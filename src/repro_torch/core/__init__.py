from .kernels import (KernelConfig, GramOperator, ExactGramOperator,
                      LowRankGramOperator, StreamingGramOperator,
                      apply_epilogue, gram_full, gram_slab, integer_pow,
                      kernel_diag, kmv_slab_free)
from .loop import (DIVERGED_METRIC, DIVERGED_NONE, DIVERGED_NONFINITE,
                   GuardSpec, LoopResult, NO_TOL, as_schedule, pad_rounds,
                   run_rounds, run_rounds_fleet)
from .dcd import (L1, L2, SVMConfig, coordinate_schedule, dcd_ksvm,
                  make_dcd_round_fn)
from .sstep_dcd import (make_sstep_dcd_round_fn, sstep_dcd_inner,
                        sstep_dcd_ksvm)
from .bdcd import KRRConfig, bdcd_krr, block_schedule, make_bdcd_round_fn
from .sstep_bdcd import (make_sstep_bdcd_round_fn, sstep_bdcd_inner,
                         sstep_bdcd_krr)
from .objectives import (krr_closed_form, krr_dual_objective, krr_predict,
                         krr_rel_residual, krr_rel_residual_fleet,
                         krr_rel_residual_op,
                         krr_rel_residual_value, ksvm_Qa,
                         ksvm_dual_objective, ksvm_duality_gap,
                         ksvm_duality_gap_lowrank, ksvm_duality_gap_op,
                         ksvm_gap_fleet, ksvm_gap_from_Qa, ksvm_predict,
                         ksvm_primal_objective, relative_solution_error)
from .predict import (BatchedPredictor, batched_predict, compact_support,
                      validate_queries)
from .nystrom import (LANDMARK_METHODS, NystromKRRSetup, NystromMap,
                      choose_landmarks, fit_nystrom, kmeans_landmarks,
                      landmark_generator, lowrank_operator,
                      nystrom_kernel_error, nystrom_krr_setup, nystrom_map)
