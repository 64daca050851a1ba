#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: the quickest proof that the port builds and runs its main path.

    python3 chip_smoke.py [--seed 0] [--svm-iters 4096] [--krr-iters 2048]

Phases (each one fails the run with a non-zero exit):

  1. build    compile every csrc/*.cu (one nvcc each, in parallel); the
              tensor-core flash kernels' SASS (forward, dkv and dq) must
              hold HGMMA and UTMALDG (cuobjdump -sass)
  2. parity   KMV and gram kernels against their plain PyTorch versions
              at the main path's shapes, f32 and bf16, every comparison
              repeating bit for bit: KMV in every regime of kmv_plan (r =
              1 the classical round, 32, 256, a 1024-query block, B = A
              the symmetric full matvec), gram also at the classical 1 x
              1 and the K-SVM 32 x 32 blocks; the KMV check must fail each
              regime's kernel with its last m split left out, the gram
              check the kernel with its last feature split left out
  3. K-SVM    KernelSVM(C=1, rbf) at the news20-like shape (m = 19996,
              n = 8192): s-step DCD (s = 32) and classical DCD on one
              schedule, the duality gap (one full KMV), prediction of
              2048 held-out queries through support-vector compaction
  4. K-RR     KernelRidge(lam=1, rbf), s-step BDCD (s = 8, b = 32) on
              the tolerance path, the relative-residual history, 2048
              predictions.  Phases 3-4's fits run their rounds as
              captured CUDA graphs (core.loop.RoundGraphs); their kmv and
              gram counts must be the launches the fits make (one each a
              round, one kmv a check, gap and prediction block), the
              warm-up rounds' launches printed apart; then (3-4b) each
              fit again with the operator not capturable (the eager
              loop) must give the same alpha and residual history bit for
              bit, and the s-step K-SVM rounds replayed with a stale
              schedule buffer (every run the first run's coordinates)
              must not
  5. stream + Nystrom, on the same data
       a. the streamed KMV pipe (A chunked in pinned host memory) and
          the row gather against their plain versions and the resident
          KMV, f32 and bf16, vector and (m, 4) X, r = 32, 256 and the
          full-matvec piece r = chunk_rows, at chunk_rows = 2048 (ragged
          tail) and 6000 (four chunks); the symmetric streamed full
          matvec (each chunk pair once, serving its mirror) against its
          plain pair loop and the resident symmetric KMV, repeating bit
          for bit, and its wrong variants (one pair's mirror product, the
          tail chunk's pair left out), which must fail
       b. KernelRidge(stream=2048) replaying phase 4's schedule at full
          depth, its residual history from the streamed full KMV; its
          device-memory growth must stay below A's bytes; its rounds
          take the eager loop (the streamed operator is not capturable)
       c. KernelSVM(s=32, stream=2048) replaying phase 3's schedule at
          full depth with one streamed duality gap (a check only at the
          last round: the depth cut is in checks, not iterations), and
          2048 predictions through BatchedPredictor(stream=1024); eager
          rounds too
       d. KernelRidge(approx="nystrom", landmarks=1024, uniform): the
          factor product on 512 rows against the plain build (and what a
          TF32 build reads against the same tolerance), the kernel error
          on a 2048-row subsample; its rounds captured, alpha and history
          equal to the eager loop's bit for bit, its runs timed
       e. pipelined, copy-only and compute-only times of the streamed
          KMV; the symmetric streamed full matvec's, beside the resident
          symmetric KMV and the ten-piece route it replaced, each against
          its bound; the pipe must read below copy-only + compute-only
  6. report   launch counts of phases 3-4, kernel times against their
              plain versions, bounds and library calls, timed with the
              launches queued behind a spin kernel, so the host's enqueue
              does not count, and eager beside it (KMV at r = 1, 32, 256,
              1024 and m, B = A and a copy of A, each with its regime;
              gram at 1 x 1, 32 x 32, 256 x 256 and 19 996 x 32, 1 x 1
              also through the 32 x 32 tile), the inner-phase share of an
              eager round; the fits' runs replayed as graphs (device ms a
              run and a round from events around 8 replays, host ms a
              run, capture time, graph pool bytes) and what is left of a
              replayed round beside its KMV and gram, per node
  7. LM       Qwen3-1.7B at its published widths (28 layers, d_model
              2048, 16 heads / 8 kv x 128, vocab 151 936), bf16,
              attn_impl="flash", random f32 weights from --seed:
       a. the rmsnorm and flash forward kernels against their plain
          versions at the path's shapes: the tensor-core forward (bf16,
          hd 64 and 128, ragged S and T) within its derived bf16 bound,
          the FP32-FMA forward (f32, hd != hdv); what the flash check
          reads for wrong variants (scale 5% off, a k tile skipped, k
          rows swapped in pairs within each tile: each must fail it)
       b. prefill: forward on 4 prompts of 2048 tokens; finite logits,
          113 rmsnorm and 28 tensor-core flash launches, held against the
          same forward with naive attention (bf16 and f32; the f32
          forward takes the FP32-FMA flash kernel 28 times; TF32
          attention must fail the f32 bound); time, tokens/s, memory peak
       c. 64 teacher-forced decode steps against the prefill logits
       d. ServingEngine(n_slots=4, max_seq=256) answers 8 requests (8-16
          prompt tokens, 16 new each, some arriving mid-flight), each
          held against the same request decoded alone by greedy_generate
          (where the tokens part, the isolated run's top-1 / top-2
          margin must be small)
       e. kernel times against bounds, plain versions, F.rms_norm and
          scaled_dot_product_attention (rmsnorm and F.rms_norm queued and
          eager, and the rmsnorm kernels' device time in one profiled
          prefill), the tensor-core forward beside the FP32-FMA one at
          (64, 2048, 128) and (32, 2048, 128)
  8. LM training, Qwen3-1.7B at the same widths, bf16 activations over f32
     params, attn_impl="flash", remat="full", random weights from --seed:
       a. the flash backward kernels (the tensor-core or the FP32-FMA dq
          and dkv) against their plain version on the same saved lse and
          delta at the path's shape (bf16, causal; dq, dk and dv within
          the derived bf16 bounds, repeating bit for bit) and f32, not
          causal, hd != hdv, hd 64 and ragged cases; what the check reads
          for wrong variants (delta left out, scale 5% off, a causal k
          tile skipped in dq, lse of the neighbouring row, k rows swapped
          in pairs: each must fail it); the RMSNorm Function's dx and
          dscale against autograd through its oracle
       b. loss_fn gradients at full width on 1 x 2048 tokens, through the
          kernels against the same model with naive attention (plain
          autograd): every leaf's gradient finite and non-zero, per-leaf
          relative error in f32 (the FP32-FMA kernels; TF32 attention
          must fail that bound) and bf16 (the tensor-core kernels)
       c. LM_TRAIN_STEPS steps of make_train_step on TokenPipeline batches
          of 4 x 2048 tokens in 2 microbatches, AdamW (lr 3e-5, warmup 2):
          finite and falling loss, lr on its schedule; launch counts per
          step; step time, tokens/s, device-memory peak, a profiled step
       d. the backward kernels' times against their bound, the plain
          version and the backward of scaled_dot_product_attention, the
          tensor-core dq and dkv beside the FP32-FMA ones

  9. sweeps, on phases 3-4's data (it runs after phase 6, before the LM
     phases free that data); nothing cut in width:
       a. KMV at c = F against its plain version, repeating bit for bit:
          r = 256 at c = 16 (the K-RR fleet round), r = 32 at c = 8 (the
          K-SVM fleet round), the full matvec B = A at c = 4, 8 and 16,
          each with the regime kmv_plan picks; at c = 16 the kernel with
          its last m split left out must fail; times against F launches at
          c = 1, the plain version and the bound; at c = 8 and 16 the wide
          plan kmv_plan took before beside the symmetric one
       b. solve_fleet(16 lambdas 1e-2..1e2 with 1.0, s=8 b=32 tol=1e-4)
          replaying phase 4's schedule: member lambda = 1 against phase 4
          and lambda = 100 against its own fit (1e-5), one kmv and one gram
          launch a round for the whole fleet and one kmv a check; an F = 1
          fleet equal to phase 4's fit bit for bit; the fleet cut at the
          check where its first member converged gives that member's alpha
          bit for bit
       c. solve_fleet(8 Cs with 1.0, s=32) replaying phase 3's schedule,
          held likewise against phase 3; both fleets' rounds and checks
          replayed and timed
       d. KernelRidge(s="auto", b="auto", probe=2) to the residual phase 4
          reached (its frontier, probes and winner); KernelRidge(stream=
          True): the chunk rows from the device's budget, measured link
          and chunk floor, its first residual check against phase 4's,
          its wall at most STREAM_AUTO_SLACK x the same fit's at 2048-row
          chunks
       e. reg_path over 4 lambdas (warm iterations against the fleet's
          cold ones) and cross_validate (3 folds, 4 lambdas, via the
          fleet, H = 512: a depth cut)
       f. FitResult.comm of phases 3-4, the fleets' modeled and measured
          speedups
 10. guarded solves (resilience), on phases 3-4's data after phase 9:
       a. the guarded rounds' apply_at K(A[idx], A)^T w (the KMV kernel
          with its operands swapped) at sb = 32 and 256 against its plain
          version, repeating bit for bit, with its plan; its last
          contraction row left out must fail; timed beside the 128-row
          wide tile, the unguarded round's KMV at r = sb and the gram-slab
          route.  The f64 route: kmv (r = 32 and B = A at m = 4096, the
          apply_at at full m), gram (32 x 32, 256 x 256) and the streamed
          apply_at (m = 4096) against their f64 plain versions at the f64
          bound; kmv with its last contraction row left out, and gram
          with its last feature chunk left out, must fail
       b. guarded K-SVM (s = 32) and K-RR (s = 8, b = 32, tol 1e-4)
          replaying phases 3-4's schedules, recompute_every "auto" (and 16
          for K-RR), held against phases 3-4's alpha at 1e-5, drift below
          1e-4, exact kmv / gram counts (a round each, a kmv a check and a
          correction); the unguarded fits refitted warm in this phase,
          bit for bit phases 3-4's, so that the replays' device ms and
          the walls of guarded and unguarded compare like for like,
          beside the modeled guard overhead; the same guarded fits
          through the eager guarded loop equal bit for bit
       c. NaN into "f", then "alpha", of the K-SVM fit: one rung each
          (halve_s:32->16), within 1e-5 of the clean alpha; a classical
          K-RR fit (H = 64, a depth cut) with a fault escalates to the
          f64 rung, its rounds on the f64 kernels with exact f64 counts
       d. a fit killed at a checkpoint boundary (checkpoint_every=4, H =
          1024, a depth cut) and resumed equals the uninterrupted fit bit
          for bit; a checkpoint of another schedule is refused
       e. a guarded streamed K-RR fit (stream=2048, 16 rounds, one
          correction) against the resident guarded fit at 1e-5
 11. serving and telemetry (repro_torch.serve, repro_torch.obs), on phases
     3-4's data, phase 9's fleets and phase 5's Nystrom fit, after phase 10:
       a. a ModelRegistry(predict_batch=1024) of phase 3's K-SVM with the
          8-C fleet's members (one group, F = 9), phase 4's K-RR with the
          16-lambda fleet's (F = 17) and the Nystrom K-RR (F = 1); the
          operator_key time of the full-width A, each group's bytes; phase
          4's K-RR saved and loaded: it must join its group by content and
          serve its column bit for bit
       b. warm-up of every bucket (8 ... 1024) of every group; KMV at every
          bucket x F (9, 17) against its plain version, repeating bit for
          bit, equal to the group's served block, with its regime (rows at
          r = 8, narrow at 16-64, wide from 128), time, plain time, bound
       c. ServingEngine(slots=256, max_queue=1024): 4096 tickets over the 27
          models (70% single rows, the rest 2-64), every 64th with a
          deadline already passed (must expire unserved); each ticket within
          2e-4 of its model's own BatchedPredictor; one KMV launch a block
          of an exact group and one gram launch a Nystrom block (its feature
          map); the serve-cache observable must not grow after warm-up;
          between the two halves the K-RR model is refit on 1024 new rows
          (tol 1e-4) and swapped: its tickets before the swap are held to
          the old weights, after it to the new; p50 / p99 latency, rows/s;
          a burst of 2 x max_queue must shed the excess at submit
       d. phase 4's K-RR fit again with telemetry=True: alpha and history
          bit for bit phase 4's and the uninstrumented refit's, the same kmv
          and gram counts; its spans, its 16 metric_check intervals (device
          times of each check's own graph), audit_fit's table, a Chrome
          trace (validated, written to chiprun_out/phase11_trace.json), the
          walls with telemetry on and off (not gated); one instrumented
          engine window's metrics as Prometheus text

 12. the distributed layouts (core.distributed, launch.mesh), on phases
     3-4's data after phase 11: the ranks are processes spawned on the one
     card (torch.multiprocessing), each drawing the data as main() does
     and calling the same facade fits, SPMD:
       a. NCCL at world 1 on the (1, 1) mesh: the 1d K-SVM (s = 32) and
          K-RR (s = 8, b = 32, tolerance path; its first DIST_KRR_ITERS
          iterations, 4 checks) fits against phases 3-4's at 1e-5 (K-RR
          against a serial fit of that cut)
       b. 1d at P = 4, four processes sharing the card over gloo (CUDA
          tensors), n / 4 = 2048 features a rank: the same two fits and
          classical DCD (s = 1) on phases 3-4's schedules (classical DCD
          on its first DIST_CLASSICAL_ITERS coordinates, beside a serial
          classical fit of that cut): alpha and the residual history
          against the serial fits at 1e-5, every rank's
          bit for bit the others'; each rank's launches exact (a gram a
          round, rank 0's checks a kmv each)
       c. 2d at 2 x 2 (m / 2 rows, n / 2 features a rank): the same, two
          gram launches a round
       d. a guarded linear 1d K-RR fit with rank 0's shard NaN-poisoned
          (resilience.poisoned_1d_factory) for the chunk holding iteration
          DIST_GUARD_FAULT_ITER: the ladder halves s and the fit ends
          within 1e-5 of the clean fit
       e. the 16-lambda K-RR fleet on the 1d layout (DIST_KRR_ITERS
          iterations) against phase 9's lambdas in a serial fleet of that
          cut at 1e-5, one reduction a round for all members
       f. every fit's collectives by axis and kind with their words: the
          counts must be rounds x round_collectives + setup_collectives
          (once a fit; + the 2d alpha assembly a chunk) + rank 0's checks
          (perf_model), beside the modeled words at the fit's P
       g. walls and a 1d K-RR round split into its partial gram, its
          reduction and its local phase (processes time-sliced on one
          card: not a scaling measurement); then every shape at which
          the ranks launched gram or kmv (the wrappers' by_shape counts,
          one kernels-record entry each with its own launches), checked
          against its plain version and timed alone on the card, beside
          torch.mm and its bound
 13. the LM's cross-device training (train_step, models/sharding), in
     phase 12's spawns after their fits: Qwen3-1.7B at full width, depth
     cut to LMD_LAYERS layers, bf16 flash with remat, 8 x 1024 tokens a
     step in 2 microbatches (a depth and batch cut: 2 layers and 16 x
     1024 tokens in 4 before phase 15 needed the time), 2 steps a case;
     the reference is the unsharded trainer, trained first in this
     process alone on the card:
       a. NCCL at world 1 (1 x 1): the s-step deferred step at s = 2 and
          the FSDP + TP step
       b. gloo at world 4 sharing the card: deferred at 2 x 2 with s = 1,
          s = 2 and s = 2 with int8 error feedback; FSDP at 4 x 1 (FSDP +
          TP at 2 x 2 runs in phase 15's MoE training)
       c. every case's loss (TOL_LMD_LOSS), AdamW's first moment after
          step 1 and first and second moments after the last step per
          leaf (TOL_GRAD_BF16), and params after 2 steps (AdamW's largest
          move apart, lmd_param_bound: a layout or gather check only, as
          it holds whatever the gradients) against the reference, each
          rank's chunks against the same chunks of the reference; the chunks
          two ranks both hold bit for bit after each step; collectives
          by axis and kind exactly train_step.step_collectives, the s = 1
          step 2x the "grad" syncs of s = 2; rmsnorm and flash launches
          a step exact; step walls and sync times (CUDA events around
          each sync, read after the step); device-memory peaks a rank
          beside the replicated trainer's
       d. rmsnorm and the tensor-core flash forward, dq and dkv at every
          shape the ranks launched them at (by_shape), checked against
          their plain versions (flash within its derived bounds) and
          timed alone on the card beside F.rms_norm and SDPA
 14. the MoE family (models/moe.py, MLA in models/attention.py), after
     phase 8: DeepSeek-V2-Lite at its published widths (27 layers,
     d_model 2048, 16 heads, MLA kv_lora_rank 512 + rope 64, 64 routed
     experts top-6 + 2 shared x 1408, vocab 102 400), bf16 over f32
     params (64.8 GB), moe_impl="capacity", random weights from --seed:
       a. full depth: a 4 x 1024 prefill (finite logits, exactly 82
          rmsnorm launches: norm1, MLA's kv_norm and norm2 a layer and
          final_norm; time, tokens/s, idle share), 32 decode steps on the
          compressed cache of 1056 positions (ms a step, idle share),
          ServingEngine(n_slots=4) answering 8 requests in bf16 (timed)
          and in f32, each f32 request held against it decoded alone by
          greedy_generate; the serving peak within MOE_PEAK_BYTES
       b. the depth cut to 2 layers (full width): the forward with the
          rmsnorm kernel against every kernel swapped for its plain
          version (f32 1e-4, bf16 TOL_LM_BF16 relative), 64 teacher-forced
          decode steps against the prefill (dense dispatch, as the JAX
          package's own test pins it) and capacity at factor E / k (no
          drops) against dense, each within TOL_LM_BF16
       c. the same depth: loss_and_grads (every gradient finite, both
          routers and every expert routed a token reached), then 2 AdamW
          steps of 4 x 1024 tokens in 2 microbatches with remat (finite
          losses, exact rmsnorm launches, step ms, tokens/s, peak)
       d. the rmsnorm kernel at every shape the phase launched it at
          (D = 512 among them: MLA's kv_norm), against its plain version,
          timed alone beside F.rms_norm and its bound
 15. sharded decode and sharded MLA / MoE (models/sharding.cache_spec,
     the split-S attention, expert parallelism), in phase 12's spawns
     after phase 13; the references are the unsharded runs, made first in
     this process alone on the card:
       a. Qwen3-1.7B at full width and LMD_LAYERS layers decoding 4 rows
          from a random 1056-position cache (rows placed so that one
          stays in the first chunk of a split S, two cross a chunk
          boundary, one runs past the end), 32 steps: NCCL at 1 x 1 (bit
          for bit); gloo at 2 x 2 in f32 (TOL_LM_F32), at 4 x 1 and with
          B = 1 at 2 x 2 (S split over data) in bf16 (TOL_LM_BF16); every
          rank's cache chunks against the same chunks of the unsharded
          run; an f32 ServingEngine(rules=) at 1 x 1 and 2 x 2 answering
          8 requests with the unsharded engine's tokens
       b. DeepSeek-V2-Lite at full width and MOE_SHORT_LAYERS layers: in
          bf16 at 2 x 2, in f32 at 1 x 4 (16 experts and 4 heads a rank):
          the sharded forward and decode on the split latent cache (32
          steps; 8 at 2 x 2, where each step gathers the model over
          data), held before each row's first routing difference (C22),
          bf16 within twice the bf16 noise, f32 at TOL_LM_F32; training
          steps of 4 x 1024 tokens in 2 microbatches with remat (2; 1 at
          2 x 2; loss TOL_MOE15_LOSS, grad norm TOL_MOE15_GNORM; in f32
          AdamW's moments and the params entry by entry), replicated
          chunks bit for bit
       c. every case's collectives exactly decode_collectives /
          step_collectives, the decode steps' rmsnorm launches, and the
          rmsnorm kernel at every shape the ranks launched it at, against
          its plain version, timed alone beside F.rms_norm and its bound
 16. the SSM family (models/mamba.py, the shared attention block in
     models/lm.py), after phase 14: Falcon-Mamba-7B (64 Mamba-1 layers,
     d_model 4096, d_inner 8192, state 16, vocab 65 024, tied; 28.0 GB of
     f32 params) and Zamba2-1.2B (38 Mamba-2 layers through SSD, 64 SSM
     heads x 64, state 64, and the shared attention + MLP block, 32
     heads x 64 and d_ff 8192, applied after each of the 19 periods;
     attn_impl="flash"), bf16 over f32 params, random weights from --seed:
       a. Falcon at full width and depth: the leaf count against the JAX
          package's abstract_params; a 4 x 1024 prefill (exactly 65
          rmsnorm launches: norm1 a layer and final_norm; time, tokens/s,
          idle share, peak), a warm-up, 32 timed and 2 profiled decode
          steps, teacher-forced, whose logits are held against the
          prefill's (TOL_LM_BF16), ServingEngine(n_slots=4) answering 8
          requests in bf16 (timed) and f32 (every token equal to the
          request decoded alone: slots are reused); the SSM core's share
          of the prefill (A14j); then the depth cut to 2 layers: 64 f32
          decode steps against the f32 prefill (TOL_LM_F32), the f32
          gradient on 1 x 1024 tokens through the rmsnorm kernel against
          the same with every rmsnorm plain, leaf by leaf (TOL_GRAD_F32),
          and 2 AdamW steps of 4 x 1024 tokens in 2 microbatches with
          remat (finite, falling losses, exact launches, step ms, peak)
       b. Zamba2 at full width and depth: the same serving checks (77
          rmsnorm launches a step: norm1 a layer, norm and norm2 an
          application of the shared block, final_norm; 19 tensor-core
          flash launches a prefill), 64 f32 decode steps against the f32
          prefill at full depth (naive attention on both sides), SSD
          against the elementwise scan on one layer at full width (the
          JAX package's tests/test_ssd.py bounds), SSD's share of the
          prefill, and 2 training steps at full depth (exact rmsnorm,
          flash forward, dq and dkv launches)
       c. rmsnorm (D = 4096 on the generic kernel, 2048 on the row kernel)
          and the tensor-core flash forward, dq and dkv at hd = 64 at
          every shape the phase launched them at, against their plain
          versions (flash within its derived bf16 bounds), timed alone
          beside F.rms_norm / SDPA and their bounds
 17. the encoder-decoder stack and M-RoPE (models/lm.py's encoder,
     cross-attention and prefill_cross_kv; layers.apply_mrope), after
     phase 16, bf16 over f32 params, random weights from --seed:
       w. Whisper-tiny at its published widths (4 encoder and 4 decoder
          layers, d_model 384, 6 heads x 64, d_ff 1536, vocab 51 865 tied,
          1500 frames, layernorm), attn_impl "naive" as its config says:
          the leaf count against the JAX package's abstract_params; a
          prefill of 4 x 448 tokens over 4 x 1500 frames (time, idle
          share, no kernel launches: layernorm and naive attention are
          plain); prefill_cross_kv and 32 teacher-forced decode steps
          against the prefill (TOL_LM_BF16), 64 f32 steps against the f32
          prefill (TOL_LM_F32); ServingEngine(n_slots=4) answering 8
          requests in bf16 (timed) and f32 (every token equal to the
          request decoded alone; cross_kv zero, as the reference's
          engine leaves it); 2 AdamW steps of 4 x 448 tokens with their
          frames in 2 microbatches with remat.  attn_impl "flash": the
          1500 frames refused (ValueError) before any launch; at 1536
          frames and 256 tokens the forward through the kernels against
          every flash call plain (bf16 TOL_LM_BF16, f32 TOL_LM_F32, 8
          flash launches a forward), the f32 gradient through the
          FP32-FMA kernels (TOL_GRAD_F32) and the bf16 one through the
          tensor-core kernels (TOL_GRAD_BF16), leaf by leaf
       v. Qwen2-VL-72B at its published widths (d_model 8192, 64 / 8
          heads x 128, d_ff 29 568, vocab 152 064 untied, M-RoPE sections
          (16, 24, 24), theta 1e6), flash, depth cut to 2 layers: a 4 x
          1024 prefill over the vision frontend's streams (16 text
          tokens, a 16 x 16 patch grid, text resuming past the largest
          position; 5 rmsnorm and 2 tensor-core flash launches), its
          logits after the prefix apart from the aligned streams' (M-RoPE
          acts); 32 decode steps against the aligned-stream prefill
          (TOL_LM_BF16); the f32 engine against each request alone; at 1
          layer, 2 AdamW steps of 2 x 1024 tokens with the (3, B, S)
          streams in 2 microbatches with remat (finite, falling losses,
          exact launches, peak within VL_PEAK_BYTES)
       c. rmsnorm (D = 8192, the generic kernel) and the tensor-core
          flash forward, dq and dkv (hd 64 at Whisper's (24, 1536) and
          (24, 256), hd 128 at Qwen2-VL's (256, 1024) and (64, 1024)) at
          every shape the phase launched them at, against their plain
          versions, timed alone beside F.rms_norm / SDPA and their bounds
 18. the sharded SSM family and the sharded encoder-decoder stack with
     M-RoPE (models/mamba.py's tensor-parallel blocks, models/sharding's
     Sharded over every layer, the Mamba states', shared_cache's and
     cross_kv's chunks), in phase 12's world-4 spawn after phase 15, at
     full width from weights drawn leaf by leaf from --seed (a rank
     keeps its chunks only); the references are the unsharded runs of the
     same weights, made first in this process alone on the card:
       a. Zamba2-1.2B at 2 periods, bf16, 1 x 4 (its Mamba-2 heads, the
          shared block's heads and d_ff split 4 ways): a 4 x 256 forward
          (9 rmsnorm and 2 tensor-core flash launches a rank) and 8
          decode steps from a random state of 256 positions (Mamba states
          and shared_cache), logits and state chunks within twice the
          unsharded run's bf16 noise; in f32 at 2 x 2 one training step
          of 2 x 256 tokens with remat (plain attention): loss and grad
          norm at TOL_LM_F32 relative, AdamW's first moment entry by
          entry (TOL_GRAD_F32 of each leaf's largest entry), replicated
          chunks bit for bit
       b. Falcon-Mamba-7B at 2 layers, bf16, 1 x 4 (d_inner 8192 split
          4 ways): the 8 decode steps, as a.
       c. Whisper-tiny whole, f32, 2 x 2 (6 heads, 3 a rank; d_model over
          data): prefill_cross_kv(rules=)'s chunks, the 8 decode steps
          (cross_kv random too) and the state chunks at TOL_LM_F32, an
          f32 ServingEngine(rules=) answering 8 requests with the
          unsharded engine's tokens, one training step of 2 x 256 tokens
          over their frames, as a.
       d. Qwen2-VL-72B at 1 layer, bf16, 1 x 4 (16 heads and 2 kv heads
          a rank, vocab 152 064 split 4 ways, its tables vocab-parallel):
          the 8 decode steps, as a. (Its sharded forward is cut for the
          phase's time and the host's memory: S18_CASES.)
       e. every part's collectives exactly decode_collectives /
          step_collectives and its launches exact on every rank (counts
          zeroed just before the part, read just after); rmsnorm and the
          tensor-core flash forward at every shape the ranks launched
          them at, against their plain versions, timed alone beside
          F.rms_norm / SDPA and their bounds; the phase's seconds

 19. the analysis and the dry run (repro_torch.analysis,
     repro_torch.launch.dryrun), after phase 17, in this process:
       a. run_all() with the registry launching every entry point for
          real on the card (the 16 C entry points of csrc/, each
          recorded launch's grid, block and dynamic shared memory
          printed beside the card's opt-in limit); any unsuppressed
          finding fails the phase
       b. the dry run of Qwen3-1.7B x train_4k at both production meshes
          (16 x 16 and 2 x 16 x 16, on meta tensors): its JSON keys and
          roofline terms, priced with the H100's data-sheet figures
       c. its accounting against the card at a (1, 1) mesh: the
          arguments' bytes it reports for Qwen3-1.7B's params and AdamW
          state equal the bytes the card's allocator is asked for when
          those tensors are made on the card, and memory_allocated()'s
          growth within the allocator's rounding (ALLOCATOR_SLACK a
          tensor); the
          FLOPs of the dispatched (non-kernel) ops of a 4 x 1024 prefill
          on meta equal a FlopCounterMode count of the same prefill on
          the card (the hand-written kernels priced by their formulas in
          both); the phase's seconds, held to ANALYSIS_PHASE_S

The last line of standard output is ``{"ok": true, "device": {...}}``;
the line before it is the ``{"kernels": [...]}`` record.  Without a CUDA
device, or without the port's sources beside this file, it exits
non-zero and prints no result.  TF32 is off throughout: the plain
versions and the kernels are compared in full f32.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and FP32 outside the
# tensor cores, the rate the kernels' f32 FMAs run at.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# bf16 dense tensor-core rate: the bound of a bf16 kernel's operations.
BF16_FLOP_PER_S = 989e12
# FP64 on the tensor cores (the same data sheet: 67 TFLOP/s; 34 outside
# them): the f64 route's bound, the least time the card could take (cuBLAS's
# f64 products run there).  The f64 tile's DFMAs run outside the tensor
# cores, so it can reach at most half of this bound's rate.
FP64_FLOP_PER_S = 67e12
# Host-to-device link of the streamed KMV: PCIe Gen5 x16, 128 GB/s both
# directions together in the H100 data sheet, so 64 GB/s one way (32 GT/s
# x 16 lanes, 128b/130b encoding: 63 GB/s of payload at best).
PCIE_H2D_BYTES_PER_S = 64e9

# Parity tolerances and their reasons.
TOL_KMV_F32 = 2e-4     # tests/test_kmv.py: f32 summation-order differences
TOL_GRAM_F32 = 1e-4    # tests/test_pallas_gram.py
TOL_BF16 = 2e-2        # bf16 inputs (both sides see the same bf16 values)
# f64 kernels against their f64 plain versions (phase 10): both sum the same
# f64 products in other orders, (n + m) u ~ 3e-12 relative at n = 8192
# before the epilogue (rbf multiplies an error in |a - b|^2 by sigma
# |a - b|^2 <= ~1e2); 1e-9 is above that and five orders below the f32
# bound, which an f32 accumulation cannot meet
TOL_F64 = 1e-9
# s-step vs classical DCD on one schedule: each of the H = 4096 coordinate
# solves reads u^T alpha, an f32 sum over m ~ 2e4 terms of size up to
# ~1e2 (error ~1e-5), and the two methods round it differently; the
# difference compounds through the clipped updates, alpha in [0, C = 1].
TOL_SSTEP_VS_CLASSICAL = 1e-3
TOL_ORACLE = 1e-4      # facade predictions vs the dense oracle, relative
                       # to the largest decision value
# Rows per pinned chunk of the streamed phase: 64 MB of f32 at n = 8192,
# so ten chunks with a ragged tail at m = 19 996.
STREAM_CHUNK_ROWS = 2048
# Streamed vs resident metric histories on one schedule: the same f32
# full-KMV sums taken chunk by chunk in another order (~1e-6 relative).
TOL_STREAM_METRIC = 1e-4
# A fleet member against its single fit on one schedule: the reference's
# f32 iterate bound (tests/test_slabfree_parity.py).
TOL_ITERATE = 1e-5
# Phase 9d: the autotuned K-RR fit's budget (the model picks b = 1: it
# needs about the coordinate updates phase 4's b = 32 took to its check
# TUNED_CHECK, 16 384, and drawing its schedule costs the host O(H m):
# about 20 s at 2 ** 17 here), the check of phase 4 whose residual it must
# reach, and the checks of the stream=True fit (depth cuts of phase 4's
# and 5b's 16).
TUNED_MAX_ITERS = 2 ** 15
TUNED_CHECK = 4
STREAM_AUTO_CHECKS = 1
# how much slower than the same fit at 2048-row chunks the stream=True
# fit's wall may read (both pin A anew; run-to-run spread of such walls)
STREAM_AUTO_SLACK = 1.25
# Nystrom factor product Phi Phi^T, kernels against the plain build, in
# units of f32 eps x kappa(K_LL) x max|Phi Phi^T|: the gram kernel and
# its plain version sum the same f32 products in another order, so their
# entries of K (at most 1 for rbf) agree within a few eps (phase 2 reads
# ~6.5 eps at 256 x 256), and K_LL^{-1/2} amplifies a relative error in
# K_LL by up to kappa.
TOL_NYSTROM_EPS_KAPPA = 8.0
F32_EPS = 2.0 ** -23
# Phase 10 (guarded solves): the apply_at row counts of the K-SVM s = 32 and
# K-RR s = 8, b = 32 rounds; A's rows the f64 B = A KMV and the f64
# streamed apply_at take (a cut of m, 275 GFLOP of f64 at 4096); the
# iteration the K-SVM faults fire at (round 31 of 128); the classical
# K-RR f64 rung's budget H (its exact residual is one f64 full matvec of
# 6.5 TFLOP at full m); the kill-and-resume fit's budget (32 rounds in 8
# segments of checkpoint_every = 4); the streamed guard's rounds.
GUARD_SB = (32, 256)
GUARD_F64_M = 4096
GUARD_FAULT_ITER = 1000
GUARD_F64_ITERS = 64
GUARD_KILL_ITERS = 1024
GUARD_STREAM_ROUNDS = 16
# phase 11: the registry's largest bucket, the engine's admission width
# and queue bound, its traffic (tickets, the share of single rows, tickets
# submitted between two steps)
SERVE_BATCH = 1024
SERVE_SLOTS = 256
SERVE_QUEUE = 1024
SERVE_TICKETS = 4096
SERVE_SINGLE = 0.7
SERVE_PER_STEP = 32
# phase 12: the ranks that share the card over gloo, their spawn's time
# limit (phases 13, 15 and 18 run in the same spawns), and the guarded 1d fit
# (linear K-RR at s = 8, b = 32): its budget H, the iteration whose chunk a
# poisoned rank corrupts, and rounds of the 1d K-RR round that are split
# into kernel, reduction and local phase
DIST_WORLD = 4
DIST_TIMEOUT_S = 900
# the gloo ranks' classical DCD fits replay the first DIST_CLASSICAL_ITERS
# coordinates of phase 3's schedule (a depth cut: at all 4096 its
# latency-bound all-reduces over gloo took 59-63 s a layout on the H100
# host, at 1024 11.5-11.8 s on a slower one), held against a serial
# classical fit of the same cut
DIST_CLASSICAL_ITERS = 256
# the ranks' s-step K-RR fits and 1d fleet replay the first DIST_KRR_ITERS
# iterations of phase 4's schedule (64 rounds and 4 checks of 256 and 16:
# a depth cut, to make room for phase 17; over gloo the three took 46 s of
# the spawn at 256 rounds on an NVIDIA H100 80GB HBM3 at 700 W), held
# against a serial fit and a serial fleet of the same cut
DIST_KRR_ITERS = 512
DIST_GUARD_ITERS = 512
DIST_GUARD_FAULT_ITER = 200
DIST_SPLIT_ROUNDS = 8
# (ranks, backend) of phase 12's two spawns
DIST_RUNS = ((1, "nccl"), (DIST_WORLD, "gloo"))
# Phase 13 (the LM's cross-device training): Qwen3-1.7B at full width with
# its depth cut to LMD_LAYERS layers (four ranks' replicated state, 0.67 B
# parameters with their AdamW moments, gradient, accumulator and residual,
# shares the one card; 2 layers before phase 15 needed the time);
# LMD_BATCH sequences of LMD_SEQ tokens a step in LMD_MICRO microbatches
# (16 in 4 before, the same cut: each microbatch gathers the tables over
# gloo; a microbatch keeps its rows a rank, and so its memory), LMD_STEPS
# steps a case, phase 8's lr without warmup.  The cases by world size:
# (label, (data, model), defer_s (0: the FSDP + TP step), int8).  The
# FSDP + TP step at 2 x 2 is left to phase 15's MoE training (its 24 s
# here went to the run's time limit).
LMD_LAYERS = 1
LMD_SEQ, LMD_BATCH, LMD_MICRO, LMD_STEPS = 1024, 8, 2, 2
LMD_ACFG = dict(warmup_steps=0, total_steps=100)
# Phase 13's loss against the unsharded trainer, relative.  Both runs
# take the same bf16 kernels on the same weights and tokens; the ranks
# sum partial products and gradients in another order.  The worst of the
# readings on the H100 (NVIDIA H100 80GB HBM3, 700.00 W) was 1.81e-5, at
# step 2 with int8 error feedback (5.0e-6 without): the limit leaves 5x.
TOL_LMD_LOSS = 1e-4
# the H100's L2: phase 13's kernel entries time each shape over enough
# copies of its inputs to pass twice this, so every launch reads HBM
L2_BYTES = 50 * 2 ** 20
LMD_CASES = {1: (("defer s=2", (1, 1), 2, False),
                 ("sharded", (1, 1), 0, False)),
             DIST_WORLD: (("defer s=1", (2, 2), 1, False),
                          ("defer s=2", (2, 2), 2, False),
                          ("defer s=2 int8", (2, 2), 2, True),
                          ("sharded", (4, 1), 0, False))}
# Phase 15 (sharded decode, sharded MLA / MoE), in phase 12's spawns after
# phase 13.  Qwen3-1.7B at full width and LMD_LAYERS layers decodes
# SDD_SLOTS rows over a cache of SDD_MAX_SEQ positions whose every slot is
# drawn at random, the rows starting at SDD_POS: one stays in the first
# chunk of a split S (the other chunks empty for it), two cross a chunk
# boundary of a 2-way and a 4-way split, one runs past the end (writes
# nothing); SDD_STEPS steps a case; an f32 engine of SDD_SLOTS slots
# answers SDD_REQUESTS requests at the meshes of SDD_ENGINE_MESHES.
# DeepSeek-V2-Lite at full width and MOE_SHORT_LAYERS layers: a forward of
# MOE15_FWD tokens (MOE15_FWD_IMPL dispatch: at 16 tokens a row the
# capacity dispatch keeps one token an expert), the decode steps on its
# split latent cache, MOE15_STEPS training steps of MOE15_BATCH x
# MOE15_SEQ tokens in MOE15_MICRO microbatches with remat; in f32 (routes
# decided alike, C22) at 1 x 4, where the experts, MLA's heads and its
# latent cache are split 4 ways.  The cases by world size: (model, (data,
# model), B, dtype).  A MoE case must hold (compare before a routing
# difference) a quarter of its rows' first SDD_HELD_STEPS decode steps, so
# that its comparison is not empty; past them bf16 routes drift apart
# (C22), f32 ones do not.
SDD_SLOTS, SDD_MAX_SEQ = 4, 1056
SDD_HELD_STEPS = 4
SDD_POS = (5, 526, 790, 1054)
SDD_STEPS = 32
# The MoE case whose params are split over data decodes only the first
# SDD_STEPS_FSDP steps (a depth cut): each of its steps gathers the whole
# model over gloo, 1.35 s a step on the H100 host.  Its rows cross their
# chunk boundaries and run past the cache within the first three steps.
SDD_STEPS_FSDP = 8
# and takes MOE15_STEPS_FSDP training steps (its FSDP gathers took 23 s a
# step there).  The MoE cases: bf16 at 2 x 2, f32 at 1 x 4 (a bf16 case
# at 1 x 4 went to the run's time limit: the f32 one holds that layout
# tighter, C22).
MOE15_STEPS_FSDP = 1
SDD_REQUESTS, SDD_PROMPT, SDD_NEW, SDD_ENGINE_SEQ = 8, 3, 3, 64
SDD_ENGINE_MESHES = ((1, 1), (2, 2))
SDD_CASES = {1: (("gqa", (1, 1), SDD_SLOTS, "bfloat16"),),
             DIST_WORLD: (("gqa", (2, 2), SDD_SLOTS, "float32"),
                          ("gqa", (4, 1), SDD_SLOTS, "bfloat16"),
                          ("gqa", (2, 2), 1, "bfloat16"),
                          ("moe", (2, 2), SDD_SLOTS, "bfloat16"),
                          ("moe", (1, 4), SDD_SLOTS, "float32"))}
MOE15_FWD, MOE15_FWD_IMPL = (8, 16), "dense"
MOE15_SEQ, MOE15_BATCH, MOE15_MICRO, MOE15_STEPS = 1024, 4, 2, 2
# phase 15's MoE training loss and grad norm against the unsharded run,
# relative: a bf16 routing flip (C22) moves a token by a whole expert
# output.  Measured on the H100 (NVIDIA H100 80GB HBM3, 700.00 W): loss
# 1.25e-4 and 1.36e-4, grad norm 8.7e-5 and 1.55e-3 (phase 15 alone).
TOL_MOE15_LOSS, TOL_MOE15_GNORM = 1e-3, 1e-2
# The f32 MoE training is held leaf by leaf and entry by entry against
# the unsharded f32 run (a leaf of more than MOE15_TREE_ENTRIES entries at
# every k-th row of dim 0, _tree_sample: whole, the reference's trees took
# 19 GB of disk): AdamW's first moment after steps 1 and 2 (linear
# in the gradients: a model-replicated leaf whose partial gradients are
# not summed over model is off by a whole share), each entry within
# TOL_GRAD_F32 of its leaf's largest |entry|; the params after step 1,
# each entry within what its own gradient difference allows (AdamW's
# first update is lr g / (|g| + eps), which moves at most 2 lr |dg| / eps
# for a change dg of g in m and in v, dg = dm / (1 - b1)) past one ulp of
# f32 rounding between the runs (_sdd_step1_params).
# Not the params at TOL_GRAD_F32 of the leaf: an entry whose gradient
# sums to near eps turns a rounding-sized dg into a part of lr (the
# params after step 2 read 1.30x that bound on the H100, NVIDIA H100
# 80GB HBM3 at 700.00 W).
MOE15_TREE_ENTRIES = 2 ** 23
# Phase 18 (the sharded SSM family, the sharded encoder-decoder stack and
# M-RoPE), in phase 12's world-4 spawn after phase 15.  Every case at full
# width, its weights drawn leaf by leaf from --seed (s18_params: a rank
# keeps its chunk of each leaf, never the whole model), held against the
# unsharded run of the same weights made first in this process alone on
# the card.  The cases: (model, (data, model), dtype, parts).  Depth cuts
# (ROADMAP's cut list): Zamba2-1.2B at S18_ZAMBA_PERIODS periods of its 19,
# Falcon-Mamba-7B at S18_FALCON_LAYERS layers of 64, Qwen2-VL-72B at
# S18_VL_LAYERS layer of 80, decode only (its sharded forward gathered the
# 5 GB f32 embedding over gloo: 30.5 s of the phase's 64.9, and 15 GiB of
# pinned staging a rank, 22.9 GiB resident, on the H100 host, NVIDIA H100
# 80GB HBM3 at 700 W); Whisper-tiny whole.  Zamba2's f32 training runs its
# shared attention plain (attn_impl "naive": the tensor-core flash runs in
# its bf16 forward).
S18_ZAMBA_PERIODS, S18_FALCON_LAYERS, S18_VL_LAYERS = 2, 2, 1
S18_CASES = (("zamba2", (1, 4), "bfloat16", ("forward", "decode")),
             ("zamba2", (2, 2), "float32", ("train",)),
             ("falcon", (1, 4), "bfloat16", ("decode",)),
             ("whisper", (2, 2), "float32",
              ("prefill", "decode", "engine", "train")),
             ("vl", (1, 4), "bfloat16", ("decode",)))
# decode: S18_SLOTS rows from a random state of S18_MAX_SEQ positions (the
# Mamba states, shared_cache and cross_kv random too), the rows at S18_POS,
# S18_STEPS steps; forwards of S18_FWD tokens; one training step of S18_TRAIN_BATCH
# x S18_TRAIN_SEQ tokens (Whisper's with their frames); an f32 engine of
# S18_SLOTS slots answering S18_REQUESTS requests
S18_SLOTS, S18_MAX_SEQ, S18_STEPS = 4, 256, 8
S18_POS = (3, 64, 127, 250)
S18_FWD = {"zamba2": (4, 256)}
S18_TRAIN_BATCH, S18_TRAIN_SEQ = 2, 256
S18_REQUESTS, S18_PROMPT, S18_NEW, S18_ENGINE_SEQ = 8, 3, 3, 64

# Phase 7 (the LM at Qwen3-1.7B width): B prompts of S tokens prefill, a
# teacher-forced decode of the first LM_DECODE_PROMPT of them, and an
# engine answering LM_REQUESTS requests of LM_NEW_TOKENS new tokens after
# prompts of 8-16 tokens (16-64 before: each request is decoded alone
# too, token by token, and that took 55 s; the run's time limit).
LM_BATCH, LM_SEQ = 4, 2048
LM_DECODE_PROMPT = 64
LM_REQUESTS, LM_NEW_TOKENS, LM_MAX_SEQ = 8, 16, 256
# decode steps timed and profiled (8 until the run's time limit: the
# profiler took ~2 s a step)
LM_PROFILE_STEPS = 2
TOL_RMSNORM_F32 = 1e-5          # tests/test_pallas_rmsnorm.py
TOL_FLASH_F32_R, TOL_FLASH_F32_A = 2e-4, 2e-5   # tests/test_flash_attention.py
# bf16 flash through the FP32-FMA kernels (head dims other than 64 and
# 128, hd != hdv): the kernel and flash_fwd_plain widen the same bf16
# q/k/v and compute in f32, so o differs only in its final bf16 rounding
# (at most one ulp, 2^-7 of |o|) and lse, f32 on both sides, is held to
# the f32 limits.
TOL_FLASH_BF16_R, TOL_FLASH_BF16_A = 1e-2, 1e-3
# bf16 flash through the tensor-core kernels (hd = hdv in {64, 128}): the
# derived elementwise bound of ref.flash_fwd_bf16_tolerance.  The kernel
# rounds each p (relative to the running max) to bf16 before the PV
# product, a relative error of at most u = 2^-8 per entry, so o = sum_j
# (p_j / l) v_j moves by at most u sum_j (p_j / l) |v_j|; the f32 sums
# add 2 T 2^-24 of the same terms and both sides' final rounding of o 2u
# |o|.  The bound is capped at the JAX package's bf16 bound, 3e-2
# (tests/test_flash_attention.py:49), so it is never looser; lse, from the
# f32 p on both sides, stays at the f32 limits.  The dk / dv bound of the
# tensor-core dkv kernel is the same sum over q with p and |ds| |q|
# (ref.flash_dkv_bf16_tolerance), and the tensor-core dq's the same sum
# over k with |ds| |k|, plus the f32 error of the score sums, which ds
# inherits where it is a cancellation residue of dp - delta
# (ref.flash_dq_bf16_tolerance); the FP32-FMA dq stays at one ulp.
# Relative Frobenius error of whole-model logits between two routes on
# the same weights.  bf16 (2^-8 relative) rounds the activations at every
# product, and the two routes round in different places (naive attention
# rounds the scores and probabilities to bf16, the flash kernel keeps
# them in f32; decode rounds each step's cache read and product): a
# relative error of a few 1e-3 per layer, summed along the residual
# stream of 28 layers, stays within the bf16 bound of the JAX model tests
# (tests/test_flash_attention.py, tests/test_models_smoke.py: 5e-2).  In
# f32 the routes differ only in summation order: the flash and naive
# logits read 2.97e-6 on the H100; attention with TF32 products reads far
# above TOL_LM_F32, which phase 7b checks on every run.
TOL_LM_BF16 = 5e-2
TOL_LM_F32 = 1e-5
# Phase 8 (LM training at Qwen3-1.7B width).  A step is LM_TRAIN_BATCH
# sequences of LM_SEQ tokens in LM_MICROBATCHES microbatches.
LM_TRAIN_STEPS, LM_TRAIN_BATCH, LM_MICROBATCHES = 6, 4, 2
# lr 3e-5 peak after 2 warmup steps.  AdamW's sign-like early updates move
# every weight of the fresh model by lr, coherently: at peak 3e-4 the loss
# overshot at the second step (12.37, 11.99, 15.81, 10.89, 13.15, 11.19 on
# the H100), at 1e-4 at the third (12.37, 10.93, 13.62, 14.45, 10.65,
# 10.29), while one update at 5e-5 took 1.45 nats off.
LM_TRAIN_LR, LM_TRAIN_WARMUP = 3e-5, 2
# Flash backward, kernels against their plain version on the same saved lse
# and delta.  f32: 2e-4 / 2e-5, ten times tighter than the JAX gradient
# test's 2e-3 / 2e-4 (tests/test_flash_attention.py:68), which covers the
# Pallas kernels' own rounding: here both sides sum the same f32 products
# (no bf16 rounding of p) in at most another order.  bf16: one ulp of the
# single final rounding of dq, dk, dv, as for the forward's o.
TOL_FLASH_BWD_F32_R, TOL_FLASH_BWD_F32_A = 2e-4, 2e-5
# RMSNorm backward on the card (kernel forward, plain f32 backward) against
# autograd through the oracle: dx one bf16 rounding (TOL_BF16); dscale, f32
# sums over the rows in another order, relative to its largest entry.
TOL_RMSNORM_DSCALE = 1e-4
# Per-leaf relative Frobenius error of whole-model gradients, flash kernels
# against naive attention on the same weights and tokens.  f32: the two
# routes differ in summation order only; the worst of the 311 leaves read
# 2.6e-6 on the H100 (the forward logits 2.9e-6), attention with TF32
# products 6.1e-4 at the median leaf and 1.1e-3 at the worst, so the bound
# is the logits' 1e-5, and TF32 attention must read above it.  bf16: the
# JAX model tests' bound.
TOL_GRAD_F32 = 1e-5
TOL_GRAD_BF16 = 5e-2


# Phase 14 (the MoE family): DeepSeek-V2-Lite at full width and depth, bf16
# over f32 params (64.8 GB), moe_impl "capacity" as its config says.
# Prefill MOE_BATCH x MOE_SEQ; MOE_DECODE_STEPS decode steps on a cache of
# MOE_SEQ + MOE_DECODE_STEPS positions; an engine (MOE_SLOTS slots) answers
# MOE_REQUESTS requests of MOE_NEW_TOKENS new tokens, in bf16 (timed) and
# in f32 (held against each request decoded alone: f32 sums the same
# products in another order, so no routing decision moves); the peak
# device memory of serving must stay within MOE_PEAK_BYTES (else the depth
# is cut, never the width).  Parity and training at full width with the
# depth cut to MOE_SHORT_LAYERS: the forward with the kernels against
# every kernel swapped for its plain version on MOE_PARITY_BATCH x
# MOE_PARITY_SEQ tokens, decode against prefill (dense dispatch, as the
# JAX package's own test pins it), capacity at E / k against dense; then
# MOE_TRAIN_STEPS AdamW steps of MOE_BATCH x MOE_SEQ tokens in
# MOE_MICROBATCHES microbatches with remat (phase 8's lr, no warmup).
MOE_BATCH, MOE_SEQ, MOE_DECODE_STEPS = 4, 1024, 32
MOE_SLOTS, MOE_REQUESTS, MOE_NEW_TOKENS, MOE_ENGINE_SEQ = 4, 8, 8, 64
MOE_PEAK_BYTES = 76e9
MOE_SHORT_LAYERS = 2
MOE_PARITY_BATCH, MOE_PARITY_SEQ = 2, 128
MOE_TRAIN_STEPS, MOE_MICROBATCHES = 2, 2

# Phase 16 (the SSM family): Falcon-Mamba-7B and Zamba2-1.2B at their
# published widths, bf16 over f32 params, random weights.  At full depth:
# a prefill of SSM_BATCH x SSM_SEQ, a warm-up, SSM_DECODE_STEPS timed and
# LM_PROFILE_STEPS profiled teacher-forced decode steps, whose SSM_HELD
# logits are held against the prefill's (TOL_LM_BF16), and an engine of
# SSM_SLOTS slots answering SSM_REQUESTS requests of SSM_NEW_TOKENS new
# tokens, in bf16 (timed) and in f32 (every token equal to the request
# decoded alone: f32 sums the same products in another order, and a slot
# reused with a state left over would part at once).  f32 decode against
# the prefill over SSM_F32_PROMPT positions at TOL_LM_F32.  Falcon's
# training cuts the depth to SSM_SHORT_LAYERS (the 28.0 GB of params
# with gradient and moments would not fit); Zamba2 trains at full depth.
# The f32 gradient on SSM_GRAD_BATCH x SSM_SEQ tokens through the rmsnorm
# kernel against the same with every rmsnorm plain, at TOL_GRAD_F32.  SSD
# against the elementwise scan at the JAX package's tests/test_ssd.py
# bounds.  SSM_LEAVES: the leaf counts of the JAX package's
# abstract_params (tests/test_torch_mamba_lm.py holds the port's to them;
# ModelConfig.param_count leaves out the norms and Mamba-1's dt_rank
# terms).
SSM_BATCH, SSM_SEQ, SSM_DECODE_STEPS = 4, 1024, 32
SSM_HELD = 1 + SSM_DECODE_STEPS + LM_PROFILE_STEPS
SSM_SLOTS, SSM_REQUESTS, SSM_NEW_TOKENS, SSM_ENGINE_SEQ = 4, 8, 8, 64
SSM_F32_PROMPT = 64
SSM_SHORT_LAYERS = 2
SSM_TRAIN_STEPS, SSM_MICROBATCHES = 2, 2
SSM_GRAD_BATCH = 1
SSM_PEAK_BYTES = 76e9
SSM_LEAVES = {"falcon_mamba_7b": 7_005_802_496,
              "zamba2_1p2b": 1_170_313_344}
TOL_SSD_R, TOL_SSD_A = 2e-3, 2e-4

# Phase 17 (the encoder-decoder stack and M-RoPE), bf16 over f32 params,
# random weights from --seed.  Whisper-tiny at its published widths and
# its own attn_impl ("naive"): a prefill of ENC_BATCH rows of ENC_TEXT
# tokens (Whisper's text context, n_text_ctx) over the config's 1500
# frames drawn from the seed; prefill_cross_kv, a warm-up and
# ENC_DECODE_STEPS timed teacher-forced decode steps held against the
# prefill (TOL_LM_BF16); f32 decode against the f32 prefill over
# ENC_F32_PROMPT positions (TOL_LM_F32); an engine of ENC_SLOTS slots
# answering ENC_REQUESTS requests of ENC_NEW_TOKENS new tokens in bf16
# (timed) and f32 (every token equal to the request decoded alone);
# ENC_TRAIN_STEPS AdamW steps at full depth with the frames in
# ENC_MICROBATCHES microbatches (both models' training steps read one
# batch, so that the falling loss checks the update).  With attn_impl
# "flash" the 1500 frames are refused before any launch; at
# ENC_FLASH_FRAMES (six blocks of 256:
# the nearest length flash takes in both packages) and ENC_FLASH_TEXT
# tokens the forward and the gradient through the kernels are held
# against every flash call plain.  Qwen2-VL-72B at its published widths,
# depth cut to VL_SERVE_LAYERS to serve and VL_TRAIN_LAYERS to train (288
# GB of f32 params at 80 layers; params, gradient and moments of 3.37 B
# params at 1 layer are 54 GB), flash: a VL_BATCH x VL_SEQ prefill over
# the vision frontend's three position streams (vl_positions), held
# apart from the aligned streams'; VL_DECODE_STEPS decode steps against
# an aligned-stream prefill (the reference decodes with (t, t, t)); the
# f32 engine against each request alone; ENC_TRAIN_STEPS steps of
# VL_TRAIN_BATCH x VL_SEQ tokens with the streams.  WHISPER_LEAVES,
# VL_LEAVES: the JAX package's abstract_params counts.
ENC_BATCH, ENC_TEXT, ENC_DECODE_STEPS = 4, 448, 32
ENC_F32_PROMPT = 64
ENC_SLOTS, ENC_REQUESTS, ENC_NEW_TOKENS, ENC_ENGINE_SEQ = 4, 8, 8, 64
ENC_FLASH_FRAMES, ENC_FLASH_TEXT = 1536, 256
ENC_TRAIN_STEPS, ENC_MICROBATCHES = 2, 2
WHISPER_LEAVES = 41_166_720
VL_SERVE_LAYERS, VL_TRAIN_LAYERS = 2, 1
VL_BATCH, VL_SEQ, VL_PREFIX, VL_GRID = 4, 1024, 16, 16
VL_DECODE_STEPS = 32
VL_TRAIN_BATCH = 2
# AdamW's first update moves every weight by lr, coherently, so a
# layer's output moves with its fan-in: at phase 8's lr 3e-5 the loss
# rose from 13.64 to 36.66 at d_model 8192 and d_ff 29 568 (this phase on
# the H100, NVIDIA H100 80GB HBM3 at 700 W); a tenth of it
VL_TRAIN_LR = 3e-6
VL_PEAK_BYTES = 76e9
VL_LEAVES = {80: 72_705_384_448, 2: 4_246_773_760}

# The libraries of the tensor-core flash kernels, whose SASS must hold
# HGMMA (wgmma) and UTMALDG (TMA loads), and a kernel each names.
WGMMA_LIBS = {"flash_fwd_wgmma": "flash_fwd_wgmma_kernel",
              "flash_bwd_wgmma": "flash_bwd_dkv_wgmma_kernel",
              "flash_bwd_dq_wgmma": "flash_bwd_dq_wgmma_kernel"}


def lm_norms(cfg) -> int:
    """RMSNorm launches in one forward or decode step: norm1 of every
    layer, norm2 of every dense and MoE layer, q_norm and k_norm with
    qk-norm, MLA's kv_norm, norm (and norm2 with an MLP) at every
    application of the shared attention block, and final_norm.  A Mamba
    layer has norm1 alone: Mamba-2's gated norm is inline and plain, as
    in the JAX package (models/mamba.py), and launches nothing."""
    attn = 1 + 2 * cfg.qk_norm + (cfg.attn_type == "mla")
    period = sum(1 if kind.startswith("mamba") else attn + (kind != "attn")
                 for kind in cfg.pattern)
    shared = attn + bool(cfg.d_ff) if cfg.shared_attn_every else 0
    return (period + shared) * cfg.n_periods + 1


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def allclose_ratio(got, want, tol, magnitude_relative=False):
    """max |got - want| / (atol + tol |want|) — at most 1 passes.  atol is
    tol, or tol * max|want| where the tolerance is magnitude-relative
    (the polynomial kernel, ROADMAP C2)."""
    got, want = got.double(), want.double()
    atol = tol * max(1.0, float(want.abs().max())) if magnitude_relative \
        else tol
    err = (got - want).abs()
    return float((err / (atol + tol * want.abs())).max()), float(err.max())


def time_cuda(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call from CUDA events over ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_CYCLES_PER_MS = []


def time_queued(fn, iters: int) -> float:
    """Mean device milliseconds per call of a short kernel, with the host's
    enqueue hidden: a spin kernel (``torch.cuda._sleep``) holds the stream
    for three times the calls' measured host time while ``iters`` calls
    queue up behind it, so the events time them back to back on the card
    (at tiny shapes ``time_cuda`` times the host's Python instead)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if not _CYCLES_PER_MS:              # the spin kernel's clock
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        torch.cuda.synchronize()
        _CYCLES_PER_MS.append(1e7 / start.elapsed_time(end))
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda._sleep(int(3 * host_ms * _CYCLES_PER_MS[0]))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float,
             flop_rate: float = FP32_FLOP_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def gram_direct(A, B, cfg, bm, br, splits, per):
    """The gram kernel through its C entry point at a chosen output tile
    and split of the feature axis (``splits`` runs of ``per`` 32-feature
    chunks), not counted as a launch.  With ``splits`` one less than
    ``gram_splits`` gives, the partial grid and the reduce both leave the
    last split's features out: a wrong kernel for the parity check to
    catch."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels._launch import (DTYPE_CODES, check_inputs,
                                             kernel_args, raise_on_error)
    m, n = A.shape
    r = B.shape[0]
    out = torch.empty((m, r), dtype=torch.float32, device=A.device)
    ws = torch.empty(splits * (m * r + m + r), dtype=torch.float32,
                     device=A.device)
    code = build.launcher("gram")(
        A.data_ptr(), B.data_ptr(), out.data_ptr(), ws.data_ptr(), m, r, n,
        check_inputs("gram", A, B), DTYPE_CODES[torch.float32],
        *kernel_args(cfg), bm, br, splits, per,
        torch.cuda.current_stream().cuda_stream)
    raise_on_error("gram", code)
    return out


def phase_split(kernel_phase, local_phase, rounds):
    """Mean host milliseconds of a round's kernel phase and local phase,
    synchronised after each."""
    import torch
    t_kernel = t_local = 0.0
    for k in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data = kernel_phase(k)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        local_phase(k, data)
        torch.cuda.synchronize()
        t_kernel += t1 - t0
        t_local += time.perf_counter() - t1
    return t_kernel / rounds * 1e3, t_local / rounds * 1e3


class DriverSpy:
    """Counts the round drivers the port's fits take, captured CUDA graphs
    (``core.loop.RoundGraphs``, ``GuardedRoundGraphs``) or the eager loop
    (``core.loop._run_rounds_eager``, ``_run_rounds_guarded_eager``), by
    wrapping them in ``core.loop`` for the run's life."""

    def __init__(self):
        from repro_torch.core import loop
        self.graphs = self.eager = 0
        spy = self
        for name in ("RoundGraphs", "GuardedRoundGraphs"):
            class Graphs(getattr(loop, name)):
                def __init__(self, *a, **k):
                    spy.graphs += 1
                    super().__init__(*a, **k)

            setattr(loop, name, Graphs)
        for name in ("_run_rounds_eager", "_run_rounds_guarded_eager"):
            def run_eager(*a, _run=getattr(loop, name), **k):
                spy.eager += 1
                return _run(*a, **k)

            setattr(loop, name, run_eager)

    def take(self):
        """(graph drivers, eager loops) since the last take."""
        out = (self.graphs, self.eager)
        self.graphs = self.eager = 0
        return out


def bit_equal(got, want) -> tuple:
    """(equal bit for bit, max |got - want|) of two tensors or arrays."""
    import numpy as np
    import torch
    if isinstance(got, torch.Tensor):
        got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return False, float("inf")
    return bool(np.array_equal(got, want)), float(np.abs(got - want).max(
        initial=0.0))


def graph_timing(label, rf, a0, xs, c, runs=8, metric_fn=None):
    """Build ``RoundGraphs`` for one fit shape (runs of ``c`` rounds, the
    check's metric at the end of each with ``metric_fn``) and time its
    full-length runs: device ms per run from CUDA events around ``runs``
    replays, host ms per run (the copy of the schedule slice and the
    replay, no synchronise), the capture's seconds and its pool's bytes.
    Prints one line; returns the numbers."""
    import torch
    from repro_torch.core.loop import RoundGraphs
    with RoundGraphs(rf, a0, xs, c, metric_fn=metric_fn) as g:
        full = g.R // c
        g.run(0)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for i in range(runs):
            g.run(i % full)
        host = (time.perf_counter() - t0) / runs * 1e3
        end.record()
        torch.cuda.synchronize()
        dev_ms = start.elapsed_time(end) / runs
        out = dict(run_ms=dev_ms, round_ms=dev_ms / c, host_ms=host,
                   capture_s=g.capture_s, warmup_s=g.warmup_s,
                   pool_bytes=g.pool_bytes, rounds=c,
                   launches=g.graph_launches[c])
    print(f"[graphs] {label}: runs of {c} rounds"
          f"{' + the check' if metric_fn else ''}: device {dev_ms:.3f} ms a "
          f"run over {runs} replays ({dev_ms / c:.4f} ms a round), host "
          f"{host:.3f} ms a run; capture {out['capture_s'] * 1e3:.1f} ms "
          f"(warm-up round {out['warmup_s'] * 1e3:.1f} ms), graph pool "
          f"{out['pool_bytes'] / 1e6:.2f} MB; kernel launches a run "
          f"{out['launches']}")
    return out


def stream_phase(c, args, failures):
    """Phase 5 (module docstring).  ``c`` holds phases 3-4's data and
    fits; returns the ``kmv_stream`` and ``kmv_stream_full`` entries of
    the kernels record."""
    import torch
    from repro_torch.api import KernelRidge, KernelSVM, SolverOptions
    from repro_torch.core import (BatchedPredictor, KernelConfig,
                                  LowRankGramOperator, StreamingGramOperator,
                                  krr_rel_residual, ksvm_predict,
                                  make_sstep_bdcd_round_fn,
                                  nystrom, pad_rounds, sstep_dcd_inner)
    from repro_torch.core.kernels import _chunk
    from repro_torch.kernels.gram import gram_cuda, gram_plain
    from repro_torch.kernels.kmv import kmv_cuda
    from repro_torch.kernels.kmv_stream import (full_launch,
                                                gather_rows_cuda,
                                                kmv_stream_cuda,
                                                kmv_stream_full_cuda,
                                                kmv_stream_full_plain,
                                                kmv_stream_full_resident,
                                                kmv_stream_plain,
                                                kmv_stream_resident)

    dev, m, n, rbf = c.dev, c.m, c.n, c.kernels["rbf"]
    CR = STREAM_CHUNK_ROWS
    f32, bf16 = torch.float32, torch.bfloat16

    # ---- a. parity ---------------------------------------------------
    t0 = time.perf_counter()
    A_h = c.A.cpu()
    A_d = {f32: c.A, bf16: c.A.to(bf16)}
    Xc_of = {(dt, cr): _chunk(A_h.to(dt), cr, pin=True)
             for dt in (f32, bf16) for cr in (CR, 6000)}
    print(f"[stream] pinned chunks of A built in "
          f"{time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{str(dt)[6:]} {cr} rows x {Xc.shape[0]}"
                      for (dt, cr), Xc in Xc_of.items()))
    err_at = {}
    t0 = time.perf_counter()
    cases = [(cfg_name, dt, cr, bname, xname)
             for dt in (f32, bf16) for cr in (CR, 6000)
             for bname in ("r32", "r256", "piece")
             for xname in ("vec", "mat4") for cfg_name in ("rbf",)]
    cases += [(k, f32, CR, "r256", "vec") for k in ("linear", "polynomial")]
    for kname, dt, cr, bname, xname in cases:
        cfg = c.kernels[kname]
        tol = TOL_KMV_F32 if dt == f32 else TOL_BF16
        Xc = Xc_of[(dt, cr)]
        B = (A_d[dt][:cr] if bname == "piece"
             else c.B_of[bname].to(dt)).contiguous()
        X = c.Xv if xname == "vec" else c.Xm
        Xvc = _chunk(X.reshape(m, -1), cr)
        got = kmv_stream_cuda(Xc, B, Xvc, cfg, m=m)
        want = kmv_stream_plain(Xc, B, Xvc, cfg, m=m)
        resident = kmv_cuda(A_d[dt], B, X, cfg).reshape(got.shape)
        poly = kname == "polynomial"
        for ref_name, ref in (("plain", want), ("resident kmv", resident)):
            ratio, err = allclose_ratio(got, ref, tol, poly)
            err_at[(kname, str(dt), cr, bname, xname, ref_name)] = err
            if not ratio <= 1.0 or got.shape != ref.shape:
                failures.append(f"kmv_stream {kname} {dt} cr={cr} {bname} "
                                f"{xname} vs {ref_name}: max abs err "
                                f"{err:.3e} ({ratio:.2f}x tolerance)")
    # the symmetric full matvec of every check, K(A, A) X
    full_cases = [(k, dt, cr, xname) for dt in (f32, bf16)
                  for cr in (CR, 6000) for xname in ("vec", "mat4")
                  for k in ("rbf",)]
    full_cases += [(k, f32, CR, "vec") for k in ("linear", "polynomial")]
    for kname, dt, cr, xname in full_cases:
        cfg = c.kernels[kname]
        tol = TOL_KMV_F32 if dt == f32 else TOL_BF16
        X = (c.Xv if xname == "vec" else c.Xm).reshape(m, -1)
        Xvc = _chunk(X, cr)
        got = kmv_stream_full_cuda(Xc_of[(dt, cr)], Xvc, cfg, m=m)
        want = kmv_stream_full_plain(Xc_of[(dt, cr)], Xvc, cfg, m=m)
        resident = kmv_cuda(A_d[dt], A_d[dt], X, cfg)
        poly = kname == "polynomial"
        for ref_name, ref in (("plain", want), ("resident kmv", resident)):
            ratio, err = allclose_ratio(got, ref, tol, poly)
            err_at[("full", kname, str(dt), cr, xname, ref_name)] = err
            if not ratio <= 1.0 or got.shape != ref.shape:
                failures.append(f"kmv_stream_full {kname} {dt} cr={cr} "
                                f"{xname} vs {ref_name}: max abs err "
                                f"{err:.3e} ({ratio:.2f}x tolerance)")
        if not torch.equal(got, kmv_stream_full_cuda(Xc_of[(dt, cr)], Xvc,
                                                     cfg, m=m)):
            failures.append(f"kmv_stream_full {kname} {dt} cr={cr} "
                            f"{xname}: a second call gave other bits")
        if (kname, dt, cr, xname) == ("rbf", f32, CR, "vec"):
            for drop, what in ((1, "pair (0, 1) without its mirror product"),
                               (2, "pair (0, tail chunk) left out")):
                bad = full_launch(Xc_of[(dt, cr)], Xvc, cfg, m, drop=drop)
                ratio, err = allclose_ratio(bad, want, tol)
                err_at[("full-wrong", what)] = (err, ratio)
                if ratio <= 1.0:
                    failures.append(f"kmv_stream_full check passes a wrong "
                                    f"pipe ({what}: {ratio:.2f}x)")
    sel = torch.cat([c.pick[:256], c.pick[:7]])       # with repeats
    for dt in (f32, bf16):
        got = gather_rows_cuda(Xc_of[(dt, CR)], sel)
        if not torch.equal(got, A_d[dt][sel]):
            failures.append(f"gather_rows {dt}: rows differ")
    torch.cuda.synchronize()
    n_cmp = sum(k[0] != "full-wrong" for k in err_at)
    print(f"[stream] {n_cmp} kmv_stream / kmv_stream_full comparisons and 2"
          f" gathers in {time.perf_counter() - t0:.1f} s; tolerances: f32 "
          f"{TOL_KMV_F32}, bf16 {TOL_BF16}, polynomial relative to max "
          f"|output|; gather exact")
    for key in (("rbf", "torch.float32", CR, "r32", "vec", "plain"),
                ("rbf", "torch.float32", CR, "r32", "vec", "resident kmv"),
                ("rbf", "torch.float32", CR, "piece", "mat4", "plain"),
                ("rbf", "torch.float32", 6000, "r256", "vec",
                 "resident kmv"),
                ("rbf", "torch.bfloat16", CR, "r256", "mat4", "plain"),
                ("polynomial", "torch.float32", CR, "r256", "vec",
                 "plain"),
                ("full", "rbf", "torch.float32", CR, "vec", "plain"),
                ("full", "rbf", "torch.float32", CR, "vec", "resident kmv"),
                ("full", "rbf", "torch.bfloat16", 6000, "mat4", "plain"),
                ("full", "polynomial", "torch.float32", CR, "vec",
                 "plain")):
        print(f"[stream] parity {' '.join(map(str, key))}: max abs err "
              f"{err_at[key]:.3e}")
    for key, (err, ratio) in ((k, v) for k, v in err_at.items()
                              if k[0] == "full-wrong"):
        print(f"[stream] kmv_stream_full with {key[1]}: max abs err "
              f"{err:.3e} ({ratio:.1f}x tolerance; must fail)")
    del A_d[bf16]
    for key in [k for k in Xc_of if k != (f32, CR)]:
        del Xc_of[key]
    if failures:
        return None

    # ---- b-d. the streamed and Nystrom paths ------------------------------
    for fn in (kmv_cuda, gram_cuda, kmv_stream_cuda, kmv_stream_full_cuda,
               gather_rows_cuda):
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    krr_s = KernelRidge(lam=1.0, kernel="rbf", device=dev,
                        options=SolverOptions(
                            method="sstep", s=8, b=32, stream=CR,
                            record=True, check_every=16,
                            max_iters=args.krr_iters, seed=args.seed))
    c.spy.take()
    r_ks = krr_s.fit(c.Ar.cpu(), c.yr, schedule=c.r_k.schedule)
    torch.cuda.synchronize()
    drivers = c.spy.take()
    print(f"[stream-krr] driver: {drivers[1]} eager loop, {drivers[0]} "
          f"captured (StreamingGramOperator.capturable = "
          f"{StreamingGramOperator.capturable})")
    if drivers != (0, 1):
        failures.append(f"the streamed K-RR fit took drivers {drivers}")
    growth = torch.cuda.max_memory_allocated() - base
    a_bytes = c.Ar.numel() * c.Ar.element_size()
    d_krr = float((r_ks.alpha - c.r_k.alpha).abs().max())
    h_s, h_r = r_ks.history, c.r_k.history
    d_hist = (float(abs(h_s - h_r).max() / abs(h_r).max())
              if h_s.shape == h_r.shape else float("inf"))
    print(f"[stream-krr] s=8 b=32 stream={CR}: {r_ks.iters_run} iters, "
          f"{r_ks.rounds_run} rounds, {len(h_s)} streamed residual checks,"
          f" {r_ks.wall_time_s:.2f} s (resident fit {c.r_k.wall_time_s:.2f}"
          f" s)")
    print(f"[stream-krr] max|a_stream - a_resident| = {d_krr:.3e} (bound "
          f"{TOL_SSTEP_VS_CLASSICAL}); residual history max rel diff "
          f"{d_hist:.3e} (bound {TOL_STREAM_METRIC}); last "
          f"{float(h_s[-1]):.4e}")
    print(f"[stream-krr] device memory growth during the fit: "
          f"{growth / 1e6:.1f} MB (A itself: {a_bytes / 1e6:.1f} MB)")
    if not d_krr <= TOL_SSTEP_VS_CLASSICAL:
        failures.append(f"streamed vs resident K-RR alpha {d_krr:.3e}")
    if not d_hist <= TOL_STREAM_METRIC:
        failures.append(f"streamed vs resident K-RR residuals {d_hist:.3e}")
    if not growth < a_bytes:
        failures.append(f"the streamed K-RR fit grew device memory by "
                        f"{growth} bytes, not below A's {a_bytes}")

    rounds = -(-c.r_s.iters_run // 32)
    svm_s = KernelSVM(C=1.0, kernel="rbf", device=dev,
                      options=SolverOptions(
                          method="sstep", s=32, stream=CR, record=True,
                          check_every=rounds, max_iters=args.svm_iters,
                          seed=args.seed))
    r_ss = svm_s.fit(c.A.cpu(), c.y, schedule=c.r_s.schedule)
    drivers = c.spy.take()
    print(f"[stream-ksvm] driver: {drivers[1]} eager loop, {drivers[0]} "
          f"captured")
    if drivers != (0, 1):
        failures.append(f"the streamed K-SVM fit took drivers {drivers}")
    d_svm = float((r_ss.alpha - c.r_s.alpha).abs().max())
    gap_s = float(r_ss.history[-1])
    d_gap = abs(gap_s - c.gap) / max(1.0, abs(c.gap))
    t0 = time.perf_counter()
    pred = BatchedPredictor(svm_s.op_, svm_s.alpha_ * svm_s.y_, batch=1024,
                            compact=True, stream=1024)
    f_qs = pred(c.Aq.cpu())
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    f_ref = ksvm_predict(c.A, c.y, r_ss.alpha, c.Aq[:64], svm_s.cfg)
    ratio, err = allclose_ratio(f_qs[:64], f_ref, TOL_ORACLE, True)
    print(f"[stream-ksvm] s=32 stream={CR}: {r_ss.iters_run} iters, "
          f"{r_ss.rounds_run} rounds, {r_ss.wall_time_s:.2f} s (resident "
          f"{c.r_s.wall_time_s:.2f} s)")
    print(f"[stream-ksvm] max|a_stream - a_resident| = {d_svm:.3e}; "
          f"streamed duality gap {gap_s:.6e} vs resident {c.gap:.6e} "
          f"(rel diff {d_gap:.3e})")
    print(f"[stream-ksvm] predict {f_qs.shape[0]} host queries in chunks of"
          f" 1024 on {pred.op.n_samples} support vectors: "
          f"{t_pred * 1e3:.1f} ms; vs dense oracle max abs err {err:.3e}")
    if not d_svm <= TOL_SSTEP_VS_CLASSICAL:
        failures.append(f"streamed vs resident K-SVM alpha {d_svm:.3e}")
    if not d_gap <= TOL_STREAM_METRIC:
        failures.append(f"streamed vs resident duality gap {d_gap:.3e}")
    if not (f_qs.shape == (c.q,) and bool(torch.isfinite(f_qs).all())
            and ratio <= 1.0):
        failures.append(f"streamed K-SVM predictions vs dense oracle "
                        f"{err:.3e}")

    nys = KernelRidge(lam=1.0, kernel="rbf", device=dev,
                      options=SolverOptions(
                          method="sstep", s=8, b=32, approx="nystrom",
                          landmarks=1024, landmark_method="uniform",
                          tol=1e-4, check_every=16, max_iters=args.krr_iters,
                          seed=args.seed))
    r_n = nys.fit(c.Ar, c.yr)
    c.nys = nys                      # phase 11 serves it
    p_n = nys.predict(c.Arq)
    torch.cuda.synchronize()
    drivers = c.spy.take()
    with mock.patch.object(LowRankGramOperator, "capturable", False):
        e_n = KernelRidge(lam=1.0, kernel="rbf", device=dev,
                          options=nys.options).fit(c.Ar, c.yr)
    e_drivers = c.spy.take()
    print(f"[nystrom] drivers: the fit {drivers[0]} captured, {drivers[1]} "
          f"eager; its refit with the operator not capturable "
          f"{e_drivers[1]} eager, {e_drivers[0]} captured")
    if drivers != (1, 0) or e_drivers != (0, 1):
        failures.append(f"the Nystrom fits took drivers {drivers}, "
                        f"{e_drivers}")
    for label, got, want in (("alpha", r_n.alpha, e_n.alpha),
                             ("residual history", r_n.history,
                              e_n.history)):
        same, diff = bit_equal(got, want)
        print(f"[nystrom] {label}: captured vs eager "
              f"{'equal bit for bit' if same else 'DIFFER'} (max abs diff "
              f"{diff:.3e})")
        if not same:
            failures.append(f"Nystrom captured vs eager {label}: {diff:.3e}")
    # the fit's runs as the facade builds them: the linear kernel over Phi
    lin = dataclasses.replace(nys.cfg, kernel=KernelConfig("linear"))
    Phi = nys.op_.Phi
    graph_timing("K-RR Nystrom l=1024 s=8 b=32",
                 make_sstep_bdcd_round_fn(Phi, c.yr, lin, 8, op=nys.op_),
                 torch.zeros_like(c.yr), pad_rounds(r_n.schedule, 8), 16,
                 metric_fn=lambda a: krr_rel_residual(Phi, c.yr, a, lin))
    launches = {"kmv_stream": kmv_stream_cuda.launches,
                "kmv_stream_full": kmv_stream_full_cuda.launches,
                "gather_rows": gather_rows_cuda.launches,
                "gram": gram_cuda.launches, "kmv": kmv_cuda.launches}
    print(f"[stream path] launches: " + ", ".join(
        f"{k} {v}" for k, v in launches.items()))
    if min(launches.values()) < 1:
        failures.append(f"a kernel of the stream/Nystrom path was never "
                        f"launched: {launches}")

    # the factor product against the same build through the plain versions
    fmap, jitter = nys.op_.fmap, 1e-6
    L = fmap.landmarks
    sidx = c.pick[:512]
    A_s = c.Ar[sidx].contiguous()

    def plain_map():
        lam, V = torch.linalg.eigh(gram_plain(L, L, rbf))
        T = (V * torch.clamp(lam, min=jitter) ** -0.5) @ V.T
        return lam, T, gram_plain(A_s, L, rbf) @ T

    lam, T_p, Phi_p = plain_map()
    # a relative error d in K_LL moves K_LL^{-1} by up to kappa * d
    kappa = float(lam.max() / torch.clamp(lam.min(), min=jitter))
    tol_phi = TOL_NYSTROM_EPS_KAPPA * F32_EPS * kappa
    Phi_k = nys.op_.Phi[sidx]
    P_p = Phi_p @ Phi_p.T
    ratio, err = allclose_ratio(Phi_k @ Phi_k.T, P_p, tol_phi, True)
    # what a build with TF32 products would read against the same check
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        Phi_t = plain_map()[2]
        P_t = Phi_t @ Phi_t.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ratio_t, err_t = allclose_ratio(P_t, P_p, tol_phi, True)
    w_p = (gram_plain(c.Ar, L, rbf) @ T_p).T @ r_n.alpha
    f_ref = (gram_plain(c.Arq[:64].contiguous(), L, rbf) @ T_p) @ w_p
    ratio_f, err_f = allclose_ratio(p_n[:64], f_ref / nys.cfg.lam, tol_phi,
                                    True)
    k_err = nystrom.nystrom_kernel_error(c.Ar[:2048].contiguous(), L, rbf)
    hist = [float(v) for v in r_n.history]
    print(f"[nystrom] l=1024 uniform: {r_n.iters_run} iters, "
          f"{r_n.rounds_run} rounds, converged={r_n.converged}, "
          f"{r_n.wall_time_s:.2f} s; residual history "
          + " ".join(f"{v:.4e}" for v in hist))
    print(f"[nystrom] K_LL eigenvalues {float(lam.min()):.4e} .. "
          f"{float(lam.max()):.4e} (floor {jitter}), kappa {kappa:.1f}: "
          f"Phi Phi^T on 512 rows vs plain build max abs err {err:.3e} "
          f"({ratio:.3f} x tolerance {tol_phi:.2e} = "
          f"{TOL_NYSTROM_EPS_KAPPA:g} x f32 eps x kappa); a TF32 build "
          f"reads {err_t:.3e} ({ratio_t:.3f} x tolerance); predictions vs "
          f"plain map max abs err {err_f:.3e}")
    print(f"[nystrom] kernel error ||K - Phi Phi^T||_F / ||K||_F on 2048 "
          f"rows: {k_err:.4e}")
    if not ratio <= 1.0:
        failures.append(f"Nystrom factor product vs plain build {err:.3e}")
    if not (ratio_f <= 1.0 and p_n.shape == (c.q,)
            and bool(torch.isfinite(p_n).all())):
        failures.append(f"Nystrom predictions vs plain map {err_f:.3e}")
    if not (hist and all(v == v for v in hist) and hist[-1] < hist[0]):
        failures.append(f"Nystrom residual history does not fall: {hist}")
    if not 0.0 <= k_err < 1.0:
        failures.append(f"Nystrom kernel error {k_err}")
    if failures:
        return None

    # ---- e. pipelined, copy-only and compute-only times -------------------
    Xc = Xc_of[(f32, CR)]
    nc = Xc.shape[0]
    Xc_dev = Xc.to(dev)
    slots = torch.empty((2, CR, n), device=dev)

    def copy_only():                      # the library yardstick: the
        for i in range(nc):               # same chunks, one stream
            slots[i % 2].copy_(Xc[i], non_blocking=True)

    Xvc = _chunk(c.Xv[:, None], CR)
    x_bytes = Xc.numel() * Xc.element_size()       # copied, padded tail too
    a_bytes = m * n * Xc.element_size()            # what K(A,B)^T X must move
    copy_ms = time_cuda(copy_only, 10)
    rows = {}
    for label, B, iters in (("r32", c.B_of["r32"], 10),
                            ("r256", c.B_of["r256"], 5),
                            ("piece", c.A[:CR].contiguous(), 3)):
        r = B.shape[0]
        ms = time_cuda(lambda: kmv_stream_cuda(Xc, B, Xvc, rbf, m=m), iters)
        comp = time_cuda(lambda: kmv_stream_resident(Xc_dev, B, Xvc, rbf,
                                                     m=m), iters)
        plain = time_cuda(lambda: kmv_stream_plain(Xc, B, Xvc, rbf, m=m),
                          iters)
        flops = 2 * m * r * n + 2 * m * r + 2 * (m + r) * n + 6 * m * r
        t_link, t_ops = a_bytes / PCIE_H2D_BYTES_PER_S, flops / FP32_FLOP_PER_S
        b_ms = max(t_link, t_ops) * 1e3
        b_by = "bytes" if t_link >= t_ops else "operations"
        rows[label] = dict(ms=ms, copy=copy_ms, comp=comp, plain=plain,
                           bound=b_ms, by=b_by, r=r)
        print(f"[stream-time] kmv_stream rbf ({m}, {r}, {n}) c=1 in {nc} "
              f"chunks of {CR}: pipelined {ms:.4f} ms | copy-only "
              f"{copy_ms:.4f} ms ({x_bytes / copy_ms / 1e6:.1f} GB/s) | "
              f"compute-only {comp:.4f} ms | plain {plain:.4f} ms | bound "
              f"{b_ms:.4f} ms ({b_by}, {b_ms / ms:.1%} of it) | overlap: "
              f"pipelined / max(copy, compute) = "
              f"{ms / max(copy_ms, comp):.3f}")
    for k in (32, 256):                   # the rows a round gathers
        g_ms = time_cuda(lambda: gather_rows_cuda(Xc, c.pick[:k]), 20)
        print(f"[stream-time] gather_rows of {k} sampled rows "
              f"({k * n * 4 / 1e6:.2f} MB read from the mapped host "
              f"buffer): {g_ms:.4f} ms")
    t0 = time.perf_counter()
    op = StreamingGramOperator.from_dense(c.A, rbf, CR, device=dev)
    t1 = time.perf_counter()
    op.scale_rows(c.y)
    t2 = time.perf_counter()
    print(f"[stream-time] streamed representation build, A (on the card "
          f"here) to pinned chunks: {(t1 - t0) * 1e3:.1f} ms; K-SVM "
          f"scale_rows on the host into new pinned chunks: "
          f"{(t2 - t1) * 1e3:.1f} ms")
    op_svm = svm_s.op_.scale_rows(c.y)
    idx_s, valid_s = pad_rounds(r_ss.schedule, 32)
    a_s, cfg_svm = r_ss.alpha, svm_s.cfg
    sk, sl = phase_split(
        lambda k: op_svm.round_data(idx_s[k], a_s),
        lambda k, d: sstep_dcd_inner(d[0], d[1], a_s[idx_s[k]], idx_s[k],
                                     cfg_svm.nu, cfg_svm.omega, 32,
                                     valid_s[k]), min(16, len(idx_s)))
    print(f"[rounds] streamed K-SVM s=32: kernel phase {sk:.3f} ms "
          f"(gather, gram, kmv_stream), local phase {sl:.3f} ms, local "
          f"share {sl / (sk + sl):.1%}")
    del op_svm
    # the full matvec K(A, A) x of every check: the symmetric pipe, its
    # chunk copies alone (in its order, through its three slots), its
    # launches over resident chunks, the resident symmetric KMV and the
    # ten-piece route of PR 12-17 (one kmv_stream_cuda a chunk of output
    # rows, built here as a yardstick only)
    Xvc1 = _chunk(c.Xv[:, None], CR)
    order = [0] + [j for i in range(nc) for j in range(nc - 1, i, -1)]
    slots3 = torch.empty((3, CR, n), device=dev)

    def full_copy_only():
        for k, j in enumerate(order):
            slots3[k % 3].copy_(Xc[j], non_blocking=True)

    def pieces():
        return torch.cat([kmv_stream_cuda(
            Xc, Xc[j].to(dev, non_blocking=True), Xvc1, rbf, m=m)
            for j in range(nc)])[:m]

    full_s = time_cuda(lambda: op.full_matvec(c.Xv), 3, warmup=1)
    full_copy = time_cuda(full_copy_only, 3)
    full_c = time_cuda(lambda: kmv_stream_full_resident(Xc_dev, Xvc1, rbf,
                                                        m=m), 3)
    full_r = time_cuda(lambda: kmv_cuda(c.A, c.A, c.Xv, rbf), 2, warmup=1)
    full_p = time_cuda(pieces, 2, warmup=1)
    full_plain = time_cuda(lambda: kmv_stream_full_plain(Xc, Xvc1, rbf,
                                                         m=m), 2)
    # K(A, A) is symmetric: the work of its m (m + 1) / 2 distinct
    # entries (as phase 6 counts the resident B = A row), against A's
    # bytes over the link once
    pairs = m * (m + 1) // 2
    t_link = a_bytes / PCIE_H2D_BYTES_PER_S
    t_ops = (2 * pairs * n + 2 * m * m + 4 * m * n + 6 * pairs) \
        / FP32_FLOP_PER_S
    full_b = max(t_link, t_ops) * 1e3
    full_by = "bytes" if t_link >= t_ops else "operations"
    del slots3
    print(f"[stream-time] full K @ x ({m}^2 x {n}) c=1, symmetric pipe "
          f"({len(order)} chunk copies, {nc} anchors): {full_s:.2f} ms "
          f"({full_b / full_s:.1%} of its bound {full_b:.2f} ms, "
          f"{full_by}) | copy-only {full_copy:.2f} ms "
          f"({len(order) * Xc[0].numel() * 4 / full_copy / 1e6:.1f} GB/s) "
          f"+ compute-only {full_c:.2f} ms ({full_b / full_c:.1%}) = "
          f"{full_copy + full_c:.2f} ms | resident symmetric kmv "
          f"{full_r:.2f} ms ({full_b / full_r:.1%}) | ten-piece route "
          f"{full_p:.2f} ms ({full_b / full_p:.1%}) | plain pair loop "
          f"{full_plain:.2f} ms")
    print(f"[stream-time] launches on the streamed fits: kmv_stream "
          f"{launches['kmv_stream']}, kmv_stream_full "
          f"{launches['kmv_stream_full']}, gather_rows "
          f"{launches['gather_rows']}")
    if not full_s < full_copy + full_c:
        failures.append(f"the symmetric pipe does not overlap: streamed full "
                        f"KMV {full_s:.2f} ms >= copy-only {full_copy:.2f} "
                        f"+ compute-only {full_c:.2f} ms")
    del Xc_dev, slots
    r32 = rows["r32"]
    return [{"name": "kmv_stream", "route": "cuda",
            "source": "src/repro_torch/csrc/kmv_stream.cu",
            "replaces": "src/repro/kernels/kmv_stream.py:111",
            "shape": f"rbf (m, r, n, c) = ({m}, 32, {n}, 1) in {nc} pinned "
                     f"chunks of {CR}",
            "launches": launches["kmv_stream"],
            "max_abs_err": err_at[("rbf", "torch.float32", CR, "r32", "vec",
                                   "plain")],
            "ms": r32["ms"], "plain_ms": r32["plain"],
            "bound_ms": r32["bound"], "bound_by": r32["by"],
            "library_ms": None, "copy_only_ms": r32["copy"],
            "compute_only_ms": r32["comp"],
            "gather_rows_launches": launches["gather_rows"]}, {
            "name": "kmv_stream_full", "route": "cuda",
            "source": "src/repro_torch/csrc/kmv_stream.cu",
            "replaces": "src/repro/kernels/kmv_stream.py:111",
            "shape": f"rbf full matvec K(A, A) x, (m, n, c) = ({m}, {n}, 1)"
                     f" in {nc} pinned chunks of {CR}, {len(order)} chunk "
                     f"copies",
            "launches": launches["kmv_stream_full"],
            "max_abs_err": err_at[("full", "rbf", "torch.float32", CR,
                                   "vec", "plain")],
            "ms": full_s, "plain_ms": full_plain, "bound_ms": full_b,
            "bound_by": full_by, "library_ms": None,
            "copy_only_ms": full_copy, "compute_only_ms": full_c,
            "resident_kmv_ms": full_r, "ten_piece_route_ms": full_p}]



def sweep_phase(c, args, failures):
    """Phase 9 (module docstring), on phases 3-4's data and fits in ``c``:
    KMV at c = F, the K-RR and K-SVM fleets, the autotuner, a streamed fit
    with its chunk rows from the device's budget, the warm-started path
    and cross-validation.  Returns the c = F KMV entries of the kernels
    record."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.api import KernelRidge, KernelSVM, SolverOptions
    from repro_torch.core import ExactGramOperator, pad_rounds
    from repro_torch.core.perf_model import stream_working_set_bytes
    from repro_torch.kernels.gram import gram_cuda
    from repro_torch.kernels.kmv import (WS_MAX_FLOATS, KmvPlan, kmv_cuda,
                                         kmv_plain, kmv_plan)
    from repro_torch.kernels.kmv import launch as kmv_launch
    from repro_torch.kernels._launch import check_inputs, sm_count
    from repro_torch.core.loop import FAST_RUN
    from repro_torch.tune import cross_validate, reg_path, solve_fleet
    from repro_torch.tune.fleet import fleet_metric

    dev, m, n, A, Ar = c.dev, c.m, c.n, c.A, c.Ar
    rbf = c.kernels["rbf"]
    sms = sm_count(0)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 9)
    t_phase = time.perf_counter()

    def counts():
        return kmv_cuda.launches, gram_cuda.launches

    def reset():
        for fn in (kmv_cuda, gram_cuda):
            fn.launches = fn.warmup_launches = 0

    # ---- 9a. KMV at c = F ---------------------------------------------
    code = check_inputs("kmv", A, A)
    kmv_at = {}
    ones = {}       # the c = 1 time of each B, measured once
    for label, B, F in (("K-RR fleet round", c.B_of["r256"], 16),
                        ("K-SVM fleet round", c.B_of["r32"], 8),
                        ("full matvec, B = A", A, 4),
                        ("full matvec, B = A", A, 8),
                        ("full matvec, B = A", A, 16)):
        r = B.shape[0]
        X = torch.randn((m, F), generator=gen, device=dev)
        plan = kmv_plan(m, r, F, sms, B is A)
        got = kmv_cuda(A, B, X, rbf)
        want = kmv_plain(A, B, X, rbf)
        ratio, err = allclose_ratio(got, want, TOL_KMV_F32)
        same = torch.equal(got, kmv_cuda(A, B, X, rbf))
        iters = 2 if B is A else 10
        ms = time_queued(lambda: kmv_cuda(A, B, X, rbf), iters)
        if label not in ones:
            ones[label] = time_queued(lambda: kmv_cuda(A, B, X[:, 0], rbf),
                                      iters)
        one = ones[label]
        plain = time_queued(lambda: kmv_plain(A, B, X, rbf), 1 if B is A
                            else iters)
        pairs = m * (m + 1) // 2 if B is A else m * r
        nbytes = 4 * (m * n + (0 if B is A else r * n) + m * F + r * F)
        flops = 2 * pairs * n + 2 * m * r * F + 2 * (m + r) * n + 6 * pairs
        b_ms, b_by = bound_ms(nbytes, flops)
        row = dict(label=label, r=r, F=F, plan=plan, err=err, ms=ms,
                   one=one, plain=plain, bound=b_ms, by=b_by)
        if B is A and F >= 8:
            # the plan kmv_plan took before the symmetric workspace limit:
            # every tile, the split in runs of whole tiles
            m_tiles = -(-m // 128)
            per = -(-m_tiles // min(m_tiles, WS_MAX_FLOATS // (r * F)))
            wide = KmvPlan("wide", 128, 128, -(-m_tiles // per), per * 128)
            row["wide"] = time_queued(
                lambda: kmv_launch(A, A, X, rbf, wide, code), iters)
            wide_err = float((kmv_launch(A, A, X, rbf, wide, code)
                              - want).abs().max())
            row["wide_err"] = wide_err
        if B is A and F == 16:
            bad = kmv_launch(A, A, X, rbf,
                             plan._replace(splits=plan.splits - 1), code)
            bad_ratio, bad_err = allclose_ratio(bad, want, TOL_KMV_F32)
            print(f"[sweep] kmv c=16 B = A ({plan.regime}) with its last m "
                  f"split left out: max abs err {bad_err:.3e} "
                  f"({bad_ratio:.1f}x tolerance; must fail)")
            if bad_ratio <= 1.0:
                failures.append("the c = 16 KMV check passes a kernel with "
                                "its last split left out")
        kmv_at[(label, F)] = row
        print(f"[sweep] kmv rbf ({m}, {r}, {n}) c={F} [{plan.regime} "
              f"{plan.bm} x {plan.br}, {plan.splits} splits]: {ms:.4f} ms "
              f"against {F} x c=1 {F * one:.4f} ms (c=1 {one:.4f}) | plain "
              f"{plain:.4f} ms | bound {b_ms:.4f} ms ({b_by}, "
              f"{b_ms / ms:.1%} of it) | max abs err {err:.3e}"
              + (f" | the wide plan of the same call {row['wide']:.4f} ms "
                 f"(max abs err {row['wide_err']:.3e})" if "wide" in row
                 else ""))
        if not ratio <= 1.0:
            failures.append(f"kmv c={F} {label}: {err:.3e} ({ratio:.2f}x "
                            f"tolerance)")
        if not same:
            failures.append(f"kmv c={F} {label}: a second call gave other "
                            f"bits")
    del X, got, want
    torch.cuda.empty_cache()

    # ---- 9b. the K-RR fleet -------------------------------------------
    lams = np.delete(np.logspace(-2, 2, 17), 1)         # 16, 1.0 among them
    i_one, i_big = int(np.argmin(abs(lams - 1.0))), len(lams) - 1
    opts_k = c.krr.options
    full_k = api._schedule("krr", opts_k, m, 32, dev)   # phase 4's draw
    if not torch.equal(full_k[:c.r_k.iters_run], c.r_k.schedule):
        failures.append("the redrawn K-RR schedule is not phase 4's")
    c.spy.take()
    reset()
    fk = solve_fleet(Ar, c.yr, lams=lams, kernel="rbf", options=opts_k,
                     schedule=full_k, device=dev)
    fk_counts = counts()
    fk_warm = (kmv_cuda.warmup_launches, gram_cuda.warmup_launches)
    drivers = c.spy.take()
    checks = fk.history.shape[0]
    want_counts = (fk.rounds_run + checks, fk.rounds_run)
    print(f"[sweep] K-RR fleet, F = {len(lams)} lambdas "
          f"{lams.min():.0e}..{lams.max():.0e}, s=8 b=32 tol="
          f"{opts_k.tol:g}: {fk.rounds_run} rounds, {checks} checks, "
          f"converged {int(fk.converged.sum())}/{len(lams)}, "
          f"{fk.wall_time_s:.2f} s against {len(lams)} x the single fit's "
          f"{c.r_k.wall_time_s:.2f} s = {len(lams) * c.r_k.wall_time_s:.2f}"
          f" s ({len(lams) * c.r_k.wall_time_s / fk.wall_time_s:.1f}x)")
    print(f"[sweep] K-RR fleet launches: kmv {fk_counts[0]}, gram "
          f"{fk_counts[1]} (one each a round for the whole fleet, one kmv "
          f"a check: {want_counts}); warm-up kmv {fk_warm[0]}, gram "
          f"{fk_warm[1]}; drivers {drivers[0]} captured, {drivers[1]} eager")
    if fk_counts != want_counts:
        failures.append(f"K-RR fleet launches {fk_counts}, not {want_counts}")
    if drivers != (1, 0):
        failures.append(f"the K-RR fleet did not run captured: {drivers}")
    r_big = KernelRidge(lam=float(lams[i_big]), kernel="rbf", device=dev,
                        options=opts_k).fit(Ar, c.yr, schedule=full_k)
    f1 = solve_fleet(Ar, c.yr, lams=[1.0], kernel="rbf", options=opts_k,
                     schedule=full_k, device=dev)
    c.spy.take()
    for label, got, want in (
            ("member lambda = 1 vs phase 4", fk.alpha[i_one], c.r_k.alpha),
            (f"member lambda = {lams[i_big]:g} vs its single fit",
             fk.alpha[i_big], r_big.alpha)):
        ratio, err = allclose_ratio(got, want, TOL_ITERATE)
        print(f"[sweep] K-RR fleet {label}: max abs err {err:.3e} (bound "
              f"{TOL_ITERATE})")
        if not ratio <= 1.0:
            failures.append(f"K-RR fleet {label}: {err:.3e}")
    for label, got, want in (("alpha", f1.alpha[0], c.r_k.alpha),
                             ("residual history", f1.history[:, 0],
                              c.r_k.history)):
        same, diff = bit_equal(got, want)
        print(f"[sweep] K-RR fleet F = 1 vs phase 4's fit: {label} "
              f"{'equal bit for bit' if same else 'DIFFERS'} (max abs diff "
              f"{diff:.3e})")
        if not same:
            failures.append(f"the F = 1 K-RR fleet's {label} differs from "
                            f"phase 4's: {diff:.3e}")
    # the frozen members: on this data every lambda's residual falls alike
    # (it is the share of coordinates not yet drawn), so a member warm
    # started at phase 4's solution converges at the first check while a
    # cold one needs about half the budget; cut at that check, the warm
    # member's alpha must be the full run's bit for bit, the cold one's
    # must have moved on
    tol_f = float(c.r_k.history[len(c.r_k.history) // 2])
    opts_f = dataclasses.replace(opts_k, tol=tol_f)
    warm = torch.stack((c.r_k.alpha, torch.zeros_like(c.r_k.alpha)))
    ff = solve_fleet(Ar, c.yr, lams=[1.0, 1.0], kernel="rbf",
                     options=opts_f, schedule=full_k, warm_start=warm,
                     device=dev)
    done_at = [int(np.argmax(ff.history[:, j] <= tol_f)) + 1
               if ff.converged[j] else None for j in range(2)]
    fc = solve_fleet(Ar, c.yr, lams=[1.0, 1.0], kernel="rbf",
                     options=opts_f, warm_start=warm, device=dev,
                     schedule=full_k[:opts_k.check_every * 8])
    c.spy.take()
    same, diff = bit_equal(fc.alpha[0], ff.alpha[0])
    moved = not bit_equal(fc.alpha[1], ff.alpha[1])[0]
    print(f"[sweep] K-RR fleet of a warm and a cold member, tol "
          f"{tol_f:.4e} (phase 4's residual at its check "
          f"{len(c.r_k.history) // 2 + 1}): done at checks {done_at} of "
          f"{ff.history.shape[0]}; the warm member's alpha cut at its check "
          f"vs the full run's {'equal bit for bit' if same else 'DIFFERS'} "
          f"(max abs diff {diff:.3e}), the cold one's "
          f"{'moved on' if moved else 'DID NOT MOVE'}")
    if not (same and moved and done_at[0] == 1
            and (done_at[1] or 0) > 1):
        failures.append(f"the frozen-member check: warm member done at "
                        f"{done_at}, bit equal {same}, cold moved {moved}")

    # ---- 9c. the K-SVM fleet ------------------------------------------
    Cs = np.array([0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0])
    opts_s = c.svm.options
    reset()
    fs = solve_fleet(A, c.y, Cs=Cs, kernel="rbf", options=opts_s,
                     schedule=c.r_s.schedule, device=dev)
    fs_counts = counts()
    drivers = c.spy.take()
    c.fleets = SimpleNamespace(lams=lams, alpha_k=fk.alpha, Cs=Cs,
                               alpha_s=fs.alpha)   # phase 11 serves them
    print(f"[sweep] K-SVM fleet, F = {len(Cs)} Cs {Cs.min():g}..{Cs.max():g}"
          f", s=32: {fs.rounds_run} rounds, {fs.wall_time_s:.2f} s against "
          f"{len(Cs)} x the single fit's {c.r_s.wall_time_s:.2f} s = "
          f"{len(Cs) * c.r_s.wall_time_s:.2f} s; launches kmv "
          f"{fs_counts[0]}, gram {fs_counts[1]}; drivers {drivers}")
    if fs_counts != (fs.rounds_run, fs.rounds_run):
        failures.append(f"K-SVM fleet launches {fs_counts}, not one kmv and "
                        f"one gram a round ({fs.rounds_run})")
    if drivers != (1, 0):
        failures.append(f"the K-SVM fleet did not run captured: {drivers}")
    s_one = int(np.argmin(abs(Cs - 1.0)))
    r_c25 = KernelSVM(C=0.25, kernel="rbf", device=dev,
                      options=opts_s).fit(A, c.y, schedule=c.r_s.schedule)
    f1s = solve_fleet(A, c.y, Cs=[1.0], kernel="rbf", options=opts_s,
                      schedule=c.r_s.schedule, device=dev)
    c.spy.take()
    for label, got, want in (
            ("member C = 1 vs phase 3", fs.alpha[s_one], c.r_s.alpha),
            ("member C = 0.25 vs its single fit", fs.alpha[1], r_c25.alpha)):
        ratio, err = allclose_ratio(got, want, TOL_ITERATE)
        print(f"[sweep] K-SVM fleet {label}: max abs err {err:.3e} (bound "
              f"{TOL_ITERATE})")
        if not ratio <= 1.0:
            failures.append(f"K-SVM fleet {label}: {err:.3e}")
    same, diff = bit_equal(f1s.alpha[0], c.r_s.alpha)
    print(f"[sweep] K-SVM fleet F = 1 vs phase 3's fit: alpha "
          f"{'equal bit for bit' if same else 'DIFFERS'} (max abs diff "
          f"{diff:.3e})")
    if not same:
        failures.append(f"the F = 1 K-SVM fleet differs from phase 3: "
                        f"{diff:.3e}")

    # the fleet rounds replayed: device ms a round and a check, capture
    op_k = ExactGramOperator(Ar, rbf)
    params_k = torch.tensor(lams, dtype=torch.float32, device=dev)
    rf_k = api._round_fn("krr", Ar, c.yr, c.krr.cfg, 8, None, op_k,
                         params_k)
    xs_k = pad_rounds(full_k, 8)
    a0_k = torch.zeros((len(lams), m), device=dev)
    met_k = fleet_metric("krr", op_k, Ar, c.yr, c.krr.cfg, opts_k, lams)
    g_round = graph_timing(f"K-RR fleet F={len(lams)}", rf_k, a0_k, xs_k,
                           FAST_RUN)
    g_check = graph_timing(f"K-RR fleet F={len(lams)}, each run ending in "
                           f"its check", rf_k, a0_k, xs_k,
                           opts_k.check_every, metric_fn=met_k)
    op_s = ExactGramOperator(A, rbf).scale_rows(c.y)
    rf_s = api._round_fn("ksvm", A, c.y, c.svm.cfg, 32, None, op_s,
                         torch.tensor(Cs, dtype=torch.float32, device=dev))
    g_svm = graph_timing(f"K-SVM fleet F={len(Cs)}", rf_s,
                         torch.zeros((len(Cs), m), device=dev),
                         pad_rounds(c.r_s.schedule, 32), FAST_RUN)
    c.spy.take()
    check_ms = g_check["run_ms"] - opts_k.check_every * g_round["round_ms"]
    kr = kmv_at[("K-RR fleet round", 16)]
    print(f"[sweep] K-RR fleet F=16 replayed: {g_round['round_ms']:.4f} ms a "
          f"round (its KMV c=16 {kr['ms']:.4f} ms), a check "
          f"{check_ms:.2f} ms (KMV c=16 B = A "
          f"{kmv_at[('full matvec, B = A', 16)]['ms']:.2f} ms), capture "
          f"{g_check['capture_s'] * 1e3:.1f} ms; K-SVM fleet F=8: "
          f"{g_svm['round_ms']:.4f} ms a round, capture "
          f"{g_svm['capture_s'] * 1e3:.1f} ms")
    del rf_k, op_k, rf_s, op_s, a0_k
    fleet_counts = (fk_counts[0] + fs_counts[0], fk_counts[1] + fs_counts[1])

    # ---- 9d. the autotuner and stream="auto" ----------------------------
    # phase 4 never reaches its tol (its residual is the share of
    # coordinates not yet drawn, 0.19 after its 2048 x 32 updates): the
    # tuned fit must reach what phase 4 had at TUNED_CHECK (a depth cut)
    tol_k = max(opts_k.tol, float(c.r_k.history[TUNED_CHECK - 1]))
    opts_a = SolverOptions(s="auto", b="auto", probe=2, tol=tol_k,
                           check_every=opts_k.check_every,
                           max_iters=TUNED_MAX_ITERS, seed=args.seed)
    ra = KernelRidge(lam=1.0, kernel="rbf", device=dev,
                     options=opts_a).fit(Ar, c.yr)
    c.spy.take()
    plan = ra.plan
    top = sorted((f for f in plan.frontier if f["feasible"]),
                 key=lambda f: (f["time"], f["s"], f["b"]))[:5]
    print(f"[tune] KernelRidge(s='auto', b='auto', probe=2): budget "
          f"{plan.budget.hbm_bytes / 2 ** 30:.2f} GiB free device memory, "
          f"link {plan.budget.dma_bps / 1e9:.2f} GB/s (measured); "
          f"{len(plan.frontier)} candidates, the modeled top 5: "
          + ", ".join(f"s={f['s']} b={f['b']} {f['time']:.4f} s"
                      for f in top))
    for p in plan.probed:
        print(f"[tune] probe s={p['s']} b={p['b']}: {p['measured_s'] * 1e3:.3f}"
              f" ms device time of 2 replayed rounds (fit wall "
              f"{p['wall_s'] * 1e3:.1f} ms, its capture "
              f"{p['capture_s'] * 1e3:.1f} ms and warm-up "
              f"{p['warmup_s'] * 1e3:.1f} ms excluded)")
    print(f"[tune] winner s={ra.options.s} b={ra.options.b}: "
          f"{ra.iters_run} iters, {ra.rounds_run} rounds, converged="
          f"{ra.converged}, last residual {float(ra.history[-1]):.4e} "
          f"(tol {tol_k:.4e}: phase 4's residual at check {TUNED_CHECK}, "
          f"after {TUNED_CHECK * opts_k.check_every * 8 * 32} coordinate "
          f"updates), {ra.wall_time_s:.2f} s; modeled "
          f"{plan.modeled['time']:.4f} s")
    if not (ra.converged and float(ra.history[-1]) <= tol_k):
        failures.append(f"the autotuned K-RR fit did not reach phase 4's "
                        f"residual {tol_k:.3e}")
    # its shape replayed: where its wall goes beside the probe's rounds
    s_a, b_a = ra.options.s, ra.options.b
    op_a = ExactGramOperator(Ar, rbf)
    rf_a = api._round_fn("krr", Ar, c.yr, c.krr.cfg, s_a, None, op_a)
    xs_a = pad_rounds(api._schedule("krr", ra.options, m, b_a, dev), s_a)
    graph_timing(f"K-RR autotuned s={s_a} b={b_a}, each run ending in its "
                 f"check", rf_a, torch.zeros_like(c.yr), xs_a,
                 opts_k.check_every, runs=2,
                 metric_fn=lambda a: api._metric_fn(
                     "krr", op_a, Ar, c.yr, c.krr.cfg, ra.options)(a))
    c.spy.take()
    del op_a, rf_a, xs_a
    if not all(p["measured_s"] < p["wall_s"] for p in plan.probed):
        failures.append("a probe's measured time holds its capture")

    opts_st = dataclasses.replace(opts_k, stream=True, tol=0.0, record=True,
                                  max_iters=STREAM_AUTO_CHECKS
                                  * opts_k.check_every * 8)
    # the same fit at phase 5b's 2048-row chunks, first (it pays any cold
    # pinned allocation): the chosen chunk must not read slower (a 128-row
    # chunk, which the JAX model alone would pick, makes a check 12 403
    # one-tile pair launches)
    r2k = KernelRidge(lam=1.0, kernel="rbf", device=dev,
                      options=dataclasses.replace(opts_st, stream=2048)).fit(
        Ar.cpu(), c.yr, schedule=full_k[:opts_st.max_iters])
    c.spy.take()
    rst = KernelRidge(lam=1.0, kernel="rbf", device=dev,
                      options=opts_st).fit(
        Ar.cpu(), c.yr, schedule=full_k[:opts_st.max_iters])
    drivers = c.spy.take()
    cr = rst.options.stream
    ws = stream_working_set_bytes(cr, n, 8 * 32, slots=rst.plan.budget.slots)
    h_s, h_r = rst.history, c.r_k.history[:len(rst.history)]
    d_hist = float(abs(h_s - h_r).max() / abs(h_r).max())
    print(f"[tune] KernelRidge(stream=True): {cr} chunk rows chosen "
          f"({-(-m // cr)} chunks), link {rst.plan.budget.dma_bps / 1e9:.2f}"
          f" GB/s, working set {ws / 1e6:.1f} MB of {rst.plan.budget.slots}"
          f" slots against a budget of "
          f"{rst.plan.budget.stream_bytes / 1e9:.2f} GB; {rst.rounds_run} "
          f"rounds and {len(h_s)} checks (a depth cut of phase 5b's), "
          f"{rst.wall_time_s:.2f} s; residual history vs phase 4's max rel "
          f"diff {d_hist:.3e} (bound {TOL_STREAM_METRIC}); drivers "
          f"{drivers}")
    if not d_hist <= TOL_STREAM_METRIC:
        failures.append(f"stream=True residuals vs phase 4's {d_hist:.3e}")
    print(f"[tune] the same fit at 2048-row chunks: {r2k.wall_time_s:.3f} s "
          f"against the chosen {cr} rows' {rst.wall_time_s:.3f} s (must be "
          f"at most {STREAM_AUTO_SLACK}x it; chunk floor "
          f"{rst.plan.budget.min_chunk_rows} rows, the fewest whose chunk "
          f"pair has a 128 x 128 tile for every SM)")
    if not rst.wall_time_s <= STREAM_AUTO_SLACK * r2k.wall_time_s:
        failures.append(f"stream=True chose {cr}-row chunks: "
                        f"{rst.wall_time_s:.3f} s against 2048 rows' "
                        f"{r2k.wall_time_s:.3f} s")

    # ---- 9e. the warm-started path and cross-validation ----------------
    lams_p = [100.0, 10.0, 1.0, 0.1]
    t0 = time.perf_counter()
    path = reg_path(Ar, c.yr, lams=lams_p, kernel="rbf", options=opts_f,
                    schedule=full_k, device=dev)
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t0
    c.spy.take()
    cold = []
    for v in path.values:           # cold iterations to tol_f: the 16-lambda
        j = int(np.argmin(abs(lams - v)))     # fleet's members, which ran
        below = fk.history[:, j] <= tol_f     # every check on this schedule
        cold.append(int(np.argmax(below) + 1) * opts_k.check_every * 8
                    if below.any() else opts_k.max_iters)
    warm = [r.iters_run for r in path.results]
    print(f"[sweep] reg_path lambda {[float(v) for v in path.values]}, "
          f"tol {tol_f:.4e}: iterations warm "
          f"{warm} (total {sum(warm)}) against cold {cold} (total "
          f"{sum(cold)}), last residuals "
          + " ".join(f"{float(r.history[-1]):.2e}" for r in path.results)
          + f"; {t_path:.2f} s")
    if not sum(warm) <= sum(cold):
        failures.append(f"the warm-started path took more iterations "
                        f"({sum(warm)}) than cold fits ({sum(cold)})")
    opts_cv = dataclasses.replace(opts_k, max_iters=512)
    t0 = time.perf_counter()
    cv = cross_validate(Ar, c.yr, lams=lams_p, kernel="rbf",
                        options=opts_cv, folds=3, via="fleet",
                        seed=args.seed, device=dev)
    t_cv = time.perf_counter() - t0
    c.spy.take()
    print(f"[sweep] cross_validate 3 folds x {len(lams_p)} lambdas via the "
          f"fleet, H = {opts_cv.max_iters} (a depth cut; the width is "
          f"full): mean mse " + " ".join(f"{v:.4f}" for v in cv.mean_scores)
          + f"; best lambda {cv.best_value:g}; {t_cv:.2f} s")
    if not (cv.scores.shape == (3, len(lams_p))
            and np.isfinite(cv.scores).all()
            and cv.best_value in lams_p):
        failures.append(f"cross_validate scores {cv.scores}")

    # ---- 9f. report -----------------------------------------------------
    for label, r in (("K-SVM s-step", c.r_s), ("K-SVM classical", c.r_c),
                     ("K-RR s-step", c.r_k)):
        cm = r.comm
        print(f"[comm] {label} FitResult.comm (Hockney model, the paper's "
              f"machine): time {cm['time']:.4e} s, flops {cm['flops']:.4e}, "
              f"words {cm['words']:.4e}, msgs {cm['msgs']:.0f}")
    print(f"[comm] K-RR fleet: modeled {fk.comm['time']:.4e} s against "
          f"{fk.comm['sequential_time']:.4e} s sequential "
          f"({fk.comm['modeled_speedup']:.2f}x); measured "
          f"{len(lams) * c.r_k.wall_time_s / fk.wall_time_s:.2f}x")
    print(f"[sweep] phase 9 took {time.perf_counter() - t_phase:.1f} s")

    entries = []
    for key, what, launches in (
            (("K-RR fleet round", 16), "krr_fleet_round", fk.rounds_run),
            (("K-SVM fleet round", 8), "ksvm_fleet_round", fs.rounds_run),
            (("full matvec, B = A", 16), "fleet_check",
             fk.history.shape[0])):
        row = kmv_at[key]
        entries.append({
            "name": f"kmv_c{row['F']}_{what}", "route": "cuda",
            "source": "src/repro_torch/csrc/kmv.cu",
            "replaces": "src/repro/kernels/kmv.py:93",
            "shape": f"rbf (m, r, n, c) = ({m}, {row['r']}, {n}, "
                     f"{row['F']}) [{row['plan'].regime}]",
            "launches": launches,
            "launches_note": "kmv launches at this shape in the fleet "
                             "that runs it: its rounds, or its checks",
            "max_abs_err": row["err"], "ms": row["ms"],
            "plain_ms": row["plain"], "bound_ms": row["bound"],
            "bound_by": row["by"], "library_ms": None,
            "ms_c1_times_F": row["one"] * row["F"],
            "ms_wide_plan": row.get("wide"),
            "ms_timing": "device time, launches queued behind a spin "
                         "kernel (time_queued)"})
    return entries, fleet_counts


def guard_phase(c, args, failures):
    """Phase 10 (module docstring), on phases 3-4's data and fits in
    ``c``: the swapped apply_at and the f64 routes against their plain
    versions, guarded K-SVM and K-RR fits against phases 3-4 and against
    their eager loop, faults walking the ladder (down to f64 on the
    card), kill and resume, and a streamed guarded fit.  Returns the
    kernels record's entries of this phase."""
    import shutil

    import torch
    from repro_torch import api
    from repro_torch.api import KernelRidge, KernelSVM
    from repro_torch.core import ExactGramOperator, KRRConfig
    from repro_torch.core.kernels import _chunk
    from repro_torch.core.perf_model import guard_overhead
    from repro_torch.kernels import kmv_stream as kst
    from repro_torch.kernels.gram import gram_cuda, gram_plain
    from repro_torch.kernels.gram import launch_f64 as gram_launch_f64
    from repro_torch.kernels.kmv import (KmvPlan, kmv_cuda, kmv_f64_plan,
                                         kmv_plain, kmv_plan)
    from repro_torch.kernels.kmv import launch as kmv_launch
    from repro_torch.kernels.kmv import launch_f64 as kmv_launch_f64
    from repro_torch.kernels._launch import check_inputs, sm_count
    from repro_torch.core import loop, pad_rounds
    from repro_torch.resilience import (FaultPlan, SimulatedKill,
                                        finite_health, inject)

    dev, m, n, A, Ar = c.dev, c.m, c.n, c.A, c.Ar
    rbf = c.kernels["rbf"]
    sms = sm_count(0)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 10)
    t_phase = time.perf_counter()
    entries = []

    # ---- 10a. the swapped apply_at, the f64 routes -------------------------
    t0 = time.perf_counter()
    apply_rows = {}
    for sb in GUARD_SB:
        idx = torch.randint(0, m, (sb,), generator=gen, device=dev)
        Bs = A[idx].contiguous()
        w = torch.randn(sb, generator=gen, device=dev)
        plan = kmv_plan(sb, m, 1, sms)
        got = kmv_cuda(Bs, A, w, rbf)
        want = kmv_plain(Bs, A, w, rbf)
        ratio, err = allclose_ratio(got, want, TOL_KMV_F32)
        again = torch.equal(got, kmv_cuda(Bs, A, w, rbf))
        # the wrong variant: the contraction's last row left out
        bad_ratio, _ = allclose_ratio(kmv_launch(
            Bs[:-1].contiguous(), A, w[:-1, None].contiguous(), rbf,
            kmv_plan(sb - 1, m, 1, sms), check_inputs("kmv", Bs, A))[:, 0],
            want, TOL_KMV_F32)
        iters = 20
        ms = time_queued(lambda: kmv_cuda(Bs, A, w, rbf), iters)
        plain = time_queued(lambda: kmv_plain(Bs, A, w, rbf), 5)
        wide = KmvPlan("wide", 128, 128 if sb > 64 else 64, -(-sb // 128),
                       128)
        ms_wide = time_queued(lambda: kmv_launch(
            Bs, A, w[:, None], rbf, wide, 0), iters)
        # the narrow tile 32 columns wide: twice the blocks of 32 x 64
        n32 = KmvPlan("narrow", 32, 32, -(-sb // 32), 32)
        ms_n32 = time_queued(lambda: kmv_launch(
            Bs, A, w[:, None], rbf, n32, 0), iters)
        # the unguarded round's KMV at r = sb, and the gram-slab route
        alpha = torch.rand(m, generator=gen, device=dev)
        ms_round = time_queued(lambda: kmv_cuda(A, Bs, alpha, rbf), iters)
        ms_slab = time_queued(lambda: gram_cuda(A, Bs, rbf) @ w, iters)
        nbytes = 4 * (m * n + sb * n + sb + m)
        bound, by = bound_ms(nbytes, 2.0 * sb * m * n + 3.0 * sb * m)
        apply_rows[sb] = dict(plan=plan, err=err, ms=ms, plain=plain,
                              wide=ms_wide, n32=ms_n32, round=ms_round,
                              slab=ms_slab, bound=bound, by=by)
        print(f"[guard] apply_at K(A[idx], A)^T w, sb = {sb} "
              f"[{plan.regime} {plan.bm}x{plan.br}, {plan.splits} split(s)"
              f"]: max abs err {err:.3e} ({ratio:.2f}x tol), bits repeat "
              f"{again}, last contraction row left out {bad_ratio:.1f}x "
              f"(must fail); {ms:.4f} ms (plain {plain:.3f}, 128-row wide "
              f"tile {ms_wide:.4f}, narrow 32 x 32 {ms_n32:.4f}, "
              f"unguarded round's KMV at r = {sb} "
              f"{ms_round:.4f}, gram slab @ w {ms_slab:.4f}; bound "
              f"{bound:.4f} by {by})")
        if not ratio <= 1.0:
            failures.append(f"apply_at sb={sb}: {err:.3e}")
        if not again:
            failures.append(f"apply_at sb={sb}: a second call gave other "
                            f"bits")
        if bad_ratio <= 1.0:
            failures.append(f"apply_at sb={sb}: the check passes the "
                            f"kernel without its last contraction row")
    f64_rows = {}
    A64 = A[:GUARD_F64_M].double().contiguous()
    for label, (Am, Bm) in (("r32", (A64, A64[:32].contiguous())),
                            ("B=A", (A64, A64)),
                            ("apply32", (A[:32].double().contiguous(),
                                         A.double()))):
        X = torch.randn(Am.shape[0], generator=gen, device=dev,
                        dtype=torch.float64)
        got = kmv_cuda(Am, Bm, X, rbf)
        want = kmv_plain(Am, Bm, X, rbf)
        ratio, err = allclose_ratio(got, want, TOL_F64)
        again = torch.equal(got, kmv_cuda(Am, Bm, X, rbf))
        mm = Am.shape[0] - 1
        bad = kmv_launch_f64(Am[:-1].contiguous(), Bm,
                             X[:-1, None].contiguous(), rbf,
                             kmv_f64_plan(mm, Bm.shape[0], sms))[:, 0]
        bad_ratio, _ = allclose_ratio(bad, want, TOL_F64)
        ms = time_cuda(lambda: kmv_cuda(Am, Bm, X, rbf), 3)
        plain = time_cuda(lambda: kmv_plain(Am, Bm, X, rbf), 3)
        mA, r = Am.shape[0], Bm.shape[0]
        bound, by = bound_ms(8 * (mA * n + (0 if Bm is Am else r * n) + mA
                                  + r),
                             2.0 * mA * r * n, FP64_FLOP_PER_S)
        f64_rows[label] = dict(err=err, ms=ms, plain=plain, bound=bound,
                               by=by, shape=(mA, r))
        print(f"[guard] f64 kmv {label} (m, r) = ({mA}, {r}): max abs err "
              f"{err:.3e} ({ratio:.2f}x the f64 bound {TOL_F64}), bits "
              f"repeat {again}, last contraction row left out "
              f"{bad_ratio:.1e}x (must fail); {ms:.3f} ms (plain "
              f"{plain:.3f}), bound "
              f"{bound:.4f} ms by {by} at FP64 {FP64_FLOP_PER_S / 1e12:.0f}"
              f" TFLOP/s (tensor cores)")
        if not (ratio <= 1.0 and again) or bad_ratio <= 1.0:
            failures.append(f"f64 kmv {label}: {ratio:.2f}x, repeat "
                            f"{again}, wrong variant {bad_ratio:.2f}x")
    del A64
    for sb in GUARD_SB:
        G = A[:sb].double().contiguous()
        got = gram_cuda(G, G, rbf)
        want = gram_plain(G, G, rbf)
        ratio, err = allclose_ratio(got, want, TOL_F64)
        # the wrong variant: the last feature chunk (32 features) left out
        Gs = G[:, :-32].contiguous()
        bad_ratio, _ = allclose_ratio(gram_launch_f64(Gs, Gs, rbf), want,
                                      TOL_F64)
        ms = time_queued(lambda: gram_cuda(G, G, rbf), 20)
        plain = time_queued(lambda: gram_plain(G, G, rbf), 20)
        bound, by = bound_ms(8 * (2 * sb * n + sb * sb),
                             2.0 * sb * sb * n, FP64_FLOP_PER_S)
        f64_rows[f"gram{sb}"] = dict(err=err, ms=ms, plain=plain,
                                     bound=bound, by=by)
        print(f"[guard] f64 gram {sb}x{sb}: max abs err {err:.3e} "
              f"({ratio:.2f}x the f64 bound), last feature chunk left out "
              f"{bad_ratio:.1e}x (must fail); {ms:.4f} ms (plain "
              f"{plain:.4f}), bound {bound:.4f} ms by {by}")
        if not ratio <= 1.0 or bad_ratio <= 1.0:
            failures.append(f"f64 gram {sb}: {ratio:.2f}x, wrong variant "
                            f"{bad_ratio:.2f}x")
    # the streamed apply_at of the f64 rung, at chunk rows STREAM_CHUNK_ROWS
    mf = min(GUARD_F64_M, m)
    Xc64 = _chunk(A[:mf].double().cpu(), STREAM_CHUNK_ROWS, pin=True)
    Bs = A[:32].double().contiguous()
    W = torch.randn(32, 1, generator=gen, device=dev, dtype=torch.float64)
    got = kst.kmv_stream_apply_cuda(Xc64, Bs, W, rbf, m=mf)
    want = kst.kmv_stream_apply_plain(Xc64, Bs, W, rbf, m=mf)
    ratio, err = allclose_ratio(got, want, TOL_F64)
    ms = time_cuda(lambda: kst.kmv_stream_apply_cuda(Xc64, Bs, W, rbf,
                                                     m=mf), 3)
    nb = 8 * mf * n
    f64_rows["stream"] = dict(err=err, ms=ms, bound=max(
        nb / PCIE_H2D_BYTES_PER_S,
        2.0 * 32 * mf * n / FP64_FLOP_PER_S) * 1e3, by="bytes")
    print(f"[guard] f64 streamed apply_at (m, sb) = ({mf}, 32) in "
          f"{STREAM_CHUNK_ROWS}-row chunks: max abs err {err:.3e} "
          f"({ratio:.2f}x); {ms:.3f} ms, bound "
          f"{f64_rows['stream']['bound']:.3f} ms (the link)")
    if not ratio <= 1.0:
        failures.append(f"f64 streamed apply_at: {ratio:.2f}x")
    del Xc64
    print(f"[guard] 10a in {time.perf_counter() - t0:.1f} s")

    # ---- 10b. guarded fits against phases 3-4 and the eager loop ----------
    def reset():
        for fn in (kmv_cuda, gram_cuda):
            fn.launches = fn.warmup_launches = fn.launches_f64 = 0

    def guarded(est_cls, kw, base, Ad, yd, sched):
        opts = dataclasses.replace(base, guard=True, **kw)
        est = est_cls(device=dev, options=opts, **c.hyper[est_cls])
        return est.fit(Ad, yd, schedule=sched)

    def timed_fit(est_cls, opts, Ad, yd, sched):
        """The estimator's fit through the facade's ``_fit`` (what
        ``fit`` calls once A and y pass their checks), its replays timed
        by CUDA events: (FitResult, the replays' device ms, the capture
        and warm-up ms they exclude)."""
        est = est_cls(device=dev, options=opts, **c.hyper[est_cls])
        st = {}
        res = api._fit(est.problem, Ad, yd, est.cfg, opts, dev,
                       schedule=sched, stats=st)[0]
        rep = st.get("replay_s")
        return res, (rep * 1e3 if rep is not None else float("nan")), \
            (st.get("capture_s", 0.0) + st.get("warmup_s", 0.0)) * 1e3

    def guard_opts(base, **kw):
        return dataclasses.replace(base, guard=True, **kw)

    t0 = time.perf_counter()
    reset()
    g_s, gd_s, gc_s = timed_fit(
        KernelSVM, guard_opts(c.svm.options, recompute_every="auto"), A,
        c.y, c.r_s.schedule)
    g_k, gd_k, gc_k = timed_fit(
        KernelRidge, guard_opts(c.krr.options, recompute_every="auto"), Ar,
        c.yr, c.r_k.schedule)
    g_k16, gd_k16, gc_k16 = timed_fit(
        KernelRidge, guard_opts(c.krr.options, recompute_every=16), Ar,
        c.yr, c.r_k.schedule)
    counts = (kmv_cuda.launches, gram_cuda.launches)
    drivers = c.spy.take()
    fits = (g_s, g_k, g_k16)
    rounds = sum(f.rounds_run for f in fits)
    checks = sum(len(f.history) for f in fits if f.history is not None)
    corr = sum(f.health.corrections for f in fits)
    want_counts = (rounds + checks + corr, rounds)
    for label, g, ref in (("K-SVM s=32", g_s, c.r_s),
                          ("K-RR s=8 b=32 auto", g_k, c.r_k),
                          ("K-RR s=8 b=32 recompute 16", g_k16, c.r_k)):
        ratio, err = allclose_ratio(g.alpha, ref.alpha, TOL_ITERATE)
        print(f"[guard] {label}: recompute_every resolves to "
              f"{g.options.recompute_every}, {g.rounds_run} rounds, "
              f"{g.health.corrections} corrections, max drift "
              f"{g.health.max_drift:.3e}; vs the unguarded fit max abs "
              f"err {err:.3e} ({ratio:.2f}x {TOL_ITERATE})")
        if not ratio <= 1.0:
            failures.append(f"guarded {label} vs unguarded: {err:.3e}")
        if not g.health.max_drift < 1e-4:
            failures.append(f"guarded {label}: drift {g.health.max_drift}")
    if g_k16.health.corrections < 1:
        failures.append("the recompute_every=16 K-RR fit made no correction")
    print(f"[guard] launches: kmv {counts[0]}, gram {counts[1]} (rounds "
          f"{rounds} + checks {checks} + corrections {corr}: {want_counts}); "
          f"drivers {drivers}")
    if counts != want_counts:
        failures.append(f"guarded launch counts {counts}, not {want_counts}")
    if counts[0] < 1 or counts[1] < 1:
        failures.append("phase 10b launched no kmv or gram kernel")
    # like for like: the unguarded fits again, warm and timed as the
    # guarded ones were, in this phase (phases 3-4's walls hold their
    # first captures on a cold card)
    u_s, ud_s, uc_s = timed_fit(KernelSVM, c.svm.options, A, c.y,
                                c.r_s.schedule)
    u_k, ud_k, uc_k = timed_fit(KernelRidge, c.krr.options, Ar, c.yr,
                                c.r_k.schedule)
    c.spy.take()
    for label, u, ref in (("K-SVM", u_s, c.r_s), ("K-RR", u_k, c.r_k)):
        same, diff = bit_equal(u.alpha, ref.alpha)
        if not same:
            failures.append(f"the unguarded {label} refit differs from "
                            f"phases 3-4: {diff:.3e}")
    guard_rows = {}
    for label, g, gd, gc, u, ud, uc, ref, o in (
            ("K-SVM s=32", g_s, gd_s, gc_s, u_s, ud_s, uc_s, c.r_s,
             c.svm.options),
            ("K-RR auto", g_k, gd_k, gc_k, u_k, ud_k, uc_k, c.r_k,
             c.krr.options),
            ("K-RR recompute 16", g_k16, gd_k16, gc_k16, u_k, ud_k, uc_k,
             c.r_k, c.krr.options)):
        krr = label.startswith("K-RR")
        model = guard_overhead(
            m, n, "rbf", b=o.b if krr else 1, s=o.s_eff,
            recompute_every=g.options.recompute_every)
        guard_rows[label] = dict(round=gd / g.rounds_run,
                                 uround=ud / u.rounds_run)
        print(f"[guard] {label}: replays {gd:.2f} ms of device time over "
              f"{g.rounds_run} rounds, "
              f"{0 if g.history is None else len(g.history)} checks and "
              f"{g.health.corrections} corrections ({gd / g.rounds_run:.4f}"
              f" ms a round, all in), the unguarded refit's {ud:.2f} "
              f"({ud / u.rounds_run:.4f}); capture + warm-up {gc:.1f} / "
              f"{uc:.1f} ms; walls {g.wall_time_s:.3f} / "
              f"{u.wall_time_s:.3f} s (phases 3-4's first fit "
              f"{ref.wall_time_s:.3f}); guard overhead modeled "
              f"{model:.4f}, measured {gd / ud - 1:.4f} on the device, "
              f"{g.wall_time_s / u.wall_time_s - 1:.4f} on the wall")
    per_corr = ((gd_k16 - gd_k) / g_k16.health.corrections
                if g_k16.health.corrections else float("nan"))
    print(f"[guard] a K-RR correction (an exact B = A matvec and the drift) "
          f"costs {per_corr:.2f} ms of device time (recompute 16 less "
          f"auto, over {g_k16.health.corrections} corrections)")
    # where a guarded K-SVM round's time goes: one round of each kind
    # profiled eagerly (torch.profiler's device time and launches), and
    # the guarded graphs of FAST_RUN rounds replayed back to back, against
    # the same replays each followed by its host read, as the guarded fit
    # runs them (the unguarded fit reads nothing between its runs)
    op_s = ExactGramOperator(A, rbf).scale_rows(c.y)
    xs_s = pad_rounds(c.r_s.schedule, 32)
    x0 = (xs_s[0][0], xs_s[1][0])
    a_s = c.r_s.alpha
    f_s = op_s.full_matvec(a_s)
    rf_u = api._round_fn("ksvm", A, c.y, c.svm.cfg, 32, None, op_s)
    rf_g = api._round_fn("ksvm", A, c.y, c.svm.cfg, 32, None, op_s,
                         guard=True)

    def guarded_round():
        new = rf_g((a_s, f_s), x0)
        ok = finite_health(new)
        return tuple(torch.where(ok, x, o) for x, o in zip(new, (a_s, f_s)))

    for label, fn in (("unguarded", lambda: rf_u(a_s, x0)),
                      ("guarded", guarded_round)):
        fn()
        busy, n_ops, top = device_profile(fn, 1)
        busy_s = "not measured" if busy is None else f"{busy:.4f} ms"
        print(f"[guard] one eager K-SVM s=32 round, {label}: device busy "
              f"{busy_s}, {n_ops:.0f} device operations; the longest: "
              + "; ".join(f"{k[:48]} {t:.4f} ms x{cnt:.0f}"
                          for k, t, cnt in top[:3]))
    R = xs_s[0].shape[0]
    runs = [(lo, min(loop.FAST_RUN, R - lo), False, False)
            for lo in range(0, R, loop.FAST_RUN)]
    spec = loop.GuardSpec(health_fn=finite_health, correct_fn=None,
                          correct_every=0)
    zero = torch.zeros_like(a_s)
    with loop.GuardedRoundGraphs(rf_g, (zero, zero), xs_s, runs,
                                 spec) as gg:
        gg.run(0).tolist()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for j in range(len(runs)):
            gg.run(j)
        ev[1].record()
        torch.cuda.synchronize()
        b2b = ev[0].elapsed_time(ev[1]) / R
        t_host = time.perf_counter()
        read = 0.0
        for j in range(len(runs)):
            ev[0].record()
            out = gg.run(j)
            ev[1].record()
            out.tolist()                         # the fit's host read
            read += ev[0].elapsed_time(ev[1])
        t_host = (time.perf_counter() - t_host) * 1e3 / R
    c.spy.take()
    print(f"[guard] guarded K-SVM s=32 runs of {loop.FAST_RUN} rounds "
          f"replayed: back to back {b2b:.4f} ms a round; each replay "
          f"followed by its host read (as the fit) {read / R:.4f} ms a "
          f"round between its events, {t_host:.4f} ms of host wall")
    with mock.patch.object(ExactGramOperator, "capturable", False):
        reset()
        e_s = guarded(KernelSVM, dict(recompute_every="auto"),
                      c.svm.options, A, c.y, c.r_s.schedule)
        e_k = guarded(KernelRidge, dict(recompute_every=16), c.krr.options,
                      Ar, c.yr, c.r_k.schedule)
        e_counts = (kmv_cuda.launches, gram_cuda.launches)
    e_drivers = c.spy.take()
    if drivers != (3, 0) or e_drivers != (0, 2):
        failures.append(f"guarded drivers: captured fits {drivers}, eager "
                        f"refits {e_drivers}")
    want_e = (g_s.rounds_run + g_k16.rounds_run + len(g_k16.history)
              + g_s.health.corrections + g_k16.health.corrections,
              g_s.rounds_run + g_k16.rounds_run)
    for label, got, want in (("K-SVM alpha", g_s.alpha, e_s.alpha),
                             ("K-RR alpha", g_k16.alpha, e_k.alpha),
                             ("K-RR history", g_k16.history, e_k.history),
                             ("K-RR drift", g_k16.health.drift,
                              e_k.health.drift)):
        same, diff = bit_equal(got, want)
        print(f"[guard] captured vs eager guarded {label}: "
              f"{'equal bit for bit' if same else 'DIFFER'} ({diff:.3e})")
        if not same:
            failures.append(f"captured vs eager guarded {label}: {diff}")
    print(f"[guard] eager guarded walls: K-SVM {e_s.wall_time_s:.2f} s "
          f"(captured {g_s.wall_time_s:.2f}), K-RR {e_k.wall_time_s:.2f} s "
          f"(captured {g_k16.wall_time_s:.2f}); eager launches {e_counts} "
          f"(want {want_e})")
    if e_counts != want_e:
        failures.append(f"eager guarded launch counts {e_counts}, not "
                        f"{want_e}")
    print(f"[guard] 10b in {time.perf_counter() - t0:.1f} s")

    # ---- 10c. faults: one rung each, and the f64 rung on the card ----------
    t0 = time.perf_counter()
    for target in ("f", "alpha"):
        with inject(FaultPlan(nan_at_iter=GUARD_FAULT_ITER,
                              target=target)) as plan:
            r = guarded(KernelSVM, dict(recompute_every="auto"),
                        c.svm.options, A, c.y, c.r_s.schedule)
        ratio, err = allclose_ratio(r.alpha, c.r_s.alpha, TOL_ITERATE)
        acts = [e.action for e in r.health.fallbacks]
        print(f"[guard] NaN into {target!r} at iteration {GUARD_FAULT_ITER}"
              f": fired {plan.carry_fired}, events {acts}, vs the clean "
              f"alpha {err:.3e} ({ratio:.2f}x); wall {r.wall_time_s:.2f} s")
        if acts != ["halve_s:32->16"] or not ratio <= 1.0:
            failures.append(f"fault on {target}: {acts}, {err:.3e}")
    base = dataclasses.replace(c.krr.options, method="classical", tol=0.0,
                               max_iters=GUARD_F64_ITERS)
    sched = c.r_k.schedule[:GUARD_F64_ITERS]
    clean = KernelRidge(device=dev, options=base,
                        **c.hyper[KernelRidge]).fit(Ar, c.yr,
                                                     schedule=sched)
    reset()
    torch.cuda.synchronize()
    stats = {}
    with inject(FaultPlan(nan_at_iter=GUARD_F64_ITERS // 2,
                          target="alpha")):
        # through the facade's _fit, for the last segment's (the f64
        # rung's) replay times
        r64, _ = api._fit("krr", Ar, c.yr, KRRConfig(lam=1.0, kernel=rbf),
                          dataclasses.replace(base, guard=True,
                                              recompute_every=0), dev,
                          schedule=sched, stats=stats)
    f64_counts = (kmv_cuda.launches_f64, gram_cuda.launches_f64)
    c.spy.take()
    acts = [e.action for e in r64.health.fallbacks]
    ratio, err = allclose_ratio(r64.alpha, clean.alpha, TOL_ITERATE)
    f64_rounds = GUARD_F64_ITERS - GUARD_F64_ITERS // 2
    f64_ms = (stats.get("replay_s") or float("nan")) * 1e3
    print(f"[guard] classical K-RR, H = {GUARD_F64_ITERS} (depth cut), NaN "
          f"into alpha at iteration {GUARD_F64_ITERS // 2}: events {acts}; "
          f"the f64 rung's {f64_rounds} rounds and its exact residual took "
          f"kmv {f64_counts[0]}, gram {f64_counts[1]} f64 launches; vs the "
          f"clean alpha {err:.3e} ({ratio:.2f}x); wall {r64.wall_time_s:.2f}"
          f" s (clean {clean.wall_time_s:.2f} s); the f64 rounds replayed "
          f"in {f64_ms:.2f} ms of device time ({f64_ms / f64_rounds:.3f} "
          f"ms a round)")
    if acts != ["f64"] or not ratio <= 1.0:
        failures.append(f"f64 rung: {acts}, {err:.3e}")
    # the rung's rounds, an apply_at and a gram each, behind its exact
    # residual (one f64 B = A matvec)
    if f64_counts != (f64_rounds + 1, f64_rounds):
        failures.append(f"the f64 rung's f64 launches {f64_counts}, not "
                        f"{(f64_rounds + 1, f64_rounds)}")
    print(f"[guard] 10c in {time.perf_counter() - t0:.1f} s")

    # ---- 10d. kill and resume ----------------------------------------------
    t0 = time.perf_counter()
    ckpt = Path(__file__).resolve().parent / "build" / "guard_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    kill_opts = dataclasses.replace(
        c.svm.options, max_iters=GUARD_KILL_ITERS)
    sched = c.r_s.schedule[:GUARD_KILL_ITERS]
    kw = dict(recompute_every="auto", checkpoint_every=4)
    full = guarded(KernelSVM, dict(kw, checkpoint_dir=str(ckpt / "full")),
                   kill_opts, A, c.y, sched)
    with inject(FaultPlan(kill_at_iter=GUARD_KILL_ITERS // 2)):
        try:
            guarded(KernelSVM, dict(kw, checkpoint_dir=str(ckpt / "kill")),
                    kill_opts, A, c.y, sched)
            killed = False
        except SimulatedKill:
            killed = True
    opts = dataclasses.replace(kill_opts, guard=True,
                               checkpoint_dir=str(ckpt / "kill"), **kw)
    est = KernelSVM(device=dev, options=opts, **c.hyper[KernelSVM])
    res = est.fit(A, c.y, schedule=sched, resume_from=str(ckpt / "kill"))
    same, diff = bit_equal(res.alpha, full.alpha)
    try:
        est.fit(A, c.y, schedule=torch.flip(sched, [0]),
                resume_from=str(ckpt / "kill"))
        refused = ""
    except ValueError as e:
        refused = str(e)
    c.spy.take()
    print(f"[guard] kill at iteration {GUARD_KILL_ITERS // 2} of "
          f"{GUARD_KILL_ITERS} (depth cut), checkpoint_every=4: killed "
          f"{killed}, {full.health.checkpoints} snapshots in the "
          f"uninterrupted fit; resumed vs uninterrupted "
          f"{'equal bit for bit' if same else 'DIFFER'} ({diff:.3e}); "
          f"another schedule refused: {'schedule' in refused}")
    if not (killed and same and "schedule" in refused):
        failures.append(f"kill and resume: killed {killed}, same {same}, "
                        f"refused {refused!r}")
    shutil.rmtree(ckpt, ignore_errors=True)
    print(f"[guard] 10d in {time.perf_counter() - t0:.1f} s")

    # ---- 10e. the streamed guard -------------------------------------------
    t0 = time.perf_counter()
    Xc = _chunk(Ar.cpu(), STREAM_CHUNK_ROWS, pin=True)
    sb = GUARD_SB[1]
    idx = torch.randint(0, m, (sb,), generator=gen, device=dev)
    Bs = Ar[idx].contiguous()
    W = torch.randn(sb, 1, generator=gen, device=dev)
    got = kst.kmv_stream_apply_cuda(Xc, Bs, W, rbf, m=m)
    want = kst.kmv_stream_apply_plain(Xc, Bs, W, rbf, m=m)
    ratio, s_err = allclose_ratio(got, want, TOL_KMV_F32)
    again = torch.equal(got, kst.kmv_stream_apply_cuda(Xc, Bs, W, rbf, m=m))
    s_ms = time_cuda(lambda: kst.kmv_stream_apply_cuda(Xc, Bs, W, rbf, m=m),
                     5)
    s_plain = time_cuda(lambda: kst.kmv_stream_apply_plain(Xc, Bs, W, rbf,
                                                           m=m), 2)
    s_bound = max(4 * m * n / PCIE_H2D_BYTES_PER_S,
                  2.0 * sb * m * n / FP32_FLOP_PER_S) * 1e3
    print(f"[guard] streamed apply_at (m, sb) = ({m}, {sb}), "
          f"{STREAM_CHUNK_ROWS}-row pinned chunks (a ragged tail): max abs "
          f"err {s_err:.3e} ({ratio:.2f}x tol), bits repeat {again}; "
          f"{s_ms:.3f} ms (plain {s_plain:.3f}), bound {s_bound:.3f} ms "
          f"(the link)")
    if not (ratio <= 1.0 and again):
        failures.append(f"streamed apply_at: {ratio:.2f}x, repeat {again}")
    del Xc
    s_opts = dataclasses.replace(c.krr.options, tol=0.0,
                                 max_iters=GUARD_STREAM_ROUNDS * 8)
    sched = c.r_k.schedule[:GUARD_STREAM_ROUNDS * 8]
    resident = guarded(KernelRidge, dict(recompute_every=16), s_opts, Ar,
                       c.yr, sched)
    kst.kmv_stream_apply_cuda.launches = 0
    streamed = guarded(KernelRidge, dict(recompute_every=16,
                                         stream=STREAM_CHUNK_ROWS),
                       s_opts, Ar.cpu(), c.yr, sched)
    n_apply = kst.kmv_stream_apply_cuda.launches
    c.spy.take()
    if n_apply < 1:
        failures.append("phase 10e launched no streamed apply_at")
    ratio, err = allclose_ratio(streamed.alpha, resident.alpha, TOL_ITERATE)
    print(f"[guard] streamed guarded K-RR (stream={STREAM_CHUNK_ROWS}), "
          f"{streamed.rounds_run} rounds, {streamed.health.corrections} "
          f"correction(s), {n_apply} streamed apply_at launches: vs the "
          f"resident guarded fit {err:.3e} ({ratio:.2f}x); walls "
          f"{streamed.wall_time_s:.2f} s (resident "
          f"{resident.wall_time_s:.2f} s)")
    if not (ratio <= 1.0 and n_apply == streamed.rounds_run
            and streamed.health.corrections == 1):
        failures.append(f"streamed guard: {err:.3e}, {n_apply} launches, "
                        f"{streamed.health.corrections} corrections")
    print(f"[guard] 10e in {time.perf_counter() - t0:.1f} s; phase 10 "
          f"{time.perf_counter() - t_phase:.1f} s")

    a32 = apply_rows[32]
    entries.append({
        "name": "kmv_apply_at", "route": "cuda",
        "source": "src/repro_torch/csrc/kmv.cu",
        "replaces": "src/repro/kernels/kmv.py:93",
        "shape": f"rbf K(A[idx], A)^T w, (sb, m, n) = (32, {m}, {n}) "
                 f"[{a32['plan'].regime}]",
        "launches": counts[0] - checks - corr,
        "launches_note": "apply_at launches of phase 10b's guarded fits, "
                         "one a round (the kmv count less the checks' and "
                         "corrections' B = A matvecs, which "
                         "launches_full_matvec counts)",
        "launches_full_matvec": checks + corr,
        "max_abs_err": a32["err"], "ms": a32["ms"], "plain_ms": a32["plain"],
        "bound_ms": a32["bound"], "bound_by": a32["by"], "library_ms": None,
        "ms_wide_plan": a32["wide"], "ms_narrow_32x32": a32["n32"],
        "ms_round_kmv_r32": a32["round"],
        "ms_gram_slab_route": a32["slab"],
        "ms_replayed_guarded_round_ksvm": guard_rows["K-SVM s=32"]["round"],
        "ms_replayed_unguarded_round_ksvm":
            guard_rows["K-SVM s=32"]["uround"],
        "ms_guarded_round_ksvm_back_to_back": b2b,
        "ms_sb256": apply_rows[256]["ms"],
        "bound_ms_sb256": apply_rows[256]["bound"],
        "ms_timing": "device time, launches queued behind a spin kernel "
                     "(time_queued)"})
    k = f64_rows["apply32"]
    entries.append({
        "name": "kmv_f64", "route": "cuda",
        "source": "src/repro_torch/csrc/f64_tile.cuh",
        "replaces": "src/repro/kernels/kmv.py:93",
        "shape": f"rbf f64 apply_at (sb, m, n) = (32, {m}, {n})",
        "launches": f64_counts[0] - 1,
        "launches_note": "f64 apply_at launches of phase 10c's f64 rung, "
                         "one a round (its exact residual, one f64 B = A "
                         "matvec, in launches_full_matvec)",
        "launches_full_matvec": 1,
        "max_abs_err": k["err"], "ms": k["ms"],
        "plain_ms": k["plain"], "bound_ms": k["bound"], "bound_by": k["by"],
        "library_ms": None,
        "ms_B_eq_A_reduced": f64_rows["B=A"]["ms"],
        "shape_B_eq_A_reduced": f64_rows["B=A"]["shape"],
        "bound_ms_B_eq_A_reduced": f64_rows["B=A"]["bound"],
        "ms_stream_apply_reduced": f64_rows["stream"]["ms"],
        "ms_f64_rung_round": f64_ms / f64_rounds,
        "bound_ms_stream_apply_reduced": f64_rows["stream"]["bound"],
        "ms_timing": "CUDA events around back-to-back calls (time_cuda)"})
    entries.append({
        "name": "kmv_stream_apply", "route": "cuda",
        "source": "src/repro_torch/csrc/kmv_stream.cu",
        "replaces": "src/repro/kernels/kmv_stream.py:111",
        "shape": f"rbf K(A, A[idx]) w streamed, (m, sb, n) = ({m}, {sb}, "
                 f"{n}), {STREAM_CHUNK_ROWS}-row pinned chunks",
        "launches": n_apply,
        "launches_note": "streamed apply_at launches of phase 10e's "
                         "guarded streamed fit (a round each)",
        "max_abs_err": s_err, "ms": s_ms, "plain_ms": s_plain,
        "bound_ms": s_bound, "bound_by": "bytes", "library_ms": None,
        "ms_timing": "CUDA events around back-to-back calls (time_cuda)"})
    # the f64 rung (classical K-RR, b = 32) runs the 32 x 32 cross block
    g, g256 = f64_rows["gram32"], f64_rows["gram256"]
    entries.append({
        "name": "gram_f64", "route": "cuda",
        "source": "src/repro_torch/csrc/f64_tile.cuh",
        "replaces": "src/repro/kernels/gram.py:82",
        "shape": f"rbf f64 (m, r, n) = (32, 32, {n})",
        "launches": f64_counts[1],
        "launches_note": "f64 gram launches of phase 10c's f64 rung, its "
                         "32 x 32 cross blocks",
        "max_abs_err": g["err"], "ms": g["ms"], "plain_ms": g["plain"],
        "bound_ms": g["bound"], "bound_by": g["by"], "library_ms": None,
        "ms_256x256": g256["ms"], "plain_ms_256x256": g256["plain"],
        "bound_ms_256x256": g256["bound"],
        "ms_timing": "device time, launches queued behind a spin kernel "
                     "(time_queued)"})
    return entries


def serve_phase(c, args, failures):
    """Phase 11 (module docstring), on phases 3-4's data, phase 9's fleets
    and phase 5's Nystrom fit in ``c``: the registry of two exact groups
    (F = 9 and F = 17) and a Nystrom one, an artifact saved and loaded, KMV
    at every serving bucket x F against its plain version, the engine's
    traffic with deadlines, a burst and a refit swap, and the instrumented
    K-RR fit with its spans, audit and trace.  Returns the kernels-record
    entries of KMV at the serving buckets."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.api import KernelRidge
    from repro_torch.core import predict as predict_mod
    from repro_torch.core.kernels import ExactGramOperator
    from repro_torch.kernels.gram import gram_cuda
    from repro_torch.kernels.kmv import kmv_cuda, kmv_plain, kmv_plan
    from repro_torch.kernels._launch import sm_count
    from repro_torch.obs.audit import audit_fit
    from repro_torch.obs.export import save_trace, to_chrome_trace, \
        validate_chrome_trace
    from repro_torch.serve import (DONE, EXPIRED, SHED, ModelRegistry,
                                   ServableModel, ServingEngine, load_model,
                                   operator_key)

    dev, m, n = c.dev, c.m, c.n
    rbf = c.kernels["rbf"]
    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent

    # ---- 11a. the registry ----------------------------------------------
    t0 = time.perf_counter()
    key_a = operator_key(c.svm.op_)
    t_key = time.perf_counter() - t0
    mem0 = torch.cuda.memory_allocated(dev)
    reg = ModelRegistry(predict_batch=SERVE_BATCH, device=dev)
    t0 = time.perf_counter()
    reg.register("ksvm", c.svm)
    t_reg = time.perf_counter() - t0
    op_s = reg.models["ksvm"].op
    for C, alpha in zip(c.fleets.Cs, c.fleets.alpha_s):
        reg.register(f"ksvm_C{C:g}", ServableModel(
            "ksvm", dataclasses.replace(c.svm.cfg, C=float(C)),
            c.svm.result_.options, alpha, c.y, op_s))
    reg.register("krr", c.krr)
    op_k = reg.models["krr"].op
    for lam, alpha in zip(c.fleets.lams, c.fleets.alpha_k):
        reg.register(f"krr_lam{lam:.3g}", ServableModel(
            "krr", dataclasses.replace(c.krr.cfg, lam=float(lam)),
            c.krr.result_.options, alpha, c.yr, op_k))
    reg.register("nystrom", c.nys)
    mem_reg = torch.cuda.memory_allocated(dev) - mem0
    g_s, g_k, g_n = reg.group("ksvm"), reg.group("krr"), reg.group("nystrom")
    sizes = (g_s.size, g_k.size, g_n.size)
    print(f"[serve] operator_key of the classification A ({m} x {n} f32, "
          f"{c.A.numel() * 4 / 1e6:.0f} MB): {t_key:.3f} s; the first "
          f"registration (one hash) {t_reg:.3f} s; members joining a "
          f"group's own operator are not hashed again")
    print(f"[serve] {len(reg.models)} models in {reg.n_groups} groups: "
          f"K-SVM F = {sizes[0]}, K-RR F = {sizes[1]}, Nystrom F = "
          f"{sizes[2]}; group bytes {g_s.nbytes / 1e6:.1f} / "
          f"{g_k.nbytes / 1e6:.1f} / {g_n.nbytes / 1e6:.1f} MB; device "
          f"memory the registry added {mem_reg / 1e6:.2f} MB (the stacked "
          f"weights; the operators are the fits' own)")
    if sizes != (9, 17, 1) or reg.n_groups != 3:
        failures.append(f"registry groups {sizes}, {reg.n_groups} groups")
    if reg.models["ksvm_C1"].op is not op_s:
        failures.append("a fleet member holds its own operator")

    # an artifact saved and loaded: it joins its group by content
    art = root / "build" / "serve_artifact"
    shutil.rmtree(art, ignore_errors=True)
    t0 = time.perf_counter()
    c.krr.save(str(art))
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = load_model(str(art), device=dev)
    t_load = time.perf_counter() - t0
    same_alpha = torch.equal(restored.alpha, c.krr.alpha_)
    same_key = operator_key(restored.op) == operator_key(op_k)
    reg.register("krr_restored", restored)
    joined = reg.group("krr_restored") is g_k
    Xq = c.Arq[:64].contiguous()
    both = g_k.serve(Xq)
    restored_same = torch.equal(both[:, g_k.col["krr"]],
                                both[:, g_k.col["krr_restored"]])
    reg.unregister("krr_restored")
    shutil.rmtree(art, ignore_errors=True)
    print(f"[serve] artifact of phase 4's K-RR: saved in {t_save:.2f} s, "
          f"loaded in {t_load:.2f} s; alpha {'equal' if same_alpha else 'DIFFERS'},"
          f" operator key {'equal' if same_key else 'DIFFERS'}, "
          f"{'joined' if joined else 'DID NOT JOIN'} the K-RR group, served "
          f"column {'equal bit for bit' if restored_same else 'DIFFERS'}")
    if not (same_alpha and same_key and joined and restored_same):
        failures.append("the saved and loaded K-RR artifact")

    # ---- 11b. warm-up and KMV at every bucket x F -----------------------
    cache0 = serve_cache = predict_mod.serve_cache_size()
    t0 = time.perf_counter()
    n_buckets = reg.warmup()
    t_warm = time.perf_counter() - t0
    cache_warm = predict_mod.serve_cache_size()
    buckets = g_s.predictor.bucket_sizes()
    print(f"[serve] warm-up: {n_buckets} blocks ({len(buckets)} buckets "
          f"{buckets} x {reg.n_groups} groups) in {t_warm:.2f} s; serve-cache "
          f"observable {cache0} -> {cache_warm}")
    sms = sm_count(0)
    shapes = {}
    for group, Q in ((g_s, c.Aq), (g_k, c.Arq)):
        F = group.size
        W = group.W
        for qb in buckets:
            B = Q[:qb].contiguous()
            plan = kmv_plan(m, qb, F, sms)
            got = kmv_cuda(group.op.A, B, W, rbf)
            want = kmv_plain(group.op.A, B, W, rbf)
            ratio, err = allclose_ratio(got, want, TOL_KMV_F32)
            same = torch.equal(got, kmv_cuda(group.op.A, B, W, rbf))
            served = group.serve(B)
            via_engine = torch.equal(served, got)
            iters = 5 if qb >= 512 else 20
            ms = time_queued(lambda: kmv_cuda(group.op.A, B, W, rbf), iters)
            plain = time_queued(lambda: kmv_plain(group.op.A, B, W, rbf),
                                max(1, iters // 5))
            nbytes = 4 * (m * n + qb * n + m * F + qb * F)
            flops = 2 * m * qb * n + 2 * m * qb * F + 2 * (m + qb) * n \
                + 6 * m * qb
            b_ms, b_by = bound_ms(nbytes, flops)
            shapes[(F, qb)] = dict(F=F, r=qb, plan=plan, err=err, ms=ms,
                                   plain=plain, bound=b_ms, by=b_by,
                                   launches=0)
            print(f"[serve] kmv rbf ({m}, {qb}, {n}) c={F} [{plan.regime} "
                  f"{plan.bm} x {plan.br}, {plan.splits} splits]: {ms:.4f} ms"
                  f" | plain {plain:.4f} ms | bound {b_ms:.4f} ms ({b_by}, "
                  f"{b_ms / ms:.1%} of it) | max abs err {err:.3e}, "
                  f"{'repeats bit for bit' if same else 'OTHER BITS'}, the "
                  f"group's served block {'equal' if via_engine else 'DIFFERS'}")
            if not ratio <= 1.0:
                failures.append(f"serving kmv c={F} r={qb}: {err:.3e} "
                                f"({ratio:.2f}x tolerance)")
            if not (same and via_engine):
                failures.append(f"serving kmv c={F} r={qb}: repeat {same}, "
                                f"served block equal {via_engine}")
    del got, want, served

    # ---- 11c. the engine's traffic --------------------------------------
    names_s = [nm for nm in reg.models if nm.startswith("ksvm")]
    names_k = [nm for nm in reg.models if nm.startswith("krr")]
    names = names_s + names_k + ["nystrom"]
    Qs, Qk = c.Aq[:1024].cpu(), c.Arq[:1024].cpu()
    rng = np.random.default_rng(args.seed + 11)
    blocks = {}
    real_block = predict_mod._serve_block

    def counted_block(op, sw, Xq):
        key = ("exact" if isinstance(op, ExactGramOperator) else "nystrom",
               tuple(sw.shape[1:]), Xq.shape[0])
        blocks[key] = blocks.get(key, 0) + 1
        return real_block(op, sw, Xq)

    def submit(eng, i, expire):
        name = names[int(rng.integers(len(names)))]
        rows = 1 if rng.random() < SERVE_SINGLE else int(rng.integers(2, 65))
        lo = int(rng.integers(0, 1024 - rows + 1))
        Q = Qs if name.startswith("ksvm") else Qk
        return eng.submit(name, Q[lo:lo + rows],
                          deadline_s=-1.0 if expire else None)

    eng = ServingEngine(reg, slots=SERVE_SLOTS, max_queue=SERVE_QUEUE)
    tickets = {"pre": [], "post": []}
    for fn in (kmv_cuda, gram_cuda):
        fn.launches = 0
    walls, served_rows = [], 0
    growth = 0
    old_krr = reg.models["krr"]
    refit = None
    with mock.patch.object(predict_mod, "_serve_block", counted_block):
        for part in ("pre", "post"):
            cache_at = predict_mod.serve_cache_size()
            t0 = time.perf_counter()
            for i in range(SERVE_TICKETS // 2):
                tickets[part].append(submit(eng, i, i % 64 == 63))
                if i % SERVE_PER_STEP == SERVE_PER_STEP - 1:
                    served_rows += eng.step()
            served_rows += eng.run_until_idle()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            growth += predict_mod.serve_cache_size() - cache_at
            if part == "pre":
                kmv_pre = (kmv_cuda.launches, gram_cuda.launches)
                blocks_pre = dict(blocks)
                # the refit swap between the two halves: every ticket
                # admitted before it was served on the old weights
                t0 = time.perf_counter()
                refit = reg.refit("krr", c.Arq[1024:], c.yrq[1024:])
                t_refit = time.perf_counter() - t0
                c.spy.take()
                # the refitted group and the one it left (now F = 16)
                # issue new block shapes: warm them, as a deployment would
                reg.warmup()
                for fn in (kmv_cuda, gram_cuda):
                    fn.launches = 0
                blocks.clear()
    kmv_post = (kmv_cuda.launches, gram_cuda.launches)
    exact_blocks = lambda b: sum(v for k, v in b.items() if k[0] == "exact")
    nys_blocks = lambda b: sum(v for k, v in b.items() if k[0] == "nystrom")
    new_krr = reg.models["krr"]
    all_t = tickets["pre"] + tickets["post"]
    done = [t for t in all_t if t.status == DONE]
    expired = [t for t in all_t if t.status == EXPIRED]
    lat = eng.latency_quantiles((0.5, 0.99))
    print(f"[serve] engine: {len(all_t)} tickets over {len(names)} models "
          f"({SERVE_SINGLE:.0%} single rows, the rest 2-64), slots "
          f"{SERVE_SLOTS}, max_queue {SERVE_QUEUE}: {len(done)} done, "
          f"{len(expired)} expired, {eng.stats['shed']} shed, "
          f"{eng.stats['blocks']} blocks in {eng.stats['steps']} steps; "
          f"{served_rows} rows in {sum(walls):.3f} s = "
          f"{served_rows / sum(walls):.0f} rows/s; ticket latency p50 "
          f"{lat['p50'] * 1e3:.3f} ms, p99 {lat['p99'] * 1e3:.3f} ms")
    print(f"[serve] KMV launches {kmv_pre[0]} + {kmv_post[0]} for "
          f"{exact_blocks(blocks_pre)} + {exact_blocks(blocks)} exact-group "
          f"blocks; gram launches {kmv_pre[1]} + {kmv_post[1]} for "
          f"{nys_blocks(blocks_pre)} + {nys_blocks(blocks)} Nystrom blocks "
          f"(its feature map); serve-cache growth after warm-up {growth}")
    print(f"[serve] refit of 'krr' on 1024 new rows (tol "
          f"{old_krr.options.tol:g}): {refit.iters_run} iters, "
          f"{refit.rounds_run} rounds, converged={refit.converged}, "
          f"{t_refit:.2f} s with its hash and warm-up; groups now "
          f"{[g.size for g in reg.groups()]}")
    if (kmv_pre[0], kmv_post[0]) != (exact_blocks(blocks_pre),
                                     exact_blocks(blocks)):
        failures.append(f"KMV launches {kmv_pre[0]}, {kmv_post[0]} for "
                        f"{exact_blocks(blocks_pre)}, {exact_blocks(blocks)}"
                        f" blocks: not one a block")
    if (kmv_pre[1], kmv_post[1]) != (nys_blocks(blocks_pre),
                                     nys_blocks(blocks)):
        failures.append("gram launches are not one a Nystrom block")
    if growth != 0:
        failures.append(f"the serve-cache observable grew by {growth}")
    want_expired = [t for t in all_t if t.deadline is not None]
    if [t.id for t in expired] != [t.id for t in want_expired] or \
            any(t.result is not None for t in expired):
        failures.append(f"{len(expired)} tickets expired, "
                        f"{len(want_expired)} had passed deadlines")
    if eng.stats["shed"] or len(done) != len(all_t) - len(want_expired):
        failures.append(f"traffic shed {eng.stats['shed']} tickets or left "
                        f"some unserved")

    # every ticket against its own model's BatchedPredictor: per model,
    # its tickets' rows in one call (the K-RR model's before and after the
    # swap apart)
    worst = 0.0
    for part in ("pre", "post"):
        by_model = {}
        for t in tickets[part]:
            if t.status == DONE:
                by_model.setdefault(t.name, []).append(t)
        for name, ts in by_model.items():
            model = (old_krr if (name == "krr" and part == "pre")
                     else new_krr if name == "krr" else reg.models[name])
            pred = predict_mod.BatchedPredictor(model.op, model.serve_w,
                                                batch=SERVE_BATCH)
            want = pred(torch.cat([t.X for t in ts]).to(dev)).cpu()
            got = torch.cat([t.result for t in ts])
            ratio, err = allclose_ratio(got, want, TOL_KMV_F32)
            worst = max(worst, err)
            if not ratio <= 1.0:
                failures.append(f"engine tickets of {name} ({part} the "
                                f"swap) vs its predictor: {err:.3e}")
    moved = float((new_krr.serve_w[:m] - old_krr.serve_w).abs().max())
    print(f"[serve] every ticket vs its model's own BatchedPredictor: max abs"
          f" err {worst:.3e} (bound {TOL_KMV_F32}); 'krr' tickets before the "
          f"swap held to the old weights, after it to the new (the weights "
          f"moved by up to {moved:.3e})")

    # a burst of twice the queue: the excess is shed at submit
    burst = [eng.submit("ksvm", Qs[i % 1024]) for i in range(2 * SERVE_QUEUE)]
    shed = sum(t.status == SHED for t in burst)
    eng.run_until_idle()
    served_burst = sum(t.status == DONE for t in burst)
    print(f"[serve] burst of {len(burst)} single rows: {shed} shed at submit,"
          f" {served_burst} served")
    if (shed, served_burst) != (SERVE_QUEUE, SERVE_QUEUE):
        failures.append(f"the burst shed {shed} and served {served_burst}")

    # ---- 11d. telemetry ---------------------------------------------------
    opts_k = c.krr.options
    for fn in (kmv_cuda, gram_cuda):
        fn.launches = 0
    r_plain = KernelRidge(lam=1.0, kernel="rbf", device=dev,
                          options=opts_k).fit(c.Ar, c.yr)
    counts_plain = (kmv_cuda.launches, gram_cuda.launches)
    for fn in (kmv_cuda, gram_cuda):
        fn.launches = 0
    r_tel = KernelRidge(lam=1.0, kernel="rbf", device=dev,
                        options=dataclasses.replace(opts_k, telemetry=True)
                        ).fit(c.Ar, c.yr)
    counts_tel = (kmv_cuda.launches, gram_cuda.launches)
    drivers = c.spy.take()
    tel = r_tel.telemetry
    want_counts = (c.r_k.rounds_run + len(c.r_k.history), c.r_k.rounds_run)
    same = [bit_equal(a, b)[0] for a, b in (
        (r_tel.alpha, c.r_k.alpha), (r_plain.alpha, c.r_k.alpha),
        (r_tel.history, c.r_k.history))]
    checks = [s for s in tel.paired_marks() if s.name == "metric_check"]
    spans = {s.name: s.duration for s in tel.spans}
    ck = np.array([s.duration for s in checks]) * 1e3
    print(f"[obs] phase 4's K-RR fit again, telemetry on: alpha "
          f"{'equal bit for bit' if same[0] else 'DIFFERS'} to phase 4's "
          f"(off: {'equal' if same[1] else 'DIFFERS'}), history "
          f"{'equal' if same[2] else 'DIFFERS'}; launches kmv / gram on "
          f"{counts_tel}, off {counts_plain}, phase 4's fit {want_counts}; "
          f"drivers {drivers}")
    print(f"[obs] spans: fit {spans.get('fit', float('nan')) * 1e3:.1f} ms, "
          f"representation_build "
          f"{spans.get('representation_build', float('nan')) * 1e3:.3f} ms, "
          f"solve {spans.get('solve', float('nan')) * 1e3:.1f} ms; "
          f"{len(checks)} metric_check intervals (device time of each "
          f"check's graph): mean {ck.mean():.3f} ms, min {ck.min():.3f}, "
          f"max {ck.max():.3f}, sum {ck.sum():.1f} ms")
    print(f"[obs] walls: telemetry on {r_tel.wall_time_s:.3f} s, off "
          f"{r_plain.wall_time_s:.3f} s, phase 4 {c.r_k.wall_time_s:.3f} s "
          f"(not gated)")
    print("[obs] audit_fit:\n" + audit_fit(r_tel).render())
    trace = to_chrome_trace(tel)
    validate_chrome_trace(trace)
    out_dir = root / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    path = save_trace(str(out_dir / "phase11_trace.json"), tel)
    print(f"[obs] Chrome trace: {len(trace['traceEvents'])} events, valid, "
          f"written to {path}")
    if not all(same) or counts_tel != counts_plain or \
            counts_tel != want_counts:
        failures.append(f"the instrumented K-RR fit: bit-equal {same}, "
                        f"counts {counts_tel} / {counts_plain} / "
                        f"{want_counts}")
    if len(checks) != len(c.r_k.history) or not (ck > 0).all():
        failures.append(f"{len(checks)} metric_check intervals for "
                        f"{len(c.r_k.history)} checks")
    if drivers != (2, 0):
        failures.append(f"the telemetry fits took drivers {drivers}")

    # one instrumented engine window
    from repro_torch.obs import Telemetry
    stel = Telemetry()
    weng = ServingEngine(reg, slots=SERVE_SLOTS, max_queue=SERVE_QUEUE,
                         telemetry=stel)
    for i in range(256):
        submit(weng, i, False)
        if i % SERVE_PER_STEP == SERVE_PER_STEP - 1:
            weng.step()
    weng.run_until_idle()
    text = stel.metrics.to_prometheus_text()
    print("[obs] an instrumented engine window of 256 tickets, its metrics "
          "as Prometheus text:")
    for line in text.splitlines():
        print(f"[obs]   {line}")
    if stel.metrics.counter("repro_serve_tickets_total").value(
            status="done") != 256:
        failures.append("the instrumented engine window did not serve 256")
    print(f"[serve] phase 11 took {time.perf_counter() - t_phase:.1f} s")

    # the kernels record: KMV at the serving buckets, one entry a group
    for (F, qb), row in shapes.items():
        row["launches"] = (blocks_pre.get(("exact", (F,), qb), 0)
                           + blocks.get(("exact", (F,), qb), 0))
    entries = []
    for F in sorted({F for F, _ in shapes}):
        rows = [shapes[(F, qb)] for qb in buckets]
        top = rows[-1]
        entries.append({
            "name": f"kmv_serve_c{F}", "route": "cuda",
            "source": "src/repro_torch/csrc/kmv.cu",
            "replaces": "src/repro/kernels/kmv.py:93",
            "shape": f"rbf (m, r, n, c) = ({m}, {top['r']}, {n}, {F}) "
                     f"[{top['plan'].regime}], the largest serving bucket",
            "launches": sum(r["launches"] for r in rows),
            "launches_note": "KMV launches of this group's served blocks "
                             "in the engine's traffic, every bucket",
            "max_abs_err": max(r["err"] for r in rows),
            "ms": top["ms"], "plain_ms": top["plain"],
            "bound_ms": top["bound"], "bound_by": top["by"],
            "library_ms": None,
            "buckets": [{"r": r["r"], "regime": r["plan"].regime,
                         "ms": r["ms"], "plain_ms": r["plain"],
                         "bound_ms": r["bound"], "bound_by": r["by"],
                         "launches": r["launches"],
                         "max_abs_err": r["err"]} for r in rows],
            "ms_timing": "device time, launches queued behind a spin "
                         "kernel (time_queued)"})
    return entries


def dist_rank(rank, world, backend, outdir, seed, svm_iters):
    """One rank of phases 12 and 13, spawned by ``spawn_ranks``
    (``torch.multiprocessing``): it draws phases 3-4's data as ``main``
    does, runs the layouts' fits on the card through the port's facade
    (every rank the same calls, SPMD), counts each fit's collectives
    (``launch.mesh.COLLECTIVES``) and kernel launches, then runs phase
    13's LM training cases (``lmd_rank``), and writes what it saw to
    ``outdir/rank{rank}.pt`` for the parent to check."""
    import os
    # every rank of the run is on this host: the backends connect over
    # loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.api import KernelRidge, KernelSVM, SolverOptions
    from repro_torch.core import (KernelConfig, apply_epilogue, pad_rounds,
                                  sstep_bdcd_inner)
    from repro_torch.core.distributed import (_dots, _reduced_row_sqnorms,
                                              shard_dataset_1d)
    from repro_torch.data.synthetic import (classification_dataset,
                                            regression_dataset)
    from repro_torch.kernels.gram import gram_cuda
    from repro_torch.kernels.kmv import kmv_cuda
    from repro_torch.launch.mesh import COLLECTIVES, make_mesh
    from repro_torch.resilience import FaultPlan, inject
    from repro_torch.tune import solve_fleet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the ranks share the host's cores (gloo sums on them)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    out = Path(outdir)
    plan = torch.load(out / "plan.pt", weights_only=False)
    dev = torch.device(plan["device"])
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    dist.init_process_group(backend, store=dist.FileStore(
        str(out / "store"), world), rank=rank, world_size=world)
    # phases 3-4's data, drawn in main()'s order from the same generator
    m, n, q = plan["m"], plan["n"], plan["q"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    A_all, y_all = classification_dataset(gen, m + q, n, device=dev)
    A, y = A_all[:m].contiguous(), y_all[:m].contiguous()
    del A_all, y_all
    torch.randperm(m, generator=gen, device=dev)       # phase 2's draws
    torch.randn(m, generator=gen, device=dev)
    torch.randn((m, 4), generator=gen, device=dev)
    R_all, t_all = regression_dataset(gen, m + q, n, device=dev)
    Ar, yr = R_all[:m].contiguous(), t_all[:m].contiguous()
    del R_all, t_all
    res = {"sums": [float(t.double().sum()) for t in (A, y, Ar, yr)],
           "fits": {}, "split": []}

    def run(name, est, A_, y_, fleet=None, **kw):
        COLLECTIVES.reset()
        kmv_cuda.launches = gram_cuda.launches = 0
        kmv_cuda.by_shape.clear()
        gram_cuda.by_shape.clear()
        sync()
        t0 = time.perf_counter()
        r = (est.fit(A_, y_, **kw) if fleet is None
             else solve_fleet(A_, y_, **fleet, **kw))
        sync()
        rec = dict(alpha=r.alpha.cpu(), rounds=r.rounds_run,
                   iters=r.iters_run, wall=time.perf_counter() - t0,
                   history=(None if r.history is None
                            else np.asarray(r.history)),
                   calls=dict(COLLECTIVES.calls),
                   words=dict(COLLECTIVES.words),
                   kmv=kmv_cuda.launches, gram=gram_cuda.launches,
                   kmv_shapes=dict(kmv_cuda.by_shape),
                   gram_shapes=dict(gram_cuda.by_shape),
                   comm_words=r.comm["words"], P=r.comm["P"],
                   layout=r.options.layout)
        health = getattr(r, "health", None)
        if health is not None:
            rec["events"] = [(e.action, e.iter_idx)
                             for e in health.fallbacks]
        res["fits"][name] = rec
        return rec

    meshes = {"1d": make_mesh(1, world)}
    if world > 1:
        meshes["2d"] = make_mesh(2, world // 2)
    for lay, mesh in meshes.items():
        common = dict(seed=seed, layout=lay, mesh=mesh)
        run(f"{lay} K-SVM s=32", KernelSVM(
            C=1.0, kernel="rbf", device=dev, options=SolverOptions(
                method="sstep", s=32, max_iters=svm_iters, **common)),
            A, y, schedule=plan["svm_sched"].to(dev))
        if world > 1:
            run(f"{lay} K-SVM classical", KernelSVM(
                C=1.0, kernel="rbf", device=dev, options=SolverOptions(
                    method="classical", max_iters=DIST_CLASSICAL_ITERS,
                    **common)),
                A, y, schedule=plan["dcd_sched"][:DIST_CLASSICAL_ITERS]
                .to(dev))
        run(f"{lay} K-RR s=8 b=32", KernelRidge(
            lam=1.0, kernel="rbf", device=dev, options=SolverOptions(
                method="sstep", s=8, b=32, tol=1e-4, check_every=16,
                max_iters=DIST_KRR_ITERS, **common)),
            Ar, yr, schedule=plan["krr_sched"][:DIST_KRR_ITERS].to(dev))
    if world > 1:
        # d. the guarded 1d fit, one rank poisoned (linear kernel, as the
        #    reference's poisoned factory requires)
        gkw = dict(method="sstep", s=8, b=32, max_iters=DIST_GUARD_ITERS,
                   check_every=4, seed=seed, layout="1d", mesh=meshes["1d"])
        run("1d linear K-RR, clean", KernelRidge(
            lam=1.0, kernel="linear", device=dev,
            options=SolverOptions(**gkw)), Ar, yr)
        with inject(FaultPlan(nan_at_iter=DIST_GUARD_FAULT_ITER)) as fp:
            rec = run("1d guarded linear K-RR, rank 0 poisoned",
                      KernelRidge(lam=1.0, kernel="linear", device=dev,
                                  options=SolverOptions(guard=True, **gkw)),
                      Ar, yr)
        rec["fired"] = fp.carry_fired
        # e. the 16-lambda K-RR fleet on the 1d layout
        run("1d K-RR fleet F=16", None, Ar, yr, fleet=dict(
            lams=plan["lams"], kernel="rbf", device=dev,
            options=SolverOptions(method="sstep", s=8, b=32, tol=1e-4,
                                  check_every=16, max_iters=DIST_KRR_ITERS,
                                  seed=seed, layout="1d",
                                  mesh=meshes["1d"])),
            schedule=plan["krr_sched"][:DIST_KRR_ITERS].to(dev))
        # g. a 1d K-RR round split into its partial kernel (CUDA events),
        #    its reduction (wall, gloo synchronises) and its local phase
        #    (events), with the wall of each part
        mesh, rbf = meshes["1d"], KernelConfig("rbf")
        A_loc = shard_dataset_1d(mesh, Ar)
        rs = _reduced_row_sqnorms(mesh, A_loc, rbf, "model")
        idx_k, valid_k = pad_rounds(plan["krr_sched"].to(dev), 8)
        alpha = res["fits"]["1d K-RR s=8 b=32"]["alpha"].to(dev)
        ev = [torch.cuda.Event(enable_timing=True) if on_card else None
              for _ in range(4)]

        def record(i):
            if on_card:
                ev[i].record()

        for k in range(DIST_SPLIT_ROUNDS):
            idx = idx_k[k]
            flat = idx.reshape(-1)
            sync()
            w0 = time.perf_counter()
            record(0)
            part = _dots(A_loc, A_loc[flat])
            record(1)
            sync()
            w1 = time.perf_counter()
            dots = mesh.all_reduce(part, "model")
            sync()
            w2 = time.perf_counter()
            record(2)
            cs = rs[flat]
            U = apply_epilogue(dots, rbf, rs, cs)
            G = apply_epilogue(dots[flat], rbf, cs, cs)
            sstep_bdcd_inner(G, U.T @ alpha, alpha[idx], yr[idx], flat, m,
                             1.0, 8, 32, valid_k[k])
            record(3)
            sync()
            w3 = time.perf_counter()
            res["split"].append(dict(
                kernel_ms=(ev[0].elapsed_time(ev[1]) if on_card
                           else float("nan")),
                kernel_wall_ms=(w1 - w0) * 1e3,
                reduce_wall_ms=(w2 - w1) * 1e3,
                local_ms=(ev[2].elapsed_time(ev[3]) if on_card
                          else float("nan")),
                local_wall_ms=(w3 - w2) * 1e3))
        del A_loc, rs, alpha
    # phase 13 on the same ranks, the solvers' data freed
    del A, y, Ar, yr
    torch.cuda.empty_cache()
    res["lm"] = lmd_rank(world, dev, seed, plan["lmd_ref"])
    # phase 15 on the same ranks
    torch.cuda.empty_cache()
    res["sdd"] = sdd_rank(world, dev, seed, plan["sdd_ref"])
    # phase 18 on the same ranks
    torch.cuda.empty_cache()
    res["s18"] = s18_rank(world, dev, seed, plan["s18_ref"])
    torch.save(res, out / f"rank{rank}.pt")
    dist.destroy_process_group()


def spawn_ranks(world: int, backend: str, d: Path, args, failures) -> bool:
    """Run ``dist_rank`` on ``world`` spawned processes and wait for them
    (``DIST_TIMEOUT_S``); a rank that raises, dies or runs past the limit
    is a failure, and every process is ended before this returns."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(
        dist_rank, args=(world, backend, str(d), args.seed, args.svm_iters),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.perf_counter() + DIST_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                failures.append(f"phase 12 {backend} world {world}: the "
                                f"ranks ran past {DIST_TIMEOUT_S} s")
                return False
    except Exception as e:          # a rank raised or died: recorded
        failures.append(f"phase 12 {backend} world {world}: {e}")
        return False
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return True


def _guard_schedule(H: int, s: int, check_every: int, fault_iter: int):
    """(rounds run, chunks) of the guarded 1d fit: chunks of check_every
    rounds, the chunk holding ``fault_iter`` run twice (at s, discarded,
    then at s / 2, where s stays)."""
    pos, rounds, chunks, fired = 0, 0, 0, False
    while pos < H:
        seg = min(check_every * s, H - pos)
        rounds += -(-seg // s)
        chunks += 1
        if not fired and pos <= fault_iter < pos + seg:
            fired, s = True, s // 2
            continue
        pos += seg
    return rounds, chunks


def _dist_kernel_entry(c, kname: str, key: tuple, launches: int):
    """The kernels-record entry of one shape phase 12's ranks launched
    ``kname`` at: ``key`` is the wrapper's ``by_shape`` key, (m, r, n,
    config) for gram and (m, r, n, c, config) for kmv.  The operands are
    cut from phase 3's A as a rank cuts them: its first m rows and n
    columns, and B the sampled rows of the whole A over the same columns
    (a 2d rank gathers them from every data rank); B is A itself where
    the ranks passed one tensor twice (gram's sampled cross block, kmv's
    full matvec on rank 0's checks).  Returns (entry with ``ratio``, a
    label)."""
    import torch

    from repro_torch.core import KernelConfig
    from repro_torch.kernels.gram import gram_cuda, gram_plain
    from repro_torch.kernels.kmv import kmv_cuda, kmv_plain
    gram = kname == "gram"
    (m, r, n), cname = key[:3], key[-1]
    cfg = KernelConfig(cname)
    same = m == r
    B = c.A[c.pick[:r], :n].contiguous()
    A = B if gram and same else c.A[:m, :n].contiguous()
    if same:
        B = A
    # the work a call needs: one read of each operand, one write of the
    # output; a symmetric full matvec reads A once and needs the m (m+1)/2
    # distinct kernel entries
    ops_bytes = 4 * (m * n + (0 if same else r * n))
    if gram:
        fn = lambda: gram_cuda(A, B, cfg)             # noqa: E731
        plain = lambda: gram_plain(A, B, cfg)         # noqa: E731
        library = lambda: torch.mm(A, B.T)            # noqa: E731
        tol, work = TOL_GRAM_F32, 2 * m * r * n
        nbytes = ops_bytes + 4 * m * r
        name = f"gram_rank_partial_{cname}_{m}x{r}x{n}"
    else:
        cols = key[3]
        X = torch.randn((m, cols), device=A.device)
        fn = lambda: kmv_cuda(A, B, X, cfg)           # noqa: E731
        plain = lambda: kmv_plain(A, B, X, cfg)       # noqa: E731
        # a linear KMV is B (A^T X): 2 (m + r) n c operations
        library = ((lambda: torch.mm(B, torch.mm(A.T, X)))
                   if cname == "linear" else None)
        tol = TOL_KMV_F32
        pairs = m * (m + 1) // 2 if same else m * r
        work = (2 * (m + r) * n * cols if cname == "linear" else
                2 * pairs * n + 2 * m * r * cols + 2 * (m + r) * n
                + 6 * pairs)
        nbytes = ops_bytes + 4 * (m + r) * cols
        name = (f"kmv_rank0_check_{cname}_{m}x{r}x{n}x{cols}" if same
                else f"kmv_rank_partial_{cname}_{m}x{r}x{n}x{cols}")
    ratio, err = allclose_ratio(fn(), plain(), tol)
    iters = 20 if work < 1e11 else 2
    b_ms, b_by = bound_ms(nbytes, work)
    entry = {"name": name, "route": "cuda",
             "source": f"src/repro_torch/csrc/{kname}.cu",
             "replaces": ("src/repro/kernels/gram.py:82" if gram
                          else "src/repro/kernels/kmv.py:93"),
             "shape": f"{cname} {key[:-1]}", "launches": launches,
             "max_abs_err": err, "ms": time_queued(fn, iters),
             "plain_ms": time_queued(plain, iters), "bound_ms": b_ms,
             "bound_by": b_by,
             "library_ms": (None if library is None
                            else time_queued(library, iters)),
             "ratio": ratio}
    return entry, f"{kname} {cname} {key[:-1]}"


def dist_phase(c, args, failures):
    """Phase 12 (module docstring): the 1d and 2d layouts on the card,
    their ranks spawned processes (NCCL at world 1, gloo among
    ``DIST_WORLD`` processes sharing the card), held against phases 3-4's
    serial fits and phase 9's fleet; the collective audit; times; and
    every shape the ranks launched gram and kmv at, checked and timed
    here, alone on the card (``_dist_kernel_entry``).  Returns the
    kernels-record entries."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core.perf_model import (round_collectives,
                                             setup_collectives)

    t_phase = time.perf_counter()
    m, n, dev = c.m, c.n, c.dev
    sums = [float(t.double().sum()) for t in (c.A, c.y, c.Ar, c.yr)]
    plan = {"svm_sched": c.r_s.schedule.cpu(),
            "dcd_sched": c.r_c.schedule.cpu(),
            "krr_sched": c.r_k.schedule.cpu(), "lams": c.fleets.lams,
            "m": m, "n": n, "q": c.q, "device": str(dev)}
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        # phase 13's reference, before the ranks take the card
        t0 = time.perf_counter()
        plan["lmd_ref"] = str(Path(tmp) / "lmd_ref.pt")
        lm_ref = lmd_reference(dev, args, Path(plan["lmd_ref"]))
        print(f"[dist-lm] the unsharded reference trained and saved in "
              f"{time.perf_counter() - t0:.1f} s")
        # phase 15's references, also before the ranks take the card
        t0 = time.perf_counter()
        plan["sdd_ref"] = str(Path(tmp) / "sdd_ref.pt")
        sdd_ref = sdd_reference(dev, args, Path(plan["sdd_ref"]))
        print(f"[sdd] the unsharded references run and saved in "
              f"{time.perf_counter() - t0:.1f} s")
        # phase 18's references, also before the ranks take the card
        t0 = time.perf_counter()
        plan["s18_ref"] = str(Path(tmp) / "s18_ref.pt")
        s18_info = s18_reference(dev, args, Path(plan["s18_ref"]))
        t_s18 = time.perf_counter() - t0
        before = _host_gib()
        _release_host_cache()
        print(f"[s18] the unsharded references run and saved in "
              f"{t_s18:.1f} s; this process's host memory before the "
              f"spawns (resident, peak resident GiB) ({before[0]:.1f}, "
              f"{before[1]:.1f}), {_host_gib()[0]:.1f} resident after its "
              f"pinned cache is released")
        for world, backend in DIST_RUNS:
            d = Path(tmp) / f"{backend}{world}"
            d.mkdir()
            torch.save(plan, d / "plan.pt")
            t0 = time.perf_counter()
            if not spawn_ranks(world, backend, d, args, failures):
                return []
            runs[world] = [torch.load(d / f"rank{r}.pt", weights_only=False)
                           for r in range(world)]
            print(f"[dist] {backend}, {world} rank(s) on the one card: "
                  f"spawned, ran and joined in "
                  f"{time.perf_counter() - t0:.1f} s (the walls below: "
                  f"processes time-sliced on one card, not a scaling "
                  f"measurement)")
    from repro_torch.api import KernelRidge, KernelSVM, SolverOptions
    from repro_torch.tune import solve_fleet
    cut = KernelSVM(C=1.0, kernel="rbf", device=dev, options=SolverOptions(
        method="classical", max_iters=DIST_CLASSICAL_ITERS,
        seed=args.seed)).fit(c.A, c.y, schedule=c.r_c.schedule[
            :DIST_CLASSICAL_ITERS])
    krr_opts = SolverOptions(method="sstep", s=8, b=32, tol=1e-4,
                             check_every=16, max_iters=DIST_KRR_ITERS,
                             seed=args.seed)
    krr_sched = c.r_k.schedule[:DIST_KRR_ITERS]
    krr_cut = KernelRidge(lam=1.0, kernel="rbf", device=dev,
                          options=krr_opts).fit(c.Ar, c.yr,
                                                schedule=krr_sched)
    fleet_cut = solve_fleet(c.Ar, c.yr, lams=c.fleets.lams, kernel="rbf",
                            options=krr_opts, schedule=krr_sched,
                            device=dev)
    serial = {"K-SVM s=32": (c.r_s.alpha, None),
              "K-SVM classical": (cut.alpha, None),
              "K-RR s=8 b=32": (krr_cut.alpha, krr_cut.history)}
    for (world, backend), ranks in zip(DIST_RUNS, runs.values()):
        tag = f"{backend}, world {world}"
        for r, res in enumerate(ranks):
            if res["sums"] != sums:
                failures.append(f"{tag} rank {r} drew other data than "
                                f"phases 3-4: {res['sums']} vs {sums}")
        for name, rec in ranks[0]["fits"].items():
            # every rank holds the same alpha and history, bit for bit
            for r, res in enumerate(ranks[1:], 1):
                other = res["fits"][name]
                if not (torch.equal(other["alpha"], rec["alpha"])
                        and (rec["history"] is None or np.array_equal(
                            other["history"], rec["history"]))):
                    failures.append(f"{tag} {name}: rank {r}'s alpha or "
                                    f"history differs from rank 0's")
            layout = rec["layout"]
            kernel = "linear" if "linear" in name else "rbf"
            checks = 0 if rec["history"] is None else len(rec["history"])
            rounds = rec["rounds"]
            chunks = max(checks, 1)
            if "poisoned" in name:
                rounds, chunks = _guard_schedule(
                    DIST_GUARD_ITERS, 8, 4, DIST_GUARD_FAULT_ITER)
                checks = chunks
            # the row norms once a fit, the 2d alpha assembly a chunk
            want = {"round": rounds * round_collectives(layout, kernel),
                    "setup": (setup_collectives(layout, kernel)
                              + chunks * (layout == "2d")),
                    "check": checks}
            got = {kd: sum(v for (_, k), v in rec["calls"].items()
                           if k == kd) for kd in want}
            by_axis = ", ".join(
                f"{ax}/{kd} {rec['calls'][(ax, kd)]} calls "
                f"{rec['words'][(ax, kd)]:.4e} words"
                for ax, kd in sorted(rec["calls"]))
            print(f"[dist] {tag} {name}: {rec['rounds']} rounds, "
                  f"{checks} checks, wall {rec['wall']:.2f} s; "
                  f"collectives {by_axis}; modeled words at P = "
                  f"{rec['P']}: {rec['comm_words']:.4e}")
            if got != want:
                failures.append(f"{tag} {name}: collectives {got}, not "
                                f"{want}")
            # kernel launches: a gram a round (two in 2d), a kmv a round on
            # the linear 1d layout, and rank 0's checks' full matvecs
            for r, res in enumerate(ranks):
                f = res["fits"][name]
                g_want = rounds * (2 if layout == "2d" else 1)
                k_want = ((rounds if kernel == "linear" else 0)
                          + (checks if r == 0 and "guarded" not in name
                             else 0))
                if (f["gram"], f["kmv"]) != (g_want, k_want):
                    failures.append(f"{tag} {name} rank {r}: launches gram "
                                    f"{f['gram']}, kmv {f['kmv']}, not "
                                    f"{g_want}, {k_want}")
            print(f"[dist] {tag} {name}: launches a rank (gram, kmv): "
                  + ", ".join(f"({res['fits'][name]['gram']}, "
                              f"{res['fits'][name]['kmv']})"
                              for res in ranks))
            base = name.split(" ", 1)[1]
            if base in serial:
                want_a, want_h = serial[base]
                ratio, err = allclose_ratio(rec["alpha"].to(dev), want_a,
                                            TOL_ITERATE)
                line = (f"[dist] {tag} {name} vs the serial fit: alpha max "
                        f"abs err {err:.3e} ({ratio:.2f}x {TOL_ITERATE})")
                if not ratio <= 1.0:
                    failures.append(f"{tag} {name}: alpha vs serial "
                                    f"{err:.3e}")
                if want_h is not None:
                    hr, he = allclose_ratio(
                        torch.as_tensor(rec["history"]),
                        torch.as_tensor(np.asarray(want_h)), TOL_ITERATE)
                    line += f"; residual history {he:.3e} ({hr:.2f}x)"
                    if not (hr <= 1.0 and len(rec["history"])
                            == len(want_h)):
                        failures.append(f"{tag} {name}: history vs serial "
                                        f"{he:.3e}")
                print(line)
    fits = runs[DIST_WORLD][0]["fits"]
    clean = fits["1d linear K-RR, clean"]
    bad = fits["1d guarded linear K-RR, rank 0 poisoned"]
    err = float((bad["alpha"] - clean["alpha"]).abs().max())
    print(f"[dist] guarded 1d, rank 0's shard NaN-poisoned at iteration "
          f"{DIST_GUARD_FAULT_ITER}: fired {bad['fired']}, events "
          f"{bad['events']}, vs the clean fit max abs err {err:.3e} "
          f"(bound {TOL_ITERATE})")
    if not (bad["fired"] and [a for a, _ in bad["events"]]
            == ["halve_s:8->4"] and err <= TOL_ITERATE):
        failures.append(f"the poisoned 1d fit did not recover: "
                        f"{bad['events']}, {err:.3e}")
    fl = fits["1d K-RR fleet F=16"]
    errs = [allclose_ratio(fl["alpha"][i].to(dev), fleet_cut.alpha[i],
                           TOL_ITERATE) for i in range(len(c.fleets.lams))]
    worst = max(r for r, _ in errs)
    print(f"[dist] 1d fleet F = {len(errs)}: members vs the serial fleet of "
          f"the same {DIST_KRR_ITERS} iterations max abs err "
          f"{max(e for _, e in errs):.3e} ({worst:.2f}x "
          f"{TOL_ITERATE}); {fl['calls'].get(('model', 'round'), 0)} "
          f"reductions for {fl['rounds']} rounds of all members")
    if not worst <= 1.0:
        failures.append(f"the 1d fleet vs the serial fleet {worst:.2f}x")
    split = [s for res in runs[DIST_WORLD] for s in res["split"]]
    mean = {k: float(np.mean([s[k] for s in split])) for k in split[0]}
    print(f"[dist] a 1d K-RR round (s=8, b=32, rbf) at P = {DIST_WORLD}, "
          f"four processes time-sliced on one card (not a scaling "
          f"measurement), mean over {DIST_SPLIT_ROUNDS} rounds x "
          f"{DIST_WORLD} ranks: partial gram {mean['kernel_ms']:.3f} ms "
          f"device ({mean['kernel_wall_ms']:.3f} ms wall), reduction of "
          f"{m} x 256 f32 {mean['reduce_wall_ms']:.3f} ms wall, local "
          f"phase {mean['local_ms']:.3f} ms device "
          f"({mean['local_wall_ms']:.3f} ms wall)")

    # every shape (and kernel config) at which the ranks launched gram and
    # kmv in this phase's fits, with its launches, summed over the ranks
    # of both runs: each is checked against its plain version and timed
    # here, the parent process alone on the card
    tally = {"gram": {}, "kmv": {}}
    for (world, backend), ranks in zip(DIST_RUNS, runs.values()):
        for res in ranks:
            for fit, rec in res["fits"].items():
                for kname in tally:
                    for key, k in rec[f"{kname}_shapes"].items():
                        t = tally[kname].setdefault(key, [0, set()])
                        t[0] += k
                        t[1].add(f"{backend} world {world}: {fit}")
    timing = ("device time, launches queued behind a spin kernel "
              "(time_queued), the parent process alone on the card")
    entries = []
    for kname, shapes in tally.items():
        for key, (launches, fits) in sorted(shapes.items()):
            entry, label = _dist_kernel_entry(c, kname, key, launches)
            print(f"[dist] {label}: {launches} launches "
                  f"({'; '.join(sorted(fits))}); {entry['ms']:.4f} ms | "
                  f"plain {entry['plain_ms']:.4f} ms | bound "
                  f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}, "
                  f"{entry['bound_ms'] / entry['ms']:.1%} of it) | library "
                  + ("-" if entry["library_ms"] is None
                     else f"{entry['library_ms']:.4f} ms")
                  + f" | vs plain max abs err {entry['max_abs_err']:.3e} "
                  f"({entry['ratio']:.2f}x tolerance)")
            if not entry.pop("ratio") <= 1.0:
                failures.append(f"{label}: the kernel disagrees with its "
                                f"plain version, {entry['max_abs_err']:.3e}")
            entry.update(ms_timing=timing, fits=sorted(fits))
            entries.append(entry)

    # phase 13: the LM's cross-device training, from the same spawns
    t0 = time.perf_counter()
    tally = lmd_check(lm_ref, {w: [res["lm"] for res in ranks]
                               for w, ranks in runs.items()}, failures)
    entries += lmd_kernel_entries(tally, dev, args.seed, failures)
    print(f"[dist-lm] phase 13's checks and kernel entries took "
          f"{time.perf_counter() - t0:.1f} s")
    # phase 15: sharded decode and sharded MLA / MoE, from the same spawns
    t0 = time.perf_counter()
    tally = sdd_check(sdd_ref, {w: [res["sdd"] for res in ranks]
                                for w, ranks in runs.items()}, failures)
    entries += sdd_kernel_entries(tally, dev, args.seed, failures)
    print(f"[sdd] phase 15's checks and kernel entries took "
          f"{time.perf_counter() - t0:.1f} s")
    # phase 18: the sharded SSM family and encoder-decoder stack, from the
    # same spawns
    t0 = time.perf_counter()
    tally = s18_check(s18_info, {w: [res["s18"] for res in ranks]
                                 for w, ranks in runs.items()}, failures)
    entries += s18_kernel_entries(tally, dev, args.seed, failures)
    t_check = time.perf_counter() - t0
    t_ranks = max(res["s18"][-1]["seconds"] for res in runs[DIST_WORLD])
    print(f"[s18] phase 18 took {t_s18 + t_ranks + t_check:.1f} s: the "
          f"references {t_s18:.1f} s, in the ranks {t_ranks:.1f} s, the "
          f"checks and kernel entries {t_check:.1f} s; this process's host "
          f"memory (resident, peak resident GiB) "
          f"({_host_gib()[0]:.1f}, {_host_gib()[1]:.1f})")
    print(f"[dist] phases 12, 13, 15 and 18 took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return entries


# ---- phase 13: the LM's cross-device training ----------------------------

def lmd_config():
    """Phase 13's model: Qwen3-1.7B at full width, LMD_LAYERS layers, bf16
    flash, remat."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen3_1p7b"), n_layers=LMD_LAYERS,
                               attn_impl="flash", remat="full")


def lmd_acfg():
    from repro_torch.optim import AdamWConfig
    return AdamWConfig(lr=LM_TRAIN_LR, **LMD_ACFG)


def lmd_param_bound(acfg) -> float:
    """The most LMD_STEPS AdamW steps from one start can move a weight
    apart in two runs, whatever their gradients: step t moves it by lr_t
    |m_hat / sqrt(v_hat)| (+ decay), and by Cauchy-Schwarz over the
    gradients' weights in m and v, |m_hat| / sqrt(v_hat) <= sqrt(sum_i
    c_i^2 / w_i) sqrt(1 - b2^t) / (1 - b1^t) with c_i = (1 - b1) b1^(t-i),
    w_i = (1 - b2) b2^(t-i) (1.0 at t = 1 and 1.0004 at t = 2); the decay
    adds lr_t wd times the gap so far.  (Each run's f32 rounding of the
    weight adds at most 2^-24 |w| a step: ``_lmd_compare`` adds that.)"""
    from repro_torch.optim import schedule
    b1, b2, gap = acfg.b1, acfg.b2, 0.0
    for t in range(1, LMD_STEPS + 1):
        r = (math.sqrt(sum(((1 - b1) * b1 ** (t - i)) ** 2
                           / ((1 - b2) * b2 ** (t - i))
                           for i in range(1, t + 1)))
             * math.sqrt(1 - b2 ** t) / (1 - b1 ** t))
        lr = schedule(acfg, t)
        gap += 2 * lr * r + lr * acfg.weight_decay * gap
    return gap


def lmd_pipe(cfg, seed):
    from repro_torch.data.tokens import TokenPipeline
    return TokenPipeline(vocab_size=cfg.vocab_size, seq_len=LMD_SEQ,
                         global_batch=LMD_BATCH, seed=seed)


def lmd_reference(dev, args, path: Path) -> dict:
    """Phase 13's reference, in this process alone on the card: the port's
    unsharded single-process trainer on the ranks' params (the same seed)
    and batches; its losses, device-memory peak and step walls, and its
    first moment after step 1, and params and both moments after
    LMD_STEPS steps (host copies, saved to ``path`` for the ranks)."""
    import torch
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)
    from repro_torch.tree import leaves
    cfg, acfg = lmd_config(), lmd_acfg()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    params, opt = init_train_state(gen, cfg, acfg, device=dev)
    step = make_train_step(cfg, acfg, TrainConfig(microbatches=LMD_MICRO))
    pipe = lmd_pipe(cfg, args.seed)
    ref, host = {"loss": [], "wall": []}, {}
    for k in range(LMD_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, pipe.batch(k))
        torch.cuda.synchronize()
        ref["wall"].append(time.perf_counter() - t0)
        ref["loss"].append(float(m["loss"]))
        if k == 0:      # copies: the next step updates m in place
            host["m1"] = [t.to("cpu", copy=True) for t in leaves(opt["m"])]
    host["p2"] = [t.to("cpu", copy=True) for t in leaves(params)]
    host["m2"] = [t.to("cpu", copy=True) for t in leaves(opt["m"])]
    host["v2"] = [t.to("cpu", copy=True) for t in leaves(opt["v"])]
    ref["peak"] = torch.cuda.max_memory_allocated() - base
    n = sum(t.numel() for t in leaves(params))
    ref["n_params"] = n
    del params, opt, step
    torch.cuda.empty_cache()
    torch.save(host, path)
    return ref


def _lmd_checksum(t) -> tuple:
    """Two int64 sums of a tensor's 32-bit words (the second of their
    squares, wrapping): equal bits give equal sums, and a rank whose copy
    differs in any bit differs in the first."""
    import torch
    w = t.detach().contiguous().view(torch.int32).reshape(-1).to(torch.int64)
    return int(w.sum()), int((w * w).sum())


def _lmd_compare(mesh, tree, specs, ref, dev, what: str) -> list:
    """Per leaf, this rank's chunks held against the same chunks of the
    reference's full leaf (every rank reads the reference; nothing is
    gathered), reduced over the mesh in one call: the relative Frobenius
    error of the whole leaf (``what`` "m" or "v": the squared norms of the
    difference and of the reference summed over the chunks, a chunk
    counted once, by the ranks at coordinate 0 of the axes it is
    replicated over), or the largest absolute difference less both runs'
    f32 rounding of the weights over LMD_STEPS steps, 2 LMD_STEPS 2^-24
    max |w| ("p")."""
    import torch
    from repro_torch.launch.mesh import MESH_AXIS
    from repro_torch.models.sharding import replicated_axes, shard_leaf
    from repro_torch.tree import leaves
    rows = []
    for t, spec, full in zip(leaves(tree), specs, ref):
        want = shard_leaf(mesh, full, spec).to(dev).double()
        got = t.detach().double()
        if what == "p":
            rows.append(torch.stack([(got - want).abs().max(),
                                     want.abs().max()]))
        elif all(mesh.index(a) == 0 for a in replicated_axes(mesh, spec)):
            rows.append(torch.stack([(got - want).square().sum(),
                                     want.square().sum()]))
        else:
            rows.append(torch.zeros(2, dtype=torch.float64, device=dev))
        del want, got
    red = mesh.all_reduce(torch.stack(rows), MESH_AXIS, "metric",
                          op="max" if what == "p" else "sum").cpu()
    if what == "p":
        return [float(d - 2 * LMD_STEPS * 2.0 ** -24 * w) for d, w in red]
    return [float((d / w).sqrt()) for d, w in red]


def lmd_rank(world: int, dev, seed: int, ref_path: str) -> list:
    """Phase 13 on one rank of a phase 12 spawn (after its fits): the
    cases of ``LMD_CASES[world]``, each from the reference's params, for
    LMD_STEPS steps on the reference's batches.  Per step: wall, loss,
    grad norm, sync seconds, collectives by (axis, kind), kernel launches
    and the checksums of this rank's leaves; per case: the first moment
    after step 1, and the params and both moments at the end, against
    the reference (``_lmd_compare``), the device-memory peak of the steps, and the shapes the kernels
    were launched at."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_bwd_cuda,
                                                     flash_fwd_cuda)
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.launch.mesh import COLLECTIVES, make_mesh
    from repro_torch.models.lm import param_specs
    from repro_torch.models.sharding import MeshRules, leaf_specs, split_axes
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_defer_train_step, make_train_step)
    from repro_torch.train.train_step import defer_rules, step_collectives
    from repro_torch.tree import leaves
    cfg, acfg = lmd_config(), lmd_acfg()
    pipe = lmd_pipe(cfg, seed)
    ref = torch.load(ref_path, mmap=True, weights_only=False)

    def launches():
        return {"rmsnorm": rmsnorm_cuda.launches,
                "flash_fwd_wgmma": flash_fwd_cuda.launches_wgmma,
                "flash_fwd": flash_fwd_cuda.launches,
                "flash_bwd_dq_wgmma": flash_bwd_cuda.launches_dq_wgmma,
                "flash_bwd_dkv_wgmma": flash_bwd_cuda.launches_dkv_wgmma,
                "flash_bwd_dq": flash_bwd_cuda.launches_dq,
                "flash_bwd_dkv": flash_bwd_cuda.launches_dkv}

    out = []
    t_all = time.perf_counter()
    for label, shape, s, int8 in LMD_CASES[world]:
        mesh = make_mesh(*shape)
        rules = MeshRules(mesh)
        defer = s > 0
        tcfg = TrainConfig(microbatches=LMD_MICRO, defer_s=max(s, 1),
                           compress_int8=int8)
        srules = defer_rules(rules) if defer else rules
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev).manual_seed(seed + 2)
        params, opt = init_train_state(gen, cfg, acfg, device=dev,
                                       rules=srules)
        step = (make_defer_train_step(cfg, acfg, tcfg, rules) if defer
                else make_train_step(cfg, acfg, tcfg, rules))
        specs = leaf_specs(param_specs(srules, cfg), params)
        for fn in (rmsnorm_cuda, flash_fwd_cuda, flash_bwd_cuda):
            fn.by_shape.clear()
        rec = {"label": f"{shape[0]}x{shape[1]} {label}", "mesh": shape,
               "defer_s": s, "int8": int8,
               "want": step_collectives(cfg, tcfg, rules, defer),
               "coords": (mesh.index("data"), mesh.index("model")),
               "split": [[a for _, a in split_axes(mesh, sp)]
                         for sp in specs],
               "local_params": sum(t.numel() for t in leaves(params)),
               "steps": [], "peak": 0}
        for k in range(LMD_STEPS):
            COLLECTIVES.reset()
            before = launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, pipe.batch(k))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rec["peak"] = max(rec["peak"],
                              torch.cuda.max_memory_allocated() - base)
            rec["steps"].append({
                "wall": wall, "loss": float(m["loss"]),
                "grad_norm": float(m["grad_norm"]), "sync_s": m["sync_s"],
                "calls": dict(COLLECTIVES.calls),
                "words": dict(COLLECTIVES.words),
                "launches": {n: c - before[n]
                             for n, c in launches().items()},
                "sums": [_lmd_checksum(t) for t in leaves(params)]})
            if k == 0:
                rec["m1"] = _lmd_compare(mesh, opt["m"], specs, ref["m1"],
                                         dev, "m")
                torch.cuda.reset_peak_memory_stats()
        rec["p2"] = _lmd_compare(mesh, params, specs, ref["p2"], dev, "p")
        rec["m2"] = _lmd_compare(mesh, opt["m"], specs, ref["m2"], dev, "m")
        rec["v2"] = _lmd_compare(mesh, opt["v"], specs, ref["v2"], dev, "m")
        rec["shapes"] = {"rmsnorm": dict(rmsnorm_cuda.by_shape),
                         "flash_fwd": dict(flash_fwd_cuda.by_shape),
                         "flash_bwd": dict(flash_bwd_cuda.by_shape)}
        del params, opt, step
        out.append(rec)
    torch.cuda.empty_cache()
    out.append({"seconds": time.perf_counter() - t_all})
    return out


def lmd_check(ref: dict, runs: dict, failures: list) -> dict:
    """Phase 13's checks of the ranks' records (``runs``: world -> the
    ranks' ``lmd_rank`` lists) against the reference: every case's loss,
    first moment after step 1, final moments and final params (the
    params bound holds whatever the gradients: it catches a layout or
    gather fault, the moments a gradient fault), replicated chunks bit for
    bit, collectives and kernel launches per step exact, s = 1 syncing
    twice as often as s = 2; prints walls, sync walls and peaks.
    Returns the kernel launch tally by (kernel, shape) with the cases
    that launched it."""
    cfg, acfg = lmd_config(), lmd_acfg()
    gib = 2.0 ** 30
    p_bound = lmd_param_bound(acfg)
    L, nm = cfg.n_layers, LMD_MICRO
    want_launch = {"rmsnorm": nm * (2 * lm_norms(cfg) - 1),
                   "flash_fwd_wgmma": nm * 2 * L, "flash_fwd": 0,
                   "flash_bwd_dq_wgmma": nm * L,
                   "flash_bwd_dkv_wgmma": nm * L, "flash_bwd_dq": 0,
                   "flash_bwd_dkv": 0}
    print(f"[dist-lm] reference: the unsharded trainer, one process alone "
          f"on the card, {cfg.name} at full width and {L} layers "
          f"({ref['n_params'] / 1e9:.3f} B params), {LMD_BATCH} x {LMD_SEQ} "
          f"tokens in {nm} microbatches: losses "
          f"{[round(x, 5) for x in ref['loss']]}, step walls "
          f"{[round(w, 3) for w in ref['wall']]} s, device-memory peak "
          f"{ref['peak'] / gib:.2f} GiB (the replicated figure)")
    tally, grads = {}, {}
    axes = {"data": 0, "model": 1}
    for world, backend in DIST_RUNS:
        ranks = runs[world]
        tag = f"{backend}, world {world}"
        print(f"[dist-lm] {tag}: phase 13 in the ranks "
              f"{max(r[-1]['seconds'] for r in ranks):.1f} s")
        for i, rec0 in enumerate(ranks[0][:-1]):
            recs = [r[i] for r in ranks]
            name = f"{tag} {rec0['label']}"
            for k in range(LMD_STEPS):
                losses = {rec["steps"][k]["loss"] for rec in recs}
                if len(losses) != 1:
                    failures.append(f"{name} step {k + 1}: the ranks' "
                                    f"losses differ {losses}")
                loss, want = rec0["steps"][k]["loss"], ref["loss"][k]
                rel = abs(loss - want) / abs(want)
                print(f"[dist-lm] {name} step {k + 1}: loss {loss:.5f} vs "
                      f"the reference {want:.5f}, relative {rel:.3e} (bound"
                      f" {TOL_LMD_LOSS}); grad_norm "
                      f"{rec0['steps'][k]['grad_norm']:.4f}; wall "
                      + ", ".join(f"{rec['steps'][k]['wall']:.2f}"
                                  for rec in recs)
                      + " s, sync "
                      + ", ".join(f"{rec['steps'][k]['sync_s']:.2f}"
                                  for rec in recs) + " s a rank")
                if not rel <= TOL_LMD_LOSS:
                    failures.append(f"{name} step {k + 1}: loss {loss} vs "
                                    f"{want}")
                # chunks that two ranks both hold must match bit for bit
                for j, split in enumerate(rec0["split"]):
                    seen = {}
                    for rec in recs:
                        key = tuple(rec["coords"][axes[a]] for a in split)
                        seen.setdefault(key, set()).add(
                            rec["steps"][k]["sums"][j])
                    if any(len(v) > 1 for v in seen.values()):
                        failures.append(f"{name} step {k + 1}: leaf {j}'s "
                                        f"replicated chunks differ")
                for r, rec in enumerate(recs):
                    st = rec["steps"][k]
                    if st["calls"] != rec["want"]:
                        failures.append(f"{name} rank {r} step {k + 1}: "
                                        f"collectives {st['calls']}, not "
                                        f"{rec['want']}")
                    if st["launches"] != want_launch:
                        failures.append(f"{name} rank {r} step {k + 1}: "
                                        f"launches {st['launches']}, not "
                                        f"{want_launch}")
            worst = {k: max(rec0[k]) for k in ("m1", "m2", "v2", "p2")}
            p_worst = worst.pop("p2")
            print(f"[dist-lm] {name}: vs the reference, worst leaf "
                  f"relative Frobenius of the first moment after step 1 "
                  f"{worst['m1']:.3e}, of the first and second moments "
                  f"after step {LMD_STEPS} {worst['m2']:.3e}, "
                  f"{worst['v2']:.3e} (bound {TOL_GRAD_BF16}); params after "
                  f"{LMD_STEPS} steps max abs diff, less the f32 rounding "
                  f"of the weights, {p_worst:.3e} (bound {p_bound:.3e}, "
                  f"AdamW's largest move apart)")
            for k, w in worst.items():
                if not w <= TOL_GRAD_BF16:
                    failures.append(f"{name}: AdamW state {k} {w}")
            if not p_worst <= p_bound:
                failures.append(f"{name}: params {p_worst} > {p_bound}")
            calls = rec0["steps"][0]["calls"]
            print(f"[dist-lm] {name}: collectives a step (rank 0) "
                  + ", ".join(f"{ax}/{kd} {n} ({rec0['steps'][0]['words'][(ax, kd)]:.4e} words)"
                              for (ax, kd), n in sorted(calls.items()))
                  + f"; local params {rec0['local_params'] / 1e6:.1f} M; "
                  f"device-memory peak a rank "
                  + ", ".join(f"{rec['peak'] / gib:.2f}" for rec in recs)
                  + f" GiB (the replicated trainer's {ref['peak'] / gib:.2f}"
                  f" GiB)")
            if rec0["defer_s"]:
                grads[(world, rec0["label"])] = calls.get(("data", "grad"),
                                                          0)
            for rec in recs:
                for kname, shapes in rec["shapes"].items():
                    for key, n in shapes.items():
                        t = tally.setdefault((kname, key), [0, set()])
                        t[0] += n
                        t[1].add(name)
    g1 = grads.get((DIST_WORLD, "2x2 defer s=1"))
    g2 = grads.get((DIST_WORLD, "2x2 defer s=2"))
    print(f"[dist-lm] grad syncs a step at 2x2: s=1 {g1}, s=2 {g2}")
    if g1 is None or g2 is None or g1 != 2 * g2:
        failures.append(f"s=1 grad syncs {g1} are not 2x s=2's {g2}")
    return tally


def _lmd_rmsnorm_entry(key, launches, cases, gen, dev, name=None):
    """The kernels-record entry (``name``, by default phase 13's) of the
    rmsnorm kernel at one shape a phase launched it at: checked against
    its plain version and timed alone on the card beside F.rms_norm."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_plain
    rows, D, dt = key
    dtype = getattr(torch, dt)
    x = torch.randn((rows, D), generator=gen, device=dev).to(dtype)
    scale = torch.randn((D,), generator=gen, device=dev)
    ratio, err = allclose_ratio(rmsnorm_cuda(x, scale).float(),
                                rmsnorm_plain(x, scale).float(),
                                TOL_BF16 if dtype == torch.bfloat16
                                else TOL_RMSNORM_F32)
    s16 = scale.to(dtype)
    nbytes = 2 * x.numel() * x.element_size() + D * 4
    b_ms, b_by = bound_ms(nbytes, 4 * x.numel(), BF16_FLOP_PER_S)
    # copies of x, cycled, that pass twice the L2 (the bound counts HBM)
    xs = [x] + [x.clone() for _ in
                range(2 * L2_BYTES // (x.numel() * x.element_size()))]
    nxt = itertools.cycle(xs).__next__
    entry = {"name": name or f"rmsnorm_rank_{rows}x{D}", "route": "cuda",
             "source": "src/repro_torch/csrc/rmsnorm.cu",
             "replaces": "src/repro/kernels/rmsnorm.py:34",
             "shape": f"x ({rows}, {D}) {dt}, scale ({D},) f32",
             "launches": launches, "max_abs_err": err,
             "ms": time_queued(lambda: rmsnorm_cuda(nxt(), scale), 50),
             "plain_ms": time_queued(lambda: rmsnorm_plain(nxt(), scale),
                                     20),
             "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": time_queued(
                 lambda: F.rms_norm(nxt(), (D,), s16, 1e-6), 50),
             "ms_timing": "device time, launches queued behind a spin "
                          "kernel (time_queued) over copies of x past "
                          "twice the L2, this process alone on the card",
             "cases": sorted(cases)}
    return entry, ratio


def _lmd_flash_entries(key, launches_fwd, launches_bwd, cases, gen, dev,
                       tag="rank"):
    """The kernels-record entries (named ``..._{tag}_bh{BH}``) of the
    tensor-core flash forward, dq and dkv at one (BH, S, hd) a phase (the
    ranks, by default) launched them at: each checked
    against the plain version within its derived bf16 bound and timed
    alone on the card, beside scaled_dot_product_attention (its forward,
    and its backward as forward + backward less forward)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (flash_bwd_cuda,
                                                     flash_bwd_plain,
                                                     flash_delta,
                                                     flash_fwd_cuda,
                                                     flash_fwd_plain)
    from repro_torch.kernels.ref import (flash_dkv_bf16_tolerance,
                                         flash_dq_bf16_tolerance,
                                         flash_fwd_bf16_tolerance)
    route, BH, S, T, hd, hdv, dt, causal = key
    dtype = getattr(torch, dt)
    q, k, v, do = (torch.randn((BH, S, hd), generator=gen, device=dev)
                   .to(dtype) for _ in range(4))
    o, lse = flash_fwd_cuda(q, k, v, causal=causal)
    o_p, lse_p = flash_fwd_plain(q, k, v, causal=causal)
    ratios = {"fwd": max(
        flash_err(o, o_p, "o", dtype,
                  flash_fwd_bf16_tolerance(q, k, v, o_p, causal))[1],
        flash_err(lse, lse_p, "lse", dtype)[1])}
    err_fwd = float((o.float() - o_p.float()).abs().max())
    delta = flash_delta(o, do)
    got = flash_bwd_cuda(q, k, v, do, lse, delta, causal=causal)
    want = flash_bwd_plain(q, k, v, do, lse, delta, causal=causal)
    args_b = (q, k, v, do, lse, delta)
    t_dq = flash_dq_bf16_tolerance(*args_b, want[0], causal)
    t_dk, t_dv = flash_dkv_bf16_tolerance(*args_b, want[1], want[2], causal)
    e = [(g.double() - w.double()).abs() for g, w in zip(got, want)]
    ratios["dq"] = float((e[0] / t_dq.double()).max())
    ratios["dkv"] = max(float((e[1] / t_dk.double()).max()),
                        float((e[2] / t_dv.double()).max()))
    errs = {"dq": float(e[0].max()),
            "dkv": max(float(e[1].max()), float(e[2].max()))}
    del t_dq, t_dk, t_dv, e, got, want
    # times: the forward through its wrapper, dq and dkv through their C
    # entry points, the plain versions, SDPA on (B, H, S, hd) views
    scale = hd ** -0.5
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    stream = torch.cuda.current_stream().cuda_stream
    base = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    launch_dq = build.launcher("flash_bwd_dq_wgmma")
    launch_dkv = build.launcher("flash_bwd_dkv_wgmma")
    ms = {"fwd": time_queued(lambda: flash_fwd_cuda(q, k, v, causal), 20),
          "dq": time_queued(lambda: launch_dq(*base, dq.data_ptr(), BH, S,
                                              T, hd, int(causal), scale,
                                              stream), 20),
          "dkv": time_queued(lambda: launch_dkv(*base, dk.data_ptr(),
                                                dv.data_ptr(), BH, S, T, hd,
                                                int(causal), scale, stream),
                             20)}
    plain_fwd = time_cuda(lambda: flash_fwd_plain(q, k, v, causal), 3)
    plain_bwd = time_cuda(lambda: flash_bwd_plain(q, k, v, do, lse, delta,
                                                  causal), 3)
    q4, k4, v4 = (t.detach().reshape(1, BH, S, hd).clone().requires_grad_()
                  for t in (q, k, v))
    do4 = do.reshape(1, BH, S, hd)

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)

    lib_fwd = time_queued(sdpa, 20)
    lib_bwd = time_queued(lambda: sdpa().backward(do4), 20) - lib_fwd
    pairs = S * (S + 1) // 2 if causal else S * T
    product = 2 * BH * pairs * hd
    in_bytes = 4 * BH * S * hd * 2 + 2 * BH * S * 4
    bounds = {"fwd": bound_ms(4 * BH * S * hd * 2 + BH * S * 4,
                              2 * product, BF16_FLOP_PER_S),
              "dq": bound_ms(in_bytes + BH * S * hd * 2, 3 * product,
                             BF16_FLOP_PER_S),
              "dkv": bound_ms(in_bytes + 2 * BH * S * hd * 2, 4 * product,
                              BF16_FLOP_PER_S)}
    shape = f"(BH, S, T, hd) = ({BH}, {S}, {T}, {hd}) {dt} causal"
    common = {"route": "cuda", "shape": shape, "cases": sorted(cases),
              "ms_timing": "device time, launches queued behind a spin "
                           "kernel (time_queued; the plain versions back "
                           "to back, time_cuda), this process alone on "
                           "the card"}
    entries = [
        dict(common, name=f"flash_fwd_wgmma_{tag}_bh{BH}",
             source="src/repro_torch/csrc/flash_fwd_wgmma.cu",
             replaces="src/repro/kernels/flash_attention.py:95",
             launches=launches_fwd, max_abs_err=err_fwd, ms=ms["fwd"],
             plain_ms=plain_fwd, bound_ms=bounds["fwd"][0],
             bound_by=bounds["fwd"][1], library_ms=lib_fwd),
        dict(common, name=f"flash_bwd_dq_wgmma_{tag}_bh{BH}",
             source="src/repro_torch/csrc/flash_bwd_dq_wgmma.cu",
             replaces="src/repro/kernels/flash_attention.py:220",
             launches=launches_bwd, max_abs_err=errs["dq"], ms=ms["dq"],
             plain_ms=plain_bwd, bound_ms=bounds["dq"][0],
             bound_by=bounds["dq"][1], library_ms=lib_bwd),
        dict(common, name=f"flash_bwd_dkv_wgmma_{tag}_bh{BH}",
             source="src/repro_torch/csrc/flash_bwd_wgmma.cu",
             replaces="src/repro/kernels/flash_attention.py:240",
             launches=launches_bwd, max_abs_err=errs["dkv"], ms=ms["dkv"],
             plain_ms=plain_bwd, bound_ms=bounds["dkv"][0],
             bound_by=bounds["dkv"][1], library_ms=lib_bwd)]
    return entries, ratios


def lmd_kernel_entries(tally: dict, dev, seed: int, failures: list):
    """The kernels-record entries of every shape phase 13's ranks launched
    rmsnorm and the flash kernels at (``lmd_check``'s tally), each checked
    and timed here."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    entries = []
    for (kname, key), (n, cases) in sorted(tally.items(),
                                           key=lambda t: str(t[0])):
        if kname == "rmsnorm":
            entry, ratio = _lmd_rmsnorm_entry(key, n, cases, gen, dev)
            print(f"[dist-lm] rmsnorm {key}: {n} launches; "
                  f"{entry['ms']:.4f} ms | plain {entry['plain_ms']:.4f} ms"
                  f" | F.rms_norm {entry['library_ms']:.4f} ms | bound "
                  f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}) | vs "
                  f"plain max abs err {entry['max_abs_err']:.3e} "
                  f"({ratio:.2f}x tolerance)")
            if not ratio <= 1.0:
                failures.append(f"rmsnorm {key} disagrees with its plain "
                                f"version")
            entries.append(entry)
        elif kname == "flash_fwd":
            if key[0] != "wgmma":
                failures.append(f"phase 13 launched the FP32-FMA flash "
                                f"forward at {key}")
                continue
            n_bwd = tally.get(("flash_bwd", key), (0,))[0]
            new, ratios = _lmd_flash_entries(key, n, n_bwd, cases, gen, dev)
            for e in new:
                print(f"[dist-lm] {e['name']} {e['shape']}: "
                      f"{e['launches']} launches; {e['ms']:.4f} ms | plain "
                      f"{e['plain_ms']:.4f} ms | SDPA "
                      f"{e['library_ms']:.4f} ms | bound "
                      f"{e['bound_ms']:.4f} ms ({e['bound_by']}) | vs plain"
                      f" max abs err {e['max_abs_err']:.3e}")
            print(f"[dist-lm] flash at {key[1:4]}: error / derived bound "
                  + ", ".join(f"{w} {r:.3f}" for w, r in ratios.items()))
            if not max(ratios.values()) <= 1.0:
                failures.append(f"flash at {key}: {ratios}")
            entries.extend(new)
    torch.cuda.empty_cache()
    return entries


# ---- phase 15: sharded decode and sharded MLA / MoE ----------------------

def _sdd_fsdp_steps() -> int:
    """The decode steps of a MoE case whose params are split over data."""
    return min(SDD_STEPS, SDD_STEPS_FSDP)


def sdd_configs():
    """Phase 15's models: Qwen3-1.7B at full width and LMD_LAYERS layers
    (bf16, flash), DeepSeek-V2-Lite at full width and MOE_SHORT_LAYERS
    layers (bf16, remat for its training)."""
    from repro_torch.configs import get_config
    gqa = dataclasses.replace(get_config("qwen3_1p7b"), n_layers=LMD_LAYERS,
                              attn_impl="flash")
    moe = dataclasses.replace(get_config("deepseek_v2_lite_16b"),
                              n_layers=MOE_SHORT_LAYERS, remat="full")
    return gqa, moe


def _sdd_state(cfg, batch: int, dev, seed: int) -> dict:
    """A decode state of SDD_MAX_SEQ positions with every slot drawn at
    random (as if earlier tokens had filled it), in the config's dtype,
    its rows at SDD_POS (B = 1: the row that crosses the middle)."""
    import torch
    from repro_torch.models import init_decode_state
    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    state = init_decode_state(cfg, batch, SDD_MAX_SEQ, device=dev)
    state["caches"] = [tuple(torch.randn(t.shape, generator=gen, device=dev)
                             .to(torch.bfloat16).to(t.dtype) for t in pair)
                       for pair in state["caches"]]
    pos = SDD_POS if batch == len(SDD_POS) else SDD_POS[1:1 + batch]
    state["pos"] = torch.tensor(pos, dtype=torch.int64, device=dev)
    return state


def _sdd_tokens(vocab: int, shape, seed: int):
    import torch
    gen = torch.Generator().manual_seed(seed + 7)
    return torch.randint(0, vocab, shape, generator=gen)


def _sdd_requests(cfg, seed: int) -> list:
    from repro_torch.train import Request
    toks = _sdd_tokens(cfg.vocab_size, (SDD_REQUESTS, SDD_PROMPT), seed + 1)
    return [Request(rid=i, prompt=toks[i].tolist(),
                    max_new_tokens=SDD_NEW) for i in range(SDD_REQUESTS)]


def _sdd_engine(params, cfg, rules, seed: int) -> dict:
    """The f32 engine (SDD_SLOTS slots) answering phase 15's requests:
    generated tokens by request, steps, mean step wall, collectives."""
    import torch
    from repro_torch.launch.mesh import COLLECTIVES
    from repro_torch.train import ServingEngine
    eng = ServingEngine(params, cfg, n_slots=SDD_SLOTS,
                        max_seq=SDD_ENGINE_SEQ, rules=rules)
    reqs = _sdd_requests(cfg, seed)
    for r in reqs:
        eng.submit(r)
    COLLECTIVES.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = eng.run_until_done()
    torch.cuda.synchronize()
    return {"tokens": {r.rid: list(r.generated) for r in reqs},
            "steps": steps, "ms": (time.perf_counter() - t0) / steps * 1e3,
            "calls": dict(COLLECTIVES.calls)}


def _moe_decisions(p, cfg, x):
    """(B, S, E) bool on the host: the experts that take each token (the
    top-k picks; with the capacity dispatch, those each expert keeps)."""
    import torch
    from repro_torch.models import moe as moe_module
    with torch.no_grad():
        _, top_w, top_idx = moe_module._route(p, cfg, x)
        routed = moe_module._routed(top_w, top_idx, cfg.n_experts)
        if cfg.moe_impl != "capacity":
            return (routed > 0).cpu()
        pri = torch.where(routed > 0, routed, torch.full_like(
            routed, float("-inf"))).transpose(1, 2)
        w, idx = pri.topk(moe_module.capacity(cfg, x.shape[1]), -1)
        kept = torch.zeros_like(pri, dtype=torch.bool).scatter_(
            -1, idx, torch.isfinite(w))
        return kept.transpose(1, 2).cpu()


def _recording_routes(seen: list):
    """``lm.moe_apply`` patched to append each call's routing decisions
    (``_moe_decisions`` of its input: over all E experts on every rank)
    to ``seen``."""
    from repro_torch.models import lm as lm_module
    apply = lm_module.moe_apply

    def recording(p, c, x, tp=None):
        seen.append(_moe_decisions(p, c, x))
        return apply(p, c, x, tp=tp)

    return mock.patch.object(lm_module, "moe_apply", recording)


def _first_route_difference(got: list, want: list, limit: int) -> list:
    """Per row, the first position (dim 1) at which any layer's routing
    decisions differ, or ``limit``."""
    first = [limit] * got[0].shape[0]
    for g, w in zip(got, want):
        differs = (g != w).any(-1)
        for b in range(differs.shape[0]):
            hits = differs[b].nonzero()
            if len(hits):
                first[b] = min(first[b], int(hits[0]))
    return first


def _held_steps(got: list, want: list) -> list:
    """Per row, the decode steps before its first routing difference:
    ``got`` / ``want`` per step, per layer (B, 1, E)."""
    steps = len(got)
    held = [steps] * got[0][0].shape[0]
    for t in range(steps):
        for b, f in enumerate(_first_route_difference(got[t], want[t], 1)):
            if f == 0:
                held[b] = min(held[b], t)
    return held


def _decode_run(params, cfg, state, toks, dev, steps, routes=False,
                cache_steps=()):
    """``steps`` unsharded decode steps: per step the f32 logits (host),
    walls, routing decisions (``routes``); the caches after the last, and
    after each step count of ``cache_steps`` (``caches_at``)."""
    import torch
    from repro_torch.models import decode_step
    out = {"logits": [], "walls": [], "routes": [], "caches_at": {}}
    for t in range(steps):
        seen = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _recording_routes(seen) if routes else contextlib.nullcontext():
            lg, state = decode_step(params, cfg, state, toks[t].to(dev))
        torch.cuda.synchronize()
        out["walls"].append(time.perf_counter() - t0)
        out["logits"].append(lg.float().cpu())
        out["routes"].append(seen)
        if t + 1 in cache_steps:
            out["caches_at"][t + 1] = [[c.cpu() for c in pair]
                                       for pair in state["caches"]]
    out["caches"] = [[c.cpu() for c in pair] for pair in state["caches"]]
    return out


def _bf16_noise(b16: list, f32: list, held=None) -> float:
    """The largest |bf16 - f32| of the unsharded run's logits, over each
    row's ``held`` first entries (all by default): the bf16 rounding the
    model's logits carry, which a sharded bf16 run carries too."""
    worst = 0.0
    for b in range(b16[0].shape[0]):
        for t in range(len(b16) if held is None else held[b]):
            worst = max(worst, float((b16[t][b] - f32[t][b]).abs().max()))
    return worst


def _moe15_train(cfg, params, seed: int, keep: bool = False):
    """MOE15_STEPS unsharded training steps of ``cfg`` from ``params``:
    losses, grad norms, walls, the device-memory peak; with ``keep`` host
    copies (``_tree_sample``) of the first moment and the params after
    step 1 and of the first moment after step 2 (``m1``, ``p1``,
    ``m2``)."""
    import torch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.tree import leaves
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    opt = adamw_init(params)
    step = make_train_step(cfg, lmd_acfg(),
                           TrainConfig(microbatches=MOE15_MICRO))
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=MOE15_SEQ,
                         global_batch=MOE15_BATCH, seed=seed)
    tr, trees = {"loss": [], "grad_norm": [], "wall": []}, {}
    for k in range(MOE15_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, pipe.batch(k))
        torch.cuda.synchronize()
        tr["wall"].append(time.perf_counter() - t0)
        tr["loss"].append(float(m["loss"]))
        tr["grad_norm"].append(float(m["grad_norm"]))
        if keep and k < 2:      # copies: the next step updates in place
            trees[f"m{k + 1}"] = [_tree_sample(t) for t in leaves(opt["m"])]
            if k == 0:
                trees["p1"] = [_tree_sample(t) for t in leaves(params)]
    tr["peak"] = torch.cuda.max_memory_allocated() - base
    del params, opt, step
    torch.cuda.empty_cache()
    return tr, trees


def _tree_sample(t) -> tuple:
    """A host copy of a leaf for phase 15's f32 entry-by-entry checks:
    ``(k, n0, rows)``, the whole leaf (k = 1) where it has at most
    MOE15_TREE_ENTRIES entries, else every k-th of its n0 rows along dim
    0, k odd and at most n0 / 4 + 1 (a dim 0 split 4 ways keeps sampled
    rows in every chunk, at other local rows)."""
    n0 = t.shape[0]
    k = 1
    if t.numel() > MOE15_TREE_ENTRIES:
        k = min(t.numel() // MOE15_TREE_ENTRIES, n0 // 4 + 1) | 1
    return k, n0, t[::k].to("cpu", copy=True)


def _ref_rows(mesh, spec, ref, dev) -> tuple:
    """This rank's part of a reference leaf kept by ``_tree_sample``, for
    its chunk of the leaf laid out by ``spec``: (the chunk's local rows
    that the reference holds, None for all of them; the reference's
    entries there, on ``dev``)."""
    import torch
    from repro_torch.models.sharding import shard_leaf
    k, n0, rows = ref
    if k == 1:
        return None, shard_leaf(mesh, rows, spec).to(dev)
    ids = shard_leaf(mesh, torch.arange(n0), tuple(spec[:1]))
    local = (ids % k == 0).nonzero().reshape(-1)
    want = shard_leaf(mesh, rows, (None,) + tuple(spec[1:]))[ids[local] // k]
    return local.to(dev), want.to(dev)


def _moe15_trees_path(path) -> Path:
    """Where the f32 MoE training's trees (``_moe15_train(keep=True)``)
    are saved beside phase 15's reference file."""
    return Path(path).with_name("sdd_moe_f32_trees.pt")


def sdd_reference(dev, args, path: Path) -> dict:
    """Phase 15's references, in this process alone on the card (before
    the ranks take it): the GQA model's unsharded decode at B =
    SDD_SLOTS and 1, in bf16 and f32, and its f32 engine; the MoE
    model's unsharded forward and decode in bf16 and f32 with their
    routing decisions, and MOE15_STEPS training steps in bf16 and in f32.
    The logits, caches and decisions go to ``path``, the f32 training's
    first moment and params to ``_moe15_trees_path(path)``; the bf16
    noise (``_bf16_noise``), walls and peaks are returned."""
    import torch
    from repro_torch.models import forward, init_params
    gqa, moe = sdd_configs()
    host, ref = {}, {}
    steps = SDD_STEPS
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 4)
    params = init_params(gen, gqa, device=dev)
    for B in sorted({c[2] for cases in SDD_CASES.values() for c in cases
                     if c[0] == "gqa"}):
        toks = _sdd_tokens(gqa.vocab_size, (steps, B, 1), args.seed)
        for dt in ("bfloat16", "float32"):
            cfg = dataclasses.replace(gqa, dtype=dt)
            host[("gqa", B, dt)] = _decode_run(
                params, cfg, _sdd_state(cfg, B, dev, args.seed), toks, dev,
                steps)
        b16, f32 = (host[("gqa", B, dt)]["logits"]
                    for dt in ("bfloat16", "float32"))
        ref[("gqa", B, "noise")] = _bf16_noise(b16, f32)
        walls = host[("gqa", B, "bfloat16")]["walls"]
        ref[("gqa", B, "ms")] = sorted(walls)[len(walls) // 2] * 1e3
    host["engine"] = _sdd_engine(
        params, dataclasses.replace(gqa, dtype="float32"), None, args.seed)
    ref["engine"] = host["engine"]
    ref["gqa_peak"] = torch.cuda.max_memory_allocated() - base
    del params
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 5)
    params = init_params(gen, moe, device=dev)
    toks = _sdd_tokens(moe.vocab_size, MOE15_FWD, args.seed).to(dev)
    dtoks = _sdd_tokens(moe.vocab_size, (steps, SDD_SLOTS, 1), args.seed)
    for dt in ("bfloat16", "float32"):
        cfg = dataclasses.replace(moe, dtype=dt, moe_impl=MOE15_FWD_IMPL)
        seen = []
        with _recording_routes(seen), torch.no_grad():
            lg = forward(params, cfg, toks)
        host[("moe_fwd", dt)] = {"logits": lg.float().cpu(), "routes": seen}
        cfg = dataclasses.replace(moe, dtype=dt)
        host[("moe_dec", dt)] = _decode_run(
            params, cfg, _sdd_state(cfg, SDD_SLOTS, dev, args.seed), dtoks,
            dev, steps, routes=True, cache_steps=(_sdd_fsdp_steps(),))
    del lg
    f16, f32 = host[("moe_fwd", "bfloat16")], host[("moe_fwd", "float32")]
    first = _first_route_difference(f16["routes"], f32["routes"],
                                    MOE15_FWD[1])
    ref["moe_fwd_noise"] = max(
        [0.0] + [float((f16["logits"][b, :f] - f32["logits"][b, :f]).abs()
                       .max()) for b, f in enumerate(first) if f])
    d16, d32 = host[("moe_dec", "bfloat16")], host[("moe_dec", "float32")]
    ref["moe_dec_noise"] = _bf16_noise(
        d16["logits"], d32["logits"], _held_steps(d16["routes"],
                                                  d32["routes"]))
    walls = d16["walls"]
    ref["moe_dec_ms"] = sorted(walls)[len(walls) // 2] * 1e3
    # the training steps from the same params, in each dtype
    ref[("moe_train", "bfloat16")], _ = _moe15_train(moe, params, args.seed)
    del params
    params = init_params(torch.Generator(device=dev).manual_seed(
        args.seed + 5), moe, device=dev)
    ref[("moe_train", "float32")], trees = _moe15_train(
        dataclasses.replace(moe, dtype="float32"), params, args.seed, True)
    del params
    torch.save(trees, _moe15_trees_path(path))
    del trees
    host["ref"] = ref
    torch.save(host, path)
    return ref


def _sdd_err(rec, got, want, noise=None, tol=None) -> None:
    """Hold this rank's logits against the reference's same rows: their
    largest abs difference, and its ratio to the bound (2 x the bf16
    ``noise``, or ``allclose_ratio`` at ``tol``); the worst kept."""
    want = want.to(got.device)
    if noise is not None:
        err = float((got.float() - want).abs().max())
        ratio = err / (2 * noise)
    else:
        ratio, err = allclose_ratio(got.float(), want, tol)
    rec["ratio"] = max(rec.get("ratio", 0.0), ratio)
    rec["err"] = max(rec.get("err", 0.0), err)


def _sdd_cache_ratio(mesh, caches, specs, want, dev, tol,
                     rows=None) -> float:
    """The worst ``allclose_ratio`` at ``tol`` of every cache chunk against
    the reference's same chunk (``rows``: the chunk's batch rows to
    compare; all by default)."""
    from repro_torch.models.sharding import shard_leaf
    worst = 0.0
    for pair, spair, wpair in zip(caches, specs, want):
        for t, sp, w in zip(pair, spair, wpair):
            w = shard_leaf(mesh, w, sp).to(dev)
            if rows is not None:
                t, w = t[rows], w[rows]
            if t.numel():
                worst = max(worst, allclose_ratio(t.float(), w.float(),
                                                  tol)[0])
    return worst


def _sdd_sharded_state(cfg, rules, B, dev, seed):
    from repro_torch.models.lm import decode_state_layout
    from repro_torch.models.sharding import shard_leaf
    full = _sdd_state(cfg, B, dev, seed)
    specs = decode_state_layout(rules, cfg, B, SDD_MAX_SEQ)
    state = {"caches": [tuple(shard_leaf(rules.mesh, t, s) for t, s in
                              zip(pair, spair))
                        for pair, spair in zip(full["caches"],
                                               specs["caches"])],
             "pos": full["pos"], "max_seq": SDD_MAX_SEQ}
    return state, specs


def _sdd_gqa_case(rules, shape, B, dt, dev, seed, host) -> dict:
    import torch
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.launch.mesh import COLLECTIVES
    from repro_torch.models import decode_step, init_params
    from repro_torch.models.lm import param_specs
    from repro_torch.models.sharding import batch_rows, shard_tree, split_axes
    from repro_torch.train.train_step import decode_collectives
    gqa = dataclasses.replace(sdd_configs()[0], dtype=dt)
    mesh = rules.mesh
    steps = SDD_STEPS
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    params = shard_tree(rules, init_params(gen, gqa, device=dev),
                        param_specs(rules, gqa))
    state, specs = _sdd_sharded_state(gqa, rules, B, dev, seed)
    toks = _sdd_tokens(gqa.vocab_size, (steps, B, 1), seed)
    rows = batch_rows(rules, B)
    want = host[("gqa", B, dt)]
    tol = TOL_LM_F32 if dt == "float32" else TOL_LM_BF16
    # one rank: the same ops as the unsharded run, so the same bits
    whole = mesh.size == 1
    rec = {"want": decode_collectives(gqa, rules, B, SDD_MAX_SEQ),
           "calls": [], "walls": [], "launches": [], "dtype": dt,
           "split": split_axes(mesh, specs["caches"][0][0]),
           "rows": (rows.start, rows.stop), "whole": whole, "equal": whole}
    for t in range(steps):
        COLLECTIVES.reset()
        before = rmsnorm_cuda.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, state = decode_step(params, gqa, state, toks[t].to(dev),
                                rules=rules)
        torch.cuda.synchronize()
        rec["walls"].append(time.perf_counter() - t0)
        rec["calls"].append(dict(COLLECTIVES.calls))
        rec["words"] = dict(COLLECTIVES.words)
        rec["launches"].append(rmsnorm_cuda.launches - before)
        _sdd_err(rec, lg, want["logits"][t][rows], None, tol)
        if whole:
            rec["equal"] &= torch.equal(lg.float().cpu(),
                                        want["logits"][t][rows])
    rec["cache_ratio"] = _sdd_cache_ratio(mesh, state["caches"],
                                          specs["caches"], want["caches"],
                                          dev, tol)
    if whole:
        rec["equal"] &= all(torch.equal(c.cpu(), w) for pair, wpair in
                            zip(state["caches"], want["caches"])
                            for c, w in zip(pair, wpair))
    rec["logits_last"] = lg.float().cpu()
    if B == SDD_SLOTS and shape in SDD_ENGINE_MESHES:
        rec["engine"] = _sdd_engine(
            params, dataclasses.replace(gqa, dtype="float32"), rules, seed)
    del params, state
    return rec


def _sdd_leaf_max(mesh, tree, specs, ref, dev) -> list:
    """Per leaf (``tree``'s leaves with their ``specs``), the largest |this
    rank's chunk - the same chunk of the reference's leaf| and the largest
    |entry| of that chunk of the reference (the rows ``_tree_sample``
    kept), each the worst over the mesh (one reduction; nothing
    gathered)."""
    import torch
    from repro_torch.launch.mesh import MESH_AXIS
    from repro_torch.tree import leaves
    rows = []
    for t, spec, full in zip(leaves(tree), specs, ref):
        local, want = _ref_rows(mesh, spec, full, dev)
        got = (t.detach() if local is None else t.detach()[local]).double()
        want = want.double()
        rows.append(torch.stack([(got - want).abs().max(),
                                 want.abs().max()]) if got.numel() else
                    torch.zeros(2, dtype=torch.float64, device=dev))
        del want, got
    red = mesh.all_reduce(torch.stack(rows), MESH_AXIS, "metric",
                          op="max").cpu()
    return [(float(d), float(w)) for d, w in red]


def _sdd_step1_params(mesh, params, m1, specs, ref_p, ref_m, acfg,
                      dev) -> list:
    """Per leaf, the worst over its entries and the mesh of (|this rank's
    params after step 1 - the reference's| - ulp(p)) over 2 lr |dg| /
    eps + 2^-20 lr: both runs round the weight to f32 (one ulp between
    them); past that, AdamW's first update moves it by what the entry's
    gradient difference dg = (m1 - m1_ref) / (1 - b1) allows (the update
    is m_hat / (sqrt(v_hat) + eps), m_hat = g and sqrt(v_hat) = |g| at
    step 1, 1 / eps-Lipschitz in each) and by the rounding of the
    update's seven f32 operations (each within 2^-24 of |update| <= 1 +
    weight decay |p|).  A weight one rounding apart reads 0.  Over the
    rows ``_tree_sample`` kept of the reference."""
    import torch
    from repro_torch.launch.mesh import MESH_AXIS
    from repro_torch.tree import leaves
    rows = []
    for p, m, spec, fp, fm in zip(leaves(params), leaves(m1), specs, ref_p,
                                  ref_m):
        local, wp = _ref_rows(mesh, spec, fp, dev)
        _, wm = _ref_rows(mesh, spec, fm, dev)
        got, m = ((p.detach(), m) if local is None else
                  (p.detach()[local], m[local]))
        if not got.numel():
            rows.append(torch.zeros((), dtype=torch.float64, device=dev))
            continue
        wp = wp.double()
        dg = (m.double() - wm.double()).abs() / (1 - acfg.b1)
        ulp = torch.maximum(*(torch.nextafter(t.abs(), torch.full_like(
            t, float("inf"))) - t.abs() for t in (got, wp.float())))
        over = ((got.double() - wp).abs() - ulp.double()).clamp_min(0.0)
        bound = 2 * acfg.lr * dg / acfg.eps + 2.0 ** -20 * acfg.lr
        rows.append((over / bound).max())
        del wp, dg, bound
    red = mesh.all_reduce(torch.stack(rows), MESH_AXIS, "metric",
                          op="max").cpu()
    return [float(r) for r in red]


def _sdd_moe_case(rules, dt, dev, seed, ref, host, ref_path) -> dict:
    import torch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.mesh import COLLECTIVES
    from repro_torch.models import decode_step, forward, init_params
    from repro_torch.models.lm import param_specs
    from repro_torch.models.sharding import batch_rows, leaf_specs, shard_tree
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.train_step import (decode_collectives,
                                              step_collectives)
    from repro_torch.tree import leaves
    moe = dataclasses.replace(sdd_configs()[1], dtype=dt)
    mesh = rules.mesh
    # bf16 logits within twice the unsharded run's own bf16 noise (C23),
    # f32 at TOL_LM_F32; each row before its first routing difference
    f32 = dt == "float32"
    tol = TOL_LM_F32 if f32 else TOL_LM_BF16
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    params = shard_tree(rules, init_params(gen, moe, device=dev),
                        param_specs(rules, moe))
    parts, t_part = {}, time.perf_counter()
    # a. the forward
    toks = _sdd_tokens(moe.vocab_size, MOE15_FWD, seed)
    rows = batch_rows(rules, MOE15_FWD[0])
    seen = []
    with _recording_routes(seen), torch.no_grad():
        lg = forward(params, dataclasses.replace(moe, moe_impl=MOE15_FWD_IMPL),
                     toks[rows].to(dev), rules=rules)
    want = host[("moe_fwd", dt)]
    first = _first_route_difference(seen, [w[rows] for w in want["routes"]],
                                    MOE15_FWD[1])
    fwd = {"held": sum(first), "of": len(first) * MOE15_FWD[1]}
    for b, f in enumerate(first):
        if f:
            _sdd_err(fwd, lg[b, :f], want["logits"][rows][b, :f],
                     None if f32 else ref["moe_fwd_noise"], tol)
    del lg
    parts["forward"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    # b. decode on the split latent cache (SDD_STEPS_FSDP steps where the
    #    params are split over data)
    steps = SDD_STEPS if mesh.shape["data"] == 1 else _sdd_fsdp_steps()
    state, specs = _sdd_sharded_state(moe, rules, SDD_SLOTS, dev, seed)
    dtoks = _sdd_tokens(moe.vocab_size, (steps, SDD_SLOTS, 1), seed)
    rows = batch_rows(rules, SDD_SLOTS)
    want = host[("moe_dec", dt)]
    dec = {"want": decode_collectives(moe, rules, SDD_SLOTS, SDD_MAX_SEQ),
           "calls": [], "walls": [], "routes": [], "logits": []}
    for t in range(steps):
        seen = []
        COLLECTIVES.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _recording_routes(seen):
            lg, state = decode_step(params, moe, state, dtoks[t].to(dev),
                                    rules=rules)
        torch.cuda.synchronize()
        dec["walls"].append(time.perf_counter() - t0)
        dec["calls"].append(dict(COLLECTIVES.calls))
        dec["words"] = dict(COLLECTIVES.words)
        dec["routes"].append(seen)
        dec["logits"].append(lg.float())
    held = _held_steps(dec.pop("routes"), [[w[rows] for w in r]
                                           for r in want["routes"]])
    for b, h in enumerate(held):
        for t in range(h):
            _sdd_err(dec, dec["logits"][t][b], want["logits"][t][rows][b],
                     None if f32 else ref["moe_dec_noise"], tol)
    del dec["logits"]
    dec.update(held=sum(held), of=len(held) * steps,
               held_first=sum(min(h, SDD_HELD_STEPS) for h in held),
               of_first=len(held) * min(steps, SDD_HELD_STEPS))
    keep = [b for b, h in enumerate(held) if h == steps]
    wc = want["caches"] if steps == SDD_STEPS else want["caches_at"][steps]
    dec["cache_ratio"] = max(
        _sdd_cache_ratio(mesh, state["caches"][:1], specs["caches"][:1],
                         wc[:1], dev, tol),
        _sdd_cache_ratio(mesh, state["caches"], specs["caches"], wc, dev,
                         tol, keep) if keep else 0.0)
    del state
    torch.cuda.empty_cache()
    parts["decode"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    # c. the FSDP + TP / EP trainer; in f32 its first moment after step 1
    #    and params after step 1, its first moment after step 2, held
    #    entry by entry
    trees = (torch.load(_moe15_trees_path(ref_path), mmap=True,
                        weights_only=False) if f32 else None)
    flat = leaf_specs(param_specs(rules, moe), params)
    tcfg = TrainConfig(microbatches=MOE15_MICRO)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    opt = adamw_init(params)
    step = make_train_step(moe, lmd_acfg(), tcfg, rules)
    pipe = TokenPipeline(vocab_size=moe.vocab_size, seq_len=MOE15_SEQ,
                         global_batch=MOE15_BATCH, seed=seed)
    tr = {"want": step_collectives(moe, tcfg, rules, False), "calls": [],
          "loss": [], "grad_norm": [], "walls": [], "sums": [], "peak": 0,
          "coords": (mesh.index("data"), mesh.index("model"))}
    n_steps = MOE15_STEPS if mesh.shape["data"] == 1 else MOE15_STEPS_FSDP
    for k in range(n_steps):
        COLLECTIVES.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, pipe.batch(k))
        torch.cuda.synchronize()
        tr["walls"].append(time.perf_counter() - t0)
        tr["calls"].append(dict(COLLECTIVES.calls))
        tr["words"] = dict(COLLECTIVES.words)
        tr["loss"].append(float(m["loss"]))
        tr["grad_norm"].append(float(m["grad_norm"]))
        tr["peak"] = max(tr["peak"],
                         torch.cuda.max_memory_allocated() - base)
        tr["sums"].append([_lmd_checksum(t) for t in leaves(params)])
        if trees is not None and k < 2:
            tr[f"m{k + 1}"] = _sdd_leaf_max(mesh, opt["m"], flat,
                                            trees[f"m{k + 1}"], dev)
            if k == 0:
                tr["p1"] = _sdd_step1_params(mesh, params, opt["m"], flat,
                                             trees["p1"], trees["m1"],
                                             lmd_acfg(), dev)
    tr["split"] = [[a for a in sp if a is not None and mesh.shape[a] > 1]
                   for sp in flat]
    del params, opt, step, trees
    torch.cuda.empty_cache()
    parts["training"] = time.perf_counter() - t_part
    return {"fwd": fwd, "dec": dec, "train": tr, "parts": parts}


def sdd_rank(world: int, dev, seed: int, ref_path: str) -> list:
    """Phase 15 on one rank of a phase 12 spawn (after phase 13): the
    cases of ``SDD_CASES[world]`` against the reference, with the shapes
    rmsnorm was launched at."""
    import torch
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import MeshRules
    host = torch.load(ref_path, weights_only=False)
    ref = host.pop("ref")
    out = []
    t_all = time.perf_counter()
    for kind, shape, B, dt in SDD_CASES[world]:
        rules = MeshRules(make_mesh(*shape))
        rmsnorm_cuda.by_shape.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rec = (_sdd_gqa_case(rules, shape, B, dt, dev, seed, host)
               if kind == "gqa" else _sdd_moe_case(rules, dt, dev, seed,
                                                  ref, host, ref_path))
        rec.update(kind=kind, mesh=shape, B=B, dtype=dt,
                   label=f"{kind} {shape[0]}x{shape[1]} B={B} {dt}",
                   seconds=time.perf_counter() - t0,
                   peak=torch.cuda.max_memory_allocated() - base,
                   shapes=dict(rmsnorm_cuda.by_shape))
        out.append(rec)
        torch.cuda.empty_cache()
    out.append({"seconds": time.perf_counter() - t_all})
    return out


def sdd_check(ref: dict, runs: dict, failures: list) -> dict:
    """Phase 15's checks of the ranks' records (``runs``: world -> the
    ranks' ``sdd_rank`` lists) against the unsharded references: logits
    and caches at TOL_LM_F32 in f32 and TOL_LM_BF16 in bf16, one rank's
    bit for bit; the MoE model's before each row's first routing
    difference (C22), its bf16 logits within twice the bf16 noise of the
    unsharded run (its own distance from the f32 run, C23); ranks that
    compute the same rows the same logits bit for bit; collectives
    exactly ``decode_collectives`` / ``step_collectives``; rmsnorm
    launches a decode step; the f32 engines' tokens equal to the
    unsharded engine's; the MoE training's losses and grad norms
    (TOL_MOE15_LOSS, TOL_MOE15_GNORM), in f32 its first moment after
    step 1 and its params entry by entry (TOL_GRAD_F32 of each leaf's
    largest entry), replicated chunks bit for bit.  Prints walls,
    collectives and peaks.  Returns the rmsnorm launch tally by shape
    with the cases that launched it."""
    gqa, moe = sdd_configs()
    gib = 2.0 ** 30
    eng = ref["engine"]
    print(f"[sdd] reference, one process alone on the card: {gqa.name} at "
          f"full width and {gqa.n_layers} layers, bf16 decode B = "
          f"{SDD_SLOTS} {ref[('gqa', SDD_SLOTS, 'ms')]:.2f} ms a step, B = 1 "
          f"{ref[('gqa', 1, 'ms')]:.2f} ms; bf16 noise (max |bf16 - f32| "
          f"logits) {ref[('gqa', SDD_SLOTS, 'noise')]:.4f}, "
          f"{ref[('gqa', 1, 'noise')]:.4f}; the f32 engine {eng['steps']} "
          f"steps at {eng['ms']:.2f} ms; peak {ref['gqa_peak'] / gib:.2f} "
          f"GiB. {moe.name} at full width and {moe.n_layers} layers: bf16 "
          f"decode {ref['moe_dec_ms']:.2f} ms a step; bf16 noise forward "
          f"{ref['moe_fwd_noise']:.4f}, decode {ref['moe_dec_noise']:.4f} "
          f"(before each row's first bf16 / f32 routing difference); "
          + "; ".join(
              f"{dt} training losses "
              f"{[round(x, 5) for x in t['loss']]}, step walls "
              f"{[round(x, 3) for x in t['wall']]} s, peak "
              f"{t['peak'] / gib:.2f} GiB"
              for dt, t in ((dt, ref[("moe_train", dt)])
                            for dt in ("bfloat16", "float32"))))
    tally = {}
    for world, backend in DIST_RUNS:
        ranks = runs[world]
        tag = f"{backend}, world {world}"
        print(f"[sdd] {tag}: phase 15 in the ranks "
              f"{max(r[-1]['seconds'] for r in ranks):.1f} s")
        for i, rec0 in enumerate(ranks[0][:-1]):
            recs = [r[i] for r in ranks]
            name = f"{tag} {rec0['label']}"
            peaks = ", ".join(f"{r['peak'] / gib:.2f}" for r in recs)
            if rec0["kind"] == "gqa":
                _sdd_check_gqa(name, recs, ref, failures)
            else:
                _sdd_check_moe(name, recs, ref, failures)
            print(f"[sdd] {name}: {rec0['seconds']:.1f} s in the case; "
                  f"device-memory peak a rank {peaks} GiB")
            for rec in recs:
                for key, n in rec["shapes"].items():
                    t = tally.setdefault(("rmsnorm", key), [0, set()])
                    t[0] += n
                    t[1].add(name)
    return tally


def _calls_line(calls: dict, words: dict) -> str:
    return ", ".join(f"{ax}/{kd} {n} ({words[(ax, kd)]:.4e} words)"
                     for (ax, kd), n in sorted(calls.items()))


def _median_ms(walls) -> str:
    return f"{sorted(walls)[len(walls) // 2] * 1e3:.1f}"


def _sdd_check_gqa(name, recs, ref, failures) -> None:
    import torch
    gqa, _ = sdd_configs()
    rec0 = recs[0]
    ratio = max(r["ratio"] for r in recs)
    cache = max(r["cache_ratio"] for r in recs)
    bound = "TOL_LM_F32" if rec0["dtype"] == "float32" else "TOL_LM_BF16"
    print(f"[sdd] {name}: {len(rec0['walls'])} decode steps, the caches' "
          f"split (dim, axis) {rec0['split']}; logits vs the unsharded run "
          f"{max(r['err'] for r in recs):.3e} max abs ({ratio:.2f}x "
          f"{bound}), cache chunks {cache:.2f}x {bound}"
          + (f", logits and caches bit for bit: {rec0['equal']}"
             if rec0["whole"] else "") + "; median "
          f"step {', '.join(_median_ms(r['walls']) for r in recs)} ms a "
          f"rank (processes time-sliced on one card: not a scaling number);"
          f" collectives a step "
          f"{_calls_line(rec0['calls'][0], rec0['words'])}")
    if not (ratio <= 1.0 and cache <= 1.0):
        failures.append(f"{name}: logits {ratio:.2f}x, caches {cache:.2f}x "
                        f"their bounds")
    if rec0["whole"] and not rec0["equal"]:
        failures.append(f"{name}: one rank's logits or caches differ from "
                        f"the unsharded run's")
    for r, rec in enumerate(recs):
        if any(c != rec["want"] for c in rec["calls"]):
            failures.append(f"{name} rank {r}: collectives "
                            f"{rec['calls'][0]}, not {rec['want']}")
        if any(n != lm_norms(gqa) for n in rec["launches"]):
            failures.append(f"{name} rank {r}: rmsnorm launches "
                            f"{rec['launches']}, not {lm_norms(gqa)} a step")
    # ranks that compute the same rows hold the same logits, bit for bit
    by_rows = {}
    for rec in recs:
        by_rows.setdefault(rec["rows"], []).append(rec["logits_last"])
    if not all(torch.equal(x, xs[0]) for xs in by_rows.values()
               for x in xs):
        failures.append(f"{name}: ranks that compute the same rows hold "
                        f"other logits")
    if "engine" in rec0:
        want = ref["engine"]["tokens"]
        same = all(r["engine"]["tokens"] == want for r in recs)
        if not same:
            failures.append(f"{name}: the engine's tokens differ from the "
                            f"unsharded engine's")
        e = rec0["engine"]
        print(f"[sdd] {name}: ServingEngine(rules=) f32, {SDD_REQUESTS} "
              f"requests, {e['steps']} steps at {e['ms']:.1f} ms (the "
              f"unsharded engine {ref['engine']['steps']} at "
              f"{ref['engine']['ms']:.2f} ms): tokens equal on every "
              f"rank: {same}; collectives {sorted(e['calls'].items())}")


def _sdd_check_moe(name, recs, ref, failures) -> None:
    fwd = [r["fwd"] for r in recs]
    dec = [r["dec"] for r in recs]
    tr = [r["train"] for r in recs]
    f_ratio = max(f.get("ratio", 0.0) for f in fwd)
    f_held, f_of = sum(f["held"] for f in fwd), sum(f["of"] for f in fwd)
    d_ratio = max(d.get("ratio", 0.0) for d in dec)
    d_held, d_of = sum(d["held"] for d in dec), sum(d["of"] for d in dec)
    d_first = sum(d["held_first"] for d in dec)
    d_of_first = sum(d["of_first"] for d in dec)
    cache = max(d["cache_ratio"] for d in dec)
    dt = recs[0]["dtype"]
    f32 = dt == "float32"
    fb, db = (("TOL_LM_F32", "TOL_LM_F32") if f32 else
              (f"2 x the bf16 noise {ref['moe_fwd_noise']:.4f}",
               f"2 x {ref['moe_dec_noise']:.4f}"))
    print(f"[sdd] {name}: forward {MOE15_FWD} ({MOE15_FWD_IMPL}) logits "
          f"{max(f.get('err', 0.0) for f in fwd):.3e} max abs, "
          f"{f_ratio:.2f}x {fb}, over the {f_held} of {f_of} row positions "
          f"before each row's first routing difference (C22); decode "
          f"{len(dec[0]['walls'])} steps on the split latent cache "
          f"{max(d.get('err', 0.0) for d in dec):.3e}, {d_ratio:.2f}x {db}, "
          f"over {d_held} of {d_of} row steps ({d_first} of {d_of_first}"
          f" in the first {SDD_HELD_STEPS}), caches {cache:.2f}x "
          f"{'TOL_LM_F32' if f32 else 'TOL_LM_BF16'}; median step "
          + ", ".join(_median_ms(d["walls"]) for d in dec)
          + f" ms a rank; decode collectives a step "
          f"{_calls_line(dec[0]['calls'][0], dec[0]['words'])}")
    if not (f_ratio <= 1.0 and d_ratio <= 1.0 and cache <= 1.0):
        failures.append(f"{name}: forward {f_ratio:.2f}x, decode "
                        f"{d_ratio:.2f}x, caches {cache:.2f}x the bound")
    if not (4 * f_held >= f_of and 4 * d_first >= d_of_first):
        failures.append(f"{name}: too few positions before a routing "
                        f"difference: {f_held} / {f_of}, in the first "
                        f"{SDD_HELD_STEPS} decode steps {d_first} / "
                        f"{d_of_first}")
    want = ref[("moe_train", dt)]
    t0 = tr[0]
    rel = max(abs(a - b) / abs(b) for a, b in zip(t0["loss"], want["loss"]))
    gn = max(abs(a - b) / abs(b) for a, b in zip(t0["grad_norm"],
                                                   want["grad_norm"]))
    print(f"[sdd] {name}: {len(t0['loss'])} {dt} steps of "
          f"make_train_step(rules=), {MOE15_BATCH} x {MOE15_SEQ} tokens in "
          f"{MOE15_MICRO} microbatches, remat: losses "
          f"{[round(x, 5) for x in t0['loss']]} vs "
          f"{[round(x, 5) for x in want['loss']]} (relative {rel:.3e}, "
          f"bound {TOL_MOE15_LOSS}), grad norms relative {gn:.3e} (bound "
          f"{TOL_MOE15_GNORM}); step walls "
          + ", ".join(f"{w:.2f}" for w in t0["walls"])
          + f" s (the reference "
          f"{', '.join(f'{w:.2f}' for w in want['wall'])}); peak a rank "
          + ", ".join(f"{t['peak'] / 2.0 ** 30:.2f}" for t in tr)
          + f" GiB; collectives a step "
          f"{_calls_line(t0['calls'][0], t0['words'])}")
    print(f"[sdd] {name}: seconds of rank 0 in its forward, decode and "
          f"training (checks included): "
          + ", ".join(f"{k} {v:.1f}" for k, v in recs[0]["parts"].items()))
    if not (rel <= TOL_MOE15_LOSS and gn <= TOL_MOE15_GNORM):
        failures.append(f"{name}: training vs the reference: loss "
                        f"{rel:.3e}, grad norm {gn:.3e}")
    if len({tuple(t["loss"]) for t in tr}) != 1:
        failures.append(f"{name}: the ranks' losses differ")
    if f32:
        for what, label in (("m1", "AdamW's first moment after step 1"),
                            ("m2", "AdamW's first moment after step 2"),
                            ("p1", "the params after step 1")):
            if what == "p1":
                ratios = t0[what]
                how = "x what the entry's gradient difference allows"
            else:
                ratios = [d / (TOL_GRAD_F32 * w) if w else d / TOL_GRAD_F32
                          for d, w in t0[what]]
                how = "x TOL_GRAD_F32 of the leaf's largest entry"
            j = max(range(len(ratios)), key=ratios.__getitem__)
            print(f"[sdd] {name}: {label} vs the unsharded f32 run, entry "
                  f"by entry (leaves of more than {MOE15_TREE_ENTRIES} "
                  f"entries at every k-th row): worst leaf {j} of "
                  f"{len(ratios)} "
                  f"{ratios[j]:.3f}{how}"
                  + (f" (max abs diff {t0[what][j][0]:.3e} of "
                     f"{t0[what][j][1]:.3e})" if what != "p1" else "")
                  + f"; leaves over 0.1x: {sum(r > 0.1 for r in ratios)}")
            if not ratios[j] <= 1.0:
                failures.append(f"{name}: {label}: leaf {j} "
                                f"{ratios[j]:.2f}x its bound")
    axes = {"data": 0, "model": 1}
    for k in range(len(t0["sums"])):
        for j, split in enumerate(t0["split"]):
            seen = {}
            for t in tr:
                key = tuple(t["coords"][axes[a]] for a in split)
                seen.setdefault(key, set()).add(t["sums"][k][j])
            if any(len(v) > 1 for v in seen.values()):
                failures.append(f"{name} step {k + 1}: leaf {j}'s "
                                f"replicated chunks differ")
    for r, rec in enumerate(recs):
        if any(c != rec["dec"]["want"] for c in rec["dec"]["calls"]):
            failures.append(f"{name} rank {r}: decode collectives "
                            f"{rec['dec']['calls'][0]}, not "
                            f"{rec['dec']['want']}")
        if any(c != rec["train"]["want"] for c in rec["train"]["calls"]):
            failures.append(f"{name} rank {r}: training collectives "
                            f"{rec['train']['calls'][0]}, not "
                            f"{rec['train']['want']}")


def sdd_kernel_entries(tally: dict, dev, seed: int, failures: list):
    """The kernels-record entries of every shape phase 15's ranks launched
    rmsnorm at, each checked against its plain version and timed here
    beside F.rms_norm."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed + 8)
    entries = []
    for (_, key), (n, cases) in sorted(tally.items(),
                                       key=lambda t: str(t[0])):
        rows, D, dt = key
        entry, ratio = _lmd_rmsnorm_entry(key, n, cases, gen, dev,
                                          f"rmsnorm_sdd_{rows}x{D}_{dt}")
        print(f"[sdd] rmsnorm {key}: {n} launches; {entry['ms']:.4f} ms | "
              f"plain {entry['plain_ms']:.4f} ms | F.rms_norm "
              f"{entry['library_ms']:.4f} ms | bound {entry['bound_ms']:.4f}"
              f" ms ({entry['bound_by']}) | vs plain max abs err "
              f"{entry['max_abs_err']:.3e} ({ratio:.2f}x tolerance)")
        if not ratio <= 1.0:
            failures.append(f"phase 15: rmsnorm {key} disagrees with its "
                            f"plain version")
        entries.append(entry)
    torch.cuda.empty_cache()
    return entries

# ---- phase 18: the sharded SSM family and encoder-decoder stack ---------

def s18_configs() -> dict:
    """Phase 18's models at full width, their depth cut (S18_*)."""
    from repro_torch.configs import get_config
    return {"zamba2": dataclasses.replace(
                get_config("zamba2_1p2b"), n_layers=2 * S18_ZAMBA_PERIODS,
                attn_impl="flash"),
            "falcon": dataclasses.replace(get_config("falcon_mamba_7b"),
                                          n_layers=S18_FALCON_LAYERS),
            "whisper": get_config("whisper_tiny"),
            "vl": dataclasses.replace(get_config("qwen2_vl_72b"),
                                      n_layers=S18_VL_LAYERS,
                                      attn_impl="flash")}


def s18_cfg(name: str, dt: str, part: str):
    """A case's config in ``dt``; training on plain attention."""
    cfg = dataclasses.replace(s18_configs()[name], dtype=dt)
    return (dataclasses.replace(cfg, attn_impl="naive") if part == "train"
            else cfg)


def _s18_leaf(path, shape, gen, dev):
    """One f32 leaf drawn as the port's init draws its kind: ones for the
    norm scales and D, zeros for the biases, -4.6 for dt_bias, Mamba-1's
    A_log log(1 .. n) and Mamba-2's zeros, N(0, 0.1) for conv_w, N(0,
    0.02) for the tables, and the matrices truncated-normal over their
    fan-in."""
    import torch
    name = path[-1]
    if name in ("scale", "norm_scale", "D"):
        return torch.ones(shape, device=dev)
    if name == "bias":
        return torch.zeros(shape, device=dev)
    if name == "dt_bias":
        return torch.full(shape, -4.6, device=dev)
    if name == "A_log":
        if len(shape) == 1:
            return torch.zeros(shape, device=dev)
        return torch.log(torch.arange(1, shape[1] + 1, dtype=torch.float32,
                                      device=dev)).expand(shape).clone()
    w = torch.empty(shape, device=dev)
    if name in ("conv_w", "table"):
        return w.normal_(0.0, 1.0, generator=gen).mul_(
            0.1 if name == "conv_w" else 0.02)
    fan_in = shape[0] * (shape[1] if name == "wo" and len(shape) == 3
                         else 1)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(fan_in ** -0.5)


def s18_params(cfg, dev, seed: int, rules=None) -> dict:
    """Random f32 params of ``cfg`` on ``dev``, each leaf from a generator
    of its own (``seed`` and the leaf's index, ``_s18_leaf``); with
    ``rules`` this rank's chunk of each, its whole leaf dropped at once
    (a rank of Qwen2-VL never holds the whole model)."""
    import torch
    from repro_torch.models import abstract_params
    from repro_torch.models.lm import param_specs
    from repro_torch.models.sharding import shard_leaf, spec_at
    from repro_torch.tree import leaves_with_paths, unflatten
    tree = abstract_params(cfg)
    specs = None if rules is None else param_specs(rules, cfg)
    out = []
    for i, (path, meta) in enumerate(leaves_with_paths(tree)):
        gen = torch.Generator(device=dev).manual_seed(seed * 7919 + i)
        t = _s18_leaf(path, tuple(meta.shape), gen, dev)
        if rules is not None:
            t = shard_leaf(rules.mesh, t, spec_at(specs, path))
        out.append(t)
    return unflatten(tree, out)


def _s18_seed(name: str, seed: int) -> int:
    return seed + 40 + sorted(s18_configs()).index(name)


def _s18_state(cfg, dev, seed: int) -> dict:
    """The whole decode state of S18_SLOTS rows and S18_MAX_SEQ positions,
    every cache (the Mamba states, shared_cache, cross_kv) drawn at random
    (bf16 values in every dtype, as phase 15's), its rows at S18_POS."""
    import torch
    from repro_torch.models import init_decode_state
    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    state = init_decode_state(cfg, S18_SLOTS, S18_MAX_SEQ, device=dev,
                              with_encoder=bool(cfg.encoder_layers))
    for key in ("caches", "shared_cache", "cross_kv"):
        if key in state:
            state[key] = [tuple(torch.randn(t.shape, generator=gen,
                                            device=dev)
                                .to(torch.bfloat16).to(t.dtype)
                                for t in pair) for pair in state[key]]
    state["pos"] = torch.tensor(S18_POS, dtype=torch.int64, device=dev)
    return state


def _s18_keys(state) -> list:
    return [k for k in ("caches", "shared_cache", "cross_kv") if k in state]


def _s18_audio(cfg, batch: int, seed: int):
    """Frame embeddings (batch, encoder_seq, d_model) f32 on the host."""
    import torch
    gen = torch.Generator().manual_seed(seed + 9)
    return torch.randn((batch, cfg.encoder_seq, cfg.d_model), generator=gen)


def _s18_batch(cfg, seed: int) -> dict:
    """The training step's batch on the host (Whisper's with frames)."""
    from repro_torch.data.tokens import TokenPipeline
    batch = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=S18_TRAIN_SEQ,
                          global_batch=S18_TRAIN_BATCH,
                          seed=seed).batch(0)
    if cfg.encoder_layers:
        batch["audio_embed"] = _s18_audio(cfg, S18_TRAIN_BATCH, seed + 1)
    return batch


def _s18_requests(cfg, seed: int) -> list:
    from repro_torch.train import Request
    toks = _sdd_tokens(cfg.vocab_size, (S18_REQUESTS, S18_PROMPT), seed + 2)
    return [Request(rid=i, prompt=toks[i].tolist(), max_new_tokens=S18_NEW)
            for i in range(S18_REQUESTS)]


def _s18_forward(params, cfg, name: str, seed: int, dev, rules=None):
    """The f32 logits of the forward of S18_FWD[name] tokens (this rank's
    rows with ``rules``)."""
    import torch
    from repro_torch.models import forward
    from repro_torch.models.sharding import batch_rows
    B, S = S18_FWD[name]
    rows = batch_rows(rules, B)
    toks = _sdd_tokens(cfg.vocab_size, (B, S), seed)[rows].to(dev)
    with torch.no_grad():
        return forward(params, cfg, toks, rules=rules).float()


def s18_reference(dev, args, path: Path) -> dict:
    """Phase 18's references, in this process alone on the card (before
    the ranks take it): every case's parts run unsharded on the same
    weights (the bf16 ones in f32 too: their bf16 noise), saved to
    ``path``; returns the walls and the noise."""
    import torch
    from repro_torch.models import decode_step, prefill_cross_kv
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.tree import leaves
    host, info = {}, {}
    for name, shape, dt, parts in S18_CASES:
        seed = _s18_seed(name, args.seed)
        params = s18_params(s18_configs()[name], dev, seed)
        for part in parts:
            dts = (dt,) if dt == "float32" else (dt, "float32")
            t0 = time.perf_counter()
            if part == "forward":
                lg = {d: _s18_forward(params, s18_cfg(name, d, part), name,
                                      seed, dev).cpu() for d in dts}
                host[(name, dt, part)] = {
                    "logits": lg[dt],
                    "noise": float((lg[dt] - lg["float32"]).abs().max())}
            elif part == "decode":
                runs = {}
                for d in dts:
                    cfg = s18_cfg(name, d, part)
                    state = _s18_state(cfg, dev, seed)
                    toks = _sdd_tokens(cfg.vocab_size,
                                       (S18_STEPS, S18_SLOTS, 1), seed)
                    logits = []
                    with torch.no_grad():
                        for t in range(S18_STEPS):
                            lg, state = decode_step(params, cfg, state,
                                                    toks[t].to(dev))
                            logits.append(lg.float().cpu())
                    runs[d] = {"logits": logits, "state": {
                        k: [[c.float().cpu() for c in pair]
                            for pair in state[k]] for k in _s18_keys(state)}}
                rec = runs[dt]
                rec["noise"] = _bf16_noise(rec["logits"],
                                           runs["float32"]["logits"])
                rec["state_noise"] = max(
                    float((a - b).abs().max())
                    for k in rec["state"]
                    for pa, pb in zip(rec["state"][k],
                                      runs["float32"]["state"][k])
                    for a, b in zip(pa, pb))
                host[(name, dt, part)] = rec
            elif part == "prefill":
                cfg = s18_cfg(name, dt, part)
                with torch.no_grad():
                    ck = prefill_cross_kv(params, cfg, _s18_audio(
                        cfg, S18_SLOTS, seed).to(dev))
                host[(name, dt, part)] = [[t.cpu() for t in pair]
                                          for pair in ck]
            elif part == "engine":
                cfg = s18_cfg(name, dt, part)
                host[(name, dt, part)] = _s18_engine(params, cfg, None,
                                                     seed)
            else:
                cfg = s18_cfg(name, dt, part)
                p = s18_params(cfg, dev, seed)
                opt = adamw_init(p)
                step = make_train_step(cfg, lmd_acfg(),
                                       TrainConfig(microbatches=1))
                p, opt, m = step(p, opt, _s18_batch(cfg, seed))
                host[(name, dt, part)] = {
                    "loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    "m1": [_tree_sample(t) for t in leaves(opt["m"])]}
                del p, opt, step
            torch.cuda.synchronize()
            info[(name, dt, part)] = time.perf_counter() - t0
            noise = host[(name, dt, part)]
            if isinstance(noise, dict) and "noise" in noise:
                info[(name, dt, part, "noise")] = noise["noise"]
        del params
        torch.cuda.empty_cache()
    torch.save(host, path)
    return info


def _s18_engine(params, cfg, rules, seed: int) -> dict:
    """The f32 engine answering phase 18's requests: generated tokens by
    request, steps, mean step wall, collectives."""
    import torch
    from repro_torch.launch.mesh import COLLECTIVES
    from repro_torch.train import ServingEngine
    eng = ServingEngine(params, cfg, n_slots=S18_SLOTS,
                        max_seq=S18_ENGINE_SEQ, rules=rules)
    reqs = _s18_requests(cfg, seed)
    for r in reqs:
        eng.submit(r)
    COLLECTIVES.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = eng.run_until_done()
    torch.cuda.synchronize()
    return {"tokens": {r.rid: list(r.generated) for r in reqs},
            "steps": steps, "ms": (time.perf_counter() - t0) / steps * 1e3,
            "calls": dict(COLLECTIVES.calls)}


def _s18_err(rec, got, want, noise=None, tol=TOL_LM_F32) -> None:
    """``_sdd_err``: bf16 within twice ``noise`` (a noise of zero admits
    no difference), f32 at ``tol``."""
    if noise is not None:
        noise = max(noise, 1e-30)
    _sdd_err(rec, got, want, noise, None if noise is not None else tol)


def _s18_part(part, name, dt, rules, params, host, seed, dev) -> dict:
    """One part of a case on this rank, held against the reference."""
    import torch
    from repro_torch.launch.mesh import COLLECTIVES
    from repro_torch.models import decode_step, prefill_cross_kv
    from repro_torch.models.lm import decode_state_layout, param_specs
    from repro_torch.models.sharding import (batch_rows, leaf_specs,
                                             shard_leaf, split_axes)
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.train_step import (decode_collectives,
                                              step_collectives)
    from repro_torch.tree import leaves
    cfg = s18_cfg(name, dt, part)
    ref = host[(name, dt, part)]
    mesh = rules.mesh
    bf16 = dt != "float32"
    rec = {"walls": [], "calls": []}

    def chunks_err(state, want, noise):
        layout = decode_state_layout(rules, cfg, S18_SLOTS, S18_MAX_SEQ)
        out = {}
        for k in want:
            for pair, spair, wpair in zip(state[k], layout[k], want[k]):
                for t, sp, w in zip(pair, spair, wpair):
                    _s18_err(out, t.float(), shard_leaf(mesh, w, sp).to(dev),
                             noise)
        return out

    if part == "forward":
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg = _s18_forward(params, cfg, name, seed, dev, rules)
        torch.cuda.synchronize()
        rec["walls"].append(time.perf_counter() - t0)
        rows = batch_rows(rules, S18_FWD[name][0])
        _s18_err(rec, lg, ref["logits"][rows], ref["noise"])
        del lg
    elif part == "decode":
        full = _s18_state(cfg, dev, seed)
        layout = decode_state_layout(rules, cfg, S18_SLOTS, S18_MAX_SEQ)
        state = {k: [tuple(shard_leaf(mesh, t, sp) for t, sp in
                           zip(pair, spair))
                     for pair, spair in zip(full[k], layout[k])]
                 for k in _s18_keys(full)}
        state.update(pos=full["pos"], max_seq=S18_MAX_SEQ)
        del full
        toks = _sdd_tokens(cfg.vocab_size, (S18_STEPS, S18_SLOTS, 1), seed)
        rows = batch_rows(rules, S18_SLOTS)
        rec["want"] = decode_collectives(cfg, rules, S18_SLOTS, S18_MAX_SEQ)
        noise = ref["noise"] if bf16 else None
        for t in range(S18_STEPS):
            COLLECTIVES.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                lg, state = decode_step(params, cfg, state, toks[t].to(dev),
                                        rules=rules)
            torch.cuda.synchronize()
            rec["walls"].append(time.perf_counter() - t0)
            rec["calls"].append(dict(COLLECTIVES.calls))
            _s18_err(rec, lg, ref["logits"][t][rows], noise)
        st = chunks_err(state, ref["state"],
                        ref["state_noise"] if bf16 else None)
        rec["state_ratio"], rec["state_err"] = st["ratio"], st["err"]
        del state
    elif part == "prefill":
        t0 = time.perf_counter()
        with torch.no_grad():
            ck = prefill_cross_kv(params, cfg, _s18_audio(
                cfg, S18_SLOTS, seed).to(dev), rules=rules)
        torch.cuda.synchronize()
        rec["walls"].append(time.perf_counter() - t0)
        st = chunks_err({"cross_kv": ck}, {"cross_kv": ref}, None)
        rec["ratio"], rec["err"] = st["ratio"], st["err"]
        del ck
    elif part == "engine":
        eng = _s18_engine(params, cfg, rules, seed)
        rec.update(steps=eng["steps"], ms=eng["ms"],
                   engine_calls=eng["calls"],
                   equal=eng["tokens"] == ref["tokens"])
        rec["walls"] = [eng["ms"] / 1e3]
    else:
        tcfg = TrainConfig(microbatches=1)
        flat = leaf_specs(param_specs(rules, cfg), params)
        opt = adamw_init(params)
        step = make_train_step(cfg, lmd_acfg(), tcfg, rules)
        rec["want"] = step_collectives(cfg, tcfg, rules, False)
        COLLECTIVES.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, _s18_batch(cfg, seed))
        torch.cuda.synchronize()
        rec["walls"].append(time.perf_counter() - t0)
        rec["calls"].append(dict(COLLECTIVES.calls))
        rec.update(ref={k: ref[k] for k in ("loss", "grad_norm")},
                   loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                   sums=[_lmd_checksum(t) for t in leaves(params)],
                   coords=(mesh.index("data"), mesh.index("model")),
                   split=[[a for _, a in split_axes(mesh, sp)]
                          for sp in flat])
        rec["m1"] = _sdd_leaf_max(mesh, opt["m"], flat, ref["m1"], dev)
        del opt, step
    torch.cuda.empty_cache()
    return rec


def _release_host_cache() -> None:
    """Return the pinned host blocks the CUDA caching host allocator keeps
    to the system: gloo stages a CUDA tensor's collective through them
    (rounded up to a power of two), and four ranks' caches of phases
    12-15 and of Qwen2-VL's table gathers (a 5 GB f32 embedding, gathered
    whole) would otherwise add up past the host's 96 GiB."""
    import torch
    fn = getattr(torch._C, "_host_emptyCache", None)
    if fn is not None:
        fn()


def _host_gib() -> tuple:
    """(resident, peak resident) GiB of this process (``/proc``,
    ``getrusage``)."""
    import resource
    rss = float("nan")
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                rss = int(line.split()[1]) / 2 ** 20
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    return rss, peak


def s18_rank(world: int, dev, seed: int, ref_path: str) -> list:
    """Phase 18 on one rank of phase 12's world-DIST_WORLD spawn (after
    phase 15): each case's params drawn as this rank's chunks, each part
    driven with the kernels' launch counts zeroed just before it and read
    just after, with the shapes they were launched at."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_bwd_cuda,
                                                     flash_fwd_cuda)
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import MeshRules
    if world != DIST_WORLD:
        return []
    host = torch.load(ref_path, mmap=True, weights_only=False)
    out = []
    t_all = time.perf_counter()
    _release_host_cache()
    for name, shape, dt, parts in S18_CASES:
        rules = MeshRules(make_mesh(*shape))
        case_seed = _s18_seed(name, seed)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = s18_params(s18_configs()[name], dev, case_seed, rules)
        rec = {"label": f"{name} {shape[0]}x{shape[1]} {dt}", "name": name,
               "dtype": dt, "mesh": shape, "parts": {},
               "init_s": time.perf_counter() - t0}
        for part in parts:
            for fn in (rmsnorm_cuda, flash_fwd_cuda, flash_bwd_cuda):
                fn.by_shape.clear()
            lm_zero_counts()
            t1 = time.perf_counter()
            res = _s18_part(part, name, dt, rules, params, host, case_seed,
                            dev)
            res.update(launches=lm_counts(), seconds=time.perf_counter() - t1,
                       shapes={"rmsnorm": dict(rmsnorm_cuda.by_shape),
                               "flash_fwd": dict(flash_fwd_cuda.by_shape),
                               "flash_bwd": dict(flash_bwd_cuda.by_shape)},
                       host_gib=_host_gib())
            _release_host_cache()
            rec["parts"][part] = res
        rec.update(seconds=time.perf_counter() - t0,
                   peak=torch.cuda.max_memory_allocated() - base)
        del params
        torch.cuda.empty_cache()
        out.append(rec)
    out.append({"seconds": time.perf_counter() - t_all})
    return out


def _s18_launches(cfg, part: str) -> tuple:
    """The launches (``lm_counts``) a part makes on a rank: rmsnorm at
    every norm of a forward or decode step (none on Whisper's layernorm),
    a remat training step's forward and recompute (the final norm once),
    the tensor-core flash forward once a forward for each attention
    (Zamba2's shared block at each application, Qwen2-VL's layers)."""
    norms = lm_norms(cfg) if cfg.norm == "rmsnorm" else 0
    if part == "forward":
        attns = (cfg.n_periods if cfg.shared_attn_every
                 else cfg.n_layers * (not cfg.has_ssm))
        return (norms, attns, 0, 0, 0)
    if part == "decode":
        return (norms * S18_STEPS, 0, 0, 0, 0)
    if part == "train":
        return (max(2 * norms - 1, 0), 0, 0, 0, 0)
    return (0, 0, 0, 0, 0)


def s18_check(info: dict, runs: dict, failures: list) -> dict:
    """Phase 18's checks of the ranks' records (``runs``: world -> the
    ranks' ``s18_rank`` lists): every part against the unsharded run
    (bf16 logits and state chunks within twice the unsharded run's bf16
    noise, f32 at TOL_LM_F32; the f32 training's loss and grad norm at
    TOL_LM_F32 relative and AdamW's first moment entry by entry within
    TOL_GRAD_F32 of each leaf's largest entry; the engine's tokens equal
    to the unsharded engine's); collectives exactly decode_collectives /
    step_collectives; each part's kernel launches exact on every rank
    (``_s18_launches``); ranks that hold the same chunk of a leaf the same
    bits after the step.  Prints walls and peaks.  Returns the launch
    tally by kernel and shape with the parts that launched it."""
    gib = 2.0 ** 30
    ranks = runs[DIST_WORLD]
    print(f"[s18] reference, one process alone on the card: "
          + "; ".join(f"{' '.join(k[:3])} {v:.1f} s" for k, v in
                      info.items() if len(k) == 3)
          + "; bf16 noise (max |bf16 - f32| logits of the unsharded run) "
          + ", ".join(f"{' '.join(k[:3])} {v:.4f}" for k, v in
                      info.items() if len(k) == 4))
    print(f"[s18] phase 18 in the ranks "
          f"{max(r[-1]['seconds'] for r in ranks):.1f} s")
    tally = {}
    for i, rec0 in enumerate(ranks[0][:-1]):
        recs = [r[i] for r in ranks]
        cfgs = {p: s18_cfg(rec0["name"], rec0["dtype"], p)
                for p in rec0["parts"]}
        label = f"gloo, world {DIST_WORLD} {rec0['label']}"
        print(f"[s18] {label}: {rec0['seconds']:.1f} s (params "
              f"{rec0['init_s']:.1f} s); device-memory peak a rank "
              + ", ".join(f"{r['peak'] / gib:.2f}" for r in recs)
              + " GiB; host memory a rank after each part (resident, "
              "peak resident GiB) "
              + "; ".join(f"{p} " + ", ".join(
                  f"({r['parts'][p]['host_gib'][0]:.1f}, "
                  f"{r['parts'][p]['host_gib'][1]:.1f})" for r in recs)
                  for p in rec0["parts"]))
        for part, res0 in rec0["parts"].items():
            parts = [r["parts"][part] for r in recs]
            what = f"{label} {part}"
            line = f"[s18] {what}: {res0['seconds']:.1f} s"
            want = _s18_launches(cfgs[part], part)
            for r, res in enumerate(parts):
                if res["launches"] != want:
                    failures.append(f"{what} rank {r}: launches (rmsnorm, "
                                    f"flash fwd, dq, dkv, FP32-FMA) "
                                    f"{res['launches']}, not {want}")
                if "want" in res and any(c != res["want"]
                                         for c in res["calls"]):
                    failures.append(f"{what} rank {r}: collectives "
                                    f"{res['calls'][0]}, not {res['want']}")
                for kname, shapes in res["shapes"].items():
                    for key, n in shapes.items():
                        t = tally.setdefault((kname, key), [0, set()])
                        t[0] += n
                        t[1].add(what)
            line += f"; launches a rank {res0['launches']}"
            if "ratio" in res0:
                ratio = max(r["ratio"] for r in parts)
                line += (f"; vs the unsharded run max abs err "
                         f"{max(r['err'] for r in parts):.3e} "
                         f"({ratio:.2f}x the bound)")
                if not ratio <= 1.0:
                    failures.append(f"{what}: {ratio:.2f}x the bound")
            if "state_ratio" in res0:
                ratio = max(r["state_ratio"] for r in parts)
                line += (f", state chunks {max(r['state_err'] for r in parts):.3e}"
                         f" ({ratio:.2f}x)")
                if not ratio <= 1.0:
                    failures.append(f"{what}: state chunks {ratio:.2f}x "
                                    f"the bound")
            if part == "engine":
                line += (f"; {res0['steps']} steps at {res0['ms']:.2f} ms, "
                         f"tokens equal to the unsharded engine's: "
                         f"{all(r['equal'] for r in parts)}")
                if not all(r["equal"] for r in parts):
                    failures.append(f"{what}: tokens differ from the "
                                    f"unsharded engine's")
            if part == "train":
                line += _s18_check_train(what, parts, failures)
            if part in ("decode", "forward", "train"):
                line += (f"; median wall a rank "
                         + ", ".join(_median_ms(r["walls"]) for r in parts)
                         + " ms (processes time-sliced on one card)")
            if res0["calls"]:
                line += f"; collectives a step {res0['calls'][0]}"
            print(line)
    return tally


def _s18_check_train(what, parts, failures) -> str:
    """The f32 training step's checks (``s18_check``); its printed part."""
    res0 = parts[0]
    ref = res0["ref"]
    loss = abs(res0["loss"] - ref["loss"]) / abs(ref["loss"])
    gnorm = abs(res0["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
    if len({r["loss"] for r in parts}) != 1:
        failures.append(f"{what}: the ranks report other losses")
    if not (loss <= TOL_LM_F32 and gnorm <= TOL_LM_F32):
        failures.append(f"{what}: loss {loss:.2e} / grad norm {gnorm:.2e} "
                        f"relative to the unsharded step")
    m1 = max(d / (TOL_GRAD_F32 * w) if w else d / TOL_GRAD_F32
             for d, w in res0["m1"])
    if not m1 <= 1.0:
        failures.append(f"{what}: AdamW's first moment {m1:.2f}x "
                        f"TOL_GRAD_F32 of the leaf's largest entry")
    axes = {"data": 0, "model": 1}
    for j, split in enumerate(res0["split"]):
        groups = {}
        for r in parts:
            key = tuple(r["coords"][axes[a]] for a in split)
            groups.setdefault(key, set()).add(r["sums"][j])
        if any(len(v) > 1 for v in groups.values()):
            failures.append(f"{what}: leaf {j}'s replicas differ")
            break
    return (f"; loss {res0['loss']:.6f} (unsharded {ref['loss']:.6f}, "
            f"{loss:.1e} relative), grad norm {gnorm:.1e} relative, first "
            f"moment {m1:.2f}x TOL_GRAD_F32 of the leaf's largest entry")


def s18_kernel_entries(tally: dict, dev, seed: int, failures: list):
    """The kernels-record entries of every shape phase 18's ranks launched
    rmsnorm and the tensor-core flash forward at, each checked against its
    plain version and timed here beside F.rms_norm / SDPA."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    entries = []
    for (kname, key), (n, cases) in sorted(tally.items(),
                                           key=lambda t: str(t[0])):
        if kname == "rmsnorm":
            rows, D, dt = key
            entry, ratio = _lmd_rmsnorm_entry(
                key, n, cases, gen, dev, f"rmsnorm_s18_{rows}x{D}_{dt}")
            new, ratios = [entry], {"rmsnorm": ratio}
        elif kname == "flash_fwd":
            if key[0] != "wgmma":
                failures.append(f"phase 18 launched the FP32-FMA flash "
                                f"forward at {key}")
                continue
            n_bwd = tally.get(("flash_bwd", key), (0,))[0]
            new, ratios = _lmd_flash_entries(key, n, n_bwd, cases, gen, dev,
                                             tag="s18")
            if not n_bwd:       # a forward's shape: dq and dkv checked only
                new = new[:1]
        else:
            continue
        for e in new:
            print(f"[s18] {e['name']} {e['shape']}: {e['launches']} "
                  f"launches; {e['ms']:.4f} ms | plain {e['plain_ms']:.4f} ms"
                  f" | library {e['library_ms']:.4f} ms | bound "
                  f"{e['bound_ms']:.4f} ms ({e['bound_by']}) | vs plain max "
                  f"abs err {e['max_abs_err']:.3e}")
        print(f"[s18] {kname} {key}: error / bound "
              + ", ".join(f"{w} {r:.3f}" for w, r in ratios.items()))
        if not max(ratios.values()) <= 1.0:
            failures.append(f"phase 18: {kname} {key} disagrees with its "
                            f"plain version: {ratios}")
        entries.extend(new)
    for kname in ("rmsnorm", "flash_fwd"):
        if not any(k == kname for k, _ in tally):
            failures.append(f"phase 18 launched no {kname}")
    torch.cuda.empty_cache()
    return entries


def profiled_kernels(run, calls: int) -> list:
    """The CUDA kernels torch.profiler records over ``calls`` calls of
    ``run`` (``key_averages`` entries).  It records the device activity
    alone: host op events cost more to sort through afterwards than the
    run takes (a training step's 19 000 launches: 16 s)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def profile_summary(kernels: list, calls: int):
    """Device-busy ms per call (the sum of the kernel durations), kernel
    launches per call, and the five kernels with the most device time, as
    (name, ms per call, launches per call), of ``profiled_kernels``' list;
    (None, 0, []) where the profiler recorded no device time."""
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / calls
    launches = sum(e.count for e in kernels) / calls
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return ((busy if busy > 0 else None), launches,
            [(e.key[:80], e.self_device_time_total / 1e3 / calls,
              e.count / calls) for e in top])


def device_profile(run, calls: int):
    """``profile_summary`` of ``calls`` profiled calls of ``run``."""
    return profile_summary(profiled_kernels(run, calls), calls)


def kernel_device_ms(kernels: list, match: str):
    """(device ms a launch, launches) of the kernels whose name holds
    ``match`` in ``profiled_kernels``' list; (None, 0) where it holds
    none."""
    hits = [e for e in kernels if match in e.key]
    count = sum(e.count for e in hits)
    total = sum(e.self_device_time_total for e in hits) / 1e3
    return (total / count if count and total > 0 else None), count


def rel_fro(got, want) -> float:
    """||got - want||_F / ||want||_F in f64."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def flash_err(got, want, what: str, dtype, tol=None) -> tuple:
    """(max abs err, max of err / tolerance) of a flash output against its
    plain version: ``tol``, an elementwise bound, where given (the
    tensor-core kernels' derived bf16 bound), else bf16 o at
    TOL_FLASH_BF16_*, f32 o and every lse at the f32 limits."""
    import torch
    got, want = got.double(), want.double()
    e = (got - want).abs()
    if tol is None:
        rtol, atol = ((TOL_FLASH_BF16_R, TOL_FLASH_BF16_A)
                      if what == "o" and dtype == torch.bfloat16
                      else (TOL_FLASH_F32_R, TOL_FLASH_F32_A))
        tol = atol + rtol * want.abs()
    return float(e.max()), float((e / tol.double()).max())


def swap_pairs(t):
    """Rows 2i and 2i + 1 of every (BH, len, d) head swapped: the layout
    fault a wrong shared-memory descriptor would make inside a tile."""
    n = t.shape[1] // 2 * 2
    out = t.clone()
    out[:, :n] = t[:, :n].reshape(t.shape[0], n // 2, 2, t.shape[2]).flip(
        2).reshape(t.shape[0], n, t.shape[2])
    return out


def flash_variant(q, k, v, skip):
    """A wrong causal flash forward, ``(o, lse)``, for phase 7a's check of
    its own tolerance: keys ``skip = (lo, hi)`` left out of every row at
    or past ``hi`` (a k tile skipped)."""
    import torch
    from repro_torch.kernels.ref import attention_scores
    s = attention_scores(q, k, True)
    lo, hi = skip
    rows = torch.arange(s.shape[1], device=s.device)[:, None]
    s[:, :, lo:hi] = torch.where(rows >= hi, -1e30, s[:, :, lo:hi])
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bqk,bkd->bqd", p, v.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def lm_phase(dev, args, failures):
    """Phase 7 (module docstring): the LM's prefill and serving at full
    Qwen3-1.7B width.  Returns the ``rmsnorm`` and ``flash_fwd`` entries
    of the kernels record."""
    import dataclasses
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels._launch import DTYPE_CODES
    from repro_torch.kernels.flash_attention import (flash_fwd_cuda,
                                                     flash_fwd_plain,
                                                     flash_route)
    from repro_torch.kernels.ref import flash_fwd_bf16_tolerance
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_plain
    from repro_torch.models import (decode_step, forward, init_decode_state,
                                    init_params)
    from repro_torch.train import Request, ServingEngine, greedy_generate
    from repro_torch.tree import leaves

    f32, bf16 = torch.float32, torch.bfloat16
    cfg = dataclasses.replace(get_config("qwen3_1p7b"), attn_impl="flash")
    B, S, H, hd = LM_BATCH, LM_SEQ, cfg.n_heads, cfg.head_dim
    D, V = cfg.d_model, cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    mib = 2.0 ** 20

    def counts():
        return {"rmsnorm": rmsnorm_cuda.launches,
                "flash_fwd": flash_fwd_cuda.launches,
                "flash_fwd_wgmma": flash_fwd_cuda.launches_wgmma}

    def reset():
        rmsnorm_cuda.launches = flash_fwd_cuda.launches = 0
        flash_fwd_cuda.launches_wgmma = 0

    # ---- a. parity of the kernels with their plain versions ---------------
    err_at = {}
    for n_rows, d in ((B * S, D), (B * S * H, hd), (B * S - 5, D),
                      (1001, 384)):
        x32 = torch.randn((n_rows, d), generator=gen, device=dev)
        scale = torch.randn((d,), generator=gen, device=dev)
        for dt, tol in ((f32, TOL_RMSNORM_F32), (bf16, TOL_BF16)):
            x = x32.to(dt)
            got, want = rmsnorm_cuda(x, scale), rmsnorm_plain(x, scale)
            ratio, err = allclose_ratio(got.float(), want.float(), tol)
            err_at[("rmsnorm", n_rows, d, str(dt))] = err
            if not (ratio <= 1.0 and got.dtype == dt
                    and got.shape == x.shape):
                failures.append(f"rmsnorm ({n_rows}, {d}) {dt}: max abs err "
                                f"{err:.3e} ({ratio:.2f}x tolerance)")
    # the tensor-core forward (bf16, hd = hdv in {64, 128}) at the path's
    # shape, hd 64 and ragged S and T; the FP32-FMA forward (f32, hd !=
    # hdv); each held within its route's bound
    flash_cases = [((B * H, S, S, hd, hd), bf16, True),
                   ((B * H, S, S, hd, hd), bf16, False),
                   ((16, 512, 512, 64, 64), bf16, True),
                   ((8, 100, 40, hd, hd), bf16, False),
                   ((8, 17, 17, hd, hd), bf16, True),
                   ((B * H, S, S, hd, hd), f32, True),
                   ((16, 512, 512, 64, hd), bf16, True),
                   ((8, 100, 100, hd, 32), f32, False)]
    for (BH, s_q, s_k, d_qk, d_v), dt, causal in flash_cases:
        q = torch.randn((BH, s_q, d_qk), generator=gen, device=dev).to(dt)
        k = torch.randn((BH, s_k, d_qk), generator=gen, device=dev).to(dt)
        v = torch.randn((BH, s_k, d_v), generator=gen, device=dev).to(dt)
        route = flash_route(dt, d_qk, d_v)
        before = counts()
        o, lse = flash_fwd_cuda(q, k, v, causal=causal)
        moved = {n: c - before[n] for n, c in counts().items()}
        want_moved = "flash_fwd_wgmma" if route == "wgmma" else "flash_fwd"
        if moved[want_moved] != 1 or sum(moved.values()) != 1:
            failures.append(f"flash_fwd {(BH, s_q, d_qk, d_v)} {dt}: "
                            f"launches {moved}, expected one {want_moved}")
        o_p, lse_p = flash_fwd_plain(q, k, v, causal=causal)
        tol = (flash_fwd_bf16_tolerance(q, k, v, o_p, causal)
               if route == "wgmma" else None)
        key = ("flash", BH, s_q, s_k, d_qk, d_v, str(dt)[6:], causal, route)
        for what, got, want, t in (("o", o, o_p, tol),
                                   ("lse", lse, lse_p, None)):
            err, ratio = flash_err(got, want, what, dt, t)
            err_at[key + (what,)] = (err, ratio)
            if not ratio <= 1.0:
                failures.append(f"flash_fwd {(BH, s_q, s_k, d_qk, d_v)} {dt}"
                                f" causal={causal} {what}: max abs err "
                                f"{err:.3e} ({ratio:.2f}x tolerance)")
        if key[1:] == (B * H, S, S, hd, hd, "bfloat16", True, "wgmma"):
            # the path's bf16 forward: its error as a median too, and
            # against the plain version that rounds p to bf16 as it does
            e = (o.float() - o_p.float()).abs()
            o_r, _ = flash_fwd_plain(q, k, v, causal=True, round_p=True)
            err_at["flash-path"] = (float(e.max()), float(e.median()),
                                    float(e.mean()),
                                    float((o.float() - o_r.float())
                                          .abs().max()))
            del e, o_r
        del tol
    del o, lse, o_p, lse_p, x32, x
    # What the flash check reads for wrong functions at the path's shape
    # (bf16, causal, the tensor-core route and its derived bound): the
    # kernel with the softmax scale 5% off, the plain version with the
    # second 64-key tile left out of every later q tile (a skipped k tile),
    # and the kernel fed k with rows swapped in pairs (a descriptor fault
    # inside a tile).  Each must fail the tolerance, or it would pass a
    # wrong kernel.  (A "p rounded to bf16" variant would be what this
    # kernel computes, as the TPU kernel does: it marks no fault.)
    q, k, v = (torch.randn((B * H, S, hd), generator=gen, device=dev)
               .to(bf16) for _ in range(3))
    o_p, lse_p = flash_fwd_plain(q, k, v, causal=True)
    tol = flash_fwd_bf16_tolerance(q, k, v, o_p, True)
    wrong = {"scale x 1.05": flash_fwd_cuda(q, k, v, True,
                                            1.05 * hd ** -0.5),
             "k tile 64:128 skipped": flash_variant(q, k, v, (64, 128)),
             "k rows swapped in pairs": flash_fwd_cuda(q, swap_pairs(k), v,
                                                       True)}
    for name, (o, lse) in wrong.items():
        reads = [flash_err(o, o_p, "o", bf16, tol),
                 flash_err(lse, lse_p, "lse", bf16)]
        err_at[("flash-wrong", name)] = reads
        if max(r for _, r in reads) <= 1.0:
            failures.append(f"flash check passes a wrong kernel ({name})")
    del q, k, v, o, lse, o_p, lse_p, wrong, tol
    torch.cuda.synchronize()
    print(f"[lm-parity] {len(err_at)} comparisons; tolerances: rmsnorm f32 "
          f"{TOL_RMSNORM_F32}, bf16 {TOL_BF16}; flash o f32 "
          f"{TOL_FLASH_F32_R} rel / {TOL_FLASH_F32_A} abs, bf16 FP32-FMA "
          f"route {TOL_FLASH_BF16_R} / {TOL_FLASH_BF16_A}, bf16 wgmma "
          f"route the derived bound (ref.flash_fwd_bf16_tolerance); lse "
          f"f32 limits")
    for key, err in err_at.items():
        if key == "flash-path":
            print(f"[lm-parity] tensor-core flash_fwd at {(B * H, S, hd)} "
                  f"bf16 causal, |o - o_plain| over all entries: max "
                  f"{err[0]:.3e}, median {err[1]:.3e}, mean {err[2]:.3e}; "
                  f"against the plain version with p rounded to bf16: max "
                  f"{err[3]:.3e}")
        elif key[0] == "rmsnorm":
            print(f"[lm-parity] {' '.join(map(str, key))}: max abs err "
                  f"{err:.3e}")
        elif key[0] == "flash":
            print(f"[lm-parity] {' '.join(map(str, key))}: max abs err "
                  f"{err[0]:.3e} ({err[1]:.3f}x tolerance)")
        else:
            (eo, ro), (el, rl) = err
            print(f"[lm-parity] wrong flash at {(B * H, S, hd)} bf16 causal"
                  f", {key[1]}: o {eo:.3e} ({ro:.3f}x tolerance), lse "
                  f"{el:.3e} ({rl:.3f}x tolerance)")
    if failures:
        return None

    # ---- b. prefill -------------------------------------------------------
    t0 = time.perf_counter()
    params = init_params(gen, cfg, device=dev)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in leaves(params))
    # param_count leaves out the norms' scale vectors
    n_norm = cfg.n_layers * (2 * D + (2 * hd if cfg.qk_norm else 0)) + D
    print(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {D}, {H} heads "
          f"({cfg.n_kv_heads} kv) x {hd}, d_ff {cfg.d_ff}, vocab {V}; "
          f"{n_par} f32 params ({n_par * 4 / 1e9:.2f} GB: param_count "
          f"{cfg.param_count()} + {n_norm} norm scales) drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    if n_par != cfg.param_count() + n_norm:
        failures.append(f"{n_par} params, not param_count "
                        f"{cfg.param_count()} + {n_norm} norm scales")
    tokens = torch.randint(0, V, (B, S), generator=gen, device=dev)
    logits = forward(params, cfg, tokens)           # warm-up (cuBLAS init)
    del logits
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    logits = forward(params, cfg, tokens)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    prefill_counts = counts()
    peak = torch.cuda.max_memory_allocated() - base
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        forward(params, cfg, tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t_best = min([t_prefill] + times)
    finite = bool(torch.isfinite(logits).all())
    print(f"[lm-prefill] forward B={B} S={S} bf16 flash: {t_prefill * 1e3:.1f}"
          f" ms (then {', '.join(f'{t * 1e3:.1f}' for t in times)} ms; best "
          f"{B * S / t_best:.0f} tokens/s); logits {tuple(logits.shape)} "
          f"{logits.dtype}, finite={finite}; device memory peak "
          f"{peak / mib:.0f} MiB above the {base / mib:.0f} MiB allocated "
          f"before it (the params and what earlier phases hold)")
    want_prefill = {"rmsnorm": lm_norms(cfg), "flash_fwd": 0,
                    "flash_fwd_wgmma": cfg.n_layers}
    print(f"[lm-prefill] launches in the forward: {prefill_counts} "
          f"(expected {want_prefill}: the bf16 hd-{hd} path takes the "
          f"tensor-core forward)")
    if not (finite and logits.shape == (B, S, V)):
        failures.append("prefill logits not finite or misshapen")
    if prefill_counts != want_prefill:
        failures.append(f"prefill launches {prefill_counts}")
    naive = dataclasses.replace(cfg, attn_impl="naive")
    e_naive = rel_fro(logits, forward(params, naive, tokens))
    torch.cuda.synchronize()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    reset()
    l32 = forward(params, cfg32, tokens)
    torch.cuda.synchronize()
    f32_counts = counts()
    want_f32 = {"rmsnorm": lm_norms(cfg), "flash_fwd": cfg.n_layers,
                "flash_fwd_wgmma": 0}
    print(f"[lm-prefill] launches in the f32 forward: {f32_counts} "
          f"(expected {want_f32}: f32 takes the FP32-FMA forward)")
    if f32_counts != want_f32:
        failures.append(f"f32 prefill launches {f32_counts}")
    e32 = rel_fro(l32, forward(params, dataclasses.replace(
        cfg32, attn_impl="naive"), tokens))
    # the same f32 forward with attention's products in TF32 (a wrong
    # attention kernel of the kind the f32 bound must catch)
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn
    sdpa_flash = ops.sdpa_flash

    def tf32_attention(q, k, v, causal=True):
        mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                          device=q.device).tril()
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return attn._sdpa(q, k, v, mask, q.dtype)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    ops.sdpa_flash = tf32_attention
    try:
        e_tf32 = rel_fro(forward(params, cfg32, tokens), l32)
    finally:
        ops.sdpa_flash = sdpa_flash
    del l32
    print(f"[lm-prefill] flash vs naive attention, same weights and tokens,"
          f" ||a - b||_F / ||b||_F: bf16 {e_naive:.3e} (bound "
          f"{TOL_LM_BF16}), f32 {e32:.3e} (bound {TOL_LM_F32}); f32 with "
          f"TF32 attention products vs f32 flash {e_tf32:.3e}")
    if not e_naive <= TOL_LM_BF16:
        failures.append(f"bf16 prefill flash vs naive {e_naive:.3e}")
    if not e32 <= TOL_LM_F32:
        failures.append(f"f32 prefill flash vs naive {e32:.3e}")
    if not e_tf32 > TOL_LM_F32:
        failures.append(f"f32 bound {TOL_LM_F32} passes TF32 attention "
                        f"({e_tf32:.3e})")

    # ---- c. decode against prefill ----------------------------------------
    P = LM_DECODE_PROMPT
    prompt = tokens[:, :P].contiguous()
    ref = logits[:, :P].clone()
    del logits
    state = init_decode_state(cfg, B, P, device=dev)
    outs = []
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    for t in range(P):
        step_logits, state = decode_step(params, cfg, state,
                                         prompt[:, t:t + 1])
        outs.append(step_logits)
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t0) / P
    decode_counts = counts()
    got = torch.stack(outs, 1)
    e_dec = rel_fro(got, ref)
    top1 = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    print(f"[lm-decode] {P} teacher-forced decode steps (B={B}): "
          f"{t_dec * 1e3:.2f} ms a step; vs prefill logits ||a - b||_F / "
          f"||b||_F {e_dec:.3e} (bound {TOL_LM_BF16}), top-1 agreement "
          f"{top1:.4f}; launches rmsnorm {decode_counts['rmsnorm']} "
          f"(expected {P * lm_norms(cfg)}), flash_fwd "
          f"{decode_counts['flash_fwd']}")
    if not (e_dec <= TOL_LM_BF16 and bool(torch.isfinite(got).all())):
        failures.append(f"decode vs prefill {e_dec:.3e}")
    if decode_counts["rmsnorm"] != P * lm_norms(cfg):
        failures.append(f"decode launches {decode_counts}")
    del got, outs, ref, state

    # ---- d. serving -------------------------------------------------------
    lens = torch.randint(8, 17, (LM_REQUESTS,), generator=gen,
                         device=dev).tolist()
    reqs = [Request(rid=i, prompt=torch.randint(
        0, V, (n,), generator=gen, device=dev).tolist(),
        max_new_tokens=LM_NEW_TOKENS) for i, n in enumerate(lens)]
    eng = ServingEngine(params, cfg, n_slots=4, max_seq=LM_MAX_SEQ)
    arrivals = {0: reqs[:4], 8: reqs[4:6], 40: reqs[6:]}  # some mid-flight
    torch.cuda.synchronize()
    reset()
    steps = 0
    t0 = time.perf_counter()
    while steps < 2000:
        for r in arrivals.get(steps, []):
            eng.submit(r)
        if steps > max(arrivals) and not eng.pending and \
                all(s is None for s in eng.slots):
            break
        eng.step()
        steps += 1
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    serve_counts = counts()
    n_gen = sum(len(r.generated) for r in reqs)
    ok = all(r.done and len(r.generated) == LM_NEW_TOKENS
             and all(0 <= t < V for t in r.generated) for r in reqs)
    print(f"[lm-serve] ServingEngine(n_slots=4, max_seq={LM_MAX_SEQ}): "
          f"{LM_REQUESTS} requests, prompts {lens} tokens, "
          f"{LM_NEW_TOKENS} new each; {steps} steps in {t_serve:.2f} s, "
          f"mean decode step {t_serve / steps * 1e3:.2f} ms, {n_gen} "
          f"generated tokens, {n_gen / t_serve:.1f} generated tokens/s; "
          f"all finished: {ok}; launches rmsnorm {serve_counts['rmsnorm']} "
          f"(expected {steps * lm_norms(cfg)})")
    if not ok:
        failures.append("the engine did not answer every request")
    if serve_counts["rmsnorm"] != steps * lm_norms(cfg):
        failures.append(f"serving launches {serve_counts}")
    agree = checked = 0
    for r in reqs:
        alone, _ = greedy_generate(params, cfg, init_decode_state(
            cfg, 1, LM_MAX_SEQ, device=dev), torch.tensor(
            [r.prompt], device=dev), LM_NEW_TOKENS)
        alone = alone[0].tolist()
        checked += len(alone)
        for t, (a, b) in enumerate(zip(r.generated, alone)):
            if a == b:
                agree += 1
                continue
            # later tokens follow different contexts.  The isolated run's
            # logits where they part (the same batch-1 computation,
            # teacher-forced), for its top-1 / top-2 margin
            st = init_decode_state(cfg, 1, LM_MAX_SEQ, device=dev)
            for x in r.prompt + alone[:t]:
                lg, st = decode_step(params, cfg, st,
                                     torch.tensor([[x]], device=dev))
            top2 = lg[0].topk(2).values
            margin = float(top2[0] - top2[1]) / max(1.0,
                                                    abs(float(top2[0])))
            if margin > TOL_LM_BF16:
                failures.append(f"request {r.rid}: token {t} differs "
                                f"from the isolated run ({a} vs {b}) "
                                f"at a margin {margin:.3e}")
            break
    print(f"[lm-serve] agreement with each request decoded alone by "
          f"greedy_generate: {agree} of {checked} tokens agree up to each "
          f"request's first difference (a difference is allowed only where"
          f" the isolated top-1/top-2 logit margin is at most {TOL_LM_BF16}"
          f" of max(1, |top-1|))")

    # where the time goes: device-busy time against the unprofiled wall
    st = init_decode_state(cfg, B, LM_MAX_SEQ, device=dev)
    tok1 = tokens[:, :1].contiguous()

    def one_step():
        nonlocal st
        st = decode_step(params, cfg, st, tok1)[1]

    one_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LM_PROFILE_STEPS):
        one_step()
    torch.cuda.synchronize()
    t_step = (time.perf_counter() - t0) / LM_PROFILE_STEPS
    prefill_kernels = profiled_kernels(lambda: forward(params, cfg, tokens),
                                       1)
    for label, kernels, calls, wall in (
            ("prefill forward", prefill_kernels, 1, t_best),
            (f"decode step (B={B}, cache {LM_MAX_SEQ})",
             profiled_kernels(one_step, LM_PROFILE_STEPS), LM_PROFILE_STEPS,
             t_step)):
        busy, launches, top = profile_summary(kernels, calls)
        if busy is None:
            print(f"[lm-profile] {label}: wall {wall * 1e3:.2f} ms; device "
                  f"time not measured (the profiler recorded none)")
            continue
        print(f"[lm-profile] {label}: wall {wall * 1e3:.2f} ms, device busy "
              f"{busy:.2f} ms (idle share {1 - busy / (wall * 1e3):.1%}) in "
              f"{launches:g} kernel launches")
        for name, ms, n in top:
            print(f"[lm-profile]   {ms:8.3f} ms  x{n:g}  {name}")
    rms_prof = kernel_device_ms(prefill_kernels, "rmsnorm")
    print(f"[lm-profile] rmsnorm kernels in one profiled prefill: "
          + ("not measured (the profiler recorded none)"
             if rms_prof[0] is None else
             f"{rms_prof[0]:.4f} ms a launch over {rms_prof[1]} launches"))
    del eng, params, tokens, st
    torch.cuda.empty_cache()
    if failures:
        return None

    # ---- e. times against bounds, plain versions and library calls -------
    x = torch.randn((B * S, D), generator=gen, device=dev).to(bf16)
    scale = torch.randn((D,), generator=gen, device=dev)
    xq = torch.randn((B * S * H, hd), generator=gen, device=dev).to(bf16)
    sq = torch.randn((hd,), generator=gen, device=dev)
    rows = {}
    for label, xx, ss in (("rows", x, scale), ("qk", xq, sq)):
        kernel = lambda: rmsnorm_cuda(xx, ss)  # noqa: E731
        s16 = ss.to(xx.dtype)
        lib_call = lambda: F.rms_norm(  # noqa: E731
            xx, (xx.shape[-1],), s16, 1e-6)
        ms, eager = time_queued(kernel, 50), time_cuda(kernel, 50)
        plain = time_queued(lambda: rmsnorm_plain(xx, ss), 20)
        lib, lib_eager = time_queued(lib_call, 50), time_cuda(lib_call, 50)
        nbytes = 2 * xx.numel() * xx.element_size() + ss.numel() * 4
        b_ms, b_by = bound_ms(nbytes, 4 * xx.numel(), BF16_FLOP_PER_S)
        rows[label] = (ms, plain, lib, b_ms, b_by, eager, lib_eager)
        print(f"[lm-time] rmsnorm {tuple(xx.shape)} bf16, queued (eager): "
              f"{ms:.4f} ({eager:.4f}) ms | plain {plain:.4f} ms | "
              f"F.rms_norm {lib:.4f} ({lib_eager:.4f}) ms | bound "
              f"{b_ms:.4f} ms ({b_by}, {b_ms / ms:.1%} of it)")
    del x, xq
    # the tensor-core forward (the path's) and the FP32-FMA one launched at
    # the same bf16 shapes, against the plain version and SDPA: at the
    # prefill's (64, 2048, 128) and the training microbatch's (32, ...)
    fma = build.launcher("flash_fwd")
    stream = torch.cuda.current_stream().cuda_stream
    pairs = S * (S + 1) // 2                   # causal (row, col) pairs
    f_times = {}
    for nb in (B, B // 2):
        q4, k4, v4 = (torch.randn((nb, H, S, hd), generator=gen, device=dev)
                      .to(bf16) for _ in range(3))
        q3, k3, v3 = (t.reshape(nb * H, S, hd) for t in (q4, k4, v4))
        o3 = torch.empty_like(q3)
        lse3 = torch.empty((nb * H, S), device=dev)
        ms = time_cuda(lambda: flash_fwd_cuda(q3, k3, v3, causal=True), 50)
        ms_fma = time_cuda(lambda: fma(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o3.data_ptr(),
            lse3.data_ptr(), nb * H, S, S, hd, hd, DTYPE_CODES[bf16], 1,
            float(hd ** -0.5), stream), 10)
        plain = time_cuda(lambda: flash_fwd_plain(q3, k3, v3, causal=True),
                          5)
        lib = time_cuda(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), 50)
        flops = 4 * nb * H * hd * pairs
        nbytes = 4 * nb * H * S * hd * 2 + nb * H * S * 4
        b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
        f_times[nb * H] = (ms, ms_fma, plain, lib, b_ms, b_by)
        print(f"[lm-time] flash_fwd (BH, S, hd) = ({nb * H}, {S}, {hd}) bf16"
              f" causal: tensor-core {ms:.4f} ms ({flops / ms / 1e9:.1f} "
              f"TFLOP/s) | FP32-FMA {ms_fma:.4f} ms "
              f"({flops / ms_fma / 1e9:.1f} TFLOP/s) | plain {plain:.4f} ms | "
              f"scaled_dot_product_attention {lib:.4f} ms | bound "
              f"{b_ms:.4f} ms ({b_by} at the bf16 tensor-core rate; "
              f"tensor-core {b_ms / ms:.1%}, FP32-FMA {b_ms / ms_fma:.1%} "
              f"of it)")
        del q4, k4, v4, q3, k3, v3, o3, lse3
    print(f"[lm] phase 7 launches: prefill forward {prefill_counts}, f32 "
          f"forward {f32_counts}, {P} decode steps {decode_counts}, {steps}"
          f" engine steps {serve_counts}")
    torch.cuda.empty_cache()
    r, rq = rows["rows"], rows["qk"]
    ms, ms_fma, plain, lib, b_ms, b_by = f_times[B * H]
    shape = f"(BH, S, T, hd) = ({B * H}, {S}, {S}, {hd}) bf16 causal"
    return [
        {"name": "rmsnorm", "route": "cuda",
         "source": "src/repro_torch/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:34",
         "shape": f"x ({B * S}, {D}) bf16, scale ({D},) f32",
         "launches": prefill_counts["rmsnorm"],
         "max_abs_err": err_at[("rmsnorm", B * S, D, str(bf16))],
         "ms": r[0], "plain_ms": r[1], "bound_ms": r[3], "bound_by": r[4],
         "library_ms": r[2], "decode_launches": decode_counts["rmsnorm"],
         "serving_launches": serve_counts["rmsnorm"],
         "ms_timing": "device time, launches queued behind a spin kernel "
                      "(time_queued); eager_ms: back to back, host "
                      "included (time_cuda); profiled_ms: torch.profiler "
                      "over one prefill",
         "eager_ms": r[5], "library_eager_ms": r[6],
         "profiled_ms": rms_prof[0], "ms_qk": rq[0], "eager_ms_qk": rq[5],
         "library_ms_qk": rq[2], "bound_ms_qk": rq[3]},
        {"name": "flash_fwd_wgmma", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_fwd_wgmma.cu",
         "replaces": "src/repro/kernels/flash_attention.py:95",
         "shape": shape, "launches": prefill_counts["flash_fwd_wgmma"],
         "max_abs_err": err_at["flash-path"][0],
         "median_abs_err": err_at["flash-path"][1],
         "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
         "library_ms": lib, "ms_bh32": f_times[B // 2 * H][0],
         "library_ms_bh32": f_times[B // 2 * H][3]},
        {"name": "flash_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_fwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:81",
         "shape": shape + " (timed); launches from the f32 prefill",
         "launches": f32_counts["flash_fwd"],
         "max_abs_err": err_at[("flash", B * H, S, S, hd, hd, "float32",
                                True, "fma", "o")][0],
         "ms": ms_fma, "plain_ms": plain, "bound_ms": b_ms,
         "bound_by": b_by, "library_ms": lib,
         "ms_bh32": f_times[B // 2 * H][1]},
    ]


def flash_bwd_variant(q, k, v, do, lse, delta, skip):
    """The plain backward with keys ``skip = (lo, hi)`` left out of dq for
    every row at or past ``hi`` (a causal k tile the dq kernel skipped);
    dk and dv as the plain version computes them (phase 8a's wrong
    variant)."""
    import torch
    from repro_torch.kernels.flash_attention import flash_bwd_plain
    from repro_torch.kernels.ref import attention_scores
    dq, dk, dv = flash_bwd_plain(q, k, v, do, lse, delta, causal=True)
    scale = q.shape[-1] ** -0.5
    p = torch.exp(attention_scores(q, k, True) - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * scale
    lo, hi = skip
    ds[:, hi:, lo:hi] = 0.0
    return torch.einsum("bqk,bkd->bqd", ds, k.float()).to(q.dtype), dk, dv


def train_phase(dev, args, failures):
    """Phase 8 (module docstring): LM training at full Qwen3-1.7B width.
    Returns the flash_bwd entries (dq and dkv, tensor-core and FP32-FMA)
    of the kernels record and the training run's launch counts."""
    import dataclasses
    import statistics
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import build, ops
    from repro_torch.kernels._launch import DTYPE_CODES
    from repro_torch.kernels.flash_attention import (flash_bwd_cuda,
                                                     flash_bwd_plain,
                                                     flash_delta,
                                                     flash_fwd_cuda,
                                                     flash_route)
    from repro_torch.kernels.ref import (flash_dkv_bf16_tolerance,
                                         flash_dq_bf16_tolerance,
                                         rmsnorm_ref)
    from repro_torch.kernels.rmsnorm import RMSNorm, rmsnorm_cuda
    from repro_torch.models import attention as attn
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw_init, schedule
    from repro_torch.train import (TrainConfig, loss_and_grads,
                                   make_train_step)
    from repro_torch.tree import leaves_with_paths

    f32, bf16 = torch.float32, torch.bfloat16
    cfg = dataclasses.replace(get_config("qwen3_1p7b"), attn_impl="flash",
                              remat="full")
    B, S, H, hd = LM_TRAIN_BATCH, LM_SEQ, cfg.n_heads, cfg.head_dim
    BH = B // LM_MICROBATCHES * H          # one microbatch's attention
    D, V = cfg.d_model, cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    gib = 2.0 ** 30

    def counts():
        return {"rmsnorm": rmsnorm_cuda.launches,
                "flash_fwd": flash_fwd_cuda.launches,
                "flash_fwd_wgmma": flash_fwd_cuda.launches_wgmma,
                "flash_bwd_dq": flash_bwd_cuda.launches_dq,
                "flash_bwd_dq_wgmma": flash_bwd_cuda.launches_dq_wgmma,
                "flash_bwd_dkv": flash_bwd_cuda.launches_dkv,
                "flash_bwd_dkv_wgmma": flash_bwd_cuda.launches_dkv_wgmma}

    def reset():
        rmsnorm_cuda.launches = flash_fwd_cuda.launches = 0
        flash_fwd_cuda.launches_wgmma = 0
        flash_bwd_cuda.launches_dq = flash_bwd_cuda.launches_dkv = 0
        flash_bwd_cuda.launches_dq_wgmma = 0
        flash_bwd_cuda.launches_dkv_wgmma = 0

    # ---- a. parity of the backward kernels with their plain version ------
    def bwd_inputs(BHx, s_q, s_k, d_qk, d_v, dt, causal):
        q = torch.randn((BHx, s_q, d_qk), generator=gen, device=dev).to(dt)
        k = torch.randn((BHx, s_k, d_qk), generator=gen, device=dev).to(dt)
        v = torch.randn((BHx, s_k, d_v), generator=gen, device=dev).to(dt)
        do = torch.randn((BHx, s_q, d_v), generator=gen, device=dev).to(dt)
        o, lse = flash_fwd_cuda(q, k, v, causal=causal)
        return q, k, v, do, lse, flash_delta(o, do)

    def bwd_err(got, want, dt, tols=(None, None, None)):
        """[(max abs err, max err / tolerance, entries that differ)] of
        dq, dk, dv; ``tols`` holds elementwise bounds where a route has
        them (the tensor-core kernels' derived bf16 bounds)."""
        rtol, atol = ((TOL_FLASH_BF16_R, TOL_FLASH_BF16_A) if dt == bf16
                      else (TOL_FLASH_BWD_F32_R, TOL_FLASH_BWD_F32_A))
        out = []
        for a, b, t in zip(got, want, tols):
            e = (a.double() - b.double()).abs()
            t = atol + rtol * b.double().abs() if t is None else t.double()
            out.append((float(e.max()), float((e / t).max()),
                        int((a != b).sum())))
        return out

    def bwd_tols(args_b, want, causal, dt):
        """The bounds on (dq, dk, dv) of the route a case takes."""
        q, k, v = args_b[:3]
        if flash_route(dt, q.shape[2], v.shape[2]) == "fma":
            return (None, None, None)
        return (flash_dq_bf16_tolerance(*args_b, want[0], causal),
                *flash_dkv_bf16_tolerance(*args_b, want[1], want[2], causal))

    err_at = {}
    # the tensor-core dq and dkv (bf16, hd = hdv in {64, 128}) at the
    # path's shape, hd 64 and ragged S and T; the FP32-FMA ones (f32, hd
    # != hdv, hd 96)
    cases = [((BH, S, S, hd, hd), bf16, True),
             ((8, 512, 512, 64, 64), bf16, True),
             ((8, 200, 136, hd, hd), bf16, False),
             ((8, 136, 200, hd, hd), bf16, True),
             ((BH, S, S, hd, hd), f32, True),
             ((8, 512, 512, hd, 64), f32, False),
             ((8, 200, 136, 64, hd), f32, False),
             ((8, 200, 200, 96, 96), bf16, True)]
    for shape, dt, causal in cases:
        args_b = bwd_inputs(*shape, dt, causal)
        route = flash_route(dt, shape[3], shape[4])
        before = counts()
        got = flash_bwd_cuda(*args_b, causal=causal)
        moved = {n: c - before[n] for n, c in counts().items()}
        tail = "_wgmma" if route == "wgmma" else ""
        dq_name, dkv_name = f"flash_bwd_dq{tail}", f"flash_bwd_dkv{tail}"
        if not (moved[dq_name] == moved[dkv_name] == 1
                and sum(moved.values()) == 2):
            failures.append(f"flash_bwd {shape} {dt}: launches {moved}, "
                            f"expected one {dq_name} and one {dkv_name}")
        want = flash_bwd_plain(*args_b, causal=causal)
        reads = bwd_err(got, want, dt, bwd_tols(args_b, want, causal, dt))
        err_at[(shape, str(dt)[6:], causal, route)] = reads
        for name, (err, ratio, _), a, ref in zip(("dq", "dk", "dv"), reads,
                                                 got, args_b[:3]):
            if not (ratio <= 1.0 and a.shape == ref.shape
                    and a.dtype == dt):
                failures.append(f"flash_bwd {shape} {dt} causal={causal} "
                                f"{name}: max abs err {err:.3e} "
                                f"({ratio:.2f}x tolerance)")
        if route == "wgmma":
            # one owner CTA an output, no atomics: the same bits again
            again = flash_bwd_cuda(*args_b, causal=causal)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                failures.append(f"flash_bwd {shape} {dt}: a second call "
                                f"gave other bits")
            del again
    del got, want, args_b
    # what the check reads for wrong functions at the path's shape (bf16,
    # causal); each must fail it, or it would pass a wrong kernel.  "k rows
    # swapped in pairs" is the fault a wrong descriptor would make inside a
    # tile of the tensor-core kernels.
    q, k, v, do, lse, delta = bwd_inputs(BH, S, S, hd, hd, bf16, True)
    want = flash_bwd_plain(q, k, v, do, lse, delta, causal=True)
    tols = bwd_tols((q, k, v, do, lse, delta), want, True, bf16)
    wrong = {
        "delta left out": flash_bwd_cuda(q, k, v, do, lse,
                                         torch.zeros_like(delta)),
        "scale x 1.05": flash_bwd_cuda(q, k, v, do, lse, delta, True,
                                       1.05 * hd ** -0.5),
        "k tile 64:128 skipped in dq": flash_bwd_variant(
            q, k, v, do, lse, delta, (64, 128)),
        "lse of the neighbouring row": flash_bwd_cuda(
            q, k, v, do, torch.roll(lse, 1, dims=1), delta),
        "k rows swapped in pairs": flash_bwd_cuda(
            q, swap_pairs(k), v, do, lse, delta)}
    for name, got in wrong.items():
        reads = bwd_err(got, want, bf16, tols)
        err_at[("wrong", name)] = reads
        if max(r for _, r, _ in reads) <= 1.0:
            failures.append(f"flash_bwd check passes a wrong kernel "
                            f"({name})")
    del wrong, got, want, tols
    # the RMSNorm Function on the card against autograd through the oracle
    for rows, d in ((B // LM_MICROBATCHES * S, D),
                    (B // LM_MICROBATCHES * S * H, hd)):
        x = torch.randn((rows, d), generator=gen, device=dev).to(bf16)
        sc = torch.randn((d,), generator=gen, device=dev)
        dy = torch.randn((rows, d), generator=gen, device=dev).to(bf16)
        grads = []
        for fn in (RMSNorm.apply, rmsnorm_ref):
            xl, sl = x.clone().requires_grad_(), sc.clone().requires_grad_()
            fn(xl, sl, 1e-6).backward(dy)
            grads.append((xl.grad, sl.grad))
        (dx, ds), (dx_r, ds_r) = grads
        r_dx, e_dx = allclose_ratio(dx.float(), dx_r.float(), TOL_BF16)
        r_ds, e_ds = allclose_ratio(ds, ds_r, TOL_RMSNORM_DSCALE, True)
        err_at[("rmsnorm-bwd", rows, d)] = (e_dx, r_dx, e_ds, r_ds)
        if not (r_dx <= 1.0 and r_ds <= 1.0 and dx.dtype == bf16):
            failures.append(f"RMSNorm backward ({rows}, {d}): dx {e_dx:.3e}"
                            f" ({r_dx:.2f}x), dscale {e_ds:.3e} "
                            f"({r_ds:.2f}x)")
    del x, dy, grads, dx, ds, dx_r, ds_r
    torch.cuda.synchronize()
    print(f"[train-parity] tolerances: flash_bwd f32 {TOL_FLASH_BWD_F32_R} "
          f"rel / {TOL_FLASH_BWD_F32_A} abs, bf16 FP32-FMA dq, dk, dv "
          f"{TOL_FLASH_BF16_R} / {TOL_FLASH_BF16_A}, tensor-core dq, dk, dv "
          f"the derived bounds (ref.flash_dq_bf16_tolerance, "
          f"ref.flash_dkv_bf16_tolerance); RMSNorm dx {TOL_BF16}, dscale "
          f"{TOL_RMSNORM_DSCALE} of its largest entry")
    for key, reads in err_at.items():
        if key[0] == "rmsnorm-bwd":
            e_dx, r_dx, e_ds, r_ds = reads
            print(f"[train-parity] RMSNorm backward ({key[1]}, {key[2]}) "
                  f"bf16: dx {e_dx:.3e} ({r_dx:.3f}x tolerance), dscale "
                  f"{e_ds:.3e} ({r_ds:.3f}x)")
            continue
        what = (f"wrong flash_bwd at {(BH, S, hd)} bf16 causal, {key[1]}"
                if key[0] == "wrong" else
                f"flash_bwd {key[0]} {key[1]} causal={key[2]} ({key[3]} "
                f"dq, dkv)")
        print(f"[train-parity] {what}: " + ", ".join(
            f"{n} {e:.3e} ({r:.3f}x tolerance, {c} entries differ)"
            for n, (e, r, c) in zip(("dq", "dk", "dv"), reads)))
    if failures:
        return None

    # ---- b. whole-model gradients at full width --------------------------
    t0 = time.perf_counter()
    params = init_params(gen, cfg, device=dev)
    pipe = TokenPipeline(vocab_size=V, seq_len=S, global_batch=B,
                         seed=args.seed)
    one = {k: t[:1].to(dev) for k, t in pipe.batch(10 ** 6).items()}
    names = ["/".join(map(str, p)) for p, _ in leaves_with_paths(params)]
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    naive = dataclasses.replace(cfg, attn_impl="naive")
    naive32 = dataclasses.replace(cfg32, attn_impl="naive")

    def tf32_attention(q, k, v, causal=True):
        mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                          device=q.device).tril()
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return attn._sdpa(q, k, v, mask, q.dtype)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    def leaf_errors(grads, ref):
        return [rel_fro(g, r) for g, r in zip(grads, ref)]

    def check_leaves(grads, what):
        bad = [n for n, g in zip(names, grads)
               if g is None or not bool(torch.isfinite(g).all())
               or not bool(g.abs().max() > 0)]
        if bad:
            failures.append(f"{what}: {len(bad)} leaves without a finite, "
                            f"non-zero gradient: {bad[:6]}")

    _, g_ref = loss_and_grads(params, naive32, one)
    reset()
    loss32, g = loss_and_grads(params, cfg32, one)
    grad_counts = counts()
    check_leaves(g, "f32 flash gradients")
    e32 = leaf_errors(g, g_ref)
    del g
    sdpa_flash = ops.sdpa_flash
    ops.sdpa_flash = tf32_attention
    try:
        _, g = loss_and_grads(params, cfg32, one)
    finally:
        ops.sdpa_flash = sdpa_flash
    e_tf32 = leaf_errors(g, g_ref)
    del g, g_ref
    _, g_ref = loss_and_grads(params, naive, one)
    reset()
    loss16, g = loss_and_grads(params, cfg, one)
    grad_counts16 = counts()
    check_leaves(g, "bf16 flash gradients")
    e16 = leaf_errors(g, g_ref)
    del g, g_ref
    torch.cuda.synchronize()
    worst = {what: max(zip(e, names)) for what, e in
             (("f32", e32), ("tf32", e_tf32), ("bf16", e16))}
    print(f"[train-grad] {cfg.name} at full width, loss_fn on 1 x {S} "
          f"tokens ({time.perf_counter() - t0:.1f} s with init): f32 loss "
          f"{float(loss32):.5f}, bf16 loss {float(loss16):.5f}; launches in"
          f" one f32 backward with remat {grad_counts}, in one bf16 "
          f"{grad_counts16}")
    print(f"[train-grad] per-leaf ||g_flash - g_naive||_F / ||g_naive||_F "
          f"over {len(names)} leaves: f32 median "
          f"{statistics.median(e32):.3e}, worst {worst['f32'][0]:.3e} "
          f"({worst['f32'][1]}; bound {TOL_GRAD_F32}); f32 with TF32 "
          f"attention products: median {statistics.median(e_tf32):.3e}, "
          f"worst {worst['tf32'][0]:.3e} ({worst['tf32'][1]}); bf16 median "
          f"{statistics.median(e16):.3e}, worst {worst['bf16'][0]:.3e} "
          f"({worst['bf16'][1]}; bound {TOL_GRAD_BF16})")
    if not worst["f32"][0] <= TOL_GRAD_F32:
        failures.append(f"f32 gradients flash vs naive {worst['f32']}")
    if not worst["tf32"][0] > TOL_GRAD_F32:
        failures.append(f"f32 gradient bound {TOL_GRAD_F32} passes TF32 "
                        f"attention ({worst['tf32']})")
    if not worst["bf16"][0] <= TOL_GRAD_BF16:
        failures.append(f"bf16 gradients flash vs naive {worst['bf16']}")
    n_layers = cfg.n_layers
    # f32 takes the FP32-FMA kernels, bf16 at hd 128 the tensor-core ones
    want_grad = {"rmsnorm": lm_norms(cfg) + lm_norms(cfg) - 1,
                 "flash_fwd": 2 * n_layers, "flash_fwd_wgmma": 0,
                 "flash_bwd_dq": n_layers, "flash_bwd_dq_wgmma": 0,
                 "flash_bwd_dkv": n_layers, "flash_bwd_dkv_wgmma": 0}
    want_grad16 = dict(want_grad, flash_fwd=0, flash_fwd_wgmma=2 * n_layers,
                       flash_bwd_dq=0, flash_bwd_dq_wgmma=n_layers,
                       flash_bwd_dkv=0, flash_bwd_dkv_wgmma=n_layers)
    for got, want in ((grad_counts, want_grad),
                      (grad_counts16, want_grad16)):
        if got != want:
            failures.append(f"gradient launches {got}, expected {want}")
    del one
    if failures:
        return None

    # ---- c. training steps -----------------------------------------------
    acfg = AdamWConfig(lr=LM_TRAIN_LR, warmup_steps=LM_TRAIN_WARMUP,
                       total_steps=LM_TRAIN_STEPS)
    step_fn = make_train_step(cfg, acfg,
                              TrainConfig(microbatches=LM_MICROBATCHES))
    opt = adamw_init(params)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    per_step = {"rmsnorm": LM_MICROBATCHES * (2 * lm_norms(cfg) - 1),
                "flash_fwd": 0,
                "flash_fwd_wgmma": LM_MICROBATCHES * 2 * n_layers,
                "flash_bwd_dq": 0,
                "flash_bwd_dq_wgmma": LM_MICROBATCHES * n_layers,
                "flash_bwd_dkv": 0,
                "flash_bwd_dkv_wgmma": LM_MICROBATCHES * n_layers}
    rows, times, step_counts = [], [], []
    reset()
    for s in range(LM_TRAIN_STEPS):
        batch = pipe.batch(s)
        before = counts()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        step_counts.append({k: v - before[k] for k, v in counts().items()})
        rows.append({k: float(v) for k, v in m.items()})
    train_counts = counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = B * S
    t_best, t_med = min(times[1:]), statistics.median(times[1:])
    for s, (r, t, c) in enumerate(zip(rows, times, step_counts)):
        print(f"[train] step {s + 1}: loss {r['loss']:.5f}, grad_norm "
              f"{r['grad_norm']:.4f}, lr {r['lr']:.4e} (schedule "
              f"{schedule(acfg, s + 1):.4e}); {t * 1e3:.1f} ms; launches "
              f"{c}")
    print(f"[train] {LM_TRAIN_STEPS} steps of {B} x {S} tokens in "
          f"{LM_MICROBATCHES} microbatches, bf16 flash remat, AdamW lr "
          f"{LM_TRAIN_LR} warmup {LM_TRAIN_WARMUP}: step {t_med * 1e3:.1f} "
          f"ms median of steps 2-{LM_TRAIN_STEPS} (best {t_best * 1e3:.1f}, "
          f"first {times[0] * 1e3:.1f}); {tokens / t_med:.0f} training "
          f"tokens/s (best {tokens / t_best:.0f}); device memory peak "
          f"{peak / gib:.2f} GiB, {(peak - base) / gib:.2f} GiB above the "
          f"{base / gib:.2f} GiB of params and AdamW state")
    losses = [r["loss"] for r in rows]
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        failures.append(f"training loss not finite or not falling: "
                        f"{losses}")
    for s, r in enumerate(rows):
        if not (math.isfinite(r["grad_norm"]) and math.isfinite(r["lr"])
                and abs(r["lr"] - schedule(acfg, s + 1))
                <= 1e-6 * abs(schedule(acfg, s + 1))):
            failures.append(f"step {s + 1}: grad_norm {r['grad_norm']}, lr "
                            f"{r['lr']} (schedule {schedule(acfg, s + 1)})")
    for s, c in enumerate(step_counts):
        if c != per_step:
            failures.append(f"step {s + 1} launches {c}, expected "
                            f"{per_step}")

    # where the time goes: one more step under the profiler
    def one_step():
        nonlocal params, opt
        params, opt, _ = step_fn(params, opt, pipe.batch(LM_TRAIN_STEPS))

    busy, launches, top = device_profile(one_step, 1)
    if busy is None:
        print(f"[train-profile] step: wall {t_med * 1e3:.1f} ms; device time "
              f"not measured (the profiler recorded none)")
    else:
        print(f"[train-profile] step: wall {t_med * 1e3:.1f} ms (median, "
              f"unprofiled), device busy {busy:.1f} ms (idle share "
              f"{1 - busy / (t_med * 1e3):.1%}) in {launches:g} kernel "
              f"launches")
        for name, ms, n in top:
            print(f"[train-profile]   {ms:8.3f} ms  x{n:g}  {name}")
    del params, opt, step_fn
    torch.cuda.empty_cache()
    if failures:
        return None

    # ---- d. backward kernel times ----------------------------------------
    q, k, v, do, lse, delta = bwd_inputs(BH, S, S, hd, hd, bf16, True)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    launch = build.launcher("flash_bwd")
    launch_w = build.launcher("flash_bwd_dkv_wgmma")
    launch_qw = build.launcher("flash_bwd_dq_wgmma")
    stream = torch.cuda.current_stream().cuda_stream
    raw = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
           dv.data_ptr(), BH, S, S, hd, hd, DTYPE_CODES[bf16], 1,
           float(hd ** -0.5))
    raw_w = raw[:6] + (dk.data_ptr(), dv.data_ptr(), BH, S, S, hd, 1,
                       float(hd ** -0.5), stream)
    raw_qw = raw[:7] + (BH, S, S, hd, 1, float(hd ** -0.5), stream)
    # every kernel through its C entry point at the path's bf16 shape:
    # the tensor-core dq and dkv the path takes, and the FP32-FMA ones
    runs = {"dq": lambda: launch(*raw, 0, stream),
            "dkv": lambda: launch(*raw, 1, stream),
            "dq_wgmma": lambda: launch_qw(*raw_qw),
            "dkv_wgmma": lambda: launch_w(*raw_w)}
    for w, run in runs.items():
        if run() != 0:
            failures.append(f"flash_bwd_{w} launch failed")
            return None
    ms = {w: time_cuda(run, 50 if w.endswith("wgmma") else 10)
          for w, run in runs.items()}
    both = time_cuda(lambda: flash_bwd_cuda(q, k, v, do, lse, delta), 10)
    plain = time_cuda(lambda: flash_bwd_plain(q, k, v, do, lse, delta), 5)
    q4, k4, v4, do4 = (t.reshape(B // LM_MICROBATCHES, H, S, hd)
                       for t in (q, k, v, do))
    leaves4 = [t.detach().clone().requires_grad_() for t in (q4, k4, v4)]

    def sdpa_fwd():
        return F.scaled_dot_product_attention(*leaves4, is_causal=True)

    def sdpa_fwd_bwd():
        sdpa_fwd().backward(do4)

    lib = time_cuda(sdpa_fwd_bwd, 20) - time_cuda(sdpa_fwd, 20)
    pairs = S * (S + 1) // 2                   # causal (row, col) pairs
    product = 2 * BH * pairs * hd              # one of the five products
    in_bytes = 4 * BH * S * hd * 2 + 2 * BH * S * 4
    out_bytes = {"dq": BH * S * hd * 2, "dkv": 2 * BH * S * hd * 2}
    n_products = {"dq": 3, "dkv": 4}
    bounds = {w: bound_ms(in_bytes + out_bytes[w], n_products[w] * product,
                          BF16_FLOP_PER_S) for w in ("dq", "dkv")}
    for w in ("dq", "dkv"):
        bounds[f"{w}_wgmma"] = bounds[w]
        n_products[f"{w}_wgmma"] = n_products[w]
    b_all = bound_ms(in_bytes + out_bytes["dq"] + out_bytes["dkv"],
                     5 * product, BF16_FLOP_PER_S)
    for w, label in (("dq", "FP32-FMA"), ("dkv", "FP32-FMA"),
                     ("dq_wgmma", "tensor-core"),
                     ("dkv_wgmma", "tensor-core")):
        flops = n_products[w] * product
        print(f"[train-time] flash_bwd_{w} ({label}) (BH, S, hd) = ({BH}, "
              f"{S}, {hd}) bf16 causal: {ms[w]:.4f} ms "
              f"({flops / ms[w] / 1e9:.1f} TFLOP/s in its {n_products[w]} "
              f"products) | bound "
              f"{bounds[w][0]:.4f} ms ({bounds[w][1]}; operations at the "
              f"bf16 tensor-core rate; {bounds[w][0] / ms[w]:.1%} of it)")
    print(f"[train-time] flash_bwd (tensor-core dq + dkv through the "
          f"wrapper): {both:.4f} ms | plain (dq, dk, dv) {plain:.4f} ms | "
          f"backward of scaled_dot_product_attention(is_causal=True) "
          f"{lib:.4f} ms | bound of the five products {b_all[0]:.4f} ms "
          f"({b_all[1]}); {5 * product / 1e9:.1f} GFLOP, "
          f"{(in_bytes + out_bytes['dq'] + out_bytes['dkv']) / 1e6:.1f} MB")
    print(f"[train] phase 8 launches over {LM_TRAIN_STEPS} steps: "
          f"{train_counts}; in the f32 gradient of 8b {grad_counts}")
    del q, k, v, do, lse, delta, dq, dk, dv, q4, k4, v4, do4, leaves4
    torch.cuda.empty_cache()
    path = err_at[((BH, S, S, hd, hd), "bfloat16", True, "wgmma")]
    path32 = err_at[((BH, S, S, hd, hd), "float32", True, "fma")]
    shape = f"(BH, S, T, hd) = ({BH}, {S}, {S}, {hd}) bf16 causal"
    entry = {"route": "cuda", "plain_ms": plain, "library_ms": lib}
    entries = [
        dict(entry, name="flash_bwd_dq_wgmma",
             source="src/repro_torch/csrc/flash_bwd_dq_wgmma.cu",
             replaces="src/repro/kernels/flash_attention.py:220",
             shape=shape, launches=train_counts["flash_bwd_dq_wgmma"],
             max_abs_err=path[0][0], ms=ms["dq_wgmma"],
             bound_ms=bounds["dq"][0], bound_by=bounds["dq"][1]),
        dict(entry, name="flash_bwd_dq",
             source="src/repro_torch/csrc/flash_bwd.cu",
             replaces="src/repro/kernels/flash_attention.py:220",
             shape=shape + " (timed); launches from the f32 gradient of 8b",
             launches=grad_counts["flash_bwd_dq"], max_abs_err=path32[0][0],
             ms=ms["dq"], bound_ms=bounds["dq"][0],
             bound_by=bounds["dq"][1]),
        dict(entry, name="flash_bwd_dkv_wgmma",
             source="src/repro_torch/csrc/flash_bwd_wgmma.cu",
             replaces="src/repro/kernels/flash_attention.py:240",
             shape=shape, launches=train_counts["flash_bwd_dkv_wgmma"],
             max_abs_err=max(path[1][0], path[2][0]), ms=ms["dkv_wgmma"],
             bound_ms=bounds["dkv"][0], bound_by=bounds["dkv"][1]),
        dict(entry, name="flash_bwd_dkv",
             source="src/repro_torch/csrc/flash_bwd.cu",
             replaces="src/repro/kernels/flash_attention.py:240",
             shape=shape + " (timed); launches from the f32 gradient of 8b",
             launches=grad_counts["flash_bwd_dkv"],
             max_abs_err=max(path32[1][0], path32[2][0]), ms=ms["dkv"],
             bound_ms=bounds["dkv"][0], bound_by=bounds["dkv"][1]),
    ]
    return entries, train_counts


def moe_phase(dev, args, failures):
    """Phase 14 (module docstring): the MoE family on the card,
    DeepSeek-V2-Lite at full width.  Returns the rmsnorm entries of the
    kernels record, one for each shape the phase launched it at."""
    import dataclasses
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import rmsnorm as rmsnorm_module
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.models import (decode_step, forward, init_decode_state,
                                    init_params)
    from repro_torch.models import lm as lm_module
    from repro_torch.models import moe as moe_module
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import (Request, ServingEngine, TrainConfig,
                                   greedy_generate, loss_and_grads,
                                   make_train_step)
    from repro_torch.tree import leaves, leaves_with_paths

    t_phase = time.perf_counter()
    laps = [t_phase]

    def lap(what):
        laps.append(time.perf_counter())
        print(f"[moe] {what} took {laps[-1] - laps[-2]:.1f} s")

    cfg = get_config("deepseek_v2_lite_16b")
    B, S, D, V = MOE_BATCH, MOE_SEQ, cfg.d_model, cfg.vocab_size
    norms = lm_norms(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 14)
    gb = 1e9
    torch.cuda.empty_cache()
    rmsnorm_cuda.by_shape = {}

    # ---- a. serving at full width and full depth -------------------------
    t0 = time.perf_counter()
    params = init_params(gen, cfg, device=dev)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in leaves(params))
    # param_count leaves out the norms' scale vectors (kv_norm's too)
    n_norm = cfg.n_layers * (2 * D + cfg.kv_lora_rank) + D
    p_bytes = torch.cuda.memory_allocated()
    print(f"[moe] {cfg.name}: {cfg.n_layers} layers, d_model {D}, "
          f"{cfg.n_heads} heads, MLA r {cfg.kv_lora_rank} + rope "
          f"{cfg.qk_rope_head_dim}, {cfg.n_experts} experts top-{cfg.top_k}"
          f" + {cfg.n_shared_experts} shared x {cfg.moe_ff}, vocab {V}, "
          f"moe_impl {cfg.moe_impl}: {n_par} f32 params "
          f"({n_par * 4 / gb:.2f} GB: param_count {cfg.param_count()} + "
          f"{n_norm} norm scales) drawn in {time.perf_counter() - t0:.1f} s;"
          f" {p_bytes / gb:.2f} GB allocated")
    if n_par != cfg.param_count() + n_norm:
        failures.append(f"{n_par} params, not param_count "
                        f"{cfg.param_count()} + {n_norm} norm scales")
    tokens = torch.randint(0, V, (B, S), generator=gen, device=dev)
    forward(params, cfg, tokens)                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rmsnorm_cuda.launches = 0
    t0 = time.perf_counter()
    logits = forward(params, cfg, tokens)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    n_prefill = rmsnorm_cuda.launches
    ok = bool(torch.isfinite(logits).all()) and logits.shape == (B, S, V)
    del logits
    t0 = time.perf_counter()
    busy, n_k, top = device_profile(lambda: forward(params, cfg, tokens), 1)
    print(f"[moe-prefill] the profiled forward took "
          f"{time.perf_counter() - t0:.1f} s")
    idle = ("not measured" if busy is None
            else f"{1 - busy / (t_prefill * 1e3):.1%}")
    print(f"[moe-prefill] forward B={B} S={S} bf16: {t_prefill * 1e3:.1f} "
          f"ms, {B * S / t_prefill:.0f} tokens/s; device busy "
          f"{'not measured' if busy is None else f'{busy:.2f} ms'}, idle "
          f"share {idle}, {n_k:g} kernel launches; logits finite and "
          f"shaped: {ok}; rmsnorm launches {n_prefill} (expected {norms}: "
          f"norm1, kv_norm, norm2 a layer and final_norm)")
    for name, ms, n in top:
        print(f"[moe-profile]   {ms:8.3f} ms  x{n:g}  {name}")
    if not ok:
        failures.append("MoE prefill logits not finite or misshapen")
    if n_prefill != norms:
        failures.append(f"MoE prefill launched rmsnorm {n_prefill} times, "
                        f"not {norms}")
    lap("14a init and prefill")

    state = init_decode_state(cfg, B, S + MOE_DECODE_STEPS, device=dev)
    cache_b = sum(t.numel() * t.element_size() for pair in state["caches"]
                  for t in pair)
    gqa_b = (2 * cfg.n_layers * B * (S + MOE_DECODE_STEPS) * cfg.n_kv_heads
             * cfg.head_dim * 2)
    step_at = iter(range(S))

    def one_step():
        nonlocal state
        t = next(step_at)
        lg, state = decode_step(params, cfg, state, tokens[:, t:t + 1])
        return lg

    one_step()                                      # warm-up
    torch.cuda.synchronize()
    rmsnorm_cuda.launches = 0
    t0 = time.perf_counter()
    for _ in range(MOE_DECODE_STEPS):
        lg = one_step()
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t0) / MOE_DECODE_STEPS
    n_decode = rmsnorm_cuda.launches
    ok = bool(torch.isfinite(lg).all()) and lg.shape == (B, V)
    # the profiled window: LM_PROFILE_STEPS steps (32 before phase 15
    # needed the time: 38 s of profiling on a slow host)
    t0 = time.perf_counter()
    busy, n_k, _ = device_profile(one_step, LM_PROFILE_STEPS)
    t_prof = time.perf_counter() - t0
    idle = ("not measured" if busy is None
            else f"{1 - busy / (t_dec * 1e3):.1%}")
    print(f"[moe-decode] {MOE_DECODE_STEPS} decode steps (B={B}, MLA cache "
          f"of {S + MOE_DECODE_STEPS} positions: {cache_b / 1e6:.1f} MB over"
          f" all layers, a GQA cache {gqa_b / cache_b:.1f}x that): "
          f"{t_dec * 1e3:.2f} ms a step; over {LM_PROFILE_STEPS} more, "
          f"profiled (device activity only, {t_prof:.1f} s), device busy "
          f"{'not measured' if busy is None else f'{busy:.2f} ms'} a step, "
          f"idle share {idle}, {n_k:g} launches a step; logits finite: "
          f"{ok}; rmsnorm launches {n_decode} (expected "
          f"{MOE_DECODE_STEPS * norms})")
    if not ok:
        failures.append("MoE decode logits not finite or misshapen")
    if n_decode != MOE_DECODE_STEPS * norms:
        failures.append(f"MoE decode launched rmsnorm {n_decode} times")
    del state, lg
    lap("14a decode")

    lens = torch.randint(8, 17, (MOE_REQUESTS,), generator=gen,
                         device=dev).tolist()
    prompts = [torch.randint(0, V, (n,), generator=gen, device=dev).tolist()
               for n in lens]

    def serve(c):
        reqs = [Request(rid=i, prompt=pr, max_new_tokens=MOE_NEW_TOKENS)
                for i, pr in enumerate(prompts)]
        eng = ServingEngine(params, c, n_slots=MOE_SLOTS,
                            max_seq=MOE_ENGINE_SEQ)
        arrivals = {0: reqs[:4], 6: reqs[4:6], 12: reqs[6:]}
        steps = 0
        torch.cuda.synchronize()
        rmsnorm_cuda.launches = 0
        t0 = time.perf_counter()
        while steps < 1000:
            for r in arrivals.get(steps, []):
                eng.submit(r)
            if steps > max(arrivals) and not eng.pending and \
                    all(s is None for s in eng.slots):
                break
            eng.step()
            steps += 1
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        n_gen = sum(len(r.generated) for r in reqs)
        done = all(r.done and len(r.generated) == MOE_NEW_TOKENS
                   and all(0 <= x < V for x in r.generated) for r in reqs)
        launches = rmsnorm_cuda.launches
        print(f"[moe-serve] ServingEngine({c.dtype}, n_slots={MOE_SLOTS}, "
              f"max_seq={MOE_ENGINE_SEQ}): {MOE_REQUESTS} requests, prompts "
              f"{lens} tokens, {MOE_NEW_TOKENS} new each; {steps} steps in "
              f"{t:.2f} s, {t / steps * 1e3:.2f} ms a step, "
              f"{n_gen / t:.1f} generated tokens/s; all finished: {done}; "
              f"rmsnorm launches {launches} (expected {steps * norms})")
        if not done:
            failures.append(f"the {c.dtype} engine did not answer every "
                            f"request")
        if launches != steps * norms:
            failures.append(f"the {c.dtype} engine launched rmsnorm "
                            f"{launches} times in {steps} steps")
        return reqs

    serve(cfg)
    lap("14a bf16 engine")
    # f32: each request through the engine against it decoded alone
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    agree = checked = 0
    for r in serve(cfg32):
        alone, _ = greedy_generate(params, cfg32, init_decode_state(
            cfg32, 1, MOE_ENGINE_SEQ, device=dev), torch.tensor(
            [r.prompt], device=dev), MOE_NEW_TOKENS)
        alone = alone[0].tolist()
        checked += len(alone)
        for t, (a, b) in enumerate(zip(r.generated, alone)):
            if a == b:
                agree += 1
                continue
            # the isolated run's top-1 / top-2 margin where they part
            st = init_decode_state(cfg32, 1, MOE_ENGINE_SEQ, device=dev)
            for x in r.prompt + alone[:t]:
                lg, st = decode_step(params, cfg32, st,
                                     torch.tensor([[x]], device=dev))
            top2 = lg[0].topk(2).values
            margin = float(top2[0] - top2[1]) / max(1.0,
                                                    abs(float(top2[0])))
            if margin > TOL_LM_F32:
                failures.append(f"f32 request {r.rid}: token {t} differs "
                                f"from the isolated run ({a} vs {b}) at a "
                                f"margin {margin:.3e}")
            break
    peak = torch.cuda.max_memory_allocated()
    lap("14a f32 engine and each request alone")
    print(f"[moe-serve] f32 engine against each request decoded alone by "
          f"greedy_generate: {agree} of {checked} tokens agree up to each "
          f"request's first difference (allowed only at an isolated top-1 /"
          f" top-2 margin within {TOL_LM_F32} of max(1, |top-1|))")
    print(f"[moe] serving device memory peak {peak / gb:.2f} GB "
          f"({peak / 2 ** 30:.2f} GiB; the params {p_bytes / gb:.2f} GB); "
          f"limit {MOE_PEAK_BYTES / gb:.0f} GB at full depth")
    if peak > MOE_PEAK_BYTES:
        failures.append(f"serving peak {peak / gb:.2f} GB over "
                        f"{MOE_PEAK_BYTES / gb:.0f} GB")
    if failures:
        return []

    # ---- b. parity at full width, depth cut to MOE_SHORT_LAYERS -----------
    del params["blocks"][MOE_SHORT_LAYERS:]
    torch.cuda.empty_cache()
    short = dataclasses.replace(cfg, n_layers=MOE_SHORT_LAYERS)

    def plain(c, toks):
        with mock.patch.object(rmsnorm_module, "on_card",
                               lambda t, name: False):
            return forward(params, c, toks)

    reads = {}
    for dt in ("float32", "bfloat16"):
        c = dataclasses.replace(short, dtype=dt)
        rmsnorm_cuda.launches = 0
        got = forward(params, c, tokens)
        torch.cuda.synchronize()
        n = rmsnorm_cuda.launches
        want = plain(c, tokens)
        if rmsnorm_cuda.launches != n or n != lm_norms(c):
            failures.append(f"{dt} parity forward: rmsnorm launches {n}, "
                            f"the plain run {rmsnorm_cuda.launches - n}")
        reads[dt] = (allclose_ratio(got, want, 1e-4), rel_fro(got, want))
        del got, want
    (r32, e32), f_32 = reads["float32"]
    _, f_bf = reads["bfloat16"]
    print(f"[moe-parity] depth {MOE_SHORT_LAYERS}, {B} x {S} tokens, the "
          f"forward with the rmsnorm kernel against every kernel swapped for"
          f" its plain version: f32 max abs err {e32:.3e} ({r32:.3f}x the "
          f"1e-4 bound), rel Frobenius {f_32:.3e}; bf16 rel Frobenius "
          f"{f_bf:.3e} (bound {TOL_LM_BF16})")
    if not r32 <= 1.0:
        failures.append(f"f32 kernel vs plain forward {e32:.3e}")
    if not f_bf <= TOL_LM_BF16:
        failures.append(f"bf16 kernel vs plain forward {f_bf:.3e}")

    dense = dataclasses.replace(short, moe_impl="dense")
    prompt = tokens[:, :LM_DECODE_PROMPT].contiguous()
    ref = forward(params, dense, prompt)
    state = init_decode_state(dense, B, LM_DECODE_PROMPT, device=dev)
    outs = []
    rmsnorm_cuda.launches = 0
    for t in range(LM_DECODE_PROMPT):
        lg, state = decode_step(params, dense, state, prompt[:, t:t + 1])
        outs.append(lg)
    n = rmsnorm_cuda.launches
    e_dec = rel_fro(torch.stack(outs, 1), ref)
    no_drop = dataclasses.replace(short, capacity_factor=cfg.n_experts
                                  / cfg.top_k)
    cap = moe_module.capacity(no_drop, LM_DECODE_PROMPT)
    e_cap = rel_fro(forward(params, no_drop, prompt), ref)
    print(f"[moe-parity] {LM_DECODE_PROMPT} teacher-forced decode steps "
          f"(dense dispatch) against the prefill: rel Frobenius {e_dec:.3e} "
          f"(bound {TOL_LM_BF16}), rmsnorm launches {n} (expected "
          f"{LM_DECODE_PROMPT * lm_norms(dense)}); capacity at factor "
          f"E / k (capacity {cap} of {LM_DECODE_PROMPT}: nothing drops) "
          f"against dense: {e_cap:.3e} (bound {TOL_LM_BF16})")
    if not e_dec <= TOL_LM_BF16:
        failures.append(f"MoE decode vs prefill {e_dec:.3e}")
    if n != LM_DECODE_PROMPT * lm_norms(dense):
        failures.append(f"MoE parity decode launched rmsnorm {n} times")
    if not (e_cap <= TOL_LM_BF16 and cap == LM_DECODE_PROMPT):
        failures.append(f"capacity (no drops) vs dense {e_cap:.3e}")
    del state, outs, ref, lg
    lap("14b parity")

    # ---- c. training at full width, depth cut to MOE_SHORT_LAYERS ---------
    pipe = TokenPipeline(vocab_size=V, seq_len=S, global_batch=B,
                         seed=args.seed)
    routed = {}
    apply = lm_module.moe_apply

    def recording(p, c, x, tp=None):
        with torch.no_grad():
            _, _, top_idx = moe_module._route(p, c, x)
        routed.setdefault(p["router"].data_ptr(), set()).update(
            top_idx.unique().tolist())
        return apply(p, c, x, tp=tp)

    with mock.patch.object(lm_module, "moe_apply", recording):
        loss, grads = loss_and_grads(params, short, {
            k: v.to(dev) for k, v in pipe.batch(10 ** 6).items()},
            MOE_MICROBATCHES)
    by_path = {"/".join(map(str, p)): g for (p, _), g in
               zip(leaves_with_paths(params), grads)}
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    n_exp = 0
    for i, blk in enumerate(params["blocks"]):
        moe = f"blocks/{i}/moe/"
        if not bool(by_path[moe + "router"].abs().max() > 0):
            failures.append(f"no gradient reached layer {i}'s router")
        for e in sorted(routed.get(blk["moe"]["router"].data_ptr(), ())):
            n_exp += 1
            if not all(bool(by_path[moe + w][e].abs().max() > 0)
                       for w in ("wi_gate", "wi_up", "wo")):
                failures.append(f"no gradient reached layer {i}'s expert {e}"
                                f", routed a token")
    print(f"[moe-train] loss_and_grads on {B} x {S} tokens: loss "
          f"{float(loss):.5f}, every gradient finite: {finite}; gradients "
          f"reach both routers and all {n_exp} (layer, expert) pairs routed "
          f"a token (of {MOE_SHORT_LAYERS * cfg.n_experts})")
    if not (finite and math.isfinite(float(loss))):
        failures.append("MoE gradients or loss not finite")
    del grads, by_path

    acfg = AdamWConfig(lr=LM_TRAIN_LR, warmup_steps=0,
                       total_steps=MOE_TRAIN_STEPS)
    step_fn = make_train_step(short, acfg,
                              TrainConfig(microbatches=MOE_MICROBATCHES))
    opt = adamw_init(params)
    n_train = sum(t.numel() for t in leaves(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rmsnorm_cuda.launches = 0
    times, losses = [], []
    for s in range(MOE_TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, pipe.batch(s))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    n = rmsnorm_cuda.launches
    want_n = MOE_TRAIN_STEPS * MOE_MICROBATCHES * (2 * lm_norms(short) - 1)
    peak = torch.cuda.max_memory_allocated()
    t_med = statistics.median(times)
    print(f"[moe-train] {MOE_TRAIN_STEPS} AdamW steps (lr {LM_TRAIN_LR}) of "
          f"{B} x {S} tokens in {MOE_MICROBATCHES} microbatches, bf16 remat,"
          f" depth {MOE_SHORT_LAYERS} ({n_train} params, "
          f"{4 * n_train * 4 / gb:.1f} GB with gradient and moments): "
          f"losses {[round(x, 5) for x in losses]}; step walls "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms, "
          f"{B * S / t_med:.0f} training tokens/s at the median; device "
          f"memory peak {peak / gb:.2f} GB; rmsnorm launches {n} (expected "
          f"{want_n}: a microbatch's forward and its remat recompute, "
          f"final_norm once)")
    if not all(math.isfinite(x) for x in losses):
        failures.append(f"MoE training losses {losses}")
    if n != want_n:
        failures.append(f"MoE training launched rmsnorm {n} times")
    del params, opt, step_fn, tokens
    torch.cuda.empty_cache()
    lap("14c training")

    # ---- d. the kernel at every shape the phase launched it at ------------
    gen_k = torch.Generator(device=dev).manual_seed(args.seed + 15)
    entries = []
    for key, n in sorted(rmsnorm_cuda.by_shape.items()):
        rows, d, dt = key
        entry, ratio = _lmd_rmsnorm_entry(key, n, ["phase 14"], gen_k, dev,
                                          name=f"rmsnorm_moe_{rows}x{d}_{dt}")
        print(f"[moe-time] rmsnorm {key}: {n} launches; {entry['ms']:.4f} ms"
              f" | plain {entry['plain_ms']:.4f} ms | F.rms_norm "
              f"{entry['library_ms']:.4f} ms | bound {entry['bound_ms']:.4f} "
              f"ms ({entry['bound_by']}) | vs plain max abs err "
              f"{entry['max_abs_err']:.3e} ({ratio:.2f}x tolerance)")
        if not ratio <= 1.0:
            failures.append(f"rmsnorm {key} disagrees with its plain "
                            f"version")
        entries.append(entry)
    lap("14d kernel entries")
    if not any(key[1] == cfg.kv_lora_rank for key in rmsnorm_cuda.by_shape):
        failures.append("phase 14 launched no rmsnorm at D = kv_lora_rank")
    torch.cuda.empty_cache()
    print(f"[moe] phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return entries


def lm_zero_counts() -> None:
    """Zero the launch counters of rmsnorm and the flash kernels."""
    from repro_torch.kernels.flash_attention import (flash_bwd_cuda,
                                                     flash_fwd_cuda)
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    rmsnorm_cuda.launches = 0
    flash_fwd_cuda.launches = flash_fwd_cuda.launches_wgmma = 0
    flash_bwd_cuda.launches_dq = flash_bwd_cuda.launches_dkv = 0
    flash_bwd_cuda.launches_dq_wgmma = 0
    flash_bwd_cuda.launches_dkv_wgmma = 0


def lm_counts() -> tuple:
    """(rmsnorm, tensor-core flash forward, dq, dkv, FP32-FMA flash
    launches of any kind) since the last ``lm_zero_counts``."""
    from repro_torch.kernels.flash_attention import (flash_bwd_cuda,
                                                     flash_fwd_cuda)
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    return (rmsnorm_cuda.launches, flash_fwd_cuda.launches_wgmma,
            flash_bwd_cuda.launches_dq_wgmma,
            flash_bwd_cuda.launches_dkv_wgmma,
            flash_fwd_cuda.launches + flash_bwd_cuda.launches_dq
            + flash_bwd_cuda.launches_dkv)


def lm_expect(failures: list, what: str, got: tuple, want: tuple) -> None:
    """A failure where ``lm_counts`` read other launches than ``want``."""
    if got != want:
        failures.append(f"{what}: launches (rmsnorm, flash fwd, dq, dkv, "
                        f"FP32-FMA) {got}, not {want}")


def ssm_phase(dev, args, failures):
    """Phase 16 (module docstring): the SSM family on the card,
    Falcon-Mamba-7B and Zamba2-1.2B at full width.  Returns the
    kernels-record entries of rmsnorm and the tensor-core flash kernels,
    one for each shape the phase launched them at."""
    import dataclasses
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import rmsnorm as rmsnorm_module
    from repro_torch.kernels.flash_attention import (flash_bwd_cuda,
                                                     flash_fwd_cuda)
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.models import (abstract_params, decode_step, forward,
                                    init_decode_state, init_params)
    from repro_torch.models import mamba as mb
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import (Request, ServingEngine, TrainConfig,
                                   greedy_generate, loss_and_grads,
                                   make_train_step)
    from repro_torch.tree import leaves, leaves_with_paths

    t_phase = time.perf_counter()
    laps = [t_phase]
    gb = 1e9
    B, S = SSM_BATCH, SSM_SEQ

    def lap(what):
        laps.append(time.perf_counter())
        print(f"[ssm] {what} took {laps[-1] - laps[-2]:.1f} s", flush=True)

    zero_counts, counts = lm_zero_counts, lm_counts

    def expect(what, got, want):
        lm_expect(failures, what, got, want)

    rmsnorm_cuda.by_shape = {}
    flash_fwd_cuda.by_shape = {}
    flash_bwd_cuda.by_shape = {}
    torch.cuda.empty_cache()

    def serve(arch, seed):
        """16a / 16b: init, prefill, decode held against the prefill, the
        engines, at full width and depth.  Returns (cfg, params, tokens,
        prefill ms)."""
        cfg = dataclasses.replace(get_config(arch), attn_impl="flash")
        tag = "falcon" if arch.startswith("falcon") else "zamba2"
        V, norms = cfg.vocab_size, lm_norms(cfg)
        apps = cfg.n_periods if cfg.shared_attn_every else 0
        gen = torch.Generator(device=dev).manual_seed(seed)
        t0 = time.perf_counter()
        params = init_params(gen, cfg, device=dev)
        torch.cuda.synchronize()
        n_par = sum(t.numel() for t in leaves(params))
        n_abs = sum(t.numel() for t in leaves(abstract_params(cfg)))
        p_bytes = torch.cuda.memory_allocated()
        print(f"[ssm-{tag}] {cfg.name}: {cfg.n_layers} layers "
              f"{'x'.join(cfg.pattern)}, d_model {cfg.d_model}, d_inner "
              f"{cfg.d_inner}, state {cfg.ssm_state}"
              + (f", {cfg.d_inner // cfg.mamba_headdim} SSM heads x "
                 f"{cfg.mamba_headdim}, ssm_impl {cfg.ssm_impl}"
                 if cfg.pattern[0] == "mamba2" else "")
              + (f", the shared block ({cfg.n_heads} heads x "
                 f"{cfg.head_dim}, d_ff {cfg.d_ff}) applied {apps} times"
                 if apps else "")
              + f", vocab {V}: {n_par} f32 params ({n_par * 4 / gb:.2f} GB;"
              f" the JAX abstract_params count {SSM_LEAVES[arch]}, "
              f"param_count {cfg.param_count()}) drawn in "
              f"{time.perf_counter() - t0:.1f} s; {p_bytes / gb:.2f} GB "
              f"allocated", flush=True)
        if not n_par == n_abs == SSM_LEAVES[arch]:
            failures.append(f"{cfg.name}: {n_par} params, abstract_params "
                            f"{n_abs}, JAX {SSM_LEAVES[arch]}")
        tokens = torch.randint(0, V, (B, S), generator=gen, device=dev)
        # the warm-up forward, profiled (device activity only: Falcon's
        # prefill makes ~38 000 launches, whose host events took 50 s to
        # sort through on the card's host)
        t0 = time.perf_counter()
        busy, n_k, top = device_profile(lambda: forward(params, cfg, tokens),
                                        1)
        t_prof = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        logits = forward(params, cfg, tokens)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        got = counts()
        peak = torch.cuda.max_memory_allocated()
        ok = bool(torch.isfinite(logits).all()) and logits.shape == (B, S, V)
        ref = logits[:, :SSM_HELD].clone()
        del logits
        idle = ("not measured" if busy is None
                else f"{1 - busy / (t_prefill * 1e3):.1%}")
        print(f"[ssm-{tag}-prefill] forward B={B} S={S} bf16: "
              f"{t_prefill * 1e3:.1f} ms, {B * S / t_prefill:.0f} tokens/s; "
              f"device busy "
              f"{'not measured' if busy is None else f'{busy:.2f} ms'}, "
              f"idle share {idle}, {n_k:g} kernel launches (the warm-up "
              f"forward profiled, {t_prof:.1f} s); peak {peak / gb:.2f} GB; logits finite and"
              f" shaped: {ok}; launches {got} (expected rmsnorm {norms}, "
              f"tensor-core flash {apps})", flush=True)
        for name, ms, n in top:
            print(f"[ssm-profile]   {ms:8.3f} ms  x{n:g}  {name}")
        if not ok:
            failures.append(f"{cfg.name} prefill logits not finite or "
                            f"misshapen")
        expect(f"{cfg.name} prefill", got, (norms, apps, 0, 0, 0))
        lap(f"16{tag[0]} {tag} init and prefill")

        # the decode steps, teacher-forced on the prefill's tokens: a
        # warm-up step, SSM_DECODE_STEPS timed, LM_PROFILE_STEPS profiled,
        # every step's logits held against the prefill's at its position
        state = init_decode_state(cfg, B, SSM_HELD, device=dev)
        outs = []

        def one_step():
            nonlocal state
            t = len(outs)
            lg, state = decode_step(params, cfg, state, tokens[:, t:t + 1])
            outs.append(lg)
            return lg

        one_step()
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        for _ in range(SSM_DECODE_STEPS):
            one_step()
        torch.cuda.synchronize()
        t_dec = (time.perf_counter() - t0) / SSM_DECODE_STEPS
        got = counts()
        t0 = time.perf_counter()
        busy, n_k, _ = device_profile(one_step, LM_PROFILE_STEPS)
        t_prof = time.perf_counter() - t0
        idle = ("not measured" if busy is None
                else f"{1 - busy / (t_dec * 1e3):.1%}")
        dec = torch.stack(outs, 1)
        e_dec = rel_fro(dec, ref)
        # context, not a check: both bf16 routes against an f32 prefill of
        # the same positions (every kernel plain, naive attention)
        with mock.patch.object(rmsnorm_module, "on_card",
                               lambda t, name: False):
            ref32 = forward(params, dataclasses.replace(
                cfg, dtype="float32", attn_impl="naive"),
                tokens[:, :SSM_HELD].contiguous())
        noise = (rel_fro(ref, ref32), rel_fro(dec, ref32))
        print(f"[ssm-{tag}-decode] {SSM_DECODE_STEPS} decode steps (B={B}):"
              f" {t_dec * 1e3:.2f} ms a step; over {LM_PROFILE_STEPS} more, "
              f"profiled ({t_prof:.1f} s), device busy "
              f"{'not measured' if busy is None else f'{busy:.2f} ms'} a "
              f"step, idle share {idle}, {n_k:g} launches a step; the "
              f"{len(outs)} teacher-forced steps' logits against the "
              f"prefill's: rel Frobenius {e_dec:.3e} (bound {TOL_LM_BF16});"
              f" the bf16 prefill and decode against an f32 prefill of "
              f"those positions: {noise[0]:.3e}, {noise[1]:.3e}; launches "
              f"{got} (expected rmsnorm {SSM_DECODE_STEPS * norms})",
              flush=True)
        if not e_dec <= TOL_LM_BF16:
            failures.append(f"{cfg.name} bf16 decode vs prefill {e_dec:.3e}")
        expect(f"{cfg.name} decode", got,
               (SSM_DECODE_STEPS * norms, 0, 0, 0, 0))
        del state, outs, ref, dec, ref32
        lap(f"16{tag[0]} {tag} decode")

        lens = torch.randint(8, 17, (SSM_REQUESTS,), generator=gen,
                             device=dev).tolist()
        prompts = [torch.randint(0, V, (n,), generator=gen,
                                 device=dev).tolist() for n in lens]

        def engine(c):
            reqs = [Request(rid=i, prompt=pr, max_new_tokens=SSM_NEW_TOKENS)
                    for i, pr in enumerate(prompts)]
            eng = ServingEngine(params, c, n_slots=SSM_SLOTS,
                                max_seq=SSM_ENGINE_SEQ)
            arrivals = {0: reqs[:4], 6: reqs[4:6], 12: reqs[6:]}
            steps = 0
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            while steps < 1000:
                for r in arrivals.get(steps, []):
                    eng.submit(r)
                if steps > max(arrivals) and not eng.pending and \
                        all(s is None for s in eng.slots):
                    break
                eng.step()
                steps += 1
            torch.cuda.synchronize()
            t = time.perf_counter() - t0
            got = counts()
            n_gen = sum(len(r.generated) for r in reqs)
            done = all(r.done and len(r.generated) == SSM_NEW_TOKENS
                       and all(0 <= x < V for x in r.generated)
                       for r in reqs)
            print(f"[ssm-{tag}-serve] ServingEngine({c.dtype}, n_slots="
                  f"{SSM_SLOTS}, max_seq={SSM_ENGINE_SEQ}): {SSM_REQUESTS} "
                  f"requests, prompts {lens} tokens, {SSM_NEW_TOKENS} new "
                  f"each; {steps} steps in {t:.2f} s, "
                  f"{t / steps * 1e3:.2f} ms a step, {n_gen / t:.1f} "
                  f"generated tokens/s; all finished: {done}; launches "
                  f"{got} (expected rmsnorm {steps * norms})", flush=True)
            if not done:
                failures.append(f"the {cfg.name} {c.dtype} engine did not "
                                f"answer every request")
            expect(f"{cfg.name} {c.dtype} engine", got,
                   (steps * norms, 0, 0, 0, 0))
            return reqs

        engine(cfg)
        lap(f"16{tag[0]} {tag} bf16 engine")
        # f32: slots are reused (8 requests on 4 slots), so a state left
        # unzeroed shows; every token must equal the request decoded alone
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        same = checked = 0
        for r in engine(cfg32):
            alone, _ = greedy_generate(params, cfg32, init_decode_state(
                cfg32, 1, SSM_ENGINE_SEQ, device=dev), torch.tensor(
                [r.prompt], device=dev), SSM_NEW_TOKENS)
            alone = alone[0].tolist()
            checked += len(alone)
            same += sum(a == b for a, b in zip(r.generated, alone))
            if r.generated != alone:
                failures.append(f"{cfg.name} f32 request {r.rid}: the "
                                f"engine's {r.generated}, alone {alone}")
        peak = torch.cuda.max_memory_allocated()
        print(f"[ssm-{tag}-serve] f32 engine against each request decoded "
              f"alone by greedy_generate: {same} of {checked} tokens equal;"
              f" serving peak {peak / gb:.2f} GB (the params "
              f"{p_bytes / gb:.2f} GB)", flush=True)
        if peak > SSM_PEAK_BYTES:
            failures.append(f"{cfg.name} serving peak {peak / gb:.2f} GB")
        lap(f"16{tag[0]} {tag} f32 engine and each request alone")
        return cfg, params, tokens, t_prefill * 1e3

    def core_share(cfg, ms_core, ms_prefill, what):
        share = cfg.n_layers * ms_core / ms_prefill
        print(f"[ssm-{cfg.name}] {what}: {ms_core:.3f} ms a layer (CUDA "
              f"events, 3 calls) x {cfg.n_layers} layers = "
              f"{share:.1%} of the {ms_prefill:.1f} ms prefill (what a "
              f"fused selective-scan kernel would replace, ROADMAP A14j)",
              flush=True)
        return share

    def train(cfg, params, what):
        """2 AdamW steps of B x S tokens in SSM_MICROBATCHES microbatches,
        bf16 with remat: finite, falling losses and exact launches."""
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=S,
                             global_batch=B, seed=args.seed)
        acfg = AdamWConfig(lr=LM_TRAIN_LR, warmup_steps=0,
                           total_steps=SSM_TRAIN_STEPS)
        step_fn = make_train_step(cfg, acfg, TrainConfig(
            microbatches=SSM_MICROBATCHES))
        opt = adamw_init(params)
        n_train = sum(t.numel() for t in leaves(params))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        times, losses = [], []
        for s in range(SSM_TRAIN_STEPS):
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, pipe.batch(s))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        got = counts()
        peak = torch.cuda.max_memory_allocated()
        t_med = statistics.median(times)
        apps = cfg.n_periods if cfg.shared_attn_every else 0
        nm = SSM_TRAIN_STEPS * SSM_MICROBATCHES
        want = (nm * (2 * lm_norms(cfg) - 1), nm * 2 * apps, nm * apps,
                nm * apps, 0)
        print(f"[ssm-train] {cfg.name} {what}: {SSM_TRAIN_STEPS} AdamW steps"
              f" (lr {LM_TRAIN_LR}) of {B} x {S} tokens in "
              f"{SSM_MICROBATCHES} microbatches, bf16 remat ({n_train} "
              f"params, {4 * n_train * 4 / gb:.1f} GB with gradient and "
              f"moments): losses {losses}; step walls "
              f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms, "
              f"{B * S / t_med:.0f} training tokens/s at the median; device"
              f" memory peak {peak / gb:.2f} GB; launches {got} (expected "
              f"{want}: a microbatch's forward and its remat recompute, "
              f"final_norm once)", flush=True)
        if not (all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0]):
            failures.append(f"{cfg.name} training losses {losses}")
        expect(f"{cfg.name} training", got, want)
        del opt, step_fn
        return params

    # ---- a. Falcon-Mamba-7B ------------------------------------------------
    cfg, params, tokens, ms_prefill = serve("falcon_mamba_7b",
                                            args.seed + 16)
    p0 = params["blocks"][0]["mamba"]
    xc = torch.randn((B, S, cfg.d_inner), generator=torch.Generator(
        device=dev).manual_seed(args.seed), device=dev).to(torch.bfloat16)

    def falcon_core():
        decay, drive, Cc = mb._mamba1_ssm_inputs(p0, xc, xc.dtype)
        return mb._chunked_ssm(decay, drive, Cc.float(), mb.CHUNK)

    shares = {"falcon": core_share(cfg, time_cuda(falcon_core, 3),
                                   ms_prefill,
                                   "decay, drive and the chunked scan")}
    del xc
    # the depth cut to SSM_SHORT_LAYERS (full width): four copies of the
    # 28.0 GB params (with gradient and AdamW moments) do not fit a card
    del params["blocks"][SSM_SHORT_LAYERS:]
    torch.cuda.empty_cache()
    short = dataclasses.replace(cfg, n_layers=SSM_SHORT_LAYERS)
    short32 = dataclasses.replace(short, dtype="float32")
    prompt = tokens[:, :SSM_F32_PROMPT].contiguous()
    ref = forward(params, short32, prompt)
    state = init_decode_state(short32, B, SSM_F32_PROMPT, device=dev)
    outs = []
    for t in range(SSM_F32_PROMPT):
        lg, state = decode_step(params, short32, state, prompt[:, t:t + 1])
        outs.append(lg)
    e32 = rel_fro(torch.stack(outs, 1), ref)
    print(f"[ssm-falcon] depth {SSM_SHORT_LAYERS}, f32: {SSM_F32_PROMPT} "
          f"teacher-forced decode steps against the prefill: rel Frobenius "
          f"{e32:.3e} (bound {TOL_LM_F32})", flush=True)
    if not e32 <= TOL_LM_F32:
        failures.append(f"Falcon-Mamba f32 decode vs prefill {e32:.3e}")
    del state, outs, ref, lg
    # the f32 gradient through the rmsnorm kernel against the same step
    # with every rmsnorm plain, leaf by leaf
    batch = {k: v[:SSM_GRAD_BATCH].to(dev) for k, v in TokenPipeline(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
        seed=args.seed).batch(10 ** 6).items()}
    loss_k, g_k = loss_and_grads(params, short32, batch)
    with mock.patch.object(rmsnorm_module, "on_card", lambda t, name: False):
        loss_p, g_p = loss_and_grads(params, short32, batch)
    errs = {"/".join(map(str, path)): rel_fro(a, b) for (path, _), a, b in
            zip(leaves_with_paths(params), g_k, g_p)}
    worst = max(errs, key=errs.get)
    finite = all(bool(torch.isfinite(g).all()) for g in g_k)
    zero = [k for k, g in zip(errs, g_k) if not bool(g.abs().max() > 0)]
    print(f"[ssm-falcon] depth {SSM_SHORT_LAYERS}, f32 loss_and_grads on "
          f"{SSM_GRAD_BATCH} x {S} tokens, the rmsnorm kernel against it "
          f"plain: loss {float(loss_k):.6f} vs {float(loss_p):.6f}; the "
          f"{len(errs)} leaves' worst rel Frobenius {errs[worst]:.3e} "
          f"({worst}; bound {TOL_GRAD_F32}); every gradient finite: "
          f"{finite}; zero leaves {zero}", flush=True)
    if not (errs[worst] <= TOL_GRAD_F32 and finite and not zero):
        failures.append(f"Falcon-Mamba f32 gradients vs plain: {worst} "
                        f"{errs[worst]:.3e}, finite {finite}, zero {zero}")
    del g_k, g_p, batch
    lap("16a falcon depth-cut checks")
    params = train(short, params, f"depth {SSM_SHORT_LAYERS}")
    del params, tokens
    torch.cuda.empty_cache()
    lap("16a falcon training")

    # ---- b. Zamba2-1.2B ----------------------------------------------------
    cfg, params, tokens, ms_prefill = serve("zamba2_1p2b", args.seed + 17)
    # f32 decode against the prefill at full depth (naive attention in
    # both, so the f32 check reads the Mamba states and the shared
    # caches; the f32 flash route is phase 7's)
    cfg32 = dataclasses.replace(cfg, dtype="float32", attn_impl="naive")
    prompt = tokens[:2, :SSM_F32_PROMPT].contiguous()
    ref = forward(params, cfg32, prompt)
    state = init_decode_state(cfg32, 2, SSM_F32_PROMPT, device=dev)
    outs = []
    for t in range(SSM_F32_PROMPT):
        lg, state = decode_step(params, cfg32, state, prompt[:, t:t + 1])
        outs.append(lg)
    e32 = rel_fro(torch.stack(outs, 1), ref)
    print(f"[ssm-zamba2] full depth, f32: {SSM_F32_PROMPT} teacher-forced "
          f"decode steps of 2 rows against the prefill: rel Frobenius "
          f"{e32:.3e} (bound {TOL_LM_F32})", flush=True)
    if not e32 <= TOL_LM_F32:
        failures.append(f"Zamba2 f32 decode vs prefill {e32:.3e}")
    del state, outs, ref, lg
    # SSD against the elementwise scan on one layer at full width, f32
    p0 = params["blocks"][0]["mamba"]
    x = 0.5 * torch.randn((2, S, cfg.d_model), generator=torch.Generator(
        device=dev).manual_seed(args.seed), device=dev)
    ssd = mb.mamba2_forward(p0, dataclasses.replace(cfg32, ssm_impl="ssd"), x)
    scan = mb.mamba2_forward(p0, dataclasses.replace(cfg32, ssm_impl="scan"),
                             x)
    err = (ssd.double() - scan.double()).abs()
    e_ssd = float(err.max())
    r_ssd = float((err / (TOL_SSD_A + TOL_SSD_R * scan.double().abs())
                   ).max())
    print(f"[ssm-zamba2] one layer at full width, 2 x {S} f32: ssd against "
          f"scan max abs err {e_ssd:.3e}, {r_ssd:.3f}x the tests/test_ssd.py"
          f" bound (rtol {TOL_SSD_R}, atol {TOL_SSD_A})", flush=True)
    if not r_ssd <= 1.0:
        failures.append(f"Zamba2 ssd vs scan {r_ssd:.3f}x the bound")
    del ssd, scan, err, x
    zxbcdt = torch.randn((B, S, 2 * cfg.d_inner + 2 * cfg.ssm_state
                          + cfg.d_inner // cfg.mamba_headdim),
                         generator=torch.Generator(device=dev).manual_seed(
                             args.seed), device=dev).to(torch.bfloat16)
    _, xr, Bc, Cc, dt, decay, _ = mb._mamba2_parts(p0, cfg, zxbcdt)
    xh = xr.reshape(B, S, -1, cfg.mamba_headdim).float()
    Bc, Cc = Bc.float(), Cc.float()
    shares["zamba2"] = core_share(cfg, time_cuda(lambda: mb._ssd_chunked(
        xh, Bc, Cc, dt, decay, mb.CHUNK), 3), ms_prefill,
        "SSD's chunked matrix form")
    del zxbcdt, xr, Bc, Cc, dt, decay, xh
    lap("16b zamba2 f32 decode and ssd vs scan")
    params = train(cfg, params, "full depth")
    del params, tokens
    torch.cuda.empty_cache()
    lap("16b zamba2 training")

    # ---- c. the kernels at every shape the phase launched them at --------
    gen_k = torch.Generator(device=dev).manual_seed(args.seed + 18)
    entries = []
    for key, n in sorted(rmsnorm_cuda.by_shape.items()):
        rows, d, dt = key
        entry, ratio = _lmd_rmsnorm_entry(key, n, ["phase 16"], gen_k, dev,
                                          name=f"rmsnorm_ssm_{rows}x{d}_{dt}")
        print(f"[ssm-time] rmsnorm {key}: {n} launches; {entry['ms']:.4f} ms"
              f" | plain {entry['plain_ms']:.4f} ms | F.rms_norm "
              f"{entry['library_ms']:.4f} ms | bound {entry['bound_ms']:.4f} "
              f"ms ({entry['bound_by']}) | vs plain max abs err "
              f"{entry['max_abs_err']:.3e} ({ratio:.2f}x tolerance)")
        if not ratio <= 1.0:
            failures.append(f"rmsnorm {key} disagrees with its plain "
                            f"version")
        entries.append(entry)
    for d in (4096, 2048):
        if not any(key[1] == d for key in rmsnorm_cuda.by_shape):
            failures.append(f"phase 16 launched no rmsnorm at D = {d}")
    for key, n in sorted(flash_fwd_cuda.by_shape.items()):
        if key[0] != "wgmma":
            failures.append(f"phase 16 launched the FP32-FMA flash forward "
                            f"at {key}")
            continue
        n_bwd = flash_bwd_cuda.by_shape.get(key, 0)
        new, ratios = _lmd_flash_entries(key, n, n_bwd, ["phase 16"], gen_k,
                                         dev, tag="ssm")
        if not n_bwd:           # a prefill shape: dq and dkv checked only
            new = new[:1]
        for e in new:
            print(f"[ssm-time] {e['name']} {e['shape']}: {e['launches']} "
                  f"launches; {e['ms']:.4f} ms | plain {e['plain_ms']:.4f} "
                  f"ms | SDPA {e['library_ms']:.4f} ms | bound "
                  f"{e['bound_ms']:.4f} ms ({e['bound_by']}) | vs plain max "
                  f"abs err {e['max_abs_err']:.3e}")
        print(f"[ssm-time] flash at {key[1:5]}: error / derived bound "
              + ", ".join(f"{w} {r:.3f}" for w, r in ratios.items()))
        if not max(ratios.values()) <= 1.0:
            failures.append(f"flash at {key}: {ratios}")
        entries.extend(new)
    if not any(key[4] == 64 for key in flash_fwd_cuda.by_shape):
        failures.append("phase 16 launched no flash forward at hd = 64")
    lap("16c kernel entries")
    torch.cuda.empty_cache()
    print(f"[ssm] the SSM cores' share of the prefill (A14j): "
          + ", ".join(f"{k} {v:.1%}" for k, v in shares.items()))
    print(f"[ssm] phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return entries


def vl_positions(B: int, S: int, dev, prefix: int = VL_PREFIX,
                 grid: int = VL_GRID):
    """(3, B, S) M-RoPE position streams laid out as Qwen2-VL's vision
    frontend lays them out (arXiv:2409.12191 section 2.1): ``prefix``
    text tokens (t = h = w = i), a ``grid`` x ``grid`` patch grid (t at
    the prefix, h its row and w its column, both from the prefix), then
    text from the largest position + 1."""
    import torch
    i = torch.arange(S, device=dev)
    g = (i - prefix).clamp(0, grid * grid - 1)
    in_grid = (i >= prefix) & (i < prefix + grid * grid)
    text = torch.where(i < prefix, i, i - grid * grid + grid)
    t = torch.where(in_grid, prefix, text)
    h = torch.where(in_grid, prefix + g // grid, text)
    w = torch.where(in_grid, prefix + g % grid, text)
    return torch.stack([t, h, w])[:, None].expand(3, B, S).contiguous()


def encdec_phase(dev, args, failures):
    """Phase 17 (module docstring): Whisper-tiny (the encoder-decoder
    stack) and Qwen2-VL-72B (M-RoPE) at their published widths.  Returns
    the kernels-record entries of rmsnorm and the tensor-core flash
    kernels, one for each shape the phase launched them at."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import flash_attention as flash_module
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (flash_bwd_cuda,
                                                     flash_fwd_cuda)
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.models import (abstract_params, decode_step, forward,
                                    init_decode_state, init_params,
                                    prefill_cross_kv)
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import (Request, ServingEngine, TrainConfig,
                                   greedy_generate, loss_and_grads,
                                   make_train_step)
    from repro_torch.tree import leaves, leaves_with_paths

    t_phase = time.perf_counter()
    laps = [t_phase]
    gb = 1e9

    def lap(what):
        laps.append(time.perf_counter())
        print(f"[encdec] {what} took {laps[-1] - laps[-2]:.1f} s",
              flush=True)

    zero_counts, counts = lm_zero_counts, lm_counts

    def expect(what, got, want):
        lm_expect(failures, what, got, want)

    def plain_flash():
        """Every flash call through its plain version (the kernels'
        reference on the same card)."""
        stack = contextlib.ExitStack()
        off = lambda t, name: False  # noqa: E731
        stack.enter_context(mock.patch.object(flash_module, "on_card", off))
        stack.enter_context(mock.patch.object(ops, "_on_card", off))
        return stack

    def norms_of(cfg):
        return lm_norms(cfg) if cfg.norm == "rmsnorm" else 0

    def grads_vs_plain(params, cfg, batch, what):
        """loss_and_grads through the kernels against every flash call
        plain, leaf by leaf: (worst rel Frobenius, its leaf)."""
        loss_k, g_k = loss_and_grads(params, cfg, batch)
        with plain_flash():
            loss_p, g_p = loss_and_grads(params, cfg, batch)
        errs = {"/".join(map(str, path)): rel_fro(a, b) for (path, _), a, b
                in zip(leaves_with_paths(params), g_k, g_p)}
        worst = max(errs, key=errs.get)
        finite = all(bool(torch.isfinite(g).all()) for g in g_k)
        zero = [k for k, g in zip(errs, g_k) if not bool(g.abs().max() > 0)]
        print(f"[encdec-whisper] {what} loss_and_grads, the flash kernels "
              f"against every flash call plain: loss {float(loss_k):.6f} "
              f"vs {float(loss_p):.6f}; the {len(errs)} leaves' worst rel "
              f"Frobenius {errs[worst]:.3e} ({worst}); every gradient "
              f"finite: {finite}; zero leaves {zero}", flush=True)
        if not (finite and not zero):
            failures.append(f"Whisper {what} gradients: finite {finite}, "
                            f"zero leaves {zero}")
        return errs[worst], worst

    def engine(params, c, prompts):
        """ENC_REQUESTS requests on ENC_SLOTS slots, arriving at steps 0,
        6 and 12 (every slot reused): (requests, steps, seconds)."""
        reqs = [Request(rid=i, prompt=pr, max_new_tokens=ENC_NEW_TOKENS)
                for i, pr in enumerate(prompts)]
        eng = ServingEngine(params, c, n_slots=ENC_SLOTS,
                            max_seq=ENC_ENGINE_SEQ)
        arrivals = {0: reqs[:4], 6: reqs[4:6], 12: reqs[6:]}
        steps = 0
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        while steps < 1000:
            for r in arrivals.get(steps, []):
                eng.submit(r)
            if steps > max(arrivals) and not eng.pending and \
                    all(s is None for s in eng.slots):
                break
            eng.step()
            steps += 1
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        got = counts()
        n_gen = sum(len(r.generated) for r in reqs)
        done = all(r.done and len(r.generated) == ENC_NEW_TOKENS
                   and all(0 <= x < c.vocab_size for x in r.generated)
                   for r in reqs)
        print(f"[encdec-serve] {c.name} ServingEngine({c.dtype}, n_slots="
              f"{ENC_SLOTS}, max_seq={ENC_ENGINE_SEQ}"
              f"{', cross_kv zero' if c.encoder_layers else ''}): "
              f"{len(reqs)} requests, prompts {[len(p) for p in prompts]} "
              f"tokens, {ENC_NEW_TOKENS} new each; {steps} steps in "
              f"{t:.2f} s, {t / steps * 1e3:.2f} ms a step, "
              f"{n_gen / t:.1f} generated tokens/s; all finished: {done}; "
              f"launches {got}", flush=True)
        if not done:
            failures.append(f"the {c.name} {c.dtype} engine did not "
                            f"answer every request")
        expect(f"{c.name} {c.dtype} engine", got,
               (steps * norms_of(c), 0, 0, 0, 0))
        return reqs

    def each_alone(params, c, reqs):
        """Every f32 engine token against the request decoded alone by
        greedy_generate (Whisper: on a state with zero cross_kv, as the
        engine's)."""
        same = checked = 0
        for r in reqs:
            alone, _ = greedy_generate(params, c, init_decode_state(
                c, 1, ENC_ENGINE_SEQ, device=dev,
                with_encoder=bool(c.encoder_layers)), torch.tensor(
                [r.prompt], device=dev), ENC_NEW_TOKENS)
            alone = alone[0].tolist()
            checked += len(alone)
            same += sum(a == b for a, b in zip(r.generated, alone))
            if r.generated != alone:
                failures.append(f"{c.name} f32 request {r.rid}: the "
                                f"engine's {r.generated}, alone {alone}")
        print(f"[encdec-serve] {c.name} f32 engine against each request "
              f"decoded alone by greedy_generate: {same} of {checked} "
              f"tokens equal", flush=True)

    def prompts_of(gen, V):
        lens = torch.randint(8, 17, (ENC_REQUESTS,), generator=gen,
                             device=dev).tolist()
        return [torch.randint(0, V, (n,), generator=gen,
                              device=dev).tolist() for n in lens]

    def decode_run(params, cfg, state, tokens, steps):
        """A warm-up step, then ``steps`` timed teacher-forced steps:
        (logits of every step (B, 1 + steps, V), ms a step, launches of
        the timed steps)."""
        outs = []
        lg, state = decode_step(params, cfg, state, tokens[:, :1])
        outs.append(lg)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        for t in range(1, 1 + steps):
            lg, state = decode_step(params, cfg, state, tokens[:, t:t + 1])
            outs.append(lg)
        torch.cuda.synchronize()
        return (torch.stack(outs, 1),
                (time.perf_counter() - t0) / steps * 1e3, counts())

    rmsnorm_cuda.by_shape = {}
    flash_fwd_cuda.by_shape = {}
    flash_bwd_cuda.by_shape = {}
    torch.cuda.empty_cache()

    # ---- w. Whisper-tiny ----------------------------------------------------
    cfg = get_config("whisper_tiny")
    B, T, F = ENC_BATCH, ENC_TEXT, cfg.encoder_seq
    V, D = cfg.vocab_size, cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(args.seed + 19)
    params = init_params(gen, cfg, device=dev)
    n_par = sum(t.numel() for t in leaves(params))
    n_abs = sum(t.numel() for t in leaves(abstract_params(cfg)))
    print(f"[encdec-whisper] {cfg.name}: {cfg.encoder_layers} encoder and "
          f"{cfg.n_layers} decoder layers, d_model {D}, {cfg.n_heads} heads"
          f" x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {V} (tied), "
          f"{F} frames, {cfg.norm}, attn_impl {cfg.attn_impl}, causal "
          f"encoder {cfg.causal} (as the reference: ROADMAP C): {n_par} f32 "
          f"params ({n_par * 4 / gb:.3f} GB; the JAX abstract_params count "
          f"{WHISPER_LEAVES}, param_count {cfg.param_count()})", flush=True)
    if not n_par == n_abs == WHISPER_LEAVES:
        failures.append(f"{cfg.name}: {n_par} params, abstract_params "
                        f"{n_abs}, JAX {WHISPER_LEAVES}")
    frames = torch.randn((B, F, D), generator=gen, device=dev)
    tokens = torch.randint(0, V, (B, T), generator=gen, device=dev)
    busy, n_k, top = device_profile(
        lambda: forward(params, cfg, tokens, audio_embed=frames), 1)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    logits = forward(params, cfg, tokens, audio_embed=frames)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    got = counts()
    ok = bool(torch.isfinite(logits).all()) and logits.shape == (B, T, V)
    ref = logits[:, :1 + ENC_DECODE_STEPS].clone()
    del logits
    idle = ("not measured" if busy is None
            else f"{1 - busy / (t_prefill * 1e3):.1%}")
    print(f"[encdec-whisper-prefill] forward B={B}, {F} frames and {T} "
          f"tokens, bf16: {t_prefill * 1e3:.1f} ms, {B * T / t_prefill:.0f}"
          f" decoder tokens/s ({B * (F + T) / t_prefill:.0f} positions/s);"
          f" device busy "
          f"{'not measured' if busy is None else f'{busy:.2f} ms'}, idle "
          f"share {idle}, {n_k:g} kernel launches (the warm-up forward "
          f"profiled); peak {torch.cuda.max_memory_allocated() / gb:.2f} "
          f"GB; logits finite and shaped: {ok}; launches {got} (layernorm "
          f"and naive attention are plain: none expected)", flush=True)
    for name, ms, n in top:
        print(f"[encdec-profile]   {ms:8.3f} ms  x{n:g}  {name}")
    if not ok:
        failures.append("Whisper prefill logits not finite or misshapen")
    expect("Whisper prefill", got, (0, 0, 0, 0, 0))
    lap("17w whisper init and prefill")

    # decode over the encoder's keys and values, teacher-forced
    t0 = time.perf_counter()
    state = init_decode_state(cfg, B, 1 + ENC_DECODE_STEPS, device=dev,
                              with_encoder=True)
    state["cross_kv"] = prefill_cross_kv(params, cfg, frames)
    torch.cuda.synchronize()
    t_cross = time.perf_counter() - t0
    dec, t_dec, got = decode_run(params, cfg, state, tokens,
                                 ENC_DECODE_STEPS)
    e_dec = rel_fro(dec, ref)
    print(f"[encdec-whisper-decode] prefill_cross_kv (the encoder over "
          f"{B} x {F} frames, {cfg.n_layers} (k, v) pairs) "
          f"{t_cross * 1e3:.1f} ms; {ENC_DECODE_STEPS} decode steps (B={B})"
          f": {t_dec:.2f} ms a step; the {1 + ENC_DECODE_STEPS} "
          f"teacher-forced steps' logits against the prefill's: rel "
          f"Frobenius {e_dec:.3e} (bound {TOL_LM_BF16}); launches {got}",
          flush=True)
    if not e_dec <= TOL_LM_BF16:
        failures.append(f"Whisper bf16 decode vs prefill {e_dec:.3e}")
    expect("Whisper decode", got, (0, 0, 0, 0, 0))
    del state, dec, ref
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    prompt = tokens[:2, :ENC_F32_PROMPT].contiguous()
    ref = forward(params, cfg32, prompt, audio_embed=frames[:2])
    state = init_decode_state(cfg32, 2, ENC_F32_PROMPT, device=dev,
                              with_encoder=True)
    state["cross_kv"] = prefill_cross_kv(params, cfg32, frames[:2])
    dec, _, _ = decode_run(params, cfg32, state, prompt,
                           ENC_F32_PROMPT - 1)
    e32 = rel_fro(dec, ref)
    print(f"[encdec-whisper-decode] f32: {ENC_F32_PROMPT} teacher-forced "
          f"decode steps of 2 rows against the f32 prefill: rel Frobenius "
          f"{e32:.3e} (bound {TOL_LM_F32})", flush=True)
    if not e32 <= TOL_LM_F32:
        failures.append(f"Whisper f32 decode vs prefill {e32:.3e}")
    del state, dec, ref
    lap("17w whisper decode")

    prompts = prompts_of(gen, V)
    engine(params, cfg, prompts)
    each_alone(params, cfg32, engine(params, cfg32, prompts))
    lap("17w whisper engines")

    # training at full depth: tokens with their frames
    pipe = TokenPipeline(vocab_size=V, seq_len=T, global_batch=B,
                         seed=args.seed)
    acfg = AdamWConfig(lr=LM_TRAIN_LR, warmup_steps=0,
                       total_steps=ENC_TRAIN_STEPS)
    step_fn = make_train_step(cfg, acfg, TrainConfig(
        microbatches=ENC_MICROBATCHES))
    opt = adamw_init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times, losses = [], []
    # one batch every step: the falling loss then reads the update, not
    # the spread between batches (at d_model 384 one update at lr 3e-5
    # moves the loss by less than two batches of 4 x 448 tokens differ)
    batch = dict(pipe.batch(0), audio_embed=torch.randn(
        (B, F, D), generator=gen, device=dev))
    for s in range(ENC_TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    got = counts()
    print(f"[encdec-train] {cfg.name} full depth: {ENC_TRAIN_STEPS} AdamW "
          f"steps (lr {LM_TRAIN_LR}) on one batch of {B} x {T} tokens with "
          f"their {F} frames in {ENC_MICROBATCHES} microbatches, bf16 "
          f"remat: losses "
          f"{losses}; step walls "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms, "
          f"{B * T / min(times):.0f} training tokens/s at the fastest; "
          f"device memory peak {torch.cuda.max_memory_allocated() / gb:.2f}"
          f" GB; launches {got}", flush=True)
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        failures.append(f"Whisper training losses {losses}")
    expect("Whisper training", got, (0, 0, 0, 0, 0))
    del opt, step_fn
    lap("17w whisper training")

    # flash: refused at the published frames, then at ENC_FLASH_FRAMES
    fcfg = dataclasses.replace(cfg, attn_impl="flash")
    zero_counts()
    try:
        forward(params, fcfg, tokens[:1, :ENC_FLASH_TEXT],
                audio_embed=frames[:1])
        failures.append(f"Whisper flash at {F} frames was not refused")
        refused = "nothing"
    except ValueError as e:
        refused = str(e)
    print(f"[encdec-whisper-flash] attn_impl flash at {F} frames: "
          f"ValueError {refused!r}; launches {counts()} (none expected)",
          flush=True)
    expect(f"Whisper flash at {F} frames", counts(), (0, 0, 0, 0, 0))
    L = cfg.encoder_layers + cfg.n_layers
    w_bh, w_hd = B * cfg.n_heads, cfg.head_dim
    ff = torch.randn((B, ENC_FLASH_FRAMES, D), generator=gen, device=dev)
    ft = tokens[:, :ENC_FLASH_TEXT].contiguous()
    zero_counts()
    lg_k = forward(params, fcfg, ft, audio_embed=ff)
    got = counts()
    with plain_flash():
        lg_p = forward(params, fcfg, ft, audio_embed=ff)
    e_b = rel_fro(lg_k, lg_p)
    fcfg32 = dataclasses.replace(fcfg, dtype="float32")
    zero_counts()
    lg_k32 = forward(params, fcfg32, ft, audio_embed=ff)
    got32 = counts()
    with plain_flash():
        lg_p32 = forward(params, fcfg32, ft, audio_embed=ff)
    e_f = rel_fro(lg_k32, lg_p32)
    print(f"[encdec-whisper-flash] {ENC_FLASH_FRAMES} frames (six blocks "
          f"of 256) and {ENC_FLASH_TEXT} tokens, B={B}: the forward with "
          f"the kernels against every flash call plain, rel Frobenius bf16"
          f" {e_b:.3e} (bound {TOL_LM_BF16}; launches {got}), f32 "
          f"{e_f:.3e} (bound {TOL_LM_F32}; launches {got32})", flush=True)
    if not (e_b <= TOL_LM_BF16 and e_f <= TOL_LM_F32):
        failures.append(f"Whisper flash vs plain: bf16 {e_b:.3e}, f32 "
                        f"{e_f:.3e}")
    expect("Whisper bf16 flash forward", got, (0, L, 0, 0, 0))
    expect("Whisper f32 flash forward", got32, (0, 0, 0, 0, L))
    del lg_k, lg_p, lg_k32, lg_p32
    gb_ = {"tokens": ft, "labels": ft.roll(-1, 1), "audio_embed": ff}
    zero_counts()
    w32, leaf32 = grads_vs_plain(params, fcfg32, gb_, "f32")
    got32 = counts()
    zero_counts()
    w16, leaf16 = grads_vs_plain(params, fcfg, gb_, "bf16")
    got = counts()
    print(f"[encdec-whisper-flash] gradients: f32 through the FP32-FMA "
          f"kernels {w32:.3e} ({leaf32}; bound {TOL_GRAD_F32}; launches "
          f"{got32}), bf16 through the tensor-core kernels {w16:.3e} "
          f"({leaf16}; bound {TOL_GRAD_BF16}; launches {got})", flush=True)
    if not (w32 <= TOL_GRAD_F32 and w16 <= TOL_GRAD_BF16):
        failures.append(f"Whisper flash gradients vs plain: f32 {w32:.3e} "
                        f"({leaf32}), bf16 {w16:.3e} ({leaf16})")
    # remat: a layer's forward again in the backward's recompute
    expect("Whisper f32 flash gradient", got32, (0, 0, 0, 0, 4 * L))
    expect("Whisper bf16 flash gradient", got, (0, 2 * L, L, L, 0))
    del params, frames, tokens, ff, ft, gb_
    torch.cuda.empty_cache()
    lap("17w whisper flash")

    # ---- v. Qwen2-VL-72B, depth cut --------------------------------------
    full = get_config("qwen2_vl_72b")
    n_full = sum(t.numel() for t in leaves(abstract_params(full)))
    cfg = dataclasses.replace(full, n_layers=VL_SERVE_LAYERS,
                              attn_impl="flash")
    B, S, V = VL_BATCH, VL_SEQ, cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(args.seed + 20)
    t0 = time.perf_counter()
    params = init_params(gen, cfg, device=dev)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in leaves(params))
    p_bytes = torch.cuda.memory_allocated()
    print(f"[encdec-qwen2vl] {full.name}: d_model {cfg.d_model}, "
          f"{cfg.n_heads} / {cfg.n_kv_heads} heads x {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {V} (untied), M-RoPE sections "
          f"{cfg.mrope_sections}, theta {cfg.rope_theta:g}; depth cut "
          f"{full.n_layers} -> {VL_SERVE_LAYERS} ({n_full} params at full "
          f"depth, {n_full * 4 / gb:.1f} GB of f32; the JAX count "
          f"{VL_LEAVES[full.n_layers]}): {n_par} f32 params "
          f"({p_bytes / gb:.2f} GB allocated; JAX "
          f"{VL_LEAVES[VL_SERVE_LAYERS]}) drawn in {time.perf_counter() - t0:.1f} s", flush=True)
    if not (n_full == VL_LEAVES[full.n_layers]
            and n_par == VL_LEAVES[VL_SERVE_LAYERS]):
        failures.append(f"Qwen2-VL params {n_full} / {n_par}, JAX "
                        f"{VL_LEAVES}")
    tokens = torch.randint(0, V, (B, S), generator=gen, device=dev)
    pos = vl_positions(B, S, dev)
    norms = norms_of(cfg)
    busy, n_k, top = device_profile(
        lambda: forward(params, cfg, tokens, positions=pos), 1)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    logits = forward(params, cfg, tokens, positions=pos)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    got = counts()
    ok = bool(torch.isfinite(logits).all()) and logits.shape == (B, S, V)
    idle = ("not measured" if busy is None
            else f"{1 - busy / (t_prefill * 1e3):.1%}")
    print(f"[encdec-qwen2vl-prefill] forward B={B} S={S} bf16, streams: "
          f"{VL_PREFIX} text, a {VL_GRID} x {VL_GRID} patch grid, text from "
          f"position {int(pos[0, 0, VL_PREFIX + VL_GRID ** 2])}: "
          f"{t_prefill * 1e3:.1f} ms, {B * S / t_prefill:.0f} tokens/s; "
          f"device busy "
          f"{'not measured' if busy is None else f'{busy:.2f} ms'}, idle "
          f"share {idle}, {n_k:g} kernel launches (the warm-up forward "
          f"profiled); peak {torch.cuda.max_memory_allocated() / gb:.2f} "
          f"GB; logits finite and shaped: {ok}; launches {got}", flush=True)
    for name, ms, n in top:
        print(f"[encdec-profile]   {ms:8.3f} ms  x{n:g}  {name}")
    if not ok:
        failures.append("Qwen2-VL prefill logits not finite or misshapen")
    expect("Qwen2-VL prefill", got, (norms, VL_SERVE_LAYERS, 0, 0, 0))
    # M-RoPE acts: against the same prefill with the three streams equal
    aligned = forward(params, cfg, tokens)
    e_pre = rel_fro(logits[:, :VL_PREFIX], aligned[:, :VL_PREFIX])
    e_after = rel_fro(logits[:, VL_PREFIX:], aligned[:, VL_PREFIX:])
    print(f"[encdec-qwen2vl-prefill] against the aligned streams (t, t, t):"
          f" the text prefix rel Frobenius {e_pre:.3e} (the streams agree "
          f"there), every position after it {e_after:.3e} (must exceed "
          f"{TOL_LM_BF16}: M-RoPE acts)", flush=True)
    if not e_after > TOL_LM_BF16:
        failures.append(f"Qwen2-VL logits after the grid {e_after:.3e} "
                        f"from the aligned streams'")
    del logits
    lap("17v qwen2-vl init and prefill")

    ref = aligned[:, :1 + VL_DECODE_STEPS].clone()
    del aligned
    state = init_decode_state(cfg, B, 1 + VL_DECODE_STEPS, device=dev)
    dec, t_dec, got = decode_run(params, cfg, state, tokens,
                                 VL_DECODE_STEPS)
    e_dec = rel_fro(dec, ref)
    print(f"[encdec-qwen2vl-decode] {VL_DECODE_STEPS} decode steps (B={B},"
          f" (t, t, t) streams as the reference decodes): {t_dec:.2f} ms a "
          f"step; the {1 + VL_DECODE_STEPS} teacher-forced steps' logits "
          f"against the aligned-stream prefill's: rel Frobenius "
          f"{e_dec:.3e} (bound {TOL_LM_BF16}); launches {got}", flush=True)
    if not e_dec <= TOL_LM_BF16:
        failures.append(f"Qwen2-VL bf16 decode vs prefill {e_dec:.3e}")
    expect("Qwen2-VL decode", got, (VL_DECODE_STEPS * norms, 0, 0, 0, 0))
    del state, dec, ref
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    each_alone(params, cfg32, engine(params, cfg32, prompts_of(gen, V)))
    print(f"[encdec-qwen2vl] serving peak "
          f"{torch.cuda.max_memory_allocated() / gb:.2f} GB (the params "
          f"{p_bytes / gb:.2f} GB)", flush=True)
    lap("17v qwen2-vl decode and f32 engine")

    # training at VL_TRAIN_LAYERS layers, the vision streams in the batch
    del params["blocks"][VL_TRAIN_LAYERS:]
    torch.cuda.empty_cache()
    short = dataclasses.replace(cfg, n_layers=VL_TRAIN_LAYERS)
    pipe = TokenPipeline(vocab_size=V, seq_len=S,
                         global_batch=VL_TRAIN_BATCH, seed=args.seed)
    acfg = AdamWConfig(lr=VL_TRAIN_LR, warmup_steps=0,
                       total_steps=ENC_TRAIN_STEPS)
    step_fn = make_train_step(short, acfg, TrainConfig(
        microbatches=ENC_MICROBATCHES))
    opt = adamw_init(params)
    n_train = sum(t.numel() for t in leaves(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times, losses = [], []
    batch = dict(pipe.batch(0), positions=vl_positions(VL_TRAIN_BATCH, S,
                                                       dev))
    for s in range(ENC_TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    got = counts()
    peak = torch.cuda.max_memory_allocated()
    nm = ENC_TRAIN_STEPS * ENC_MICROBATCHES
    Lt = VL_TRAIN_LAYERS
    want = (nm * (2 * norms_of(short) - 1), nm * 2 * Lt, nm * Lt, nm * Lt,
            0)
    print(f"[encdec-train] {full.name} depth {Lt}: {ENC_TRAIN_STEPS} AdamW"
          f" steps (lr {VL_TRAIN_LR}) on one batch of {VL_TRAIN_BATCH} x "
          f"{S} tokens with"
          f" the (3, B, S) vision streams in {ENC_MICROBATCHES} "
          f"microbatches (split on the batch axis), bf16 remat ({n_train} "
          f"params, {4 * n_train * 4 / gb:.1f} GB with gradient and "
          f"moments): losses {losses}; step walls "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms, "
          f"{VL_TRAIN_BATCH * S / min(times):.0f} training tokens/s at the "
          f"fastest; device memory peak {peak / gb:.2f} GB (limit "
          f"{VL_PEAK_BYTES / gb:.0f}); launches {got} (expected {want})",
          flush=True)
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        failures.append(f"Qwen2-VL training losses {losses}")
    if peak > VL_PEAK_BYTES:
        failures.append(f"Qwen2-VL training peak {peak / gb:.2f} GB")
    expect("Qwen2-VL training", got, want)
    del opt, step_fn, params, tokens, pos
    torch.cuda.empty_cache()
    lap("17v qwen2-vl training")

    # ---- the kernels at every shape the phase launched them at ----------
    gen_k = torch.Generator(device=dev).manual_seed(args.seed + 21)
    entries = []
    for key, n in sorted(rmsnorm_cuda.by_shape.items()):
        rows, d, dt = key
        entry, ratio = _lmd_rmsnorm_entry(key, n, ["phase 17"], gen_k, dev,
                                          name=f"rmsnorm_vl_{rows}x{d}_{dt}")
        print(f"[encdec-time] rmsnorm {key}: {n} launches; "
              f"{entry['ms']:.4f} ms | plain {entry['plain_ms']:.4f} ms | "
              f"F.rms_norm {entry['library_ms']:.4f} ms | bound "
              f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}) | vs plain"
              f" max abs err {entry['max_abs_err']:.3e} ({ratio:.2f}x "
              f"tolerance)")
        if not (ratio <= 1.0 and d == cfg.d_model):
            failures.append(f"rmsnorm {key}: {ratio:.2f}x its tolerance "
                            f"(phase 17 launches it at D = {cfg.d_model} "
                            f"only)")
        entries.append(entry)
    fma = [key for key in flash_fwd_cuda.by_shape if key[0] != "wgmma"]
    print(f"[encdec-time] the FP32-FMA flash shapes (f32 checks, held by "
          f"the f32 forward and gradient above): {sorted(fma)}")
    want_keys = {(w_bh, ENC_FLASH_FRAMES, w_hd), (w_bh, ENC_FLASH_TEXT, w_hd),
                 (B * cfg.n_heads, S, cfg.head_dim),
                 (VL_TRAIN_BATCH // ENC_MICROBATCHES * cfg.n_heads, S,
                  cfg.head_dim)}
    seen = set()
    for key, n in sorted(flash_fwd_cuda.by_shape.items()):
        if key[0] != "wgmma":
            continue
        seen.add((key[1], key[2], key[4]))
        n_bwd = flash_bwd_cuda.by_shape.get(key, 0)
        new, ratios = _lmd_flash_entries(key, n, n_bwd, ["phase 17"], gen_k,
                                         dev, tag=f"encdec_s{key[2]}")
        if not n_bwd:           # a prefill shape: dq and dkv checked only
            new = new[:1]
        for e in new:
            print(f"[encdec-time] {e['name']} {e['shape']}: "
                  f"{e['launches']} launches; {e['ms']:.4f} ms | plain "
                  f"{e['plain_ms']:.4f} ms | SDPA {e['library_ms']:.4f} ms "
                  f"| bound {e['bound_ms']:.4f} ms ({e['bound_by']}) | vs "
                  f"plain max abs err {e['max_abs_err']:.3e}")
        print(f"[encdec-time] flash at {key[1:5]}: error / derived bound "
              + ", ".join(f"{w} {r:.3f}" for w, r in ratios.items()))
        if not max(ratios.values()) <= 1.0:
            failures.append(f"flash at {key}: {ratios}")
        entries.extend(new)
    if seen != want_keys:
        failures.append(f"phase 17 launched the tensor-core flash at "
                        f"{sorted(seen)}, not {sorted(want_keys)}")
    lap("17 kernel entries")
    torch.cuda.empty_cache()
    print(f"[encdec] phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return entries


# phase 19: its time budget on the card host (the ISSUE's 20 s)
ANALYSIS_PHASE_S = 20.0
ANALYSIS_PREFILL = (4, 1024)          # phase 19c's prefill, batch x tokens
ALLOCATOR_SLACK = 1 << 20             # bytes a tensor's block may exceed it


def analysis_phase(dev, args, failures):
    """Phase 19 (module docstring): the static analysis with the registry
    launching on the card, one dry-run cell at both production meshes,
    and the dry run's bytes and FLOPs held against the card."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import analysis
    from repro_torch.analysis import kernel_check, registry
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import forward
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.sharding import MeshRules
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()

    # ---- 19a. the analysis, the kernels launched on the card -----------
    calls = registry.capture_entry_points(launch=True)
    limit = kernel_check.smem_limit()
    print(f"[analysis] {len(calls)} launches of "
          f"{len({c.symbol for c in calls})} C entry points; opt-in shared "
          f"memory limit {limit} B a block")
    for c in calls:
        for k, rec in enumerate(c.launches or ()):
            print(f"[analysis]   {c.entry:30s} {c.symbol:28s} #{k} grid "
                  f"{rec['grid']} block {rec['block']} smem {rec['smem']} "
                  f"/ {limit} B")
        if not c.launches:
            failures.append(f"19a: {c.entry} {c.symbol} noted no launch")
    sites = {s.symbol for s in registry.discover_sites()}
    if {c.symbol for c in calls} != sites:
        failures.append(f"19a: sites not reached: "
                        f"{sorted(sites - {c.symbol for c in calls})}")
    orig = kernel_check.capture_entry_points
    kernel_check.capture_entry_points = lambda: calls
    try:
        found = analysis.run_all()
    finally:
        kernel_check.capture_entry_points = orig
    active = [f for f in found if not f.suppressed]
    print(f"[analysis] run_all: {len(found)} findings, "
          f"{len(found) - len(active)} suppressed, {len(active)} active")
    for f in active:
        print(f"[analysis] FINDING {f.format()}")
        failures.append(f"19a: {f.check} {f.path}:{f.line}")
    print(f"[analysis] 19a took {time.perf_counter() - t_phase:.1f} s")

    # ---- 19b. one dry-run cell at both production meshes ---------------
    t0 = time.perf_counter()
    for multi_pod in (False, True):
        r = dryrun.run_cell("qwen3_1p7b", "train_4k", multi_pod)
        if r["status"] != "ok":
            failures.append(f"19b: {r['mesh']}: {r}")
            continue
        print(f"[dryrun] qwen3_1p7b x train_4k ({r['mesh']}): keys "
              f"{sorted(r)}")
        print(f"[dryrun]   flops {r['hlo_flops_per_device']:.4g} (kernels "
              f"{r['kernel_flops_per_device']:.4g}), bytes "
              f"{r['hlo_bytes_per_device']:.4g}, collective bytes "
              f"{r['collective_bytes']}, t_compute {r['t_compute']:.4g} s, "
              f"t_memory {r['t_memory']:.4g} s, t_collective "
              f"{r['t_collective']:.4g} s, bottleneck {r['bottleneck']}, "
              f"roofline_fraction {r['roofline_fraction']:.4g}, "
              f"useful_flop_ratio {r['useful_flop_ratio']:.4g}, memory "
              f"{r['memory_analysis']}")
    print(f"[dryrun] 19b took {time.perf_counter() - t0:.1f} s")

    # ---- 19c. the dry run's accounting against the card ----------------
    t0 = time.perf_counter()
    cfg = dryrun.production_cfg(get_config("qwen3_1p7b"), "prefill_32k")
    rules = MeshRules(Mesh((1, 1)))
    want = (specs.chunk_bytes(specs.param_specs(cfg, rules))
            + specs.chunk_bytes(specs.opt_specs(cfg, rules)))
    torch.cuda.synchronize()

    def requested():
        return torch.cuda.memory_stats(dev)["requested_bytes.all.current"]

    before = (torch.cuda.memory_allocated(dev), requested())
    params = specs.local_tree(specs.param_specs(cfg, rules), dev)
    opt = specs.local_tree(specs.opt_specs(cfg, rules), dev)
    made = torch.cuda.memory_allocated(dev) - before[0]
    asked = requested() - before[1]
    n_alloc = len(leaves(params)) + len(leaves(opt))
    print(f"[dryrun] 19c argument bytes: specs {want} B; the card's "
          f"allocator: {asked} B requested, {made} B allocated "
          f"({n_alloc} tensors; the 4-byte step lives on the host in the "
          f"step, on the card here)")
    # the allocator rounds a request up to 512 B, and hands a request of
    # more than 1 MiB a cached block unsplit when less than 1 MiB would
    # be left over (ALLOCATOR_SLACK a tensor)
    if asked != want or not 0 <= made - want <= ALLOCATOR_SLACK * n_alloc:
        failures.append(f"19c: argument bytes {want} vs the card's "
                        f"{asked} requested, {made} allocated")
    del opt
    for t in leaves(params):
        t.normal_(0.0, 0.02)
    B, S_ = ANALYSIS_PREFILL
    shape = ShapeConfig("prefill_4x1024", S_, B, "prefill")
    meta = dryrun.measure(cfg, shape, rules)["costs"]
    tokens = torch.randint(0, cfg.vocab_size, (B, S_), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(args.seed))
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        logits = forward(params, cfg, tokens, rules=rules)
    torch.cuda.synchronize()
    card = fc.get_total_flops()
    print(f"[dryrun] 19c prefill {B} x {S_}: dispatched FLOPs on meta "
          f"{meta[('flops',)]:.6g}, on the card {card:.6g}; kernels by "
          f"formula {meta[('kernel_flops',)]:.6g} FLOPs, "
          f"{meta[('kernel_bytes',)]:.6g} B")
    if meta[("flops",)] != card:
        failures.append(f"19c: meta FLOPs {meta[('flops',)]} vs card "
                        f"{card}")
    if not torch.isfinite(logits).all():
        failures.append("19c: the card prefill's logits are not finite")
    del params, logits
    torch.cuda.empty_cache()
    print(f"[dryrun] 19c took {time.perf_counter() - t0:.1f} s")
    took = time.perf_counter() - t_phase
    print(f"[analysis] phase 19 took {took:.1f} s (budget "
          f"{ANALYSIS_PHASE_S:.0f} s)")
    if took > ANALYSIS_PHASE_S:
        failures.append(f"phase 19 took {took:.1f} s, over its "
                        f"{ANALYSIS_PHASE_S:.0f} s")


def mark(t_main: float, phase: str) -> None:
    """A line when a phase ends: the run's seconds so far (the contract's
    limit is on the whole run)."""
    print(f"[smoke] {phase} ended at {time.perf_counter() - t_main:.1f} s",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--svm-iters", type=int, default=4096)
    ap.add_argument("--krr-iters", type=int, default=2048)
    args = ap.parse_args(argv)
    t_main = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device is available; this script runs only "
                    "on the card")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        return fail(f"the port's sources are not at {src / 'repro_torch'}")
    sys.path.insert(0, str(src))

    from repro_torch.api import KernelRidge, KernelSVM, SolverOptions
    from repro_torch.core import (ExactGramOperator, KernelConfig,
                                  krr_predict, krr_rel_residual_op,
                                  ksvm_duality_gap, ksvm_predict,
                                  make_dcd_round_fn,
                                  make_sstep_bdcd_round_fn,
                                  make_sstep_dcd_round_fn, pad_rounds,
                                  sstep_bdcd_inner, sstep_dcd_inner)
    from repro_torch.core.loop import FAST_RUN, RoundGraphs
    from repro_torch.data.synthetic import (PAPER_DATASETS,
                                            classification_dataset,
                                            regression_dataset)
    from repro_torch.kernels import build
    from repro_torch.kernels._launch import check_inputs, sm_count
    from repro_torch.kernels.gram import gram_cuda, gram_plain, gram_splits
    from repro_torch.kernels.kmv import kmv_cuda, kmv_plain, kmv_plan
    from repro_torch.kernels.kmv import launch as kmv_launch

    # full-f32 products everywhere the plain versions meet the kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    failures = []
    print(f"device: {torch.cuda.get_device_name(0)}  torch "
          f"{torch.__version__}  cuda {torch.version.cuda}")

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    info = build.build_all()
    for entry in build.SIGNATURES:
        build.launcher(entry)
    print(f"[build] {time.perf_counter() - t0:.1f} s total")
    for name, rec in info.items():
        print(f"[build] {name}: {rec['seconds']:.1f} s -> {rec['path']}")
        for line in rec["log"].splitlines():
            if any(w in line for w in ("registers", "spill", "warning")):
                print(f"[build]   {line.strip()}")
    for lib, kernel in WGMMA_LIBS.items():
        kernels = build.sass_counts(lib)
        for name, ops in kernels.items():
            print(f"[build] SASS {lib}: {name}: HGMMA x{ops['HGMMA']}, "
                  f"UTMALDG x{ops['UTMALDG']}")
            if not (ops["HGMMA"] and ops["UTMALDG"]):
                failures.append(f"{lib}: {name} lacks HGMMA or UTMALDG")
        if not any(kernel in name for name in kernels):
            failures.append(f"{lib}: no {kernel} in its SASS")
    if failures:
        return fail("; ".join(failures))

    # ---- data at the news20-like shape ------------------------------------
    spec = PAPER_DATASETS["news20-like"]
    m, n, q = spec["m"], spec["n"], 2048
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    A_all, y_all = classification_dataset(gen, m + q, n, device=dev)
    A, y = A_all[:m].contiguous(), y_all[:m].contiguous()
    Aq, yq = A_all[m:].contiguous(), y_all[m:].contiguous()
    del A_all, y_all
    print(f"[data] K-SVM: A {tuple(A.shape)} f32 "
          f"({A.numel() * 4 / 1e6:.0f} MB), {q} held-out queries")

    # ---- 2. kernel parity -------------------------------------------------
    kernels = {"linear": KernelConfig("linear"),
               "polynomial": KernelConfig("polynomial", degree=3,
                                          coef0=1.0),
               "rbf": KernelConfig("rbf", sigma=1.0)}
    pick = torch.randperm(m, generator=gen, device=dev)
    B_of = {"r1": A[pick[:1]].contiguous(),
            "r32": A[pick[:32]].contiguous(),
            "r256": A[pick[:256]].contiguous(),
            "B=A": A, "q1024": Aq[:1024].contiguous()}
    Xv = torch.randn(m, generator=gen, device=dev)
    Xm = torch.randn((m, 4), generator=gen, device=dev)
    A16 = A.to(torch.bfloat16)
    # the classical round's 1 x 1 block, the K-SVM round's 32 x 32, the
    # K-RR round's 256 x 256 and the materialized slab's m x 32
    gram_blocks = {"1x1": (B_of["r32"][:1], B_of["r32"][1:2]),
                   "32x32": (B_of["r32"], B_of["r32"]),
                   "256x256": (B_of["r256"], B_of["r256"]),
                   "mx32": (A, B_of["r32"])}
    err_at = {}
    t0 = time.perf_counter()
    for kname, cfg in kernels.items():
        poly = kname == "polynomial"
        for dtype in (torch.float32, torch.bfloat16):
            tol = TOL_KMV_F32 if dtype == torch.float32 else TOL_BF16
            Ad = A if dtype == torch.float32 else A16
            for bname, B in B_of.items():
                Bd = Ad if bname == "B=A" else B.to(dtype)
                for xname, X in (("vec", Xv), ("mat4", Xm)):
                    got = kmv_cuda(Ad, Bd, X, cfg)
                    want = kmv_plain(Ad, Bd, X, cfg)
                    ratio, err = allclose_ratio(got, want, tol, poly)
                    err_at[("kmv", kname, str(dtype), bname, xname)] = err
                    if not ratio <= 1.0 or got.shape != want.shape:
                        failures.append(
                            f"kmv {kname} {dtype} {bname} {xname}: max "
                            f"abs err {err:.3e} ({ratio:.2f}x tolerance)")
                    # fixed-order sums, no atomics: the same bits again
                    if not torch.equal(got, kmv_cuda(Ad, Bd, X, cfg)):
                        failures.append(f"kmv {kname} {dtype} {bname} "
                                        f"{xname}: a second call gave "
                                        f"other bits")
                if dtype == torch.float32:
                    # each regime with its last m split left out of the
                    # partial grid and the reduce must fail the check
                    plan = kmv_plan(m, Bd.shape[0], 1, sm_count(0),
                                    Bd is Ad)
                    bad = kmv_launch(Ad, Bd, Xv[:, None].contiguous(), cfg,
                                     plan._replace(splits=plan.splits - 1),
                                     check_inputs("kmv", Ad, Bd))[:, 0]
                    ratio, err = allclose_ratio(bad, kmv_plain(Ad, Bd, Xv,
                                                               cfg),
                                                tol, poly)
                    err_at[("kmv-wrong", kname, bname)] = (err, ratio,
                                                           plan.regime)
                    if ratio <= 1.0:
                        failures.append(f"kmv check passes a wrong kernel "
                                        f"({kname} {bname}, {plan.regime}, "
                                        f"last split left out: "
                                        f"{ratio:.2f}x)")
            tol = TOL_GRAM_F32 if dtype == torch.float32 else TOL_BF16
            for gname, (G1, G2) in gram_blocks.items():
                G1d, G2d = G1.to(dtype), G2.to(dtype)
                got = gram_cuda(G1d, G2d, cfg)
                want = gram_plain(G1d, G2d, cfg)
                ratio, err = allclose_ratio(got, want, tol, poly)
                err_at[("gram", kname, str(dtype), gname)] = err
                if not ratio <= 1.0:
                    failures.append(f"gram {kname} {dtype} {gname}: max "
                                    f"abs err {err:.3e} ({ratio:.2f}x "
                                    f"tolerance)")
                # fixed-order sums, no atomics: the same bits again
                if not torch.equal(got, gram_cuda(G1d, G2d, cfg)):
                    failures.append(f"gram {kname} {dtype} {gname}: a "
                                    f"second call gave other bits")
                if dtype == torch.float32 and gname != "mx32":
                    # the last feature split left out of the reduce must
                    # fail the check
                    bm, br, splits, per = gram_splits(
                        G1d.shape[0], G2d.shape[0], n, sm_count(0))
                    bad = gram_direct(G1d, G2d, cfg, bm, br, splits - 1, per)
                    ratio, err = allclose_ratio(bad, want, tol, poly)
                    err_at[("gram-wrong", kname, gname)] = (err, ratio)
                    if ratio <= 1.0:
                        failures.append(f"gram check passes a wrong kernel "
                                        f"({kname} {gname}, last split "
                                        f"left out: {ratio:.2f}x)")
    torch.cuda.synchronize()
    del A16
    n_cmp = sum(k[0] not in ("gram-wrong", "kmv-wrong") for k in err_at)
    print(f"[parity] {n_cmp} comparisons in "
          f"{time.perf_counter() - t0:.1f} s; tolerances: KMV f32 "
          f"{TOL_KMV_F32}, gram f32 {TOL_GRAM_F32}, bf16 {TOL_BF16}, "
          f"polynomial relative to max |output|")
    for key in (("kmv", "rbf", "torch.float32", "r1", "vec"),
                ("kmv", "rbf", "torch.float32", "r32", "vec"),
                ("kmv", "rbf", "torch.float32", "B=A", "vec"),
                ("kmv", "polynomial", "torch.float32", "B=A", "mat4"),
                ("kmv", "rbf", "torch.bfloat16", "q1024", "mat4"),
                ("gram", "rbf", "torch.float32", "1x1"),
                ("gram", "rbf", "torch.float32", "32x32"),
                ("gram", "rbf", "torch.float32", "256x256"),
                ("gram", "linear", "torch.float32", "mx32")):
        print(f"[parity] {' '.join(key)}: max abs err {err_at[key]:.3e}")
    for key, (err, ratio, regime) in ((k, v) for k, v in err_at.items()
                                      if k[0] == "kmv-wrong"):
        print(f"[parity] kmv {key[1]} {key[2]} ({regime}) with the last m "
              f"split left out of the reduce: max abs err {err:.3e} "
              f"({ratio:.1f}x tolerance; must fail)")
    for key, (err, ratio) in ((k, v) for k, v in err_at.items()
                              if k[0] == "gram-wrong"):
        print(f"[parity] gram {key[1]} {key[2]} with the last feature split "
              f"left out of the reduce: max abs err {err:.3e} ({ratio:.1f}x "
              f"tolerance; must fail)")
    if failures:
        for f in failures:
            print(f"[parity] FAIL {f}")
        return fail(f"{len(failures)} kernel parity failures")
    print("[parity] all kernels agree with their plain versions")
    mark(t_main, "phase 2")

    # ---- 3. K-SVM main path -----------------------------------------------
    spy = DriverSpy()
    for fn in (kmv_cuda, gram_cuda):
        fn.launches = fn.warmup_launches = 0
    svm_opts = dict(max_iters=args.svm_iters, seed=args.seed)
    svm = KernelSVM(C=1.0, kernel="rbf", device=dev, options=SolverOptions(
        method="sstep", s=32, **svm_opts))
    r_s = svm.fit(A, y)
    dcd = KernelSVM(C=1.0, kernel="rbf", device=dev, options=SolverOptions(
        method="classical", **svm_opts))
    r_c = dcd.fit(A, y, schedule=r_s.schedule)
    agree = float((r_s.alpha - r_c.alpha).abs().max())
    gap = float(ksvm_duality_gap(A, y, r_s.alpha, svm.cfg))
    t0 = time.perf_counter()
    f_q = svm.decision_function(Aq)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    acc = float((torch.sign(f_q) == yq).float().mean())
    n_sv = svm._predictor.op.n_samples
    f_ref = ksvm_predict(A, y, r_s.alpha, Aq[:64], svm.cfg)
    ratio_svm, err_svm = allclose_ratio(f_q[:64], f_ref, TOL_ORACLE, True)
    svm_counts = (kmv_cuda.launches, gram_cuda.launches)
    svm_drivers = spy.take()
    print(f"[ksvm] s-step s=32: {r_s.iters_run} iters, {r_s.rounds_run} "
          f"rounds, {r_s.wall_time_s:.2f} s | classical: "
          f"{r_c.rounds_run} rounds, {r_c.wall_time_s:.2f} s")
    print(f"[ksvm] max|a_s - a_dcd| = {agree:.3e} (bound "
          f"{TOL_SSTEP_VS_CLASSICAL}) | duality gap {gap:.6e} | "
          f"nonzero alpha {int((r_s.alpha != 0).sum())}")
    print(f"[ksvm] predict {q} queries on {n_sv} support vectors: "
          f"{t_pred * 1e3:.1f} ms, accuracy {acc:.4f}; vs dense oracle "
          f"max abs err {err_svm:.3e}")
    print(f"[ksvm] launches: kmv {svm_counts[0]}, gram {svm_counts[1]}; "
          f"drivers: {svm_drivers[0]} captured, {svm_drivers[1]} eager")
    if svm_drivers != (2, 0):
        failures.append(f"the K-SVM fits did not both run captured: "
                        f"{svm_drivers}")
    if not agree <= TOL_SSTEP_VS_CLASSICAL:
        failures.append(f"s-step vs classical {agree:.3e}")
    if not (torch.isfinite(r_s.alpha).all() and
            float(r_s.alpha.min()) >= 0.0 and
            float(r_s.alpha.max()) <= 1.0 + 1e-6):
        failures.append("K-SVM alpha outside [0, C]")
    if not (f_q.shape == (q,) and bool(torch.isfinite(f_q).all())):
        failures.append("K-SVM decision values not finite")
    if not ratio_svm <= 1.0:
        failures.append(f"K-SVM predictions vs dense oracle {err_svm:.3e}")
    if not (gap == gap and abs(gap) < float("inf")):
        failures.append("K-SVM duality gap not finite")

    # ---- 4. K-RR main path ------------------------------------------------
    R_all, t_all = regression_dataset(gen, m + q, n, device=dev)
    Ar, yr = R_all[:m].contiguous(), t_all[:m].contiguous()
    Arq, yrq = R_all[m:].contiguous(), t_all[m:].contiguous()
    del R_all, t_all
    krr = KernelRidge(lam=1.0, kernel="rbf", device=dev,
                      options=SolverOptions(method="sstep", s=8, b=32,
                                            tol=1e-4, check_every=16,
                                            max_iters=args.krr_iters,
                                            seed=args.seed))
    r_k = krr.fit(Ar, yr)
    t0 = time.perf_counter()
    p_q = krr.predict(Arq)
    torch.cuda.synchronize()
    t_pred_k = time.perf_counter() - t0
    p_ref = krr_predict(Ar, r_k.alpha, Arq[:64], krr.cfg)
    ratio_krr, err_krr = allclose_ratio(p_q[:64], p_ref, TOL_ORACLE, True)
    rmse = float(((p_q - yrq) ** 2).mean().sqrt())
    hist = [float(v) for v in r_k.history]
    counts = (kmv_cuda.launches, gram_cuda.launches)   # the main path's
    warmup = (kmv_cuda.warmup_launches, gram_cuda.warmup_launches)
    krr_drivers = spy.take()
    print(f"[krr] s-step s=8 b=32: {r_k.iters_run} iters, "
          f"{r_k.rounds_run} rounds, converged={r_k.converged}, "
          f"{r_k.wall_time_s:.2f} s")
    print(f"[krr] rel residual history: "
          + " ".join(f"{v:.4e}" for v in hist))
    print(f"[krr] predict {q} queries: {t_pred_k * 1e3:.1f} ms, rmse "
          f"{rmse:.4f} (target std {float(yrq.std()):.4f}); vs dense "
          f"oracle max abs err {err_krr:.3e}")
    print(f"[krr] launches: kmv {counts[0] - svm_counts[0]}, gram "
          f"{counts[1] - svm_counts[1]}; drivers: {krr_drivers[0]} "
          f"captured, {krr_drivers[1]} eager")
    if krr_drivers != (1, 0):
        failures.append(f"the K-RR fit did not run captured: {krr_drivers}")
    if not (hist and all(v == v and v < float("inf") for v in hist)
            and hist[-1] < hist[0]):
        failures.append(f"K-RR residual history does not fall: {hist}")
    if not (p_q.shape == (q,) and bool(torch.isfinite(p_q).all())):
        failures.append("K-RR predictions not finite")
    if not ratio_krr <= 1.0:
        failures.append(f"K-RR predictions vs dense oracle {err_krr:.3e}")

    print(f"[main path] launches: kmv {counts[0]}, gram {counts[1]}")
    print(f"[main path] warm-up launches, apart from those (one eager round "
          f"and check a fit before its captures): kmv {warmup[0]}, gram "
          f"{warmup[1]}")
    if counts[0] < 1 or counts[1] < 1:
        failures.append(f"a kernel was never launched on the main path "
                        f"(kmv {counts[0]}, gram {counts[1]})")
    # every round launches one KMV and one gram; a check or a prediction
    # block one KMV more: the counts are the launches the fits made
    rounds = r_s.rounds_run + r_c.rounds_run + r_k.rounds_run
    n_pred = -(-q // svm.predict_batch) + -(-q // krr.predict_batch)
    want = (rounds + len(hist) + 1 + n_pred, rounds)
    if counts != want:
        failures.append(f"main-path launch counts {counts}, not the "
                        f"{want} launches the fits make")

    # ---- 3-4b. the captured fits against the eager loop -------------------
    t0 = time.perf_counter()
    with mock.patch.object(ExactGramOperator, "capturable", False):
        e_s = KernelSVM(C=1.0, kernel="rbf", device=dev,
                        options=svm.options).fit(A, y)
        e_c = KernelSVM(C=1.0, kernel="rbf", device=dev,
                        options=dcd.options).fit(A, y, schedule=e_s.schedule)
        e_k = KernelRidge(lam=1.0, kernel="rbf", device=dev,
                          options=krr.options).fit(Ar, yr)
    eager_drivers = spy.take()
    print(f"[graphs] the same fits with the operator not capturable: "
          f"{eager_drivers[1]} eager loops, {eager_drivers[0]} captured, "
          f"{time.perf_counter() - t0:.1f} s; fit walls eager (captured): "
          f"K-SVM s=32 {e_s.wall_time_s:.2f} s ({r_s.wall_time_s:.2f}), "
          f"classical {e_c.wall_time_s:.2f} s ({r_c.wall_time_s:.2f}), "
          f"K-RR {e_k.wall_time_s:.2f} s ({r_k.wall_time_s:.2f})")
    if eager_drivers != (0, 3):
        failures.append(f"the eager refits took {eager_drivers}")
    for label, got, want_ in (
            ("K-SVM s=32 alpha", r_s.alpha, e_s.alpha),
            ("K-SVM classical alpha", r_c.alpha, e_c.alpha),
            ("K-RR alpha", r_k.alpha, e_k.alpha),
            ("K-RR residual history", r_k.history, e_k.history)):
        same, diff = bit_equal(got, want_)
        print(f"[graphs] {label}: captured vs eager "
              f"{'equal bit for bit' if same else 'DIFFER'} (max abs "
              f"diff {diff:.3e})")
        if not same:
            failures.append(f"captured vs eager {label}: {diff:.3e}")
    # the wrong driver: every run after the first replayed without its
    # schedule slice repeats the first run's coordinates
    rf_s = make_sstep_dcd_round_fn(A, y, svm.cfg, 32,
                                   op=ExactGramOperator(A, kernels["rbf"])
                                   .scale_rows(y))
    xs_s = pad_rounds(r_s.schedule, 32)
    for refresh in (True, False):
        with RoundGraphs(rf_s, torch.zeros_like(y), xs_s,
                         min(FAST_RUN, xs_s[0].shape[0])) as g:
            for j in range(g.n_runs):
                g.run(j, refresh=refresh or j == 0)
            same, diff = bit_equal(g.state, e_s.alpha)
        spy.take()
        what = ("refreshed" if refresh else
                "stale (every run the first run's coordinates)")
        print(f"[graphs] K-SVM s=32 through RoundGraphs, schedule buffer "
              f"{what}: vs eager {'equal' if same else 'differs'} (max abs "
              f"diff {diff:.3e}){'' if refresh else '; must differ'}")
        if same != refresh:
            failures.append(f"the bit-for-bit check "
                            f"{'fails' if refresh else 'passes'} the "
                            f"{what} driver")
    if failures:
        for f in failures:
            print(f"[check] FAIL {f}")
        return fail(f"{len(failures)} main-path check(s) failed")
    mark(t_main, "phases 3-4")

    # ---- 5. stream and Nystrom --------------------------------------------
    ns_stream = SimpleNamespace(
        dev=dev, m=m, n=n, q=q, kernels=kernels, A=A, y=y, Aq=Aq,
        B_of=B_of, pick=pick, Xv=Xv, Xm=Xm, r_s=r_s, gap=gap, Ar=Ar, yr=yr,
        Arq=Arq, r_k=r_k, spy=spy)
    stream_entries = stream_phase(ns_stream, args, failures)
    if failures:
        for f in failures:
            print(f"[stream] FAIL {f}")
        return fail(f"{len(failures)} stream/Nystrom check(s) failed")
    mark(t_main, "phase 5")

    # ---- 6. counts, times, bounds -----------------------------------------

    rbf, lin = kernels["rbf"], kernels["linear"]
    rows = []

    def kmv_row(label, B, c, iters):
        X = Xv if c == 1 else Xm
        r = B.shape[0]
        plan = kmv_plan(m, r, c, sm_count(0), B is A)
        kernel = lambda: kmv_cuda(A, B, X, rbf)  # noqa: E731
        ms = time_queued(kernel, iters)
        eager = time_cuda(kernel, iters)
        plain = time_queued(lambda: kmv_plain(A, B, X, rbf), iters)
        # K(A, A) is symmetric: its m (m + 1) / 2 distinct entries are the
        # work the full matvec needs; B = A is read once
        pairs = m * (m + 1) // 2 if B is A else m * r
        nbytes = 4 * (m * n + (0 if B is A else r * n) + m * c + r * c)
        flops = 2 * pairs * n + 2 * m * r * c + 2 * (m + r) * n + 6 * pairs
        b_ms, b_by = bound_ms(nbytes, flops)
        rows.append(("kmv", f"{label} [{plan.regime} {plan.bm} x "
                     f"{plan.br}]", ms, plain, b_ms, b_by, None, eager))
        return ms, plain, b_ms, b_by, eager, plan.regime

    def gram_row(label, G1, G2, cfg, iters, library, kernel=None):
        r1, r2 = G1.shape[0], G2.shape[0]
        kernel = kernel or (lambda: gram_cuda(G1, G2, cfg))
        ms = time_queued(kernel, iters)
        eager = time_cuda(kernel, iters)
        plain = time_queued(lambda: gram_plain(G1, G2, cfg), iters)
        lib = (time_queued(lambda: torch.mm(G1, G2.T), iters) if library
               else None)
        nbytes = 4 * ((r1 + r2) * n + r1 * r2)
        flops = 2 * r1 * r2 * n + (2 * (r1 + r2) * n + 6 * r1 * r2
                                   if cfg.name == "rbf" else 0)
        b_ms, b_by = bound_ms(nbytes, flops)
        rows.append(("gram", label, ms, plain, b_ms, b_by, lib, eager))
        return ms, plain, b_ms, b_by, lib, eager

    k32 = kmv_row(f"rbf ({m}, 32, {n}) c=1 K-SVM round", B_of["r32"],
                  1, 20)
    k1 = kmv_row(f"rbf ({m}, 1, {n}) c=1 classical DCD round", B_of["r1"],
                 1, 20)
    k256 = kmv_row(f"rbf ({m}, 256, {n}) c=1 K-RR round", B_of["r256"],
                   1, 10)
    kmv_row(f"rbf ({m}, 1024, {n}) c=1 prediction block", B_of["q1024"],
            1, 5)
    kfull = kmv_row(f"rbf ({m}, {m}, {n}) c=1 full matvec, B = A", A, 1,
                    2)
    A_copy = A.clone()
    kmv_row(f"rbf ({m}, {m}, {n}) c=1 full matvec, B a copy of A",
            A_copy, 1, 2)
    del A_copy
    g_ms = {}
    for label, (G1, G2) in gram_blocks.items():
        what = {"1x1": "classical DCD cross block",
                "32x32": "K-SVM cross block", "256x256": "K-RR cross block",
                "mx32": "slab_free=False slab"}[label]
        shape = (G1.shape[0], G2.shape[0], n)
        iters = 10 if label == "mx32" else 50
        row = gram_row(f"rbf {shape} [{what}]", G1, G2, rbf, iters, False)
        g_ms[label] = row[0]
        if label == "256x256":
            g256 = row
        if label == "1x1":
            # the same block through the 32 x 32 tile kernel, against the
            # dot kernel that gram_splits picks for it
            _, _, splits, per = gram_splits(32, 32, n, sm_count(0))
            gram_row(f"rbf {shape} through the 32 x 32 tile", G1, G2, rbf,
                     iters, False, lambda: gram_direct(G1, G2, rbf, 32, 32,
                                                       splits, per))
        gram_row(f"linear {shape} vs torch.mm", G1, G2, lin, iters, True)
    print("[time] kmv, gram: the kernel's, plain and library times are "
          "device times of launches queued behind a spin kernel "
          "(time_queued); 'eager' times the same calls back to back "
          "(time_cuda), the wrapper's host time included; kmv's regime and "
          "tile in brackets")
    for kind, label, ms, plain, b_ms, b_by, lib, eager in rows:
        lib_s = f"{lib:.4f} ms" if lib is not None else "none"
        eager_s = f" (eager {eager:.4f} ms)" if eager is not None else ""
        print(f"[time] {kind} {label}: {ms:.4f} ms{eager_s} | plain "
              f"{plain:.4f} ms | bound {b_ms:.4f} ms ({b_by}, "
              f"{b_ms / ms:.1%} of it) | library {lib_s}")

    # inner (local) phase share of an s-step round, synchronised per phase
    op_svm = ExactGramOperator(A, rbf).scale_rows(y)
    idx_s, valid_s = pad_rounds(r_s.schedule, 32)
    a_s = r_s.alpha
    cfg_svm = svm.cfg
    sk, sl = phase_split(
        lambda k: op_svm.round_data(idx_s[k], a_s),
        lambda k, d: sstep_dcd_inner(d[0], d[1], a_s[idx_s[k]], idx_s[k],
                                     cfg_svm.nu, cfg_svm.omega, 32,
                                     valid_s[k]), 16)
    op_krr = ExactGramOperator(Ar, rbf)
    idx_k, valid_k = pad_rounds(r_k.schedule, 8)
    a_k = r_k.alpha
    kk, kl = phase_split(
        lambda k: op_krr.round_data(idx_k[k].reshape(-1), a_k),
        lambda k, d: sstep_bdcd_inner(d[0], d[1], a_k[idx_k[k]],
                                      yr[idx_k[k]], idx_k[k].reshape(-1), m,
                                      1.0, 8, 32, valid_k[k]), 16)
    print(f"[rounds] K-SVM s=32: kernel phase {sk:.3f} ms, local phase "
          f"{sl:.3f} ms, local share {sl / (sk + sl):.1%}")
    print(f"[rounds] K-RR s=8 b=32: kernel phase {kk:.3f} ms, local phase "
          f"{kl:.3f} ms, local share {kl / (kk + kl):.1%}")

    # the same rounds replayed as CUDA graphs, as the fits run them: device
    # ms a round from events around the replays; what is left of the local
    # phase beside the rounds' KMV and gram (their queued times above),
    # spread over the round's other launches (an eager round profiled)
    op_krr_c = ExactGramOperator(Ar, rbf)
    rf_c = make_dcd_round_fn(A, y, svm.cfg, op=op_svm)
    rf_k = make_sstep_bdcd_round_fn(Ar, yr, krr.cfg, 8, op=op_krr_c)
    xs_k = pad_rounds(r_k.schedule, 8)
    gap_k = lambda a: krr_rel_residual_op(op_krr_c, yr, a,  # noqa: E731
                                          krr.cfg)
    zero = torch.zeros_like(y)
    shapes = [
        ("K-SVM s=32", rf_s, xs_s, FAST_RUN, None, k32[0] + g_ms["32x32"],
         lambda: rf_s(zero, (xs_s[0][0], xs_s[1][0]))),
        ("K-SVM classical", rf_c, r_c.schedule, FAST_RUN, None,
         k1[0] + g_ms["1x1"], lambda: rf_c(zero, r_c.schedule[0])),
        ("K-RR s=8 b=32", rf_k, xs_k, 16, None, k256[0] + g256[0],
         lambda: rf_k(zero, (xs_k[0][0], xs_k[1][0]))),
        ("K-RR s=8 b=32, each run ending in its check", rf_k, xs_k, 16,
         gap_k, None, None)]
    for label, rf, xs, c_len, metric, kernels_ms, one_round in shapes:
        gt = graph_timing(label, rf, zero, xs, c_len, metric_fn=metric)
        if one_round is None:
            continue
        busy, nodes, _ = device_profile(one_round, 1)
        local = gt["round_ms"] - kernels_ms
        per_node = (f"{local / (nodes - 2) * 1e3:.2f} us" if nodes > 2
                    else "not measured")
        print(f"[rounds] {label} replayed: {gt['round_ms']:.4f} ms a round "
              f"(eager kernel + local phase above); its KMV + gram "
              f"{kernels_ms:.4f} ms, the rest {local:.4f} ms, local share "
              f"{local / gt['round_ms']:.1%}; an eager round launches "
              f"{nodes:.0f} device operations (busy "
              f"{busy if busy is None else round(busy, 4)} ms), so "
              f"{per_node} a node beside KMV and gram")
    spy.take()

    if failures:
        for f in failures:
            print(f"[check] FAIL {f}")
        return fail(f"{len(failures)} main-path check(s) failed")
    mark(t_main, "phase 6")

    # ---- 9. sweeps (on phases 3-4's data, before the LM frees it) ---------
    del rf_s, rf_c, rf_k, op_krr_c, gap_k, shapes, op_svm, op_krr
    torch.cuda.empty_cache()
    ns_sweep = SimpleNamespace(
        dev=dev, m=m, n=n, kernels=kernels, A=A, y=y, Ar=Ar, yr=yr,
        B_of=B_of, r_s=r_s, r_c=r_c, r_k=r_k, svm=svm, krr=krr, spy=spy)
    sweep_entries, fleet_counts = sweep_phase(ns_sweep, args, failures)
    print(f"[sweep] phase 9 launches (the fleets, counted from 0): kmv "
          f"{fleet_counts[0]}, gram {fleet_counts[1]}")
    if failures:
        for f in failures:
            print(f"[sweep] FAIL {f}")
        return fail(f"{len(failures)} sweep check(s) failed")
    mark(t_main, "phase 9")

    # ---- 10. guarded solves (on phases 3-4's data) ------------------------
    guard_entries = guard_phase(SimpleNamespace(
        dev=dev, m=m, n=n, kernels=kernels, A=A, y=y, Ar=Ar, yr=yr,
        r_s=r_s, r_k=r_k, svm=svm, krr=krr, spy=spy,
        hyper={KernelSVM: dict(C=1.0, kernel="rbf"),
               KernelRidge: dict(lam=1.0, kernel="rbf")}), args, failures)
    if failures:
        for f in failures:
            print(f"[guard] FAIL {f}")
        return fail(f"{len(failures)} guard check(s) failed")
    mark(t_main, "phase 10")

    # ---- 11. serving and telemetry (on phases 3-4's data) -----------------
    serve_entries = serve_phase(SimpleNamespace(
        dev=dev, m=m, n=n, kernels=kernels, A=A, y=y, Aq=Aq, Ar=Ar, yr=yr,
        Arq=Arq, yrq=yrq, svm=svm, krr=krr, r_k=r_k, spy=spy,
        fleets=ns_sweep.fleets, nys=ns_stream.nys), args, failures)
    if failures:
        for f in failures:
            print(f"[serve] FAIL {f}")
        return fail(f"{len(failures)} serve/telemetry check(s) failed")
    mark(t_main, "phase 11")

    # ---- 12. the distributed layouts (on phases 3-4's data) ---------------
    dist_entries = dist_phase(SimpleNamespace(
        dev=dev, m=m, n=n, q=q, A=A, y=y, Ar=Ar, yr=yr, pick=pick, r_s=r_s,
        r_c=r_c, r_k=r_k, fleets=ns_sweep.fleets), args, failures)
    if failures:
        for f in failures:
            print(f"[dist] FAIL {f}")
        return fail(f"{len(failures)} distributed-layout check(s) failed")
    mark(t_main, "phases 12, 13, 15 and 18")

    # ---- 7. LM prefill and serving ----------------------------------------
    del A, Ar, Aq, Arq, B_of, gram_blocks, Xv, Xm, svm, krr
    del dcd, ns_stream, ns_sweep
    torch.cuda.empty_cache()
    lm_entries = lm_phase(dev, args, failures)
    if failures:
        for f in failures:
            print(f"[lm] FAIL {f}")
        return fail(f"{len(failures)} LM check(s) failed")
    mark(t_main, "phase 7")

    # ---- 8. LM training ---------------------------------------------------
    train = train_phase(dev, args, failures)
    if failures:
        for f in failures:
            print(f"[train] FAIL {f}")
        return fail(f"{len(failures)} LM training check(s) failed")
    mark(t_main, "phase 8")
    train_entries, train_counts = train
    for entry in lm_entries:
        entry["train_launches"] = train_counts[entry["name"]]
    del train
    torch.cuda.empty_cache()

    # ---- 14. the MoE family -----------------------------------------------
    moe_entries = moe_phase(dev, args, failures)
    if failures:
        for f in failures:
            print(f"[moe] FAIL {f}")
        return fail(f"{len(failures)} MoE check(s) failed")
    mark(t_main, "phase 14")

    # ---- 16. the SSM family -----------------------------------------------
    ssm_entries = ssm_phase(dev, args, failures)
    if failures:
        for f in failures:
            print(f"[ssm] FAIL {f}")
        return fail(f"{len(failures)} SSM check(s) failed")
    mark(t_main, "phase 16")

    # ---- 17. the encoder-decoder stack and M-RoPE -------------------------
    encdec_entries = encdec_phase(dev, args, failures)
    if failures:
        for f in failures:
            print(f"[encdec] FAIL {f}")
        return fail(f"{len(failures)} encoder-decoder / M-RoPE check(s) "
                    f"failed")
    mark(t_main, "phase 17")

    # ---- 19. the analysis and the dry run ---------------------------------
    analysis_phase(dev, args, failures)
    if failures:
        for f in failures:
            print(f"[analysis] FAIL {f}")
        return fail(f"{len(failures)} analysis / dry-run check(s) failed")
    mark(t_main, "phase 19")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(f"[smoke] every phase passed in "
          f"{time.perf_counter() - t_main:.1f} s")
    print(smi[0])                            # the card's name, power limit
    record = {"kernels": [
        {"name": "kmv", "route": "cuda", "source":
            "src/repro_torch/csrc/kmv.cu",
         "replaces": "src/repro/kernels/kmv.py:93",
         "shape": f"rbf (m, r, n, c) = ({m}, 32, {n}, 1)",
         "launches": counts[0],
         "max_abs_err": err_at[("kmv", "rbf", "torch.float32", "r32",
                                "vec")],
         "ms": k32[0], "plain_ms": k32[1], "bound_ms": k32[2],
         "bound_by": k32[3], "library_ms": None,
         "ms_timing": "device time, launches queued behind a spin kernel "
                      "(time_queued); eager_ms: back to back, host "
                      "included (time_cuda)",
         "eager_ms": k32[4], "regime": k32[5],
         "ms_r1": k1[0], "eager_ms_r1": k1[4], "plain_ms_r1": k1[1],
         "bound_ms_r1": k1[2], "regime_r1": k1[5],
         "ms_full": kfull[0], "eager_ms_full": kfull[4],
         "plain_ms_full": kfull[1], "bound_ms_full": kfull[2],
         "regime_full": kfull[5]},
        {"name": "gram", "route": "cuda", "source":
            "src/repro_torch/csrc/gram.cu",
         "replaces": "src/repro/kernels/gram.py:82",
         "shape": f"rbf (m, r, n) = (256, 256, {n})",
         "launches": counts[1],
         "max_abs_err": err_at[("gram", "rbf", "torch.float32",
                                "256x256")],
         "ms": g256[0], "plain_ms": g256[1], "bound_ms": g256[2],
         "bound_by": g256[3], "library_ms": g256[4],
         "ms_timing": "device time, launches queued behind a spin kernel "
                      "(time_queued); eager_ms: back to back, host "
                      "included (time_cuda)",
         "eager_ms": g256[5]},
        *stream_entries,
        *sweep_entries,
        *guard_entries,
        *serve_entries,
        *dist_entries,
        *lm_entries,
        *train_entries,
        *moe_entries,
        *ssm_entries,
        *encdec_entries,
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
