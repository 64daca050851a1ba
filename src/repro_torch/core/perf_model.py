"""Hockney-model performance analysis (paper Section 4, Theorems 1-2) —
the counterpart of ``repro/core/perf_model.py``, plain Python arithmetic
with the same results.

T = gamma*F + beta*W + phi*L  with per-iteration costs:

  BDCD:        F = b*f*m*n/P + mu*b*m + b^3 + b*m      W = b*m      L = log P
  s-step BDCD: per OUTER round (s inner solves):
               F = s*b*f*m*n/P + mu*s*b*m + s*b^3 + C(s,2)*b^2 + s*b*m
               W = s*b*m                               L = log P

DCD (K-SVM) is the b=1 specialization.  These closed forms power the
strong-scaling predictions (benchmarks/fig3) that mirror the paper's Cray
EX experiments, calibrated with machine parameters measured on this host
(gamma) and standard HPC interconnect constants (beta, phi).

Both kernel *representations* are priced (DESIGN.md §9): exact rounds at
data width n with the kernel's epilogue cost mu, low-rank (Nystrom)
rounds at width l with linear-kernel mu plus the one-time
``lowrank_setup_cost``; ``modeled_predict_cost`` prices serving for both
(and the SV fraction for compacted K-SVM models).

``Machine``'s defaults are the paper's Cray EX and host constants, kept
so that ``FitResult.comm`` means what it means in the JAX package.  The
JAX module's TPU defaults are gone: its VMEM budget, its HBM-class
stream DMA rate and its 16 GiB device memory.  Every memory budget and
link rate here is an explicit argument; on the card it comes from a
``DeviceBudget`` (``DeviceBudget.of_device``): the free device memory
``torch.cuda.mem_get_info`` reports, a stated share of it for the
streamed working set (the port's chunk slots live in device memory, not
on-chip), the host-to-device rate of one pinned chunk copy, measured
once a process, and the fewest chunk rows that fill the card.  The Pallas working-set functions (``vmem_fits``) have
no counterpart: there is no BlockSpec and no VMEM here.
"""
from __future__ import annotations

import dataclasses
import math
import os


@dataclasses.dataclass(frozen=True)
class Machine:
    gamma: float = 1.0 / 50e9     # s/flop  (~50 GFLOP/s per core, DGEMM)
    beta: float = 8.0 / 25e9      # s/word  (8B words over 25 GB/s links)
    phi: float = 2.0e-6           # s/message (Cray EX / Slingshot-ish)
    mu: float = 20.0              # non-linear kernel op cost in flop units


@dataclasses.dataclass(frozen=True)
class Problem:
    m: int
    n: int
    f: float = 1.0                # nnz density
    b: int = 1
    H: int = 1000                 # total (inner) iterations
    kernel: str = "rbf"


def _mu(mach: Machine, prob) -> float:
    """Kernel-epilogue op cost in flop units; accepts a Problem or name."""
    kernel = prob if isinstance(prob, str) else prob.kernel
    return {"linear": 1.0, "polynomial": mach.mu / 2, "rbf": mach.mu}[
        kernel]


def bdcd_cost(prob: Problem, mach: Machine, P: int) -> dict:
    """Classical BDCD total cost for H iterations on P processors."""
    b, m, n, f, H = prob.b, prob.m, prob.n, prob.f, prob.H
    mu = _mu(mach, prob)
    F = H * (b * f * m * n / P + mu * b * m + b ** 3 + b * m)
    W = H * b * m
    L = H * math.log2(max(P, 2))
    return {"flops": F, "words": W, "msgs": L,
            "time": mach.gamma * F + mach.beta * W + mach.phi * L,
            "t_comp": mach.gamma * F, "t_band": mach.beta * W,
            "t_lat": mach.phi * L}


def sstep_bdcd_cost(prob: Problem, mach: Machine, P: int, s: int) -> dict:
    """s-step BDCD total cost for H inner iterations (H/s outer rounds)."""
    b, m, n, f, H = prob.b, prob.m, prob.n, prob.f, prob.H
    mu = _mu(mach, prob)
    rounds = H / s
    F = rounds * (s * b * f * m * n / P + mu * s * b * m + s * b ** 3
                  + math.comb(s, 2) * b ** 2 + s * b * m)
    W = rounds * (s * b * m)
    L = rounds * math.log2(max(P, 2))
    return {"flops": F, "words": W, "msgs": L,
            "time": mach.gamma * F + mach.beta * W + mach.phi * L,
            "t_comp": mach.gamma * F, "t_band": mach.beta * W,
            "t_lat": mach.phi * L}


def best_s(prob: Problem, mach: Machine, P: int,
           candidates=(1, 2, 4, 8, 16, 32, 64, 128, 256), *,
           hbm_bytes: int, word: int = 4,
           return_frontier: bool = False) -> tuple:
    """Offline tuning of s (paper 5.2.1): best predicted time among the
    FEASIBLE candidates — an s whose per-round KMV working set (the
    ``m x s*b`` slab bound of ``slab_fits_hbm``) cannot be resident is
    excluded, so callers (the ``tune.autotune`` tuner) never get a plan the
    memory system cannot execute.  s=1 is always kept as a fallback
    (the classical schedule's m x b column set is the solver's floor).

    ``return_frontier=True`` additionally returns the searched frontier:
    ``[{"s", "time", "feasible"}, ...]`` over ALL candidates (infeasible
    ones carry their modeled time too — the frontier shows what the
    memory ceiling cost us).  ``hbm_bytes`` is the device-memory budget
    (``DeviceBudget.hbm_bytes`` on the card).
    """
    frontier = []
    for s in candidates:
        feasible = s == 1 or slab_fits_hbm(prob.m, s * prob.b,
                                           hbm_bytes, word)
        frontier.append({"s": s,
                         "time": sstep_bdcd_cost(prob, mach, P, s)["time"],
                         "feasible": feasible})
    feas = [f for f in frontier if f["feasible"]]
    best = min(feas, key=lambda f: f["time"])
    if return_frontier:
        return best["s"], best["time"], frontier
    return best["s"], best["time"]


def storage_words(prob: Problem, P: int, s: int = 1) -> float:
    """Theorem 1/2 storage: fmn/P + s*b*m."""
    return prob.f * prob.m * prob.n / P + s * prob.b * prob.m


def lowrank_setup_cost(m: int, n: int, l: int, kernel: str,
                       mach: Machine = None, P: int = 1) -> dict:
    """One-time cost of building the rank-l Nystrom representation:
    the ``K(A, L)`` slab (m*l*n MACs + epilogue), the l x l
    eigendecomposition (~10 l^3 — LAPACK's classic constant), and the
    ``m x l x l`` feature-map GEMM.  The m-scaled terms shard over P
    (rows are embarrassingly parallel); the eigh is redundant per rank.
    """
    mach = mach or Machine()
    mu = _mu(mach, kernel)
    F = (m * l * n + mu * m * l + m * l * l) / P + 10.0 * l ** 3
    return {"flops": F, "time": mach.gamma * F}


def modeled_fit_cost(m: int, n: int, kernel: str, *, b: int = 1,
                     s: int = 1, iters: int = 1, P: int = 1,
                     mach: Machine = None, approx: str = None,
                     landmarks: int = 0) -> dict:
    """Hockney-model cost summary for a completed solver run — the
    ``FitResult.comm`` payload of the ``repro.api`` facade.  ``iters`` is
    the number of INNER iterations actually executed (early stopping
    shrinks it), ``P`` the processor count implied by the layout; ``s=1``
    prices the classical per-iteration collective schedule.

    ``approx="nystrom"`` prices the LOW-RANK representation instead: the
    per-round slab GEMM runs over the rank-``landmarks`` linear factor
    Phi (width l, mu = 1 — no nonlinear epilogue in the round loop), the
    one-time ``lowrank_setup_cost`` is folded into flops/time and
    reported separately under ``setup_flops``/``setup_time``, and the
    psum payload is the CONTRACTED ``(s*b, s*b+1)`` words the linear
    all-reduce operator actually moves per round — not the Theorem-2
    ``s*b*m`` pre-epilogue payload, which only nonlinear kernels must
    psum (exact-path pricing keeps the paper's model for fidelity).
    """
    mach = mach or Machine()
    # price whole communication rounds: a ragged final round (pad-and-
    # mask) still issues a full-size collective, so round iters up to
    # ceil(iters/s) rounds — keeping comm['msgs'] consistent with the
    # FitResult.rounds_run reported for the same run.
    H = max(iters, 1) if s <= 1 else -(-max(iters, 1) // s) * s
    if approx:
        prob = Problem(m=m, n=max(landmarks, 1), b=max(b, 1), H=H,
                       kernel="linear")
    else:
        prob = Problem(m=m, n=n, b=max(b, 1), H=H, kernel=kernel)
    cost = (bdcd_cost(prob, mach, P) if s <= 1
            else sstep_bdcd_cost(prob, mach, P, s))
    # problem identity rides along so downstream consumers (the
    # JAX package's repro.obs audit re-pricing guard overhead) need
    # only this dict
    cost = dict(cost, m=m, n=n, kernel=kernel, b=b,
                P=P, s=s, iters=iters, approx=approx,
                landmarks=landmarks if approx else 0)
    if approx:
        setup = lowrank_setup_cost(m, n, max(landmarks, 1), kernel,
                                   mach, P)
        cost["setup_flops"] = setup["flops"]
        cost["setup_time"] = setup["time"]
        cost["flops"] += setup["flops"]
        cost["t_comp"] += setup["time"]
        # linear-factor rounds psum only the contracted quantities
        sb = max(s, 1) * max(b, 1)
        rounds = H if s <= 1 else H / s
        cost["words"] = rounds * sb * (sb + 1)
        cost["t_band"] = mach.beta * cost["words"]
        cost["time"] = cost["t_comp"] + cost["t_band"] + cost["t_lat"]
    return cost


def fleet_fit_cost(m: int, n: int, kernel: str, F: int, *, b: int = 1,
                   s: int = 1, iters: int = 1, P: int = 1,
                   mach: Machine = None, approx: str = None,
                   landmarks: int = 0) -> dict:
    """Hockney-model cost of an F-member solver fleet
    (``tune.solve_fleet``, DESIGN.md §10) vs F sequential fits.

    The fleet shares ONE operator, so per round the slab GEMM and its
    nonlinear epilogue — the paper's dominant terms — are computed once
    for the whole fleet (one KMV of F columns a round); only the
    per-member ``U^T alpha_f`` contraction, the O((sb)^2) correction
    solves, and the state updates batch by F.  Sequential fits pay
    everything F times; ``sequential_time / time`` is the modeled fleet
    speedup.
    """
    mach = mach or Machine()
    single = modeled_fit_cost(m, n, kernel, b=b, s=s, iters=iters, P=P,
                              mach=mach, approx=approx,
                              landmarks=landmarks)
    H = max(iters, 1) if s <= 1 else -(-max(iters, 1) // s) * s
    rounds = H if s <= 1 else H / s
    width = max(landmarks, 1) if approx else n
    mu = 1.0 if approx else _mu(mach, kernel)
    sb = max(s, 1) * max(b, 1)
    # shared once per round: slab GEMM + epilogue (+ one-time setup)
    shared = rounds * (sb * m * width / P + mu * sb * m)
    setup = single.get("setup_flops", 0.0)
    # batched per member: U^T alpha (sb*m), the sb^2-scale correction
    # solves, and the state update
    per_member = rounds * (sb * m + s * max(b, 1) ** 3
                           + math.comb(max(s, 1), 2) * max(b, 1) ** 2
                           + sb * m)
    flops = shared + setup + F * per_member
    # the collective payload batches by F only for the contracted
    # (low-rank / linear) quantities; the pre-epilogue m x sb psum of the
    # nonlinear exact path is SHARED — same words as a single solve
    words = single["words"] * (F if approx else 1)
    msgs = single["msgs"]
    time = mach.gamma * flops + mach.beta * words + mach.phi * msgs
    return {"flops": flops, "words": words, "msgs": msgs, "time": time,
            "t_comp": mach.gamma * flops, "t_band": mach.beta * words,
            "t_lat": mach.phi * msgs, "F": F, "P": P, "s": s,
            "iters": iters, "approx": approx,
            "landmarks": landmarks if approx else 0,
            "sequential_time": F * single["time"],
            "modeled_speedup": F * single["time"] / time}


def modeled_predict_cost(m: int, n: int, q: int, kernel: str, *,
                         approx: str = None, landmarks: int = 0,
                         sv_fraction: float = 1.0,
                         mach: Machine = None, stream: int = 0,
                         word: int = 4,
                         dma_bps: float = None) -> dict:
    """Per-batch serving cost (DESIGN.md §9) for ``q`` queries against an
    ``m``-sample model: exact representations pay the ``q x m_sv`` kernel
    block (KMV-streamed, never materialized — flops only, zero slab
    words), low-rank ones pay the O(l)-per-query feature map.  The
    crossover ``l < sv_fraction * m * n / (n + l)`` is the serving
    argument for Nystrom (Hsieh et al., CA-SVM lineage).

    ``stream=chunk_rows`` prices OUT-OF-CORE query batches (DESIGN.md
    §14): the query stream arrives in (chunk_rows x n) host chunks DMA'd
    through the same double-buffered pipe as training, so the block pays
    ``max(t_comp, t_dma)`` per chunk plus the warm-up DMA instead of
    pure compute — the added keys ``t_dma``/``t_overlap``/
    ``compute_bound`` expose the regime."""
    mach = mach or Machine()
    mu = _mu(mach, kernel)
    if approx:
        l = max(landmarks, 1)
        # phi(Xq): q*l*n MACs + epilogue, transform q*l*l, dot q*l
        F = q * l * n + mu * q * l + q * l * l + q * l
    else:
        msv = max(1, int(sv_fraction * m))
        F = q * msv * n + mu * q * msv + q * msv
    t_comp = mach.gamma * F
    cost = {"flops": F, "time": t_comp,
            "flops_per_query": F / max(q, 1)}
    if stream and stream > 0:
        if dma_bps is None:
            raise ValueError("a streamed query batch needs dma_bps, the "
                             "host-to-device rate (DeviceBudget.dma_bps)")
        bps = dma_bps
        n_chunks = max(1, -(-q // stream))
        t_dma = word * q * n / bps           # total query-chunk DMA
        per_comp, per_dma = t_comp / n_chunks, t_dma / n_chunks
        time = per_dma + n_chunks * max(per_comp, per_dma)
        cost.update(time=time, t_dma=t_dma,
                    t_overlap=time - t_comp,
                    stream_chunks=n_chunks,
                    compute_bound=per_comp >= per_dma)
    return cost


# --------------------------------------------------------------------------
# Serving latency model (DESIGN.md §13): continuous batching with a full
# drain per engine step.  Each step admits every queued request (up to
# the ``slots`` admission window) and serves them as ONE bucketed block
# through ``core/predict.py``; the step duration IS the batch window.
# Deterministic-drain queueing: a request arrives uniformly within the
# current step, waits for the step boundary, and is served by the next
# step — latency in (T, 2T] for steady step time T, so p50 = 1.5 T and
# p99 = 1.99 T.  The steady step time follows the predictor's
# power-of-two BUCKETS (an admitted batch of 13 pads to 16 and costs
# 16), so the model iterates the bucketed drain recurrence instead of
# assuming a linear T(b).  ``benchmarks/fig9_serve.py`` measures the
# engine against exactly this model (with gamma/dispatch calibrated
# on-host).
# --------------------------------------------------------------------------

SERVE_DISPATCH_S = 50e-6           # per-block host->device dispatch cost


def serve_bucket(q: float, slots: int) -> int:
    """The power-of-two block shape a q-row admission pads to (mirrors
    ``BatchedPredictor.block_shape``: minimum bucket 8, capped at the
    admission window)."""
    q = max(int(-(-q // 1)), 1)
    if q >= slots:
        return slots
    return min(slots, max(8, 1 << (q - 1).bit_length()))


def serve_block_time(q: int, m: int, n: int, kernel: str, *,
                     approx: str = None, landmarks: int = 0,
                     sv_fraction: float = 1.0, mach: Machine = None,
                     dispatch_s: float = SERVE_DISPATCH_S) -> float:
    """Modeled wall time of ONE q-query block through the batched
    predictor: the representation's per-query flops
    (``modeled_predict_cost``) plus a fixed per-block dispatch cost —
    the term that makes batching win (F flops amortize, dispatch does
    not)."""
    cost = modeled_predict_cost(m, n, max(q, 1), kernel, approx=approx,
                                landmarks=landmarks,
                                sv_fraction=sv_fraction, mach=mach)
    return cost["time"] + dispatch_s


def modeled_serve_latency(rate_qps: float, slots: int, m: int, n: int,
                          kernel: str, *, approx: str = None,
                          landmarks: int = 0, sv_fraction: float = 1.0,
                          mach: Machine = None,
                          dispatch_s: float = SERVE_DISPATCH_S,
                          ticket_s: float = 0.0,
                          tail_factor: float = 1.0) -> dict:
    """Steady-state latency/throughput of the continuous-batching engine
    at ``rate_qps`` with an admission window of ``slots`` queries/step.

    The steady batch is the fixed point of the drain recurrence
    ``b_{k+1} = rate * T(b_k)`` with the BUCKETED step time
    ``T(b) = dispatch + ticket * b + bucket(b) * t_q``: the device pays
    per padded-bucket row (t_q — the predictor serves the full
    power-of-two block whether its tail is real or zeros), the host
    pays per REAL ticket (``ticket_s`` — admission, buffer fill,
    result scatter; zero by default for the pure device model).  The
    recurrence is iterated to its limit cycle, since padding makes the
    device term piecewise-constant and the limit may be a short cycle
    straddling a bucket edge rather than a fixed point.  The engine
    saturates when the rate exceeds the full-window capacity; then
    every step serves a FULL window and the excess is shed by the
    bounded queue.

    A ticket's latency is the residue of the step it arrived during
    plus the full step that serves it — uniform in (T, 2T] when T is
    deterministic, so p50 = 1.5 T and p99 = 1.99 T.  Real hosts jitter:
    the MEDIAN latency is robust to it, but the p99 inherits the
    step-time tail, so callers with a measured step-time distribution
    pass ``tail_factor`` = q99(T)/median(T) (1.0 keeps the
    deterministic tail).

    Returns p50/p99 latency, sustained throughput, the steady batch and
    step time (limit-cycle averages), and ``saturated``.
    """
    mach = mach or Machine()
    t_q = serve_block_time(1, m, n, kernel, approx=approx,
                           landmarks=landmarks, sv_fraction=sv_fraction,
                           mach=mach, dispatch_s=0.0)
    t_full = serve_block_time(slots, m, n, kernel, approx=approx,
                              landmarks=landmarks,
                              sv_fraction=sv_fraction, mach=mach,
                              dispatch_s=dispatch_s) + slots * ticket_s
    capacity = slots / t_full          # qps when every step is full
    saturated = (rate_qps * (t_q + ticket_s) >= 1.0
                 or rate_qps >= capacity)
    if saturated:
        b_star, t_step, throughput = float(slots), t_full, capacity
    else:
        # bucketed drain recurrence (fluid): admit min(queue, slots),
        # pay the padded bucket (device) plus the real rows (host),
        # arrivals accumulate meanwhile.  Burn in, then average the
        # limit cycle.
        q_len, b_hist, t_hist = 0.0, [], []
        for k in range(200):
            b = min(q_len, float(slots))
            if b < 1.0:                # idle: fast-forward to the next
                q_len = 1.0            # arrival (the driver does too)
                continue
            dt = (dispatch_s + ticket_s * b
                  + serve_bucket(b, slots) * t_q)
            q_len = q_len - b + rate_qps * dt
            if k >= 100:
                b_hist.append(b)
                t_hist.append(dt)
        b_star = sum(b_hist) / len(b_hist)
        t_step = sum(t_hist) / len(t_hist)
        throughput = rate_qps
    return {"p50_s": 1.5 * t_step,
            "p99_s": 1.99 * t_step * tail_factor,
            "t_step_s": t_step, "batch": b_star,
            "throughput_qps": throughput, "capacity_qps": capacity,
            "saturated": saturated, "slots": slots,
            "dispatch_s": dispatch_s, "t_query_s": t_q,
            "ticket_s": ticket_s}


@dataclasses.dataclass(frozen=True)
class ServePlan:
    """The engine sizing ``choose_serve_plan`` resolved: admission
    window (= the slot-matrix height = the largest predictor bucket),
    the modeled latency summary at the target rate, and the frontier of
    every candidate considered."""

    slots: int
    model: dict                    # modeled_serve_latency at the choice
    frontier: tuple                # ({"slots", "p99_s", ...}, ...)


def choose_serve_plan(m: int, n: int, kernel: str, *, rate_qps: float,
                      slo_p99_s: float = float("inf"),
                      approx: str = None, landmarks: int = 0,
                      sv_fraction: float = 1.0, mach: Machine = None,
                      dispatch_s: float = SERVE_DISPATCH_S,
                      candidates=(8, 16, 32, 64, 128, 256, 512, 1024,
                                  2048, 4096)) -> ServePlan:
    """Size the serving engine from the perf model: the SMALLEST
    power-of-two admission window that sustains ``rate_qps`` without
    saturating (bigger windows only stretch the batch window, and with
    it p99).  Among unsaturated candidates any that meet the p99 SLO
    are preferred; if none can, the plan falls back to the highest-
    capacity window (shed-and-degrade beats OOM — the engine's bounded
    queue enforces it)."""
    frontier = []
    for s in candidates:
        lat = modeled_serve_latency(rate_qps, s, m, n, kernel,
                                    approx=approx, landmarks=landmarks,
                                    sv_fraction=sv_fraction, mach=mach,
                                    dispatch_s=dispatch_s)
        frontier.append(dict(lat, slots=s))
    ok = [f for f in frontier if not f["saturated"]
          and f["p99_s"] <= slo_p99_s]
    if ok:
        best = min(ok, key=lambda f: f["slots"])
    else:
        unsat = [f for f in frontier if not f["saturated"]]
        pool = unsat or frontier
        best = max(pool, key=lambda f: f["capacity_qps"])
    return ServePlan(slots=best["slots"], model=best,
                     frontier=tuple(frontier))


# --------------------------------------------------------------------------
# On-chip traffic model (EXPERIMENTS.md §Perf): HBM bytes per outer round.
# The network Hockney model above prices the collective; these two price
# the local memory system, where the materialized m x sb slab is the
# dominant term the slab-free KMV kernel deletes.
# --------------------------------------------------------------------------

def slab_round_hbm_bytes(m: int, n: int, sb: int, c: int = 1,
                         word: int = 4) -> int:
    """Materialized-slab s-step round (fused-epilogue gram kernel +
    separate consumers):

      gram:     read A (m*n) + read B (sb*n), write slab (m*sb)
      U^T x:    re-read slab (m*sb) + read x (c*m), write (c*sb)
      Gblk:     gather sb slab rows (sb*sb)

    The 2*m*sb slab round-trip dominates for m >> n, sb.
    """
    gram = m * n + sb * n + m * sb
    consume = m * sb + c * m + c * sb + sb * sb
    return word * (gram + consume)


def kmv_round_hbm_bytes(m: int, n: int, sb: int, c: int = 1,
                        word: int = 4) -> int:
    """Slab-free s-step round (fused KMV kernel + small cross-block gram):

      KMV:      read A (m*n) + read B (sb*n) + read x (c*m), write (c*sb)
      Gblk:     read B twice (2*sb*n), write sb*sb

    Zero m x sb traffic: the slab lives only in the kernel's on-chip
    tiles.
    """
    kmv = m * n + sb * n + c * m + c * sb
    cross = 2 * sb * n + sb * sb
    return word * (kmv + cross)


def slab_fits_hbm(m: int, sb: int, hbm_bytes: int,
                  word: int = 4) -> bool:
    """Whether the materialized m x sb slab ALONE fits the HBM budget
    (A's own footprint is not counted, so this is an optimistic bound) —
    the slab-free path has no such ceiling on m."""
    return word * m * sb < hbm_bytes


# --------------------------------------------------------------------------
# Streaming pipeline model (DESIGN.md §14): the double-buffered
# out-of-core KMV (kernels/kmv_stream.py) DMAs (chunk_rows x n) row
# blocks from slow memory while the previous block contracts, so the
# steady-state pipe pays max(t_dma, t_comp) per chunk instead of the
# sum.  These closed forms (a) price that overlap, (b) bound the
# buffered working set a chunk size implies, and (c) decide
# when streaming is REQUIRED — the resident working set exceeding the
# device-memory budget — which is the autotuner's trigger for
# ``chunk_rows="auto"`` resolution.  On the card the chunks cross the
# host link into device-memory slots: the rate and the budget come from
# a ``DeviceBudget``.
# --------------------------------------------------------------------------


def stream_chunk_cost(chunk_rows: int, n: int, sb: int, kernel: str, *,
                      c: int = 1, mach: Machine = None, word: int = 4,
                      dma_bps: float) -> dict:
    """One pipeline stage: DMA of a (chunk_rows x n) data block plus its
    (chunk_rows x c) right-hand-side block vs the (GEMM + epilogue +
    contract) compute on the previous block.  ``compute_bound`` is the
    overlap regime where the DMA is (nearly) free."""
    mach = mach or Machine()
    mu = _mu(mach, kernel)
    bytes_in = word * (chunk_rows * n + chunk_rows * c)
    t_dma = bytes_in / dma_bps
    flops = (chunk_rows * sb * n        # dots = chunk @ B^T
             + mu * chunk_rows * sb     # Table-1 epilogue
             + chunk_rows * sb * c)     # acc += ktile^T @ x
    t_comp = mach.gamma * flops
    return {"bytes": bytes_in, "flops": flops, "t_dma": t_dma,
            "t_comp": t_comp, "compute_bound": t_comp >= t_dma}


def stream_pipeline_cost(m: int, n: int, sb: int, chunk_rows: int,
                         kernel: str, *, c: int = 1, mach: Machine = None,
                         word: int = 4, dma_bps: float) -> dict:
    """Whole streamed KMV: warm-up DMA of chunk 0, then ``n_chunks``
    steady stages at ``max(t_dma, t_comp)`` each (double-buffered
    overlap).  ``time_unoverlapped`` is the same pipe with blocking
    copies (the sum per stage) and ``resident_time`` the pure-compute
    bound of an HBM-resident KMV — ``streamed_over_resident`` is the
    modeled slowdown factor fig10's measured gate mirrors (~1.0 when
    compute-bound, up to t_dma/t_comp when DMA-bound)."""
    n_chunks = -(-m // chunk_rows)
    per = stream_chunk_cost(chunk_rows, n, sb, kernel, c=c, mach=mach,
                            word=word, dma_bps=dma_bps)
    steady = max(per["t_dma"], per["t_comp"])
    time = per["t_dma"] + n_chunks * steady
    unoverlapped = n_chunks * (per["t_dma"] + per["t_comp"])
    resident = max(n_chunks * per["t_comp"], 1e-30)
    return dict(per, n_chunks=n_chunks, time=time,
                time_unoverlapped=unoverlapped,
                resident_time=resident,
                streamed_over_resident=time / resident,
                overlap_speedup=unoverlapped / max(time, 1e-30))


def stream_working_set_bytes(chunk_rows: int, n: int, sb: int, *,
                             c: int = 1, word: int = 4,
                             slots: int = 2) -> int:
    """Bytes the streamed contraction keeps live: ``slots`` slots of the
    data chunk and of its right-hand-side chunk (two, double buffering,
    in the JAX package's pipe; the port's symmetric full-matvec pipe keeps
    a third, ``STREAM_SLOTS``), the (sb x n) sampled rows, the transient
    (chunk_rows x sb) kernel tile, and the (sb x c) accumulator."""
    return word * (slots * chunk_rows * n + slots * chunk_rows * c
                   + sb * n + chunk_rows * sb + sb * c)


def stream_chunk_fits(chunk_rows: int, n: int, sb: int, *, c: int = 1,
                      word: int = 4, budget_bytes: int,
                      slots: int = 2) -> bool:
    """Whether a chunk size's working set fits ``budget_bytes`` (on the
    card ``DeviceBudget.stream_bytes``) — the feasibility constraint
    ``choose_chunk_rows`` (and the streaming tests) enforce."""
    return stream_working_set_bytes(chunk_rows, n, sb, c=c, word=word,
                                    slots=slots) <= budget_bytes


def streaming_required(m: int, n: int, sb: int, *, c: int = 1,
                       word: int = 4, device_bytes: int) -> bool:
    """Whether the RESIDENT slab-free round — X (m x n) plus the KMV
    round set (the x vector, the sampled rows, the contracted outputs) —
    exceeds the device-memory budget: the gate between "fits in HBM"
    and the streamed pipeline (the out-of-core axis)."""
    resident = word * (m * n + c * m + sb * n + sb * c)
    return resident > device_bytes


STREAM_CHUNK_CANDIDATES = (128, 256, 512, 1024, 2048, 4096, 8192)


def choose_chunk_rows(m: int, n: int, sb: int, kernel: str, *, c: int = 1,
                      mach: Machine = None, word: int = 4,
                      dma_bps: float, budget_bytes: int, slots: int = 2,
                      candidates=STREAM_CHUNK_CANDIDATES,
                      return_frontier: bool = False):
    """Resolve ``chunk_rows="auto"``: the best modeled pipeline time
    among chunk sizes whose working set (``slots`` slots) fits
    ``budget_bytes`` (ties break toward the smaller working set), the
    chunks crossing the link at ``dma_bps``.  The smallest candidate is
    always kept as a floor so the search cannot come back empty.
    Mirrors ``best_s``'s frontier contract."""
    cands = sorted({min(cr, max(8, m)) for cr in candidates})
    frontier = []
    for i, cr in enumerate(cands):
        feasible = i == 0 or stream_chunk_fits(cr, n, sb, c=c, word=word,
                                               budget_bytes=budget_bytes,
                                               slots=slots)
        cost = stream_pipeline_cost(m, n, sb, cr, kernel, c=c, mach=mach,
                                    word=word, dma_bps=dma_bps)
        frontier.append({"chunk_rows": cr, "time": cost["time"],
                         "compute_bound": cost["compute_bound"],
                         "working_set_bytes": stream_working_set_bytes(
                             cr, n, sb, c=c, word=word, slots=slots),
                         "feasible": feasible})
    feas = [f for f in frontier if f["feasible"]]
    best = min(feas, key=lambda f: (f["time"], f["working_set_bytes"]))
    if return_frontier:
        return best["chunk_rows"], frontier
    return best["chunk_rows"]


# --------------------------------------------------------------------------
# Structural comm model (DESIGN.md §11): COUNTS of collectives, not bytes.
# The Hockney L term above prices one latency unit per round; these two
# expose the underlying per-round collective schedule as checkable
# integers, so the static comm auditor (repro.analysis.comm_check) can
# assert the traced jaxpr executes EXACTLY the modeled schedule — the
# paper's H/s communication-round claim as a machine-checked invariant.
# --------------------------------------------------------------------------

def round_collectives(layout: str, kernel: str) -> int:
    """Collectives per OUTER ROUND of the slab-free solvers by layout.

    serial: 0.  1d: ONE model-axis psum per round regardless of kernel
    (linear psums the contracted (sb, sb+1) words, nonlinear the
    pre-epilogue m x sb block with the cross terms riding along — see
    ``core.distributed.AllreduceGramOperator``).  2d: three — the
    sampled-row gather over ``data``, the fused ``model`` reduction, and
    the fused contracted-quantities psum back over ``data``
    (``dist_sstep_*_2d`` docstrings).  The classical solvers are the
    s=1 specialization: SAME per-round counts, s times the rounds.
    """
    if layout not in ("serial", "1d", "2d"):
        raise ValueError(f"unknown layout {layout!r}")
    return {"serial": 0, "1d": 1, "2d": 3}[layout]


def setup_collectives(layout: str, kernel: str) -> int:
    """One-time (loop-invariant) collectives per solve: the psummed RBF
    row squared-norms (``_psummed_row_sqnorms``) — hoisted out of the
    round loop precisely so they don't scale with H.  Zero for linear
    and polynomial kernels (no row-norm term) and for serial runs."""
    if layout == "serial":
        return 0
    return 1 if kernel == "rbf" else 0


# --------------------------------------------------------------------------
# Guarded-solve overhead model (DESIGN.md §12): drift correction costs one
# EXACT full matvec f = K @ alpha every ``recompute_every`` rounds — the
# one part of the guarded protocol that is not free (the per-round
# residual recurrence reuses the m x sb block the round already
# evaluates, and the health predicate is O(m) elementwise).  These
# closed forms let the autotuner pick the largest drift-correction
# cadence that keeps modeled overhead under a budget.
# --------------------------------------------------------------------------

GUARD_OVERHEAD_BUDGET = 0.10       # default: <= 10% modeled overhead


def guard_round_flops(m: int, n: int, kernel: str, *, b: int = 1,
                      s: int = 1, P: int = 1, f: float = 1.0,
                      mach: Machine = None) -> float:
    """Flops of ONE outer round of the (s-step) solver — the denominator
    of the overhead ratio (the guarded round itself adds only the O(m*sb)
    recurrence update, already inside this count's epilogue term)."""
    mach = mach or Machine()
    mu = _mu(mach, kernel)
    return (s * b * f * m * n / P + mu * s * b * m + s * b ** 3
            + math.comb(s, 2) * b ** 2 + s * b * m)


def recompute_flops(m: int, n: int, kernel: str, *, P: int = 1,
                    f: float = 1.0, approx: str = None, landmarks: int = 0,
                    mach: Machine = None) -> float:
    """Flops of one exact residual recompute ``f = K @ alpha``: the full
    m x m gram streamed block-wise through the operator (never stored)
    for the exact representation, two O(m l) linear contractions for the
    low-rank one."""
    if approx:
        return 2.0 * m * landmarks
    mach = mach or Machine()
    mu = _mu(mach, kernel)
    return f * m * m * n / P + mu * m * m


def choose_recompute_every(m: int, n: int, kernel: str, *, b: int = 1,
                           s: int = 1, P: int = 1, f: float = 1.0,
                           approx: str = None, landmarks: int = 0,
                           budget: float = GUARD_OVERHEAD_BUDGET,
                           mach: Machine = None) -> int:
    """Smallest drift-correction cadence (in outer rounds) whose modeled
    amortized overhead stays within ``budget``: recomputing every r
    rounds costs ``recompute/ (r * round)`` extra, so r >= recompute /
    (budget * round).  More frequent correction is strictly better for
    drift, so the floor IS the choice."""
    if budget <= 0:
        raise ValueError(f"budget must be > 0, got {budget!r}")
    per_round = guard_round_flops(m, n, kernel, b=b, s=s, P=P, f=f,
                                  mach=mach)
    rec = recompute_flops(m, n, kernel, P=P, f=f, approx=approx,
                          landmarks=landmarks, mach=mach)
    return max(1, math.ceil(rec / (budget * per_round)))


def guard_overhead(m: int, n: int, kernel: str, *, b: int = 1, s: int = 1,
                   P: int = 1, f: float = 1.0, recompute_every: int = 0,
                   approx: str = None, landmarks: int = 0,
                   mach: Machine = None) -> float:
    """Modeled fractional flop overhead of guarded mode at a given
    cadence (0 = drift correction off => only the free recurrence)."""
    if recompute_every < 1:
        return 0.0
    per_round = guard_round_flops(m, n, kernel, b=b, s=s, P=P, f=f,
                                  mach=mach)
    rec = recompute_flops(m, n, kernel, P=P, f=f, approx=approx,
                          landmarks=landmarks, mach=mach)
    return rec / (recompute_every * per_round)


# --------------------------------------------------------------------------
# The device's budget: what the pricing above needs to know of the card,
# read from the card (free memory) or measured on it (the host link).
# --------------------------------------------------------------------------

# Device slots of data chunks the port's streamed pipes keep: two in the
# round's pipe, three in the symmetric full matvec of every check
# (kernels/kmv_stream.py), so a streamed fit needs three.
STREAM_SLOTS = 3
# The share of the free device memory a streamed working set may take.
STREAM_SHARE = 0.5
# Bytes of the pinned chunk whose copy measures the host link.
DMA_PROBE_BYTES = 64 * 2 ** 20
# Rows of the square tiles of the symmetric pipe's chunk pairs
# (csrc/kmv_partial.cuh KMV_PAIR_BM).
PAIR_TILE = 128

_DMA_BPS = {}                       # device -> measured rate, a process


@dataclasses.dataclass(frozen=True)
class DeviceBudget:
    """What the tuner may spend on a device: ``hbm_bytes`` of device
    memory, ``stream_bytes`` for a streamed working set of ``slots``
    chunk slots, the host-to-device link at ``dma_bps``, and chunks of at
    least ``min_chunk_rows`` rows.

    The streaming model prices a chunk by its bytes and its operations
    only: not how far one launch fills the card, nor the
    n_chunks (n_chunks + 1) / 2 pair launches of every check's symmetric
    pipe.  Alone it picks the smallest chunk (the least warm-up), and on
    an H100 a 128-row chunk makes each check 12 403 one-tile launches.
    So on a CUDA card ``min_chunk_rows`` is the fewest rows whose chunk
    pair of PAIR_TILE-square tiles has a tile for every SM (ROADMAP C8);
    1 elsewhere, the JAX package's model."""

    hbm_bytes: int
    stream_bytes: int
    dma_bps: float
    slots: int = STREAM_SLOTS
    min_chunk_rows: int = 1

    @classmethod
    def of_device(cls, device) -> "DeviceBudget":
        """The budget of ``device`` now: on a CUDA card the free memory
        ``torch.cuda.mem_get_info`` reports, the measured link rate
        (``measure_dma_bps``) and the card's SM count; on the CPU the
        host's available memory, and no link (a CPU fit reads host memory
        where it lies)."""
        import torch
        dev = torch.device(device)
        if dev.type == "cuda":
            free, _ = torch.cuda.mem_get_info(dev)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            return cls(int(free), int(STREAM_SHARE * free),
                       measure_dma_bps(dev),
                       min_chunk_rows=PAIR_TILE * math.ceil(math.sqrt(sms)))
        free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
        return cls(int(free), int(STREAM_SHARE * free), float("inf"))


def measure_dma_bps(device, nbytes: int = DMA_PROBE_BYTES) -> float:
    """Host-to-device bytes a second of one pinned ``nbytes`` copy (the
    copy-only yardstick of the streamed pipe), timed with CUDA events
    after one untimed copy; measured once a process and device."""
    import torch
    dev = torch.device(device)
    key = (dev.type, dev.index if dev.index is not None
           else torch.cuda.current_device())
    if key not in _DMA_BPS:
        src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        dst.copy_(src, non_blocking=True)
        start.record()
        dst.copy_(src, non_blocking=True)
        end.record()
        end.synchronize()
        _DMA_BPS[key] = nbytes / (start.elapsed_time(end) * 1e-3)
    return _DMA_BPS[key]
