"""Positive and negative fixtures for ``repro_torch.analysis``'s checks
(the port's counterpart of ``analysis_fixtures.py``): recorded kernel
launches with broken and sound plans, round functions, spans, a
streamed pipe's events and dataclasses.  The kernel fixtures are
``CapturedCall`` records as ``registry.capture`` makes them, so no
kernel runs."""
from __future__ import annotations

import dataclasses
import textwrap

import torch

from repro_torch.analysis.registry import CapturedCall

KMV = ("kmv_launch", "kmv.cu", 38)


def _kmv(**args) -> CapturedCall:
    base = dict(m=300, r=136, n=70, c=5, regime=2, bm=128, br=64, splits=3,
                rows_per_split=128, dtype=0)
    base.update(args)
    return CapturedCall("fixture", "kmv", "kmv_launch", "kmv.cu", 38, base)


def _gram(**args) -> CapturedCall:
    base = dict(m=200, r=136, n=700, bm=64, br=64, splits=22, per=1)
    base.update(args)
    return CapturedCall("fixture", "gram", "gram_launch", "gram.cu", 403,
                        base)


def sound_split():
    """kmv_plan's wide plan: 3 runs of 128 rows cover m = 300."""
    return [_kmv()]


def missing_split():
    """One split too few: rows 256..299 are in no run (the wrong kernel
    chip_smoke.py holds its parity check against)."""
    return [_kmv(splits=2)]


def sound_symmetric():
    """The symmetric plan: tiles (i <= j), each standing for its mirror."""
    return [_kmv(m=512, r=512, c=1, regime=3, bm=128, br=128, splits=4,
                 rows_per_split=128)]


def racing_symmetric():
    """A symmetric plan of two 256-row splits over four 128-column tiles:
    every row is covered, but the mirrors of column tiles 2 and 3 write
    workspace slices 2 and 3, past the plan's two."""
    return [_kmv(m=512, r=512, c=1, regime=3, bm=128, br=128, splits=2,
                 rows_per_split=256)]


def sound_gram():
    return [_gram()]


def gram_short_split():
    """The gram plan's last feature chunk in no split."""
    return [_gram(splits=21)]


def _flash_wgmma(q_off: int) -> CapturedCall:
    args = dict(q=4096 + q_off, k=8192, v=12288, o=16384, lse=20480, BH=2,
                S=512, Tk=512, hd=128, causal=1, scale=0.088, stream=0)
    return CapturedCall("fixture", "flash_fwd_wgmma",
                        "flash_fwd_wgmma_launch", "flash_fwd_wgmma.cu", 242,
                        args)


def aligned_tma():
    return [_flash_wgmma(0)]


def misaligned_tma():
    """q starts 4 bytes past a 16-byte boundary (a view one f32 in)."""
    return [_flash_wgmma(4)]


def _launched(smem: int) -> CapturedCall:
    call = _flash_wgmma(0)
    call.launches = [{"grid": (4, 2, 1), "block": (384, 1, 1),
                      "smem": smem}]
    return call


def modest_smem():
    return [_launched(160 * 1024)]


def smem_hog():
    """240 KiB of dynamic shared memory: over sm_90's 227 KiB opt-in."""
    return [_launched(240 * 1024)]


# ------------------------------------------------------- round functions --

SYNC_BAD = textwrap.dedent("""
    def make_foo_round_fn(A):
        def round_fn(alpha, i):
            if alpha[i] > 0:
                alpha = -alpha
            step = alpha.sum().item()
            return alpha * float(alpha[0]) + step
        return round_fn
""")

SYNC_GOOD = textwrap.dedent("""
    def make_foo_round_fn(A, gram_fn=None):
        def round_fn(alpha, xs):
            if gram_fn is not None:
                alpha = gram_fn(alpha)
            if A.ndim == 2 and len(xs) > 1:
                alpha = alpha + 1
            n = int(A.shape[0])
            return torch.where(alpha > 0, alpha, -alpha) * n
        return round_fn
""")

# --------------------------------------------------------------- spans --

SPAN_BAD = textwrap.dedent("""
    def f(x, name):
        span_begin("round")
        y = x + 1
        span_begin(name)
        span_end(name)
        span_end(f"chk{x}")
        return y
""")

SPAN_GOOD = textwrap.dedent("""
    def f(x, name):
        span_begin("round")
        span_begin(name)
        y = x + 1
        span_end(name)
        span_end("round")
        return y
""")

# ----------------------------------------------------------------- pipe --

PIPE_GOOD = textwrap.dedent("""
    int pipe(cudaStream_t cs, cudaStream_t ps) {
      cudaEventRecord(ready, cs);
      cudaStreamWaitEvent(ps, ready, 0);
      for (int i = 0; i < nc; ++i) {
        const int cur = i % 2, nxt = 1 - cur;
        if (i >= 1) cudaStreamWaitEvent(ps, freed[nxt], 0);
        cudaEventRecord(filled[nxt], ps);
        cudaStreamWaitEvent(cs, filled[cur], 0);
        cudaEventRecord(freed[cur], cs);
      }
      return 0;
    }
""")

# a consume wait on the slot the prefetch records, and a record no one
# waits on
PIPE_BAD = (PIPE_GOOD.replace("cudaStreamWaitEvent(cs, filled[cur], 0);",
                              "cudaStreamWaitEvent(cs, filled[nxt], 0);")
            .replace("cudaStreamWaitEvent(ps, ready, 0);", ""))


# ---------------------------------------------------------- dataclasses --

@dataclasses.dataclass
class CarriesTensors:
    alpha: torch.Tensor
    steps: int


@dataclasses.dataclass
class CarriesNumbers:
    steps: int
    rate: float
