"""The kernel sites, their capture, and the registry of entry points that
reach them (the counterpart of ``repro/analysis/registry.py``).

The JAX module's sites are the ``pl.pallas_call`` expressions of its
kernels.  The port's are the C entry points of ``csrc/*.cu``: every
``extern "C" int <name>_launch(...)``, found by reading the sources
(``discover_sites``), each with the names of its parameters.

``capture`` wraps ``kernels.build.launcher`` with a recorder: every
launch a wrapper makes is kept as a ``CapturedCall`` with its entry
point, C entry, site and arguments by name (the plan: regime, tiles,
splits; the operand sizes and dtype code; the pointers as integers).
On the card the launch runs for real and the call also holds what the
library's ``rt::launch`` noted of each kernel it started
(``build.launch_log``: grid, block, dynamic shared memory).
Without a card the recorder returns 0 in place of the kernel (the JAX
module's stub runner): CPU tensors stand in for the card's and pinned
memory (``_launch.card_tensor`` / ``pinned_host``), the CUDA device,
stream and event calls of the wrappers are stubbed, and the SM count is
an H100 SXM's 132, so the wrappers' own Python runs to the launch and
records the plan it would launch; the outputs are left uninitialised.

``ENTRY_POINTS`` holds one representative concretization a route of
each public wrapper (the JAX module's eight, widened to the port's
routes: the f64 routes, the bf16 tensor-core flash kernels, the
streamed ``sym`` and ``apply`` pipes and ``gather_rows`` are sites of
their own).  ``kernel_check`` flags a site no entry point reaches
(CHK-SITE), so a forgotten registration is itself a finding.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import re
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build

CSRC_DIR = str(build.CSRC)
# an H100 SXM's streaming multiprocessors: the plans' SM count without a
# card
SM_COUNT_NO_CARD = 132

_ENTRY_RE = re.compile(r'extern\s+"C"\s+int\s+(\w+_launch)\s*\(([^)]*)\)',
                       re.S)


@dataclasses.dataclass(frozen=True)
class Site:
    """One C entry point: its symbol, file, line and parameter names."""

    symbol: str
    path: str
    line: int
    params: Tuple[str, ...]


def discover_sites(root: str = CSRC_DIR) -> List[Site]:
    """Every ``extern "C" int *_launch`` entry point of the sources under
    ``root``, read from the text."""
    sites = []
    for fname in sorted(os.listdir(root)):
        if not fname.endswith(".cu"):
            continue
        path = os.path.abspath(os.path.join(root, fname))
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        for m in _ENTRY_RE.finditer(text):
            params = tuple(re.findall(r"(\w+)\s*$", p.strip())[0]
                           for p in m.group(2).split(",") if p.strip())
            sites.append(Site(m.group(1), path,
                              text.count("\n", 0, m.start()) + 1, params))
    return sites


@dataclasses.dataclass
class CapturedCall:
    """One recorded launch of a C entry point."""

    entry: str                      # the registry entry that made it
    launcher: str                   # build.SIGNATURES key
    symbol: str
    path: str
    line: int
    args: Dict[str, object]         # by parameter name (pointers as ints)
    launches: Optional[List[dict]] = None   # card only: rt::launch notes

    @property
    def site(self) -> Tuple[str, int]:
        return (self.path, self.line)


class _StubStream:
    cuda_stream = 0


class _StubEvent:
    def __init__(self, *args, **kwargs):
        pass

    def record(self, stream=None) -> None:
        pass

    def query(self) -> bool:
        return True

    def synchronize(self) -> None:
        pass


@contextlib.contextmanager
def _no_card():
    """The wrappers' card-side calls stubbed (module docstring)."""
    from repro_torch.kernels import _launch, gram, kmv, kmv_stream
    patches = [(_launch, "card_tensor", lambda t: t.device.type == "cpu"),
               (_launch, "pinned_host", lambda t: t.device.type == "cpu"),
               (torch.cuda, "device", lambda d: contextlib.nullcontext()),
               (torch.cuda, "current_stream",
                lambda device=None: _StubStream()),
               (torch.cuda, "Stream", lambda *a, **k: _StubStream()),
               (torch.cuda, "Event", _StubEvent),
               (torch.cuda, "current_device", lambda: 0)]
    patches += [(mod, "sm_count", lambda i: SM_COUNT_NO_CARD)
                for mod in (gram, kmv, kmv_stream)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    streams = dict(kmv_stream._COPY_STREAMS)
    pending = list(kmv_stream._PENDING)
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        kmv_stream._COPY_STREAMS.clear()
        kmv_stream._COPY_STREAMS.update(streams)
        kmv_stream._PENDING[:] = pending


def on_card() -> bool:
    """Whether ``capture`` launches for real: a CUDA device is present."""
    return torch.cuda.is_available()


@contextlib.contextmanager
def capture(launch: Optional[bool] = None, entry: str = ""):
    """Record every C entry point launched in the block (module
    docstring); yields a namespace whose ``calls`` list gathers the
    ``CapturedCall`` rows, each tagged with ``state["entry"]`` as it
    stands at the launch.  ``launch``: run the kernels (default: when a
    card is present), else stub them."""
    launch = on_card() if launch is None else launch
    sites = {s.symbol: s for s in discover_sites()}
    calls: List[CapturedCall] = []
    real_launcher = build.launcher

    def recording(name: str):
        library, symbol, _ = build.SIGNATURES[name]
        site = sites[symbol]
        real = real_launcher(name) if launch else None

        def run(*args):
            rec = CapturedCall(state["entry"], name, symbol, site.path,
                               site.line, dict(zip(site.params, args)))
            calls.append(rec)
            if real is None:
                return 0
            build.clear_launch_log(library)    # drop earlier launches
            code = real(*args)
            rec.launches = build.launch_log(library)
            return code
        return run

    state = {"entry": entry}
    build.launcher = recording
    try:
        with (contextlib.nullcontext() if launch else _no_card()):
            yield SimpleNamespace(calls=calls, state=state)
    finally:
        build.launcher = real_launcher


# ---------------------------------------------------------- entry points --

@dataclasses.dataclass(frozen=True)
class EntryPoint:
    """A registered concretization: ``run(device, pin)`` drives a public
    wrapper on tensors made on ``device`` (``pin`` makes a tensor the
    streamed kernels read from host memory)."""

    name: str
    run: Callable


def _gen():
    return torch.Generator().manual_seed(0)


def _rand(shape, dtype=torch.float32, device="cpu"):
    return torch.randn(shape, generator=_gen()).to(dtype).to(device)


def _kmv(m, r, c, kernel, dtype=torch.float32, same=False):
    def go(device, pin):
        from repro_torch.core.kernels import KernelConfig
        from repro_torch.kernels.kmv import kmv_cuda
        A = _rand((m, 70), dtype, device)
        B = A if same else _rand((r, 70), dtype, device)
        X = _rand((m,) if c == 1 else (m, c), torch.float32, device)
        kmv_cuda(A, B, X, KernelConfig(kernel))
    return go


def _gram(m, r, n, dtype=torch.float32):
    def go(device, pin):
        from repro_torch.core.kernels import KernelConfig
        from repro_torch.kernels.gram import gram_cuda
        gram_cuda(_rand((m, n), dtype, device), _rand((r, n), dtype, device),
                  KernelConfig("rbf"))
    return go


def _stream(kind, dtype=torch.float32):
    def go(device, pin):
        from repro_torch.core.kernels import KernelConfig
        from repro_torch.kernels import kmv_stream as ks
        cfg = KernelConfig("rbf")
        Xc = pin(_rand((4, 24, 70), dtype))          # ragged: m = 90 rows
        if kind == "kmv":
            ks.kmv_stream_cuda(Xc, _rand((12, 70), dtype, device),
                               _rand((4, 24, 5), torch.float32, device),
                               cfg, m=90)
        elif kind == "full":
            ks.kmv_stream_full_cuda(Xc, _rand((4, 24, 1), torch.float32,
                                              device), cfg, m=90)
        elif kind == "apply":
            ks.kmv_stream_apply_cuda(Xc, _rand((8, 70), dtype, device),
                                     _rand((8, 3), torch.float32, device),
                                     cfg, m=90)
        else:
            ks.gather_rows_cuda(Xc, torch.arange(0, 90, 9, device=device))
    return go


def _rmsnorm(rows, D, dtype):
    def go(device, pin):
        from repro_torch.kernels.rmsnorm import rmsnorm_cuda
        rmsnorm_cuda(_rand((rows, D), dtype, device),
                     _rand((D,), torch.float32, device))
    return go


def _flash(dtype, hd, bwd):
    def go(device, pin):
        from repro_torch.kernels import flash_attention as fa
        BH, S = 2, 512
        q, k, v, do = (_rand((BH, S, hd), dtype, device) for _ in range(4))
        if not bwd:
            fa.flash_fwd_cuda(q, k, v, causal=True)
            return
        lse = _rand((BH, S), torch.float32, device)
        delta = _rand((BH, S), torch.float32, device)
        fa.flash_bwd_cuda(q, k, v, do, lse, delta, causal=True)
    return go


ENTRY_POINTS: Tuple[EntryPoint, ...] = (
    EntryPoint("kmv_cuda[rows,rbf]", _kmv(200, 3, 1, "rbf")),
    EntryPoint("kmv_cuda[narrow,linear]", _kmv(200, 40, 2, "linear")),
    EntryPoint("kmv_cuda[wide,rbf]", _kmv(300, 136, 5, "rbf")),
    EntryPoint("kmv_cuda[symmetric,rbf]", _kmv(4224, 4224, 1, "rbf",
                                               same=True)),
    EntryPoint("kmv_cuda[f64,rbf]", _kmv(200, 40, 3, "rbf", torch.float64)),
    EntryPoint("gram_cuda[f32,rbf]", _gram(200, 136, 700)),
    EntryPoint("gram_cuda[bf16,dot]", _gram(3, 4, 70, torch.bfloat16)),
    EntryPoint("gram_cuda[f64,rbf]", _gram(40, 24, 70, torch.float64)),
    EntryPoint("kmv_stream_cuda[f32]", _stream("kmv")),
    EntryPoint("kmv_stream_cuda[f64]", _stream("kmv", torch.float64)),
    EntryPoint("kmv_stream_full_cuda[sym]", _stream("full")),
    EntryPoint("kmv_stream_apply_cuda[f32]", _stream("apply")),
    EntryPoint("kmv_stream_apply_cuda[f64]",
               _stream("apply", torch.float64)),
    EntryPoint("gather_rows_cuda", _stream("gather")),
    EntryPoint("rmsnorm_cuda[bf16,2048]", _rmsnorm(520, 2048,
                                                   torch.bfloat16)),
    EntryPoint("rmsnorm_cuda[f32,200]", _rmsnorm(130, 200, torch.float32)),
    EntryPoint("flash_fwd_cuda[fma,f32]", _flash(torch.float32, 64, False)),
    EntryPoint("flash_fwd_cuda[wgmma,bf16]",
               _flash(torch.bfloat16, 128, False)),
    EntryPoint("flash_bwd_cuda[fma,f32]", _flash(torch.float32, 64, True)),
    EntryPoint("flash_bwd_cuda[wgmma,bf16]",
               _flash(torch.bfloat16, 128, True)),
)


def capture_entry_points(entries: Sequence[EntryPoint] = ENTRY_POINTS,
                         launch: Optional[bool] = None
                         ) -> List[CapturedCall]:
    """Drive every registered entry point under one ``capture``; each
    call is tagged with the entry that made it.  On the card the tensors
    are made there (the streamed data pinned) and the kernels run."""
    launch = on_card() if launch is None else launch
    device = "cuda" if launch else "cpu"

    def pin(t):
        return t.pin_memory() if launch else t

    with capture(launch) as cap:
        for ep in entries:
            cap.state["entry"] = ep.name
            ep.run(device, pin)
        if launch:
            torch.cuda.synchronize()
    return cap.calls


__all__ = ["CSRC_DIR", "CapturedCall", "ENTRY_POINTS", "EntryPoint", "Site",
           "capture", "capture_entry_points", "discover_sites", "on_card"]
