"""Build the CUDA sources under ``repro_torch/csrc/`` at first use and
bind them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles, with its own ``nvcc`` process (all
started together), into ``lib<name>.so`` with a plain C interface for
``sm_90a``.  The libraries land in ``build/repro_torch/<hash>/`` at the
root of the checkout (git-ignored), keyed by a hash of every source in
``csrc/`` and the compiler flags, so an edited source rebuilds and an
unchanged one is reused.  A failed build raises; nothing falls back to
the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# --split-compile=0 compiles a source's kernels on all the host's cores:
# kmv.cu and kmv_stream.cu hold some forty instantiations each (the KMV
# regimes x dtypes), which one core compiles for minutes
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")

_P, _I = ctypes.c_void_p, ctypes.c_int
_F, _D = ctypes.c_float, ctypes.c_double
# each C entry point: its library (csrc/<library>.cu), symbol and
# argument types
SIGNATURES = {
    "kmv": ("kmv", "kmv_launch", [_P] * 5 + [_I] * 12 + [_F, _F, _P]),
    "kmv_f64": ("kmv", "kmv_f64_launch",
                [_P] * 5 + [_I] * 8 + [_D, _D, _P]),
    "gram": ("gram", "gram_launch",
             [_P] * 4 + [_I] * 7 + [_F, _F] + [_I] * 4 + [_P]),
    "gram_f64": ("gram", "gram_f64_launch",
                 [_P] * 3 + [_I] * 5 + [_D, _D, _P]),
    "kmv_stream": ("kmv_stream", "kmv_stream_launch",
                   [_P] * 7 + [_I] * 15 + [_F, _F, _P, _P]),
    "kmv_stream_f64": ("kmv_stream", "kmv_stream_f64_launch",
                       [_P] * 7 + [_I] * 10 + [_D, _D, _P, _P]),
    "kmv_stream_apply": ("kmv_stream", "kmv_stream_apply_launch",
                         [_P] * 7 + [_I] * 14 + [_F, _F, _P, _P]),
    "kmv_stream_apply_f64": ("kmv_stream", "kmv_stream_apply_f64_launch",
                             [_P] * 7 + [_I] * 10 + [_D, _D, _P, _P]),
    "kmv_stream_sym": ("kmv_stream", "kmv_stream_sym_launch",
                       [_P] * 5 + [_I] * 10 + [_F, _F, _P, _P]),
    "gather_rows": ("kmv_stream", "gather_rows_launch",
                    [_P] * 3 + [_I] * 4 + [_P]),
    "rmsnorm": ("rmsnorm", "rmsnorm_launch", [_P] * 3 + [_I] * 3 + [_F, _P]),
    "flash_fwd": ("flash_fwd", "flash_fwd_launch",
                  [_P] * 5 + [_I] * 7 + [_F, _P]),
    "flash_bwd": ("flash_bwd", "flash_bwd_launch",
                  [_P] * 9 + [_I] * 7 + [_F, _I, _P]),
    "flash_fwd_wgmma": ("flash_fwd_wgmma", "flash_fwd_wgmma_launch",
                        [_P] * 5 + [_I] * 5 + [_F, _P]),
    "flash_bwd_dkv_wgmma": ("flash_bwd_wgmma", "flash_bwd_dkv_wgmma_launch",
                            [_P] * 8 + [_I] * 5 + [_F, _P]),
    "flash_bwd_dq_wgmma": ("flash_bwd_dq_wgmma", "flash_bwd_dq_wgmma_launch",
                           [_P] * 7 + [_I] * 5 + [_F, _P]),
}

_LAUNCHERS: Dict[str, object] = {}
_LIBRARIES: Dict[str, ctypes.CDLL] = {}
LAUNCH_LOG_MAX = 64        # csrc/launch_log.cuh LAUNCH_LOG_MAX


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH): the CUDA kernels "
                       "cannot be built")


def sources() -> Dict[str, Path]:
    """``{name: path}`` of every ``csrc/*.cu`` translation unit."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, dict]:
    """Compile every source whose library is missing, in parallel.

    Returns ``{name: {"path", "seconds", "log"}}``; ``seconds`` is 0 and
    ``log`` the saved compiler output for a library that was already
    built.  Raises ``RuntimeError`` with the compiler's output if any
    build fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    info, procs = {}, {}
    for name, src in sources().items():
        lib = out_dir / f"lib{name}.so"
        log = out_dir / f"{name}.log"
        if lib.exists():
            info[name] = {"path": lib, "seconds": 0.0,
                          "log": log.read_text() if log.exists() else ""}
            continue
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True),
                       time.perf_counter(), tmp, lib, log)
    failures = []
    for name, (proc, t0, tmp, lib, log) in procs.items():
        text, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"--- {name} (exit {proc.returncode}) ---\n"
                            f"{text}")
            continue
        log.write_text(text)
        os.replace(tmp, lib)          # atomic: concurrent builds agree
        info[name] = {"path": lib, "seconds": seconds, "log": text}
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n"
                           + "\n".join(failures))
    return info


def sass_counts(library: str, ops=("HGMMA", "UTMALDG")) -> Dict[str, dict]:
    """``{kernel: {op: n}}``: the SASS lines of every kernel in the built
    ``lib<library>.so`` that hold each instruction of ``ops``, read with
    ``cuobjdump -sass`` from nvcc's directory (so a run can show that the
    tensor-core kernels hold ``HGMMA`` and the TMA loads ``UTMALDG``)."""
    cuobjdump = Path(find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass",
                           str(build_all()[library]["path"])],
                          capture_output=True, text=True, check=True).stdout
    kernels, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            kernels[name] = dict.fromkeys(ops, 0)
        elif name is not None:
            for op in ops:
                kernels[name][op] += op in line
    return kernels


def library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so`` of ``csrc/<name>.cu``, built on first
    use."""
    lib = _LIBRARIES.get(name)
    if lib is None:
        lib = _LIBRARIES[name] = ctypes.CDLL(str(build_all()[name]["path"]))
    return lib


def _read_launch_log(name: str):
    """``(launches noted since the last read, their records)`` of library
    ``name``, the log started afresh."""
    fn = library(name).launch_log_read
    fn.argtypes = [_P, _I]
    fn.restype = _I
    buf = (ctypes.c_ulonglong * (7 * LAUNCH_LOG_MAX))()
    return fn(ctypes.cast(buf, _P), LAUNCH_LOG_MAX), buf


def clear_launch_log(name: str) -> None:
    """Start library ``name``'s launch log afresh, whatever it noted."""
    _read_launch_log(name)


def launch_log(name: str) -> List[dict]:
    """The launches library ``name`` made since the last read (or
    ``clear_launch_log``), in order: ``{"grid", "block", "smem"}`` each
    (``csrc/launch_log.cuh``: the configuration each ``rt::launch``
    used); the log starts afresh.  Raises if more launches were made than
    the log holds."""
    n, buf = _read_launch_log(name)
    if n > LAUNCH_LOG_MAX:
        raise RuntimeError(f"lib{name}: {n} launches since the last read, "
                           f"more than the log's {LAUNCH_LOG_MAX}")
    return [{"grid": tuple(buf[7 * i:7 * i + 3]),
             "block": tuple(buf[7 * i + 3:7 * i + 6]),
             "smem": int(buf[7 * i + 6])} for i in range(n)]


def launcher(name: str):
    """The C entry point ``name`` of ``SIGNATURES``, its library built on
    first use, with its ctypes argument types set (pointers and streams
    as ``c_void_p``, so they are not cut to 32 bits)."""
    fn = _LAUNCHERS.get(name)
    if fn is None:
        library_name, symbol, argtypes = SIGNATURES[name]
        fn = getattr(library(library_name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LAUNCHERS[name] = fn
    return fn
