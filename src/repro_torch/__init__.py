"""PyTorch/CUDA port of ``repro`` (Scalable Dual Coordinate Descent for
Kernel Methods), for NVIDIA Hopper.

The module layout mirrors the JAX package: ``core/kernels.py`` (kernel
math and ``ExactGramOperator``), the four solvers, the round driver
``core/loop.py``, ``core/objectives.py``, ``core/predict.py`` and the
``api.py`` facade; and for the LM workload ``models/`` (dense GQA
decoders: the training / prefill forward and loss, the KV-cache decode
step), ``configs/``, ``optim/`` (AdamW), ``data/tokens.py`` and
``train/`` (the microbatched train step, checkpoints, greedy generation
and the serving engine).  Every kernel (KMV, gram and the streamed KMV
of the solve path; RMSNorm and flash attention, forward and backward, of
the LM) is hand-written CUDA C++ under ``csrc/``, built at first use
(``kernels/build.py``); on CPU tensors every wrapper runs its plain
PyTorch version instead.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
