"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``ops`` is the dispatch layer the rest of the package calls; ``kmv``,
``gram``, ``kmv_stream`` and ``rmsnorm`` hold one kernel each (wrapper,
launch count, plain version), ``flash_attention`` the flash forward and
the two backward kernels; ``rmsnorm`` and ``flash_attention`` also hold
the autograd Functions of the LM; ``ref`` holds the oracles; ``build``
compiles ``csrc/``.
"""
