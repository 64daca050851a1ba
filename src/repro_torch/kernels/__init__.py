"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``ops`` is the dispatch layer the rest of the package calls; ``kmv``,
``gram``, ``kmv_stream``, ``rmsnorm`` and ``flash_attention`` hold one
kernel each (wrapper, launch count, plain version); ``ref`` holds the
oracles; ``build`` compiles ``csrc/``.
"""
