"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``ops`` is the dispatch layer the rest of the package calls; ``kmv`` and
``gram`` hold one kernel each (wrapper, launch count, plain version);
``ref`` holds the materializing oracles; ``build`` compiles ``csrc/``.
"""
