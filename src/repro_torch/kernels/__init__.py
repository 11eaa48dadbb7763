"""Hand-written Hopper kernels of the port, one family per subpackage.

Each family has a plain PyTorch ``ref.py`` (the CPU path and the oracle the
kernels are held to on the card) and a ``cuda.py`` of wrappers that build,
bind and launch the CUDA C++ source under its ``csrc/``; ``nvcc.py`` builds
the sources and holds the ctypes helpers they share.  Families:
``adaptive_update`` (the fused MindTheStep tick), ``flash_attention``,
``rg_lru`` and ``selective_scan`` (serving).
"""
