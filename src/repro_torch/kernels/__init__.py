"""Hand-written CUDA kernels for Hopper (``csrc/``) with their wrappers and
plain PyTorch versions. Importing this package builds nothing: the kernels
are compiled at their first launch (``build.load_kernels``)."""
