"""Hand-written CUDA kernels, their plain PyTorch versions and wrappers.

Nothing here builds or loads a kernel at import time: the first launch on
a CUDA tensor does (``_build.load``)."""
