"""PyTorch/CUDA port of the ReaLB reproduction (``repro``).

Runs ReaLB serving of moonshot-v1-16b-a3b on an NVIDIA H100 through two
CUDA kernels written for ``sm_90a`` (``csrc/``): the NVFP4 weight quantizer
and the grouped W4A4 expert FFN.  The subpackages mirror ``repro``'s:
the counterpart of ``repro/x/y.py`` is ``repro_torch/x/y.py``.  The port
imports ``torch`` and ``numpy``, never ``jax`` and nothing of ``repro``.
"""
