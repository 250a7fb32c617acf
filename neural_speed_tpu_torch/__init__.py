"""PyTorch/CUDA port of neural_speed_tpu: int4 weight-only serving on NVIDIA
Hopper through hand-written kernels (see `csrc/`).

Importing the package builds nothing and needs no GPU; the kernels are
compiled with `nvcc` on first use on the card (`_build.py`).
"""

from . import _build  # noqa: F401
