"""sadvio_tpu_torch: the PyTorch/CUDA port of sadvio_tpu.

Stereo visual(-inertial) odometry on one NVIDIA GPU.  Plain tensor code is
PyTorch; the LK iteration loop is a CUDA kernel written for Hopper
(``ops/csrc/lk_iterate.cu``).  The subpackages mirror ``sadvio_tpu``'s, so a
module's counterpart sits at the same relative path.  This package never
imports JAX.  It does not choose a device: the caller names it
(``StereoSLAM(..., device=...)``).
"""

__version__ = "0.1.0"

import torch as _torch

# The estimation stack (Lie-group retractions, Schur complements, QR/eigh
# marginalization) means nothing at reduced precision: keep float32
# matrix products and convolutions in full float32, never TF32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
