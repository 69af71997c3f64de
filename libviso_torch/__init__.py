"""libviso_torch: the stereo visual odometry engine in PyTorch and CUDA.

A port of ``libviso_tpu`` (the JAX package beside it, which stays the
reference) to PyTorch on an NVIDIA H100.  Plain tensor code is PyTorch;
the Pallas kernel on the main path is a hand-written CUDA kernel
(``csrc/``, built by ``_build.py`` at first use).  Public functions keep
the JAX package's names and array layouts, take an explicit ``device``
where they create tensors, and replace ``vmap`` with a leading batch axis.

Layout (as ``libviso_tpu``):
  ops/        detector, descriptors, matcher (+ the CUDA L1 kernel), circle
  geometry/   SE(3), epipolar geometry, triangulation, Horn alignment
  solvers/    Gauss-Newton and batched RANSAC
  pipeline/   the per-frame stereo step and the sequence driver
  io/, utils/ KITTI I/O, trajectory metrics
"""

import torch

# The reference computes in full float32 (precision="highest" throughout
# the JAX solver); TF32 would keep about three decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
