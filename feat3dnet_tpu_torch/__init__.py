"""PyTorch + CUDA port of feat3dnet_tpu for NVIDIA Hopper (H100).

The JAX package `feat3dnet_tpu` is the reference; this package keeps its
module paths and public names so each counterpart sits at the same path.
This slice ports the inference forward: FPS centres, the exact ball query,
the detector/descriptor towers, and the cluster-descriptor server. Its
three kernels (FPS, ball query, the fused describe tower) are hand-written
CUDA C++ under `csrc/`, built with nvcc at first use (`kernels/`). Every
kernel wrapper takes its plain PyTorch twin for CPU tensors only; on CUDA
tensors it launches the kernel or raises.
"""
from feat3dnet_tpu_torch.config import ModelConfig

__all__ = ["ModelConfig"]
