"""PyTorch + CUDA port of feat3dnet_tpu for NVIDIA Hopper (H100).

The JAX package `feat3dnet_tpu` is the reference; this package keeps its
module paths and public names so each counterpart sits at the same path.
Ported so far: the inference forward (FPS centres, the exact ball query,
the detector/descriptor towers, the cluster-descriptor server) and
whole-cloud keypoint extraction (Morton-culled ball query, ball-max NMS,
the detector-only tower, `inference.InferencePipeline`, `cli.infer`) and
weakly supervised triplet training (the fused training towers, the loss,
Adam, augmentation, the triplet loader, checkpoints, `train.Trainer`,
`cli.train`). Its ten kernels are hand-written CUDA C++ under `csrc/`,
built with nvcc at first use (`kernels/`). Every kernel wrapper takes its plain PyTorch twin
for CPU tensors only; on CUDA tensors it launches the kernel or raises.
"""
from feat3dnet_tpu_torch.config import InferenceConfig, ModelConfig, TrainConfig

__all__ = ["InferenceConfig", "ModelConfig", "TrainConfig"]
