"""Inference entry points of the port (cluster-descriptor serving)."""
from feat3dnet_tpu_torch.inference.serving import ClusterDescriptorServer

__all__ = ["ClusterDescriptorServer"]
