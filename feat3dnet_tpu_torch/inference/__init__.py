"""Inference entry points of the port: cluster-descriptor serving and
whole-cloud keypoint extraction."""
from feat3dnet_tpu_torch.inference.pipeline import InferencePipeline, InferenceResult
from feat3dnet_tpu_torch.inference.serving import ClusterDescriptorServer

__all__ = ["ClusterDescriptorServer", "InferencePipeline", "InferenceResult"]
