"""Inference entry points of the port: cluster-descriptor serving,
whole-cloud keypoint extraction and PointNet++ segmentation."""
from feat3dnet_tpu_torch.inference.pipeline import InferencePipeline, InferenceResult
from feat3dnet_tpu_torch.inference.segmentation import SegmentationPipeline, SegmentationResult
from feat3dnet_tpu_torch.inference.serving import ClusterDescriptorServer

__all__ = ["ClusterDescriptorServer", "InferencePipeline", "InferenceResult",
           "SegmentationPipeline", "SegmentationResult"]
