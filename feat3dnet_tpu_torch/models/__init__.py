"""Model families: 3DFeat-Net detector + descriptor, and PointNet++ MSG
segmentation (PyTorch)."""
from feat3dnet_tpu_torch.models.feat3dnet import Feat3DNet, Feat3DNetOutput
from feat3dnet_tpu_torch.models.net_factory import get_network, register_network
from feat3dnet_tpu_torch.models.pointnet2 import PointNet2MSG, PointNet2Output

__all__ = ["Feat3DNet", "Feat3DNetOutput", "PointNet2MSG", "PointNet2Output", "get_network",
           "register_network"]
