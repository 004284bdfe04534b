"""Model family: 3DFeat-Net detector + descriptor (PyTorch)."""
from feat3dnet_tpu_torch.models.feat3dnet import Feat3DNet, Feat3DNetOutput
from feat3dnet_tpu_torch.models.net_factory import get_network, register_network

__all__ = ["Feat3DNet", "Feat3DNetOutput", "get_network", "register_network"]
