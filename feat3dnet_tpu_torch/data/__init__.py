"""Data IO for the port (numpy only)."""
from feat3dnet_tpu_torch.data.io import (example_cloud_path, example_data_dir,
                                         load_point_cloud, save_descriptors)

__all__ = ["example_cloud_path", "example_data_dir", "load_point_cloud",
           "save_descriptors"]
