"""Data for the port: cloud IO, the triplet loader and augmentation."""
from feat3dnet_tpu_torch.data.datagenerator import (TripletDataset, crop_and_resample,
                                                    parse_metadata, prefetch)
from feat3dnet_tpu_torch.data.io import (example_cloud_path, example_data_dir,
                                         load_point_cloud, save_descriptors,
                                         save_point_cloud)

__all__ = ["TripletDataset", "crop_and_resample", "example_cloud_path", "example_data_dir",
           "load_point_cloud", "parse_metadata", "prefetch", "save_descriptors",
           "save_point_cloud"]
