"""Offline dataset preparation — Python ports of the reference's MATLAB
layer (SURVEY.md §2.3: scripts_data_processing/) plus the submap converter.
The port's numpy copy of feat3dnet_tpu/dataprep/ (the same functions,
imported from this package only).

  normals.py      k-NN plane-fit normal estimation (findPointNormals.m)
  voxel.py        voxel-grid average downsampling (pcdownsample gridAverage)
  train_cases.py  train.txt generation (oxford_generate_train_cases.m)
  kitti.py        KITTI odometry: scan selection every 10 m, velodyne-frame
                  pair groundtruths, cloud processing (process_kitti_data.m)
  oxford.py       SE3 pose utilities + LMS scan accumulation
                  (oxford_build_pointclouds.m internals)
  submap.py       SLAM submap binary -> framework .bin (submap_converter.py)
"""
from feat3dnet_tpu_torch.dataprep.normals import estimate_normals
from feat3dnet_tpu_torch.dataprep.voxel import voxel_downsample
from feat3dnet_tpu_torch.dataprep.train_cases import generate_train_cases

__all__ = ["estimate_normals", "voxel_downsample", "generate_train_cases"]
