"""The plain reference agrees with the port's CPU path at a tiny size."""
from __future__ import annotations

import os

import numpy as np
import torch

from portbench import harness, traffic
from portbench.reference import extract as R
from portbench.reference import model as M
from portbench.reference import train as RT
from portbench.tests.pb_small import small_run

EVAL = harness.load_json(os.path.join(harness.HERE, "configs", "feat3dnet-paper-eval.json"))
DATA = os.path.join(harness.ROOT, "examples", "data")


def test_fps_and_ball_query_equal_the_port_plain_versions():
    from feat3dnet_tpu_torch.ops.fps import farthest_point_sample_scan
    from feat3dnet_tpu_torch.ops.neighborhoods import ball_query_plain

    xyz = torch.from_numpy(traffic.load_xyz(DATA, "oxford_270.bin")[:2048])[None]
    idx = RT.fps(xyz, 64)
    assert torch.equal(idx, farthest_point_sample_scan(xyz, 64).long())
    centres = xyz[0, idx[0]]
    ref = R.ball_indices(xyz[0], centres, 2.0, 64)
    port, _ = ball_query_plain(xyz, centres[None], 2.0, 64)
    assert torch.equal(ref, port[0].long())


def test_describe_matches_the_port_at_the_trained_weights():
    from feat3dnet_tpu_torch.ops.fused_describe import (folded_weights,
                                                        fused_describe_clusters_t_plain,
                                                        pack_clusters_lanes_torch,
                                                        transpose_folded_weights)
    from feat3dnet_tpu_torch.utils.convert import load_variables_npz

    from portbench.entries.common import port_model_config

    spec = {"clouds": ["kitti_00_001554.bin"], "centres": 64, "num_samples": 64,
            "radius_m": 2.0, "batch": 128, "requests": 1}
    offs = torch.from_numpy(traffic.cluster_requests(DATA, spec, 5, "cpu")[0])
    mcfg = EVAL["model"]
    w = M.weights_from_npz(os.path.join(harness.ROOT, EVAL["weights"]), mcfg, "cpu")
    d_ref, a_ref = M.describe_clusters(w, mcfg, offs)
    v = load_variables_npz(os.path.join(harness.ROOT, EVAL["weights"]))
    wt = transpose_folded_weights(folded_weights(v, port_model_config(mcfg)))
    d, a = fused_describe_clusters_t_plain(wt, pack_clusters_lanes_torch(offs),
                                           port_model_config(mcfg))
    assert float((d - d_ref).abs().max()) < 1e-4
    assert float((a - a_ref).abs().max() / a_ref.max()) < 1e-5


def test_extraction_cell_agrees_with_the_port_on_the_cpu():
    out = small_run("extract-kitti-stream")
    c = out["checks"]
    assert out["correct"], c
    assert c["kp_set_gap"]["value"] == 0.0
    assert c["kp_att_gap"]["value"] < 1e-5 and c["desc_gap"]["value"] < 1e-4


def test_serving_cell_agrees_with_the_port_on_the_cpu():
    out = small_run("serve-clusters-7680")
    assert out["correct"], out["checks"]
    assert out["checks"]["desc_gap"]["value"] < 1e-5


def test_training_cell_agrees_with_the_port_on_the_cpu():
    out = small_run("train-oxford-fused")
    c = out["checks"]
    assert out["correct"], c
    assert c["loss_gap"]["value"] < 2e-5 and c["grad_gap"]["value"] < 1e-4


def test_augmentation_equals_the_ports_draws():
    from feat3dnet_tpu_torch.data.augment import augment_clouds
    from feat3dnet_tpu_torch.train.trainer import aug_generator

    xyz = torch.from_numpy(np.random.default_rng(0).normal(size=(6, 256, 3)).astype(np.float32))
    names = ["Jitter", "RotateSmall", "Shift", "RotateZ"]
    ref = RT.augment(RT.aug_generator("cpu", 11, 3), xyz, names)
    port = augment_clouds(aug_generator(torch.device("cpu"), 11, 3), xyz, names)
    assert torch.equal(ref, port)
