"""A run with the timed path broken underneath comes out not correct: per
cell, each fault it can have (an answer altered where it is produced; half
of a batch left out; a training step that leaves its state unchanged)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.tests.pb_small import small_run


def test_extraction_altered_descriptor(monkeypatch):
    from feat3dnet_tpu_torch.ops import fused_describe as fd

    real = fd.fused_describe_clusters_t

    def altered(*a, **kw):
        d, att = real(*a, **kw)
        d = d.clone()
        d[0] = -d[0]
        return d, att

    monkeypatch.setattr(fd, "fused_describe_clusters_t", altered)
    out = small_run("extract-kitti-stream")
    assert not out["correct"] and out["checks"]["desc_gap"]["value"] > 0.01


def test_extraction_half_of_a_batch_left_out(monkeypatch):
    from feat3dnet_tpu_torch.inference.pipeline import InferencePipeline

    real = InferencePipeline._finish

    def half(unit):
        res = real(unit)
        n = len(res) // 2
        return res[:len(res) - n] + res[:n]          # the second half gets the first's

    monkeypatch.setattr(InferencePipeline, "_finish", staticmethod(half))
    out = small_run("extract-kitti-stream")
    assert not out["correct"] and out["checks"]["kp_set_gap"]["value"] > 0.5


def test_extraction_altered_attention(monkeypatch):
    from feat3dnet_tpu_torch.ops import fused_describe as fd

    real = fd.fused_detect_clusters

    def altered(*a, **kw):
        att, ori = real(*a, **kw)
        return att * 1.001, ori

    monkeypatch.setattr(fd, "fused_detect_clusters", altered)
    out = small_run("extract-kitti-stream")
    assert not out["correct"] and out["checks"]["kp_att_gap"]["value"] > 1e-4


@pytest.mark.parametrize("fault", ["altered", "half"])
def test_serving_faults(monkeypatch, fault):
    from feat3dnet_tpu_torch.inference.serving import ClusterDescriptorServer

    real = ClusterDescriptorServer.__call__

    def broken(self, clusters):
        d, a = real(self, clusters)
        d = d.clone()
        if fault == "altered":
            d[0] = -d[0]
        else:
            d[d.shape[0] // 2:] = 0.0
        return d, a

    monkeypatch.setattr(ClusterDescriptorServer, "__call__", broken)
    out = small_run("serve-clusters-7680")
    assert not out["correct"] and out["checks"]["desc_gap"]["value"] > 0.1


def test_training_step_that_leaves_its_state_unchanged(monkeypatch):
    from feat3dnet_tpu_torch.train import trainer

    make = trainer.make_fused_train_step

    def broken(*a, **kw):
        step = make(*a, **kw)

        def unchanged(state, clouds):
            before = [p.detach().clone() for p in state.model.parameters()]
            state, metrics = step(state, clouds)
            with torch.no_grad():
                for p, b in zip(state.model.parameters(), before):
                    p.copy_(b)
            return state, metrics

        return unchanged

    monkeypatch.setattr(trainer, "make_fused_train_step", broken)
    out = small_run("train-oxford-fused")
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] > 0.9


def test_training_half_of_the_batch(monkeypatch):
    from feat3dnet_tpu_torch.train import trainer

    from portbench import readings

    monkeypatch.setattr(trainer, "make_fused_train_step", trainer.make_fused_train_step)
    readings.plant("half_batch")
    out = small_run("train-oxford-fused")
    assert not out["correct"]
    assert out["checks"]["loss_gap"]["value"] > 1e-3
