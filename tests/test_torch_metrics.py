"""The port's training metrics (utils/metrics_writer.py, utils/logging.py,
the step's histograms, cli.train's logs) against the JAX package on the
CPU.

device_histogram: counts, lo, hi and num exact against JAX's on the same
float32 inputs; sum and sum_sq at rtol 1e-6 (the two reduce in other
orders). MetricsWriter rows equal to JAX's writer's, `ts` aside. A train
step's hist_det_cnt equals the JAX step's (its training forward and loss,
on the same init and batch) exactly (the ball counts are
integers, index-exact between the packages); hist_normalized_attention
has the same num, and its sum (1 per anchor cloud: a softmax) and range
within 1e-6.
"""
import json
import logging
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from feat3dnet_tpu.utils import metrics_writer as jmw
from feat3dnet_tpu_torch.utils import metrics_writer as mw

torch.set_num_threads(2)

CFG = dict(num_clusters=8, num_samples=8, feature_dim=16, base_scale=10.0,
           detector_mlp=(8,), detector_mlp2=(8,), descriptor_mlp=(8, 8))
INPUTS = {
    "seeded": lambda rs: rs.randn(3, 500).astype(np.float32) * 2.0 + 1.0,
    "constant": lambda rs: np.full((64,), 3.0, np.float32),
    "counts": lambda rs: rs.randint(0, 65, size=(18, 512)).astype(np.float32),
    "softmax": lambda rs: np.exp(rs.randn(6, 512)).astype(np.float32) / 700.0,
}


def _host(h):
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in h.items()}


def _assert_hist_equal(got, want, exact_sums=False):
    for k in ("counts", "lo", "hi", "num"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("sum", "sum_sq"):
        np.testing.assert_allclose(got[k], want[k], rtol=0 if exact_sums else 1e-6, err_msg=k)


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_device_histogram_matches_jax(name):
    x = INPUTS[name](np.random.RandomState(0))
    got = _host(mw.device_histogram(torch.from_numpy(x)))
    want = _host(jmw.device_histogram(jnp.asarray(x)))
    _assert_hist_equal(got, want)
    assert got["counts"].dtype == np.int32 and got["counts"].sum() == x.size
    if name == "constant":
        assert got["counts"][0] == x.size


def test_metrics_writer_rows_match_jax(tmp_path):
    x = INPUTS["counts"](np.random.RandomState(1))
    ours = mw.MetricsWriter(str(tmp_path / "port" / "metrics.jsonl"), tensorboard=True)
    theirs = jmw.MetricsWriter(str(tmp_path / "jax" / "metrics.jsonl"))
    for step in (1, 2):
        ours.write(step=step, loss=torch.tensor(0.5 / step),
                   sum_positive=torch.tensor(0.25), hist_det_cnt=mw.device_histogram(
                       torch.from_numpy(x + step)))
        theirs.write(step=step, loss=jnp.float32(0.5 / step), sum_positive=jnp.float32(0.25),
                     hist_det_cnt=jmw.device_histogram(jnp.asarray(x + step)))
    ours.write(step=2, fp_rate=0.125)
    theirs.write(step=2, fp_rate=0.125)
    ours.close()
    got, want = ours.read(), theirs.read()
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.pop("ts") > 0 and w.pop("ts") > 0
        assert g == w
    events = os.listdir(tmp_path / "port" / "tb")
    assert any(f.startswith("events.out.tfevents") for f in events)


def test_tensorboard_needs_its_package(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError, match="`tensorboard` package"):
        mw.MetricsWriter(str(tmp_path / "m.jsonl"), tensorboard=True)
    mw.MetricsWriter(str(tmp_path / "m.jsonl")).write(step=1, loss=0.5)


@pytest.mark.parametrize("fused", [False, True])
def test_step_metrics_carry_both_histograms(rng, fused):
    from feat3dnet_tpu.config import ModelConfig as JaxModelConfig
    from feat3dnet_tpu.config import TrainConfig as JaxTrainConfig
    from feat3dnet_tpu.models import Feat3DNet as JaxFeat3DNet
    from feat3dnet_tpu.train import trainer as jtr
    from feat3dnet_tpu.train.loss import alignment_triplet_loss as jax_loss
    from feat3dnet_tpu_torch.config import ModelConfig, TrainConfig
    from feat3dnet_tpu_torch.models import Feat3DNet
    from feat3dnet_tpu_torch.train import init_state, make_fused_train_step, make_train_step

    jcfg = JaxModelConfig(**CFG, fused_towers=fused, fused_cot_dtype=jnp.float32)
    jmodel = JaxFeat3DNet(jcfg)
    tx = jtr.make_optimizer(1e-3)
    jstate, _ = jtr.init_state(jmodel, JaxTrainConfig(num_points=64), jcfg,
                               jax.random.PRNGKey(0), tx=tx)
    variables = jax.tree.map(np.asarray, {"params": jstate.params,
                                          "batch_stats": jstate.batch_stats})
    cfg = ModelConfig(**CFG, fused_towers=fused, fused_cot_dtype=torch.float32)
    model = Feat3DNet(cfg)
    state = init_state(model, TrainConfig(num_points=64, learning_rate=1e-3), cfg,
                       variables=variables, device="cpu")
    a = rng.randn(2, 64, 3).astype(np.float32)
    p, n = a + 0.01 * rng.randn(2, 64, 3).astype(np.float32), rng.randn(2, 64, 3).astype(
        np.float32)
    # JAX's step histograms, from its training forward and loss
    out, _ = jmodel.apply({"params": jstate.params, "batch_stats": jstate.batch_stats},
                          jnp.asarray(np.concatenate([a, p, n])), training=True,
                          mutable=["batch_stats"])
    feats = jnp.split(out.features, 3, axis=0)
    _, aux = jax_loss(*feats, jnp.split(out.attention, 3, axis=0)[0], 1.0)
    jm = {"hist_det_cnt": jmw.device_histogram(out.end_points["det_cnt"].astype(jnp.float32)),
          "hist_normalized_attention": jmw.device_histogram(aux["normalized_attention"])}
    if fused:
        _, m = make_fused_train_step(model, 1.0, True)(state, torch.from_numpy(
            np.concatenate([a, p, n])))
    else:
        _, m = make_train_step(model, 1.0, True)(state, *map(torch.from_numpy, (a, p, n)))
    assert {"hist_det_cnt", "hist_normalized_attention"} <= m.keys()
    _assert_hist_equal(_host(m["hist_det_cnt"]), _host(jm["hist_det_cnt"]), exact_sums=True)
    got, want = _host(m["hist_normalized_attention"]), _host(jm["hist_normalized_attention"])
    assert got["num"] == want["num"] == 2 * 8 and got["counts"].sum() == 16
    for k in ("lo", "hi", "sum"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    assert 0 <= _host(m["hist_det_cnt"])["hi"] <= CFG["num_samples"]


def test_setup_logging_writes_its_file(tmp_path):
    from feat3dnet_tpu_torch.utils.logging import setup_logging

    path = str(tmp_path / "logs" / "log.txt")
    logger = setup_logging(path, level=logging.INFO)
    try:
        setup_logging(path)                     # handlers are added once
        assert sum(isinstance(h, logging.FileHandler) for h in logger.handlers) == \
            len({getattr(h, "baseFilename", None) for h in logger.handlers
                 if isinstance(h, logging.FileHandler)})
        logging.getLogger("feat3dnet_tpu_torch.train").info("hello %d", 7)
        for h in logger.handlers:
            h.flush()
        assert "hello 7" in open(path).read()
    finally:
        for h in list(logger.handlers):
            if isinstance(h, logging.FileHandler):
                logger.removeHandler(h)
                h.close()


def test_cli_train_tensorboard_and_log(tmp_path):
    """cli.train --tensorboard: event files under <log_dir>/tb, histogram
    rows in metrics.jsonl, the Arguments line in <log_dir>/log.txt."""
    from feat3dnet_tpu_torch.cli import train
    from tests.test_torch_train import _write_dataset

    _write_dataset(tmp_path / "data", np.random.RandomState(3))
    log_dir = tmp_path / "log"
    train.main(["--data_dir", str(tmp_path / "data"), "--log_dir", str(log_dir),
                "--num_points", "64", "--num_clusters", "8", "--num_samples", "8",
                "--batch_size", "2", "--num_epochs", "1", "--summary_every_n_steps", "1",
                "--device", "cpu", "--tensorboard", "--noattention"])
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(log_dir / "tb"))
    rows = [json.loads(x) for x in open(log_dir / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2]
    for r in rows:
        h = r["hist_det_cnt"]
        assert len(h["counts"]) == 16 and sum(h["counts"]) == h["num"] and h["hi"] <= 8
        assert "hist_normalized_attention" not in r          # --noattention
    assert "Arguments" in open(log_dir / "log.txt").read()
