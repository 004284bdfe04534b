"""Port of eval/ (matching, RANSAC, metrics, validation, fig4), the held-out
suite and cli.match / cli.train's validation, against the JAX package.

* match_descriptors and mutual_matches: index-exact (the first of equal
  distances); squared distances within 1e-6 (4 ulps of |a|^2 + |b|^2 = 2,
  where the expansion rounds; sqrt then magnifies it for close pairs).
* estimate_rigid_transform, plain, weighted and batched: R within 2e-5
  and t within 2e-4 (f32 on coordinates of ~10 m; the SVDs differ in
  their signs and rounding).
* ransac_rigid on JAX's own Gumbel top-3 triples (`hypotheses=`): every
  triple's inlier count, the inlier mask and count equal; the refit R and
  t within the same limits. The port's own draw finds the same inliers.
* The metrics are numpy copies: equal.
* ClusterPairValidator on a written cluster folder, with the JAX weights
  carried across by utils/convert.py: the same FPR@95, descriptors within
  1e-5.
* fig4.evaluate_pair / evaluate_dataset: equal statistics.
* heldout.build_test_set writes the same bytes as
  examples/eval_inference_sweep.build_test_set.
* cli.match and cli.train's validation run on the CPU.
Small widths and clouds throughout.
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

from feat3dnet_tpu.config import ModelConfig as JaxModelConfig
from feat3dnet_tpu.eval import fig4 as jfig4
from feat3dnet_tpu.eval import matching as jmatch
from feat3dnet_tpu.eval import metrics as jmetrics
from feat3dnet_tpu.eval import ransac as jransac
from feat3dnet_tpu.eval.validate import ClusterPairValidator as JaxValidator
from feat3dnet_tpu.models import Feat3DNet as JaxFeat3DNet
from feat3dnet_tpu_torch.config import ModelConfig
from feat3dnet_tpu_torch.eval import fig4, heldout, matching, metrics, ransac
from feat3dnet_tpu_torch.eval.validate import ClusterPairValidator
from feat3dnet_tpu_torch.models import Feat3DNet
from feat3dnet_tpu_torch.utils import load_variables

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(num_clusters=-1, num_samples=8, feature_dim=16, base_scale=2.0,
             detector_mlp=(8, 16), detector_mlp2=(8,), descriptor_mlp=(8, 8))
RT_TOL = 2e-5


def _unit(rs, n, d=32):
    x = rs.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _rotation(rs):
    q = rs.randn(4)
    return fig4.rotmat_from_quat(q).astype(np.float32)


def test_matching_matches_jax():
    rs = np.random.RandomState(0)
    a, b = _unit(rs, 300), _unit(rs, 250)
    a[10] = a[5]                       # equal distances: the first index wins
    b[:40] = a[100:140] + 0.01 * rs.randn(40, 32).astype(np.float32)
    b[40] = a[5]
    ji, jd = jmatch.match_descriptors(jnp.asarray(a), jnp.asarray(b))
    ti, td = matching.match_descriptors(torch.from_numpy(a), torch.from_numpy(b))
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy() ** 2, np.asarray(jd) ** 2, rtol=0, atol=1e-6)
    assert ti[40].item() == 5
    jm = jmatch.mutual_matches(jnp.asarray(a), jnp.asarray(b))
    tm = matching.mutual_matches(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert 30 < tm.sum().item() < 250


@pytest.mark.parametrize("case", ["plain", "weighted", "batched"])
def test_estimate_rigid_transform_matches_jax(case):
    rs = np.random.RandomState(1)
    shape = (16, 3) if case == "batched" else (60,)
    src = (rs.randn(*shape, 3) * 5.0).astype(np.float32)
    r, t = _rotation(rs), rs.randn(3).astype(np.float32)
    dst = (src @ r.T + t + 0.02 * rs.randn(*src.shape)).astype(np.float32)
    w = None
    if case == "weighted":
        w = (rs.rand(60) > 0.4).astype(np.float32)
        dst[w == 0] += 3.0 * rs.randn(int((w == 0).sum()), 3).astype(np.float32)
    want = jransac.estimate_rigid_transform(
        jnp.asarray(src), jnp.asarray(dst), None if w is None else jnp.asarray(w))
    got = ransac.estimate_rigid_transform(
        torch.from_numpy(src), torch.from_numpy(dst), None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=RT_TOL)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation),
                               atol=RT_TOL * 10)
    if case != "batched":
        np.testing.assert_allclose(got.rotation.numpy(), r, atol=5e-3)
        np.testing.assert_allclose(got.apply(torch.from_numpy(src)).numpy(),
                                   np.asarray(want.apply(jnp.asarray(src))), atol=2e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_ransac_on_jax_triples_matches_jax(masked):
    rs = np.random.RandomState(2)
    n, k = 200, 256
    src = (rs.randn(n, 3) * 8.0).astype(np.float32)
    r, t = _rotation(rs), (rs.randn(3) * 3).astype(np.float32)
    dst = (src @ r.T + t + 0.05 * rs.randn(n, 3)).astype(np.float32)
    out = rs.rand(n) < 0.45                               # outliers, far off
    dst[out] = (rs.randn(int(out.sum()), 3) * 20.0).astype(np.float32)
    valid = rs.rand(n) > 0.1 if masked else None
    key = jax.random.PRNGKey(7)
    # JAX's own draw, as ransac_rigid makes it
    logits = jnp.where(jnp.asarray(np.ones(n, bool) if valid is None else valid), 0.0, -jnp.inf)
    _, triples = jax.lax.top_k(jax.random.gumbel(key, (k, n)) + logits[None, :], 3)
    jt, jmask, jcount = jransac.ransac_rigid(
        key, jnp.asarray(src), jnp.asarray(dst), 1.0, num_hypotheses=k,
        valid=None if valid is None else jnp.asarray(valid))
    tv = None if valid is None else torch.from_numpy(valid)
    tt, tmask, tcount = ransac.ransac_rigid(None, torch.from_numpy(src), torch.from_numpy(dst),
                                            1.0, valid=tv, hypotheses=np.array(triples))
    # every triple's inlier count
    s3, d3 = src[np.asarray(triples)], dst[np.asarray(triples)]
    jh = jransac.estimate_rigid_transform(jnp.asarray(s3), jnp.asarray(d3))
    th = ransac.estimate_rigid_transform(torch.from_numpy(s3), torch.from_numpy(d3))
    vm = np.ones(n, bool) if valid is None else valid

    def counts(rot, tr):
        resid = np.linalg.norm(np.einsum("kij,nj->kni", rot, src) + tr[:, None] - dst[None], axis=-1)
        return ((resid < 1.0) & vm[None]).sum(-1)
    np.testing.assert_array_equal(counts(th.rotation.numpy(), th.translation.numpy()),
                                  counts(np.asarray(jh.rotation), np.asarray(jh.translation)))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert tcount.item() == int(jcount) and tcount.item() >= 0.9 * (~out & vm).sum()
    np.testing.assert_allclose(tt.rotation.numpy(), np.asarray(jt.rotation), atol=RT_TOL)
    np.testing.assert_allclose(tt.translation.numpy(), np.asarray(jt.translation),
                               atol=RT_TOL * 10)
    # the port's own draw finds the same consensus
    gen = torch.Generator().manual_seed(0)
    _, gmask, _ = ransac.ransac_rigid(gen, torch.from_numpy(src), torch.from_numpy(dst), 1.0,
                                      num_hypotheses=k, valid=tv)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(jmask))


def test_metrics_equal_jax():
    rs = np.random.RandomState(3)
    pos, neg = rs.rand(500) * 0.8, rs.rand(700) * 0.5 + 0.4
    assert metrics.fpr_at_95_recall(pos, neg) == jmetrics.fpr_at_95_recall(pos, neg)
    err, valid = rs.rand(300) * 3, rs.rand(300) > 0.3
    assert metrics.precision_at_thresholds(err, valid) == \
        jmetrics.precision_at_thresholds(err, valid)
    score, target = rs.rand(400), rs.rand(400) > 0.6
    counts = rs.randint(1, 5, 400)
    for kw in ({}, {"instance_count": counts, "num_thresh": 20}):
        for a, b in zip(metrics.precision_recall(score, target, **kw),
                        jmetrics.precision_recall(score, target, **kw)):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def variables():
    rs = np.random.RandomState(4)
    model = JaxFeat3DNet(JaxModelConfig(**MODEL))
    v = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 3)), training=False)
    v = jax.tree.map(lambda x: x + 0.1 * rs.randn(*x.shape).astype(np.float32), v)
    v = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.abs(x) + 0.5 if "var" in jax.tree_util.keystr(p) else x, v)
    return model, jax.tree.map(np.asarray, v)


def _clusters(folder, n_pairs=12, seed=5):
    rs = np.random.RandomState(seed)
    places = [heldout.make_patch_place(rs, n_patches=6, extent=8.0) for _ in range(3)]
    heldout.write_cluster_pairs(str(folder), rs, places, n_pairs)


def test_validator_matches_jax(variables, tmp_path):
    jmodel, v = variables
    _clusters(tmp_path / "clusters")
    kw = dict(batch=8, max_cluster_points=128)
    jval = JaxValidator(jmodel, JaxModelConfig(**MODEL), str(tmp_path / "clusters"), **kw)
    cfg = ModelConfig(**MODEL)
    model = load_variables(Feat3DNet(cfg), v).eval()
    val = ClusterPairValidator(model, cfg, str(tmp_path / "clusters"), device="cpu", **kw)
    assert val.groundtruths == jval.groundtruths and len(val.groundtruths) == 12
    c, m = val._load_batch([0, 1, 2], 0)
    want = np.asarray(jval._describe(v, jnp.asarray(c), jnp.asarray(m)))
    np.testing.assert_allclose(val._describe(c, m), want, rtol=0, atol=1e-5)
    fpr = val()
    assert fpr == jval(v) and 0.0 <= fpr <= 1.0


def _fig4_folder(root, rs, pairs=2, n=400, k=60):
    data, res = root / "data", root / "res"
    os.makedirs(data), os.makedirs(res)
    lines = ["idx1 idx2 t1 t2 t3 q1 q2 q3 q4"]
    for p in range(pairs):
        c1 = (rs.rand(n, 3) * 20.0).astype(np.float32)
        q = rs.randn(4)
        q /= np.linalg.norm(q)
        t = rs.randn(3)
        r = fig4.rotmat_from_quat(q)
        c2 = ((c1 - t) @ r).astype(np.float32)            # r @ c2 + t == c1
        kp1, kp2 = c1[:k], c2[:k] + 0.3 * rs.randn(k, 3).astype(np.float32)
        d1 = _unit(rs, k)
        d2 = d1 + 0.3 * rs.randn(k, 32).astype(np.float32)
        for idx, cloud, kp, d in ((2 * p, c1, kp1, d1), (2 * p + 1, c2, kp2, d2)):
            np.concatenate([cloud, np.zeros_like(cloud)], 1).tofile(str(data / f"{idx}.bin"))
            np.concatenate([kp, d], 1).astype(np.float32).tofile(str(res / f"{idx}.bin"))
        lines.append(f"{2 * p} {2 * p + 1} " + " ".join(f"{x:.6f}" for x in (*t, *q)))
    (data / "groundtruths.txt").write_text("\n".join(lines))
    return str(data), str(res)


def test_fig4_matches_jax(tmp_path):
    data, res = _fig4_folder(tmp_path, np.random.RandomState(6))
    assert fig4.read_groundtruths(os.path.join(data, "groundtruths.txt")) is not None
    stats, summary = fig4.evaluate_dataset(data, res, log=lambda *_: None, device="cpu")
    jstats, jsummary = jfig4.evaluate_dataset(data, res, log=lambda *_: None)
    assert summary == jsummary and 0 < summary["total_correct"] < summary["total_putative"]
    for s, j in zip(stats, jstats):
        assert (s.num_putative, s.num_correct) == (j.num_putative, j.num_correct)
        np.testing.assert_array_equal(s.match_errors, j.match_errors)
    a = [np.fromfile(os.path.join(d, "0.bin"), np.float32).reshape(-1, w)
         for d, w in ((data, 6), (res, 35))]
    b = [np.fromfile(os.path.join(d, "1.bin"), np.float32).reshape(-1, w)
         for d, w in ((data, 6), (res, 35))]
    rot, t = np.eye(3), np.zeros(3)
    got = fig4.evaluate_pair(a[0], a[1][:, :3], a[1][:, 3:], b[0], b[1][:, :3], b[1][:, 3:],
                             rot, t, device="cpu")
    want = jfig4.evaluate_pair(a[0], a[1][:, :3], a[1][:, 3:], b[0], b[1][:, :3],
                               b[1][:, 3:], rot, t)
    assert (got.num_putative, got.num_correct) == (want.num_putative, want.num_correct)
    np.testing.assert_array_equal(got.match_errors, want.match_errors)
    np.testing.assert_array_equal(fig4.precision_curve(stats)[1],
                                  jfig4.precision_curve(jstats)[1])


def test_heldout_test_set_is_byte_equal(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        import eval_inference_sweep
    finally:
        sys.path.remove(os.path.join(ROOT, "examples"))
    got = heldout.build_test_set(str(tmp_path / "port"), 2)
    want = eval_inference_sweep.build_test_set(str(tmp_path / "jax"), 2)
    names = sorted(os.listdir(want))
    assert sorted(os.listdir(got)) == names and len(names) == 5
    for name in names:
        with open(os.path.join(got, name), "rb") as f, open(os.path.join(want, name), "rb") as g:
            assert f.read() == g.read(), name


def test_cli_match_runs_on_the_cpu(tmp_path, capsys):
    from feat3dnet_tpu_torch.cli import match

    rs = np.random.RandomState(8)
    kp1 = (rs.rand(80, 3) * 20.0).astype(np.float32)
    r, t = _rotation(rs), rs.randn(3).astype(np.float32)
    kp2 = ((kp1 - t) @ r).astype(np.float32)
    d = _unit(rs, 80)
    np.concatenate([kp1, d], 1).tofile(str(tmp_path / "a.bin"))
    np.concatenate([kp2, d + 0.01 * rs.randn(80, 32).astype(np.float32)], 1).astype(
        np.float32).tofile(str(tmp_path / "b.bin"))
    args = ["--desc1", str(tmp_path / "a.bin"), "--desc2", str(tmp_path / "b.bin"),
            "--device", "cpu", "--num_hypotheses", "128"]
    for extra in ([], ["--mutual"]):
        result = match.main(args + extra)
        printed = json.loads(capsys.readouterr().out)
        assert printed == result
        assert result["num_matches"] == 80 and result["num_inliers"] == 80
        np.testing.assert_allclose(np.asarray(result["rotation"]), r, atol=1e-4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            match.main(args[:-4])


def test_cli_train_logs_fp_rate(tmp_path, caplog):
    from feat3dnet_tpu_torch.cli import train

    rs = np.random.RandomState(9)
    os.makedirs(tmp_path / "data" / "train")
    lines = []
    for i in range(4):
        (rs.randn(200, 6) * 3.0).astype(np.float32).tofile(
            str(tmp_path / "data" / "train" / f"c{i}.bin"))
        others = [j for j in range(4) if j != i]
        lines.append(f"c{i}.bin | {others[0]} | {others[1]}")
    (tmp_path / "data" / "train" / "train.txt").write_text("\n".join(lines) + "\n")
    _clusters(tmp_path / "data" / "clusters", n_pairs=6)
    args = ["--data_dir", str(tmp_path / "data"), "--log_dir", str(tmp_path / "log"),
            "--num_points", "64", "--num_clusters", "8", "--num_samples", "8",
            "--batch_size", "2", "--num_epochs", "1", "--summary_every_n_steps", "1",
            "--device", "cpu", "--validate_every_n_steps", "1"]
    with caplog.at_level(logging.INFO, logger="feat3dnet_tpu_torch.train"):
        state = train.main(args)
    assert state.step == 2
    logged = [r.getMessage() for r in caplog.records if "FP Rate" in r.getMessage()]
    assert len(logged) == 2
    rows = [json.loads(x) for x in open(tmp_path / "log" / "metrics.jsonl")]
    fp = [r for r in rows if "fp_rate" in r]
    assert [r["step"] for r in fp] == [1, 2]
    assert all(0.0 <= r["fp_rate"] <= 1.0 for r in fp)
    assert [r["step"] for r in rows if "loss" in r] == [1, 2]
