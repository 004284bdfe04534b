"""The port's parallel package (feat3dnet_tpu_torch/parallel/) on the CPU.

Data parallelism: gloo ranks spawned through `run_ranks` (a `file://`
store in tmp_path, so pytest-xdist workers never share a port), each with
its role-aligned share of the combined batch, against one process on the
combined batch. The contract is the JAX docstrings': the data-parallel step
equals the single-process step. Tolerances:
* float64 (both routes, 2 ranks and 3 ranks of batch 6): every gradient
  leaf before the optimiser within 1e-9 of the leaf's largest |value|
  (a leaf whose single-process gradient is zero, |g| <= 1e-12, within
  1e-12 absolute), the loss, sum_positive, sum_negative, the BN buffers
  and the parameters after Adam within 1e-9 relative (the parameters also
  within 2e-9 absolute: Adam's first step moves a zero leaf by its
  rounding noise over Adam's eps), the histograms' bins equal;
* float32: every leaf within 1e-4 of its largest |value| (the leaves that
  are analytically zero, |g| <= 1e-4 max|g|, within 1e-3 absolute as in
  tests/test_torch_train.py), and every fused tower leaf's norm within
  1 +- 1e-4 of the single process's (not the ranks' count; the leaves that
  are analytically zero, the conv biases and the last mid conv's beta,
  left out);
* against JAX: the port's DP step and `make_shardmap_fused_dp_train_step`
  on a 2-device mesh from the same weights, at tests/test_parallel.py's
  `_assert_step_close` tolerances (loss rtol 1e-5, params atol 3 lr, BN
  statistics rtol 1e-4 / atol 1e-6, metrics rtol 1e-4 / atol 1e-5), and
  the port's gradients against JAX's single-device (eager) gradients on
  the combined batch at tests/test_torch_train.py's tolerances. JAX's own
  shard_map step is not the gradients' reference: it reduces the fused
  tower leaves twice (ROADMAP queue C). The generators differ
  (torch.Generator, jax.random), so the port's ranks take JAX's augmented
  batch.

Point parallelism (meshes of CPU devices, one process): every result bit
for bit against the single-device pipeline, and against JAX's mesh
pipeline at tests/test_parallel.py's tolerances. After a weight load the
fused route, the server's `describe_packed` and a mesh pipeline run the new
weights, bit for bit against fresh objects.

JAX is imported inside the tests that use it: the spawned ranks import
this module.
"""
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from feat3dnet_tpu_torch.config import InferenceConfig, ModelConfig, TrainConfig
from feat3dnet_tpu_torch.data.augment import augment_clouds, augment_rows
from feat3dnet_tpu_torch.inference import ClusterDescriptorServer, InferencePipeline
from feat3dnet_tpu_torch.models import Feat3DNet
from feat3dnet_tpu_torch.parallel import (keypoint_sharded_attention, make_fused_dp_train_step,
                                          make_mesh, run_ranks, shard_batch)
from feat3dnet_tpu_torch.parallel.mesh import chunk_shards
from feat3dnet_tpu_torch.train.trainer import (aug_generator, init_state,
                                               make_fused_train_step, role_rows)
from feat3dnet_tpu_torch.utils import init_variables, variables_from_module
from feat3dnet_tpu_torch.utils.collectives import all_reduce_sum

torch.set_num_threads(2)

# tests/test_parallel.py's configuration: batch 8 x 64 points
CFG = dict(num_clusters=8, num_samples=8, feature_dim=16, base_scale=10.0,
           detector_mlp=(8,), detector_mlp2=(8,), descriptor_mlp=(8, 8))
N = 64
LR = TrainConfig().learning_rate
AUG = ("RotateSmall", "Jitter")
TOWER = ("detection.conv0.", "description.conv0.", "description.conv1.",
         "description.conv_mid_0.")


def _stacked(seed, b):
    rng = np.random.RandomState(seed)
    a = rng.randn(b, N, 3).astype(np.float32)
    p = a + 0.01 * rng.randn(b, N, 3).astype(np.float32)
    n = a + 0.2 * rng.randn(b, N, 3).astype(np.float32)
    return np.concatenate([a, p, n])


def _cfg(route, dtype):
    if route == "fused":
        return ModelConfig(**CFG, fused_towers=True, fused_cot_dtype=dtype)
    return ModelConfig(**CFG)


def _numpy(t):
    if isinstance(t, dict):
        return {k: _numpy(v) for k, v in t.items()}
    return t.detach().cpu().numpy().copy()


def run_step(route, dtype, stacked, variables=None, aug=None, group=None, rank=0, world=1):
    """One fused-step call (the DP step's share with a group) -> numpy of the
    grads before the optimiser, the metrics, the BN buffers and the params
    after it."""
    cfg = _cfg(route, dtype)
    model = Feat3DNet(cfg, bn_group=group)
    state = init_state(model, TrainConfig(num_points=N), cfg,
                       variables=variables or init_variables(cfg, seed=0), device="cpu")
    model.to(dtype)
    clouds = torch.from_numpy(stacked)
    if group is not None:
        clouds = shard_batch(clouds, rank, world)
        step = make_fused_dp_train_step(model, 1.0, cfg.attention, group,
                                        augmentations=aug, aug_seed=3)
    else:
        step = make_fused_train_step(model, 1.0, cfg.attention, augmentations=aug, aug_seed=3)
    state, metrics = step(state, clouds)
    return {"grads": {k: _numpy(p.grad) for k, p in model.named_parameters()},
            "metrics": _numpy(metrics),
            "buffers": {k: _numpy(b) for k, b in model.named_buffers()},
            "params": {k: _numpy(p) for k, p in model.named_parameters()}}


def _collective_check(rank, group):
    """all_reduce_sum's forward sums x and its backward the cotangents."""
    x = torch.tensor([1.0, -2.0], dtype=torch.float64, requires_grad=True)
    y = all_reduce_sum(x * (rank + 1), group)
    (y * torch.tensor([3.0, 5.0], dtype=torch.float64) * (rank + 2)).sum().backward()
    return _numpy(y), _numpy(x.grad)


def dp_ranks(rank, world, group, dev, cases):
    """The rank body of the gradient groups: every case's DP step, then
    this rank's augmented rows and the collective's check."""
    out = {key: run_step(*case, group=group, rank=rank, world=world)
           for key, case in cases.items()}
    stacked = next(iter(cases.values()))[2]
    local = shard_batch(torch.from_numpy(stacked), rank, world)
    rows = role_rows(local.shape[0] // 3, rank, world)
    out["aug"] = _numpy(augment_rows(aug_generator(local.device, 3, 0), local, AUG, rows,
                                     stacked.shape[0]))
    out["collective"] = _collective_check(rank, group)
    return out


def _leaf_close(got, want, rtol, zero_atol, zero_below, what):
    top = np.abs(want).max()
    if top <= zero_below:
        assert np.abs(got - want).max() <= zero_atol, what
    else:
        assert np.abs(got - want).max() <= rtol * top, (what, np.abs(got - want).max() / top)


def _assert_dp_equal(dp, single, rtol):
    """float64: the step's numbers on rank 0 (every rank holds the same)."""
    for k, g in single["grads"].items():
        _leaf_close(dp["grads"][k], g, rtol, 1e-12, 1e-12, k)
    for k in ("loss", "sum_positive", "sum_negative"):
        np.testing.assert_allclose(dp["metrics"][k], single["metrics"][k], rtol=rtol, err_msg=k)
    for k, h in single["metrics"].items():
        if k.startswith("hist_"):
            for f in ("lo", "hi", "counts", "num"):
                np.testing.assert_array_equal(dp["metrics"][k][f], h[f], err_msg=k + f)
            for f in ("sum", "sum_sq"):
                np.testing.assert_allclose(dp["metrics"][k][f], h[f], rtol=1e-6, err_msg=k + f)
    for k, v in single["buffers"].items():
        np.testing.assert_allclose(dp["buffers"][k], v, rtol=rtol, atol=1e-12, err_msg=k)
    # Adam's first step is lr g / (|g| + 1e-8): a leaf within the zero rule
    # moves by at most lr 1e-12 / 1e-8 either way
    for k, v in single["params"].items():
        np.testing.assert_allclose(dp["params"][k], v, rtol=rtol, atol=2 * LR * 1e-4,
                                   err_msg=k)


def _cases(stacked, dtypes):
    return {(route, str(dt)): (route, dt, stacked, None, None)
            for route in ("autograd", "fused") for dt in dtypes}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The two spawned groups, run in threads while JAX computes its side:
    2 gloo ranks (both routes in float64 and f32 on batch 8, and the JAX
    case on JAX's augmented batch) and 3 gloo ranks (batch 6, both routes
    in float64). Also JAX's shard_map DP step on a 2-device mesh and its
    single-device (eager) gradients on the combined augmented batch, from
    the port's seeded weights."""
    import threading

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from feat3dnet_tpu.config import ModelConfig as JaxModelConfig
    from feat3dnet_tpu.config import TrainConfig as JaxTrainConfig
    from feat3dnet_tpu.data.augment import augment_clouds as jax_augment
    from feat3dnet_tpu.models import Feat3DNet as JaxFeat3DNet
    from feat3dnet_tpu.parallel import make_mesh as jax_mesh
    from feat3dnet_tpu.parallel import make_shardmap_fused_dp_train_step
    from feat3dnet_tpu.train import trainer as jtr
    from feat3dnet_tpu.train.loss import alignment_triplet_loss as jax_loss

    variables = init_variables(_cfg("autograd", torch.float32), seed=0)
    stacked = jnp.asarray(_stacked(0, 8))
    augmented = jax_augment(jax.random.fold_in(jax.random.PRNGKey(3), 0), stacked, AUG)
    plans = {"world2": (2, _stacked(0, 8), (torch.float64, torch.float32)),
             "world3": (3, _stacked(1, 6), (torch.float64,))}
    out, threads = {}, []
    for name, (world, batch, dtypes) in plans.items():
        cases = _cases(batch, dtypes)
        if world == 2:
            cases["jax"] = ("autograd", torch.float32, np.asarray(augmented), variables, None)
        init = str(tmp_path_factory.mktemp(name) / "store")

        def run(name=name, world=world, batch=batch, cases=cases, init=init):
            try:
                out[name] = (batch, cases, run_ranks(
                    dp_ranks, world, "gloo", init_file=init, args=(cases,), timeout=300,
                    collective_timeout=120, threads=1))
            except BaseException as e:   # re-raised in the test's thread
                out[name] = e

        threads.append(threading.Thread(target=run))
        threads[-1].start()

    jcfg = JaxModelConfig(**CFG)
    tx = jtr.make_optimizer(JaxTrainConfig().learning_rate)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = jtr.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                           opt_state=tx.init(params))
    mesh = jax_mesh(2)
    dp = make_shardmap_fused_dp_train_step(
        JaxFeat3DNet(jcfg, bn_axis_name="data"), tx, 1.0, jcfg.attention, mesh,
        augmentations=AUG, aug_seed=3, donate_state=False)
    s2, m2 = dp(state, jax.device_put(stacked, NamedSharding(mesh, PartitionSpec("data"))))
    jmodel = JaxFeat3DNet(jcfg)

    def loss_fn(params):
        o, _ = jmodel.apply({"params": params, "batch_stats": state.batch_stats}, augmented,
                            training=True, mutable=["batch_stats"])
        fa, fp, fn = jnp.split(o.features, 3, axis=0)
        return jax_loss(fa, fp, fn, jnp.split(o.attention, 3, axis=0)[0], 1.0)[0]

    out["jax"] = {"dp_state": jax.tree.map(np.asarray, {"params": s2.params,
                                                        "batch_stats": s2.batch_stats}),
                  "dp_metrics": jax.tree.map(np.asarray, m2),
                  "grads": jax.tree.map(np.asarray, jax.grad(loss_fn)(state.params))}
    for t in threads:
        t.join()
    return out


def _group(groups, name):
    if isinstance(groups[name], BaseException):
        raise groups[name]
    return groups[name]


@pytest.fixture(scope="module")
def world2(groups):
    return _group(groups, "world2")


@pytest.fixture(scope="module")
def world3(groups):
    return _group(groups, "world3")


@pytest.fixture(scope="module")
def jax_case(groups):
    return groups["jax"]


@pytest.mark.parametrize("world", ["world2", "world3"])
@pytest.mark.parametrize("route", ["autograd", "fused"])
def test_dp_step_equals_one_process_float64(request, world, route):
    stacked, cases, ranks = request.getfixturevalue(world)
    key = (route, str(torch.float64))
    single = run_step(*cases[key])
    for r, res in enumerate(ranks):
        _assert_dp_equal(res[key], single, 1e-9)
        if r:   # every rank holds the same state
            for k, v in ranks[0][key]["params"].items():
                np.testing.assert_array_equal(res[key]["params"][k], v)


@pytest.mark.parametrize("route", ["autograd", "fused"])
def test_dp_step_equals_one_process_float32(world2, route):
    stacked, cases, ranks = world2
    key = (route, str(torch.float32))
    single, dp = run_step(*cases[key]), ranks[0][key]
    top = max(np.abs(g).max() for g in single["grads"].values())
    for k, g in single["grads"].items():
        _leaf_close(dp["grads"][k], g, 1e-4, 1e-3, 1e-4 * top, k)
    for k in ("loss", "sum_positive", "sum_negative"):
        np.testing.assert_allclose(dp["metrics"][k], single["metrics"][k], rtol=1e-4, err_msg=k)
    for k, v in single["buffers"].items():
        np.testing.assert_allclose(dp["buffers"][k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    # each tower leaf is reduced once: its norm is the single process's, not
    # 2x (the leaves that are analytically zero carry only rounding noise)
    tower = [k for k, g in single["grads"].items() if k.startswith(TOWER)
             and np.abs(g).max() > 1e-4 * top]
    assert len(tower) == 11, tower
    for k in tower:
        ratio = np.linalg.norm(dp["grads"][k]) / np.linalg.norm(single["grads"][k])
        assert abs(ratio - 1.0) <= 1e-4, (k, ratio)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _flax_layout(named):
    """The port's named leaves -> flax paths (a Dense weight as the kernel)."""
    out = {}
    for name, v in named.items():
        *scope, leaf = name.split(".")
        out["/".join(scope + ["kernel" if leaf == "weight" else leaf])] = \
            v.T if leaf == "weight" else v
    return out


def test_dp_step_against_jax(world2, jax_case):
    """Loss, BN statistics, params and metrics against JAX's shard_map DP
    step; the gradients against JAX's single-device step."""
    dp = world2[2][0]["jax"]
    jm = jax_case["dp_metrics"]
    np.testing.assert_allclose(dp["metrics"]["loss"], jm["loss"], rtol=1e-5, atol=1e-6)
    for k in ("sum_positive", "sum_negative"):
        np.testing.assert_allclose(dp["metrics"][k], jm[k], rtol=1e-4, atol=1e-5, err_msg=k)
    for k in ("hist_det_cnt", "hist_normalized_attention"):
        assert set(dp["metrics"][k]) == set(jm[k])
        for f, v in jm[k].items():
            np.testing.assert_allclose(dp["metrics"][k][f], v, rtol=1e-4, atol=1e-5,
                                       err_msg=k + f)
    params = _flax_layout(dp["params"])
    for path, w in _flat(jax_case["dp_state"]["params"]).items():
        np.testing.assert_allclose(params[path], w, rtol=1e-4, atol=3 * LR, err_msg=path)
    stats = _flax_layout(dp["buffers"])
    for path, w in _flat(jax_case["dp_state"]["batch_stats"]).items():
        np.testing.assert_allclose(stats[path], w, rtol=1e-4, atol=1e-6, err_msg=path)
    want = _flat(jax_case["grads"])
    got = _flax_layout(dp["grads"])
    assert got.keys() == want.keys()
    top = max(np.abs(g).max() for g in want.values())
    for path, w in want.items():
        if np.abs(w).max() <= 1e-4 * top:      # analytically zero: rounding noise
            np.testing.assert_allclose(got[path], w, atol=1e-3, err_msg=path)
        else:
            np.testing.assert_allclose(got[path], w, rtol=5e-3,
                                       atol=5e-4 * max(np.abs(w).max(), 1e-3), err_msg=path)


def test_augmented_rows_and_collective(world2):
    stacked, _, ranks = world2
    whole = _numpy(augment_clouds(aug_generator(torch.device("cpu"), 3, 0),
                                  torch.from_numpy(stacked), AUG))
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["aug"], shard_batch(whole, r, 2))
        y, g = res["collective"]
        np.testing.assert_array_equal(y, [3.0, -6.0])            # (1 + 2) x
        np.testing.assert_array_equal(g, [15.0 * (r + 1), 25.0 * (r + 1)])  # (2 + 3) c


# ---- small cases ------------------------------------------------------------


@pytest.fixture
def group1(tmp_path):
    """A gloo group of this process alone."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("route", ["autograd", "fused"])
def test_world_of_one_is_the_plain_step(group1, route):
    stacked = _stacked(2, 2)
    got = run_step(route, torch.float32, stacked, aug=AUG, group=group1)
    want = run_step(route, torch.float32, stacked, aug=AUG)
    for what in ("grads", "metrics", "buffers", "params"):
        for k, v in want[what].items():
            if isinstance(v, dict):
                for f, x in v.items():
                    np.testing.assert_array_equal(got[what][k][f], x, err_msg=k + f)
            else:
                np.testing.assert_array_equal(got[what][k], v, err_msg=f"{what} {k}")


def test_refusals():
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(torch.zeros(15, N, 3), 0, 2)
    with pytest.raises(ValueError, match="does not split"):
        shard_batch((np.zeros((3, N, 3)),) * 3, 1, 2)
    cfg = _cfg("fused", torch.float32)
    with pytest.raises(ValueError, match="bn_group"):
        make_fused_dp_train_step(Feat3DNet(cfg), 1.0, True, group=object())
    with pytest.raises(ValueError, match="not both"):
        InferencePipeline(Feat3DNet(cfg), None, cfg, device="cpu", mesh=make_mesh(2, "cpu"),
                          cloud_mesh=make_mesh(2, "cpu"))
    with pytest.raises(ValueError, match="128-aligned"):
        InferencePipeline(Feat3DNet(cfg), None, cfg, InferenceConfig(use_hashed_grouping=True),
                          mesh=make_mesh(3, "cpu")).extract(np.zeros((100, 3), np.float32))
    assert chunk_shards(96, 32, 2) == [(0, 64), (64, 96)]
    assert chunk_shards(8192, 8192, 2) == [(0, 8192), (8192, 8192)]


# ---- point parallelism ----------------------------------------------------------

PCFG = dict(num_clusters=-1, num_samples=8, feature_dim=16, base_scale=2.0,
            detector_mlp=(8, 16), detector_mlp2=(8,), descriptor_mlp=(8, 8))


def _variables(cfg, seed):
    """A seeded variable tree away from the init's zero biases and unit BN
    statistics."""
    v = init_variables(cfg, seed=seed)
    rng = np.random.RandomState(seed)
    for col in v.values():
        stack = [col]
        while stack:
            d = stack.pop()
            for k, x in d.items():
                if isinstance(x, dict):
                    stack.append(x)
                else:
                    d[k] = (x + 0.1 * rng.randn(*x.shape)).astype(np.float32)
                    if k == "var":
                        d[k] = np.abs(d[k]) + 0.5
    return v


def _inference_model(seed=3):
    from feat3dnet_tpu_torch.utils import load_variables

    cfg = ModelConfig(**PCFG)
    return cfg, load_variables(Feat3DNet(cfg), _variables(cfg, seed)).eval()


def _same(got, want):
    assert got.num_keypoints == want.num_keypoints
    np.testing.assert_array_equal(got.keypoints, want.keypoints)
    np.testing.assert_array_equal(got.attention, want.attention)
    np.testing.assert_array_equal(got.features, want.features)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_keypoint_sharded_attention_bit_equal(n_dev):
    cfg, model = _inference_model()
    rng = np.random.RandomState(1)
    cloud = torch.from_numpy((rng.rand(1, 256, 3).astype(np.float32) - 0.5) * 8.0)
    valid = torch.ones((1, 256), dtype=torch.bool)
    with torch.no_grad():
        for chunk in (32, None):
            ref = InferencePipeline(model, None, cfg, InferenceConfig(
                keypoint_chunk=chunk or 256 // n_dev), device="cpu")
            want = ref._chunked_attention(cloud, valid)
            got = keypoint_sharded_attention(model, make_mesh(n_dev, "cpu"), chunk)(cloud, valid)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("route", ["dense", "hashed", "fused"])
@pytest.mark.parametrize("n_dev", [2, 4])
def test_mesh_extract_bit_equal(route, n_dev):
    """mesh= extract against extract: keypoints index-exact, features and
    attention bit-equal. On the fused route the CPU runs K6's and K3's plain
    versions, and K3's plain version (torch GEMMs over the keypoints of a
    shard) rounds a feature by up to one f32 step (6e-8) otherwise than
    over all K; the kernel computes each cluster alone, and chip_smoke
    phase 21c holds it bit-equal on the card."""
    cfg, model = _inference_model()
    icfg = InferenceConfig(use_hashed_grouping=route != "dense",
                           use_fused_detector=route == "fused", keypoint_chunk=1024,
                           max_keypoints=32, nms_radius=1.0)
    cloud = (np.random.RandomState(4).rand(3000, 6).astype(np.float32) - 0.5) * 12.0
    want = InferencePipeline(model, None, cfg, icfg, device="cpu").extract(cloud)
    got = InferencePipeline(model, None, cfg, icfg, mesh=make_mesh(n_dev, "cpu")).extract(cloud)
    assert want.num_keypoints > 4
    if route != "fused":
        _same(got, want)
        return
    assert got.num_keypoints == want.num_keypoints
    np.testing.assert_array_equal(got.keypoints, want.keypoints)
    np.testing.assert_array_equal(got.attention, want.attention)
    np.testing.assert_allclose(got.features, want.features, rtol=0, atol=1e-7)


def test_mesh_extract_against_jax():
    """The port's mesh pipeline against JAX's InferencePipeline(mesh=
    make_mesh(2)) at tests/test_parallel.py's tolerances (dense route)."""
    import jax
    import jax.numpy as jnp

    from feat3dnet_tpu.config import InferenceConfig as JaxInferenceConfig
    from feat3dnet_tpu.config import ModelConfig as JaxModelConfig
    from feat3dnet_tpu.inference import InferencePipeline as JaxPipeline
    from feat3dnet_tpu.models import Feat3DNet as JaxFeat3DNet
    from feat3dnet_tpu.parallel import make_mesh as jax_mesh

    cfg, model = _inference_model()
    cloud = (np.random.RandomState(0).rand(300, 6).astype(np.float32) - 0.5) * 10.0
    icfg = dict(max_keypoints=16, keypoint_chunk=1024, use_hashed_grouping=False)
    got = InferencePipeline(model, None, cfg, InferenceConfig(**icfg),
                            mesh=make_mesh(2, "cpu")).extract(cloud)
    v = jax.tree.map(jnp.asarray, variables_from_module(model))
    want = JaxPipeline(JaxFeat3DNet(JaxModelConfig(**PCFG)), v, JaxModelConfig(**PCFG),
                       JaxInferenceConfig(**icfg), mesh=jax_mesh(2)).extract(cloud)
    assert got.num_keypoints == want.num_keypoints
    np.testing.assert_allclose(got.keypoints, want.keypoints, atol=1e-5)
    np.testing.assert_allclose(got.features, want.features, rtol=1e-4, atol=1e-5)


def test_make_sharded_extract_is_the_mesh_extract():
    """make_sharded_extract's impl on a cloud padded to its bucket gives
    the mesh pipeline's extract (fused route, 2 CPU devices): the same
    count, and the same keypoints, attention and features in its first
    rows; a cloud of another bucket raises."""
    from feat3dnet_tpu_torch.config import bucket_for
    from feat3dnet_tpu_torch.parallel import make_sharded_extract

    cfg, model = _inference_model()
    icfg = InferenceConfig(use_hashed_grouping=True, use_fused_detector=True,
                           keypoint_chunk=1024, max_keypoints=32, nms_radius=1.0)
    cloud = (np.random.RandomState(4).rand(3000, 6).astype(np.float32) - 0.5) * 12.0
    pipe = InferencePipeline(model, None, cfg, icfg, mesh=make_mesh(2, "cpu"))
    want = pipe.extract(cloud)
    nb = bucket_for(cloud.shape[0])
    xyz = torch.zeros((1, nb, 3))
    xyz[0, :cloud.shape[0]] = torch.from_numpy(cloud[:, :3])
    valid = torch.arange(nb)[None] < cloud.shape[0]
    impl = make_sharded_extract(model, make_mesh(2, "cpu"), cfg, icfg, nb)
    with torch.no_grad():
        kp, feats, att, num = impl(xyz, valid, pipe._layout_for(cloud[:, :3]))
    k = int(num[0])
    assert k == want.num_keypoints > 4
    np.testing.assert_array_equal(kp[0, :k].numpy(), want.keypoints)
    np.testing.assert_array_equal(att[0, :k].numpy(), want.attention)
    np.testing.assert_array_equal(feats[0, :k].numpy(), want.features)
    with pytest.raises(ValueError, match="bucket"):
        impl(xyz[:, :nb // 2], valid[:, :nb // 2], (256, 512))


@pytest.mark.parametrize("case", ["fused_pipeline", "server", "fused_mesh"])
def test_weight_change_reaches_the_kernel_weights(case):
    """After `load_variables` of a second tree into the model, a fused-route
    pipeline (K6's and K3's plain versions), the server's `describe_packed`
    and a 2-device CPU mesh pipeline on the fused route (both devices the
    CPU: the one owner of kernel weights, through the mesh's stage
    sequence) give what a fresh one built on the second tree gives, bit
    for bit. With the weights unchanged, the next call gives the same
    results from the same kernel weights (the same weights_t list and, on
    CUDA, the same packed buffers)."""
    from feat3dnet_tpu_torch.utils import load_variables

    cfg = ModelConfig(**PCFG)
    trees = [_variables(cfg, seed) for seed in (3, 8)]
    rng = np.random.RandomState(4)
    if case == "server":
        packed = ClusterDescriptorServer.pack_clusters(
            ((rng.rand(24, 8, 3) - 0.5) * 2.0).astype(np.float32))

        def make(v):
            return ClusterDescriptorServer(load_variables(Feat3DNet(cfg), v), device="cpu")

        def run(obj):
            return [t.numpy() for t in obj.describe_packed(packed)]
    else:
        icfg = InferenceConfig(use_hashed_grouping=True, use_fused_detector=True,
                               keypoint_chunk=1024, max_keypoints=32, nms_radius=1.0)
        cloud = (rng.rand(3000, 6).astype(np.float32) - 0.5) * 12.0
        mesh = make_mesh(2, "cpu") if case == "fused_mesh" else None

        def make(v):
            return InferencePipeline(Feat3DNet(cfg), v, cfg, icfg,
                                     device=None if mesh else "cpu", mesh=mesh)

        def run(obj):
            res = obj.extract(cloud)
            assert res.num_keypoints > 4
            return [res.keypoints, res.attention, res.features]

    def made(obj):
        kw = obj.kernel_weights
        return [kw.describe()] if case == "server" else [kw.detect(), kw.describe()]

    obj = make(trees[0])
    first = run(obj)
    load_variables(obj.model, trees[1])
    got, want = run(obj), run(make(trees[1]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[-1], first[-1])
    before = made(obj)
    for g, w in zip(run(obj), got):
        np.testing.assert_array_equal(g, w)
    for (w1, p1), (w0, p0) in zip(made(obj), before):
        assert w1 is w0 and p1 is p0


@pytest.fixture(scope="module")
def cloud_stream():
    """Six clouds (five of bucket 4 096, one of 8 192) and each one's extract."""
    cfg, model = _inference_model()
    rng = np.random.RandomState(5)
    clouds = [(rng.rand(n, 3).astype(np.float32) - 0.5) * 15.0
              for n in (300, 250, 400, 350, 280, 5000)]
    icfg = InferenceConfig(use_hashed_grouping=True, keypoint_chunk=256, max_keypoints=32,
                           nms_radius=1.0)
    single = InferencePipeline(model, None, cfg, icfg, device="cpu")
    return cfg, model, icfg, clouds, [single.extract(c) for c in clouds]


@pytest.mark.parametrize("n_dev,pick,many", [(2, (0, 1, 2, 3, 4), False),
                                             (3, (0, 5, 1), True)])
def test_cloud_mesh_bit_equal(cloud_stream, n_dev, pick, many):
    """cloud_mesh= extract_batch (and extract_many) against extract, per
    cloud: 5 clouds on 2 shards (a padding replica dropped), and on 3 shards
    clouds of two buckets (4 096 and 8 192 points)."""
    cfg, model, icfg, clouds, want = cloud_stream
    meshed = InferencePipeline(model, None, cfg, icfg, cloud_mesh=make_mesh(n_dev, "cpu"))
    clouds, want = [clouds[i] for i in pick], [want[i] for i in pick]
    runs = [meshed.extract_batch(clouds)]
    if many:
        runs.append(meshed.extract_many(clouds, batch_size=2))
    for got in runs:
        assert len(got) == len(clouds)
        for g, w in zip(got, want):
            _same(g, w)


# ---- the CLI and the entry point ---------------------------------------------------


def test_cli_train_two_ranks(tmp_path):
    from feat3dnet_tpu_torch.cli import train

    root = tmp_path / "data"
    os.makedirs(root / "train")
    rs = np.random.RandomState(3)
    lines = []
    for i in range(4):
        (rs.randn(200, 6) * 3.0).astype(np.float32).tofile(str(root / "train" / f"c{i}.bin"))
        others = [j for j in range(4) if j != i]
        lines.append(f"c{i}.bin | {others[0]} | {others[1]}")
    (root / "train" / "train.txt").write_text("\n".join(lines) + "\n")
    args = ["--data_dir", str(root), "--log_dir", str(tmp_path / "log"), "--num_points", "64",
            "--num_clusters", "8", "--num_samples", "8", "--batch_size", "2", "--num_epochs",
            "1", "--summary_every_n_steps", "1", "--fused_towers", "--num_devices", "2"]
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match=f"{torch.cuda.device_count()} CUDA devices"):
            train.main(args)
    out = train.main(args + ["--device", "cpu"])
    assert [r["step"] for r in out] == [2, 2]
    assert out[0]["loss"] == out[1]["loss"]
    rows = [json.loads(x) for x in open(tmp_path / "log" / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2]
    assert rows[-1]["loss"] == pytest.approx(out[0]["loss"])
    assert rows[0]["hist_det_cnt"]["num"] == 3 * 2 * 8     # the combined batch's clusters
    assert sorted(os.listdir(tmp_path / "log" / "ckpt")) == ["ckpt_2.pt"]
    assert open(tmp_path / "log" / "log.txt").read().count("Step 2, Loss") == 1


def test_cli_train_joins_a_torchrun_group(tmp_path, monkeypatch):
    """Under torchrun's environment cli.train joins that group (here one
    gloo rank on a free localhost port) instead of spawning ranks."""
    import socket

    from feat3dnet_tpu_torch.cli import train

    root = tmp_path / "data"
    os.makedirs(root / "train")
    rs = np.random.RandomState(4)
    lines = []
    for i in range(3):
        (rs.randn(200, 6) * 3.0).astype(np.float32).tofile(str(root / "train" / f"c{i}.bin"))
        lines.append(f"c{i}.bin | {(i + 1) % 3} | {(i + 2) % 3}")
    (root / "train" / "train.txt").write_text("\n".join(lines) + "\n")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    state = train.main(["--data_dir", str(root), "--log_dir", str(tmp_path / "log"),
                        "--num_points", "64", "--num_clusters", "8", "--num_samples", "8",
                        "--batch_size", "1", "--num_epochs", "1", "--device", "cpu",
                        "--num_devices", "4"])
    assert state.step == 3
    assert state.model.bn_group is not None
    assert not dist.is_initialized()


def test_dryrun_multichip():
    from feat3dnet_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(2)
