"""Package-level rules of the PyTorch port.

* No file of feat3dnet_tpu_torch (nor chip_smoke.py, nor the card-side
  tests/test_torch_cuda.py) imports JAX or its libraries — checked on
  the source, since this test process itself has JAX loaded.
* Every kernel wrapper carries a launch counter and its plain twin, takes
  the twin only for CPU tensors, and refuses other devices; K2's wrapper
  counts its scalar and per-centre launches apart.
* `feat3dnet_tpu_torch.ops` exports what JAX's `ops` exports, but for the
  CSR entry points (TPU layouts of K4's and K5's computations).
* Every public function, class and method of the JAX package has a
  counterpart in the port module of the same path, or a reason in
  NOT_PORTED.
* The kernel sources exist, carry their note, and nothing builds at import.
"""
import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import feat3dnet_tpu_torch
from feat3dnet_tpu_torch import kernels
from feat3dnet_tpu_torch.config import ModelConfig
from feat3dnet_tpu_torch.ops import (batch_group, fps, fused_describe, fused_train, hash_grid,
                                     interpolate)

torch.set_num_threads(2)

PKG = os.path.dirname(os.path.abspath(feat3dnet_tpu_torch.__file__))
ROOT = os.path.dirname(PKG)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "feat3dnet_tpu"}
WRAPPERS = {
    "fps": (fps.farthest_point_sample, fps.farthest_point_sample_scan),
    "ball_query": (batch_group.ball_query_fused, batch_group.ball_query_plain),
    "fused_describe": (fused_describe.fused_describe_clusters_t,
                       fused_describe.fused_describe_clusters_t_plain),
    "sorted_ball_query": (hash_grid.sorted_ball_query, hash_grid.sorted_ball_query_plain),
    "ball_max": (hash_grid.ball_max_sorted, hash_grid.ball_max_plain),
    "fused_detect": (fused_describe.fused_detect_clusters,
                     fused_describe.fused_detect_clusters_plain),
    "train_stats": (fused_train.stats_pass, fused_train.stats_pass_plain),
    "train_final": (fused_train.final_pass, fused_train.final_pass_plain),
    "train_bwd_top": (fused_train.bwd_top_pass, fused_train.bwd_top_pass_plain),
    "train_bwd": (fused_train.bwd_pass, fused_train.bwd_pass_plain),
    "three_interp": (interpolate.three_interpolate, interpolate.three_interpolate_plain),
}


def _port_sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "tests", "test_torch_cuda.py")   # runs on the card


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_has_counter_and_plain_twin(name):
    wrapper, plain = WRAPPERS[name]
    assert isinstance(wrapper.launches, int)
    assert wrapper.plain is plain
    assert wrapper.__module__ == plain.__module__ or name == "ball_query"


def test_ball_query_counts_its_modes():
    w = batch_group.ball_query_fused
    assert set(w.mode_launches) == {"scalar", "radii"}
    assert all(isinstance(n, int) for n in w.mode_launches.values())
    with pytest.raises(ValueError, match="unsupported device"):
        meta = torch.device("meta")
        w(torch.empty(1, 8, 3, device=meta), torch.empty(1, 2, 3, device=meta),
          torch.ones(1, 2, device=meta), 4)


def test_ops_exports_jax_names():
    from feat3dnet_tpu import ops as jax_ops
    from feat3dnet_tpu_torch import ops

    csr = {"build_hit_csr_host", "ball_query_grouped_csr", "ball_max_csr"}
    assert set(jax_ops.__all__) - set(ops.__all__) == csr
    for name in ("knn_points", "prob_sample", "sample_points", "sample_and_group",
                 "sample_and_group_all"):
        assert getattr(ops, name).__module__.startswith("feat3dnet_tpu_torch.ops."), name
    for name in ops.__all__:
        assert callable(getattr(ops, name)), name


# Public names of feat3dnet_tpu/ with no counterpart in the port, on purpose:
# "<module path>:<name>" (or the module path alone) -> the reason. ROADMAP's
# "Not ported, on purpose" names the same entries.
NOT_PORTED = {
    "inference/pipeline.py:InferencePipeline.packed_offsets":
        "offsets of the TPU's packed upload buffer; the port uploads tensors",
    "models/feat3dnet.py:Feat3DNet.setup": "flax's constructor; the port's is __init__",
    "models/layers.py:ConvBNParams":
        "flax's parameter surface for the fused kernels; the port's ConvBN holds the tree",
    "models/layers.py:residual_save_policy":
        "a jax.checkpoint policy; the port's form is residual_saving",
    "ops/batch_group.py:use_fused_ball_query":
        "the TPU's opt-in switch; on the card K2 is always the ball query",
    "ops/fps.py:farthest_point_sample_pallas": "on the card farthest_point_sample is K1",
    "ops/fused_describe.py:fused_describe_clusters_2d": "a TPU layout of K3's computation",
    "ops/fused_describe.py:fused_detect_clusters_2d":
        "a TPU layout of K6's computation (fused_detect_clusters)",
    "ops/fused_describe.py:fused_detect_planes_t": "the TPU planes layout of K6's computation",
    "ops/fused_describe.py:pack_clusters_lanes_jnp":
        "the jnp packer; the port's is pack_clusters_lanes_torch",
    "ops/fused_describe.py:pack_planes_keypoints_t": "the TPU planes layout's packer",
    "ops/fused_describe.py:pack_weights_for_plan": "the TPU's MXU lane packing (lane_pack)",
    "ops/fused_train.py:pack_x_t8": "the fused towers' t8 layout: TPU lane padding",
    "ops/fused_train.py:unpack_dx_t8": "the fused towers' t8 layout: TPU lane padding",
    "ops/hash_grid.py:ball_max_csr": "a CSR layout of K5's computation (ball_max_sorted)",
    "ops/hash_grid.py:ball_query_grouped_csr":
        "a CSR layout of K4's computation (ball_query_grouped_sorted)",
    "ops/hash_grid.py:ball_query_planes_sorted": "a planes layout of K4's computation",
    "ops/hash_grid.py:build_hit_csr_host": "builds the CSR layout on the host",
    "ops/hash_grid.py:finish_planes": "a helper of the planes layout",
    "ops/hash_grid.py:planes_cnt_rows": "a helper of the planes layout",
    "ops/hash_grid.py:unplane": "a helper of the planes layout",
    "parallel/data_parallel.py:make_chained_shardmap_dp_train_step":
        "JAX's second sharding mechanism; torch.distributed has one",
    "parallel/data_parallel.py:make_shardmap_fused_dp_train_step":
        "JAX's second sharding mechanism; torch.distributed has one",
    "parallel/mesh.py:data_sharding": "a jax.sharding object",
    "parallel/mesh.py:replicated_sharding": "a jax.sharding object",
    "parallel/multihost.py:global_mesh": "a jax.sharding mesh",
    "utils/cache.py": "XLA's persistent compile cache: TPU-only",
    "utils/native.py:get_lib": "the port's loader is library()",
    "utils/native.py:morton_pack": "it went with the host Morton layout",
    "utils/profiling.py:time_function":
        "a logging decorator nothing called (the reference's was unused); the port's "
        "stages are profiler spans (span, spanned)",
    "utils/tf1_loader.py:jax_to_numpy": "the port's is to_numpy",
}


def _jax_public_names():
    """module path -> the public top-level functions and classes of each
    feat3dnet_tpu/**/*.py and the public methods of its public classes
    ("Class.method"), read with ast, nothing imported."""
    jax_pkg = os.path.join(ROOT, "feat3dnet_tpu")
    out = {}
    for d, _, files in os.walk(jax_pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            names = []
            for node in tree.body:
                if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
                        and not node.name.startswith("_")):
                    names.append(node.name)
                    if isinstance(node, ast.ClassDef):
                        names += [f"{node.name}.{m.name}" for m in node.body
                                  if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                                  and not m.name.startswith("_")]
            out[os.path.relpath(path, jax_pkg).replace(os.sep, "/")] = names
    return out


def test_every_jax_public_name_has_a_counterpart():
    """Each public name of the JAX package is defined or imported in the
    port module of the same path, or stands in NOT_PORTED; and no
    NOT_PORTED entry has gained a counterpart, so the list cannot go
    stale."""
    import importlib.util

    missing = set()
    for rel, names in sorted(_jax_public_names().items()):
        modname = "feat3dnet_tpu_torch." + rel[:-3].replace("/", ".")
        modname = modname[:-len(".__init__")] if modname.endswith(".__init__") else modname
        if importlib.util.find_spec(modname) is None:
            missing.add(rel)
            continue
        mod = importlib.import_module(modname)
        for name in names:
            obj = mod
            for part in name.split("."):
                obj = getattr(obj, part, None)
            if obj is None:
                missing.add(f"{rel}:{name}")
    assert not missing - set(NOT_PORTED), "no counterpart and not listed"
    assert not set(NOT_PORTED) - missing, "listed in NOT_PORTED but ported (or gone)"
    assert all(NOT_PORTED.values())


def test_wrappers_refuse_other_devices():
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fps.farthest_point_sample(torch.empty(1, 8, 3, device=meta), 2)
    with pytest.raises(ValueError, match="unsupported device"):
        batch_group.ball_query_fused(torch.empty(1, 8, 3, device=meta),
                                     torch.empty(1, 2, 3, device=meta), 1.0, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_describe.fused_describe_clusters_t(
            [], torch.empty(512, 4, device=meta), ModelConfig())
    with pytest.raises(ValueError, match="unsupported device"):
        fused_describe.fused_describe_clusters(
            [], torch.empty(4, ModelConfig().num_samples, 3, device=meta), ModelConfig())
    with pytest.raises(ValueError, match="unsupported device"):
        fused_describe.fused_detect_clusters([], torch.empty(4, 64, 3, device=meta),
                                             ModelConfig())
    x = torch.empty(8, 16, 3, device=meta)
    w, b = torch.empty(3, 8, device=meta), torch.empty(8, device=meta)
    plan = fused_train.detector_plan(1)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_train.stats_pass(x, plan, [], w, b, 16)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_train.final_pass(x, plan, [(w, b, b, b)])
    with pytest.raises(ValueError, match="unsupported device"):
        fused_train.convbn_maxpool_fused(x, [w, b, b, b], (8,), 8, 16)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_train.bwd_top_pass(x, plan, [(w, b, b, b)], b, b, torch.empty(16, 8, device=meta))
    with pytest.raises(ValueError, match="unsupported device"):
        fused_train.bwd_pass(x, plan, [(w, b, b, b)], b, b, torch.empty(16, 8, device=meta),
                             b, b, b, None, None, 16)


@pytest.mark.parametrize("source", kernels.SOURCES)
def test_kernel_sources_carry_their_note(source):
    with open(os.path.join(kernels.CSRC_DIR, source)) as f:
        head = f.read(4000)
    assert "Replaces: feat3dnet_tpu/ops/" in head
    assert "What bounds it on this card" in head
    assert "What the design does about it" in head


def test_nothing_builds_at_import():
    code = ("import sys\n"
            "import feat3dnet_tpu_torch.inference, feat3dnet_tpu_torch.models, "
            "feat3dnet_tpu_torch.utils, feat3dnet_tpu_torch.cli.infer, "
            "feat3dnet_tpu_torch.cli.train, feat3dnet_tpu_torch.train, "
            "feat3dnet_tpu_torch.data, feat3dnet_tpu_torch.utils.checkpoint, "
            "feat3dnet_tpu_torch.eval, feat3dnet_tpu_torch.eval.fig4, "
            "feat3dnet_tpu_torch.eval.heldout, feat3dnet_tpu_torch.eval.visualize, "
            "feat3dnet_tpu_torch.cli.match, feat3dnet_tpu_torch.cli.verify_parity, "
            "feat3dnet_tpu_torch.cli.prepare, feat3dnet_tpu_torch.dataprep, "
            "feat3dnet_tpu_torch.dataprep.kitti, feat3dnet_tpu_torch.dataprep.oxford, "
            "feat3dnet_tpu_torch.dataprep.submap, feat3dnet_tpu_torch.entry, "
            "feat3dnet_tpu_torch.utils.tf1_loader, feat3dnet_tpu_torch.utils.metrics_writer, "
            "feat3dnet_tpu_torch.utils.logging\n"
            "assert 'torch.utils.tensorboard' not in sys.modules\n"
            "assert 'matplotlib' not in sys.modules\n"
            "assert not {'jax', 'triton'} & set(sys.modules)\n"
            "from feat3dnet_tpu_torch import kernels\n"
            "assert kernels.build.cache_info().currsize == 0\n"
            "assert kernels.library.cache_info().currsize == 0\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
    assert kernels.build_dir() == os.path.join(ROOT, "build", "feat3dnet_tpu_torch")
    for name in kernels.SOURCES + kernels.HEADERS:
        assert os.path.isfile(os.path.join(kernels.CSRC_DIR, name))


def test_train_config_mirrors_jax():
    from feat3dnet_tpu.config import TrainConfig as JaxTrainConfig
    from feat3dnet_tpu_torch.config import TrainConfig

    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JaxTrainConfig())


def test_model_config_mirrors_jax():
    from feat3dnet_tpu.config import ModelConfig as JaxModelConfig

    ours = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxModelConfig)}
    assert ours.keys() == theirs.keys()
    for k in ours:
        if "dtype" not in k:
            assert ours[k] == theirs[k], k
    assert ModelConfig().compute_dtype is torch.float32
    for fd in (32, 128):
        assert ModelConfig(feature_dim=fd).descriptor_mlp2 == \
            JaxModelConfig(feature_dim=fd).descriptor_mlp2
        assert ModelConfig(feature_dim=fd).descriptor_mlp3 == (fd,)


def test_io_reads_the_vendored_clouds(tmp_path):
    from feat3dnet_tpu.data import io as jio
    from feat3dnet_tpu_torch.data import io

    assert io.example_data_dir() == jio.example_data_dir()
    cloud = io.load_point_cloud(io.example_cloud_path("oxford_456.bin"))
    np.testing.assert_array_equal(
        cloud, jio.load_point_cloud(jio.example_cloud_path("oxford_456.bin")))
    path = str(tmp_path / "d.bin")
    io.save_descriptors(path, cloud[:5, :3], cloud[:5, 3:])
    xyz, feat = jio.load_descriptors(path, feature_dim=3)
    np.testing.assert_array_equal(np.concatenate([xyz, feat], 1), cloud[:5])
