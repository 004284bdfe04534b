"""Package-level rules of the PyTorch port.

* No file of feat3dnet_tpu_torch (nor chip_smoke.py, nor the card-side
  tests/test_torch_cuda.py) imports JAX or its libraries — checked on
  the source, since this test process itself has JAX loaded.
* Every kernel wrapper carries a launch counter and its plain twin, takes
  the twin only for CPU tensors, and refuses other devices.
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
from feat3dnet_tpu_torch.ops import batch_group, fps, fused_describe

torch.set_num_threads(2)

PKG = os.path.dirname(os.path.abspath(feat3dnet_tpu_torch.__file__))
ROOT = os.path.dirname(PKG)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "feat3dnet_tpu"}
WRAPPERS = {
    "fps": (fps.farthest_point_sample, fps.farthest_point_sample_scan),
    "ball_query": (batch_group.ball_query_fused, batch_group.ball_query_plain),
    "fused_describe": (fused_describe.fused_describe_clusters_t,
                       fused_describe.fused_describe_clusters_t_plain),
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


@pytest.mark.parametrize("source", kernels.SOURCES)
def test_kernel_sources_carry_their_note(source):
    with open(os.path.join(kernels.CSRC_DIR, source)) as f:
        head = f.read(4000)
    assert "Replaces: feat3dnet_tpu/ops/" in head
    assert "What bounds it on this card" in head
    assert "What the design does about it" in head


def test_nothing_builds_at_import():
    code = ("import feat3dnet_tpu_torch.inference, feat3dnet_tpu_torch.models, "
            "feat3dnet_tpu_torch.utils\n"
            "from feat3dnet_tpu_torch import kernels\n"
            "assert kernels.build.cache_info().currsize == 0\n"
            "assert kernels.library.cache_info().currsize == 0\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
    assert kernels.build_dir() == os.path.join(ROOT, "build", "feat3dnet_tpu_torch")
    for name in kernels.SOURCES + kernels.HEADERS:
        assert os.path.isfile(os.path.join(kernels.CSRC_DIR, name))


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
