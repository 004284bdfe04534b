"""The port's verify_parity CLI against the JAX gate (tests/test_verify_parity.py's
cases) on the CPU.

A random paper-config model is exported under the TF1 names, JAX's
pipeline writes a self-produced 'reference output' from it, and both
gates run on the same npz, cloud and output: both must pass (exit 0), and
the port's cosine summary (n, min, p5, median, mean) must be within 1e-5
of JAX's. With one descriptor kernel corrupted both must fail (exit 1),
again with summaries within 1e-5. Cases: the paper config, feature_dim
128 (mlp2 widened to 256), and a no-BN checkpoint (--no_bn; the internal
K3 gate is skipped there, as in JAX).
"""
import ast

import numpy as np
import pytest
import torch

from tests.test_verify_parity import _write_tf1_npz

torch.set_num_threads(2)

CASES = {"paper": ({}, []),
         "fd128": ({"feature_dim": 128}, ["--feature_dim", "128"]),
         "nobn": ({"use_bn": False}, ["--no_bn"])}


def _summary(out):
    line = next(x for x in out.splitlines() if x.startswith("descriptor cosine vs reference:"))
    return ast.literal_eval(line.split(":", 1)[1].strip())


def _gates(capsys, args):
    """(rc, summary, stdout) of the JAX gate and of the port's (device cpu)."""
    from feat3dnet_tpu.cli.verify_parity import main as jax_gate
    from feat3dnet_tpu_torch.cli.verify_parity import main as gate

    capsys.readouterr()
    rc_j = jax_gate(args)
    out_j = capsys.readouterr().out
    rc_p = gate(args + ["--device", "cpu"])
    out_p = capsys.readouterr().out
    return (rc_j, _summary(out_j), out_j), (rc_p, _summary(out_p), out_p)


def _assert_close(got, want):
    assert got["n"] == want["n"]
    for k in ("min", "p5", "median", "mean"):
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])


@pytest.mark.parametrize("case", sorted(CASES))
def test_verify_parity_matches_jax_gate(tmp_path, capsys, case):
    from feat3dnet_tpu.config import InferenceConfig
    from feat3dnet_tpu.data.io import save_descriptors
    from feat3dnet_tpu.inference import InferencePipeline

    cfg_kwargs, flags = CASES[case]
    npz = str(tmp_path / "ckpt.npz")
    cfg, model, variables = _write_tf1_npz(npz, **cfg_kwargs)
    rng = np.random.RandomState(0)
    cloud = np.concatenate([(rng.rand(600, 3).astype(np.float32) - 0.5) * 30.0,
                            np.zeros((600, 3), np.float32)], axis=1)
    cloud_path = str(tmp_path / "cloud.bin")
    cloud.tofile(cloud_path)
    res = InferencePipeline(model, variables, cfg, InferenceConfig(max_keypoints=32)).extract(
        cloud)
    ref_path = str(tmp_path / "ref_out.bin")
    save_descriptors(ref_path, res.keypoints, res.features)

    args = ["--npz", npz, "--cloud", cloud_path, "--reference_output", ref_path] + flags
    (rc_j, want, _), (rc_p, got, out) = _gates(capsys, args)
    assert rc_j == rc_p == 0
    _assert_close(got, want)
    assert ("fused-vs-model cosine" in out) == (case != "nobn")
    if case != "paper":
        return
    internal = next(x for x in out.splitlines() if x.startswith("fused-vs-model cosine"))
    assert float(internal.split()[3]) >= 0.9999                   # min over the keypoints

    arrays = dict(np.load(npz))
    key = "description/layer1/conv0/conv2d/weights"
    arrays[key] = arrays[key] + 3.0
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **arrays)
    (rc_j, want, _), (rc_p, got, _) = _gates(
        capsys, ["--npz", bad, "--cloud", cloud_path, "--reference_output", ref_path])
    assert rc_j == rc_p == 1
    _assert_close(got, want)
