"""The port's accuracy programs (feat3dnet_tpu_torch/examples/) against the
JAX examples/ modules, on the CPU at small sizes.

* The dataset builders (scaled_accuracy_run, synthetic_training_demo,
  degraded_eval at every level) write the JAX files byte for byte.
* HandcraftedExtractor gives the JAX keypoints and features bit for bit on
  held-out clouds, and the port's fig4 on them equals JAX's aggregate.
* scaled_accuracy_run.main runs the recipe and the evaluation end to end
  with --device cpu at a tiny size; its summary has every key of the JAX
  summary.json.
* The other mains run at small sizes; every module runs on cuda unless
  told otherwise (and raises without a card), and writes by default only
  under feat3dnet_tpu_torch/examples/results/.
"""
import importlib
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from feat3dnet_tpu_torch.examples import RESULTS_DIR
from feat3dnet_tpu_torch.examples import degraded_eval as port_degraded
from feat3dnet_tpu_torch.examples import eval_inference_sweep as port_sweep
from feat3dnet_tpu_torch.examples import handcrafted_baseline as port_baseline
from feat3dnet_tpu_torch.examples import scaled_accuracy_run as port_scaled
from feat3dnet_tpu_torch.examples import synthetic_training_demo as port_demo

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
JAX_SUMMARY = os.path.join(EXAMPLES, "results", "scaled_accuracy", "summary.json")
# each module's output flag
OUT_FLAG = {"scaled_accuracy_run": "--results_dir", "handcrafted_baseline": "--results_dir",
            "eval_inference_sweep": "--out", "degraded_eval": "--results_dir",
            "synthetic_training_demo": "--out", "register_examples": "--out_dir"}


def jax_example(name):
    """examples/<name>.py, the oracle (numpy at import; JAX inside its
    functions)."""
    sys.path.insert(0, EXAMPLES)
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(EXAMPLES)


def assert_same_tree(got, want):
    """Both directories hold the same file names, each byte-equal."""
    names = sorted(os.path.relpath(os.path.join(d, f), want)
                   for d, _, fs in os.walk(want) for f in fs)
    assert sorted(os.path.relpath(os.path.join(d, f), got)
                  for d, _, fs in os.walk(got) for f in fs) == names
    assert names
    for name in names:
        with open(os.path.join(got, name), "rb") as f, \
                open(os.path.join(want, name), "rb") as g:
            assert f.read() == g.read(), name


def keys_of(tree, prefix=()):
    """Every key path of a nested dict."""
    out = set()
    for k, v in tree.items():
        out.add(prefix + (k,))
        if isinstance(v, dict):
            out |= keys_of(v, prefix + (k,))
    return out


def test_scaled_accuracy_dataset_is_byte_equal(tmp_path):
    jax_mod = jax_example("scaled_accuracy_run")
    port_scaled.build_dataset(str(tmp_path / "port"), np.random.RandomState(0), 3, 2, 4, 2)
    jax_mod.build_dataset(str(tmp_path / "jax"), np.random.RandomState(0), 3, 2, 4, 2)
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert len(os.listdir(tmp_path / "port" / "train")) == 3 * 2 + 1


def test_synthetic_demo_dataset_is_byte_equal(tmp_path):
    jax_mod = jax_example("synthetic_training_demo")
    port_demo.build_dataset(str(tmp_path / "port"), np.random.RandomState(0), 3, 2, 4)
    jax_mod.build_dataset(str(tmp_path / "jax"), np.random.RandomState(0), 3, 2, 4)
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


@pytest.mark.parametrize("level", sorted(port_degraded.LEVELS))
def test_degraded_test_is_byte_equal(tmp_path, level):
    jax_mod = jax_example("degraded_eval")
    assert jax_mod.LEVELS == port_degraded.LEVELS
    keep, sector, noise = port_degraded.LEVELS[level]
    port_degraded.build_degraded_test(str(tmp_path / "port"), np.random.RandomState(7), 2,
                                      keep, sector, noise)
    jax_mod.build_degraded_test(str(tmp_path / "jax"), np.random.RandomState(7), 2,
                                keep, sector, noise)
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


@pytest.fixture(scope="module")
def baseline_pairs(tmp_path_factory):
    """2 held-out pairs (4 clouds) through both extractors; the port's and
    JAX's descriptor files side by side."""
    from feat3dnet_tpu_torch.data.io import load_point_cloud, save_descriptors
    from feat3dnet_tpu_torch.eval.heldout import build_test_set

    jax_mod = jax_example("handcrafted_baseline")
    root = tmp_path_factory.mktemp("baseline")
    test_dir = build_test_set(str(root), 2)
    port_ext = port_baseline.HandcraftedExtractor(device="cpu")
    jax_ext = jax_mod.HandcraftedExtractor()
    out = {"test_dir": test_dir, "port": {}, "jax": {}}
    for tag in ("port", "jax"):
        os.makedirs(root / tag)
    for f in sorted(x for x in os.listdir(test_dir) if x.endswith(".bin")):
        cloud = load_point_cloud(os.path.join(test_dir, f), 6)
        for tag, ext in (("port", port_ext), ("jax", jax_ext)):
            res = ext.extract(cloud)
            out[tag][f] = res
            save_descriptors(str(root / tag / f), res.keypoints, res.features)
    out["dirs"] = {tag: str(root / tag) for tag in ("port", "jax")}
    return out


def test_handcrafted_extractor_is_bit_equal(baseline_pairs):
    assert len(baseline_pairs["port"]) == 4
    for f, got in baseline_pairs["port"].items():
        want = baseline_pairs["jax"][f]
        assert got.num_keypoints == want.num_keypoints == 1024
        np.testing.assert_array_equal(got.keypoints, want.keypoints)
        np.testing.assert_array_equal(got.features, want.features)
        np.testing.assert_array_equal(got.attention, want.attention)


def test_handcrafted_fig4_equals_jax(baseline_pairs):
    from feat3dnet_tpu.eval import fig4 as jfig4
    from feat3dnet_tpu_torch.eval import fig4

    test_dir = baseline_pairs["test_dir"]
    _, got = fig4.evaluate_dataset(test_dir, baseline_pairs["dirs"]["port"], feature_dim=24,
                                   log=lambda *_: None, device="cpu")
    _, want = jfig4.evaluate_dataset(test_dir, baseline_pairs["dirs"]["jax"], feature_dim=24,
                                     log=lambda *_: None)
    assert got == want
    assert 0 < got["total_correct"] < got["total_putative"] == 2 * 1024


def test_evaluate_baseline_registers_on_cpu(baseline_pairs, tmp_path):
    ext = port_baseline.HandcraftedExtractor(device="cpu")
    out = port_baseline.evaluate_baseline(ext, baseline_pairs["test_dir"], str(tmp_path))
    assert out["fig4"]["pairs"] == 2 and out["keypoints"] == "FPS 1024"
    assert out["registration"]["n_pairs"] == 2
    assert out["registration"]["success_rate"] == 1.0
    path = port_baseline.merge_section(str(tmp_path / "res"), "handcrafted_baseline", out)
    port_baseline.merge_section(str(tmp_path / "res"), "other", {"x": 1})
    with open(path) as f:
        assert json.load(f) == {"handcrafted_baseline": out, "other": {"x": 1}}


def test_registration_from_the_result_files_equals_extracting_again(baseline_pairs):
    """eval/heldout.evaluate_registration on process_directory's files (what
    evaluate_setting passes) gives what extracting every cloud again does."""
    from feat3dnet_tpu_torch.eval.heldout import evaluate_registration

    ext = port_baseline.HandcraftedExtractor(device="cpu")
    again, files = {}, {}
    evaluate_registration(ext, baseline_pairs["test_dir"], again)
    evaluate_registration(ext, baseline_pairs["test_dir"], files,
                          result_dir=baseline_pairs["dirs"]["port"], feature_dim=24)
    assert files == again and again["registration"]["n_pairs"] == 2


def test_scaled_accuracy_run_end_to_end_on_cpu(tmp_path):
    args = ["--device", "cpu", "--places", "4", "--views", "3", "--stage1_epochs", "1",
            "--stage2_epochs", "1", "--num_points", "256", "--num_clusters", "16",
            "--test_pairs", "2", "--val_pairs", "4", "--keep_dir", str(tmp_path / "data"),
            "--results_dir", str(tmp_path / "res")]
    t0 = time.perf_counter()
    summary = port_scaled.main(args)
    seconds = time.perf_counter() - t0
    with open(JAX_SUMMARY) as f:
        jax_summary = json.load(f)
    assert keys_of(jax_summary) <= keys_of(summary), keys_of(jax_summary) - keys_of(summary)
    with open(tmp_path / "res" / "summary.json") as f:
        assert json.load(f) == json.loads(json.dumps(summary))
    sections = {k: summary[k] for k in jax_summary}
    assert port_scaled.finite(sections), sections
    # 4 x 3 views in batches of 6: 2 steps a stage; stage 2 continues the count
    assert summary["final_step"] == summary["final_count"] == 4
    assert (summary["route"], summary["seed"], summary["device"]) == ("autograd", 0, "cpu")
    assert summary["fig4"]["pairs"] == 2 and summary["registration"]["n_pairs"] == 2
    assert summary["matched_budget"]["kp1024_ratio0_nms02"]["keypoints_per_cloud"] == 1024
    assert set(summary["launches"]) == {"train", "eval"}   # CPU tensors launch nothing
    assert not any(n for ph in summary["launches"].values() for n in ph.values())
    assert os.path.exists(tmp_path / "res" / "metrics_stage1.jsonl")
    from feat3dnet_tpu_torch.utils import load_variables_npz
    variables = load_variables_npz(str(tmp_path / "res" / "variables.npz"))
    assert {"params", "batch_stats"} <= set(variables) and "detection" in variables["params"]
    # the log of stage 2 names the restore of stage 1 at its step
    with open(tmp_path / "data" / "run_stage2" / "log.txt") as f:
        assert "Restored checkpoint at step 2" in f.read()
    print(f"scaled_accuracy_run at the tiny size: {seconds:.1f} s")


def test_scaled_accuracy_eval_only_loads_the_weights(tmp_path, monkeypatch):
    """--eval_only evaluates --variables, or else --keep_dir's last stage-2
    checkpoint, with no training (the evaluation itself stubbed)."""
    from feat3dnet_tpu_torch.config import ModelConfig
    from feat3dnet_tpu_torch.utils import init_variables, save_variables_npz

    seen = []

    def fake_evaluate(variables, cfg, root, device, log=None):
        seen.append(variables)
        return {"heldout_fpr95": 0.0, "matched_budget": {"kp1024_ratio0_nms02": {
            "fig4": {"precision_at_1m": 90.0}, "keypoints_per_cloud": 1024.0,
            "registration": {"success_rate": 1.0, "n_pairs": 2}}}}

    monkeypatch.setattr(port_scaled, "evaluate", fake_evaluate)
    monkeypatch.setattr(port_scaled, "train_recipe", None)   # must not be reached
    want = init_variables(ModelConfig(num_clusters=16), seed=3)
    save_variables_npz(str(tmp_path / "v.npz"), want)
    base = ["--device", "cpu", "--places", "3", "--views", "2", "--val_pairs", "4",
            "--test_pairs", "2", "--eval_only"]
    out = port_scaled.main(base + ["--variables", str(tmp_path / "v.npz"),
                                   "--results_dir", str(tmp_path / "r1")])
    assert out["variables"] == "v.npz" and not out["limits"]["stage2_min_fpr95_by_3000"]["ok"]
    np.testing.assert_array_equal(seen[-1]["params"]["detection"]["conv0"]["conv2d"]["kernel"],
                                  want["params"]["detection"]["conv0"]["conv2d"]["kernel"])
    assert not os.path.exists(tmp_path / "r1" / "variables.npz")
    # a stage-2 checkpoint of cli.train's layout under --keep_dir
    ckpt = tmp_path / "keep" / "run_stage2" / "ckpt"
    os.makedirs(ckpt)
    torch.save({"step": 7, "variables": _tensors(want)}, str(ckpt / "ckpt_7.pt"))
    out = port_scaled.main(base + ["--keep_dir", str(tmp_path / "keep"),
                                   "--results_dir", str(tmp_path / "r2")])
    assert out["final_step"] == 7
    np.testing.assert_array_equal(seen[-1]["batch_stats"]["detection"]["conv0"]["bn"]["mean"],
                                  want["batch_stats"]["detection"]["conv0"]["bn"]["mean"])


@pytest.mark.parametrize("route", ["autograd", "fused"])
def test_init_variables_starts_stage_1_and_keeps_the_detector(tmp_path, monkeypatch, route):
    """--init_variables: stage 1 starts from the npz and trains no `detection`
    parameter, so stage 2, restoring all of stage 1, starts the detector
    from the npz's weights (the evaluation stubbed)."""
    from feat3dnet_tpu_torch.config import ModelConfig
    from feat3dnet_tpu_torch.utils import init_variables, save_variables_npz

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                       else {prefix + k: np.asarray(v)})
        return out

    monkeypatch.setattr(port_scaled, "evaluate", lambda *a, **k: {
        "heldout_fpr95": 0.0, "matched_budget": {"kp1024_ratio0_nms02": {
            "fig4": {"precision_at_1m": 90.0}, "keypoints_per_cloud": 1024.0,
            "registration": {"success_rate": 1.0, "n_pairs": 2}}}})
    init = init_variables(ModelConfig(num_clusters=16), seed=11)
    save_variables_npz(str(tmp_path / "init.npz"), init)
    data = tmp_path / "data"
    out = port_scaled.main(
        ["--device", "cpu", "--places", "4", "--views", "3", "--stage1_epochs", "1",
         "--stage2_epochs", "1", "--num_points", "256", "--num_clusters", "16",
         "--test_pairs", "2", "--val_pairs", "4", "--keep_dir", str(data),
         "--results_dir", str(tmp_path / "res"), "--init_variables", str(tmp_path / "init.npz")]
        + (["--fused_towers"] if route == "fused" else []))
    assert out["init_variables"] == "init.npz" and out["final_step"] == 4
    stage1 = torch.load(str(data / "run_stage1" / "ckpt" / "ckpt_2.pt"), weights_only=True)
    got, want = flat(port_scaled.host_variables(stage1["variables"])), flat(init)
    for k in want:
        if k.startswith("params/detection/"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not np.array_equal(got["params/description/conv0/conv2d/kernel"],
                              want["params/description/conv0/conv2d/kernel"])
    with open(data / "run_stage2" / "log.txt") as f:
        log = f.read()
    assert "Restored checkpoint at step 2" in log and "'restore_exclude': None" in log


def _tensors(tree):
    return {k: _tensors(v) if isinstance(v, dict) else torch.from_numpy(np.asarray(v))
            for k, v in tree.items()}


def test_limit_report():
    entry = {"fig4": {"precision_at_1m": 86.0}, "keypoints_per_cloud": 1020.0,
             "registration": {"success_rate": 21 / 24, "n_pairs": 24}}
    summary = {"heldout_fpr95": 0.05, "matched_budget": {"kp1024_ratio0_nms02": entry}}
    rows = [{"step": 700, "fp_rate": 0.3}, {"step": 2900, "fp_rate": 0.08},
            {"step": 3100, "fp_rate": 0.01}, {"step": 800, "loss": 0.1}]
    rep = port_scaled.limit_report(summary, rows)
    assert all(v["ok"] for v in rep.values()), rep
    assert rep["stage2_min_fpr95_by_3000"]["value"] == 0.08
    entry["fig4"]["precision_at_1m"] = 85.0
    rep = port_scaled.limit_report(summary, rows[:1] + rows[2:])
    assert not rep["precision_at_1m"]["ok"] and not rep["stage2_min_fpr95_by_3000"]["ok"]


def test_sweep_settings_and_record_limits():
    with open(os.path.join(EXAMPLES, "results", "scaled_accuracy",
                           "inference_sweep.json")) as f:
        record = json.load(f)
    assert set(port_sweep.SETTINGS) == set(record) - {"final_step"}
    for name, entry in record.items():
        if name == "final_step":
            continue
        assert port_sweep.misses(entry, entry) == []
        off = json.loads(json.dumps(entry))
        off["fig4"]["precision_at_1m"] += 1.01
        off["keypoints_per_cloud"] *= 1.011
        reg = off["registration"]
        reg["success_rate"] = (port_sweep.registrations(entry) - 3) / reg["n_pairs"]
        assert len(port_sweep.misses(off, entry)) == 3, name


def test_eval_inference_sweep_main(tmp_path, monkeypatch):
    """main's settings, output and --record rule, with the held-out protocol
    stubbed (eval/heldout.evaluate_setting, the path
    test_scaled_accuracy_run_end_to_end_on_cpu runs for real)."""
    from feat3dnet_tpu_torch.eval import heldout

    made = []

    def fake_setting(pipe, test_dir, result_dir, log=None):
        made.append(pipe.icfg)
        assert len(os.listdir(test_dir)) == 2 * 2 + 1
        return {"fig4": {"pairs": 2.0, "precision_at_1m": 80.0 + len(made),
                         "total_putative": 2000.0, "total_correct": 1600.0},
                "keypoints_per_cloud": 1000.0,
                "registration": {"n_pairs": 2, "success_rate": 1.0}}

    monkeypatch.setattr(heldout, "evaluate_setting", fake_setting)
    out = tmp_path / "sweep.json"
    args = ["--device", "cpu", "--test_pairs", "2", "--out", str(out)]
    got = port_sweep.main(args)
    assert [(c.min_response_ratio, c.nms_radius) for c in made] == [
        (0.01, 0.5), (0.0, 0.5), (0.0, 0.25), (0.0, 0.2), (0.0, 0.15), (0.01, 0.25)]
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(got))
    assert got["variables"] == "ckpt4480_variables.npz" and got["device"] == "cpu"
    assert got["kp1024_ratio0_nms02"]["fig4"]["precision_at_1m"] == 84.0
    # each setting is held to its own record entry: one 1.5 points off fails
    made.clear()
    rec = json.loads(json.dumps(got))
    for i, name in enumerate(port_sweep.SETTINGS):
        rec[name]["fig4"]["precision_at_1m"] = 81.0 + i
    rec["kp1024_ratio0"]["fig4"]["precision_at_1m"] += 1.5
    with open(tmp_path / "rec.json", "w") as f:
        json.dump(rec, f)
    with pytest.raises(SystemExit, match="kp1024_ratio0'"):
        port_sweep.main(args + ["--record", str(tmp_path / "rec.json"),
                                "--use_fused_detector"])
    assert all(c.use_fused_detector for c in made)


def test_synthetic_training_demo_on_cpu(tmp_path):
    out = port_demo.main(["--device", "cpu", "--epochs", "1", "--num_points", "256",
                          "--out", str(tmp_path / "demo.json")])
    # 12 places x 3 views in batches of 4: 9 steps, rows every 3, validation at 1 and 9
    assert [s for s, _ in out["losses"]] == [3, 6, 9]
    assert [s for s, _ in out["fp_rates"]] == [1, 9]
    assert all(np.isfinite(v) for _, v in out["losses"] + out["fp_rates"])
    with open(tmp_path / "demo.json") as f:
        assert json.load(f)["device"] == "cpu"


def test_register_examples_on_cpu(tmp_path):
    from feat3dnet_tpu_torch.examples import register_examples

    rs = np.random.RandomState(3)
    os.makedirs(tmp_path / "data")
    for a, b in register_examples.PAIRS:
        base = (rs.rand(1500, 3) * np.array([30.0, 30.0, 4.0])).astype(np.float32)
        for name, shift in ((a, 0.0), (b, 0.3)):
            np.concatenate([base + shift, np.zeros_like(base)], 1).astype(
                np.float32).tofile(str(tmp_path / "data" / f"{name}.bin"))
    results = register_examples.main(["--data_dir", str(tmp_path / "data"), "--out_dir",
                                      str(tmp_path / "out"), "--device", "cpu"])
    assert set(results) == set(register_examples.PAIRS)
    for r in results.values():
        assert r["num_matches"] > 0 and np.isfinite(np.asarray(r["rotation"])).all()


@pytest.mark.parametrize("name", sorted(OUT_FLAG))
def test_modules_default_to_cuda_and_the_port_results(name, tmp_path):
    mod = importlib.import_module(f"feat3dnet_tpu_torch.examples.{name}")
    args = mod.build_parser().parse_args([])
    assert args.device == "cuda"
    default = vars(args)[OUT_FLAG[name].lstrip("-")]
    assert os.path.abspath(default).startswith(RESULTS_DIR + os.sep), default
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([OUT_FLAG[name], str(tmp_path / "never")])
        assert not os.path.exists(tmp_path / "never")
