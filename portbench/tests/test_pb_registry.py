"""Every configuration, cell and per-layer metric of BENCHMARK.json is found by
name, and a cell or metric added as new files runs with no code edit."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ROOT = harness.ROOT
CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def test_benchmark_names_resolve_to_files():
    bench = harness.benchmark()
    for c in bench["configs"]:
        cfg = harness.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"] and c["file"].startswith("portbench/")
    for w in bench["workloads"]:
        _, wl, _ = harness.cell_spec(w["name"], bench)
        assert os.path.isfile(os.path.join(harness.HERE, "entries", f"{wl['entry']}.py"))
        assert set(wl["check"]["limits"]) and wl["check"]["control"]["kind"]
    for m in bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]).read)
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_benchmark_json_shape():
    """The keys, names and bounds BENCHMARK.json may hold."""
    import re

    bench = harness.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and name.match(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert name.match(w["name"]) and name.match(w["traffic"]) and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert 1 <= bench["run_seconds"] <= 51
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e


def _copy_checkout(tmp_path):
    """BENCHMARK.json and portbench/ copied; the program and the data linked."""
    dst = tmp_path / "checkout"
    dst.mkdir()
    shutil.copytree(harness.HERE, dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst / "BENCHMARK.json")
    return dst


def _run_in(dst, workload, overrides, trace=0):
    """run.main in a fresh interpreter that imports portbench from `dst`."""
    code = ("import io, json, sys; sys.path.insert(0, sys.argv[1]);"
            "from portbench import run;"
            "out = run.main(['--workload', sys.argv[2], '--seed', '7', '--seconds', '0.05',"
            " '--trace', sys.argv[4]], device='cpu', overrides=json.loads(sys.argv[3]),"
            " stream=io.StringIO());"
            "print(json.dumps(out))")
    r = subprocess.run([sys.executable, "-c", code, str(dst), workload, json.dumps(overrides),
                        str(trace)], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_new_cell_and_metric_are_files_only(tmp_path):
    from portbench.tests.pb_small import SMALL

    dst = _copy_checkout(tmp_path)
    for name in ("feat3dnet_tpu_torch", "examples"):
        os.symlink(os.path.join(ROOT, name), dst / name)
    wl = json.loads((dst / "portbench/workloads/serve-clusters-7680.json").read_text())
    wl["traffic"]["batch"] = 1024
    (dst / "portbench/workloads/serve-clusters-1024.json").write_text(json.dumps(wl))
    (dst / "portbench/metrics/requests.serve1024.py").write_text(
        "def read(r):\n    return float(r.result['work']['requests'])\n")
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "serve-clusters-1024", "config": "feat3dnet-paper-eval",
                               "traffic": "clusters-1024", "chips": 1, "why": "a test cell"})
    next(m for m in bench["end_to_end"]
         if m["name"] == "descriptors_per_s")["workloads"].append("serve-clusters-1024")
    bench["per_layer"].append({"name": "requests.serve1024", "unit": "requests",
                               "better": "higher", "source": "host_clock", "layer": "entry",
                               "moves": "descriptors_per_s",
                               "workloads": ["serve-clusters-1024"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    small = dict(SMALL["serve-clusters-7680"])
    small["traffic"] = {**small["traffic"], "batch": 128}
    out = _run_in(dst, "serve-clusters-1024", small)
    assert out["correct"] and out["metrics"]["descriptors_per_s"]["value"] > 0
    traced = _run_in(dst, "serve-clusters-1024", small, trace=1)
    assert traced["metrics"]["requests.serve1024"]["value"] >= 1


def test_run_refuses_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and portbench/: no result."""
    dst = _copy_checkout(tmp_path)
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed",
                        "1", "--seconds", "1", "--trace", "0"], cwd=dst, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_run_refuses_without_a_card():
    """No CUDA device: a non-zero exit and no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed",
                        "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 3 and r.stdout.strip() == ""
