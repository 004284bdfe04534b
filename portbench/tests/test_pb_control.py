"""Each cell's control comes out not correct: the reference computed one
precision below the configuration (TF32 products) put in the program's
place, or, for training, the program with its own TF32 switch on. TF32
exists only on the card: these tests skip elsewhere."""
from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.entries.common import Context
from portbench.tests.pb_small import SEED

ROOT = harness.ROOT


SIZES = {"extract-kitti-stream": {"traffic": {"pool": 2, "warm_frames": 1, "call_frames": 2},
                                  "check": {"sample": 2}},
         "serve-clusters-7680": {"traffic": {"requests": 1, "warm_requests": 1},
                                 "check": {"sample": 1}},
         "train-oxford-fused": {"traffic": {"pool": 4}}}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SIZES))
def test_control_fails(cell):
    """At the cell's widths on the card: the control fails one of its numbers."""
    if not torch.cuda.is_available():
        pytest.skip("the TF32 controls need a CUDA device")
    _, wl, cfg = harness.cell_spec(cell)
    control = wl["check"]["control"]
    over = {**SIZES[cell], **control.get("overrides", {})}
    run = harness.entry(wl["entry"]).Cell(Context(ROOT, cfg, wl, SEED, torch.device("cuda"),
                                                    over))
    run.setup()
    run.release()
    numbers = run.numbers(control=control["kind"] == "reference_tf32")
    limits = wl["check"]["limits"]
    assert any(v > limits[k] for k, v in numbers.items()), numbers
