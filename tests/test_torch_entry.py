"""The port's entry() (feat3dnet_tpu_torch/entry.py) against
__graft_entry__.entry() on the CPU: it runs, its outputs have JAX's
shapes, and with JAX's variables brought across the bridge it matches
JAX's forward (keypoints equal; features and attention within rtol 1e-4 /
atol 1e-5, tests/test_torch_model.py's tolerance). The zero cloud ties
every distance, so the FPS and ball-query tie orders are held as well.
"""
import numpy as np
import pytest
import torch

import jax

from feat3dnet_tpu_torch.entry import entry
from feat3dnet_tpu_torch.utils import load_variables

torch.set_num_threads(2)


def test_entry_matches_graft_entry():
    from __graft_entry__ import entry as jax_entry

    fn, (model, cloud) = entry(device="cpu")
    assert cloud.device.type == "cpu" and tuple(cloud.shape) == (2, 4096, 3)
    out = fn(model, cloud)
    jfn, (jvars, jcloud) = jax_entry()
    want = [np.asarray(x) for x in jfn(jvars, jcloud)]
    assert [tuple(o.shape) for o in out] == [w.shape for w in want] == \
        [(2, 512, 3), (2, 512, 32), (2, 512)]
    assert all(bool(torch.isfinite(o).all()) for o in out)
    load_variables(model, jax.tree.map(np.asarray, jvars))
    kp, feat, att = (o.numpy() for o in fn(model, cloud))
    np.testing.assert_array_equal(kp, want[0])
    np.testing.assert_allclose(feat, want[1], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(att, want[2], rtol=1e-4, atol=1e-5)


def test_entry_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
