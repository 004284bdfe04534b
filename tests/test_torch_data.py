"""Port of data/augment and data/datagenerator against the JAX package.

Augmentations: a torch.Generator and jax.random draw different numbers
from one seed, so both frameworks get the same numpy draws injected (the
JAX module's jax.random calls and the port's draw helpers are patched) and
must agree to rtol 1e-5 / atol 1e-6, the chain and the one-step functions
(`jitter`, ..., `scale`) alike; the port's own draws are held to the
distributions' bounds and moments. The triplet loader's batches must be
bit-equal to the JAX numpy branch.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from feat3dnet_tpu.data import augment as jaug
from feat3dnet_tpu.data import datagenerator as jdg
from feat3dnet_tpu_torch.data import augment as taug
from feat3dnet_tpu_torch.data import datagenerator as tdg

torch.set_num_threads(2)


def _inject_draws(rng, monkeypatch):
    """A (3, 50, 3) cloud batch; jax.random and the port's draw helpers
    patched to hand out the same numpy draws, picked by shape."""
    xyz = rng.randn(3, 50, 3).astype(np.float32) * 5.0
    normals = [rng.randn(*s).astype(np.float32) for s in ((3, 50, 3), (3, 3))]
    uniforms = [rng.rand(*s).astype(np.float32) for s in ((3, 1, 3), (3,), (3, 1, 1))]

    def pick(pool, shape):
        return next(u for u in pool if u.shape == tuple(shape))

    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, *a, **k: jnp.asarray(pick(normals, shape)))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, *a, minval=0.0, maxval=1.0, **k:
                        minval + (maxval - minval) * jnp.asarray(pick(uniforms, shape)))
    monkeypatch.setattr(taug, "_randn",
                        lambda gen, shape, device: torch.from_numpy(pick(normals, shape)))
    monkeypatch.setattr(taug, "_rand",
                        lambda gen, shape, device: torch.from_numpy(pick(uniforms, shape)))
    return xyz


@pytest.mark.parametrize("name", sorted(taug.AUGMENTATIONS))
def test_augmentation_matches_jax_on_injected_draws(rng, monkeypatch, name):
    xyz = _inject_draws(rng, monkeypatch)
    want = jaug.AUGMENTATIONS[name](jax.random.PRNGKey(0), jnp.asarray(xyz))
    got = taug.augment_clouds(torch.Generator(), torch.from_numpy(xyz), [name])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


# the JAX package's one-step functions: name -> (chain key, non-default kwargs)
ONE_STEP = {
    "jitter": ("Jitter", dict(sigma=0.03, clip=0.04)),
    "shift": ("Shift", dict(shift_range=0.3)),
    "rotate_z": ("RotateZ", None),
    "rotate_y": ("RotateY", None),
    "rotate_small": ("RotateSmall", dict(angle_sigma=0.2, angle_clip=0.25)),
    "scale": ("Scale", dict(low=0.5, high=2.0)),
}


@pytest.mark.parametrize("fn,kwargs", [(fn, kw) for fn, (_, other) in sorted(ONE_STEP.items())
                                       for kw in ({}, other) if kw is not None])
def test_one_step_augmentation_matches_jax_on_injected_draws(rng, monkeypatch, fn, kwargs):
    """`jitter`, `shift`, `rotate_z`, `rotate_y`, `rotate_small` and
    `scale` against the JAX functions of the same name, at the default
    arguments and at others (rtol 1e-5 / atol 1e-6)."""
    xyz = _inject_draws(rng, monkeypatch)
    want = getattr(jaug, fn)(jax.random.PRNGKey(0), jnp.asarray(xyz), **kwargs)
    got = getattr(taug, fn)(torch.Generator(), torch.from_numpy(xyz), **kwargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fn", sorted(ONE_STEP))
def test_one_step_augmentation_equals_the_chain(fn):
    """At the default arguments each one-step function is the chain of its
    one augmentation, bit for bit, from generators of the same seed."""
    xyz = torch.from_numpy(np.random.RandomState(5).randn(4, 40, 3).astype(np.float32))
    got = getattr(taug, fn)(torch.Generator().manual_seed(11), xyz)
    want = taug.augment_clouds(torch.Generator().manual_seed(11), xyz, [ONE_STEP[fn][0]])
    assert torch.equal(got, want)
    assert not torch.equal(got, xyz)


def test_augmentation_distributions():
    gen = torch.Generator().manual_seed(0)
    xyz = torch.zeros(4000, 8, 3)
    noise = taug.draw_jitter(gen, xyz)
    f32 = np.float32                        # the clip bounds as float32 values
    assert noise.abs().max().item() <= f32(0.05)
    assert abs(noise.std().item() - 0.01) < 5e-4 and abs(noise.mean().item()) < 2e-4
    shift = taug.draw_shift(gen, xyz)
    assert shift.shape == (4000, 1, 3) and shift.abs().max().item() <= f32(0.1)
    assert abs(shift.std().item() - 0.2 / np.sqrt(12)) < 2e-3
    angles = taug.draw_small_angles(gen, xyz)
    assert angles.abs().max().item() <= f32(0.18) and abs(angles.std().item() - 0.06) < 2e-3
    ang = taug.draw_angle(gen, xyz)
    assert ang.min().item() >= 0.0 and ang.max().item() < 2 * np.pi
    s = taug.draw_scale(gen, xyz)
    assert s.min().item() >= f32(0.8) and s.max().item() <= f32(1.25)
    r = taug.small_rotation(angles)
    eye = torch.eye(3).expand_as(r)
    torch.testing.assert_close(r @ r.transpose(1, 2), eye, rtol=0, atol=1e-5)
    # a rotation keeps norms; the chain is reproducible from the seed
    pts = torch.randn(4, 100, 3)
    names = taug.resolve_augmentations(["RotateSmall", "Rotate1D"])
    out = taug.augment_clouds(torch.Generator().manual_seed(3), pts, names)
    torch.testing.assert_close(out.norm(dim=-1), pts.norm(dim=-1), rtol=1e-5, atol=1e-5)
    assert torch.equal(out, taug.augment_clouds(torch.Generator().manual_seed(3), pts, names))


def test_resolve_augmentations_matches_jax():
    names = ["Jitter", "RotateSmall", "Shift", "Rotate1D", "Scale"]
    for axis in (1, 2):
        assert list(taug.resolve_augmentations(names, axis)) == \
            list(jaug.resolve_augmentations(names, axis))
    with pytest.raises(KeyError):
        taug.resolve_augmentations(["Flip"])


def _write_dataset(root, rs):
    os.makedirs(root)
    sizes = [300, 90, 250, 400, 180, 260]       # one short cloud (duplicate-padding)
    lines = []
    for i, n in enumerate(sizes):
        cloud = rs.randn(n, 6).astype(np.float32) * 8.0   # some points beyond 20 m
        cloud.tofile(os.path.join(root, f"cloud_{i}.bin"))
        pos = " ".join(str(j) for j in ((i + 1) % 6, (i + 2) % 6))
        lines.append(f"cloud_{i}.bin | {pos} | {(i + 3) % 6}")
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(lines) + "\n\n")
    return os.path.join(root, "train.txt")


@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_triplet_dataset_matches_jax(tmp_path, shard):
    meta = _write_dataset(str(tmp_path / "train"), np.random.RandomState(1))
    ours = tdg.TripletDataset(meta, seed=4, shard_index=shard[0], num_shards=shard[1],
                              use_native="no")
    theirs = jdg.TripletDataset(meta, seed=4, shard_index=shard[0], num_shards=shard[1],
                                use_native="no")
    assert ours.size == theirs.size == 6
    for epoch in range(2):
        np.testing.assert_array_equal(ours.epoch_order(epoch), theirs.epoch_order(epoch))
        got = list(ours.epoch_triplets(epoch, 2, 128))
        want = list(theirs.epoch_triplets(epoch, 2, 128))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a.shape == (2, 128, 6)
                np.testing.assert_array_equal(a, b)
    m = tdg.parse_metadata(meta)
    assert [(x.fname, x.positives, x.nonnegatives) for x in m] == \
        [(x.fname, x.positives, x.nonnegatives) for x in jdg.parse_metadata(meta)]


def test_crop_and_resample_and_prefetch():
    cloud = np.random.RandomState(0).randn(500, 6).astype(np.float32) * 15.0
    for n in (64, 1000):
        a = tdg.crop_and_resample(cloud, n, np.random.RandomState(2))
        b = jdg.crop_and_resample(cloud, n, np.random.RandomState(2))
        np.testing.assert_array_equal(a, b)
        assert (np.sum(a[:, :3] ** 2, axis=1) <= 400.0).all()
    with pytest.raises(ValueError):
        tdg.crop_and_resample(cloud + 100.0, 8, np.random.RandomState(0))
    assert list(tdg.prefetch(iter(range(5)), transform=lambda x: x * 2)) == [0, 2, 4, 6, 8]

    def boom():
        yield 1
        raise OSError("disk")

    with pytest.raises(OSError, match="disk"):
        list(tdg.prefetch(boom()))
