"""The training kernels' recompute arithmetic (3xTF32 on the tensor cores),
emulated in torch on the CPU, against the plain passes and the JAX
reference at the tolerances the kernels are held to on the card.

csrc/fused_train.cu computes every conv of the recompute, y = h W + b, with
mma.sync TF32 operands in the 3xTF32 split: each operand v becomes
hi = tf32(v) (cvt.rna: round to nearest, ties away from zero, to 10
mantissa bits) and lo = tf32(v - hi); each 8-deep block of the product
sums lo·hi, then hi·lo, then hi·hi into fresh f32 accumulators (the small
terms first; lo·lo is dropped), which are added to the running sums with
__fadd_rn; the bias is added after the product. `tf32x3_matmul`
(tests/tf32_emulation.py, shared with the K6 emulation) emulates that.

The towers run at the paper widths (detector 3-64-128-256, descriptor
3-32-64 | poolcat | 128) on 256 clusters of 64 slots, the first 64 with
every slot equal (every slot ties in the pool). Folded BN as the card's
check folds it: from the plain stats pass. Tolerances: K7's means rtol 1e-5
/ atol 1e-6 and variances rtol 1e-4 / atol 1e-6, K8's pooled atol 1e-4,
tie counts equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from feat3dnet_tpu.ops import fused_train as jft
from feat3dnet_tpu_torch.ops import fused_train as tft
from tests.tf32_emulation import round_toward_zero, tf32_rna, tf32x3_matmul

NS, G, TIED, EPS = 64, 256, 64, 1e-3
TOWERS = {"detector": (tft.detector_plan(3), (64, 128, 256)),
          "descriptor": (tft.descriptor_plan(2, 1), (32, 64, 128))}


def test_tf32_split_and_rounding():
    one = torch.tensor(1.0)
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12, 1 + 3 * 2.0 ** -12])
    np.testing.assert_array_equal(
        tf32_rna(tie).numpy(), np.float32([1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1, 1 + 2.0 ** -10]))
    assert tf32_rna(one).item() == 1.0
    near = torch.tensor([1 + 2.0 ** -30, -(1 + 2.0 ** -30), 1 - 2.0 ** -30], dtype=torch.float64)
    np.testing.assert_array_equal(round_toward_zero(near).numpy(),
                                  np.float32([1, -1, np.nextafter(np.float32(1), 0)]))
    v = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(np.float32))
    hi = tf32_rna(v)
    lo = tf32_rna(v - hi)
    assert not (hi.view(torch.int32) & 0x1FFF).any() and not (lo.view(torch.int32) & 0x1FFF).any()
    assert ((hi - v).abs() <= 2.0 ** -11 * v.abs()).all()
    # hi + lo carries 22 bits: within 2^-22 of v
    assert ((hi.double() + lo.double() - v.double()).abs() <= 2.0 ** -22 * v.abs().double()).all()


def _inputs(kind):
    rs = np.random.RandomState(7)
    plan, widths = TOWERS[kind]
    x = (0.5 * rs.randn(NS, G, 3)).astype(np.float32)
    x[:, :TIED] = x[0:1, :TIED]
    flat = []
    for ci, co in tft.plan_conv_widths(plan, widths, 3):
        flat += [rs.randn(ci, co) * np.sqrt(2.0 / ci), rs.randn(co) * 0.1,
                 1 + 0.2 * rs.randn(co), 0.1 * rs.randn(co)]
    return plan, widths, x, [np.asarray(f, np.float32) for f in flat]


@pytest.fixture(scope="module", params=sorted(TOWERS))
def emulated(request):
    """Phase 9's forward chain: per conv the plain stats pass and the
    emulated one (both (sum y, sum y^2)), the plain stats folding the BN;
    then the emulated and plain outputs of the top conv, (ns, G, C_top)."""
    plan, widths, x_np, flat_np = _inputs(request.param)
    x, flat = torch.from_numpy(x_np), [torch.from_numpy(f) for f in flat_np]
    count = float(NS * G)
    folded, stats, h, j = [], [], x, 0
    for op in plan:
        if op[0] == "poolcat":
            h = torch.cat([h, torch.amax(h, dim=0, keepdim=True).expand_as(h)], dim=-1)
            continue
        w, b, g, be = flat[4 * j:4 * j + 4]
        y = tf32x3_matmul(h.reshape(-1, h.shape[-1]), w).reshape(NS, G, -1) + b
        emu = torch.stack([y.double().sum(dim=(0, 1)), (y * y).double().sum(dim=(0, 1))])
        plain = tft.stats_pass_plain(x, plan, folded, w, b, G)
        stats.append((emu.float(), plain))
        _, _, a, c, _ = tft._finalize_stats(plain, count, g, be, EPS)
        folded.append((w, b, a, c))
        z = y * a + c
        h = torch.clamp(z, min=0.0) if op[1] else z
        j += 1
    h_plain, _ = tft._run_plan(x, plan, folded, len(folded))
    return dict(plan=plan, widths=widths, x=x_np, flat=flat_np, stats=stats, h=h,
                h_plain=h_plain, folded=folded)


def _means_vars(st):
    m = st[0] / float(NS * G)
    return m, st[1] / float(NS * G) - m * m


def test_tf32x3_recompute_matches_plain(emulated):
    for emu, plain in emulated["stats"]:
        (me, ve), (mp, vp) = _means_vars(emu), _means_vars(plain)
        torch.testing.assert_close(me, mp, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(ve, vp, rtol=1e-4, atol=1e-6)
    h, hp = emulated["h"], emulated["h_plain"]
    pool, pool_p = torch.amax(h, dim=0), torch.amax(hp, dim=0)
    assert (pool - pool_p).abs().max().item() <= 1e-4
    # the all-ties clusters: every slot ties in both
    cnt = (h[:, :TIED] == pool[:TIED]).sum(dim=0)
    cnt_p = (hp[:, :TIED] == pool_p[:TIED]).sum(dim=0)
    assert torch.equal(cnt, cnt_p) and bool((cnt == NS).all())


def test_tf32x3_recompute_matches_jax(emulated):
    pooled_j, (means_j, vars_j) = jft.reference_tower(
        jnp.asarray(emulated["x"]), tuple(jnp.asarray(f) for f in emulated["flat"]),
        emulated["plan"], emulated["widths"], NS, G, EPS)
    for (emu, _), mj, vj in zip(emulated["stats"], means_j, vars_j):
        me, ve = _means_vars(emu)
        np.testing.assert_allclose(me.numpy(), np.asarray(mj), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ve.numpy(), np.asarray(vj), rtol=1e-4, atol=1e-6)
    pool = torch.amax(emulated["h"], dim=0).numpy()
    assert np.abs(pool - np.asarray(pooled_j)).max() <= 1e-4
