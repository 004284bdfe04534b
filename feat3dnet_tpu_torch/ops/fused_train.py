"""Fused training-mode tower passes (port of feat3dnet_tpu/ops/fused_train.py).

The pre-pool segment of a tower (ConvBN layers with training BN, the
descriptor's pool-concat, the final slot max-pool) runs as a multi-pass
pipeline that never keeps an inter-layer activation in device memory:

  forward   one stats pass per conv (K7): recompute the tower prefix from
            x with the finalised folded affines, accumulate the new conv's
            masked per-channel sum and sum of squares; `_finalize_stats`
            turns them into the BN moments and the folded affine
            z = y * a + c. Then the final pass (K8): full recompute and the
            slot max-pool.
  backward  the top pass (K9): recompute, route dpooled through the final
            pool's ties (even split), the top conv's sum dz and
            sum dz * xhat. Then one pass per conv from the top down (K10):
            dW and db, the propagated cotangent do_{j-1} in `cot_dtype`
            (through the pool-concat where one precedes conv j) and the next
            conv's sums from the rounded cotangent; or dx for conv 0.

`tower_prepool_fused` is a torch.autograd.Function playing the part of the
JAX custom_vjp: it returns (pooled, (means, vars)), the moments
non-differentiable, and its backward gives dx, dW, db, dgamma, dbeta.
`convbn_maxpool_fused` and `reference_convbn_maxpool` are it and
`reference_tower` on the detector's plan, as in the JAX package.

Each pass is a wrapper with a launch counter and `.plain`: CPU tensors take
the plain version (which materialises the activations); CUDA tensors launch
the kernel in csrc/fused_train.cu or raise. The kernels reduce across
blocks through per-block partials summed by one torch.sum, so two runs on
the same input give the same bits.

Layout: slot-major x (ns, Gp, C_in), Gp >= g_total real clusters; pad
clusters are masked out of the statistics and of dy, and their pooled rows
are garbage. A plan is a tuple of ("conv", relu) and ("poolcat",) entries,
as in the JAX package. The TPU's lane-dense "t8" layout is not ported
(ROADMAP).

Data parallelism (`group=`, a torch.distributed process group; the JAX
package's `axis_name`): every rank runs the passes on its own clusters and
the BN statistics are the whole group's. Between the launches, each
conv's (sum y, sum y^2) is all-reduced before `_finalize_stats`, and in
the backward a copy of each level's (sum dz, sum dz * xhat) is
all-reduced before m1 and m2, which dx needs. dW, db, dgamma and dbeta
stay the rank's own share (from its rows and its local sums): the
trainer's one all-reduce of the gradients sums them, so no leaf is
reduced twice. Every rank holds the same number of clusters (the
data-parallel step's shards are equal), so the global row count is the
group's size times the local one, a host number that is not sent. With
group=None nothing changes.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from feat3dnet_tpu_torch import kernels
from feat3dnet_tpu_torch.utils.collectives import all_reduce_
from feat3dnet_tpu_torch.utils.profiling import spanned

Plan = Tuple[Tuple, ...]
# blocks of a pass (each walks its share of the clusters); the per-block
# partials of the cross-block sums are (this many, ...) tensors
GRID_BLOCKS = 264
# widest conv input or output, widest x, most slots, most convs a kernel takes
MAX_WIDTH, MAX_CIN0, MAX_SLOTS, MAX_CONVS = 256, 4, 64, 8


def detector_plan(n_convs: int) -> Plan:
    return (("conv", True),) * n_convs


def descriptor_plan(n_pre: int, n_mid: int) -> Plan:
    mids = tuple(("conv", i < n_mid - 1) for i in range(n_mid))
    return (("conv", True),) * n_pre + (("poolcat",),) + mids


def plan_conv_widths(plan: Plan, widths: Sequence[int], cin: int) -> List[Tuple[int, int]]:
    """Per conv: (input width, output width) implied by the plan."""
    out, c, j = [], cin, 0
    for op in plan:
        if op[0] == "poolcat":
            c = 2 * c
        else:
            out.append((c, widths[j]))
            c = widths[j]
            j += 1
    return out


def _n_convs(plan: Plan) -> int:
    return sum(1 for op in plan if op[0] == "conv")


def _conv_flags(plan: Plan) -> List[Tuple[bool, bool]]:
    """Per conv: (relu, a poolcat directly precedes it)."""
    out, after = [], False
    for op in plan:
        if op[0] == "poolcat":
            after = True
        else:
            out.append((bool(op[1]), after))
            after = False
    return out


# ---------------------------------------------------------------------------
# plain versions (torch, activations materialised)
# ---------------------------------------------------------------------------


class _Rec:
    """Per-conv forward record: input h_in, pre-BN y, output o."""

    __slots__ = ("h_in", "y", "o", "after_poolcat")

    def __init__(self, h_in, y, o, after_poolcat):
        self.h_in, self.y, self.o, self.after_poolcat = h_in, y, o, after_poolcat


def _pool_and_ties(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slot max-pool of (ns, G, C) -> (pool (G, C), tie count (G, C))."""
    pool = torch.amax(h, dim=0)
    return pool, (h == pool).to(torch.float32).sum(dim=0)


def _route_pool(h, pool, cnt, dpool) -> torch.Tensor:
    """Even-split tie routing of dpool (G, C) -> (ns, G, C)."""
    unit = dpool / cnt
    return torch.where(h == pool, unit, torch.zeros((), dtype=h.dtype, device=h.device))


def _act(z: torch.Tensor, relu: bool) -> torch.Tensor:
    return torch.clamp(z, min=0.0) if relu else z


def _run_plan(x_sm: torch.Tensor, plan: Plan, convs, upto: int):
    """Interpret the plan with folded convs (W, b, a, c) until `upto` convs are
    consumed (a poolcat before the stopping conv is applied). Returns
    (h, per-conv records)."""
    h, recs, j, after = x_sm, [], 0, False
    for op in plan:
        if op[0] == "poolcat":
            pool, _ = _pool_and_ties(h)
            h = torch.cat([h, pool.expand_as(h)], dim=-1)
            after = True
            continue
        if j == upto:
            break
        w, b, a, c = convs[j]
        y = torch.matmul(h, w) + b
        o = _act(y * a + c, op[1])
        recs.append(_Rec(h, y, o, after))
        h, after, j = o, False, j + 1
    return h, recs


def _row_mask(gp: int, g_total: int, device) -> torch.Tensor:
    """(1, Gp, 1) f32: 1 for real clusters."""
    return (torch.arange(gp, device=device) < g_total).to(torch.float32)[None, :, None]


def _relu_of(plan: Plan, j: int) -> bool:
    return _conv_flags(plan)[j][0]


def stats_pass_plain(x_sm, plan, prefix, w, b, g_total):
    """Masked (sum y, sum y^2) of conv j = len(prefix) -> (2, C_j)."""
    h, _ = _run_plan(x_sm, plan, prefix, len(prefix))
    ym = (torch.matmul(h, w) + b) * _row_mask(x_sm.shape[1], g_total, x_sm.device)
    return torch.stack([ym.sum(dim=(0, 1)), (ym * ym).sum(dim=(0, 1))])


def final_pass_plain(x_sm, plan, convs):
    """Full folded recompute + slot max-pool -> (Gp, C_top)."""
    h, _ = _run_plan(x_sm, plan, convs, len(convs))
    return torch.amax(h, dim=0)


def bwd_top_pass_plain(x_sm, plan, convs, mu, isig, dpooled):
    """dpooled routed through the final pool's ties; (sum dz, sum dz * xhat)
    of the top conv -> (2, C_top)."""
    h, recs = _run_plan(x_sm, plan, convs, len(convs))
    top = recs[-1]
    xhat = (top.y - mu) * isig
    pool, cnt = _pool_and_ties(h)
    do = _route_pool(h, pool, cnt, dpooled)
    if _relu_of(plan, len(convs) - 1):
        w, b, a, c = convs[-1]
        do = torch.where(top.y * a + c > 0.0, do, torch.zeros((), device=do.device))
    return torch.stack([do.sum(dim=(0, 1)), (do * xhat).sum(dim=(0, 1))])


def bwd_pass_plain(x_sm, plan, convs, mu, isig, src, m1, m2, ga_sig, mu_p, isig_p,
                   g_total, cot_dtype=torch.bfloat16):
    """Backward of conv j = len(convs) - 1. src: dpooled (Gp, C_j) when j is
    the top conv, else the streamed cotangent (ns, Gp, C_j). Returns
    (dW (C_in, C_j), db (C_j,), do_{j-1} (ns, Gp, C_{j-1}) in cot_dtype,
    (sum dz, sum dz * xhat) of conv j-1 (2, C_{j-1})) for j > 0, and
    (dW, db, dx (ns, Gp, C_in), None) for j == 0."""
    j = len(convs) - 1
    zero = torch.zeros((), device=x_sm.device)
    h, recs = _run_plan(x_sm, plan, convs, j + 1)
    rec = recs[-1]
    w, b, a, c = convs[j]
    xhat = (rec.y - mu) * isig
    if j == _n_convs(plan) - 1:
        pool, cnt = _pool_and_ties(h)
        do = _route_pool(h, pool, cnt, src)
    else:
        do = src.to(x_sm.dtype)
    dz = torch.where(rec.y * a + c > 0.0, do, zero) if _relu_of(plan, j) else do
    dy = ga_sig * (dz - m1 - xhat * m2) * _row_mask(x_sm.shape[1], g_total, x_sm.device)
    cin, cout = w.shape
    dw = rec.h_in.reshape(-1, cin).t() @ dy.reshape(-1, cout)
    db = dy.sum(dim=(0, 1))
    dcat = torch.matmul(dy, w.t())
    if j == 0:
        return dw, db, dcat, None
    prev = recs[-2]
    if rec.after_poolcat:
        cp = prev.o.shape[-1]
        pool2, cnt2 = _pool_and_ties(prev.o)
        do_prev = dcat[..., :cp] + _route_pool(prev.o, pool2, cnt2, dcat[..., cp:].sum(dim=0))
    else:
        do_prev = dcat
    do_prev = do_prev.to(cot_dtype)
    dop = do_prev.to(x_sm.dtype)
    wp, bp, ap, cp_ = convs[j - 1]
    if _relu_of(plan, j - 1):
        dop = torch.where(prev.y * ap + cp_ > 0.0, dop, zero)
    xhat_p = (prev.y - mu_p) * isig_p
    return dw, db, do_prev, torch.stack([dop.sum(dim=(0, 1)), (dop * xhat_p).sum(dim=(0, 1))])


# ---------------------------------------------------------------------------
# kernel wrappers (K7-K10)
# ---------------------------------------------------------------------------


def _check_cuda(name: str, x_sm: torch.Tensor, tensors) -> None:
    if x_sm.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x_sm.device}")
    if x_sm.dtype != torch.float32 or x_sm.dim() != 3 or not x_sm.is_contiguous():
        raise ValueError(f"{name}: want contiguous (ns, Gp, C_in) float32 x, got "
                         f"{tuple(x_sm.shape)} {x_sm.dtype}")
    ns, _, cin = x_sm.shape
    if not (1 <= ns <= MAX_SLOTS and 1 <= cin <= MAX_CIN0):
        raise ValueError(f"{name}: the kernel takes ns <= {MAX_SLOTS} and C_in <= "
                         f"{MAX_CIN0}, got ns={ns}, C_in={cin}")
    for t in tensors:
        if t is not None and (t.device != x_sm.device or t.dtype != torch.float32):
            raise ValueError(f"{name}: every operand must be float32 on {x_sm.device}")


def _pack(name: str, x_sm, plan, convs, vecs=(), with_wt=False):
    """Flat f32 weight buffer on the device, the host (n, 9) int32 conv table
    (cin, cout, relu, poolcat, W, W^T, b, a, c offsets; -1 = absent) and the
    host int32 offsets of `vecs`."""
    flags = _conv_flags(plan)
    if not 1 <= len(convs) <= min(MAX_CONVS, len(flags)):
        raise ValueError(f"{name}: {len(convs)} convs for a plan of {len(flags)}")
    parts, rows, off = [], [], 0

    def put(t):
        nonlocal off
        parts.append(t.reshape(-1))
        off += t.numel()
        return off - t.numel()

    for l, cv in enumerate(convs):
        w = cv[0]
        cin, cout = w.shape
        if (l > 0 and (cin % 4 or cin > MAX_WIDTH)) or cout % 4 or cout > MAX_WIDTH:
            raise ValueError(f"{name}: conv {l} is {cin} -> {cout}; the kernel takes "
                             f"widths that are multiples of 4 and at most {MAX_WIDTH}")
        if l == 0 and cin != x_sm.shape[2]:
            raise ValueError(f"{name}: conv 0 takes {cin} channels, x has {x_sm.shape[2]}")
        row = [cin, cout, int(flags[l][0]), int(flags[l][1]), put(w), -1, put(cv[1]), -1, -1]
        if len(cv) == 4:
            row[7], row[8] = put(cv[2]), put(cv[3])
        if with_wt and l == len(convs) - 1:
            row[5] = put(w.t().contiguous())
        rows.append(row)
    _check_cuda(name, x_sm, [t for cv in convs for t in cv] + list(vecs))
    voffs = [put(v) if v is not None else -1 for v in vecs]
    wts = torch.cat([p.contiguous() for p in parts])
    return (wts, torch.tensor(rows, dtype=torch.int32),
            torch.tensor(voffs or [0], dtype=torch.int32))


def _blocks(gp: int) -> int:
    return max(1, min(gp, GRID_BLOCKS))


@spanned("f3d.k7.stats")
def stats_pass(x_sm, plan, prefix, w, b, g_total):
    """K7: masked (sum y, sum y^2) of conv j after the folded prefix ->
    (2, C_j). prefix: folded (W, b, a, c) of convs < j."""
    if x_sm.device.type == "cpu":
        return stats_pass_plain(x_sm, plan, prefix, w, b, g_total)
    wts, table, _ = _pack("stats_pass", x_sm, plan, list(prefix) + [(w, b)])
    ns, gp, cin = x_sm.shape
    nblk = _blocks(gp)
    part = torch.empty((nblk, 2, w.shape[1]), dtype=torch.float32, device=x_sm.device)
    kernels.launch_train_stats(x_sm, g_total, wts, table, nblk, part)
    stats_pass.launches += 1
    return part.sum(dim=0)


@spanned("f3d.k8.final")
def final_pass(x_sm, plan, convs, stop=None):
    """K8: full folded recompute + slot max-pool -> pooled (Gp, C_top).
    stop (CUDA only, for the time split): a stage of kernels.FINAL_STOPS
    after which the kernel leaves each cluster; pooled is then not written
    and the launch is not counted."""
    if x_sm.device.type == "cpu":
        return final_pass_plain(x_sm, plan, convs)
    wts, table, _ = _pack("final_pass", x_sm, plan, convs)
    gp = x_sm.shape[1]
    pooled = torch.empty((gp, convs[-1][0].shape[1]), dtype=torch.float32, device=x_sm.device)
    kernels.launch_train_final(x_sm, wts, table, _blocks(gp), pooled, stop)
    if stop is None:
        final_pass.launches += 1
    return pooled


@spanned("f3d.k9.bwd_top")
def bwd_top_pass(x_sm, plan, convs, mu, isig, dpooled):
    """K9: dpooled (Gp, C_top) through the final pool's ties -> the top conv's
    (sum dz, sum dz * xhat), (2, C_top)."""
    if x_sm.device.type == "cpu":
        return bwd_top_pass_plain(x_sm, plan, convs, mu, isig, dpooled)
    if len(convs) != _n_convs(plan):
        raise ValueError("bwd_top_pass: needs every conv of the plan")
    wts, table, vecs = _pack("bwd_top_pass", x_sm, plan, convs, (mu, isig))
    c_top = convs[-1][0].shape[1]
    gp = x_sm.shape[1]
    if dpooled.shape != (gp, c_top) or dpooled.dtype != torch.float32 \
            or dpooled.device != x_sm.device or not dpooled.is_contiguous():
        raise ValueError(f"bwd_top_pass: want contiguous ({gp}, {c_top}) float32 dpooled")
    nblk = _blocks(gp)
    part = torch.empty((nblk, 2, c_top), dtype=torch.float32, device=x_sm.device)
    kernels.launch_train_bwd_top(x_sm, wts, table, vecs, nblk, dpooled, part)
    bwd_top_pass.launches += 1
    return part.sum(dim=0)


@spanned("f3d.k10.bwd")
def bwd_pass(x_sm, plan, convs, mu, isig, src, m1, m2, ga_sig, mu_p, isig_p,
             g_total, cot_dtype=torch.bfloat16, stop=None):
    """K10: the backward of conv j = len(convs) - 1 (see bwd_pass_plain).
    stop (CUDA only, for the time split): a stage of kernels.BWD_STOPS after
    which the kernel leaves each cluster; the outputs are then partial and
    the launch is not counted."""
    if x_sm.device.type == "cpu":
        return bwd_pass_plain(x_sm, plan, convs, mu, isig, src, m1, m2, ga_sig, mu_p,
                              isig_p, g_total, cot_dtype)
    if cot_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"bwd_pass: cot_dtype {cot_dtype} is not bfloat16 or float32")
    j = len(convs) - 1
    vec_list = (mu, isig, m1, m2, ga_sig) + ((mu_p, isig_p) if j > 0 else (None, None))
    wts, table, vecs = _pack("bwd_pass", x_sm, plan, convs, vec_list, with_wt=True)
    ns, gp, cin0 = x_sm.shape
    cin, cout = convs[j][0].shape
    top = j == _n_convs(plan) - 1
    want = (gp, cout) if top else (ns, gp, cout)
    src_dtype = torch.float32 if top else cot_dtype
    if tuple(src.shape) != want or src.dtype != src_dtype or src.device != x_sm.device \
            or not src.is_contiguous():
        raise ValueError(f"bwd_pass: want a contiguous {want} {src_dtype} cotangent, got "
                         f"{tuple(src.shape)} {src.dtype}")
    nblk = _blocks(gp)
    dev = x_sm.device
    dw_part = torch.empty((nblk, cin, cout), dtype=torch.float32, device=dev)
    db_part = torch.empty((nblk, cout), dtype=torch.float32, device=dev)
    if j > 0:
        cprev = convs[j - 1][0].shape[1]
        out = torch.empty((ns, gp, cprev), dtype=cot_dtype, device=dev)
        bst_part = torch.empty((nblk, 2, cprev), dtype=torch.float32, device=dev)
    else:
        out = torch.empty((ns, gp, cin0), dtype=torch.float32, device=dev)
        bst_part = None
    kernels.launch_train_bwd(x_sm, g_total, wts, table, vecs, nblk, top, src, dw_part,
                             db_part, out, bst_part, stop)
    if stop is None:
        bwd_pass.launches += 1
    return (dw_part.sum(dim=0), db_part.sum(dim=0), out,
            None if bst_part is None else bst_part.sum(dim=0))


for _w, _p in ((stats_pass, stats_pass_plain), (final_pass, final_pass_plain),
               (bwd_top_pass, bwd_top_pass_plain), (bwd_pass, bwd_pass_plain)):
    _w.launches = 0
    _w.plain = _p


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------


def _finalize_stats(stats, count: float, gamma, beta, eps: float):
    """(2, C) sum/sumsq -> (mean, var, a, c, inv_sigma); z = y * a + c."""
    s, q = stats[0], stats[1]
    mean = s / count
    var = torch.clamp(q / count - mean * mean, min=0.0)
    inv_sigma = torch.rsqrt(var + eps)
    a = gamma * inv_sigma
    c = beta - a * mean
    return mean, var, a, c, inv_sigma


def _count(ns: int, g_total: int, group) -> float:
    """The BN row count of the whole group (equal shards)."""
    return float(ns * g_total * (1 if group is None else dist.get_world_size(group)))


def _fwd_impl(x_sm, flat, plan, ns, g_total, eps, group=None):
    n = _n_convs(plan)
    count = _count(ns, g_total, group)
    folded, means, vars_, isigs = [], [], [], []
    for j in range(n):
        w, b, g, be = flat[4 * j:4 * j + 4]
        stats = stats_pass(x_sm, plan, folded, w, b, g_total)
        if group is not None:
            stats = all_reduce_(stats, group)
        mean, var, a, c, isig = _finalize_stats(stats, count, g, be, eps)
        means.append(mean)
        vars_.append(var)
        isigs.append(isig)
        folded.append((w, b, a, c))
    return final_pass(x_sm, plan, folded), means, vars_, folded, isigs


def _bwd_impl(x_sm, flat, dpooled, means, folded, isigs, plan, ns, g_total, cot_dtype,
              group=None):
    n = _n_convs(plan)
    count = _count(ns, g_total, group)
    bst = bwd_top_pass(x_sm, plan, folded, means[-1], isigs[-1], dpooled)
    dflat: List[Optional[torch.Tensor]] = [None] * (4 * n)
    src, dx = dpooled, None
    for j in range(n - 1, -1, -1):
        g = flat[4 * j + 2]
        # the group's sums for m1 and m2; dgamma and dbeta below stay local
        bst_all = bst if group is None else all_reduce_(bst.clone(), group)
        m1, m2 = bst_all[0] / count, bst_all[1] / count
        dw, db, out, bst_prev = bwd_pass(
            x_sm, plan, folded[:j + 1], means[j], isigs[j], src, m1, m2, g * isigs[j],
            means[j - 1] if j else None, isigs[j - 1] if j else None, g_total, cot_dtype)
        # dgamma = sum dz * xhat, dbeta = sum dz: free from the reductions
        dflat[4 * j:4 * j + 4] = [dw, db, bst[1], bst[0]]
        if j > 0:
            src, bst = out, bst_prev
        else:
            dx = out
    return dx, dflat


class _TowerPrepool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_sm, plan, ns, g_total, eps, cot_dtype, group, *flat):
        pooled, means, vars_, folded, isigs = _fwd_impl(x_sm, flat, plan, ns, g_total, eps,
                                                        group)
        n = len(means)
        ctx.plan, ctx.ns, ctx.g_total, ctx.cot_dtype, ctx.n = plan, ns, g_total, cot_dtype, n
        ctx.group = group
        ctx.save_for_backward(x_sm, *flat, *means, *isigs,
                              *[f[2] for f in folded], *[f[3] for f in folded])
        ctx.mark_non_differentiable(*means, *vars_)
        return (pooled, *means, *vars_)

    @staticmethod
    def backward(ctx, dpooled, *_):
        n = ctx.n
        saved = ctx.saved_tensors
        x_sm, flat = saved[0], saved[1:1 + 4 * n]
        means, isigs, a_s, c_s = (saved[1 + 4 * n + k * n:1 + 4 * n + (k + 1) * n]
                                  for k in range(4))
        folded = [(flat[4 * j], flat[4 * j + 1], a_s[j], c_s[j]) for j in range(n)]
        if dpooled is None:
            dpooled = torch.zeros((x_sm.shape[1], flat[-4].shape[1]), dtype=torch.float32,
                                  device=x_sm.device)
        dx, dflat = _bwd_impl(x_sm, flat, dpooled.contiguous(), means, folded, isigs,
                              ctx.plan, ctx.ns, ctx.g_total, ctx.cot_dtype, ctx.group)
        return (dx, None, None, None, None, None, None, *dflat)


def tower_prepool_fused(x_sm: torch.Tensor, flat_params: Sequence[torch.Tensor], plan: Plan,
                        widths: Sequence[int], ns: int, g_total: int, eps: float = 1e-3,
                        cot_dtype: torch.dtype = torch.bfloat16, group=None):
    """Fused training-mode ConvBN tower + slot max-pool.

    x_sm: (ns, Gp, C_in) slot-major offsets, Gp >= g_total (pad clusters
    are masked out of every statistic; their pooled rows are garbage).
    flat_params: per conv (W (Cin, Cout), b, gamma, beta), flat, in plan
    order. cot_dtype: the streamed inter-layer cotangent's type. group: a
    torch.distributed process group whose ranks share the BN statistics
    (each with the same Gp and g_total), or None.

    Returns (pooled (Gp, C_top), (batch_means, batch_vars) per conv). The
    loss differentiates through the batch moments (flax BatchNorm training
    semantics); the moments themselves are non-differentiable.
    """
    flat = tuple(flat_params)
    n = _n_convs(plan)
    if len(flat) != 4 * n or tuple(widths) != tuple(flat[4 * j].shape[1] for j in range(n)):
        raise ValueError(f"tower_prepool_fused: {len(flat)} params and widths {tuple(widths)} "
                         f"for a plan of {n} convs")
    if x_sm.shape[0] != ns or not 0 < g_total <= x_sm.shape[1]:
        raise ValueError(f"tower_prepool_fused: x {tuple(x_sm.shape)}, ns={ns}, "
                         f"g_total={g_total}")
    out = _TowerPrepool.apply(x_sm, plan, ns, g_total, float(eps), cot_dtype, group, *flat)
    return out[0], (tuple(out[1:1 + n]), tuple(out[1 + n:]))


def convbn_maxpool_fused(x_sm: torch.Tensor, flat_params: Sequence[torch.Tensor],
                         widths: Sequence[int], ns: int, g_total: int, eps: float = 1e-3,
                         cot_dtype: torch.dtype = torch.bfloat16, group=None):
    """The detector's pre-pool segment (a chain of ReLU ConvBNs, then the
    slot max-pool): `tower_prepool_fused` on `detector_plan(len(widths))`.
    JAX's `ct` and `interpret` schedule its kernels on the TPU, and its
    `x_layout` and `cin` select the TPU's t8 layout, which is not ported;
    none of them is taken."""
    return tower_prepool_fused(x_sm, flat_params, detector_plan(len(widths)), widths, ns,
                               g_total, eps, cot_dtype, group)


def reference_tower(x_sm, flat_params, plan: Plan, widths, ns: int, g_total: int,
                    eps: float = 1e-3):
    """Plain torch reference with flax's math, differentiable by autograd:
    slot-major (ns, G, C_in) -> (pooled (G, C_top), (means, vars))."""
    h = x_sm[:, :g_total, :]
    means, vars_, j = [], [], 0
    for op in plan:
        if op[0] == "poolcat":
            h = torch.cat([h, torch.amax(h, dim=0, keepdim=True).expand_as(h)], dim=-1)
            continue
        w, b, g, be = flat_params[4 * j:4 * j + 4]
        y = torch.matmul(h, w) + b
        mean = y.mean(dim=(0, 1))
        var = (y * y).mean(dim=(0, 1)) - mean * mean
        z = g * ((y - mean) * torch.rsqrt(var + eps)) + be
        h = torch.relu(z) if op[1] else z
        means.append(mean)
        vars_.append(var)
        j += 1
    return torch.amax(h, dim=0), (tuple(means), tuple(vars_))


def reference_convbn_maxpool(x_sm, flat_params, widths, ns: int, g_total: int,
                             eps: float = 1e-3):
    """`reference_tower` on `detector_plan(len(widths))`."""
    return reference_tower(x_sm, flat_params, detector_plan(len(widths)), widths, ns,
                           g_total, eps)
