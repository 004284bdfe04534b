"""Three-nearest-neighbour inverse-distance interpolation: PointNet++'s
feature propagation (three_nn + three_interpolate of Pointnet2.PyTorch).

Contract (index-exact): for each unknown point, the 3 known points of the
smallest squared distance ((dx*dx) + dy*dy) + dz*dz, ties to the lower
index (`neighborhoods.knn_points`' stable sort); d_i their Euclidean
distances (not squared), r_i = 1 / (d_i + 1e-8), w_i = r_i / ((r_0 + r_1)
+ r_2); out = (w_0 f[i_0] + w_1 f[i_1]) + w_2 f[i_2].

* `three_interpolate_plain` — the plain version on `knn_points`, in blocks
  of unknown points. The CPU path and the oracle for the kernel.
* `three_interpolate` — the wrapper of kernel K11 (csrc/three_interp.cu).
  CPU tensors take the plain version; CUDA tensors launch the kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch

from feat3dnet_tpu_torch import kernels
from feat3dnet_tpu_torch.ops.neighborhoods import gather_points, knn_points
from feat3dnet_tpu_torch.utils.profiling import spanned

_EPS = 1e-8
# unknown points a block of the plain version: its (B, rows, m) distances
_PLAIN_ROWS = 4096


def _weights(dist2: torch.Tensor) -> torch.Tensor:
    """(..., 3) squared distances -> the (..., 3) inverse-distance weights."""
    recip = 1.0 / (torch.sqrt(dist2) + _EPS)
    norm = (recip[..., 0] + recip[..., 1]) + recip[..., 2]
    return recip / norm[..., None]


def three_interpolate_plain(unknown: torch.Tensor, known: torch.Tensor, feats: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, n, 3), (B, m, 3), (B, m, C) -> (out (B, n, C), idx (B, n, 3)
    int32, weights (B, n, 3))."""
    outs, idxs, ws = [], [], []
    for s in range(0, unknown.shape[1], _PLAIN_ROWS):
        d2, idx = knn_points(3, known, unknown[:, s:s + _PLAIN_ROWS])
        w = _weights(d2)
        f = [gather_points(feats, idx[..., i]) for i in range(3)]
        outs.append((w[..., 0:1] * f[0] + w[..., 1:2] * f[1]) + w[..., 2:3] * f[2])
        idxs.append(idx)
        ws.append(w)
    return torch.cat(outs, 1), torch.cat(idxs, 1), torch.cat(ws, 1)


@spanned("f3d.k11.interp")
def three_interpolate(unknown: torch.Tensor, known: torch.Tensor, feats: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Interpolation through kernel K11: (B, n, 3), (B, m, 3), (B, m, C)
    f32 -> (out (B, n, C), idx (B, n, 3) int32, weights (B, n, 3)).

    CPU tensors take `three_interpolate_plain`; CUDA tensors launch the
    kernel, and anything it does not take raises.
    """
    if unknown.device.type == "cpu":
        return three_interpolate_plain(unknown, known, feats)
    if unknown.device.type != "cuda":
        raise ValueError(f"three_interpolate: unsupported device {unknown.device}")
    ts = (unknown, known, feats)
    if (any(t.dtype != torch.float32 or t.dim() != 3 for t in ts)
            or unknown.shape[2] != 3 or known.shape[2] != 3
            or known.shape[:2] != feats.shape[:2] or unknown.shape[0] != known.shape[0]):
        raise ValueError(f"three_interpolate: want (B, n, 3), (B, m, 3), (B, m, C) float32, got "
                         f"{[(tuple(t.shape), t.dtype) for t in ts]}")
    if any(t.device != unknown.device for t in ts):
        raise ValueError("three_interpolate: tensors on different devices")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("three_interpolate: tensors must be contiguous")
    b, n, _ = unknown.shape
    m, c = feats.shape[1], feats.shape[2]
    if m < 3:
        raise ValueError(f"three_interpolate: {m} known points, at least 3 wanted")
    out = torch.empty((b, n, c), dtype=torch.float32, device=unknown.device)
    idx = torch.empty((b, n, 3), dtype=torch.int32, device=unknown.device)
    w = torch.empty((b, n, 3), dtype=torch.float32, device=unknown.device)
    kernels.launch_three_interp(unknown, known, feats, out, idx, w)
    three_interpolate.launches += 1
    return out, idx, w


three_interpolate.launches = 0
three_interpolate.plain = three_interpolate_plain
