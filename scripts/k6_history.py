#!/usr/bin/env python3
"""Build K6 (csrc/fused_detect.cu) of several trees and compare them on one
CUDA card: ptxas lines, SASS instruction counts, and times in turns at the
extraction shapes (the vendored clouds' K4 clusters, trained weights,
unfolded f32, the mode every tree has).

    python3 scripts/k6_history.py TAG=DIR [TAG=DIR ...]

DIR is a checkout (a commit unpacked with `git archive`, say), or its
feat3dnet_tpu_torch/csrc/ with the package around it.
Each tree's fused_detect.cu is built alone, with the headers it has, and
reads the weight buffer its own ops/fused_describe.py packs. A tree whose
f3d_fused_detect takes no folded and bf16 arguments (K6's first form) is
called with that signature. The trees must be K6's FFMA design (no offsets
of tensor-core fragments). Outputs are held to the first tree's (attention
relative and orientation within 1e-5). Run from the root of a checkout; it
writes only under build/.
"""
import ctypes
import inspect
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

HEADERS = ("common.cuh", "slot_layer.cuh")


def tree_csrc(directory):
    csrc = os.path.join(directory, "feat3dnet_tpu_torch", "csrc")
    return os.path.abspath(csrc if os.path.isdir(csrc) else directory)


def tree_pack(directory, w, cfg, dev):
    """The unfolded f32 weights as the tree's own wrapper packs them: (flat,
    table)."""
    pack = cs.other_fused_describe(tree_csrc(directory))._detect_kernel_weights
    unfolded = (True,) if "unfolded" in inspect.signature(pack).parameters else ()
    return pack(w, cfg, dev, *unfolded)[:2]


def tree_library(directory):
    """(ctypes library, build info, whether the entry takes folded and bf16)."""
    from feat3dnet_tpu_torch import kernels

    csrc = tree_csrc(directory)
    headers = tuple(h for h in HEADERS if os.path.isfile(os.path.join(csrc, h)))
    info = kernels.build(csrc, ("fused_detect.cu",), headers)
    with open(os.path.join(csrc, "fused_detect.cu")) as f:
        modes = "int folded" in f.read()
    lib = ctypes.CDLL(info.path)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.f3d_fused_detect
    fn.argtypes = ([P, I, I, P, P, I, I] + ([I, I, F, F, F] if modes else [F, F]) + [P, P])
    fn.restype = I
    return fn, info, modes


def main():
    import torch

    from feat3dnet_tpu_torch.config import ModelConfig
    from feat3dnet_tpu_torch.data.io import example_cloud_path, load_point_cloud
    from feat3dnet_tpu_torch.ops import fused_describe as fd
    from feat3dnet_tpu_torch.utils import load_variables_npz

    trees = dict(a.split("=", 1) for a in sys.argv[1:])
    cs.require(trees and torch.cuda.is_available(), "usage: TAG=DIR ...; needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    libs = {}
    for tag, directory in trees.items():
        fn, info, modes = tree_library(directory)
        libs[tag] = (fn, modes)
        cs.ptxas_lines(tag, info, "fused_detect")
        ops = ("FFMA", "LDS", "LDG", "LDL", "STL", "HMMA")
        for name, c in cs.sass_counts(info, r"\w*fused_detect\w*", ops).items():
            print(f"  sass ({tag}): {name}: " + ", ".join(f"{c[op]} {op}" for op in ops))
    cfg = ModelConfig()
    variables = load_variables_npz(os.path.join(HERE, "feat3dnet_tpu_torch", "assets",
                                                "ckpt4480_variables.npz"))
    w = [t.to(dev) for t in fd.transpose_unfolded_detector(
        fd.detector_weights_unfolded(variables, cfg))]
    packs = {tag: tree_pack(directory, w, cfg, dev) for tag, directory in trees.items()}
    r = np.float32(cfg.base_scale)
    totals = dict.fromkeys(libs, 0.0)
    with torch.no_grad():
        for cloud_name in cs.CLOUDS:
            cloud = load_point_cloud(example_cloud_path(cloud_name))
            offs = cs.sorted_clusters(dev, cloud)[4]
            b, ns, _ = offs.shape
            outs = {tag: torch.empty((b, 3), device=dev) for tag in libs}

            def run(tag):
                fn, modes = libs[tag]
                flat, table = packs[tag]
                head = [ctypes.c_void_p(offs.data_ptr()), ns, b, ctypes.c_void_p(flat.data_ptr()),
                        ctypes.c_void_p(table.data_ptr()), len(cfg.detector_mlp),
                        len(cfg.detector_mlp2)]
                tail = [0, 0, float(r), float(np.float32(1) / r)] if modes else [float(r)]
                err = fn(*head, *tail, float(r * r), ctypes.c_void_p(outs[tag].data_ptr()),
                         ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
                cs.require(err == 0, f"{tag}: CUDA error {err}")

            ms = cs.ms_in_turns({tag: (lambda tag=tag: run(tag)) for tag in libs}, 5)
            first = next(iter(libs))
            for tag in libs:
                a, a0 = outs[tag][:, 0], outs[first][:, 0]
                rel = ((a - a0).abs() / a0.abs().clamp(min=1e-6)).max().item()
                ori = torch.atan2(outs[tag][:, 2], outs[tag][:, 1])
                ori0 = torch.atan2(outs[first][:, 2], outs[first][:, 1])
                o_err = cs._wrapped(ori - ori0).abs().max().item()
                cs.require(rel <= 1e-5 and o_err <= 1e-5, f"{tag} vs {first} on {cloud_name}")
                totals[tag] += ms[tag] / len(cs.CLOUDS)
            print(f"[{card}] fused_detect unfolded {cloud_name} M={b}: " + ", ".join(
                f"{tag} {ms[tag]:.4f} ms" for tag in libs) + " (in turns; outputs within 1e-5 "
                f"of {first})")
    print(f"[{card}] mean over the vendored clouds: " + ", ".join(
        f"{tag} {v:.4f} ms" for tag, v in totals.items()))


if __name__ == "__main__":
    main()
