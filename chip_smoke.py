#!/usr/bin/env python3
"""Smoke run of the PyTorch port (feat3dnet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the three CUDA kernels from
feat3dnet_tpu_torch/csrc with nvcc, then:
  1. holds each kernel against its plain PyTorch version at the main
     path's shapes (FPS and ball query index-exact on the four vendored
     clouds and a synthetic masked case; the fused describe kernel on
     7 680 clusters within stated tolerances);
  2. drives the main path with launch counters reset: Feat3DNet eval at
     the paper config (seeded weights, perturbed BN statistics) on each
     vendored cloud, then 8 ClusterDescriptorServer requests of 7 680
     packed clusters; every kernel must have launched;
  3. checks the outputs (shapes, unit norms, agreement with the model on
     the CPU and with the model path on the card);
  4. times each kernel against its plain version (CUDA events, in turns)
     and the server's descriptors/s.
The line before last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}. Any failure raises (non-zero exit). It
needs a CUDA device and refuses to run without one.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CLOUDS = ("oxford_270.bin", "oxford_456.bin", "kitti_00_001554.bin",
          "kitti_00_004534.bin")
NPOINT, RADIUS, NS = 512, 2.0, 64
BATCH = 7680          # clusters per serving request (2 048 distinct, tiled)
REQUESTS = 8
SEED = 0


def require(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def main():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False; "
                           "this script needs a CUDA device")
    sys.path.insert(0, HERE)
    import feat3dnet_tpu_torch

    pkg_dir = os.path.dirname(os.path.abspath(feat3dnet_tpu_torch.__file__))
    require(pkg_dir == os.path.join(HERE, "feat3dnet_tpu_torch"),
            f"feat3dnet_tpu_torch imported from {pkg_dir}, not from this checkout")

    from feat3dnet_tpu_torch import kernels
    from feat3dnet_tpu_torch.config import ModelConfig
    from feat3dnet_tpu_torch.data.io import example_cloud_path, load_point_cloud
    from feat3dnet_tpu_torch.inference import ClusterDescriptorServer
    from feat3dnet_tpu_torch.models import Feat3DNet
    from feat3dnet_tpu_torch.ops import batch_group, fps, fused_describe
    from feat3dnet_tpu_torch.ops.neighborhoods import gather_points, group_points
    from feat3dnet_tpu_torch.utils import init_variables, load_variables

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # ---- build -----------------------------------------------------------
    info = kernels.build()
    kernels.library()
    print(f"build: {info.seconds:.1f} s -> {os.path.relpath(info.path, HERE)}")
    for line in info.ptxas.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    clouds = {n: torch.from_numpy(
        np.ascontiguousarray(load_point_cloud(example_cloud_path(n))[:, :3]))[None]
        for n in CLOUDS}
    gpu = {n: c.to(dev) for n, c in clouds.items()}
    wrappers = {"fps": fps.farthest_point_sample,
                "ball_query": batch_group.ball_query_fused,
                "fused_describe": fused_describe.fused_describe_clusters_t}
    report = {k: {} for k in wrappers}

    # ---- 1. kernels against their plain versions ----------------------------
    fps_k, fps_p = wrappers["fps"], wrappers["fps"].plain
    pair = torch.cat([gpu["oxford_270.bin"], gpu["oxford_456.bin"]], dim=0)
    centers = {}
    for name, xyz in list(gpu.items()) + [("oxford_pair(B=2)", pair)]:
        k, p = fps_k(xyz, NPOINT), fps_p(xyz, NPOINT)
        require(torch.equal(k, p), f"fps kernel != plain on {name}")
        centers[name] = gather_points(xyz, k).contiguous()
        print(f"K1 fps {name} {tuple(xyz.shape)}: index-exact vs plain")
    report["fps"]["max_abs_err"] = 0

    bq_k, bq_p = wrappers["ball_query"], wrappers["ball_query"].plain
    for name, xyz in list(gpu.items()) + [("oxford_pair(B=2)", pair)]:
        (ik, ck), (ip, cp) = bq_k(xyz, centers[name], RADIUS, NS), bq_p(
            xyz, centers[name], RADIUS, NS)
        require(torch.equal(ik, ip) and torch.equal(ck, cp),
                f"ball query kernel != plain on {name}")
        print(f"K2 ball_query {name}: idx/cnt exact vs plain "
              f"(mean cnt {ck.float().mean().item():.2f})")
    g = torch.Generator(device="cpu").manual_seed(SEED)
    syn = (torch.randn(2, 5000, 3, generator=g) * 3.0).to(dev)
    syn_mask = (torch.rand(2, 5000, generator=g) > 0.3).to(dev)
    syn_ctr = torch.cat([syn[:, :100], syn[:, 100:200] + 40.0], dim=1).contiguous()
    (ik, ck), (ip, cp) = bq_k(syn, syn_ctr, RADIUS, NS, syn_mask), bq_p(
        syn, syn_ctr, RADIUS, NS, syn_mask)
    require(torch.equal(ik, ip) and torch.equal(ck, cp),
            "ball query kernel != plain on the synthetic masked case")
    require(bool((ck[:, 100:] == 0).all()) and bool(syn_mask.gather(
        1, ik.reshape(2, -1).long()).all()), "synthetic case: empty balls / mask")
    print("K2 ball_query synthetic (B=2, N=5000, 30% masked, 200 empty balls): exact")
    report["ball_query"]["max_abs_err"] = 0

    # the serving batch: 512 FPS-centred neighbourhoods of each cloud,
    # origin-centred, 2 048 distinct clusters tiled to BATCH
    per_cloud = []
    for name in CLOUDS:
        nidx, _ = bq_k(gpu[name], centers[name], RADIUS, NS)
        per_cloud.append((group_points(gpu[name], nidx) - centers[name][:, :, None])[0])
    distinct = torch.cat(per_cloud, dim=0)
    clusters = distinct.repeat(-(-BATCH // distinct.shape[0]), 1, 1)[:BATCH].contiguous()

    cfg = ModelConfig()
    variables = init_variables(cfg, seed=SEED, bn_perturb=0.1)
    model = load_variables(Feat3DNet(cfg), variables).eval()
    cpu_model = load_variables(Feat3DNet(cfg), variables).eval()
    model.to(dev)
    server = ClusterDescriptorServer(model)
    weights_t = server._kernel_weights_t()
    packed_host = ClusterDescriptorServer.pack_clusters(clusters.cpu().numpy())
    packed = torch.from_numpy(packed_host).to(dev)
    k3, k3_plain = wrappers["fused_describe"], wrappers["fused_describe"].plain
    (dk, ak), (dp, ap) = k3(weights_t, packed, cfg), k3_plain(weights_t, packed, cfg)
    torch.cuda.synchronize()
    err = (dk - dp).abs().max().item()
    cos = torch.nn.functional.cosine_similarity(dk, dp, dim=1).min().item()
    att_rel = ((ak - ap).abs() / ap.abs().clamp(min=1e-6)).max().item()
    print(f"K3 fused_describe {BATCH} clusters: max|d| {err:.3e} (<= 1e-4), "
          f"min cos {cos:.7f} (>= 0.99999), att rel {att_rel:.3e} (<= 1e-4)")
    require(err <= 1e-4 and cos >= 0.99999 and att_rel <= 1e-4,
            "fused describe kernel outside tolerance vs plain")
    report["fused_describe"]["max_abs_err"] = err

    # ---- 2. the main path, with launch counters from zero --------------------
    for w in wrappers.values():
        w.launches = 0
    outs = {}
    with torch.no_grad():
        for name in CLOUDS:
            outs[name] = model(gpu[name])
        torch.cuda.synchronize()
        answers = []
        t0 = time.perf_counter()
        for _ in range(REQUESTS):
            d, a = server.describe_packed(packed_host)
            answers.append((d.cpu(), a.cpu()))
        serve_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"main path launches: {launches}")
    for k, n in launches.items():
        require(n > 0, f"kernel {k} was not launched on the main path")

    # ---- 3. outputs ------------------------------------------------------------
    for name, out in outs.items():
        require(tuple(out.keypoints.shape) == (1, cfg.num_clusters, 3)
                and tuple(out.features.shape) == (1, cfg.num_clusters, cfg.feature_dim),
                f"model output shapes on {name}")
        norms = out.features.norm(dim=-1)
        require(bool(((norms - 1).abs() < 1e-5).all()), f"unit descriptors on {name}")
        require(bool(torch.isfinite(out.attention).all())
                and bool(torch.isfinite(out.orientation).all()), f"finite heads on {name}")
    print(f"model: {len(outs)} clouds -> keypoints (1, {cfg.num_clusters}, 3), features "
          f"(1, {cfg.num_clusters}, {cfg.feature_dim}) unit-norm, finite attention")
    with torch.no_grad():
        ref = cpu_model(clouds["oxford_270.bin"])
    got = outs["oxford_270.bin"]
    require(torch.equal(got.keypoints.cpu(), ref.keypoints), "keypoints: card != CPU")
    f_err = (got.features.cpu() - ref.features).abs().max().item()
    a_err = ((got.attention.cpu() - ref.attention).abs()
             / ref.attention.abs().clamp(min=1e-6)).max().item()
    print(f"model card vs CPU (oxford_270): keypoints equal, features max|d| "
          f"{f_err:.3e} (<= 1e-4), attention rel {a_err:.3e} (<= 1e-4)")
    require(f_err <= 1e-4 and a_err <= 1e-4, "model on the card disagrees with the CPU")

    d0 = answers[0][0]
    for d, a in answers:
        require(torch.equal(d, d0) and bool(torch.isfinite(a).all()),
                "server answers differ between requests")
    with torch.no_grad():
        dm, _ = server._model_path(clusters)
    cos_all = torch.nn.functional.cosine_similarity(d0, dm.cpu(), dim=1)
    frac = (cos_all >= 0.9999).float().mean().item()
    print(f"server vs model path: min cos {cos_all.min().item():.6f} (>= 0.999), "
          f"{100 * frac:.2f} % at >= 0.9999 (>= 99 %)")
    require(cos_all.min().item() >= 0.999 and frac >= 0.99,
            "server disagrees with the model path")

    # ---- 4. times ------------------------------------------------------------------
    def cuda_ms(fn, reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def in_turns(kernel_fn, plain_fn, reps_k, reps_p):
        kernel_fn()
        plain_fn()
        torch.cuda.synchronize()
        p1 = cuda_ms(plain_fn, reps_p)
        k1 = cuda_ms(kernel_fn, reps_k)
        k2 = cuda_ms(kernel_fn, reps_k)
        p2 = cuda_ms(plain_fn, reps_p)
        return (k1 + k2) / 2, (p1 + p2) / 2

    with torch.no_grad():
        for key, fn_k, fn_p, rk, rp in (
                ("fps", lambda x: fps_k(x, NPOINT), lambda x: fps_p(x, NPOINT), 10, 2),
                ("ball_query", None, None, 20, 5)):
            per = []
            for name in CLOUDS:
                xyz = gpu[name]
                if key == "fps":
                    kf, pf = (lambda x=xyz: fn_k(x)), (lambda x=xyz: fn_p(x))
                else:
                    c = centers[name]
                    kf = lambda x=xyz, c=c: bq_k(x, c, RADIUS, NS)
                    pf = lambda x=xyz, c=c: bq_p(x, c, RADIUS, NS)
                ms_k, ms_p = in_turns(kf, pf, rk, rp)
                per.append((ms_k, ms_p))
                print(f"[{card}] {key} {name} N={xyz.shape[1]}: kernel {ms_k:.4f} ms, "
                      f"plain {ms_p:.4f} ms")
            report[key]["ms"] = float(np.mean([p[0] for p in per]))
            report[key]["plain_ms"] = float(np.mean([p[1] for p in per]))
        ms_k, ms_p = in_turns(lambda: k3(weights_t, packed, cfg),
                              lambda: k3_plain(weights_t, packed, cfg), 10, 3)
        report["fused_describe"].update(ms=ms_k, plain_ms=ms_p)
        print(f"[{card}] fused_describe {BATCH} clusters: kernel {ms_k:.4f} ms "
              f"({BATCH / ms_k * 1e3:.0f} desc/s), plain {ms_p:.4f} ms")
        # server: host-packed requests in, descriptors on the host out
        server.describe_packed(packed_host)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REQUESTS):
            d, a = server.describe_packed(packed_host)
            d.cpu(), a.cpu()
        serve_s2 = time.perf_counter() - t0
        # one request split into its stages on the device timeline
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        x = torch.as_tensor(packed_host, device=dev)
        ev[1].record()
        d, a = server.describe_packed(x)
        ev[2].record()
        d.cpu(), a.cpu()
        ev[3].record()
        ev[3].synchronize()
        stages = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
        # the model forward on each cloud (FPS, ball query, towers)
        fwd = {}
        for name in CLOUDS:
            model(gpu[name])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(5):
                model(gpu[name])
            torch.cuda.synchronize()
            fwd[name] = (time.perf_counter() - t1) / 5 * 1e3
    print(f"[{card}] server: {REQUESTS} requests x {BATCH} clusters, "
          f"{REQUESTS * BATCH / serve_s2:.0f} descriptors/s end to end "
          f"(host packed array in, host results out; first run {REQUESTS * BATCH / serve_s:.0f})")
    print(f"[{card}] one request: host->device {stages[0]:.3f} ms, describe_packed "
          f"{stages[1]:.3f} ms, device->host {stages[2]:.3f} ms")
    for name, ms in fwd.items():
        print(f"[{card}] model forward {name} N={gpu[name].shape[1]}: {ms:.3f} ms "
              f"(host clock, synchronised)")

    meta = {
        "fps": ("feat3dnet_tpu_torch/csrc/fps.cu", "feat3dnet_tpu/ops/fps.py:103"),
        "ball_query": ("feat3dnet_tpu_torch/csrc/ball_query.cu",
                       "feat3dnet_tpu/ops/batch_group.py:51"),
        "fused_describe": ("feat3dnet_tpu_torch/csrc/fused_describe.cu",
                           "feat3dnet_tpu/ops/fused_describe.py:883"),
    }
    summary = [{"name": k, "route": "cuda", "source": meta[k][0], "replaces": meta[k][1],
                "launches": launches[k], "max_abs_err": report[k]["max_abs_err"],
                "ms": report[k]["ms"], "plain_ms": report[k]["plain_ms"]}
               for k in wrappers]
    print(f"card: {card}")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
