#!/usr/bin/env python3
"""Smoke run of the PyTorch port (feat3dnet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the six CUDA kernels from
feat3dnet_tpu_torch/csrc with nvcc (one process per source), then:
  1. holds K1-K3 against their plain PyTorch versions at the forward's
     shapes (FPS and ball query index-exact on the four vendored clouds
     and a synthetic masked case; the fused describe kernel on 7 680
     clusters within stated tolerances);
  2. drives the forward/serving path with launch counters reset:
     Feat3DNet eval at the paper config (seeded weights, perturbed BN
     statistics) on each vendored cloud, then 8 ClusterDescriptorServer
     requests of 7 680 packed clusters; every kernel must have launched;
  3. checks those outputs (shapes, unit norms, agreement with the model
     on the CPU and with the model path on the card);
  4. times K1-K3 against their plain versions (CUDA events, in turns)
     and the server's descriptors/s;
  5. holds K4 (sorted ball query) and K5 (ball max) index-exact and K6
     (detector-only tower) within 1e-5 against their plain versions at the
     extraction shapes: the vendored clouds at their buckets and a seeded
     200 000-point synthetic cloud (plain versions on 8 192 of its
     centres), with the trained weights (assets/ckpt4480_variables.npz);
  6. drives the extraction path with launch counters reset:
     InferencePipeline.extract on the five clouds, default route and
     use_fused_detector, then process_directory over examples/data; K3-K6
     must have launched;
  7. checks the extraction: the hashed route equals the dense route in
     keypoints (features within 1e-4, attention 1e-5); the fused route
     keeps >= 99 % of the keypoints, >= 99 % of the shared ones with
     features within 1e-4 and all at cosine >= 0.9999 (K3's folded BN
     rounds differently from the model tower); every written file is
     (K, 35) float32 rows;
  8. times K4-K6 against their plain versions and the extract latency of
     both routes per cloud (host Morton sort separately), and profiles
     one extract of each of the two largest clouds per route.
It writes only under build/ in the checkout.
The line before last is a JSON summary of the six kernels; the last line
is {"ok": true, "device": {...}}. Any failure raises (non-zero exit). It
needs a CUDA device and refuses to run without one.
"""
import itertools
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
NMS_RADIUS = 0.5      # InferenceConfig().nms_radius
SYN_POINTS = 200_000  # the synthetic cloud above 131 072 points
SYN_SLICE = 8192      # sorted centres of it that the plain versions check
FULL_CHECK = 32768    # buckets up to this size: plain versions on every centre
BATCH = 7680          # clusters per serving request (2 048 distinct, tiled)
REQUESTS = 8
SEED = 0


def require(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, reps):
    """Mean ms per call of `fn` over `reps` back-to-back calls (CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(kernel_fn, plain_fn, reps_k, reps_p):
    """(kernel ms, plain ms), warmed up, timed plain, kernel, kernel, plain."""
    import torch

    kernel_fn()
    plain_fn()
    torch.cuda.synchronize()
    p1 = cuda_ms(plain_fn, reps_p)
    k1 = cuda_ms(kernel_fn, reps_k)
    k2 = cuda_ms(kernel_fn, reps_k)
    p2 = cuda_ms(plain_fn, reps_p)
    return (k1 + k2) / 2, (p1 + p2) / 2


def synthetic_cloud(seed, n=SYN_POINTS):
    """n points uniform in a 160 m x 160 m x 8 m box (about 33 per 2 m ball)."""
    rs = np.random.RandomState(seed)
    box = np.array([160.0, 160.0, 8.0])
    return (rs.rand(n, 3) * box - box / 2).astype(np.float32)


def _wrapped(d):
    import torch

    return torch.remainder(d + np.pi, 2 * np.pi) - np.pi


def extraction_phases(dev, card, clouds, npz_path, data_dir, out_dir):
    """Phases 5-8: K4/K5/K6 against their plain versions at the extraction
    shapes, InferencePipeline.extract with the trained weights (launch
    counters reset), its outputs against the dense route and across the
    two routes, then times. `clouds` maps names to (N, >=3) host arrays;
    process_directory writes into `out_dir` (emptied first). Returns
    {kernel: report} for K4, K5, K6 and the extraction path's launches."""
    import shutil

    import torch

    from feat3dnet_tpu_torch.config import InferenceConfig, ModelConfig, bucket_for
    from feat3dnet_tpu_torch.inference import InferencePipeline
    from feat3dnet_tpu_torch.models import Feat3DNet
    from feat3dnet_tpu_torch.ops import batch_group, fps
    from feat3dnet_tpu_torch.ops import fused_describe as fd
    from feat3dnet_tpu_torch.ops import hash_grid as hg
    from feat3dnet_tpu_torch.utils import load_variables, load_variables_npz

    cfg = ModelConfig()
    variables = load_variables_npz(npz_path)
    model = load_variables(Feat3DNet(cfg), variables).eval().to(dev)
    w_det = [w.to(dev) for w in fd.transpose_unfolded_detector(
        fd.detector_weights_unfolded(variables, cfg))]
    report = {"sorted_ball_query": {"max_abs_err": 0}, "ball_max": {"max_abs_err": 0},
              "fused_detect": {"max_abs_err": 0.0}}
    times = {k: [] for k in report}

    # ---- 5. K4, K5, K6 against their plain versions at the extraction shapes
    with torch.no_grad():
        for name, cloud in clouds.items():
            n = cloud.shape[0]
            nb = bucket_for(n)
            padded = np.zeros((nb, 3), np.float32)
            padded[:n] = cloud[:, :3]
            valid = np.arange(nb) < n
            sc = hg.build_sorted_cloud_host(padded, valid, cell_size=RADIUS,
                                            block_size=256).to(dev)
            ctr = sc.pts4[:, :3]
            # the plain versions on every centre, or on a contiguous slice of
            # SYN_SLICE sorted centres of the largest cloud
            sl = slice(0, nb) if nb <= FULL_CHECK else slice(nb // 4, nb // 4 + SYN_SLICE)
            ctr_sl = ctr[sl].contiguous()
            top_k, cnt_k = hg.sorted_ball_query(sc.pts4, sc.blk_bbox, ctr, RADIUS, NS, tile=256)
            top_p, cnt_p = hg.sorted_ball_query_plain(sc.pts4, ctr_sl, RADIUS, NS)
            require(torch.equal(top_k[sl], top_p) and torch.equal(cnt_k[sl], cnt_p),
                    f"sorted ball query kernel != plain on {name}")
            grouped, _, cnt = hg._finish_grouped(top_k, cnt_k, ctr, NS)
            offs = (grouped - ctr[:, None, :]).contiguous()
            att_k, ori_k = fd.fused_detect_clusters(w_det, offs, cfg)
            att_p, ori_p = fd.fused_detect_clusters_plain(w_det, offs[sl], cfg)
            a_err = (att_k[sl] - att_p).abs()
            a_rel = (a_err / att_p.abs().clamp(min=1e-6)).max().item()
            o_err = _wrapped(ori_k[sl] - ori_p).abs().max().item()
            require(a_rel <= 1e-5 and o_err <= 1e-5,
                    f"fused detect kernel outside tolerance on {name}: att rel {a_rel:.3e}, "
                    f"ori {o_err:.3e} rad")
            report["fused_detect"]["max_abs_err"] = max(report["fused_detect"]["max_abs_err"],
                                                        a_err.max().item())
            bm_k = hg.ball_max_sorted(sc.pts4, sc.blk_bbox, att_k, NMS_RADIUS)
            bm_p = hg.ball_max_plain(sc.pts4, att_k, NMS_RADIUS, centers=ctr_sl)
            require(torch.equal(bm_k[sl], bm_p), f"ball max kernel != plain on {name}")
            real = ctr[:, 0] < 5e8
            sat = (cnt_k[real] > NS).float().mean().item()
            print(f"K4/K5/K6 {name} N={n} bucket {nb} (plain on {sl.stop - sl.start} centres): "
                  f"K4 top/cnt exact, mean in-ball {cnt_k[real].float().mean().item():.1f}, "
                  f"{100 * sat:.1f} % saturated; K6 att rel {a_rel:.3e} (<= 1e-5), ori "
                  f"{o_err:.3e} rad (<= 1e-5); K5 ball max exact, "
                  f"{(att_k[real] >= bm_k[real]).sum().item()} local maxima")
            if nb <= FULL_CHECK:      # times at the vendored clouds' shapes
                pairs = (
                    ("sorted_ball_query",
                     lambda: hg.sorted_ball_query(sc.pts4, sc.blk_bbox, ctr, RADIUS, NS, tile=256),
                     lambda: hg.sorted_ball_query_plain(sc.pts4, ctr, RADIUS, NS), 5, 1),
                    ("fused_detect", lambda: fd.fused_detect_clusters(w_det, offs, cfg),
                     lambda: fd.fused_detect_clusters_plain(w_det, offs, cfg), 3, 2),
                    ("ball_max", lambda: hg.ball_max_sorted(sc.pts4, sc.blk_bbox, att_k, NMS_RADIUS),
                     lambda: hg.ball_max_plain(sc.pts4, att_k, NMS_RADIUS), 10, 2))
                for key, kf, pf, rk, rp in pairs:
                    ms_k, ms_p = in_turns(kf, pf, rk, rp)
                    times[key].append((ms_k, ms_p))
                    print(f"[{card}] {key} {name} bucket {nb}: kernel {ms_k:.4f} ms, "
                          f"plain {ms_p:.4f} ms")
            del sc, top_k, top_p, grouped, offs
    for key, per in times.items():
        report[key]["ms"] = float(np.mean([p[0] for p in per]))
        report[key]["plain_ms"] = float(np.mean([p[1] for p in per]))

    # ---- 6. the extraction path, trained weights, counters from zero --------
    pipes = {"default": InferencePipeline(model, None, cfg, InferenceConfig(), device=dev),
             "fused": InferencePipeline(model, None, cfg,
                                        InferenceConfig(use_fused_detector=True), device=dev)}
    wrappers = {"fps": fps.farthest_point_sample, "ball_query": batch_group.ball_query_fused,
                "fused_describe": fd.fused_describe_clusters_t,
                "sorted_ball_query": hg.sorted_ball_query, "ball_max": hg.ball_max_sorted,
                "fused_detect": fd.fused_detect_clusters}
    for w in wrappers.values():
        w.launches = 0
    results = {route: {} for route in pipes}
    shutil.rmtree(out_dir, ignore_errors=True)
    for route, pipe in pipes.items():
        for name, cloud in clouds.items():
            results[route][name] = pipe.extract(cloud)
    n_files = pipes["default"].process_directory(data_dir, out_dir, log=lambda *_: None)
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"extraction path launches: {launches}")
    for k in ("sorted_ball_query", "ball_max", "fused_detect", "fused_describe"):
        require(launches[k] > 0, f"kernel {k} was not launched on the extraction path")

    # ---- 7. outputs: hashed == dense, fused ~ default, files ----------------
    dense = InferencePipeline(model, None, cfg, InferenceConfig(use_hashed_grouping=False),
                              device=dev)
    dense_ms = {}
    for name, cloud in clouds.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rd = dense.extract(cloud)
        dense_ms[name] = (time.perf_counter() - t0) * 1e3
        rh, rf = results["default"][name], results["fused"][name]
        require(rh.num_keypoints == rd.num_keypoints and np.array_equal(rh.keypoints, rd.keypoints),
                f"hashed extract keypoints != dense on {name}")
        f_err = float(np.abs(rh.features - rd.features).max())
        a_rel = float((np.abs(rh.attention - rd.attention)
                       / np.maximum(np.abs(rd.attention), 1e-6)).max())
        require(f_err <= 1e-4 and a_rel <= 1e-5,
                f"hashed extract outputs != dense on {name}: {f_err:.3e}, {a_rel:.3e}")
        require(np.isfinite(rh.features).all() and rh.features.shape == (rh.num_keypoints, 32),
                f"extract output shape on {name}")
        kd = {r.tobytes(): i for i, r in enumerate(rh.keypoints)}
        shared = [(kd[r.tobytes()], j) for j, r in enumerate(rf.keypoints) if r.tobytes() in kd]
        overlap = len(shared) / max(rh.num_keypoints, rf.num_keypoints, 1)
        # the fused route's descriptors come from K3, whose BN is folded into
        # the weights: they round differently from the model tower (the
        # serving envelope), so a rare cluster lands past 1e-4
        fa = rh.features[[i for i, _ in shared]]
        fb = rf.features[[j for _, j in shared]]
        dmax = np.abs(fa - fb).max(axis=1)
        cos = (fa * fb).sum(1) / np.linalg.norm(fa, axis=1) / np.linalg.norm(fb, axis=1)
        within = float((dmax <= 1e-4).mean())
        print(f"extract {name}: hashed == dense ({rh.num_keypoints} keypoints, features "
              f"max|d| {f_err:.3e}, attention rel {a_rel:.3e}); fused route {rf.num_keypoints} "
              f"keypoints, overlap {len(shared)}/{max(rh.num_keypoints, rf.num_keypoints)} = "
              f"{100 * overlap:.2f} % (>= 99 %); shared features max|d| {dmax.max():.3e}, "
              f"{100 * within:.2f} % within 1e-4 (>= 99 %), min cos {cos.min():.7f} (>= 0.9999)")
        require(overlap >= 0.99 and within >= 0.99 and cos.min() >= 0.9999,
                f"fused route disagrees on {name}")
    written = sorted(os.listdir(out_dir))
    require(len(written) == n_files == 4, f"process_directory wrote {written}")
    for fname in written:
        rows = np.fromfile(os.path.join(out_dir, fname), np.float32)
        require(rows.size % 35 == 0 and rows.size > 0, f"{fname}: not (K, 35) float32 rows")
        want = results["default"].get(fname)
        if want is not None:
            require(np.array_equal(rows.reshape(-1, 35),
                                   np.concatenate([want.keypoints, want.features], 1)),
                    f"{fname}: written rows differ from extract")
    print(f"process_directory: {n_files} files of (K, 35) float32 rows, equal to extract")

    # ---- 8. times: extract latency per cloud, both routes, in turns ---------
    for name, cloud in clouds.items():
        ms = {route: [] for route in pipes}
        sort_ms = []
        for route in ("default", "fused", "fused", "default"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = pipes[route].extract(cloud)
            ms[route].append((time.perf_counter() - t0) * 1e3)
            sort_ms.append(pipes[route].timings["host_sort_s"] * 1e3)
        print(f"[{card}] extract {name} N={cloud.shape[0]}: default {np.mean(ms['default']):.2f} ms, "
              f"fused {np.mean(ms['fused']):.2f} ms, dense route {dense_ms[name]:.2f} ms "
              f"(host clock, synchronised); host Morton sort {np.mean(sort_ms):.2f} ms of it; "
              f"{res.num_keypoints} keypoints")
    # where the device time goes in one extract of the two largest clouds
    for name, route in itertools.product(
            sorted(clouds, key=lambda k: clouds[k].shape[0])[-2:], pipes):
        pipe = pipes[route]
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pipe.extract(clouds[name])
            wall = (time.perf_counter() - t0) * 1e3
        # the device-side entries are the kernels themselves
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        ev.sort(key=lambda e: e.self_device_time_total, reverse=True)
        dev_ms = sum(e.self_device_time_total for e in ev) / 1e3
        print(f"[{card}] profile extract {name} ({route}): wall {wall:.2f} ms, device busy "
              f"{dev_ms:.2f} ms ({100 * dev_ms / wall:.1f} %)")
        for e in ev[:8]:
            print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:90]}")
    return report, launches


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

    # ---- 5-8. whole-cloud extraction, trained weights ----------------------------
    ext_clouds = {n: load_point_cloud(example_cloud_path(n)) for n in CLOUDS}
    ext_clouds["synthetic_200k"] = synthetic_cloud(SEED)
    ext_report, ext_launches = extraction_phases(
        dev, card, ext_clouds,
        os.path.join(HERE, "feat3dnet_tpu_torch", "assets", "ckpt4480_variables.npz"),
        os.path.dirname(example_cloud_path(CLOUDS[0])),
        os.path.join(HERE, "build", "chip_smoke_extract"))
    report.update(ext_report)
    # K1-K3 count on the forward/serving path, K4-K6 on the extraction path
    launches.update({k: ext_launches[k] for k in ext_report})

    meta = {
        "fps": ("feat3dnet_tpu_torch/csrc/fps.cu", "feat3dnet_tpu/ops/fps.py:103"),
        "ball_query": ("feat3dnet_tpu_torch/csrc/ball_query.cu",
                       "feat3dnet_tpu/ops/batch_group.py:51"),
        "fused_describe": ("feat3dnet_tpu_torch/csrc/fused_describe.cu",
                           "feat3dnet_tpu/ops/fused_describe.py:883"),
        "sorted_ball_query": ("feat3dnet_tpu_torch/csrc/sorted_ball_query.cu",
                              "feat3dnet_tpu/ops/hash_grid.py:787"),
        "ball_max": ("feat3dnet_tpu_torch/csrc/ball_max.cu",
                     "feat3dnet_tpu/ops/hash_grid.py:1139"),
        "fused_detect": ("feat3dnet_tpu_torch/csrc/fused_detect.cu",
                         "feat3dnet_tpu/ops/fused_describe.py:1286"),
    }
    summary = [{"name": k, "route": "cuda", "source": meta[k][0], "replaces": meta[k][1],
                "launches": launches[k], "max_abs_err": report[k]["max_abs_err"],
                "ms": report[k]["ms"], "plain_ms": report[k]["plain_ms"]}
               for k in meta]
    print(f"card: {card}")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
