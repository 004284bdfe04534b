"""Data and point parallelism across the cards of one host.

    python3 scripts/parallel_cards.py                         # every visible card
    python3 scripts/parallel_cards.py --device cpu --ranks 4  # CPU rehearsal, tiny shapes

On N cards (N >= 2; nccl ranks on cuda:0 .. cuda:N-1, spawned by
parallel/data_parallel.run_ranks):
  a. one data-parallel fused training step (paper config, f32 cotangents,
     seeded weights, TrainConfig() points) over N ranks of 2 triplets
     each, against one process on the combined batch of 2N triplets on
     cuda:0: the loss within 1e-5 relative, every gradient leaf at cosine
     >= 0.999 (the analytically zero leaves |g| <= 1e-3), K7-K10 launched
     on every rank;
  b. the DP step's median ms (10 synchronised steps after 2, augmented)
     at 6 triplets a rank (6N combined) against one card's step at 6
     triplets, and the triplets/s of each;
  c. InferencePipeline(mesh=make_mesh(N)) extract with the trained
     weights on the two vendored KITTI clouds, default, fused and dense
     routes: bit-equal to one card's extract (keypoints, attention,
     features), ms a cloud of each in turns (one card, mesh, mesh, one
     card; 5 extracts a turn);
  d. InferencePipeline(cloud_mesh=make_mesh(N)) extract_many(batch_size=4)
     on 16 KITTI frames (the two clouds in turn), both hashed routes:
     bit-equal per cloud to one card's extract, clouds/s against one
     card's extract_many(batch_size=4), in turns.
Every time is printed beside the card's name and power limit (nvidia-smi).
With --device cpu the same code runs on gloo CPU ranks and a mesh of CPU
devices at tiny shapes (a rehearsal of the control flow; its times mean
nothing and no kernel launches). Exits non-zero on any failed check.
"""
import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(num_clusters=32, num_samples=16, detector_mlp=(16, 32), detector_mlp2=(16,),
            descriptor_mlp=(16, 16))


def _configs(cpu):
    import torch

    from feat3dnet_tpu_torch.config import InferenceConfig, ModelConfig, TrainConfig

    mkw = TINY if cpu else {}
    tcfg = TrainConfig(num_points=512) if cpu else TrainConfig()
    icfg = dict(max_keypoints=64, keypoint_chunk=1024) if cpu else {}
    return (ModelConfig(**mkw, fused_towers=True, fused_cot_dtype=torch.float32), tcfg,
            ModelConfig(**mkw), lambda **kw: InferenceConfig(**icfg, **kw))


def _batch(dev, n_clouds, num_points, seed):
    import torch

    from feat3dnet_tpu_torch.data.datagenerator import crop_and_resample
    from feat3dnet_tpu_torch.data.io import example_cloud_path, load_point_cloud

    names = ("oxford_270.bin", "oxford_456.bin", "kitti_00_001554.bin", "kitti_00_004534.bin")
    raw = [load_point_cloud(example_cloud_path(n)) for n in names]
    out = [crop_and_resample(raw[i % 4], num_points, np.random.RandomState(seed + i))[:, :3]
           for i in range(n_clouds)]
    return torch.from_numpy(np.ascontiguousarray(np.stack(out), np.float32)).to(dev)


def _step_ms(step, state, clouds, sync):
    for _ in range(2):
        step(state, clouds)
    per = []
    for _ in range(10):
        sync()
        t0 = time.perf_counter()
        step(state, clouds)
        sync()
        per.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(per)


def dp_rank(rank, world, group, dev, cpu, stacked_eq, stacked_big):
    """One rank: a's DP step on its share of the 2N-triplet batch (grads,
    loss, K7-K10 launches), then b's timing at 6 triplets a rank."""
    import torch

    from feat3dnet_tpu_torch.data.augment import resolve_augmentations
    from feat3dnet_tpu_torch.models import Feat3DNet
    from feat3dnet_tpu_torch.ops import fused_train as tft
    from feat3dnet_tpu_torch.parallel import make_fused_dp_train_step, shard_batch
    from feat3dnet_tpu_torch.train import init_state
    from feat3dnet_tpu_torch.utils import init_variables

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, tcfg, _, _ = _configs(cpu)
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    wrappers = (tft.stats_pass, tft.final_pass, tft.bwd_top_pass, tft.bwd_pass)
    model = Feat3DNet(cfg, bn_group=group)
    state = init_state(model, tcfg, cfg, variables=init_variables(cfg, seed=0), device=dev)
    step = make_fused_dp_train_step(model, cfg.margin, cfg.attention, group)
    for w in wrappers:
        w.launches = 0
    _, metrics = step(state, shard_batch(torch.from_numpy(stacked_eq).to(dev), rank, world))
    out = {"loss": metrics["loss"].item(), "launches": [w.launches for w in wrappers],
           "grads": {k: p.grad.detach().cpu() for k, p in model.named_parameters()}}
    aug = tuple(resolve_augmentations(tcfg.augmentations, tcfg.upright_axis))
    model = Feat3DNet(cfg, bn_group=group)
    state = init_state(model, tcfg, cfg, variables=init_variables(cfg, seed=0), device=dev)
    step = make_fused_dp_train_step(model, cfg.margin, cfg.attention, group,
                                    augmentations=aug, aug_seed=1)
    out["ms"] = _step_ms(step, state,
                         shard_batch(torch.from_numpy(stacked_big).to(dev), rank, world), sync)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks / mesh devices (default: every visible card)")
    opts = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    from feat3dnet_tpu_torch import kernels
    from feat3dnet_tpu_torch.data.augment import resolve_augmentations
    from feat3dnet_tpu_torch.data.io import example_cloud_path, load_point_cloud
    from feat3dnet_tpu_torch.inference import InferencePipeline
    from feat3dnet_tpu_torch.models import Feat3DNet
    from feat3dnet_tpu_torch.ops import batch_group, fused_describe, hash_grid
    from feat3dnet_tpu_torch.parallel import make_mesh, run_ranks, shard_batch
    from feat3dnet_tpu_torch.train import init_state, make_fused_train_step
    from feat3dnet_tpu_torch.utils import init_variables, load_variables_npz

    cpu = opts.device == "cpu"
    if cpu:
        n, card, sync = opts.ranks or 4, "CPU rehearsal", (lambda: None)
        dev, mesh, backend, devices = torch.device("cpu"), make_mesh(opts.ranks or 4, "cpu"), \
            "gloo", None
        torch.set_num_threads(2)
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("parallel_cards: no CUDA device")
        mesh = make_mesh(opts.ranks)
        n = len(mesh)
        if n < 2:
            raise RuntimeError(f"parallel_cards: needs 2 or more cards, found {n}")
        dev, backend, devices, sync = mesh[0], "nccl", [str(d) for d in mesh], \
            torch.cuda.synchronize
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader", "-i", "0"],
                              capture_output=True, text=True, check=True).stdout.strip()
        kernels.build()
        kernels.library()
        print(f"{torch.cuda.device_count()} cards; torch {torch.__version__} cuda "
              f"{torch.version.cuda}", flush=True)
    print(f"card: {card}; {n} ranks / mesh devices", flush=True)
    fcfg, tcfg, cfg, icfg = _configs(cpu)
    failed = []

    def check(ok, what):
        if not ok:
            failed.append(what)
            print(f"FAILED: {what}", flush=True)

    # ---- a and b: the DP step over N ranks -----------------------------------------
    t0 = time.perf_counter()
    stacked_eq = _batch("cpu", 3 * 2 * n, tcfg.num_points, 100).numpy()
    stacked_big = _batch("cpu", 3 * 6 * n, tcfg.num_points, 300).numpy()
    store = os.path.join(HERE, "build", f"parallel_cards_{os.getpid()}")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    ranks = run_ranks(dp_rank, n, backend, devices, init_file=store,
                      args=(cpu, stacked_eq, stacked_big), timeout=1200,
                      collective_timeout=300, threads=2 if cpu else None)
    model = Feat3DNet(fcfg)
    state = init_state(model, tcfg, fcfg, variables=init_variables(fcfg, seed=0), device=dev)
    _, met = make_fused_train_step(model, fcfg.margin, fcfg.attention)(
        state, torch.from_numpy(stacked_eq).to(dev))
    loss = met["loss"].item()
    want = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    top = max(g.abs().max().item() for g in want.values())
    noise = {k for k, g in want.items() if g.abs().max().item() <= 1e-4 * top}
    for r, res in enumerate(ranks):
        cos = {k: torch.nn.functional.cosine_similarity(res["grads"][k].flatten(),
                                                        w.flatten(), dim=0).item()
               for k, w in want.items() if k not in noise}
        worst = min(cos, key=cos.get)
        noise_max = max((res["grads"][k].abs().max().item() for k in noise), default=0.0)
        check(abs(res["loss"] - loss) <= 1e-5 * abs(loss), f"a rank {r}: loss {res['loss']}")
        check(cos[worst] >= 0.999 and noise_max <= 1e-3,
              f"a rank {r}: cosine {cos[worst]} on {worst}, noise {noise_max}")
        check(cpu or min(res["launches"]) > 0, f"a rank {r}: K7-K10 {res['launches']}")
        print(f"a rank {r}: loss {res['loss']:.7f} (one card {loss:.7f}), worst cosine "
              f"{cos[worst]:.7f} on {worst}, noise max {noise_max:.2e}, K7-K10 launches "
              f"{res['launches']}", flush=True)
    aug = tuple(resolve_augmentations(tcfg.augmentations, tcfg.upright_axis))
    model = Feat3DNet(fcfg)
    state = init_state(model, tcfg, fcfg, variables=init_variables(fcfg, seed=0), device=dev)
    # one card on rank 0's 6 triplets
    one_ms = _step_ms(make_fused_train_step(model, fcfg.margin, fcfg.attention,
                                            augmentations=aug, aug_seed=1), state,
                      torch.from_numpy(shard_batch(stacked_big, 0, n)).to(dev), sync)
    dp_ms = max(res["ms"] for res in ranks)
    print(f"[{card}] b: fused step at 6 triplets: one card {one_ms:.2f} ms ({6e3 / one_ms:.1f} "
          f"triplets/s); {n} ranks at 6 each (DP, {6 * n} combined) "
          f"{[round(res['ms'], 2) for res in ranks]} ms ({6e3 * n / dp_ms:.1f} triplets/s, "
          f"{one_ms * n / dp_ms:.2f}x); wall {time.perf_counter() - t0:.1f} s", flush=True)
    del model, state

    # ---- c and d: extraction on the mesh ----------------------------------------------
    t0 = time.perf_counter()
    npz = os.path.join(HERE, "feat3dnet_tpu_torch", "assets", "ckpt4480_variables.npz")
    variables = init_variables(cfg, seed=1) if cpu else load_variables_npz(npz)
    kitti = [load_point_cloud(example_cloud_path(f)) for f in ("kitti_00_001554.bin",
                                                                "kitti_00_004534.bin")]
    if cpu:
        kitti = [c[:3000] for c in kitti]
    counted = {"K2": batch_group.ball_query_fused, "K4": hash_grid.sorted_ball_query,
               "K5": hash_grid.ball_max_sorted, "K6": fused_describe.fused_detect_clusters,
               "K3": fused_describe.fused_describe_clusters_t}
    need = {"default": ("K4", "K5"), "fused": ("K4", "K5", "K6", "K3"), "dense": ("K2",)}

    def same(got, want_):
        return all(g.num_keypoints == w.num_keypoints and all(
            np.array_equal(getattr(g, f), getattr(w, f))
            for f in ("keypoints", "attention", "features")) for g, w in zip(got, want_))

    for route, kw in (("default", {}), ("fused", dict(use_fused_detector=True)),
                      ("dense", dict(use_hashed_grouping=False))):
        one = InferencePipeline(Feat3DNet(cfg), variables, cfg, icfg(**kw), device=dev)
        meshed = InferencePipeline(Feat3DNet(cfg), variables, cfg, icfg(**kw), mesh=mesh)
        want = [one.extract(c) for c in kitti]
        for w in counted.values():
            w.launches = 0
        got = [meshed.extract(c) for c in kitti]
        launched = {k: w.launches for k, w in counted.items()}
        check(same(got, want), f"c {route}: the mesh extract differs from extract")
        check(cpu or all(launched[k] > 0 for k in need[route]), f"c {route}: {launched}")
        ms = {"one": [], "mesh": []}
        for who in ("one", "mesh", "mesh", "one"):
            pipe = one if who == "one" else meshed
            sync()
            t1 = time.perf_counter()
            for _ in range(5):
                for c in kitti:
                    pipe.extract(c)
            sync()
            ms[who].append((time.perf_counter() - t1) * 1e3 / (5 * len(kitti)))
        print(f"[{card}] c {route}: mesh of {n} bit-equal to one card "
              f"({[g.num_keypoints for g in got]} keypoints; launches {launched}); "
              f"{np.mean(ms['mesh']):.2f} ms a cloud against one card's "
              f"{np.mean(ms['one']):.2f} (turns {[round(x, 2) for x in ms['one'] + ms['mesh']]})",
              flush=True)
        if route == "dense":
            continue
        stream = kitti * 8
        cm = InferencePipeline(Feat3DNet(cfg), variables, cfg, icfg(**kw), cloud_mesh=mesh)
        check(same(cm.extract_many(stream, batch_size=4), want * 8),
              f"d {route}: cloud_mesh extract_many differs from extract")
        rate = {"one": [], "mesh": []}
        for who in ("one", "mesh", "mesh", "one"):
            pipe = one if who == "one" else cm
            sync()
            t1 = time.perf_counter()
            pipe.extract_many(stream, batch_size=4)
            sync()
            rate[who].append(len(stream) / (time.perf_counter() - t1))
        print(f"[{card}] d {route}: cloud_mesh of {n} extract_many(batch_size=4) on "
              f"{len(stream)} KITTI frames bit-equal per cloud; {np.mean(rate['mesh']):.1f} "
              f"clouds/s against one card's {np.mean(rate['one']):.1f} (turns "
              f"{[round(x, 1) for x in rate['one'] + rate['mesh']]})", flush=True)
    print(f"[{card}] c, d wall {time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        raise SystemExit(f"parallel_cards: {len(failed)} checks failed: {failed}")
    print("parallel_cards: ok")


if __name__ == "__main__":
    main()
