"""Where residual_dtype's gradients differ between the card and the CPU, on
the card, at the paper config (18 x 4 096 points, 512 x 64, r 2 m):

    python3 scripts/residual_card_vs_cpu.py

One training forward and backward (chip_smoke.model_grads; float64 through
chip_smoke.f64_grads) from seeded weights on one seeded training batch:
plain and residual_dtype=bfloat16 on the card and on the CPU. It prints,
for each pair, the four leaves of lowest gradient cosine, the analytic
zeros' largest |difference| and |gradient| (the conv biases under BN, the
last mid conv's beta) and the largest |gradient|; then the CPU's residual
step at 3 threads against 8, and whether the card's residual step equals
the same squash points without residual_saving's packing bit for bit.
Needs a CUDA device; TF32 off.
"""
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from feat3dnet_tpu_torch.config import ModelConfig  # noqa: E402
from feat3dnet_tpu_torch.models import Feat3DNet  # noqa: E402
from feat3dnet_tpu_torch.models import feat3dnet as model_module  # noqa: E402
from feat3dnet_tpu_torch.utils import init_variables, load_variables  # noqa: E402


def grads(cfg, variables, device, clouds, tag, f64=False):
    t = time.time()
    m = load_variables(Feat3DNet(cfg), variables).to(device)
    if f64:
        return cs.f64_grads(m, clouds.to(device), cfg.margin)
    loss, g, _ = cs.model_grads(m, clouds.to(device), cfg.margin)
    print(f"  {tag}: loss {loss:.7f} ({time.time() - t:.1f} s)", flush=True)
    return g


def compare(tag, a, b):
    zeros = ({k for k in a if k.endswith("conv2d.bias") and ".conv" in k}
             | {"description.conv_mid_0.bn.bias"})
    cos = {k: torch.nn.functional.cosine_similarity(a[k].flatten().double(),
                                                    b[k].flatten().double(), dim=0).item()
           for k in a if k not in zeros}
    worst = sorted(cos, key=cos.get)[:4]
    zd = max((a[k] - b[k]).abs().max().item() for k in zeros)
    za = max(max(a[k].abs().max().item(), b[k].abs().max().item()) for k in zeros)
    top = max(v.abs().max().item() for v in b.values())
    print(f"{tag}: worst cos " + ", ".join(f"{k} {cos[k]:.6f}" for k in worst)
          + f"; zeros max|d| {zd:.2e} max|g| {za:.2e}; top |g| {top:.3e}", flush=True)


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("residual_card_vs_cpu: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    variables = init_variables(ModelConfig(), seed=0)
    clouds = cs.training_batch(dev, 300)
    resid, plain = ModelConfig(residual_dtype=torch.bfloat16), ModelConfig()
    g64 = grads(plain, variables, dev, clouds, "f64", f64=True)
    gcp = grads(plain, variables, dev, clouds, "card plain")
    gcr = grads(resid, variables, dev, clouds, "card residual")
    ghp = grads(plain, variables, "cpu", clouds.cpu(), "cpu plain")
    ghr = grads(resid, variables, "cpu", clouds.cpu(), "cpu residual")
    compare("card plain vs f64", gcp, g64)
    compare("cpu plain vs f64", ghp, g64)
    compare("card plain vs cpu plain", gcp, ghp)
    compare("card residual vs cpu residual", gcr, ghr)
    compare("card residual vs card plain", gcr, gcp)
    compare("cpu residual vs cpu plain", ghr, ghp)
    compare("card residual vs f64", gcr, g64)
    compare("cpu residual vs f64", ghr, g64)
    # the CPU's residual step under another thread count (another summation order)
    torch.set_num_threads(3)
    ghr3 = grads(resid, variables, "cpu", clouds.cpu(), "cpu residual 3 threads")
    compare("cpu residual (3 threads) vs cpu residual", ghr3, ghr)
    torch.set_num_threads(8)
    # the same squash points without the packing must be bit-equal
    packed = model_module._maybe_remat
    model_module._maybe_remat = lambda per_point, cfg, training: per_point
    try:
        unpacked = grads(resid, variables, dev, clouds, "card residual unpacked")
    finally:
        model_module._maybe_remat = packed
    print("card residual packed == unpacked:",
          all(torch.equal(gcr[k], unpacked[k]) for k in gcr))


if __name__ == "__main__":
    main()
