"""Do two identical train steps on the card end on the same bits, and what
does it cost? Phase 6b's recipe (B = 8 at 352 x 480, two padded rows,
random weights from seed 0) for the `train` and `mosa_2` nets: two runs
of 3 Adam steps from the same weights, with the bilinear x2 backward of
F.interpolate (atomicAdd) or of ops/pooling.py (a fixed order), and with
cuDNN's default or deterministic algorithms. Prints, for each of the
four, how many leaves the two runs end equal on, the largest leaf
difference over that leaf's max, and each step's host ms.

    python3 -m mst_tpu_torch.probes.determinism    # one CUDA card
"""

import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from mst_tpu_torch import io, resolve_device
from mst_tpu_torch.config import get_params, step_config, ynet_config
from mst_tpu_torch.models import ynet
from mst_tpu_torch.ops import pooling
from mst_tpu_torch.train.steps import make_train_step
from mst_tpu_torch.train.trainer import setup_training

H, W, B, STEPS = 352, 480, 8, 3


def interpolate_backward(x):
    """The upsample with F.interpolate's own (atomicAdd) backward."""
    return pooling._nhwc(F.interpolate(pooling._nchw(x), scale_factor=2,
                                       mode="bilinear", align_corners=False))


def batch_for(params):
    """bench.py's input draws (bench.py:47-55), as chip_smoke's phase 6b."""
    rng = np.random.default_rng(0)
    sem = rng.normal(size=(1, H, W, params["n_semantic_classes"]))
    total = params["obs_len"] + params["pred_len"]
    traj = rng.uniform(0.2 * min(H, W), 0.6 * min(H, W), size=(B, total, 2))
    mask = np.ones(B)
    mask[-2:] = 0.0
    return {k: torch.tensor(v, dtype=torch.float32, device="cuda")
            for k, v in (("semantic", sem), ("traj", traj), ("mask", mask))}


def run(params, batch):
    """STEPS steps from seed 0's weights -> (the leaves, host ms a step)."""
    mcfg = ynet_config(params)
    weights, state = ynet.init_ynet(torch.Generator().manual_seed(0), mcfg,
                                    "cuda")
    setup = setup_training(weights, params, steps_per_epoch=1)
    step = make_train_step(mcfg, step_config(params))
    ms = []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(weights, state, setup["optimizer"],
                        batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {k: v.detach().clone() for k, v in
            io.flatten(weights).items()}, ms


def main():
    if not torch.cuda.is_available():
        print("determinism: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip())
    resolve_device("cuda")
    fixed = ynet.upsample_bilinear_2x
    try:
        for net in ("train", "mosa_2"):
            params = get_params("sdd_shortterm_train.yaml", dict(
                train_net=net, position=["0", "1", "2", "3", "4"],
                lr=1e-4))
            batch = batch_for(params)
            for backward, up in (("F.interpolate", interpolate_backward),
                                 ("fixed order", fixed)):
                ynet.upsample_bilinear_2x = up
                for det in (False, True):
                    torch.backends.cudnn.deterministic = det
                    (a, ms_a), (b, ms_b) = run(params, batch), run(params,
                                                                   batch)
                    equal = sum(torch.equal(a[k], b[k]) for k in a)
                    diff = max(float((a[k] - b[k]).abs().max())
                               / max(float(a[k].abs().max()), 1e-30)
                               for k in a)
                    print(f"{net}, bilinear backward {backward}, "
                          f"cudnn.deterministic {det}: {equal}/{len(a)} "
                          f"leaves equal, largest difference {diff:.3e} of "
                          f"a leaf's max; step ms "
                          f"{[round(x, 2) for x in ms_a + ms_b]}",
                          flush=True)
    finally:
        ynet.upsample_bilinear_2x = fixed
        torch.backends.cudnn.deterministic = False
    return 0


if __name__ == "__main__":
    sys.exit(main())
