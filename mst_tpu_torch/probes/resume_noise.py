"""Phase 10 of chip_smoke.py, repeated: how far the resumed run (R) lands
from an uninterrupted one (A), against how far a second uninterrupted run
(B) lands, and how often |R - A| passes phase 10's bound 2 |B - A| + 1e-6.
A distance is the largest |difference| of a trainable leaf over that
leaf's max; the card's run-to-run noise comes from the bilinear
backward's atomics.

    cd <root of a checkout>; python3 <path>/resume_noise.py [N]

It imports chip_smoke.py and mst_tpu_torch from the current directory,
so one copy of this script measures any checkout whose chip_smoke.py has
phase 10 (`raw_to_resumed`). One CUDA card. Prints one JSON line a
repetition and a summary; exits 1 if any repetition's phase 10 failed.
"""

import json
import os
import subprocess
import sys


def main(n):
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("resume_noise: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from mst_tpu_torch.ops.kernels import _build

    try:  # where the checkout's probes hold the table of wrappers
        from mst_tpu_torch.probes import kernel_wrappers
    except ImportError:  # else chip_smoke.py holds it
        kernel_wrappers = chip_smoke.kernel_wrappers
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card)
    _build.build(["fused_predict", "softargmax_rows", "conv3x3",
                  "decoder_chain"])

    # raw_to_resumed takes |B - A| first, then |R - A|
    distances, state_distance = [], chip_smoke.state_distance

    def recorded(a, b):
        distances.append(state_distance(a, b))
        return distances[-1]

    chip_smoke.state_distance = recorded
    reps = []
    for i in range(n):
        distances.clear()
        try:
            chip_smoke.raw_to_resumed(torch, kernel_wrappers(), card,
                                      {"max_abs_err": 0.0},
                                      {"max_abs_err": 0.0})
            failed = None
        except AssertionError as e:
            failed = str(e)
        d_ba, d_ra = (distances + [None, None])[:2]
        reps.append({"rep": i, "B-A": d_ba, "R-A": d_ra,
                     "ratio": d_ra / d_ba if d_ba and d_ra is not None
                     else None, "failed": failed})
        print("resume_noise " + json.dumps(reps[-1]), flush=True)
    n_failed = sum(r["failed"] is not None for r in reps)
    print("resume_noise " + json.dumps({
        "checkout": os.getcwd(), "card": card, "repetitions": n,
        "failed": n_failed,
        "ratios": [r["ratio"] for r in reps]}))
    return 1 if n_failed else 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 3))
