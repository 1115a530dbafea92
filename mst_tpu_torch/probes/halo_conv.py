"""Does cuDNN sum a conv on a halo'd H slab as it sums the whole map?

    python -m mst_tpu_torch.probes.halo_conv    # one CUDA card

The spatial mesh's eval (models/layers.conv2d on a mesh.Slab) convolves
each rank's slab with one halo row of each neighbour above and below and
pads only W; its waypoint samples equal a world of one's bit for bit only
where those convs give the whole map's bits. For the Y-Net's 3x3 conv
shapes at 352 x 480 (B = 8 and the K = 20 decode's 160 rows) and the
slabs of 2 and 4 'space' ranks, the probe builds each slab's halo'd input
from the whole map (what parallel/halo.exchange delivers), convolves it,
and compares with the whole map's conv: bit-equal or the largest
difference, with cuDNN's default and deterministic algorithms, f32 with
TF32 off (mst_tpu_torch.resolve_device). The bilinear x2 of a halo'd slab
(ops/pooling.upsample_bilinear_2x) is compared too. Prints the card's
name and power limit first.
"""

import subprocess
import sys

import torch
import torch.nn.functional as F

# (N, H, W, Ci, Co): the encoder's and goal decoder's at B = 8, the
# trajectory decoder's at K * B = 160; the 22- and 44-row maps give
# 11-row slabs at 2 and 4 ranks, which the odd-slab rule runs whole
SHAPES = ((8, 352, 480, 14, 32), (8, 352, 480, 32, 32),
          (8, 176, 240, 32, 64), (8, 22, 30, 64, 64), (8, 44, 60, 128, 64),
          (160, 352, 480, 48, 32), (160, 352, 480, 32, 32),
          (160, 176, 240, 48, 32), (160, 88, 120, 96, 64))


def halo_slab(x, s, n):
    """Slab s of n of x (N, H, W, C) with one row of each neighbour, zeros
    at the map's top and bottom."""
    h = x.shape[1] // n
    lo, hi = s * h, (s + 1) * h
    zero = torch.zeros_like(x[:, :1])
    top = x[:, lo - 1:lo] if lo else zero
    bottom = x[:, hi:hi + 1] if hi < x.shape[1] else zero
    return torch.cat([top, x[:, lo:hi], bottom], 1), lo, hi


def conv(x, w, b, padding):
    return F.conv2d(x.permute(0, 3, 1, 2), w, b,
                    padding=padding).permute(0, 2, 3, 1)


def compare(shape, ranks=(2, 4)):
    """-> {ranks: max |slab conv - whole conv|} (0.0: bit-equal)."""
    N, H, W, Ci, Co = shape
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((N, H, W, Ci), generator=g, device="cuda")
    w = torch.randn((Co, Ci, 3, 3), generator=g, device="cuda") * 0.1
    b = torch.randn((Co,), generator=g, device="cuda")
    whole = conv(x, w, b, 1)
    out = {}
    for n in ranks:
        err = 0.0
        for s in range(n):
            xe, lo, hi = halo_slab(x, s, n)
            err = max(err, float((conv(xe, w, b, (0, 1))
                                  - whole[:, lo:hi]).abs().max()))
        out[n] = err
    return out


def upsample_equal():
    """The bilinear x2 of the middle-bottom slab of 2, with its top halo
    row and the map's own bottom edge, against the whole map's rows."""
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((160, 44, 60, 64), generator=g, device="cuda")

    def up(t):
        return F.interpolate(t.permute(0, 3, 1, 2), scale_factor=2,
                             mode="bilinear", align_corners=False
                             ).permute(0, 2, 3, 1)

    return torch.equal(up(x[:, 21:44])[:, 2:], up(x)[:, 44:88])


def main():
    if not torch.cuda.is_available():
        print("halo_conv: no CUDA device", file=sys.stderr)
        return 2
    from mst_tpu_torch import resolve_device

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip())
    resolve_device("cuda")
    try:
        for det in (False, True):
            torch.backends.cudnn.deterministic = det
            for shape in SHAPES:
                errs = compare(shape)
                print(f"cudnn.deterministic {det}, (N, H, W, Ci, Co) "
                      f"{shape}: max |slab - whole| by 'space' ranks "
                      f"{errs}", flush=True)
                torch.cuda.empty_cache()
            print(f"cudnn.deterministic {det}: the bilinear x2 of a halo'd "
                  f"slab bit-equal: {upsample_equal()}")
    finally:
        torch.backends.cudnn.deterministic = False
    return 0


if __name__ == "__main__":
    sys.exit(main())
