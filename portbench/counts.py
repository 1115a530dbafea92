"""The yardstick's arithmetic: the card's published peaks, the least time
of a kernel call from its bytes and operations, and the model's FLOPs
from a configuration's shapes. Kept here, beside the harness, so that a
change to the program cannot change what it is measured against.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit.
"""

from portbench.reference import model

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12  # f32 outside the tensor cores (TF32 is off)


def least_s(nbytes, flops, flop_per_s=F32_FLOP_PER_S):
    """The least time of a call: each input byte read once and each
    output byte written once at HBM speed, or its operations at the
    peak rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_per_s)


def fused_predict_s(R, H, W, C, P):
    """The fused 1x1 predictor + soft-argmax over R rows of (H, W, C) f32
    activations into P maps: x read once, the (C, P) weight and bias,
    (R, P, 2) points written; 2C operations a logit, 8 for its running
    soft-argmax statistics."""
    return least_s(R * H * W * C * 4 + (C * P + P) * 4 + R * P * 2 * 4,
                   R * H * W * P * (2 * C + 8))


def softargmax_rows_s(R, HW, elem_bytes=4):
    """The rows soft-argmax over R maps of HW logits: read once, two
    coordinates written; 8 operations a logit."""
    return least_s(R * HW * elem_bytes + R * 2 * 4, R * HW * 8)


def _level(path, net):
    """The pyramid level (0 finest) at which a conv of the tree runs."""
    parts = path.split("/")
    n = len(net.encoder_channels)
    if parts[0] == "encoder":
        i = int(parts[2])
        if parts[1] == "fusion_stages":
            return n - net.n_fusion + i
        return i
    if parts[1] == "center":
        return n
    if parts[1] == "predictor":
        return 0
    return n - 1 - int(parts[2])


def convs(net):
    """[(path, level, cin, cout, k, data_fed)] of every conv of the model;
    data_fed marks a conv whose input is the data (no input gradient)."""
    out = []
    for path, shape in model.param_shapes(net).items():
        if not path.endswith("/weight"):
            continue
        conv = path[:-len("/weight")]
        co, ci, k, _ = shape
        data_fed = conv.split("/")[1] != "fusion_stages" and conv.endswith(
            "/0/conv0") and conv.startswith("encoder/")
        out.append((conv, _level(conv, net), ci, co, k, data_fed))
    return out


def conv_flops(H, W, level, ci, co, k):
    """2 H W Ci Co k^2 at the level's size: one multiply and one add a
    tap."""
    return 2 * (H >> level) * (W >> level) * ci * co * k * k


def serve_flops(net, H, W, B, K):
    """A request of B agents: the encoder and the goal decoder on B rows,
    the trajectory decoder on K B rows, as the published model runs them
    (unshared: every sample's first convs read the encoder features)."""
    total = 0
    for conv, level, ci, co, k, _ in convs(net):
        rows = K * B if conv.startswith("traj_decoder") else B
        total += rows * conv_flops(H, W, level, ci, co, k)
    return total


def train_flops(net, H, W, B):
    """A fine-tune step of B rows: every conv's forward; the input
    gradient of every conv whose input depends on a trainable leaf (all
    but the data-fed first convs, the encoder being adapted at every
    stage); the weight gradient of every adapted conv."""
    total = 0
    for conv, level, ci, co, k, data_fed in convs(net):
        f = B * conv_flops(H, W, level, ci, co, k)
        adapted = conv.startswith("encoder/") and net.lora_at(
            conv.split("/")[1].split("_")[0] if net.network == "fusion"
            else int(conv.split("/")[2]))
        total += f * (1 + (not data_fed) + adapted)
    return total
