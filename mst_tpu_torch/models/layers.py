"""Conv layers on NHWC tensors with OIHW weights (counterpart of
mst_tpu/models/layers.py).

Activations keep the JAX package's NHWC layout at every function edge; a
contiguous NHWC tensor viewed as NCHW is exactly PyTorch's channels_last
memory format, so the permutes below are free and the convs run
channels_last. Weights are OIHW, PyTorch's own layout.
"""

import math

import torch
import torch.nn.functional as F


def conv2d(x, weight, bias=None):
    """SAME-padded stride-1 conv: x (N, H, W, Ci), weight (Co, Ci, k, k)
    -> (N, H, W, Co)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, padding="same")
    return y.permute(0, 2, 3, 1)


def conv_apply(params, x):
    """One conv of the parameter tree: 'weight' (+ 'bias')."""
    return conv2d(x, params["weight"], params.get("bias"))


def lora_merged_weight(params, rank):
    """loralib's merged weight W + (B @ A).view(out, in, k, k) / rank.

    The row-major view of B @ A is already OIHW, so unlike the JAX package
    (which transposes it to HWIO) no transpose follows.
    """
    w = params["weight"]
    delta = (params["lora_B"] @ params["lora_A"]).view(w.shape)
    return w + delta * (1.0 / rank)


def lora_conv_apply(params, x, rank):
    return conv2d(x, lora_merged_weight(params, rank), params.get("bias"))


# ---------------------------------------------------------------------------
# initializers: the shapes and distributions of mst_tpu/models/layers.py
# (torch nn.Conv2d defaults; loralib for the LoRA factors)
# ---------------------------------------------------------------------------

def _uniform(generator, shape, bound):
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


def conv_init(generator, in_ch, out_ch, kernel_size, bias=True):
    """kaiming_uniform(a=sqrt(5)) weight and U(+-1/sqrt(fan_in)) bias."""
    fan_in = in_ch * kernel_size * kernel_size
    bound = math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / fan_in)
    params = {"weight": _uniform(
        generator, (out_ch, in_ch, kernel_size, kernel_size), bound)}
    if bias:
        params["bias"] = _uniform(generator, (out_ch,),
                                  1.0 / math.sqrt(fan_in))
    return params


def lora_conv_init(generator, in_ch, out_ch, kernel_size, rank):
    """Base conv plus loralib factors: lora_A (r*k, in*k) kaiming-uniform,
    lora_B (out*k, r*k) zeros."""
    params = conv_init(generator, in_ch, out_ch, kernel_size)
    k = kernel_size
    bound = math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / (in_ch * k))
    params["lora_A"] = _uniform(generator, (rank * k, in_ch * k), bound)
    params["lora_B"] = torch.zeros(out_ch * k, rank * k)
    return params
