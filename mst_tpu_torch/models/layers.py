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


def batchnorm_init(ch):
    """-> (params, state) of a BatchNorm2d: weight 1, bias 0; running mean
    0, running var 1 and an int32 batch count (mst_tpu's dtype; torch's
    own counter is int64)."""
    params = {"weight": torch.ones(ch), "bias": torch.zeros(ch)}
    state = {"running_mean": torch.zeros(ch), "running_var": torch.ones(ch),
             "num_batches": torch.zeros((), dtype=torch.int32)}
    return params, state


def batchnorm_apply(params, state, x, train, momentum=0.1, eps=1e-5):
    """BatchNorm2d on an NHWC x (mst_tpu/models/layers.py:198-218) ->
    (y, new state). train normalises with the batch's biased variance and
    returns running statistics moved to 0.9 old + 0.1 batch, with the
    unbiased variance; the state given is not modified. Eval normalises
    with the running statistics and returns the state as it is."""
    if not train:
        y = F.batch_norm(x.permute(0, 3, 1, 2), state["running_mean"],
                         state["running_var"], params["weight"],
                         params["bias"], False, momentum, eps)
        return y.permute(0, 2, 3, 1), state
    # F.batch_norm updates the running statistics it is given in place
    # (outside autograd), so it gets copies: the new state
    mean = state["running_mean"].detach().clone()
    var = state["running_var"].detach().clone()
    y = F.batch_norm(x.permute(0, 3, 1, 2), mean, var, params["weight"],
                     params["bias"], True, momentum, eps)
    return y.permute(0, 2, 3, 1), {
        "running_mean": mean, "running_var": var,
        "num_batches": state["num_batches"] + 1}


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


def conv_init(generator, in_ch, out_ch, kernel_size, bias=True,
              zero_init=False):
    """kaiming_uniform(a=sqrt(5)) weight and U(+-1/sqrt(fan_in)) bias;
    zero_init: zeros for both (the adapters), drawing nothing."""
    if zero_init:
        params = {"weight": torch.zeros(out_ch, in_ch, kernel_size,
                                        kernel_size)}
        if bias:
            params["bias"] = torch.zeros(out_ch)
        return params
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
