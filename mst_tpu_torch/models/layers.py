"""Conv layers on NHWC tensors with OIHW weights (counterpart of
mst_tpu/models/layers.py).

Activations keep the JAX package's NHWC layout at every function edge; a
contiguous NHWC tensor viewed as NCHW is exactly PyTorch's channels_last
memory format, so the permutes below are free and the convs run
channels_last. Weights are OIHW, PyTorch's own layout.

A conv takes its input and weight in one dtype (f32, or bf16 under the
steps' compute dtype) and raises TypeError otherwise, as
lax.conv_general_dilated does. A batch norm follows JAX's promotion: in
eval mode a bf16 x against f32 running statistics comes out f32 (so the
conv after it raises, where mst_tpu's does); in train mode it stays in
x's dtype and the running statistics in theirs.
"""

import math

import torch
import torch.nn.functional as F


def check_same_dtype(x, weight):
    """Raise as lax.conv_general_dilated does on operands of two dtypes."""
    if x.dtype != weight.dtype:
        raise TypeError(f"a conv requires its input and weight to have the "
                        f"same dtype, got {x.dtype} and {weight.dtype}")


def conv2d(x, weight, bias=None):
    """SAME-padded stride-1 conv: x (N, H, W, Ci), weight (Co, Ci, k, k)
    -> (N, H, W, Co)."""
    check_same_dtype(x, weight)
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
    with the running statistics and returns the state as it is.

    train is False, True, or a parallel.mesh.Shards: x is then this
    rank's rows of a global batch, and the statistics are the global
    batch's. Train mode takes one formula in every world
    (global_batch_norm)."""
    if train:
        return global_batch_norm(params, state, x,
                                 None if train is True else train,
                                 momentum, eps)
    # JAX promotes (x - mean) to the wider of the two dtypes
    dtype = torch.promote_types(x.dtype, state["running_mean"].dtype)
    y = F.batch_norm(x.permute(0, 3, 1, 2).to(dtype),
                     state["running_mean"].to(dtype),
                     state["running_var"].to(dtype),
                     params["weight"].to(dtype), params["bias"].to(dtype),
                     False, momentum, eps)
    return y.permute(0, 2, 3, 1), state


def global_batch_norm(params, state, x, shards=None, momentum=0.1,
                      eps=1e-5):
    """Train-mode batchnorm_apply over a global batch whose rows the ranks
    of `shards` hold, x this rank's (every rank the same number; None: x
    is the whole batch): the mean, then the biased variance about it, as
    mst_tpu computes them, each a sum over the ranks (an autograd op, so
    the backward sums over the ranks too; what SyncBatchNorm computes),
    in the statistics' dtype. x keeps its dtype. The moved running
    statistics are the same on every rank."""
    stat_dtype = state["running_mean"].dtype
    xs = x.to(stat_dtype)

    def total(t):
        return t if shards is None else shards.sum_differentiable(t)

    n = xs.numel() // xs.shape[-1] * (1 if shards is None else shards.count)
    mean = total(xs.sum(dim=(0, 1, 2))) / n
    var = total(((xs - mean) ** 2).sum(dim=(0, 1, 2))) / n
    y = (xs - mean) * torch.rsqrt(var + eps) * params["weight"].to(
        stat_dtype) + params["bias"].to(stat_dtype)
    with torch.no_grad():
        running_mean = ((1 - momentum) * state["running_mean"]
                        + momentum * mean)
        running_var = ((1 - momentum) * state["running_var"]
                       + momentum * var * (n / max(n - 1, 1)))
    return y.to(x.dtype), {"running_mean": running_mean,
                           "running_var": running_var,
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
