"""The segmentation backbone's convolution on NCHW views of channels_last
memory (models/unet.py).

On the card it is cuDNN's F.conv2d. On the CPU, in f32, it is oneDNN's
direct convolution at every shape (torch.ops.aten.mkldnn_convolution),
which F.conv2d itself takes for most of the backbone's shapes: it sums
each output pixel in an order that does not depend on the map's height,
so an H slab's conv with its halo rows (a spatial mesh's rank) gives
the whole map's bits on the slab's rows. F.conv2d picks ATen's im2col
and GEMM instead for a 3x3 or 1x1 kernel on one image of at most 20480
elements, and that GEMM's sums change with the rows it is given (a
slab's conv lands otherwise than the whole map's in its last bits).

The oneDNN call is a custom op (mst_tpu_torch::conv2d_onednn) with a fake
and an autograd rule, so torch.export records it in a program and a
process that loads the program runs the same kernel (loader.py imports
this module); its backward is ATen's convolution_backward.
"""

from typing import List, Optional

import torch
import torch.nn.functional as F


def conv2d(x, weight, bias, stride, padding):
    """F.conv2d(x, weight, bias, stride, padding) with padding a pair (H,
    W): oneDNN's on a CPU f32 x (the module docstring), F.conv2d
    elsewhere."""
    if x.device.type == "cpu" and x.dtype == torch.float32 and \
            torch.backends.mkldnn.is_available():
        return _onednn(x, weight, bias, int(stride), list(padding))
    return F.conv2d(x, weight, bias, stride, tuple(padding))


@torch.library.custom_op("mst_tpu_torch::conv2d_onednn", mutates_args=())
def _onednn(x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor], stride: int,
            padding: List[int]) -> torch.Tensor:
    return torch.ops.aten.mkldnn_convolution(
        x, weight, bias, padding, [stride, stride], [1, 1], 1)


def _out_shape(x, weight, stride, padding):
    k = weight.shape[-2:]
    return (x.shape[0], weight.shape[0]) + tuple(
        (x.shape[2 + i] + 2 * padding[i] - k[i]) // stride + 1
        for i in range(2))


@_onednn.register_fake
def _(x, weight, bias, stride, padding):
    fmt = (torch.channels_last
           if x.is_contiguous(memory_format=torch.channels_last)
           and not x.is_contiguous() else torch.contiguous_format)
    return torch.empty(_out_shape(x, weight, stride, padding),
                       dtype=x.dtype, device=x.device, memory_format=fmt)


def _setup(ctx, inputs, output):
    x, weight, bias, stride, padding = inputs
    ctx.save_for_backward(x, weight)
    ctx.has_bias, ctx.stride, ctx.padding = bias is not None, stride, padding


def _backward(ctx, grad):
    x, weight = ctx.saved_tensors
    gx, gw, gb = torch.ops.aten.convolution_backward(
        grad, x, weight, [weight.shape[0]] if ctx.has_bias else None,
        [ctx.stride, ctx.stride], ctx.padding, [1, 1], False, [0, 0], 1,
        [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
         ctx.has_bias and ctx.needs_input_grad[2]])
    return gx, gw, gb, None, None


_onednn.register_autograd(_backward, setup_context=_setup)
