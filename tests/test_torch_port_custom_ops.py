"""The serving kernels as torch.library custom ops, on the CPU: both ops
through torch.library.opcheck (schema, autograd registration, fake
tensor, AOT dispatch), under torch.func.vmap against one plain call a
slice (the weight shared and batched), and their fake implementations'
shapes. The CUDA implementations (the kernels), their vmap folds on the
card and their launches under CUDA-graph capture are chip_smoke.py's
phase 12.
"""

import numpy as np
import pytest
import torch

from mst_tpu_torch.ops.kernels.fused_predict import (
    fused_predictor_softargmax, fused_predictor_softargmax_plain)
from mst_tpu_torch.ops.kernels.softargmax_rows import softargmax2d_rows
from mst_tpu_torch.ops.softargmax import softargmax2d

ROWS = torch.ops.mst_tpu_torch.softargmax2d_rows
FUSED = torch.ops.mst_tpu_torch.fused_predictor_softargmax


@pytest.fixture
def rng():
    return np.random.default_rng(13)


def t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_rows(rng, dtype):
    x = t(rng.normal(size=(3, 4, 9, 11)) * 3, dtype)
    torch.library.opcheck(ROWS, (x, 1e-6))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_fused(rng, dtype):
    x = t(rng.normal(size=(5, 7, 9, 6)), dtype)
    w = t(rng.normal(size=(6, 4)) * 0.3, dtype)
    b = t(rng.normal(size=(4,)))
    torch.library.opcheck(FUSED, (x, w, b, 1e-6))


def test_rows_under_vmap(rng):
    """A run axis (at dim 0, and at dim 1) folds into the rows: each run's
    slice equals the plain version of that slice, exactly."""
    x = t(rng.normal(size=(3, 2, 5, 8, 12)) * 4)
    got = torch.func.vmap(softargmax2d_rows)(x)
    for r in range(3):
        torch.testing.assert_close(got[r], softargmax2d(x[r]), rtol=0,
                                   atol=0)
    got = torch.func.vmap(softargmax2d_rows, in_dims=1)(x)
    for r in range(2):
        torch.testing.assert_close(got[r], softargmax2d(x[:, r]), rtol=0,
                                   atol=0)


@pytest.mark.parametrize("batched", [
    (0, None, None), (0, 0, 0), (0, 0, None), (None, 0, 0)])
def test_fused_under_vmap(rng, batched):
    """The weight shared (folded into R) or each run's own (one call a
    run), and x shared across runs: each run's slice equals the plain
    version of its operands (1e-6 px: the folded call is one einsum over
    all runs' rows)."""
    n = 3
    xs = t(rng.normal(size=(n, 4, 6, 10, 8)))
    ws = t(rng.normal(size=(n, 8, 5)) * 0.3)
    bs = t(rng.normal(size=(n, 5)))
    args = [a if d == 0 else a[0] for a, d in zip((xs, ws, bs), batched)]
    got = torch.func.vmap(fused_predictor_softargmax,
                          in_dims=batched)(*args)
    assert got.shape == (n, 4, 5, 2)
    for r in range(n):
        want = fused_predictor_softargmax_plain(*[
            a[r] if d == 0 else a for a, d in zip(args, batched)])
        torch.testing.assert_close(got[r], want, rtol=0, atol=1e-6)


def test_fake_shapes():
    """Meta tensors reach the fakes: the rows op keeps the leading dims and
    ends in 2, the fused op gives (R, P, 2), both f32 (bf16 in, too)."""
    x = torch.empty((2, 3, 40, 56), dtype=torch.bfloat16, device="meta")
    out = ROWS(x, 1e-6)
    assert out.shape == (2, 3, 2) and out.dtype == torch.float32
    assert out.device.type == "meta"
    out = FUSED(torch.empty((7, 40, 56, 32), device="meta"),
                torch.empty((32, 12), device="meta"),
                torch.empty((12,), device="meta"), 1e-6)
    assert out.shape == (7, 12, 2) and out.dtype == torch.float32
    with torch._subclasses.fake_tensor.FakeTensorMode():
        out = FUSED(torch.empty((9, 8, 8, 6)), torch.empty((6, 30)),
                    torch.empty((30,)), 1e-6)
        assert out.shape == (9, 30, 2)
