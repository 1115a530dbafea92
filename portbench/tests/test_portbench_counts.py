"""The yardstick's counts against hand counts and against PyTorch's own
count of the reference's convolutions."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts, traffic
from portbench.reference import model
from portbench.reference import train as ref_train
from portbench.tests.small import small


def test_fused_bound_by_hand():
    # 160 rows of 352 x 480 x 32 f32 read once: 3,460,300,800 bytes, plus
    # the (32, 12) weight and bias and the (160, 12, 2) points
    nbytes = 160 * 352 * 480 * 32 * 4 + (32 * 12 + 12) * 4 + 160 * 12 * 8
    assert nbytes == 3_460_317_744
    assert counts.fused_predict_s(160, 352, 480, 32, 12) == pytest.approx(
        nbytes / 3.35e12, rel=1e-12)
    # P = 30 at Y-Net-Mod's 200 rows of 320 x 576: still bytes
    ops = 200 * 320 * 576 * 30 * (2 * 32 + 8)
    assert ops / 67e12 < 200 * 320 * 576 * 32 * 4 / 3.35e12


def test_rows_bound_by_hand():
    assert counts.softargmax_rows_s(8, 352 * 480) == pytest.approx(
        (8 * 352 * 480 * 4 + 8 * 2 * 4) / 3.35e12, rel=1e-12)


def test_conv_flops_by_hand():
    # a 3x3 conv from 2 to 3 channels at level 1 of a 64 x 96 map
    assert counts.conv_flops(64, 96, 1, 2, 3, 3) == 2 * 32 * 48 * 2 * 3 * 9


@pytest.mark.parametrize("name", ["ynet_sdd.serve_ttst",
                                  "ynetmod_ind.serve_ttst_cws"])
def test_serve_flops_count_the_reference_convs(name):
    cell, cfg = small(name)
    net = model.Net.of(cfg)
    flat = {k: v for k, v in traffic.weights(net, 1, "cpu").items()
            if "lora" not in k}
    H, W, B, K = 64, 96, 2, 20
    sem = torch.rand(B, net.n_semantic_classes, H, W)
    obs = torch.rand(B, net.obs_len, 2) * 40
    wps = torch.rand(K, B, len(net.waypoints), 2) * 40
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        feats = model.features(flat, net, sem, obs, 1050)
        model.goal_logits(flat, feats)
        model.decode(flat, feats, wps, 1050, 5)
    assert fc.get_total_flops() == counts.serve_flops(net, H, W, B, K)


@pytest.mark.parametrize("name", ["ynet_sdd.finetune_mosa1",
                                  "ynetmod_ind.finetune_mosa1"])
def test_train_flops_count_the_reference_convs(name):
    cell, cfg = small(name)
    net = model.Net.of(cfg)
    params = {**traffic.weights(net, 1, "cpu"),
              **traffic.style_deltas(net, 1, 1, "cpu")[0]}
    H, W, B = 64, 96, 4
    batch = {"semantic": torch.rand(1, H, W, net.n_semantic_classes),
             "traj": torch.rand(B, net.obs_len + net.pred_len, 2) * 40,
             "mask": torch.ones(B)}
    names = ref_train.trainable(net, params)
    for k in names:
        params[k].requires_grad_(True)
    with FlopCounterMode(display=False) as fc:
        out = ref_train.step_outputs(params, net, cfg, batch)
        torch.autograd.grad(out["loss"], [params[k] for k in names])
    # the LoRA merges' small matmuls are the only other products
    assert fc.get_total_flops() == pytest.approx(
        counts.train_flops(net, H, W, B), rel=2e-3)
