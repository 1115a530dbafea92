"""Experiment.forward_test with a shallow segmentation backbone in front
of the 2-stage Y-Net, clean and noisy, against mst_tpu's forward_test run
in float64: the checks, bars and fixtures of
test_torch_port_forward_test.py (whose docstring gives the reasons),
here in a file of their own so that each file's eager mst_tpu compiles
stay ~15 s.
"""

import pytest

from tests.test_torch_port_forward_test import (  # noqa: F401 (fixtures)
    INPUTS, MAP_TOL, assert_grad, assert_loss, check_input_grads,
    check_losses, check_maps, in_float64, jax_float64, jax_noise,
    one_scene, pairs, probes, world)


@pytest.mark.parametrize("backbone", ["backbone"])
def test_forward_test_losses_match_mst_tpu(probes, backbone):
    check_losses(probes(backbone))


@pytest.mark.parametrize("backbone", ["backbone"])
def test_forward_test_maps_match_mst_tpu(probes, backbone):
    check_maps(probes(backbone))


@pytest.mark.parametrize("backbone", ["backbone"])
def test_forward_test_input_grads_match_mst_tpu(probes, backbone):
    check_input_grads(probes(backbone))


def test_noisy_forward_test_matches_mst_tpu_on_its_draws(world, pairs,
                                                        probes):
    """The noisy probe (noisy_std_frac 0.1 on the observed maps and the
    semantic map) with mst_tpu's float64 draws injected, held to
    mst_tpu's float64 probe as without noise: the losses of the port's
    f32 and float64 probes, and the input gradients, which pass through
    the noise's scale (the inputs' value range), of its float64 probe;
    the noise moves the maps."""
    port, jexp = pairs("backbone")
    noise = jax_noise(jexp, port, world, INPUTS)
    data = one_scene(world, "port")
    kw = dict(set_input=INPUTS, noisy_std_frac=0.1)
    got = port.forward_test(data, None, noise=noise, **kw)
    got64 = in_float64(port, lambda: port.forward_test(
        data, None, noise=noise, input_grads=True, **kw))
    want = jax_float64(jexp, lambda: jexp.forward_test(
        one_scene(world, "jax"), None, input_grads=True, **kw))
    for probe in (got, got64):
        for g, w, name in zip(probe[:2], want[:2], ("goal", "traj")):
            assert_loss(g, w, name)
    for name in INPUTS:
        assert_grad(got64[3][name], want[3][name], name)
    noisy = port.forward_test(data, None, noise=noise, decision="map", **kw)
    clean = probes("backbone")["port_maps"]
    for g, c in zip(noisy[:2], clean[:2]):
        assert float((g - c).abs().max()) > 10 * MAP_TOL * float(
            c.abs().max())
