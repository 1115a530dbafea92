"""A segmentation_bn fine-tune against mst_tpu's on the CPU in f32, from
the same weights (test_torch_port_segmentation.py's `world`: a shallow
backbone, batch norms moved, the stride-2 convs live): its delta after
one Adam step (mst_tpu's keys; both packages' style overlays), and both
packages' Experiment.train of 2 epochs across e_unfreeze with Adam and a
scripted validation. Epoch 0 runs the backbone in the step in eval mode,
where the 13 encoder norms' running statistics are Adam's leaves and get
their gradients; from epoch 1 the backbone's batch norms run on the
batch's statistics, which move the state's 'segmentation_bn', and the
leaves' running statistics get a zero gradient, with which Adam's moments
still move them (ROADMAP Queue 3 #10: mst_tpu's quirk, kept on purpose).
"""

import json

import numpy as np

from mst_tpu import serve as jserve
from mst_tpu.train import checkpoints as jckpt
from mst_tpu.train import freeze as jfreeze
from mst_tpu_torch import config, io, loader, serve
from mst_tpu_torch.train import steps, trainer
from tests.test_torch_port_backbone_loop import (MAP_TOL, PARAM_TOL, close,
                                                 jax_experiment, scripted)
from tests.test_torch_port_segmentation import (  # noqa: F401 (world)
    hwio, jax_tree, params_for, step_inputs, t, world)


# the norms' weights and biases: tests/test_torch_port_spatial_train_jax
# .py's bars, mst_tpu's own for its steps (Adam steps a leaf by about lr
# whatever its gradient's size, so where a gradient sits near 0 a last-bit
# difference can step it the other way)
LEAF_RTOL, LEAF_ATOL = 1e-3, 3


def test_segmentation_bn_across_e_unfreeze_matches_jax(world):
    """The epoch losses (1e-5), the 'segmentation_bn' state after epoch 1
    (MAP_TOL of each leaf's max), the 13 encoder norms' running
    statistics, which Adam moved in both epochs (PARAM_TOL of each leaf's
    max; a run that left them in place in epoch 1 lands ~lr off), their
    weights and biases (LEAF_RTOL, LEAF_ATOL lr), and the other backbone
    leaves untouched."""
    over = dict(n_epoch=2, e_unfreeze=1, train_net="segmentation_bn")
    port = trainer.Experiment(params_for(world, **over),
                              images=world["images"])
    jexp = jax_experiment(params_for(world, "jax", **over), world["images"],
                          port)
    records = {}
    for side, exp, split in (("port", port, world["tables"]),
                             ("jax", jexp, world["frames"])):
        exp._evaluate = scripted([50.0, 45.0])
        exp.train(split["train"], split["val"], None, None, "exp")
        with open(world["tmp"] / side / "metrics.jsonl") as f:
            records[side] = [json.loads(line) for line in f]
    assert len(records["port"]) == len(records["jax"]) == 2
    for g, w in zip(records["port"], records["jax"]):
        for k in ("loss", "train_ade", "train_fde"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    got = io.state_to_numpy(port.model_state["segmentation_bn"])
    want = {k: np.asarray(v) for k, v in io.flatten(
        jexp.model_state["segmentation_bn"]).items()}
    assert got.keys() == want.keys()
    for k, v in want.items():
        close(got[k], v, MAP_TOL, k)
    ported = hwio(port.model_params)
    jflat = {k: np.asarray(v)
             for k, v in jckpt.flatten_tree(jexp.model_params).items()
             if k.startswith("segmentation/")}
    trained = {k for k in jflat if "bn" in k[len("segmentation/"):]}
    assert len(trained) == 4 * 13
    lr = port.params["lr"]
    for k, v in jflat.items():
        start = world["flat"][k[len("segmentation/"):]]
        if k not in trained:
            np.testing.assert_array_equal(ported[k], start, err_msg=k)
            np.testing.assert_array_equal(v, start, err_msg=k)
        elif k.endswith(("/running_mean", "/running_var")):
            close(ported[k], v, PARAM_TOL, k)
            assert np.abs(ported[k] - start).max() > 0.5 * lr, k
        else:  # a gradient near 0 flips Adam's step: mst_tpu's own bars
            np.testing.assert_allclose(ported[k], v, rtol=LEAF_RTOL,
                                       atol=LEAF_ATOL * lr, err_msg=k)


def test_segmentation_bn_delta_matches_jax_and_serves(world, tmp_path):
    """A segmentation_bn fine-tune's delta after one Adam step: mst_tpu's
    keys (its mask: the 13 encoder norms' weights, biases and running
    statistics), and both packages' style overlays of it on the base
    weights give the same leaves; a Predictor's style holds the stepped
    backbone, running statistics included, bit for bit."""
    params, weights, init, batch = step_inputs(world, "segmentation_bn")
    setup = trainer.setup_training(weights, params, steps_per_epoch=1)
    step = steps.make_train_step(config.ynet_config(params),
                                 config.step_config(params,
                                                    segment_in_step=True))
    step(weights, {}, setup["optimizer"], {k: t(v) for k, v in
                                            batch.items()})
    path = tmp_path / "bn.npz"
    trainer.save_params(path, weights, params)
    delta = io.load_checkpoint(path)
    want = {k for k, v in io.flatten(jfreeze.trainable_mask(
        jax_tree(init), "segmentation_bn")).items() if v}
    assert delta.keys() == want and len(want) == 4 * 13
    stepped = hwio(weights)
    assert any(not np.array_equal(delta[k], init[k]) for k in delta
               if k.endswith("/running_var"))
    got = io.params_to_numpy(loader.overlay_npz(
        io.params_from_numpy(init), delta, "delta"))
    jgot = io.flatten(jserve._overlay(io.unflatten(init), delta))
    assert got.keys() == jgot.keys()
    for k, v in jgot.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    pred = serve.Predictor(params, device="cpu")
    pred.add_style("bn", path)
    style = io.params_to_numpy(pred._weights("bn"))
    for k, v in stepped.items():
        if k.startswith("segmentation/"):
            np.testing.assert_array_equal(style[k], v, err_msg=k)
