"""The plain reference that decides a run's `correct`.

Plain PyTorch on NCHW tensors, written from the published model (Y-Net,
Mangalam et al., ICCV 2021; Y-Net-Mod and MoSA, the MST reference's
models/ynet.py and utils/) with no kernel, no hoisting and no batching
trick: `model` holds the parameter tree's names and shapes and the
forward passes, `sampling` the keyed draws, TTST's k-means and CWS,
`train` the loss, the ground-truth maps and Adam. Nothing here imports
the program under test, nor jax: the draws' hash and the k-means loop are
frozen copies of the arithmetic the program states, so that the same key
gives the same draws on both sides.
"""
