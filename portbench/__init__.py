"""The benchmark of the PyTorch/CUDA port (mst_tpu_torch); see
README.md."""
