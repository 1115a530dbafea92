"""Determinism helpers (counterpart of mst_tpu/utils/seeding.py; reference
utils/data_utils.py:945-952): seed the host-side generators the data
pipeline draws from, and torch's default generators."""

import random

import numpy as np
import torch


def set_random_seeds(seed: int = 0):
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
