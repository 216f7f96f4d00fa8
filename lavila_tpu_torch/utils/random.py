"""Seeding: one seed, offset per process (reference lavila/utils/random.py)."""

import random

import numpy as np


def random_seed(seed: int = 42, rank: int = 0) -> int:
    np.random.seed(seed + rank)
    random.seed(seed + rank)
    return seed + rank
