"""RNG-DISCIPLINE true positives: entropy outside the counter scheme.

Parsed by the rule engine in tests, never imported or executed.
"""
import numpy as np
import torch

from repro_torch.serve import sampling as sampling_lib


def resample(logits, uid):
    torch.manual_seed(uid)                                   # TP 1
    gen = torch.Generator()                                  # TP 2
    noise = torch.rand(logits.shape)                         # TP 3
    logits.normal_()                                         # TP 4
    k1, k2 = sampling_lib.fold_in(uid, 0)                    # TP 5
    rng = np.random.default_rng(uid)                         # TP 6
    return gen, noise, k1, k2, rng
