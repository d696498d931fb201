"""Opt-in NaN/Inf debug hook (ref src/logsumexp.h:15-18 nan_debug analog).

The reference's debug build aborts inside log_sum_exp when a NaN appears.
Device kernels can't trap per-op, so the TPU-native equivalent checks at
the host boundaries: every wrapper that materializes device results
(log-likelihoods, lattices, counts) calls check_finite, which is a no-op
unless MB_NAN_CHECK=1 is set in the environment.
"""

import os

import numpy as np


def nan_check_enabled():
    return os.environ.get("MB_NAN_CHECK", "0") == "1"


def check_finite(name, arr, allow_neg_inf=True):
    """Raise FloatingPointError if arr holds NaN (or +inf; -inf is a legal
    log-zero unless allow_neg_inf=False). Returns arr unchanged. No-op
    unless MB_NAN_CHECK=1."""
    if not nan_check_enabled():
        return arr
    a = np.asarray(arr, np.float64)
    bad = np.isnan(a) | np.isposinf(a)
    if not allow_neg_inf:
        bad |= np.isneginf(a)
    if bad.any():
        idx = np.argwhere(bad)[:4].tolist()
        raise FloatingPointError(
            "MB_NAN_CHECK: non-finite values in %s at %s (of %s)"
            % (name, idx, a.shape))
    return arr
