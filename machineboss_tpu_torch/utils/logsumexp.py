"""Table-interpolated log-sum-exp, numerically identical to the reference
(ref: src/logsumexp.{h,cpp}): log(1+exp(-x)) via a 100k-entry lookup table
with linear interpolation, precision 1e-4, cutoff at x=10.

The host DP engines use this for golden-file parity; the TPU engines use
exact fused logaddexp (the difference is ~1e-5 per op, within the 0.01-nat
cross-backend tolerance the reference itself uses).
"""

import math

import numpy as np

LOOKUP_MAX = 10.0
PRECISION = 1e-4
ENTRIES = int(LOOKUP_MAX / PRECISION) + 1

# one extra entry so interpolation at the boundary can read table[n+1]
_TABLE = np.log1p(np.exp(-np.arange(ENTRIES + 1, dtype=np.float64)
                         * PRECISION))

NEG_INF = -math.inf


def lse_unary(x):
    """log(1+exp(-x)) for x >= 0, table-interpolated."""
    if x >= LOOKUP_MAX or math.isnan(x) or math.isinf(x):
        return 0.0
    if x < 0:
        return -x
    n = int(x / PRECISION)
    f0 = _TABLE[n]
    dx = x - n * PRECISION
    f1 = _TABLE[n + 1]
    return f0 + (f1 - f0) * (dx / PRECISION)


def lse(a, b):
    """log(exp(a)+exp(b)) with reference semantics (a==b handled exactly)."""
    if a == b:
        mx, diff = a, 0.0
    elif a < b:
        mx, diff = b, b - a
    else:
        mx, diff = a, a - b
    return mx + lse_unary(diff)


def lse_unary_vec(x):
    """Vectorized log(1+exp(-x)) for nonnegative x (array)."""
    x = np.asarray(x, dtype=np.float64)
    out = np.zeros_like(x)
    ok = (x < LOOKUP_MAX) & np.isfinite(x)
    xs = np.where(ok, x, 0.0)
    n = (xs / PRECISION).astype(np.int64)
    f0 = _TABLE[n]
    f1 = _TABLE[n + 1]
    dx = xs - n * PRECISION
    out = np.where(ok, f0 + (f1 - f0) * (dx / PRECISION), 0.0)
    return out


def lse_vec(a, b):
    """Elementwise table lse over arrays."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mx = np.where(a == b, a, np.maximum(a, b))
    diff = np.where(a == b, 0.0, np.abs(a - b))
    with np.errstate(invalid="ignore"):
        res = mx + lse_unary_vec(diff)
    return np.where(np.isneginf(mx) & np.isneginf(np.minimum(a, b)), NEG_INF,
                    res)


def accumulate_at(ll, dst, contrib):
    """Sequential ll[dst[k]] = lse(ll[dst[k]], contrib[k]) in edge order,
    matching the reference's per-transition accumulation order."""
    for k in range(len(dst)):
        d = dst[k]
        ll[d] = lse(ll[d], contrib[k])
