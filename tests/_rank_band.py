"""The rank band of a dense f64 oracle, shared by the port's evaluation
tests: scores within a tolerance of the target may fall on either side
of it, so a streamed rank is right when it lies inside the band."""
import numpy as np


def f64_band(x, y, t, c_lo, c_hi, id_offset, tol):
    """Per row, the least and the most 0-based rank the target can have
    when scores within ``tol`` of it may fall on either side (dense f64
    scores over the valid columns, the target's own column left out)."""
    s = x.astype(np.float64) @ y.astype(np.float64).T
    c = y.shape[0]
    gid = id_offset + np.arange(c)
    valid = (gid >= c_lo) & (gid < c_hi)
    local = t.astype(np.int64) - id_offset
    owned = (local >= 0) & (local < c)
    tgt = np.where(owned, s[np.arange(len(t)), np.clip(local, 0, c - 1)], 0.0)
    other = valid[None, :] & (gid[None, :] != t[:, None])
    lo = ((s > tgt[:, None] + tol) & other).sum(1)
    hi = ((s >= tgt[:, None] - tol) & other).sum(1)
    return lo, hi
