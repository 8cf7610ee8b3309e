"""iCaRL's herding (Rebuffi et al., CVPR 2017), plain NumPy: pick, one at a
time, the sample that brings the mean of the picked ones closest to the
class mean, in float64, the first index on a tie."""

from __future__ import annotations

import numpy as np


def barycenter(features: np.ndarray, nb: int) -> np.ndarray:
    """The first ``nb`` indices in the order they were picked."""
    f = np.asarray(features, np.float32).astype(np.float64)
    nb = min(nb, len(f))
    mu = f.mean(axis=0)
    taken = np.zeros(len(f), bool)
    order = np.empty(nb, np.int64)
    total = np.zeros_like(mu)
    for k in range(nb):
        d = (((total[None, :] + f) / (k + 1) - mu[None, :]) ** 2).sum(axis=1)
        d[taken] = np.inf
        i = int(np.argmin(d))
        order[k], taken[i] = i, True
        total += f[i]
    return order
