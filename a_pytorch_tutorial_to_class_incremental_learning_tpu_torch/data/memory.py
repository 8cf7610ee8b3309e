"""Rehearsal memory with herding exemplar selection (numpy, on the host).

Same semantics as the JAX package's ``data/memory.py`` with its numpy
herding: ``add`` re-ranks every class present in the added data with the
current model's features, the per-class quota is ``memory_size //
nb_seen_classes`` (or ``// nb_total_classes`` with ``fixed_memory``), and
``get`` returns the exemplars of all classes in class order.  The greedy is
a few thousand feature vectors once per task, so it stays on the host.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np


def herd_barycenter(features: np.ndarray, nb: int) -> np.ndarray:
    """iCaRL greedy herding: the first ``nb`` indices, in selection order,
    such that each prefix's mean best approximates the class mean (float32
    storage, float64 accumulation, first-index tie break)."""
    features = np.asarray(features, np.float32).astype(np.float64)
    n = len(features)
    nb = min(nb, n)
    mu = features.mean(axis=0)
    selected = np.zeros(n, bool)
    order = np.empty(nb, np.int64)
    running_sum = np.zeros_like(mu)
    for k in range(nb):
        cand = (running_sum[None, :] + features) / (k + 1)
        dist = ((mu[None, :] - cand) ** 2).sum(axis=1)
        dist[selected] = np.inf
        i = int(np.argmin(dist))
        order[k] = i
        selected[i] = True
        running_sum += features[i]
    return order


def herd_random(features: np.ndarray, nb: int, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return rng.permutation(len(features))[: min(nb, len(features))]


def herd_cluster(features: np.ndarray, nb: int, iters: int = 20) -> np.ndarray:
    """K-means into ``nb`` clusters and keep the unchosen sample nearest each
    centroid, clusters visited by descending population (rank order)."""
    features = np.asarray(features, np.float64)
    n = len(features)
    nb = min(nb, n)
    rng = np.random.RandomState(0)
    centroids = features[rng.permutation(n)[:nb]].copy()

    def sq_dists(c: np.ndarray) -> np.ndarray:
        d2 = (
            (features * features).sum(1)[:, None]
            + (c * c).sum(1)[None, :]
            - 2.0 * features @ c.T
        )
        return np.maximum(d2, 0.0)

    for _ in range(iters):
        assign = sq_dists(centroids).argmin(axis=1)
        for c in range(nb):
            members = features[assign == c]
            if len(members):
                centroids[c] = members.mean(axis=0)
    d2 = sq_dists(centroids)
    assign = d2.argmin(axis=1)
    pop = np.bincount(assign, minlength=nb)
    order = np.argsort(d2, axis=0, kind="stable")
    taken = np.zeros(n, bool)
    chosen = np.empty(nb, np.int64)
    for rank, c in enumerate(np.argsort(-pop, kind="stable")):
        for i in order[:, c]:
            if not taken[i]:
                chosen[rank] = i
                taken[i] = True
                break
    return chosen


_METHODS: Dict[str, Callable[..., np.ndarray]] = {
    "barycenter": herd_barycenter,
    "random": herd_random,
    "cluster": herd_cluster,
}


class RehearsalMemory:
    """Budgeted exemplar store, class -> ``(x, y, t)`` in herding-rank order."""

    def __init__(
        self,
        memory_size: int = 2000,
        herding_method="barycenter",
        fixed_memory: bool = False,
        nb_total_classes: Optional[int] = None,
    ):
        if isinstance(herding_method, str):
            if herding_method not in _METHODS:
                raise ValueError(
                    f"unknown herding_method {herding_method!r}; "
                    f"options: {sorted(_METHODS)} or a callable"
                )
            herding_method = _METHODS[herding_method]
        self.herd = herding_method
        self.memory_size = memory_size
        self.fixed_memory = fixed_memory
        if fixed_memory and not nb_total_classes:
            raise ValueError("fixed_memory=True requires nb_total_classes")
        self.nb_total_classes = nb_total_classes
        self._store: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}

    @property
    def nb_classes(self) -> int:
        return len(self._store)

    def __len__(self) -> int:
        return sum(len(v[1]) for v in self._store.values())

    def quota(self, nb_seen_classes: int) -> int:
        if self.fixed_memory:
            return self.memory_size // int(self.nb_total_classes)
        return self.memory_size // max(nb_seen_classes, 1)

    def add(
        self,
        x: np.ndarray,
        y: np.ndarray,
        t: Optional[np.ndarray],
        features: np.ndarray,
    ) -> None:
        y = np.asarray(y)
        features = np.asarray(features)
        if t is None:
            t = np.full(len(y), -1, np.int64)
        seen_classes = np.unique(y)
        nb_after = len(set(self._store) | {int(c) for c in seen_classes})
        q = self.quota(nb_after)
        for c in seen_classes:
            idx = np.where(y == c)[0]
            if self.herd is herd_random:
                rank = herd_random(features[idx], q, seed=int(c) + 1)
            else:
                rank = self.herd(features[idx], q)
            keep = idx[rank]
            self._store[int(c)] = (x[keep].copy(), y[keep].copy(), np.asarray(t)[keep].copy())
        # Shrink every class to the (possibly reduced) quota; rank order
        # makes truncation keep the best exemplars.
        for c, (cx, cy, ct) in list(self._store.items()):
            self._store[c] = (cx[:q], cy[:q], ct[:q])

    def get(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if not self._store:
            raise ValueError("memory is empty")
        xs, ys, ts = zip(*(self._store[c] for c in sorted(self._store)))
        return np.concatenate(xs), np.concatenate(ys), np.concatenate(ts)
