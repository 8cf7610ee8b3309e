"""What decides ``correct``: the numbers compared and their limits.

Training cells follow the port's first steps with the plain reference
(``reference/resnet.py``) from the same weights and the same batches and
compare (i) each step's loss, (ii) the first gradient as the optimizer
got it, read from the port's momentum after one step (``buf = g + wd*p``
from a zero buffer), leaf by leaf, and (iii) each parameter's change over
the steps, at the median and at the worst leaf.  A leaf's gap is ``| |a| - |r| |`` over the
larger of ``|r|`` and the median leaf's ``|r|``; leaves whose reference
gradient is under a thousandth of the median leaf's are left out.  Exact
comparisons (a feed that is not the benchmark's own data, a start that is
not its weights) have the limit 0."""

from __future__ import annotations

import math
import sys
from typing import Dict, List, Optional

import torch

Tensors = Dict[str, torch.Tensor]


def _norms(t: Tensors) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in t.items()}


def leaf_gap(prog: Tensors, ref: Tensors, keep: Optional[List[str]] = None) -> Dict[str, float]:
    pn, rn = _norms(prog), _norms(ref)
    keys = keep if keep is not None else list(ref)
    med = float(torch.tensor([rn[k] for k in keys]).median()) if keys else 0.0
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys}


def kept_leaves(grad_ref: Tensors) -> List[str]:
    rn = _norms(grad_ref)
    med = float(torch.tensor(list(rn.values())).median())
    return [k for k, v in rn.items() if v >= 1e-3 * med]


def training_numbers(losses_prog: List[float], losses_ref: List[float], grad1_prog: Tensors,
                     grad1_ref: Tensors, delta_prog: Tensors, delta_ref: Tensors) -> dict:
    """``loss_gap``: the worst step's relative loss gap; ``grad_gap``: the
    worst leaf's gap of the first gradient; ``delta_gap`` and
    ``delta_gap_worst``: the median and the worst leaf's gap of the change
    over the steps.  The first steps from a fresh network at the recipe's
    lr amplify round-off, so the worst leaf's gap (an early BN scale or
    shift) swings from seed to seed by several times; the median leaf's
    holds steady.  Both are held to a limit of their own."""
    keep = kept_leaves(grad1_ref)
    loss_gap = max(abs(a - r) / max(abs(r), 1e-30) for a, r in zip(losses_prog, losses_ref))
    if len(losses_prog) != len(losses_ref):
        loss_gap = float("inf")
    g = leaf_gap(grad1_prog, grad1_ref, keep)
    d = leaf_gap(delta_prog, delta_ref, keep)
    top = lambda x: sorted(x.items(), key=lambda kv: -kv[1])[:3]  # noqa: E731
    return {"loss_gap": loss_gap, "grad_gap": max(g.values()),
            "delta_gap": float(torch.tensor(list(d.values())).median()),
            "delta_gap_worst": max(d.values()),
            "_loss_gap_first": abs(losses_prog[0] - losses_ref[0]) / max(abs(losses_ref[0]), 1e-30),
            "_worst": {"grad": top(g), "delta": top(d),
                       "left_out": sorted(set(grad1_ref) - set(keep))}}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """``{"correct", "checks": {name: {"value", "limit"}}}``; a number
    missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        checks[name] = {"value": v if v is not None and math.isfinite(v) else None,
                        "limit": limit}
    return {"correct": ok, "checks": checks}


def print_checks(checks: dict) -> None:
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
