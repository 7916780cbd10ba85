"""The numbers that decide ``correct``, and their reading against limits.

A training cell compares the program's first steps with the reference's
from the same weights and inputs, leaf by leaf: the gap between the two
norms (not the norm of their difference) over the reference's norm of that
leaf or of the median leaf, whichever is larger, and the worst leaf. Leaves
whose reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out, by that rule and not by name.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Optional, Tuple

import torch

TINY_GRAD = 1e-3  # of the median leaf's gradient norm


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


def moving_leaves(ref_grad: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient norm is at least ``TINY_GRAD`` of
    the median leaf's."""
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= TINY_GRAD * med]


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   leaves: Iterable[str]) -> Tuple[float, Optional[str]]:
    """max over ``leaves`` of |prog - ref| / max(ref, median ref), and the
    leaf; a leaf missing on the program's side reads 1."""
    leaves = list(leaves)
    med = statistics.median(ref[k] for k in leaves)
    worst, which = 0.0, None
    for k in leaves:
        if k not in prog:
            return 1.0, k
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if gap > worst:
            worst, which = gap, k
    return worst, which


def leaf_diffs(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               leaves: Iterable[str]) -> Dict[str, float]:
    """Per leaf, the norm of the difference over the reference's norm,
    ||prog - ref|| / ||ref||; a leaf missing on the program's side reads 1."""
    out = {}
    for k in leaves:
        if k not in prog:
            out[k] = 1.0
            continue
        r = ref[k].double()
        out[k] = float((prog[k].double() - r).norm() / max(float(r.norm()),
                                                             1e-30))
    return out


def median(values: Dict[str, float]) -> float:
    return float(statistics.median(values.values()))


def loss_gap(prog: List[float], ref: List[float]) -> float:
    """max over steps of |prog - ref| / |ref|; a missing step reads 1."""
    if len(prog) != len(ref):
        return 1.0
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """(every number finite and within its limit, {name: value and limit});
    a number missing or not finite is not within its limit and is given as
    text, so that the line stays JSON."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        out[name] = {"value": v if v is None or math.isfinite(v) else str(v),
                     "limit": limit}
    return ok, out
