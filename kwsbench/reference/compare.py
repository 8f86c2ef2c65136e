"""The comparisons that decide ``correct``: each number the program's output gives against the reference.

Training (``leaf_gaps``): for each leaf, the gap between the program's norm
and the reference's, over the larger of the reference's norm of that leaf
and the median leaf's norm; the worst leaf's, or the median leaf's (the
driver takes both from ``leaf_gaps``). Leaves whose reference
gradient is under a thousandth of the median leaf's are left out
(``live_leaves``): there round-off alone moves them.

Scoring: every logit gap over the RMS of the reference's logits, the
largest (``logit_gap``) and the median row's largest (``row_gap``).
"""

from __future__ import annotations

import statistics

import torch

DEAD_LEAF = 1e-3  # a leaf whose reference gradient norm is under this share of the median leaf's


def norms(leaves: dict) -> dict[str, float]:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def live_leaves(ref_grads: dict) -> list[str]:
    n = norms(ref_grads)
    floor = DEAD_LEAF * statistics.median(n.values())
    return [k for k, v in n.items() if v >= floor]


def leaf_gaps(prog: dict, ref: dict, leaves: list[str]) -> dict[str, float]:
    """Each leaf's ``| |prog| - |ref| | / max(|ref|, median leaf's |ref|)``."""
    p, r = norms({k: prog[k] for k in leaves}), norms({k: ref[k] for k in leaves})
    floor = statistics.median(r.values())
    return {k: abs(p[k] - r[k]) / max(r[k], floor) for k in leaves}


def loss_gap(prog: list[float], ref: list[float]) -> float:
    """The largest relative gap of the steps' losses."""
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref, strict=True))


def logit_gaps(prog: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(largest, median row's largest) absolute logit gap over the RMS of ``ref``'s logits."""
    rms = float(ref.double().pow(2).mean().sqrt())
    row = (prog.double() - ref.double()).abs().amax(dim=1) / rms
    return float(row.max()), float(row.median())
