"""The numbers that decide ``correct``, and the judgement against the
cell's limits (``workloads/<cell>.json``).

Training: each of the first steps' losses (``loss_gap``: the worst of
the traffic's loss terms over the steps; the first step's alone,
``loss_gap_first``; each term, ``<term>_gap`` and ``<term>_gap_first``), the first gradient's norm of every leaf, and every leaf's change after those steps, the port's against
the plain reference's, taken by the worst leaf (``*_gap``) and by the
median leaf (``*_gap_median``): the gap between the two norms over the
reference's norm of that leaf or of the median leaf, whichever is larger. Leaves whose reference gradient is under a thousandth
of the median leaf's move by round-off alone under Adam and are left out
of the change (``negligible``); buffers, which have no gradient, stay in.
And how many latent rows the steps gave a code (the port's usage
histogram over the steps against the reference's count), exactly
(``usage_gap``).

Tokens: for every row, how far the port's code lies from the reference's
nearest one, in the reference's own latents and in float64, as a share of
the distance between the nearest code and the median code of that row.
Images: the widest gap between the port's uint8 pixels and the
reference's float pixels, in pixel units (0-255).
"""

from __future__ import annotations

import statistics

import torch

NEGLIGIBLE = 1e-3


def _median(values) -> float:
    return statistics.median(values) if values else 0.0


def leaf_gaps(got: dict, want: dict, leaves) -> list:
    """|got - want| / max(want, median of want) for each of ``leaves``."""
    leaves = list(leaves)
    med = _median([want[k] for k in leaves])
    return [abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in leaves]


def negligible(first_grads: dict) -> set:
    """Leaves whose first gradient is under ``NEGLIGIBLE`` of the median's."""
    med = _median(list(first_grads.values()))
    return {k for k, v in first_grads.items() if v < NEGLIGIBLE * med}


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` / ``ref``: {"losses": [per step {name: float}], "grads":
    {leaf: first gradient norm}, "changes": {leaf: norm of the change},
    "usage_total": latent rows given a code over the steps}."""
    steps = [{name: abs(p_step[name] - r) / max(abs(r), 1e-30)
              for name, r in r_step.items() if not (name == "r1_penalty" and r == 0)}
             for p_step, r_step in zip(prog["losses"], ref["losses"], strict=True)]
    terms = {}
    for name in steps[0]:
        if name != "loss":
            terms[f"{name}_gap"] = max(s[name] for s in steps if name in s)
            terms[f"{name}_gap_first"] = steps[0][name]
    skip = negligible(ref["grads"])
    grads = leaf_gaps(prog["grads"], ref["grads"], ref["grads"])
    moved = leaf_gaps(prog["changes"], ref["changes"],
                      [k for k in ref["changes"] if k not in skip])
    usage = abs(prog["usage_total"] - ref["usage_total"]) / max(ref["usage_total"], 1)
    return {"usage_gap": usage, "loss_gap": max(max(s.values()) for s in steps),
            "loss_gap_first": max(steps[0].values()), **terms,
            "grad_gap": max(grads), "grad_gap_median": _median(grads),
            "change_gap": max(moved), "change_gap_median": _median(moved)}


@torch.no_grad()
def code_gap(latents: torch.Tensor, codebook: torch.Tensor, codes: torch.Tensor,
             block: int = 8192) -> dict:
    """``latents`` (M, D): the reference's; ``codes`` (M,): the port's.
    -> {"code_gap": the widest share, over rows, of (d(port's code) -
    d(nearest)) / (d(median code) - d(nearest)); "codes_differing": the
    share of rows whose code is not the reference's nearest}."""
    cb = codebook.double()
    c2 = (cb * cb).sum(1)
    widest, differing = 0.0, 0
    for lo in range(0, latents.shape[0], block):
        x = latents[lo:lo + block].double()
        d = c2[None] - 2 * x @ cb.T
        best, nearest = d.min(1)
        mid = d.median(1).values
        got = d.gather(1, codes[lo:lo + block].long()[:, None])[:, 0]
        widest = max(widest, float(((got - best) / (mid - best).clamp(min=1e-300)).max()))
        differing += int((codes[lo:lo + block].long() != nearest).sum())
    return {"code_gap": widest, "codes_differing": differing / latents.shape[0]}


def pixel_gap(prog_u8: torch.Tensor, ref01: torch.Tensor) -> dict:
    """-> {"pixel_gap": max |port - 255 ref|, "pixel_gap_mean": its mean}."""
    diff = (prog_u8.float() - ref01.float() * 255.0).abs()
    return {"pixel_gap": float(diff.max()), "pixel_gap_mean": float(diff.mean())}


def judge(numbers: dict, limits: dict) -> tuple:
    """-> (correct, checks): every number that has a limit, in the limits'
    order, as {name: {"value": v, "limit": l}}; correct iff each v <= l.
    A number that is missing or not finite fails."""
    checks, correct = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        checks[name] = {"value": value, "limit": limit}
        if value is None or not value <= limit:   # NaN fails too
            correct = False
    return correct, checks
