"""The numbers that decide ``correct``: the program's readings of its
first rounds against the reference's, each held to its limit from the
workload file.

* ``loss``: the largest relative gap of a round's loss;
* ``grad1``: the worst leaf's gap between the norms of the first moment
  after round 1 (the gradient as the optimizer got it, times 1 − β1),
  over the larger of the reference's norm of that leaf and of the median
  leaf;
* ``grad1_mid``: the median leaf's such gap, over the leaves whose
  reference gradient is not nought to rounding (steady from seed to seed
  where one small leaf's gap swings);
* ``change<R>``: the same of each leaf's change over the R rounds
  followed (three, or the traffic's ``rounds``), leaving out the leaves
  whose reference gradient is nought to rounding (a first moment under a
  thousandth of the median leaf's, as a key's bias is under softmax);
* ``age<R>``: the share of real coordinates whose age after round R
  differs (the selections of the rounds after the first);
* ``state<R>``: the worst leaf's relative L2 distance of the carried
  gradient and of the residual after round R, over the larger of the
  reference's norm of that leaf and of the median leaf;
* ``state<R>_agreed``: the same over the coordinates whose ages agree
  after round R (both sides last selected them in the same round), so
  that a coordinate selected on one side only does not count;
* ``state<R>_agreed_mid``: the median leaf's such gap of the carried
  gradient, over the leaves whose reference gradient is not nought to
  rounding (steady where one small leaf's gap swings);
* ``theta<R>``: the gap of the carried thresholds after round R (the
  ones round R used): θ_M's relative gap, or θ_A's absolute gap in
  rounds, whichever is larger;
* ``streak<R>``: the gap of the carried streak of on-track rounds after
  round R (the warm-corrected thresholds' trust gate)."""

from __future__ import annotations

import math
import statistics
from typing import Any, Dict, List, Optional

import torch

ZERO_GRAD = 1e-3


def _gaps(prog: List[float], ref: List[float],
          keep: Optional[List[bool]] = None) -> List[float]:
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    med = statistics.median([ref[i] for i in idx])
    return [abs(prog[i] - ref[i]) / max(ref[i], med, 1e-30) for i in idx]


def state_gaps(prog: Dict, ref: Dict, agreed: bool = False) -> List:
    """(key/path, gap) of every leaf of the carried gradient and residual:
    the relative L2 distance over the larger of the reference's norm of
    that leaf and of the median leaf."""
    rows = []
    keep = (prog["age"] == ref["age"]) if agreed else None
    for key in ("g", "res"):
        if ref.get(key) is None:
            continue
        a, b = prog[key].float(), ref[key].float()
        if keep is not None:
            a, b = a * keep, b * keep
        diff, norm = [], []
        for o, n in zip(ref["offsets"], ref["sizes"]):
            diff.append(float(torch.linalg.vector_norm(a[o:o + n] - b[o:o + n])))
            norm.append(float(torch.linalg.vector_norm(b[o:o + n])))
        med = statistics.median(norm)
        rows += [(f"{key}:{path}", d / max(r, med, 1e-30))
                 for path, d, r in zip(ref["paths"], diff, norm)]
    return rows


def numbers(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """Every number the readings allow."""
    out: Dict[str, float] = {}
    if ref["loss"]:
        out["loss"] = max(abs(p - r) / abs(r)
                          for p, r in zip(prog["loss"], ref["loss"]))
    med = statistics.median(ref["m1"])
    moved = [m >= ZERO_GRAD * med for m in ref["m1"]]
    out["grad1"] = max(_gaps(prog["m1"], ref["m1"]))
    out["grad1_mid"] = statistics.median(_gaps(prog["m1"], ref["m1"], moved))
    r = ref["rounds"]
    out[f"change{r}"] = max(_gaps(prog["change"], ref["change"], moved))
    valid = ref["valid"]
    diff = (prog["age"] != ref["age"]) & valid
    out[f"age{r}"] = float(diff.sum()) / float(valid.sum())
    out[f"state{r}"] = max(g for _, g in state_gaps(prog, ref))
    agreed = state_gaps(prog, ref, True)
    out[f"state{r}_agreed"] = max(g for _, g in agreed)
    out[f"state{r}_agreed_mid"] = statistics.median(
        g for (_, g), m in zip(agreed, moved) if m)
    pc, rc = ({k: float(v) for k, v in side["carried"].items()}
              for side in (prog, ref))
    out[f"theta{r}"] = max(
        abs(pc["theta_m"] - rc["theta_m"]) / max(rc["theta_m"], 1e-30),
        abs(pc["theta_a"] - rc["theta_a"]))
    out[f"streak{r}"] = abs(pc["streak"] - rc["streak"])
    return out


def leaf_gaps(prog: Dict[str, Any], ref: Dict[str, Any], key: str = "m1",
              top: int = 5) -> List:
    """The leaves with the widest gaps of ``key``'s norms: (path, gap,
    the leaf's reference norm over the median leaf's)."""
    med = statistics.median(ref[key])
    rows = [(path, abs(p - r) / max(r, med, 1e-30), r / med)
            for path, p, r in zip(ref["paths"], prog[key], ref[key])]
    return sorted(rows, key=lambda x: -x[1])[:top]


def judge(values: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """{name: {"value", "limit"}} for each limited number."""
    return {k: {"value": values.get(k, math.inf), "limit": lim}
            for k, lim in limits.items()}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())
