"""The comparison that decides ``correct``: a result's rows against the
plain reference's, on one process's share and then summed over the
processes.

A process holds the rows of some keys. It takes the reference's rows
of those keys, puts both in one canonical order (the workload's
``sort_columns``, compared as values) and counts:

* ``rows_gap``: |all processes' rows - the reference's rows| (after
  the sum over processes);
* ``mismatched``: rows whose ``exact_columns`` differ bit for bit, or
  every row of a process whose row count differs from the reference's
  rows of its keys;
* ``gap``: the largest |program - reference| / scale over the
  ``gap_columns``, the scale being the reference's sum of |x| of the
  group (inf where the rows do not line up).

Together they catch a missing, an extra and an altered row: a key held
by no process shows in ``rows_gap``, a key held twice too. Nothing here
imports the program.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

TINY = 1e-300


def canonical_order(cols: List[torch.Tensor], by: List[int]) -> torch.Tensor:
    """The permutation that sorts rows lexicographically by the columns
    ``by`` (the first the most significant)."""
    n = len(cols[0]) if cols else 0
    perm = torch.arange(n, device=cols[0].device if cols else "cpu")
    for i in reversed(by):
        _, p = torch.sort(cols[i][perm], stable=True)
        perm = perm[p]
    return perm


def _bits(x: torch.Tensor) -> torch.Tensor:
    if x.is_floating_point():
        return x.to(torch.float64).view(torch.int64)
    return x.to(torch.int64)


def local_numbers(prog: List[torch.Tensor], ref: List[torch.Tensor],
                  scales: List[Optional[torch.Tensor]], spec: dict
                  ) -> Dict[str, float]:
    """One process's counts: its rows, its mismatched rows, its gap."""
    if len(prog) != len(ref):
        return {"rows": float(len(prog[0]) if prog else 0),
                "mismatched": float(len(ref[0])), "gap": float("inf")}
    key = spec["key_column"]
    sel = torch.isin(ref[key], torch.unique(prog[key]))
    ref = [c[sel] for c in ref]
    scales = [None if s is None else s[sel] for s in scales]
    n_p, n_r = len(prog[key]), len(ref[key])
    out = {"rows": float(n_p)}
    if n_p != n_r:
        out["mismatched"] = float(max(n_p, n_r))
        out["gap"] = float("inf") if spec.get("gap_columns") else 0.0
        return out
    pp = canonical_order(prog, spec["sort_columns"])
    rp = canonical_order(ref, spec["sort_columns"])
    bad = torch.zeros(n_p, dtype=torch.bool, device=prog[key].device)
    for i in spec["exact_columns"]:
        bad |= _bits(prog[i][pp]) != _bits(ref[i][rp])
    out["mismatched"] = float(bad.sum())
    gap = 0.0
    for i in spec.get("gap_columns", []):
        d = (prog[i][pp].to(torch.float64) - ref[i][rp].to(torch.float64))
        rel = torch.nan_to_num(d.abs() / scales[i][rp].clamp_min(TINY),
                               nan=float("inf"))
        if len(rel):
            gap = max(gap, float(rel.max()))
    out["gap"] = gap
    return out


def numbers(summed: Dict[str, float], ref_rows: int, spec: dict
            ) -> Dict[str, float]:
    """The compared numbers from the sums over processes."""
    out = {"rows_gap": abs(summed["rows"] - ref_rows),
           "mismatched": summed["mismatched"]}
    if spec.get("gap_columns"):
        out["gap"] = summed["gap"]
    return out


def verdict(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(nums[k] <= limits[k] for k in nums)
