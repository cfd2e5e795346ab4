"""The comparison that decides `correct`: the port's readings of three
steps against the reference's (reference.py), twice: the first three
steps of the run, from the seed's weights, and the three steps that
follow the window, from the port's state as it was read after the window
(port.late_readings), whose numbers carry the prefix `late_`. Each number
below is a relative gap; the cell's `limits/<workload>.json` names the
numbers it compares and the limit of each, and `correct` needs every one
of them at or under its limit. A leaf's gap is |port's norm -
reference's| over the larger of the reference's norm of that leaf and of
the median leaf.

  grad_gap          the median dense leaf's gap in the first gradient
                    (worked out from the change after step 1,
                    reference.py; first steps only);
  change_gap        the median dense leaf's gap in the change after three
                    steps, over the leaves whose exact reference gradient
                    is at least MOVE_RULE of the median leaf's: a leaf with
                    a smaller gradient moves by round-off alone;
  change_gap_wide_leaf  the worst of those leaves' gaps, over the leaves
                    of more than one element: a fault in any one of them
                    shows here, where the median would pass it;
  table_change_gap  the worst large table's gap in the change;
  table_change_pooled_gap  the large tables' change taken together, for
                    tables whose rows move by stochastic rounding: one
                    table's change is then a count of a few dozen one-step
                    moves, whose chance swings it by tens of percent.

Read but compared by no cell (PERF.md gives why): `loss_gap`, the widest
of the three steps' |loss - reference| / reference, and
`grad_gap_worst_leaf`, `change_gap_worst_leaf`, the worst dense leaf's
gaps over every leaf, which the final layer's one-element bias sets most
often: its gradient, the batch's mean of sigmoid(z) - y, reads 0.002-0.06
where each term is about 0.5, and after the window, once the model has
learned the labels' rate, less.

A dense leaf is a parameter of the port (by its name), a large table is
`table_<feature>`. A compared number with no limit fails.
"""

from __future__ import annotations

import math

from benchmark.reference import Readings, median

_CHANGE = ("change_gap", "change_gap_wide_leaf", "table_change_gap",
           "table_change_pooled_gap", "loss_gap", "change_gap_worst_leaf")
NUMBERS = (("grad_gap", "grad_gap_worst_leaf") + _CHANGE
           + tuple(f"late_{n}" for n in _CHANGE))
MOVE_RULE = 1e-3


def _gaps(prog: dict, ref: dict, leaves) -> dict[str, float]:
    """Each leaf's gap, over the larger of its own and the median leaf's
    reference norm."""
    leaves = list(leaves)
    floor = median(ref[k] for k in leaves)
    out = {}
    for k in leaves:
        denom = max(ref[k], floor)
        gap = (abs(prog[k] - ref[k]) / denom if denom > 0
               else (0.0 if prog[k] == ref[k] else math.inf))
        out[k] = gap if math.isfinite(prog[k]) else math.inf
    return out


def _worst(gaps: dict[str, float]) -> dict:
    at = max(gaps, key=gaps.__getitem__)
    return {"value": gaps[at], "at": at}


def _median(gaps: dict[str, float]) -> dict:
    """The median leaf's gap; infinite where any leaf's is."""
    values = list(gaps.values())
    return {"value": (median(values) if all(map(math.isfinite, values))
                      else math.inf),
            "at": f"median of {len(gaps)} leaves"}


def _pooled(norms: dict, leaves) -> float:
    return math.sqrt(sum(norms[k] ** 2 for k in leaves))


def numbers(prog: Readings, ref: Readings, prefix: str = ""
            ) -> dict[str, dict]:
    """{number: {"value", "at"}} of the port's readings against the
    reference's: every number of NUMBERS that the readings hold (the first
    gradient's only where the port's readings give it), each name after
    `prefix`."""
    if set(prog.change_norms) != set(ref.change_norms):
        raise ValueError("the port's leaves are not the reference's")
    loss_gaps = [abs(p - r) / abs(r) if math.isfinite(p) else math.inf
                 for p, r in zip(prog.losses, ref.losses)]
    step = max(range(len(loss_gaps)), key=loss_gaps.__getitem__)
    tables = [k for k in ref.change_norms if k.startswith("table_")]
    dense = [k for k in ref.change_norms if k not in tables]
    floor = median(ref.grad_exact[k] for k in dense)
    moving = [k for k in dense if ref.grad_exact[k] >= MOVE_RULE * floor]
    change = _gaps(prog.change_norms, ref.change_norms, moving)
    wide = {k: v for k, v in change.items() if ref.sizes[k] > 1}
    p, r = _pooled(prog.change_norms, tables), _pooled(ref.change_norms,
                                                         tables)
    pooled = abs(p - r) / r if math.isfinite(p) else math.inf
    out = {
        "change_gap": _median(change),
        "change_gap_wide_leaf": _worst(wide),
        "table_change_gap": _worst(_gaps(prog.change_norms,
                                         ref.change_norms, tables)),
        "table_change_pooled_gap": {"value": pooled,
                                    "at": f"{len(tables)} tables"},
        "loss_gap": {"value": loss_gaps[step], "at": f"step {step + 1}"},
        "change_gap_worst_leaf": _worst(change),
    }
    if prog.grad_norms:
        if set(prog.grad_norms) != set(ref.grad_norms):
            raise ValueError("the port's leaves are not the reference's")
        grad = _gaps(prog.grad_norms, ref.grad_norms, dense)
        out["grad_gap"] = _median(grad)
        out["grad_gap_worst_leaf"] = _worst(grad)
    return {prefix + k: v for k, v in out.items()}


def judge(found: dict[str, dict], limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit", "at"}}) over the numbers the
    limits name."""
    compared = [n for n in NUMBERS if n in limits]
    if not compared:
        raise ValueError("the limits name no number to compare")
    out, ok = {}, True
    for name in compared:
        limit = limits[name]
        got = found.get(name, {"value": math.inf, "at": "not read"})
        ok = ok and limit is not None and got["value"] <= limit
        out[name] = {"value": got["value"], "limit": limit, "at": got["at"]}
    return ok, out


def lines(compared: dict) -> list[str]:
    """The numbers beside their limits, one plain line each."""
    out = []
    for name, v in compared.items():
        ok = v["limit"] is not None and v["value"] <= v["limit"]
        out.append(f"check {name} {v['value']!r} limit {v['limit']!r} "
                   f"({v['at']}) {'ok' if ok else 'FAIL'}")
    return out
