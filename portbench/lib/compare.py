"""The comparison that decides ``correct``: the program's records against
the reference's, unit by unit (a unit is keyed by its position and
UMI), and each number beside its limit."""

from __future__ import annotations

import numpy as np

# the numbers compared, in the order they are printed
NUMBERS = ("unit_mismatch", "depth_mismatch", "base_mismatch_share", "qual_mismatch_share")


def compare(expected: dict, observed: dict) -> dict:
    """Counts over the units of ``expected`` and of ``observed`` (which
    the caller limits to the same reads): units on one side only, units
    whose depths (cD, cM) differ, and the shares of the matched units'
    cycles whose base, or quality, differs."""
    missing = extra = depth = cycles = base = qual = 0
    for key in expected.keys() | observed.keys():
        e = sorted(expected.get(key, []), key=lambda r: r[0].tobytes())
        o = sorted(observed.get(key, []), key=lambda r: r[0].tobytes())
        missing += max(0, len(e) - len(o))
        extra += max(0, len(o) - len(e))
        for (eb, eq, ed, em), (ob, oq, od, om) in zip(e, o):
            if len(eb) != len(ob):
                missing += 1
                extra += 1
                continue
            depth += (ed, em) != (od, om)
            cycles += len(eb)
            base += int(np.count_nonzero(eb != ob))
            qual += int(np.count_nonzero(eq != oq))
    return {
        "units": sum(len(v) for v in expected.values()),
        "unit_mismatch": missing + extra,
        "depth_mismatch": depth,
        "base_mismatch_share": base / max(cycles, 1),
        "qual_mismatch_share": qual / max(cycles, 1),
    }


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or below its
    limit, and at least one unit compared."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    ok = numbers["units"] > 0 and all(c["value"] <= c["limit"] for c in checks.values())
    # a lower limit: at least one unit compared
    checks["units_compared"] = {"value": numbers["units"], "limit": 1}
    return ok, checks
