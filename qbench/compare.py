"""How an answer is held against the reference.

Three numbers, each against a limit that the traffic file states:

- ``keys_off``: groups whose keys differ from the reference's (or are
  missing or extra), and bins whose emptiness (NaN) differs; exact, limit 0.
- ``exact_off``: entries of integer sums, counts and extremes that differ;
  exact, limit 0.
- ``float_rel_err``: the largest gap of a float sum or mean, relative to
  the reference's value or to the median magnitude of that answer column,
  whichever is larger: |got - want| / max(|want|, median |want|).  A group
  whose few rows sum to almost nothing would otherwise weigh a rounding
  gap of the size of its neighbours' values as a large relative error.
"""

from __future__ import annotations

import numpy as np

NUMBERS = ("keys_off", "exact_off", "float_rel_err")


def compare(got, want, kinds):
    """The three numbers for one answer."""
    out = {"keys_off": 0, "exact_off": 0, "float_rel_err": 0.0}
    keys = [c for c, k in kinds.items() if k == "key"]
    rows = slice(None)
    if keys:
        n_got, n_want = len(got[keys[0]]), len(want[keys[0]])
        if n_got != n_want:
            out["keys_off"] = max(n_got, n_want)
            return out
        same = np.ones(n_want, bool)
        for c in keys:
            same &= np.asarray(got[c]) == np.asarray(want[c])
        out["keys_off"] = int((~same).sum())
        rows = same
    for c, kind in kinds.items():
        if kind == "key":
            continue
        g, w = np.asarray(got[c])[rows], np.asarray(want[c])[rows]
        if g.shape != w.shape:
            out["keys_off"] += max(g.size, w.size)
            continue
        if kind == "exact":
            out["exact_off"] += int((g != w).sum())
            continue
        g, w = g.astype(np.float64), w.astype(np.float64)
        if kind == "float_nan":
            empty = np.isnan(w)
            out["keys_off"] += int((np.isnan(g) != empty).sum())
            g, w = g[~empty & ~np.isnan(g)], w[~empty & ~np.isnan(g)]
        scale = np.maximum(np.abs(w), np.median(np.abs(w)) if w.size else 0.0)
        with np.errstate(invalid="ignore", divide="ignore"):
            rel = np.abs(g - w) / np.where(scale != 0, scale, 1.0)
        rel = np.where(np.isnan(rel), np.inf, rel)
        out["float_rel_err"] = max(out["float_rel_err"], float(rel.max(initial=0.0)))
    return out


def fold(readings):
    """The numbers of many answers as one reading: counts add up, the
    relative gap is the widest."""
    out = {"keys_off": 0, "exact_off": 0, "float_rel_err": 0.0}
    for r in readings:
        out["keys_off"] += r["keys_off"]
        out["exact_off"] += r["exact_off"]
        out["float_rel_err"] = max(out["float_rel_err"], r["float_rel_err"])
    return out


def within(numbers, limits):
    return all(numbers[k] <= limits[k] for k in NUMBERS)
