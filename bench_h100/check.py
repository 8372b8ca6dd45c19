"""The comparison that decides ``correct``.

A run is a stateful time loop, like a training run: set-up builds the
solver, drives it from the seed's state through its first ``CHECKED_STEPS``
steps with the window's own calls (``run``, the captured step; the monitor
row after them), and hands that same solver to the window.  The
reference, plain PyTorch in float64 (reference/), follows those steps from
the same state on the card once the window has closed, and the program's
outputs are held against it:

- ``step``: the state after the steps, by the worst field: the gap
  between the program's state and the reference's, in L2 over every
  solution point, over the L2 of the reference's state;
- ``row``: the monitor's L1 residual row of that state, the median
  field's relative gap (the worst field's swings from seed to seed where
  a field's residual is small: the channel's z-momentum row, which only
  the perturbation feeds, read 5.65e-5 to 2.32e-3 over 13 seeds while the
  median field read 1.23e-5 to 2.1e-5; PERF.md);
- ``ke`` (where the monitor integrates it): the row's kinetic energy, the
  workshop's dissipation curve, its relative gap to the reference's;
- ``avg`` (with running averages): each average's gap, as ``step``.

Each number has its limit in the configuration's file (``limits``), set
between the sound program's readings over a dozen seeds and more and the
lower-precision control's (PERF.md).  A run whose window wrote a
non-finite monitor row, or whose state went non-finite, is not correct.
"""

from __future__ import annotations

import numpy as np

CHECKED_STEPS = 2

AVERAGED = {"rho_average": lambda u: u[0], "u_average": lambda u: u[1] / u[0],
            "v_average": lambda u: u[2] / u[0],
            "w_average": lambda u: u[3] / u[0],
            "e_average": lambda u: u[4] / u[0]}


def _l2(x):
    return float(np.sqrt(np.sum(np.square(x, dtype=np.float64))))


def fields(got, ref, start):
    """Each field's (gap over the reference's values, the reference's
    departure from ``start`` over its values)."""
    return [(_l2(g - r) / _l2(r), _l2(r - s) / _l2(r))
            for g, r, s in zip(got, ref, start)]


def numbers(u0, prog: dict, ref: dict, average_fields=()) -> dict:
    """The compared numbers of the program's outputs ``prog`` against the
    reference's ``ref`` (dicts of u, row, ke and avg), from the start
    ``u0``."""
    out = {"step": max(a for a, _ in fields(prog["u"], ref["u"], u0)),
           "row": float(np.median(np.abs(prog["row"] - ref["row"])
                                  / np.abs(ref["row"])))}
    if ref.get("ke") is not None:
        got = prog.get("ke")
        out["ke"] = (float("nan") if got is None
                     else abs(got - ref["ke"]) / abs(ref["ke"]))
    if ref.get("avg") is not None:
        start = [AVERAGED[f](u0) for f in average_fields]
        out["avg"] = max(a for a, _ in fields(prog["avg"], ref["avg"],
                                              start))
    return out


def verdict(values: dict, limits: dict) -> bool:
    """Every number finite and within its limit (a number without one is
    not within it)."""
    return all(k in limits and np.isfinite(v) and v <= limits[k]
               for k, v in values.items())
