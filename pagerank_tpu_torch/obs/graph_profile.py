"""The rank-mass ledger: ``ledger_tolerance`` and
``mass_ledger_entry``, copied from ``pagerank_tpu/obs/graph_profile.py:
77-80, 589-676`` (only these; the graph profile itself is ROADMAP slice
8). The SDC guard (``sdc.py``) reconciles each checked step through
them.
"""

from __future__ import annotations

import math
from typing import Dict

#: Ledger reconciliation tolerance factor: relative tolerance is
#: ``LEDGER_TOL_FACTOR * eps(accum dtype) * sqrt(n)`` — the sqrt(n)
#: absorbs the reduction-order error of an n-term sum while staying
#: orders of magnitude below any real mass bug (a wrong weight or mask
#: moves whole rank fractions, not ulps).
LEDGER_TOL_FACTOR = 64.0


def ledger_tolerance(eps: float, n: int,
                     tol_factor: float = LEDGER_TOL_FACTOR) -> float:
    """Relative reconciliation tolerance for an n-vertex mass sum in a
    dtype with machine epsilon ``eps`` (see LEDGER_TOL_FACTOR)."""
    return tol_factor * float(eps) * max(1.0, math.sqrt(max(1, n)))


def mass_ledger_entry(*, damping: float, semantics: str, n: int,
                      eps: float, mass_prev: float, mass: float,
                      dangling_mass: float, contrib_total: float,
                      retained_total: float = 0.0,
                      tol_factor: float = LEDGER_TOL_FACTOR,
                      flow_slack: float = 0.0
                      ) -> Dict[str, object]:
    """One probe iteration's exact mass decomposition + reconciliation.

    The update (models/pagerank.apply_update) sums to

      textbook:  mass' = (1-d)      + d*contrib_total + d*m
      reference: mass' = (1-d)*n    + d*contrib_total
                         + d*retained_total + d*m

    where every right-hand term except the teleport is MEASURED inside
    the step (``step_probed`` ledger sums). Two reconciliations, each
    with a named leak:

      - **identity residual**: measured ``mass`` minus the term sum.
        The teleport term is the only one derived from the formula
        rather than measured, so a violation is attributed to
        ``teleport`` (the epilogue/mask path — e.g. a wrong valid
        mask zeroing live lanes).
      - **flow conservation** (textbook only, where the dangling mask
        IS out_degree == 0): every unit of ``mass_prev`` must leave
        through links or the dangling pool —
        ``unaccounted = mass_prev - m - contrib_total``. Positive
        unaccounted means mass silently fell out of the flow (a
        ``dangling``-mask leak: a sink vertex the mask misses);
        negative means the edges CREATED mass (a ``link`` leak: bad
        weights / duplicated slots). Reference semantics deliberately
        does not conserve mass (the zero-in retention re-feeds old
        rank, module docstring of models/pagerank), so only the
        identity check applies there.

    All residuals are reported relative to the mode's expected total
    (1 textbook, n reference). ``leak`` is the worst offender's name,
    None when the ledger reconciles within :func:`ledger_tolerance`.

    ``flow_slack`` (mass units) widens ONLY the flow-
    conservation check: under the stale-boundary step
    (config.halo_async) the measured contribution total mixes this
    iteration's own-block mass with LAST iteration's boundary mass,
    so flow conservation holds up to the previous step's L1 delta —
    the caller passes that bound and the check stays sharp as the
    solve converges (slack -> 0 with delta). The identity residual
    needs no slack: the update consumed the same measured contrib the
    ledger reports, stale or not.
    """
    reference = semantics == "reference"
    scale = float(n) if reference else 1.0
    teleport = (1.0 - damping) * scale
    link = damping * contrib_total
    retained = damping * retained_total if reference else 0.0
    dangling_term = damping * dangling_mass
    total = teleport + link + retained + dangling_term
    tol = ledger_tolerance(eps, n, tol_factor)
    residual = (mass - total) / scale
    violations = {}
    if abs(residual) > tol:
        violations["teleport"] = abs(residual)
    unaccounted = None
    if not reference:
        unaccounted = (mass_prev - dangling_mass - contrib_total) / scale
        flow_tol = tol + abs(flow_slack) / scale
        if unaccounted > flow_tol:
            violations["dangling"] = abs(unaccounted)
        elif unaccounted < -flow_tol:
            violations["link"] = abs(unaccounted)
    leak = (max(violations, key=violations.get) if violations else None)
    return {
        "mass_prev": float(mass_prev),
        "mass": float(mass),
        "normalized_mass": float(mass / scale),
        "teleport_mass": float(teleport / scale),
        "link_mass": float(link / scale),
        "retained_mass": float(retained / scale),
        "dangling_mass": float(dangling_term / scale),
        "residual": float(residual),
        "unaccounted": (float(unaccounted)
                        if unaccounted is not None else None),
        "tol": float(tol),
        "leak": leak,
        "ok": leak is None,
    }
