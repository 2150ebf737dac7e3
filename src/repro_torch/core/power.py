"""Power-aware elastic datacenter — ``power_batch``'s host side.

Copy of the numpy half of ``repro/core/power.py``: the power models and
their utilization tables (:func:`power_points`), the exact energy
decomposition (:func:`table_segment`, :func:`segment_energy_j`), the fleet
and demand-trace builders, the fault table, and the host-side finalizers.
Arithmetic and random draws keep the reference's order, so every table and
every finalized output is bit-identical.  The reference's OO manager has
no counterpart here.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .faults import FaultPlan


def interp_table(points: Sequence[float], util: float) -> float:
    """Piecewise-linear power lookup over evenly spaced utilization points.

    CloudSim's ``PowerModelSpecPower`` semantics: ``points[k]`` is the power
    at utilization ``k/(len-1)`` and intermediate utilizations interpolate
    linearly between the two enclosing measurements.

    (The elastic scenario's engines never call this inside their hot
    loops: they accumulate the exact :func:`table_segment` decomposition
    and finalize through :func:`segment_energy_j`, which reproduces this
    interpolation bit-for-bit — asserted by tests.)
    """
    u = min(max(util, 0.0), 1.0)
    n = len(points)
    x = u * (n - 1)
    k = min(int(x), n - 2)
    frac = x - k
    return points[k] + (points[k + 1] - points[k]) * frac


@dataclass
class PowerModelLinear:
    """P(u) = idle + (max-idle)·u — the standard CloudSim linear model."""
    idle_w: float = 86.0
    max_w: float = 117.0

    def power(self, util: float) -> float:
        u = min(max(util, 0.0), 1.0)
        return self.idle_w + (self.max_w - self.idle_w) * u


@dataclass
class PowerModelCubic:
    """P(u) = idle + (max-idle)·u³ — CloudSim's ``PowerModelCubic``
    (dynamic power ∝ V²f with both scaling with load)."""
    idle_w: float = 93.7
    max_w: float = 135.0

    def power(self, util: float) -> float:
        u = min(max(util, 0.0), 1.0)
        return self.idle_w + (self.max_w - self.idle_w) * u * u * u


@dataclass(frozen=True)
class PowerModelSpecTable:
    """SPECpower-style measured table: power at 0%, 10%, …, 100% load,
    linearly interpolated in between (``PowerModelSpecPower`` semantics)."""
    points: Tuple[float, ...]

    def __post_init__(self):
        object.__setattr__(self, "points",
                           tuple(float(p) for p in self.points))
        if len(self.points) < 2:
            raise ValueError("SPEC table needs ≥ 2 measurement points")

    def power(self, util: float) -> float:
        return interp_table(self.points, util)


# The two SPECpower_ssj2008 tables every CloudSim power example ships
# (Beloglazov & Buyya's evaluation hosts).
SPEC_HP_ML110_G4 = (86.0, 89.4, 92.6, 96.0, 99.5, 102.0, 106.0, 108.0,
                    112.0, 114.0, 117.0)
SPEC_HP_ML110_G5 = (93.7, 97.0, 101.0, 105.0, 110.0, 116.0, 121.0, 125.0,
                    129.0, 133.0, 135.0)


@dataclass(frozen=True)
class PowerModelDvfs:
    """Discrete-step DVFS: the host clocks at the lowest frequency step
    ``f ≥ u`` and dynamic power scales as ``f²·u`` (∝ V²f at proportional
    voltage).  Monotone non-decreasing in utilization: linear within a
    step, an upward jump at each step boundary.
    """
    idle_w: float = 86.0
    max_w: float = 117.0
    steps: Tuple[float, ...] = (0.4, 0.6, 0.8, 1.0)

    def __post_init__(self):
        object.__setattr__(self, "steps",
                          tuple(float(f) for f in self.steps))
        if not self.steps or tuple(sorted(self.steps)) != self.steps \
                or self.steps[-1] != 1.0:
            raise ValueError("DVFS steps must ascend and end at 1.0")

    def frequency(self, util: float) -> float:
        u = min(max(util, 0.0), 1.0)
        for f in self.steps:
            if f >= u:
                return f
        return self.steps[-1]

    def power(self, util: float) -> float:
        u = min(max(util, 0.0), 1.0)
        f = self.frequency(u)
        return self.idle_w + (self.max_w - self.idle_w) * (f * f) * u


def power_points(model, n_points: int = 11) -> List[float]:
    """Sample any power model onto an evenly spaced utilization table.

    The elastic-datacenter scenario evaluates *all* host power through
    :func:`interp_table` over these samples (its vec engine needs one
    uniform SoA representation); the models' own ``power()`` stays the
    ground truth for the consolidation workloads and the unit tests.
    """
    if n_points < 2:
        raise ValueError("n_points must be ≥ 2")
    return [model.power(k / (n_points - 1)) for k in range(n_points)]


def table_segment(util: float, n_points: int) -> Tuple[int, float]:
    """(segment index, fractional position) of a utilization in a table.

    The exact-summation decomposition behind the elastic scenario's energy
    accounting: interpolated power is ``t[s] + (t[s+1]-t[s])·frac``, so an
    engine only needs to *count* segment hits and *sum* fracs — both exact
    accumulations — and :func:`segment_energy_j` applies the table once at
    the end.  ``frac`` comes from ``fmod`` (exact in IEEE-754, and equal to
    the ``x - s`` the direct interpolation uses, since ``s = ⌊x⌋``); the
    top endpoint folds into the last segment with ``frac = 1``.
    """
    x = util * (n_points - 1)
    s = min(int(x), n_points - 2)
    frac = 1.0 if x >= n_points - 1 else math.fmod(x, 1.0)
    return s, frac


def segment_energy_j(tables: "np.ndarray", seg_count: "np.ndarray",
                     seg_frac: "np.ndarray", interval) -> "np.ndarray":
    """Per-host energy (J) from segment-hit counts and frac sums.

    ``tables [..., H, P]``, ``seg_count``/``seg_frac [..., H, P-1]`` →
    ``[..., H]`` joules.  Σ_k interval·(t[s_k] + Δt[s_k]·frac_k)
    regrouped by segment:  interval · Σ_s (count_s·t[s] + Δt[s]·Σfrac_s).

    This host-side numpy routine is shared verbatim by the OO manager and
    the vec engine — the one place the power table is multiplied in.  The
    compiled vec loop deliberately contains **no** float multiply feeding
    an add: XLA:CPU's fusion clones producers into consumers and may then
    contract ``a + b·c`` into an FMA (observed as 1-ulp energy drift on
    wide batches that no graph-level pin — optimization_barrier, bitcast,
    select, roll — survives, since fusion re-derives the product from the
    cloned multiply).  Pure counts and frac sums are exact accumulations,
    immune by construction.
    """
    tables = np.asarray(tables, np.float64)
    lo, hi = tables[..., :-1], tables[..., 1:]
    watts = seg_count * lo + (hi - lo) * seg_frac
    return watts.sum(axis=-1) * np.asarray(interval)[..., None]


MODEL_MIXES = ("mixed", "linear", "cubic", "spec", "dvfs")


def make_power_fleet(n_hosts: int, mix: str = "mixed") -> List[object]:
    """One power model per host.  ``mixed`` cycles through all four model
    families in two efficiency tiers (G4-class efficient, G5-class not),
    so energy-aware host selection has a real gradient to exploit."""
    mixed = [
        PowerModelLinear(86.0, 117.0),
        PowerModelCubic(93.7, 135.0),
        PowerModelSpecTable(SPEC_HP_ML110_G4),
        PowerModelDvfs(93.7, 135.0),
        PowerModelSpecTable(SPEC_HP_ML110_G5),
        PowerModelDvfs(86.0, 117.0),
    ]
    families = {
        "mixed": mixed,
        "linear": [PowerModelLinear(86.0, 117.0),
                   PowerModelLinear(93.7, 135.0)],
        "cubic": [PowerModelCubic(86.0, 117.0),
                  PowerModelCubic(93.7, 135.0)],
        "spec": [PowerModelSpecTable(SPEC_HP_ML110_G4),
                 PowerModelSpecTable(SPEC_HP_ML110_G5)],
        "dvfs": [PowerModelDvfs(86.0, 117.0),
                 PowerModelDvfs(93.7, 135.0)],
    }
    try:
        cycle = families[mix]
    except KeyError:
        raise ValueError(f"unknown model mix {mix!r}; "
                         f"known: {MODEL_MIXES}") from None
    return [cycle[i % len(cycle)] for i in range(n_hosts)]


def elastic_demand_trace(rng: random.Random, n_samples: int) -> List[float]:
    """Aggregate per-VM utilization trace in [0, 1]: triangle-wave diurnal
    swing + bounded random walk.

    Deliberately libm-free (``rng.uniform`` + arithmetic only, no
    ``sin``/``gauss``): the trace is the sole stochastic input of the
    elastic scenario, and keeping it free of platform-dependent
    transcendental rounding keeps the committed golden fixtures bit-stable
    across machines.
    """
    walk = rng.uniform(0.2, 0.8)
    out = []
    for k in range(n_samples):
        phase = k / n_samples
        diurnal = 1.0 - 2.0 * abs(phase - 0.5)          # 0 → 1 → 0 triangle
        walk = min(max(walk + rng.uniform(-0.08, 0.08), 0.0), 1.0)
        out.append(min(max(0.1 + 0.6 * diurnal + 0.3 * (walk - 0.5),
                           0.02), 1.0))
    return out


def power_fault_table(fault_plan: Optional[FaultPlan], n_hosts: int,
                      n_samples: int, interval: float) -> Optional[np.ndarray]:
    """``[K, H]`` bool: host ``h`` failed during interval ``k`` — the one
    compiled fault view both power backends consume.

    The scenario is time-stepped, so windows resolve at the interval
    decision times ``k·interval`` under the plan's half-open rule (a
    window starting exactly at ``k·interval`` is visible to interval
    ``k``).  The OO path replays rows of this table as priority ``-1``
    events at the changed intervals; the vec loop indexes it directly —
    same table, same rule, bit-exact either way.
    """
    if fault_plan is None:
        return None
    for kind in ("link", "region", "transient"):
        if fault_plan.has(kind):
            raise ValueError(
                f"power_batch supports only 'node' fault windows "
                f"(host crashes), got a {kind!r} event")
    fault_plan.check_targets("node", n_hosts, "host")
    times = np.arange(n_samples, dtype=np.float64) * float(interval)
    tbl = fault_plan.down_mask("node", times, n_hosts)
    dead = np.all(tbl, axis=1)
    if dead.any():
        k = int(np.argmax(dead))
        raise ValueError(
            f"power_batch: fault plan fails all {n_hosts} hosts during "
            f"interval {k} (t={k * float(interval)}) — at least one host "
            f"must survive")
    return tbl


def check_demand(demand) -> np.ndarray:
    """Validate an injected demand curve (a trace-replay
    :func:`repro.core.trace.demand_curve` product or a hand-built array):
    1-D, finite, in [0, 1].  Returns the canonical f64 array whose values
    both backends consume verbatim (bit-exactness)."""
    d = np.asarray(demand, np.float64)
    if d.ndim != 1 or d.shape[0] < 1:
        raise ValueError(f"power_batch: demand must be a non-empty 1-D "
                         f"utilization curve, got shape {d.shape}")
    if not np.all(np.isfinite(d)) or float(d.min()) < 0.0 \
            or float(d.max()) > 1.0:
        raise ValueError("power_batch: demand values must be finite "
                         "utilizations in [0, 1]")
    return d


def _finalize(out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Datacenter-level totals from the per-host accumulators.

    Shared by the oo and vec handlers so the scalar reductions are the same
    ``np.sum`` (pairwise) over bit-identical per-host arrays — keeping the
    totals in the bit-exactness contract too.
    """
    out = dict(out)
    out["energy_total_wh"] = np.sum(out["energy_wh"], axis=-1)
    out["sla_total_s"] = np.sum(out["sla_s"], axis=-1)
    out["unserved_total_mips_s"] = np.sum(out["unserved_mips_s"], axis=-1)
    return out


def _empty_outputs(n_hosts: int):
    zf = np.empty((0, n_hosts), np.float64)
    zi = np.empty((0,), np.int32)
    return _finalize(dict(
        energy_wh=zf, sla_s=zf, unserved_mips_s=zf, migrations=zi,
        scale_out_events=zi, scale_in_events=zi, final_active=zi,
        iterations=zi))


def _finalize_accumulators(out: Dict[str, np.ndarray], tables: np.ndarray,
                           interval) -> Dict[str, np.ndarray]:
    """Exact loop accumulators → public per-host metrics (host-side numpy;
    op-for-op what ``ElasticDatacenterManager.result`` computes)."""
    interval = np.float64(interval)
    out = dict(out)
    energy_j = segment_energy_j(tables, out.pop("seg_count"),
                                out.pop("seg_frac"), interval)
    out["energy_wh"] = energy_j / 3600.0
    out["sla_s"] = out.pop("over_count") * interval
    out["unserved_mips_s"] = out.pop("unserved_mips") * interval
    return out
