"""ML-fleet configuration and the planned-outage view of a fault plan.

Port of ``repro/core/cluster.py``'s ``StepCost``, ``FleetConfig``,
``RunStats`` and ``fleet_fault_windows``: the inputs and outputs of the
``fleet_batch`` / ``fleet`` scenarios (:mod:`repro_torch.core.vec_cluster`).
The reference's event-driven ``FleetSim`` and its legacy scenarios have no
counterpart here: the port has the ``vec`` backend only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .faults import FaultPlan


@dataclass
class StepCost:
    """Roofline terms for one training step on the chosen (arch, mesh)."""
    compute_s: float
    memory_s: float
    collective_s: float
    overlap_collective: float = 0.0     # fraction of collective hidden (0..1)

    def step_seconds(self) -> float:
        # compute and memory phases overlap on-chip (roofline max); the
        # un-hidden fraction of collectives serializes.
        return max(self.compute_s, self.memory_s) + \
            self.collective_s * (1.0 - self.overlap_collective)


@dataclass
class FleetConfig:
    n_nodes: int = 1024                 # active nodes (data-parallel workers)
    n_spares: int = 32
    chips_per_node: int = 8
    mtbf_hours_node: float = 5000.0     # per-node mean time between failures
    repair_hours: float = 2.0
    ckpt_every_steps: int = 200
    ckpt_write_s: float = 30.0          # async-shadowed fraction excluded
    restart_s: float = 180.0            # reschedule + restore + recompile
    straggler_sigma: float = 0.08       # lognormal sigma of per-node slowdown
    straggler_evict_factor: float = 1.6 # evict if node slower than this ×median
    straggler_window: int = 20          # consecutive slow steps before evict
    degrade_mtbf_hours: float = 800.0   # chronic-straggler onset (thermal,
    degrade_factor: float = 2.5         #   ECC retry, flaky ICI link, …)
    elastic: bool = True                # continue at reduced DP width if no spare
    min_nodes_frac: float = 0.75        # below this fraction, stall instead
    pod_boundary_overhead_s: float = 0.0  # extra per-step DCN penalty
    seed: int = 0


@dataclass
class RunStats:
    wallclock_s: float = 0.0
    steps_done: int = 0
    failures: int = 0
    evictions: int = 0
    restarts: int = 0
    lost_steps: float = 0.0
    stall_s: float = 0.0
    ckpt_s: float = 0.0
    ideal_s: float = 0.0

    @property
    def goodput(self) -> float:
        """Unique-useful-step-seconds / wall-clock (1.0 = zero overhead:
        no stragglers, failures, checkpoint stalls, or re-execution)."""
        return self.ideal_s / self.wallclock_s if self.wallclock_s else 0.0


def fleet_fault_windows(fault_plan: Optional[FaultPlan], n_total: int
                        ) -> tuple:
    """Validated ``((node, t_start, t_end), …)`` planned-outage windows.

    A :class:`~repro_torch.core.faults.FaultPlan` adds **planned** per-node
    outage windows on top of the fleet's stochastic failures.  Only
    ``node`` events with an explicit target and a finite end are
    meaningful, and per-node windows must not overlap (one outage per node
    at a time).  Bit-exactness domain against the reference's OO engine
    (its differential suite): ``straggler_sigma=0``, MTBF/degrade horizons
    beyond the run, ``n_spares=0``, windows not step-aligned, separated by
    more than ``restart_s`` and longer than it.
    """
    if fault_plan is None:
        return ()
    for kind in ("link", "region", "transient"):
        if fault_plan.has(kind):
            raise ValueError(
                f"fleet_batch supports only 'node' fault windows (planned "
                f"node outages), got a {kind!r} event")
    fault_plan.check_targets("node", n_total, "node")
    tgt, ts, te, _sev = fault_plan.select("node")
    if (tgt < 0).any():
        raise ValueError(
            "fleet_batch fault windows need an explicit node target "
            "(target=-1 would down the whole fleet)")
    if not np.isfinite(te).all():
        raise ValueError("fleet_batch fault windows must have a finite "
                         "t_end (the node must eventually recover)")
    windows = sorted(zip(tgt.tolist(), ts.tolist(), te.tolist()))
    for (n0, s0, e0), (n1, s1, e1) in zip(windows, windows[1:]):
        if n0 == n1 and s1 < e0:
            raise ValueError(
                f"fleet_batch fault windows on node {n0} overlap "
                f"([{s0}, {e0}) and [{s1}, {e1})): one outage per node "
                f"at a time")
    return tuple(windows)
