"""Batched power-aware elastic datacenter — ``power_batch`` as a VecEngine.

Port of ``repro/core/vec_power.py``.  Per-host attributes are ``[B, H]``
tensors, power models are lowered host-side to ``[H, P]`` utilization→power
tables (:func:`repro_torch.core.power.power_points`), and the loop runs one
iteration per trace interval (``trip_count = n_samples``).

On the card the whole loop is one launch of the power-scan kernel per
chunk (``Loop.step_kernel``); on the CPU the driver runs the same step
(:func:`repro_torch.kernels.power_scan.power_step`) in its Python loop.

Exactness: as in the reference, the loop accumulates exact quantities —
power-table segment hits and frac sums, SLA-interval counts, unserved-MIPS
sums — and the host-side finalizer applies the tables, so every output is
bit-identical to the reference's ``vec`` (and ``oo``) backend.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..kernels.power_scan import even_counts, power_scan, power_step
from .faults import FaultPlan
from .power import (_empty_outputs, _finalize, _finalize_accumulators,
                    check_demand, elastic_demand_trace, make_power_fleet,
                    power_fault_table, power_points)
from .vec_engine import (BatchPlan, Done, Loop, VecEngine, broadcast_cells,
                         make_batch_entry)


@dataclass(frozen=True)
class _Statics:
    """Shape-defining configuration of one power sweep."""
    n_hosts: int
    n_points: int
    n_intervals: int
    n_vms: int
    min_active: int
    # When set, ``params.fail_tbl`` carries the [B, K, H] host-crash table
    # and every step opens with the degraded-capacity block.
    faults: bool = False


class _Params(NamedTuple):
    """Per-cell inputs, cell axis first."""
    trace: Any          # [B, K] f64 aggregate per-VM utilization demand
    cap: Any            # [B, H] f64 host capacity (MIPS)
    eff: Any            # [B, H] f64 watts/MIPS at full load
    up_thr: Any         # [B] f64 scale-out utilization threshold
    lo_thr: Any         # [B] f64 scale-in utilization threshold
    vm_mips: Any        # [B] f64 per-VM capacity (MIPS)
    cooldown_k: Any     # [B] i32 intervals to wait after a scaling action
    init_active: Any    # [B] i32 hosts powered on at t=0
    fail_tbl: Any = None   # [B, K, H] bool host crashed during interval k


class _Carry(NamedTuple):
    count: Any          # [B, H] i32 VMs placed per host
    active: Any         # [B, H] bool host powered on
    cooldown: Any       # [B] i32 intervals until the next action may fire
    seg_count: Any      # [B, H, P-1] i32 power-table segment hits (active)
    seg_frac: Any       # [B, H, P-1] f64 Σ frac within each segment
    over_count: Any     # [B, H] i32 intervals spent overloaded (SLA)
    unserved: Any       # [B, H] f64 Σ unserved MIPS
    migrations: Any     # [B] i32 VMs that landed on a new host
    scale_out: Any      # [B] i32 power-on events
    scale_in: Any       # [B] i32 power-off events


def _power_build(params: _Params, s: _Statics, ops) -> Loop:
    """All lanes' elastic datacenters, one iteration per trace interval."""
    dev = params.trace.device
    b, h = params.trace.shape[0], s.n_hosts
    i32 = torch.int32
    active0 = torch.arange(h, device=dev) < params.init_active[:, None]
    zi = torch.zeros((b,), dtype=i32, device=dev)
    init = _Carry(
        count=even_counts(active0, s.n_vms), active=active0, cooldown=zi,
        seg_count=torch.zeros((b, h, s.n_points - 1), dtype=i32, device=dev),
        seg_frac=torch.zeros((b, h, s.n_points - 1), dtype=torch.float64,
                             device=dev),
        over_count=torch.zeros((b, h), dtype=i32, device=dev),
        unserved=torch.zeros((b, h), dtype=torch.float64, device=dev),
        migrations=zi, scale_out=zi, scale_in=zi)

    def finalize(end: _Carry, it) -> Dict[str, Any]:
        return dict(
            seg_count=end.seg_count, seg_frac=end.seg_frac,
            over_count=end.over_count, unserved_mips=end.unserved,
            migrations=end.migrations, scale_out_events=end.scale_out,
            scale_in_events=end.scale_in,
            final_active=end.active.sum(dim=-1))     # int64, as jnp.sum

    kernel = None
    if dev.type == "cuda":
        def kernel(state):
            return power_scan(state, params, s)
    return Loop(init=init, cond=lambda c, it: it < s.n_intervals,
                body=lambda c, it: power_step(c, it, params, s, ops),
                finalize=finalize, trip_count=s.n_intervals,
                step_kernel=kernel)


POWER_ENGINE = VecEngine("power_batch", _power_build)


def _prepare_power(*, seeds: Sequence[int] | np.ndarray = (0,),
                   n_hosts: int = 8, n_vms: int = 32,
                   n_samples: int = 288, interval: float = 300.0,
                   host_mips: float = 8000.0, vm_mips=1000.0,
                   up_thr=0.8, lo_thr=0.3, cooldown=3,
                   min_active: int = 1, init_active: Optional[int] = None,
                   model_mix: str = "mixed", n_points: int = 11,
                   fault_plan: Optional[FaultPlan] = None, demand=None):
    if demand is not None:
        demand = check_demand(demand)
        n_samples = int(demand.shape[0])
    min_active = max(int(min_active), 1)
    init_active = n_hosts if init_active is None else int(init_active)
    if not 1 <= min_active <= n_hosts:
        raise ValueError("min_active must be in [1, n_hosts]")
    if not min_active <= init_active <= n_hosts:
        raise ValueError("init_active must be in [min_active, n_hosts]")
    if n_vms < 1:
        raise ValueError("n_vms must be ≥ 1")
    if not interval > 0:
        raise ValueError("interval must be > 0")
    seeds, axes, b = broadcast_cells(seeds, dict(
        up_thr=up_thr, lo_thr=lo_thr, cooldown=cooldown, vm_mips=vm_mips))
    if b and float(np.max(axes["vm_mips"])) > float(host_mips):
        raise ValueError(
            f"vm_mips (max {np.max(axes['vm_mips'])}) must be ≤ host_mips "
            f"({host_mips}): a VM must fit a time-shared host")
    fail_tbl = power_fault_table(fault_plan, n_hosts, n_samples, interval)
    if b == 0:
        return Done(_empty_outputs(n_hosts))

    if demand is not None:
        traces = np.broadcast_to(demand, (b, n_samples)).copy()
    else:
        traces = np.asarray([elastic_demand_trace(random.Random(int(s)),
                                                  n_samples)
                             for s in seeds], np.float64)
    models = make_power_fleet(n_hosts, model_mix)
    cap = np.full(n_hosts, float(host_mips), np.float64)
    table = np.asarray([power_points(m, n_points) for m in models],
                       np.float64)
    eff = table[:, -1] / cap
    bc = lambda a: np.broadcast_to(a, (b,) + np.shape(a)).copy()
    params = _Params(
        trace=traces,
        cap=bc(cap), eff=bc(eff),
        up_thr=axes["up_thr"].astype(np.float64),
        lo_thr=axes["lo_thr"].astype(np.float64),
        vm_mips=axes["vm_mips"].astype(np.float64),
        cooldown_k=axes["cooldown"].astype(np.int32),
        init_active=np.full(b, init_active, np.int32),
        fail_tbl=None if fail_tbl is None else bc(fail_tbl))
    statics = _Statics(int(n_hosts), int(n_points), int(n_samples),
                       int(n_vms), min_active, faults=fail_tbl is not None)
    # All lanes run exactly n_samples iterations — no divergence to bucket.
    return BatchPlan(
        params, statics,
        finalize=lambda out: _finalize(
            _finalize_accumulators(out, table, float(interval))))


simulate_power_batch = make_batch_entry(
    POWER_ENGINE, _prepare_power, name="simulate_power_batch", doc="""\
    Run a batch of elastic-datacenter cells through the sweep layer.

    Same parameters and outputs as the reference's ``simulate_power_batch``,
    plus ``device`` (default ``"cuda"``): per-host ``energy_wh [B, H]`` /
    ``sla_s`` / ``unserved_mips_s``, their datacenter totals, and integer
    ``migrations`` / ``scale_out_events`` / ``scale_in_events`` /
    ``final_active``.  A ``fault_plan`` of ``node`` windows crashes hosts
    for the covered intervals.  Bit-exact against the reference on every
    output.
    """)
