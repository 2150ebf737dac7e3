"""Batched ML-fleet simulator — ``fleet_batch`` / ``fleet`` as a VecEngine.

Port of ``repro/core/vec_cluster.py``: the fleet life-cycle — lognormal
straggler max-reduction, pre-drawn exponential failure/repair rounds,
checkpoint cadence with rollback-on-failure, elastic width penalty, stall
below ``min_nodes_frac``, chronic-straggler eviction — over dense ``[B, n]``
node arrays.  On the card each chunk's whole while-loop is one launch of
the fleet kernel (``Loop.step_kernel`` → :func:`~repro_torch.kernels
.fleet_step.fleet_loop`); on the CPU the driver runs
:func:`~repro_torch.kernels.fleet_step.fleet_step` in its where-live loop.

Random schedules are drawn on the host with numpy, per lane, keyed by the
lane's seed only (as the reference keys by seed only), into a ``_Tables``
tree that travels with the params through chunking and bucketing: the CPU
and the card see identical tables, and a lane's result does not depend on
its chunk.  The per-step draws (jitter, inverse-CDF max, eviction re-draw)
come from :mod:`repro_torch.kernels.fleet_rng`, keyed by
``(seed, stream, it, node)``.

Exactness: on the reference's deterministic domain (σ = 0, MTBF and
degradation beyond the run, with or without a ``FaultPlan``) every output
is bit-identical to the reference's ``vec``; given the reference's own
schedules (:func:`repro_torch.convert.params_from_reference`) σ = 0 runs
with failures, degradation and eviction are bit-identical too.  Stochastic
configs draw other random numbers than the reference's threefry and match
its statistics (mean goodput within 2%).
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..kernels.fleet_step import fleet_cond, fleet_loop, fleet_step
from .backend import scenario
from .cluster import FleetConfig, RunStats, StepCost, fleet_fault_windows
from .faults import FaultPlan
from .vec_engine import (BatchPlan, Done, Loop, VecEngine, make_batch_entry,
                         resolve_precision)


@dataclass(frozen=True)
class _Statics:
    """Shape-defining configuration and the flags that prune the step:
    ``sigma_zero`` drops the per-step draws, ``degrade`` the degradation
    schedule, ``track_stragglers`` the median and eviction bookkeeping;
    ``fast`` runs the loop in float32 on the float64 sample."""
    n_nodes: int
    n_spares: int
    k_fail_rounds: int
    k_degrade: int
    window: int
    track_stragglers: bool = True
    degrade: bool = True
    sigma_zero: bool = False
    fast: bool = False
    n_fault_windows: int = 0

    @property
    def n_total(self) -> int:
        return self.n_nodes + self.n_spares


class _Params(NamedTuple):
    """Per-cell scalars, cell axis first."""
    base_step_s: Any
    mtbf_s: Any
    repair_s: Any
    ckpt_every: Any
    ckpt_write_s: Any
    restart_s: Any
    sigma: Any
    evict_factor: Any
    degrade_s: Any
    degrade_factor: Any
    min_nodes: Any            # min_nodes_frac * n_nodes (float threshold)
    total_steps: Any
    max_wall_s: Any


class _Faults(NamedTuple):
    """Planned-outage windows (:func:`~repro_torch.core.cluster
    .fleet_fault_windows`), one row per window, cell axis first."""
    node: Any                 # [B, W] i32 which node the window downs
    start: Any                # [B, W] f64 outage start (half-open window)
    end: Any                  # [B, W] f64 outage end


class _Tables(NamedTuple):
    """Per-cell random schedules, drawn on the host, cell axis first."""
    fail_start: Any           # [B, n, K] f64 start of node i's k-th outage
    bias0: Any                # [B, n] f64 initial per-node slowdown bias
    seed: Any                 # [B] i64 the lane's seed (per-step draws)
    degrade_t: Any = None     # [B, n, k_degrade] f64 degradation times
    faults: Any = None        # _Faults, when a plan is given


class _Carry(NamedTuple):
    t: Any                    # [B] simulation clock
    step: Any                 # [B] i32 unique steps completed
    last_ckpt: Any            # [B] i32
    bias: Any                 # [B, n] persistent per-node slowdown bias
    slow_count: Any           # [B, n] i32 consecutive-slow-step counts
    evict_until: Any          # [B, n] eviction outage ends
    was_up: Any               # [B, n] bool schedule-up at last observation
    was_active: Any           # [B, n] bool active set of the last attempt
    watch_from: Any           # [B] start of an in-flight stall/restart/ckpt
                              #     window (-inf = none)
    failures: Any
    restarts: Any
    evictions: Any
    lost_steps: Any
    stall_s: Any
    ckpt_s: Any


def _f32(x):
    return x.to(torch.float32) if x is not None and x.is_floating_point() \
        else x


def loop_inputs(args, s: _Statics):
    """``(params, tables)`` as the loop reads them: for ``fast``, the same
    float64 sample as ``exact``, cast to float32."""
    p, tb = args
    if not s.fast:
        return p, tb
    fx = tb.faults
    return _Params(*(_f32(f) for f in p)), tb._replace(
        fail_start=_f32(tb.fail_start), bias0=_f32(tb.bias0),
        degrade_t=_f32(tb.degrade_t),
        faults=None if fx is None else fx._replace(
            start=_f32(fx.start), end=_f32(fx.end)))


def _fleet_build(args, s: _Statics, ops) -> Loop:
    """All lanes' fleets as one loop over step attempts."""
    p, tb = loop_inputs(args, s)
    dev, T = p.base_step_s.device, tb.fail_start.dtype
    b, n = p.base_step_s.shape[0], s.n_total
    zf = torch.zeros((b,), dtype=T, device=dev)
    zi = torch.zeros((b,), dtype=torch.int32, device=dev)
    init = _Carry(
        t=zf, step=zi, last_ckpt=zi, bias=tb.bias0,
        slow_count=torch.zeros((b, n), dtype=torch.int32, device=dev),
        evict_until=torch.zeros((b, n), dtype=T, device=dev),
        was_up=torch.ones((b, n), dtype=torch.bool, device=dev),
        was_active=(torch.arange(n, device=dev) < s.n_nodes).expand(b, n),
        watch_from=torch.full((b,), -torch.inf, dtype=T, device=dev),
        failures=zi, restarts=zi, evictions=zi,
        lost_steps=zf, stall_s=zf, ckpt_s=zf)

    def finalize(end: _Carry, it) -> Dict[str, Any]:
        finished = end.step >= p.total_steps
        wallclock = torch.where(finished, end.t, p.max_wall_s)
        ideal = end.step.to(T) * p.base_step_s
        return dict(
            wallclock_s=wallclock, steps_done=end.step,
            failures=end.failures, restarts=end.restarts,
            evictions=end.evictions, lost_steps=end.lost_steps,
            stall_s=end.stall_s, ckpt_s=end.ckpt_s, ideal_s=ideal,
            goodput=torch.where(wallclock > 0, ideal / wallclock, 0.0))

    kernel = None
    if dev.type == "cuda":
        def kernel(state):
            return fleet_loop(state, p, tb, s)
    return Loop(init=init, cond=lambda c, it: fleet_cond(c, p),
                body=lambda c, it: fleet_step(c, it, p, tb, s, ops),
                finalize=finalize, step_kernel=kernel)


FLEET_ENGINE = VecEngine("fleet_batch", _fleet_build)


def _predicted_iters(params: _Params, n_total: int) -> np.ndarray:
    """Predicted while-loop length per cell, for divergence bucketing:
    unique steps plus failure-rollback redo work (each failure among the
    ``n_total`` nodes over the ≈ ``total_steps × base_step_s`` horizon
    rolls the fleet back ~``ckpt_every/2`` steps)."""
    steps = np.asarray(params.total_steps, np.float64)
    horizon = steps * np.asarray(params.base_step_s, np.float64)
    exp_failures = horizon * n_total / np.asarray(params.mtbf_s, np.float64)
    redo = np.asarray(params.ckpt_every, np.float64) / 2.0 + 1.0
    return steps + exp_failures * redo


def _make_params(cost: StepCost, cfg: FleetConfig, total_steps,
                 max_wallclock_s, *, mtbf_hours=None, ckpt_every=None,
                 straggler_sigma=None) -> _Params:
    """Broadcast scalars/sweep axes into a batched _Params (numpy, f64)."""
    base = cost.step_seconds() + cfg.pod_boundary_overhead_s
    mtbf_h = cfg.mtbf_hours_node if mtbf_hours is None else mtbf_hours
    every = cfg.ckpt_every_steps if ckpt_every is None else ckpt_every
    sigma = cfg.straggler_sigma if straggler_sigma is None else straggler_sigma
    vals = dict(
        base_step_s=base,
        mtbf_s=np.asarray(mtbf_h, np.float64) * 3600.0,
        repair_s=cfg.repair_hours * 3600.0,
        ckpt_every=np.asarray(every, np.int32),
        ckpt_write_s=cfg.ckpt_write_s,
        restart_s=cfg.restart_s,
        sigma=np.asarray(sigma, np.float64),
        evict_factor=cfg.straggler_evict_factor,
        degrade_s=cfg.degrade_mtbf_hours * 3600.0,
        degrade_factor=cfg.degrade_factor,
        min_nodes=cfg.min_nodes_frac * cfg.n_nodes,
        total_steps=np.asarray(total_steps, np.int32),
        max_wall_s=max_wallclock_s,
    )
    shape = np.broadcast_shapes(*(np.shape(v) for v in vals.values()))
    return _Params(**{k: np.broadcast_to(np.asarray(v, np.asarray(v).dtype),
                                         shape).astype(
                          np.int32 if k in ("ckpt_every", "total_steps")
                          else np.float64)
                      for k, v in vals.items()})


def _draw_tables(seeds: np.ndarray, params: _Params, s: _Statics
                 ) -> _Tables:
    """The lanes' random schedules, keyed by seed only.

    Each seed has three numpy streams (``default_rng([seed, stream])``):
    standard-exponential failure gaps drawn round by round (``[K, n]``, so
    the first rounds do not depend on ``K``), degradation gaps, and the
    bias normals.  Scaling and sums follow the reference's expressions.
    """
    n, k = s.n_total, s.k_fail_rounds
    uniq, inv = np.unique(seeds, return_inverse=True)
    gaps = np.empty((len(uniq), n, k))
    dgaps = np.empty((len(uniq), n, s.k_degrade)) if s.degrade else None
    z = np.empty((len(uniq), n))
    for j, seed in enumerate(uniq.tolist()):
        gaps[j] = np.random.default_rng([seed, 0]).standard_exponential(
            (k, n)).T
        if s.degrade:
            dgaps[j] = np.random.default_rng([seed, 1]).standard_exponential(
                (s.k_degrade, n)).T
        z[j] = np.random.default_rng([seed, 2]).standard_normal(n)
    col = lambda a: np.asarray(a, np.float64)[:, None, None]
    fail_start = (np.cumsum(gaps[inv] * col(params.mtbf_s), axis=2)
                  + np.arange(k) * col(params.repair_s))
    degrade_t = (np.cumsum(dgaps[inv] * col(params.degrade_s), axis=2)
                 if s.degrade else None)
    if not (s.track_stragglers or s.degrade):
        bias0 = np.zeros((len(seeds), n))               # per-node path unused
    elif s.sigma_zero:
        bias0 = np.ones((len(seeds), n))
    else:
        bias0 = np.exp(z[inv] * (np.asarray(params.sigma)[:, None] / 2.0))
    return _Tables(fail_start=fail_start, bias0=bias0,
                   seed=seeds.astype(np.int64), degrade_t=degrade_t)


def _empty_outputs() -> Dict[str, np.ndarray]:
    zf, zi = np.empty((0,), np.float64), np.empty((0,), np.int32)
    return dict(wallclock_s=zf, steps_done=zi, failures=zi, restarts=zi,
                evictions=zi, lost_steps=zf, stall_s=zf, ckpt_s=zf,
                ideal_s=zf, goodput=zf, iterations=zi)


def _prepare_fleet(cost: StepCost, cfg: FleetConfig, total_steps: int = 2000,
                   *, seeds: Sequence[int] | np.ndarray = (0,),
                   mtbf_hours=None, ckpt_every=None, straggler_sigma=None,
                   max_wallclock_s: float = 30 * 86400.0,
                   k_fail_rounds: Optional[int] = None, k_degrade: int = 8,
                   precision: str = "exact",
                   fault_plan: Optional[FaultPlan] = None):
    fast = resolve_precision(precision)
    windows = fleet_fault_windows(fault_plan, cfg.n_nodes + cfg.n_spares)
    seeds = np.asarray(seeds, np.uint32)
    params = _make_params(cost, cfg, total_steps, max_wallclock_s,
                          mtbf_hours=mtbf_hours, ckpt_every=ckpt_every,
                          straggler_sigma=straggler_sigma)
    b = int(np.broadcast_shapes(seeds.shape, params.base_step_s.shape)[0]) \
        if (seeds.ndim or params.base_step_s.ndim) else 1
    seeds = np.broadcast_to(np.atleast_1d(seeds), (b,))
    params = _Params(*(np.broadcast_to(np.atleast_1d(f), (b,)).copy()
                       for f in params))
    if b == 0:
        return Done(_empty_outputs())
    if k_fail_rounds is None:
        # Horizon estimate: 10× the zero-overhead run time (goodput ≥ 0.1),
        # capped by the hard wall-clock bound; 3× margin on expected rounds.
        horizon = min(float(max_wallclock_s),
                      float(np.max(params.base_step_s))
                      * float(np.max(params.total_steps)) * 10.0 + 3600.0)
        cycle = float(np.min(params.mtbf_s) + np.min(params.repair_s))
        k_fail_rounds = int(np.clip(np.ceil(horizon / cycle * 3.0 + 3), 4, 64))
    statics = _Statics(
        cfg.n_nodes, cfg.n_spares, int(k_fail_rounds), int(k_degrade),
        cfg.straggler_window,
        track_stragglers=bool(np.min(params.evict_factor) < 1e8
                              and cfg.straggler_window <= 10_000),
        degrade=bool(np.min(params.degrade_s) < 1e8 * 3600.0),
        sigma_zero=bool(np.all(params.sigma == 0.0)),
        fast=fast,
        n_fault_windows=len(windows))
    tables = _draw_tables(seeds, params, statics)
    if windows:
        w = np.asarray(windows, np.float64)            # [W, 3]
        bcw = lambda a: np.broadcast_to(a, (b, len(windows))).copy()
        tables = tables._replace(faults=_Faults(
            node=bcw(w[:, 0].astype(np.int32)), start=bcw(w[:, 1]),
            end=bcw(w[:, 2])))
    return BatchPlan(
        (params, tables), statics,
        predicted_cost=_predicted_iters(params, statics.n_total))


simulate_fleet_batch = make_batch_entry(
    FLEET_ENGINE, _prepare_fleet, name="simulate_fleet_batch", doc="""\
    Run a batch of fleet scenarios through the sweep layer.

    Same parameters and outputs as the reference's
    ``simulate_fleet_batch``, plus ``device`` (default ``"cuda"``):
    ``seeds`` and the optional sweep axes (``mtbf_hours``, ``ckpt_every``,
    ``straggler_sigma``) broadcast into cells; returns per-cell
    ``goodput``, ``wallclock_s``, ``steps_done``, ``failures``,
    ``restarts``, ``evictions``, ``lost_steps``, ``stall_s``, ``ckpt_s``,
    ``ideal_s`` and ``iterations``.  ``precision`` is ``"exact"`` (f64) or
    ``"fast"`` (same f64 sample, f32 loop); a ``fault_plan`` of ``node``
    windows adds planned outages (:func:`~repro_torch.core.cluster
    .fleet_fault_windows`).
    """)


def simulate_fleet_vec(cost: StepCost, cfg: FleetConfig,
                       total_steps: int = 2000, *,
                       max_wallclock_s: float = 30 * 86400.0,
                       use_pallas: bool = False,
                       fault_plan: Optional[FaultPlan] = None,
                       device="cuda") -> RunStats:
    """Single-scenario convenience wrapper returning ``RunStats``."""
    out = simulate_fleet_batch(cost, cfg, total_steps, seeds=[cfg.seed],
                               max_wallclock_s=max_wallclock_s,
                               use_pallas=use_pallas, fault_plan=fault_plan,
                               device=device)
    return RunStats(**{f.name: (int if f.type == "int" else float)(
        out[f.name][0]) for f in fields(RunStats)})


@scenario("fleet")
def _fleet(*, cost: StepCost, cfg: FleetConfig, total_steps: int = 2000,
           max_wallclock_s: float = 30 * 86400.0, use_pallas: bool = False,
           fault_plan: Optional[FaultPlan] = None, device="cuda") -> RunStats:
    return simulate_fleet_vec(cost, cfg, total_steps,
                              max_wallclock_s=max_wallclock_s,
                              use_pallas=use_pallas, fault_plan=fault_plan,
                              device=device)
