"""Multi-datacenter cloudlet routing — ``netdc_batch``'s host side.

Copy of the numpy half of ``repro/core/netdc.py``: the libm-free workload
generator, the per-cell routing tables (:func:`build_cell`), the batch
builder (:func:`build_cells`) and the host-side summary (:func:`summarize`).
Every ``random.Random`` draw and every floating-point operation keeps the
reference's order, so the tables — and through them the outputs — are
bit-identical.  The reference's OO broker has no counterpart here.

``workload=`` (trace replay) raises ``NotImplementedError`` until
``core/trace.py`` is ported.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np

from .faults import FaultPlan, RetryPolicy, apply_transient
from .network import InterDCTopology


def default_dc_mips(n_dcs: int) -> np.ndarray:
    """Heterogeneous default capacities: four repeating size classes."""
    return np.asarray([4000.0 + 1500.0 * (d % 4) for d in range(n_dcs)],
                      np.float64)


def netdc_workload(rng: random.Random, n_jobs: int, n_dcs: int, *,
                   mean_gap_s: float, length_mi, payload_mb) -> Dict[str, Any]:
    """One seed's job stream: nondecreasing submit times (uniform gaps),
    uniform source DC, uniform length (MI) and payload (bytes).

    Deliberately libm-free (``rng.uniform``/``randrange`` + arithmetic, no
    ``expovariate``): the stream is the scenario's sole stochastic input,
    and avoiding platform-dependent transcendental rounding keeps the
    committed golden fixtures bit-stable across machines.
    """
    t = 0.0
    submit, src, length, payload = [], [], [], []
    for j in range(n_jobs):
        if j:
            t += rng.uniform(0.0, 2.0 * mean_gap_s)
        submit.append(t)
        src.append(rng.randrange(n_dcs))
        length.append(rng.uniform(*length_mi))
        payload.append(rng.uniform(*payload_mb) * 1e6)
    return dict(submit=np.asarray(submit, np.float64),
                src=np.asarray(src, np.int32),
                length=np.asarray(length, np.float64),
                payload=np.asarray(payload, np.float64))


class NetdcFaults(NamedTuple):
    """Per-cell fault context (present iff the cell was built faulted).

    The vec engine never reads this — its fault view is baked into
    ``NetdcCell.online`` — while the OO broker replays ``windows`` live
    through a :class:`~repro.core.faults.FaultInjector` and re-derives the
    same candidate mask from ``static_online`` + per-DC down counters.
    ``perm`` is the stable sort that put the cell into effective-submit
    order (``sorted = orig[perm]``); summaries unsort through it."""
    windows: tuple            # ((target, t_start, t_end), ...) node windows
    static_online: np.ndarray  # [D] bool offline_dc mask (no fault fold)
    gave_up: np.ndarray       # [J] bool transient retries/budget exhausted
    attempts: np.ndarray      # [J] i64 attempts made per job (>= 1)
    perm: np.ndarray          # [J] i64 stable effective-submit order
    timeout_s: float          # drop a job no DC can finish inside this


@dataclass(frozen=True)
class NetdcCell:
    """One cell's precomputed routing tables — shared verbatim by the OO
    broker and the vec engine, so decision bit-identity reduces to both
    backends evaluating the same adds/max/compares over the same doubles.
    Under a :class:`~repro.core.faults.FaultPlan` the per-job rows are in
    effective-submit order and ``online`` folds in node-down windows and
    given-up jobs (the vec fault view); ``fx`` carries what the OO broker
    needs to reproduce that mask from live events instead."""
    submit: np.ndarray        # [J] f64 nondecreasing (effective) submits
    src: np.ndarray           # [J] i32 source DC per job
    length: np.ndarray        # [J] f64 MI
    payload: np.ndarray       # [J] f64 bytes
    xfer: np.ndarray          # [J, D] f64 WAN transfer delay to each DC
    exec_s: np.ndarray        # [J, D] f64 execution time on each DC
    bias: np.ndarray          # [J, D] f64 (locality_weight - 1) · xfer
    online: np.ndarray        # [J, D] bool per-job candidate mask
    fx: Optional[NetdcFaults] = None


def build_cell(seed: int, n_dcs: int, n_jobs: int, dc_mips: np.ndarray,
               topo: InterDCTopology, locality_weight: float,
               offline_dc: int, *, mean_gap_s: float, length_mi,
               payload_mb, fault_plan: Optional[FaultPlan] = None,
               retry: Optional[RetryPolicy] = None,
               timeout_s: float = math.inf,
               workload: Optional[Dict[str, Any]] = None) -> NetdcCell:
    """Workload + routing tables for one (seed, weight, outage) cell.
    An injected ``workload`` (a validated trace-replay stream) replaces
    the seeded generator — every cell then shares the recorded stream."""
    wl = (workload if workload is not None else
          netdc_workload(random.Random(int(seed)), n_jobs, n_dcs,
                         mean_gap_s=mean_gap_s, length_mi=length_mi,
                         payload_mb=payload_mb))
    online0 = np.ones(n_dcs, bool)
    if offline_dc >= 0:
        online0[offline_dc] = False
    if fault_plan is None and not math.isfinite(timeout_s):
        xfer = topo.delay_rows(wl["src"], wl["payload"])
        return NetdcCell(
            submit=wl["submit"], src=wl["src"], length=wl["length"],
            payload=wl["payload"], xfer=xfer,
            exec_s=wl["length"][:, None] / dc_mips[None, :],
            bias=(float(locality_weight) - 1.0) * xfer,
            online=np.repeat(online0[None, :], n_jobs, axis=0))

    plan = fault_plan if fault_plan is not None else FaultPlan()
    # Transient failures resolve at the *original* submit times, then a
    # stable sort restores nondecreasing effective-submit order — the
    # shared event order both backends process (heap time/serial ties ==
    # stable-sort ties because the OO broker schedules in row order).
    out = apply_transient(plan, retry, wl["submit"],
                          seed=plan.seed * 1_000_003 + int(seed))
    perm = np.argsort(out.eff_submit, kind="stable")
    submit = out.eff_submit[perm]
    src, length = wl["src"][perm], wl["length"][perm]
    payload, gave_up = wl["payload"][perm], out.gave_up[perm]
    xfer = topo.delay_rows(src, payload)
    if plan.has("link"):
        xfer = xfer * plan.degrade_factor(submit, n_dcs)
    online = np.repeat(online0[None, :], n_jobs, axis=0)
    windows = ()
    if plan.has("node"):
        online &= ~plan.down_mask("node", submit, n_dcs)
        tgt, ts, te, _ = plan.select("node")
        windows = tuple(zip(tgt.tolist(), ts.tolist(), te.tolist()))
    online &= ~gave_up[:, None]
    return NetdcCell(
        submit=submit, src=src, length=length, payload=payload, xfer=xfer,
        exec_s=length[:, None] / dc_mips[None, :],
        bias=(float(locality_weight) - 1.0) * xfer, online=online,
        fx=NetdcFaults(windows=windows, static_online=online0,
                       gave_up=gave_up, attempts=out.attempts[perm],
                       perm=perm, timeout_s=float(timeout_s)))


def summarize(out: Dict[str, Any], cells: Sequence[NetdcCell]
              ) -> Dict[str, Any]:
    """Batch-level metrics from per-job ``finish``/``dst`` — one shared
    numpy routine so every aggregate (pairwise sums, argmax tie-breaks) is
    computed identically for both backends.

    Every aggregate is masked to served jobs (``dst >= 0``); with no
    faults every job is served and the ``where`` masks are identity, so
    the arithmetic — and the committed golden fixtures — are unchanged
    bit-for-bit.  Under faults the per-job arrays (``finish``/``dst``
    plus the added ``submit``) are unsorted back to original job order,
    and the summary gains ``served``/``dropped``/``retries`` counts."""
    out = dict(out)
    finish = out["finish"] = np.asarray(out["finish"], np.float64)
    dst = out["dst"] = np.asarray(out["dst"], np.int64)
    submit = np.stack([c.submit for c in cells])
    src = np.stack([c.src for c in cells]).astype(np.int64)
    payload = np.stack([c.payload for c in cells])
    xfer = np.stack([c.xfer for c in cells])
    exec_s = np.stack([c.exec_s for c in cells])
    d_iota = np.arange(xfer.shape[-1])
    srv = dst >= 0
    remote = srv & (dst != src)
    out["makespan"] = np.max(np.where(srv, finish, -np.inf), axis=-1)
    out["response_total_s"] = np.sum(
        np.where(srv, finish - submit, 0.0), axis=-1)
    out["remote_jobs"] = np.sum(remote, axis=-1)
    out["remote_bytes"] = np.sum(np.where(remote, payload, 0.0), axis=-1)
    out["xfer_total_s"] = np.sum(np.where(srv, np.take_along_axis(
        xfer, np.maximum(dst, 0)[..., None], -1)[..., 0], 0.0), axis=-1)
    out["dc_jobs"] = np.sum(dst[:, :, None] == d_iota, axis=1)
    out["dc_busy_s"] = np.sum(
        np.where(dst[:, :, None] == d_iota, exec_s, 0.0), axis=1)
    out["busiest_dc"] = np.argmax(out["dc_busy_s"], axis=-1)
    if cells and cells[0].fx is not None:
        inv = np.stack([np.argsort(c.fx.perm) for c in cells])
        for k in ("finish", "dst"):
            out[k] = np.take_along_axis(out[k], inv, axis=-1)
        out["submit"] = np.take_along_axis(submit, inv, axis=-1)
        out["served"] = np.sum(srv, axis=-1)
        out["dropped"] = srv.shape[-1] - out["served"]
        out["retries"] = np.stack(
            [np.sum(c.fx.attempts - 1) for c in cells])
    return out


def build_cells(*, seeds, n_dcs: int, n_jobs: int, dc_mips, link_bw: float,
                hop_latency_s: float, locality_weight, offline_dc: int,
                mean_gap_s: float, length_mi, payload_mb,
                fault_plan: Optional[FaultPlan] = None,
                retry: Optional[RetryPolicy] = None,
                timeout_s: float = math.inf, workload=None):
    """Validated per-cell table construction — the shared front half of
    both backends' batch handlers."""
    if workload is not None:
        raise NotImplementedError(
            "netdc_batch: workload= (trace replay) waits for the port of "
            "core/trace.py (ROADMAP item A14)")
    if n_jobs < 1 or n_dcs < 1:
        raise ValueError("netdc_batch needs n_jobs ≥ 1 and n_dcs ≥ 1")
    dc_mips = (default_dc_mips(n_dcs) if dc_mips is None
               else np.asarray(dc_mips, np.float64))
    if dc_mips.shape != (n_dcs,) or not np.all(dc_mips > 0):
        raise ValueError(f"dc_mips must be {n_dcs} positive capacities")
    if not timeout_s > 0:
        raise ValueError(f"netdc_batch: timeout_s must be > 0: {timeout_s}")
    if fault_plan is not None:
        if fault_plan.has("region"):
            raise ValueError("netdc_batch has no region concept — use "
                             "'node' faults on datacenter targets")
        fault_plan.check_targets("node", n_dcs, "datacenter")
        fault_plan.check_targets("link", n_dcs, "datacenter")
    from .vec_engine import broadcast_cells
    seeds, axes, b = broadcast_cells(seeds, dict(
        locality_weight=locality_weight, offline_dc=offline_dc))
    weights = axes["locality_weight"].astype(np.float64)
    offs = axes["offline_dc"].astype(np.int64)
    if b and (np.max(offs) >= n_dcs or
              (n_dcs == 1 and np.any(offs >= 0))):
        raise ValueError("offline_dc must be < n_dcs and leave at least "
                         "one datacenter online")
    topo = InterDCTopology(n_dcs, link_bw=link_bw,
                           hop_latency_s=hop_latency_s)
    cells = [build_cell(int(seeds[i]), n_dcs, n_jobs, dc_mips, topo,
                        float(weights[i]), int(offs[i]),
                        mean_gap_s=mean_gap_s, length_mi=length_mi,
                        payload_mb=payload_mb, fault_plan=fault_plan,
                        retry=retry, timeout_s=timeout_s,
                        workload=workload)
             for i in range(b)]
    return cells, b


def empty_netdc_outputs(n_dcs: int, faulted: bool = False
                        ) -> Dict[str, np.ndarray]:
    zf, zi = np.empty((0,), np.float64), np.empty((0,), np.int64)
    zjf, zji = np.empty((0, 0), np.float64), np.empty((0, 0), np.int64)
    out = dict(finish=zjf, dst=zji, makespan=zf, response_total_s=zf,
               remote_jobs=zi, remote_bytes=zf, xfer_total_s=zf,
               dc_jobs=np.empty((0, n_dcs), np.int64),
               dc_busy_s=np.empty((0, n_dcs), np.float64), busiest_dc=zi,
               iterations=np.empty((0,), np.int32))
    if faulted:
        out.update(submit=zjf, served=zi, dropped=zi, retries=zi)
    return out
