"""Batched multi-datacenter routing — ``netdc_batch`` as a VecEngine.

Port of ``repro/core/vec_netdc.py``.  One routing decision per loop
iteration over the precomputed tables of :mod:`repro_torch.core.netdc`, for
all lanes at once: the candidate scores are ``[B, D]`` and the pick is
``ops.argmin(score, elig)`` — the next_event kernel on the card.

The body is adds, maxima and compares over host-built f64 tables (no
multiply), and the argmin keeps the first-occurrence tie rule, so every
output is bit-identical to the reference's ``vec`` (and ``oo``) backend.

The per-job outputs ``dst``/``finish`` are written in place, one column per
iteration: every lane runs exactly ``n_jobs`` iterations, and a lane whose
``cond`` is false has ``it == n_jobs``, so its write lands in a spare last
column that ``finalize`` drops.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .faults import FaultPlan, RetryPolicy
from .netdc import build_cells, empty_netdc_outputs, summarize
from .vec_engine import BatchPlan, Done, Loop, VecEngine, make_batch_entry


class _Statics(NamedTuple):
    n_jobs: int
    n_dcs: int
    # Fault view: ``timeout`` (inf = off) excludes candidates that cannot
    # finish in time; ``guarded`` marks that rows of ``online`` may be
    # all-False (node windows / given-up jobs), so commits need ``ok``
    # guards.
    timeout: float = math.inf
    guarded: bool = False


class _Params(NamedTuple):
    """The routing tables the loop reads (cell axis first)."""
    submit: torch.Tensor      # [B, J]    f64
    xfer: torch.Tensor        # [B, J, D] f64
    exec_s: torch.Tensor      # [B, J, D] f64
    bias: torch.Tensor        # [B, J, D] f64
    online: torch.Tensor      # [B, J, D] bool (folds node windows + give-ups)


class _Carry(NamedTuple):
    free: torch.Tensor        # [B, D] f64 time each DC's FIFO queue drains
    dst: torch.Tensor         # [B, J+1] i32 chosen DC per job (+ spare)
    finish: torch.Tensor      # [B, J+1] f64 completion time per job (+ spare)


def _netdc_build(cell: _Params, s: _Statics, ops) -> Loop:
    """One routing decision per iteration, in submission order."""
    dev = cell.submit.device
    b = cell.submit.shape[0]
    lanes = torch.arange(b, device=dev)
    idx = torch.arange(s.n_dcs, device=dev)
    f64 = cell.submit.dtype

    def body(c: _Carry, it) -> _Carry:
        j = it.clamp(max=s.n_jobs - 1).long()         # dead lanes: any row
        sub = cell.submit[lanes, j][:, None]           # [B, 1]
        arr = sub + cell.xfer[lanes, j]                # [B, D] WAN arrivals
        fin = torch.maximum(c.free, arr) + cell.exec_s[lanes, j]
        score = fin + cell.bias[lanes, j]
        elig = cell.online[lanes, j]
        if math.isfinite(s.timeout):                   # static: timeout lane
            elig = elig & (fin <= sub + s.timeout)
        pick = ops.argmin(score, elig)                 # [B] int32
        chosen = fin.gather(1, pick[:, None].long())   # [B, 1]
        hit = idx == pick[:, None]
        col = it.long()                                # n_jobs ⇒ spare column
        if not s.guarded:
            c.dst[lanes, col] = pick
            c.finish[lanes, col] = chosen[:, 0]
            return _Carry(free=torch.where(hit, chosen, c.free),
                          dst=c.dst, finish=c.finish)
        ok = elig.any(dim=-1)                          # else job is dropped
        c.dst[lanes, col] = torch.where(ok, pick, -1)
        c.finish[lanes, col] = torch.where(ok, chosen[:, 0], math.inf)
        return _Carry(free=torch.where(ok[:, None] & hit, chosen, c.free),
                      dst=c.dst, finish=c.finish)

    return Loop(
        init=_Carry(
            free=torch.zeros((b, s.n_dcs), dtype=f64, device=dev),
            dst=torch.full((b, s.n_jobs + 1), -1, dtype=torch.int32,
                           device=dev),
            finish=torch.full((b, s.n_jobs + 1), math.inf, dtype=f64,
                              device=dev)),
        cond=lambda c, it: it < s.n_jobs,
        body=body,
        finalize=lambda c, it: dict(finish=c.finish[:, :s.n_jobs],
                                    dst=c.dst[:, :s.n_jobs]))


NETDC_ENGINE = VecEngine("netdc_batch", _netdc_build)


def _prepare_netdc(*, seeds=(0,), n_dcs: int = 4, n_jobs: int = 64,
                   dc_mips=None, locality_weight=1.0, offline_dc=-1,
                   link_bw: float = 10e9, hop_latency_s: float = 0.02,
                   mean_gap_s: float = 2.0, length_mi=(2e3, 2e4),
                   payload_mb=(10.0, 200.0),
                   fault_plan: Optional[FaultPlan] = None,
                   retry: Optional[RetryPolicy] = None,
                   timeout_s: float = math.inf, workload=None):
    cells, b = build_cells(
        seeds=seeds, n_dcs=n_dcs, n_jobs=n_jobs, dc_mips=dc_mips,
        link_bw=link_bw, hop_latency_s=hop_latency_s,
        locality_weight=locality_weight, offline_dc=offline_dc,
        mean_gap_s=mean_gap_s, length_mi=length_mi, payload_mb=payload_mb,
        fault_plan=fault_plan, retry=retry, timeout_s=timeout_s,
        workload=workload)
    if b == 0:
        return Done(empty_netdc_outputs(
            n_dcs, faulted=fault_plan is not None
            or math.isfinite(timeout_s)))
    fx = cells[0].fx
    params = _Params(*(np.stack([np.asarray(getattr(c, f)) for c in cells])
                       for f in _Params._fields))
    n_jobs = len(cells[0].submit)
    # Every lane runs exactly n_jobs iterations: nothing to bucket.
    return BatchPlan(params, _Statics(int(n_jobs), int(n_dcs),
                                      timeout=(fx.timeout_s if fx
                                               else math.inf),
                                      guarded=fx is not None),
                     finalize=lambda out: summarize(out, cells))


simulate_netdc_batch = make_batch_entry(
    NETDC_ENGINE, _prepare_netdc, name="simulate_netdc_batch", doc="""\
    Batched multi-datacenter cloudlet routing through the sweep layer.

    Same parameters and outputs as the reference's
    ``simulate_netdc_batch``, plus ``device`` (default ``"cuda"``):
    per-job ``finish [B, J]`` / ``dst [B, J]`` and the summary metrics
    (``makespan``, ``response_total_s``, ``remote_jobs``, ``remote_bytes``,
    ``xfer_total_s``, ``dc_jobs``, ``dc_busy_s``, ``busiest_dc``); faulted
    runs add ``submit`` / ``served`` / ``dropped`` / ``retries``.
    Bit-exact against the reference on every output.
    """)
