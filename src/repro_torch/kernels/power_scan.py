"""The ``power_batch`` interval loop — CUDA kernel + plain version.

Port of ``repro/kernels/step.py::fused_scan`` for its one consumer, the
power step of ``repro/core/vec_power.py``.  :func:`power_step` is that step
in plain PyTorch with the lane axis written out ([B, H] per-host state);
:func:`power_scan_ref` runs it ``K`` times; :func:`power_scan` runs the
whole loop as one launch of ``csrc/power_scan.cu`` (one CTA per lane) on a
CUDA tensor, or the plain loop on a CPU tensor.

``params`` and the carry are the NamedTuples of
:mod:`repro_torch.core.vec_power` (``_Params``/``_Carry``); the statics
object carries ``n_hosts``, ``n_points``, ``n_intervals``, ``n_vms``,
``min_active`` and ``faults``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ops import PlainOps

_I32, _F64 = torch.int32, torch.float64
_SMEM_PER_HOST = 37                 # bytes of shared memory per host
_SMEM_MAX = 227 * 1024              # per-block dynamic shared memory (H100)


def even_counts(active: torch.Tensor, n_vms: int) -> torch.Tensor:
    """Even VM split over each lane's active hosts, in host order: the
    first ``V mod A`` active hosts take one extra VM.  ``[B, H]`` → int32."""
    a32 = active.to(_I32)
    rank = torch.cumsum(a32, dim=-1, dtype=_I32) - 1
    a = torch.clamp(a32.sum(dim=-1, keepdim=True, dtype=_I32), min=1)
    base = n_vms // a
    rem = n_vms - base * a
    return torch.where(active, base + (rank < rem).to(_I32), 0).to(_I32)


def power_step(c, it, p, s, ops):
    """One interval for every lane (``it [B]`` int32 interval index) —
    the reference's ``_power_build.step``, op for op."""
    dev = p.trace.device
    lanes = torch.arange(p.trace.shape[0], device=dev)
    idx = torch.arange(s.n_hosts, device=dev)
    k = it.long()
    if s.faults:
        # Host crashes at the start of the interval (keep-alive election).
        failed = p.fail_tbl[lanes, k]                       # [B, H]
        act = c.active & ~failed
        keep = ops.argmin(p.eff, ~failed)
        act = torch.where(act.any(dim=-1, keepdim=True), act,
                          act | (idx == keep[:, None]))
        fchanged = (act ^ c.active).any(dim=-1, keepdim=True)
        cnt = torch.where(fchanged, even_counts(act, s.n_vms), c.count)
        fmoved = torch.clamp(cnt - c.count, min=0).sum(dim=-1, dtype=_I32)
        avail = (~failed).sum(dim=-1, dtype=_I32)
        on_mask = ~act & ~failed
    else:
        act, cnt = c.active, c.count
        avail = s.n_hosts
        on_mask = ~act

    # Demand, utilization, energy segments, SLA (current placement).  The
    # multiplies feed only divides, min/max and compares.
    d = p.trace[lanes, k] * p.vm_mips                       # [B]
    demand = cnt.to(_F64) * d[:, None]                      # [B, H]
    util = torch.clamp(demand / p.cap, max=1.0)
    x = util * (s.n_points - 1)
    seg = torch.clamp(x.to(_I32), max=s.n_points - 2)
    frac = torch.where(x >= s.n_points - 1, 1.0, torch.fmod(x, 1.0))
    seg_iota = torch.arange(s.n_points - 1, device=dev, dtype=_I32)
    hot = (seg[..., None] == seg_iota) & act[..., None]     # [B, H, P-1]
    seg_count = c.seg_count + hot.to(_I32)
    seg_frac = c.seg_frac + torch.where(hot, frac[..., None], 0.0)
    over_count = c.over_count + (demand > p.cap).to(_I32)
    unserved = c.unserved + (torch.maximum(demand, p.cap) - p.cap)

    # Autoscale decision (end of interval; shapes interval k+1).
    n_act = act.sum(dim=-1, dtype=_I32)
    can = c.cooldown == 0
    any_over = (act & (util > p.up_thr[:, None])).any(dim=-1)
    all_under = torch.where(act, util, -torch.inf).amax(dim=-1) < p.lo_thr
    want_out = can & any_over & (n_act < avail)
    want_in = can & ~want_out & all_under & (n_act > s.min_active)
    pick_on = ops.argmin(p.eff, on_mask)
    pick_off = ops.argmax(p.eff, act)
    active1 = torch.where(
        want_out[:, None], act | (idx == pick_on[:, None]),
        torch.where(want_in[:, None], act & (idx != pick_off[:, None]), act))
    changed = want_out | want_in
    count1 = torch.where(changed[:, None], even_counts(active1, s.n_vms),
                         cnt)
    moved = torch.clamp(count1 - cnt, min=0).sum(dim=-1, dtype=_I32)
    migrations = c.migrations + torch.where(changed, moved, 0)
    if s.faults:
        migrations = migrations + fmoved
    return type(c)(
        count=count1, active=active1,
        cooldown=torch.where(changed, p.cooldown_k,
                             torch.clamp(c.cooldown - 1, min=0)),
        seg_count=seg_count, seg_frac=seg_frac, over_count=over_count,
        unserved=unserved, migrations=migrations,
        scale_out=c.scale_out + want_out.to(_I32),
        scale_in=c.scale_in + want_in.to(_I32))


def power_scan_ref(init, params, statics):
    """Plain version: :func:`power_step` for every interval, in order."""
    c = init
    n = params.trace.shape[0]
    for k in range(statics.n_intervals):
        it = torch.full((n,), k, dtype=_I32, device=params.trace.device)
        c = power_step(c, it, params, statics, PlainOps)
    return c


_CARRY_TYPES = dict(count=_I32, active=torch.bool, cooldown=_I32,
                    seg_count=_I32, seg_frac=_F64, over_count=_I32,
                    unserved=_F64, migrations=_I32, scale_out=_I32,
                    scale_in=_I32)
_PARAM_TYPES = dict(trace=_F64, cap=_F64, eff=_F64, up_thr=_F64,
                    lo_thr=_F64, vm_mips=_F64, cooldown_k=_I32)


def _check(init, params, s):
    b, h, k = params.trace.shape[0], s.n_hosts, s.n_intervals
    shapes = dict(count=(b, h), active=(b, h), cooldown=(b,),
                  seg_count=(b, h, s.n_points - 1),
                  seg_frac=(b, h, s.n_points - 1), over_count=(b, h),
                  unserved=(b, h), migrations=(b,), scale_out=(b,),
                  scale_in=(b,), trace=(b, k), cap=(b, h), eff=(b, h),
                  up_thr=(b,), lo_thr=(b,), vm_mips=(b,), cooldown_k=(b,))
    dev = params.trace.device
    for src, types in ((init, _CARRY_TYPES), (params, _PARAM_TYPES)):
        for name, dtype in types.items():
            t = getattr(src, name)
            if t.dtype != dtype or tuple(t.shape) != shapes[name] \
                    or t.device != dev:
                raise ValueError(
                    f"power_scan: {name} must be {dtype} {shapes[name]} on "
                    f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if s.faults:
        f = params.fail_tbl
        if f is None or f.dtype != torch.bool or \
                tuple(f.shape) != (b, k, h) or f.device != dev:
            raise ValueError(f"power_scan: fail_tbl must be bool "
                             f"{(b, k, h)} on {dev}")
    if s.n_points < 2 or h < 1:
        raise ValueError("power_scan needs n_points ≥ 2 and n_hosts ≥ 1")
    if h * _SMEM_PER_HOST > _SMEM_MAX:
        raise ValueError(f"power_scan: n_hosts={h} needs "
                         f"{h * _SMEM_PER_HOST} B of shared memory per "
                         f"block, more than {_SMEM_MAX}")


@functools.lru_cache(maxsize=None)
def _entry():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.entry("power_scan", "power_scan_f64",
                        (p,) * 18 + (i,) * 6 + (p,))


def _launch(init, params, s):
    out = type(init)(*(t.clone(memory_format=torch.contiguous_format)
                       for t in init))
    ins = [getattr(params, n).contiguous() for n in _PARAM_TYPES]
    fail = params.fail_tbl.contiguous() if s.faults else None
    b = params.trace.shape[0]
    if b:
        with torch.cuda.device(params.trace.device):
            rc = _entry()(
                *(t.data_ptr() for t in ins),
                None if fail is None else fail.data_ptr(),
                *(t.data_ptr() for t in out), b, s.n_hosts, s.n_points,
                s.n_intervals, s.n_vms, s.min_active,
                torch.cuda.current_stream().cuda_stream)
        _build.check("power_scan", rc, "power_scan")
        power_scan.launches += 1
    return out


def power_scan(init, params, statics):
    """All ``statics.n_intervals`` steps from ``init`` → final carry.

    ``power_scan.launches`` counts kernel launches (CPU calls run the plain
    version and do not count)."""
    _check(init, params, statics)
    dev = params.trace.device
    if dev.type == "cuda":
        return _launch(init, params, statics)
    if dev.type == "cpu":
        return power_scan_ref(init, params, statics)
    raise ValueError(f"power_scan runs on cuda or cpu, got {dev}")


power_scan.launches = 0
