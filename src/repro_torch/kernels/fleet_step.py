"""The ``fleet_batch`` while-loop — CUDA kernel + plain version.

Port of ``repro/kernels/step.py::fused_step_body`` for its one consumer,
the fleet step of ``repro/core/vec_cluster.py``.  The TPU kernel ran one
loop iteration per call with the ``cond`` outside; the port's kernel
(``csrc/fleet_loop.cu``, one CTA per lane) runs each lane's whole loop,
``cond`` inside, in one launch per chunk.

  * :func:`fleet_step` — one iteration for every lane, the reference's
    ``step`` op for op, over ``[B, n]`` tensors;
  * :func:`fleet_loop_ref` — the plain whole loop: the driver's
    where-live loop over :func:`fleet_step`;
  * :func:`fleet_loop` — the kernel on CUDA tensors, the plain loop on CPU
    tensors; ``max_iters=1`` is exactly one step on every live lane.

``carry``/``params``/``tables`` are the NamedTuples of
:mod:`repro_torch.core.vec_cluster` (``_Carry``, ``_Params``, ``_Tables``
with its optional ``_Faults``); ``statics`` carries ``n_nodes``,
``n_spares``, ``k_fail_rounds``, ``k_degrade``, ``window``,
``track_stragglers``, ``degrade``, ``sigma_zero``, ``fast`` and
``n_fault_windows``.  The per-step random draws come from
:mod:`repro_torch.kernels.fleet_rng`, which the kernel repeats op for op.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from . import fleet_rng as rng
from .ops import PlainOps

STALL_RETRY_S = 60.0          # the reference's stall-retry cadence
UNIFORM_MIN = 1e-12           # lower bound of the inverse-CDF uniform
_I32, _I64, _F32, _F64 = torch.int32, torch.int64, torch.float32, \
    torch.float64
_SMEM_MAX = 227 * 1024        # per-block dynamic shared memory (H100)


def smem_bytes(n_total: int, dtype: torch.dtype) -> int:
    """Shared memory of one kernel block: five ``[n]`` float arrays, one
    int32 array and five byte flags per node."""
    item = 8 if dtype == _F64 else 4
    return n_total * (5 * item + 4 + 5)


def fleet_step(c, it, p, tb, s, ops):
    """One iteration for every lane (``it [B]`` int32) — the reference's
    ``_fleet_build.step``, op for op."""
    dev, T = c.t.device, c.t.dtype
    inf = math.inf
    n, k_last = s.n_nodes + s.n_spares, s.k_fail_rounds - 1
    t = c.t[:, None]                                       # [B, 1]
    rep = p.repair_s[:, None]
    fs = tb.fail_start                                      # [B, n, K]

    # Renewal round = completed outages; its start and the next one.
    ended = (fs + rep[..., None] <= t[..., None]).sum(-1, dtype=_I32)
    r = torch.clamp(ended, max=k_last)
    cur = fs.gather(2, r.long()[..., None])[..., 0]
    rdown = (cur <= t) & (t < cur + rep)
    down = rdown
    fx = tb.faults
    if s.n_fault_windows:
        mine = fx.node[:, None, :] == torch.arange(n, device=dev)[None, :,
                                                                  None]
        fst, fen = fx.start[:, None, :], fx.end[:, None, :]
        down = down | (mine & (fst <= t[..., None])
                       & (t[..., None] < fen)).any(-1)
    up_sched = ~down
    up = up_sched & (t >= c.evict_until) if s.track_stragglers \
        else up_sched
    failures = c.failures + (c.was_up & ~up_sched).sum(-1, dtype=_I32)
    nxt = fs.gather(2, torch.clamp(r + 1, max=k_last).long()[..., None])
    next_fail = torch.where(cur > t, cur,
                            torch.where(rdown & (r < k_last), nxt[..., 0],
                                        inf))
    if s.n_fault_windows:
        next_fail = torch.minimum(next_fail, torch.where(
            mine & (fst > t[..., None]), fst, inf).amin(-1))
    # Cascade: a then-active node failed inside the window jumped over.
    watch = c.watch_from[:, None]
    f_window = torch.where(c.was_active & (cur > watch) & (cur <= t), cur,
                           inf).amin(-1)
    if s.n_fault_windows:
        was = c.was_active.gather(1, fx.node.long())
        f_window = torch.minimum(f_window, torch.where(
            was & (fx.start > watch) & (fx.start <= t), fx.start,
            inf).amin(-1))
    cascade = torch.isfinite(c.watch_from) & (f_window < c.t)
    # Active set: index-ordered prefix of up nodes, capped at n_nodes.
    active = up & (torch.cumsum(up, -1) <= s.n_nodes)
    n_active = active.sum(-1)                               # int64
    stalled = ~cascade & (n_active.to(T) < p.min_nodes)
    n_one = torch.clamp(n_active, min=1)

    # Straggler sampling: the sync step waits for the slowest active node.
    lanes_seed = tb.seed
    deg_mult = None
    if s.track_stragglers or s.degrade:
        slowdown = c.bias
        if s.degrade:
            cnt = (tb.degrade_t <= t[..., None]).sum(-1)
            deg_mult = torch.exp(cnt.to(T)
                                 * torch.log(p.degrade_factor)[:, None])
            slowdown = slowdown * deg_mult
        if not s.sigma_zero:
            w = rng.draw(lanes_seed[:, None], rng.STREAM_JITTER, it[:, None],
                         torch.arange(n, device=dev)[None, :])
            draws = rng.normal_f32(w[0], w[1])
            slowdown = slowdown * torch.exp(draws.to(T) * p.sigma[:, None])
        max_slow = torch.where(active, slowdown, -inf).amax(-1)
    elif s.sigma_zero:
        max_slow = torch.ones_like(c.t)
    else:
        # Only the max matters: sample it by inverse CDF, one draw a step.
        w = rng.draw(lanes_seed, rng.STREAM_MAX, it, torch.zeros_like(it))
        u = rng.uniform_min(w[0], w[1], T, UNIFORM_MIN)
        sig_tot = torch.sqrt(p.sigma * p.sigma
                             + (p.sigma / 2.0) * (p.sigma / 2.0))
        z = rng.ndtri(rng.root(u, (1.0 / n_one.to(_F64)).to(T)))
        max_slow = torch.exp(sig_tot * z)
    width = torch.clamp(float(s.n_nodes) / n_one.to(T), min=1.0)
    step_s = p.base_step_s * max_slow * width

    # Failure interruption: the earliest active-node failure in the step.
    t_int = ops.min(next_fail, active)
    interrupted = ~cascade & ~stalled & (t_int < c.t + step_s)
    completed = ~cascade & ~stalled & ~interrupted
    t_done = c.t + step_s
    step1 = c.step + 1

    # Straggler bookkeeping and chronic eviction (completed steps).
    evict_now = torch.zeros_like(completed)
    bias1, evict_until1, slow_count2 = c.bias, c.evict_until, c.slow_count
    if s.track_stragglers:
        srt = torch.sort(torch.where(active, slowdown, inf), -1).values
        lo = torch.clamp(torch.div(n_active - 1, 2, rounding_mode="floor"),
                         min=0)
        hi = torch.clamp(torch.div(n_active, 2, rounding_mode="floor"),
                         min=0)
        med = 0.5 * (srt.gather(1, lo[:, None])[:, 0]
                     + srt.gather(1, hi[:, None])[:, 0])
        slow = active & (slowdown > (p.evict_factor * med)[:, None])
        slow_count1 = torch.where(
            active, torch.where(slow, c.slow_count + 1, 0),
            c.slow_count).to(_I32)
        chronic = active & (slow_count1 >= s.window)
        worst = ops.argmax(c.bias if deg_mult is None else c.bias * deg_mult,
                           chronic)
        evict_now = completed & chronic.any(-1)
        w = rng.draw(lanes_seed, rng.STREAM_EVICT, it, torch.zeros_like(it))
        new_bias = torch.exp(rng.normal_f64(*w)
                             * (p.sigma / 2.0).to(_F64)).to(T)
        hit = evict_now[:, None] & (torch.arange(n, device=dev)[None, :]
                                    == worst[:, None])
        bias1 = torch.where(hit, new_bias[:, None], c.bias)
        evict_until1 = torch.where(hit, (t_done + p.repair_s)[:, None],
                                   c.evict_until)
        slow_count2 = torch.where(hit, 0, slow_count1).to(_I32)
        slow_count2 = torch.where(completed[:, None], slow_count2,
                                  c.slow_count)

    # Checkpoint cadence, then select among {cascade, stalled, interrupted,
    # ckpt_hit, done}.
    ckpt_due = (step1 - c.last_ckpt) >= p.ckpt_every
    t_after = torch.where(ckpt_due, t_done + p.ckpt_write_s, t_done)
    ckpt_hit = completed & ckpt_due & (t_int < t_done + p.ckpt_write_s)
    restart_at = interrupted | ckpt_hit
    t_next = torch.where(
        cascade, f_window + p.restart_s,
        torch.where(stalled, c.t + STALL_RETRY_S,
                    torch.where(restart_at, t_int + p.restart_s, t_after)))
    step_next = torch.where(completed, step1,
                            torch.where(stalled, c.step, c.last_ckpt))
    last_ckpt_next = torch.where(completed & ckpt_due, step1, c.last_ckpt)
    rollback = cascade | interrupted
    watch_next = torch.where(
        cascade, f_window,
        torch.where(stalled, c.t, torch.where(restart_at, t_int, -inf)))
    return type(c)(
        t=t_next, step=step_next, last_ckpt=last_ckpt_next, bias=bias1,
        slow_count=slow_count2, evict_until=evict_until1, was_up=up_sched,
        was_active=torch.where(cascade[:, None], c.was_active, active),
        watch_from=watch_next, failures=failures,
        restarts=c.restarts + (rollback | ckpt_hit).to(_I32),
        evictions=c.evictions + evict_now.to(_I32),
        lost_steps=c.lost_steps + torch.where(
            rollback, (c.step - c.last_ckpt).to(T), 0.0),
        stall_s=c.stall_s + torch.where(
            stalled, STALL_RETRY_S,
            torch.where(rollback | ckpt_hit, p.restart_s, 0.0)),
        ckpt_s=c.ckpt_s + torch.where(completed & ckpt_due, p.ckpt_write_s,
                                      0.0))


def fleet_cond(c, p):
    """Live lanes: steps left and wall-clock left."""
    return (c.step < p.total_steps) & (c.t < p.max_wall_s)


def _keep(live, new, old):
    m = live.reshape(live.shape + (1,) * (new.dim() - 1))
    return torch.where(m, new, old)


def fleet_loop_ref(init, params, tables, statics, max_iters=None):
    """Plain version: :func:`fleet_step` on every live lane until no lane
    is live (at most ``max_iters`` steps a lane) → ``(carry, it)``."""
    c = init
    it = torch.zeros_like(init.step)
    cap = math.inf if max_iters is None else int(max_iters)
    live = fleet_cond(c, params) & (it < cap)
    while bool(live.any()):
        new = fleet_step(c, it, params, tables, statics, PlainOps)
        c = type(c)(*(_keep(live, a, b) for a, b in zip(new, c)))
        it = it + live.to(_I32)
        live = fleet_cond(c, params) & (it < cap)
    return c, it


_CARRY_TYPES = dict(t="T", step=_I32, last_ckpt=_I32, bias="T",
                    slow_count=_I32, evict_until="T", was_up=torch.bool,
                    was_active=torch.bool, watch_from="T", failures=_I32,
                    restarts=_I32, evictions=_I32, lost_steps="T",
                    stall_s="T", ckpt_s="T")
_PER_NODE = ("bias", "slow_count", "evict_until", "was_up", "was_active")
_PARAM_TYPES = dict(base_step_s="T", mtbf_s="T", repair_s="T",
                    ckpt_every=_I32, ckpt_write_s="T", restart_s="T",
                    sigma="T", evict_factor="T", degrade_s="T",
                    degrade_factor="T", min_nodes="T", total_steps=_I32,
                    max_wall_s="T")


def _check(init, p, tb, s):
    T = _F32 if s.fast else _F64
    b, n = p.base_step_s.shape[0], s.n_nodes + s.n_spares
    dev = p.base_step_s.device

    def need(name, t, dtype, shape):
        dtype = T if dtype == "T" else dtype
        if t is None or t.dtype != dtype or tuple(t.shape) != shape \
                or t.device != dev:
            got = None if t is None else (t.dtype, tuple(t.shape), t.device)
            raise ValueError(f"fleet_loop: {name} must be {dtype} {shape} "
                             f"on {dev}, got {got}")

    for name, dtype in _CARRY_TYPES.items():
        need(name, getattr(init, name), dtype,
             (b, n) if name in _PER_NODE else (b,))
    for name, dtype in _PARAM_TYPES.items():
        need(name, getattr(p, name), dtype, (b,))
    need("fail_start", tb.fail_start, "T", (b, n, s.k_fail_rounds))
    need("seed", tb.seed, _I64, (b,))
    if s.degrade:
        need("degrade_t", tb.degrade_t, "T", (b, n, s.k_degrade))
    w = s.n_fault_windows
    if w:
        need("faults.node", tb.faults.node, _I32, (b, w))
        need("faults.start", tb.faults.start, "T", (b, w))
        need("faults.end", tb.faults.end, "T", (b, w))
    if s.k_fail_rounds < 1 or n < 1 or s.n_nodes < 0:
        raise ValueError("fleet_loop needs k_fail_rounds ≥ 1 and a node")
    if smem_bytes(n, T) > _SMEM_MAX:
        raise ValueError(f"fleet_loop: {n} nodes need {smem_bytes(n, T)} B "
                         f"of shared memory per block, more than "
                         f"{_SMEM_MAX}")


@functools.lru_cache(maxsize=None)
def _entry(symbol: str):
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.entry("fleet_loop", symbol, (p,) * 35 + (i,) * 11 + (p,))


def _launch(init, p, tb, s, max_iters):
    out = type(init)(*(t.clone(memory_format=torch.contiguous_format)
                       for t in init))
    it = torch.zeros_like(init.step)
    ins = [getattr(p, name).contiguous() for name in _PARAM_TYPES]
    fx = tb.faults if s.n_fault_windows else None
    tabs = [tb.fail_start.contiguous(), tb.seed.contiguous(),
            tb.degrade_t.contiguous() if s.degrade else None,
            *((fx.node.contiguous(), fx.start.contiguous(),
               fx.end.contiguous()) if fx is not None else (None,) * 3)]
    b, n = p.base_step_s.shape[0], s.n_nodes + s.n_spares
    if b:
        fn = _entry("fleet_loop_f32" if s.fast else "fleet_loop_f64")
        cap = 2**31 - 1 if max_iters is None else int(max_iters)
        with torch.cuda.device(p.base_step_s.device):
            rc = fn(*(t.data_ptr() for t in ins),
                    *(None if t is None else t.data_ptr() for t in tabs),
                    *(t.data_ptr() for t in out), it.data_ptr(),
                    b, s.n_nodes, n, s.k_fail_rounds, s.k_degrade, s.window,
                    s.n_fault_windows, int(s.track_stragglers),
                    int(s.degrade), int(s.sigma_zero), cap,
                    torch.cuda.current_stream().cuda_stream)
        _build.check("fleet_loop", rc, "fleet_loop")
        fleet_loop.launches += 1
    return out, it


def fleet_loop(init, params, tables, statics, max_iters=None):
    """Every lane from ``init`` until its ``cond`` is false (or after
    ``max_iters`` steps) → ``(final carry, it [B] int32)``.

    ``fleet_loop.launches`` counts kernel launches (CPU calls run the plain
    version and do not count)."""
    _check(init, params, tables, statics)
    dev = params.base_step_s.device
    if dev.type == "cuda":
        return _launch(init, params, tables, statics, max_iters)
    if dev.type == "cpu":
        return fleet_loop_ref(init, params, tables, statics, max_iters)
    raise ValueError(f"fleet_loop runs on cuda or cpu, got {dev}")


fleet_loop.launches = 0
