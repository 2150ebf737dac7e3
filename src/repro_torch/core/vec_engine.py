"""VecEngine — the batched event-loop driver under every ported engine.

Port of ``repro/core/vec_engine.py`` (``Loop``, ``VecEngine``,
``run_one``/``batched_sim``, ``BatchPlan``, ``Done``, ``run_plan``,
``make_batch_entry``, ``broadcast_cells``, ``empty_report``,
``resolve_precision``).  A scenario is declared as in the reference:

  * a hashable **statics** object (shapes and feature flags);
  * a **params** tree of tensors whose every leaf carries the lane axis
    first;
  * ``build(params, statics, ops) -> Loop`` returning the initial state
    tree, ``cond``/``body`` and a ``finalize``; ``ops`` is a
    :class:`~repro_torch.kernels.ops.MaskedOps`.

Where the reference ``vmap``s one cell's loop, the port writes the lane
axis out: ``build`` sees every lane at once, ``cond(state, it)`` returns a
``[B]`` bool and ``it`` is a ``[B]`` int32 tensor of per-lane iteration
counts.  A dynamic ``cond`` runs until no lane is live, and each step keeps
the old value of every state leaf on lanes that are no longer live
(``torch.where(live, new, old)``) — the semantics of a vmapped
``while_loop``; ``iterations`` counts per lane.  A ``body`` may instead
update a leaf in place and return the same tensor: it then guarantees
that lanes whose ``cond`` is false are left as they were.  A static
``trip_count`` runs a plain Python loop.  ``Loop.step_kernel`` is an
optional whole-loop launcher an engine sets when its state lies on the
card; the driver then hands it the initial state and takes the final one
(with a dynamic ``cond`` also the per-lane ``it``), with no host sync per
iteration.

Every tensor is created with an explicit dtype: there is no global
precision switch (the reference runs under ``enable_x64``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.ops import MaskedOps
from .backend import scenario
from .sweep import (NOT_PORTED, SweepReport, execute_sweep, tree_leaves,
                    tree_map2)


class Loop(NamedTuple):
    """All lanes' event loop, as returned by an engine's ``build``.

    ``trip_count`` promises ``cond(state, it) == (it < trip_count)`` on
    every lane, so the driver runs exactly that many steps.
    ``step_kernel(init) -> final state`` then runs all ``trip_count``
    steps in one launch, with outputs bit-identical to the step loop.
    Without ``trip_count``, ``step_kernel(init) -> (final state, it)``
    runs every lane until its own ``cond`` is false and returns the
    per-lane iteration counts (``[B]`` int32); lanes that finish early
    keep their state, as in the driver's where-live loop.
    """

    init: Any
    cond: Callable[[Any, Any], Any]
    body: Callable[[Any, Any], Any]
    finalize: Callable[[Any, Any], Dict[str, Any]]
    trip_count: Optional[int] = None
    step_kernel: Optional[Callable[[Any], Any]] = None


@dataclass(frozen=True)
class VecEngine:
    """A scenario kind as a declarative batched event-loop definition."""

    kind: str
    build: Callable[[Any, Any, MaskedOps], Loop]


def _n_lanes(params: Any) -> int:
    leaves = tree_leaves(params)
    return int(leaves[0].shape[0]) if leaves else 1


def _keep_live(live: torch.Tensor):
    def pick(new, old):
        if new is old:
            return new
        m = live.reshape(live.shape + (1,) * (new.dim() - 1))
        return torch.where(m, new, old)
    return pick


def run_one(engine: VecEngine, params: Any, statics: Any
            ) -> Dict[str, Any]:
    """Every lane of ``params``, start to finish."""
    loop = engine.build(params, statics, MaskedOps())
    leaves = tree_leaves(loop.init)
    dev = leaves[0].device if leaves else torch.device("cpu")
    n = _n_lanes(params)
    if loop.trip_count is not None:
        trips = int(loop.trip_count)
        if loop.step_kernel is not None:
            state = loop.step_kernel(loop.init)
        else:
            state = loop.init
            for i in range(trips):
                it = torch.full((n,), i, dtype=torch.int32, device=dev)
                state = loop.body(state, it)
        it = torch.full((n,), trips, dtype=torch.int32, device=dev)
    elif loop.step_kernel is not None:
        state, it = loop.step_kernel(loop.init)
    else:
        state = loop.init
        it = torch.zeros((n,), dtype=torch.int32, device=dev)
        live = loop.cond(state, it)
        while bool(live.any()):
            state = tree_map2(_keep_live(live), loop.body(state, it), state)
            it = it + live.to(torch.int32)
            live = loop.cond(state, it)
    out = dict(loop.finalize(state, it))
    out.setdefault("iterations", it)
    return out


def batched_sim(engine: VecEngine, statics: Any) -> Callable:
    """The sweep layer's calling convention: ``fn(params) -> outputs``."""
    def fn(params):
        return run_one(engine, params, statics)
    return fn


class BatchPlan(NamedTuple):
    """What ``prepare`` hands the driver: data + schedule for one batch."""

    params: Any                               # numpy tree, cell axis first
    statics: Any
    predicted_cost: Optional[Any] = None      # per-cell loop-length estimate
    finalize: Optional[Callable[[Dict[str, Any]], Any]] = None  # host-side


def resolve_precision(precision: str) -> bool:
    """Validate an engine's ``precision`` opt-in → ``fast`` flag.

    ``"exact"`` runs the loop in f64; ``"fast"`` keeps the f64 stochastic
    sample but runs the loop arithmetic in f32.
    """
    if precision not in ("exact", "fast"):
        raise ValueError(
            f"precision must be 'exact' or 'fast': {precision!r}")
    return precision == "fast"


class Done(NamedTuple):
    """``prepare`` short-circuit: host-computed outputs, no dispatch."""

    outputs: Any


def empty_report() -> SweepReport:
    """The sweep report a zero-cell batch carries (no dispatch happened)."""
    return SweepReport(n_cells=0, chunk_size=0, n_chunks=0, devices=1,
                       bucketed=False)


def broadcast_cells(seeds, axes: Dict[str, Any]):
    """Broadcast ``seeds`` against named sweep axes → ``(seeds[B],
    {axis: values[B]}, B)``."""
    seeds = np.atleast_1d(np.asarray(seeds, np.int64))
    arrs = {k: np.atleast_1d(np.asarray(v)) for k, v in axes.items()}
    b = int(np.broadcast_shapes(seeds.shape,
                                *(a.shape for a in arrs.values()))[0])
    return (np.broadcast_to(seeds, (b,)),
            {k: np.broadcast_to(a, (b,)) for k, a in arrs.items()}, b)


def run_plan(engine: VecEngine, plan, *, device, chunk_size=None,
             devices=None, with_report: bool = False,
             compact: bool = False, segment_iters=None,
             sharding: Optional[str] = None,
             on_chunk: Optional[Callable] = None,
             progress: Optional[Callable] = None,
             quarantine: bool = False):
    """Execute a :class:`BatchPlan` through the sweep layer on ``device``;
    ``plan.finalize`` then runs on the host outputs."""
    if compact or segment_iters is not None or progress is not None \
            or quarantine:
        raise NotImplementedError(
            f"compact / segment_iters / progress / quarantine: {NOT_PORTED}")
    if isinstance(plan, Done):
        out, report = plan.outputs, empty_report()
    else:
        out, report = execute_sweep(
            batched_sim(engine, plan.statics), plan.params, device=device,
            chunk_size=chunk_size, devices=devices,
            predicted_cost=plan.predicted_cost, sharding=sharding,
            on_chunk=on_chunk)
        if plan.finalize is not None:
            out = plan.finalize(out)
    return (out, report) if with_report else out


def make_batch_entry(engine: VecEngine, prepare: Callable, *,
                     kind: Optional[str] = None, register: bool = True,
                     name: Optional[str] = None,
                     doc: Optional[str] = None) -> Callable:
    """Build a sweep-routed batched entry point and register its scenario.

    ``prepare(*args, **kw)`` returns a :class:`BatchPlan` (or
    :class:`Done`).  The entry adds ``device`` (default ``"cuda"``) and the
    uniform sweep controls to ``prepare``'s signature; ``use_pallas`` is
    accepted so reference call sites run unchanged, and does not change
    which implementation runs.
    """
    kind = kind or engine.kind

    def entry(*args, device="cuda", use_pallas: Any = False,
              chunk_size=None, devices=None, with_report: bool = False,
              compact: bool = False, segment_iters=None, sharding: Optional[str] = None,
              on_chunk: Optional[Callable] = None,
              progress: Optional[Callable] = None,
              quarantine: bool = False, **kw):
        del use_pallas
        dev = resolve_device(device)
        plan = prepare(*args, **kw)
        return run_plan(engine, plan, device=dev, chunk_size=chunk_size,
                        devices=devices, with_report=with_report,
                        compact=compact, segment_iters=segment_iters, sharding=sharding,
                        on_chunk=on_chunk, progress=progress,
                        quarantine=quarantine)

    entry.__name__ = name or f"simulate_{kind}"
    entry.__qualname__ = entry.__name__
    if doc:
        entry.__doc__ = doc
    if register:
        scenario(kind)(entry)
    return entry
