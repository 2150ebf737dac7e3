"""Sweep execution — chunked, divergence-bucketed batch runs on one device.

Port of ``repro/core/sweep.py`` (``SweepReport``, ``SweepConfig``,
``auto_chunk_size``, single-device ``execute_sweep``).  The cell axis is
split into chunks run one after another on one device; the last chunk is
padded by repeating its final cell, and with a ``predicted_cost`` the cells
are sorted longest first before chunking and the permutation is undone on
output.  Lanes are independent, so chunked outputs are bit-identical to a
monolithic run.

Parameters stay on the host as numpy arrays; each chunk is gathered on the
host, copied to the device, run, and its outputs copied back, so the
outputs of :func:`execute_sweep` are numpy arrays as in the reference.

Not ported yet (ROADMAP "A. Modules still to port", item 13 — the
compacting scheduler and multi-device sweeps): ``devices`` > 1,
``sharding`` and ``compact=True`` raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

MIN_CHUNK = 16          # smaller dispatches are dominated by fixed overhead
_DIVERGENCE_SPREAD = 1.05   # predicted max/min above this ⇒ bucketing pays

NOT_PORTED = ("not ported yet: multi-device sweeps, sharding and the "
              "compacting scheduler wait for ROADMAP item A13")


# -- parameter pytrees (NamedTuples / tuples / dicts of arrays, None leaves) --

def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every array leaf; ``None`` leaves stay ``None``."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_map2(fn: Callable, a: Any, b: Any) -> Any:
    """``fn(x, y)`` over two trees of the same structure."""
    if a is None:
        return None
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*(tree_map2(fn, x, y) for x, y in zip(a, b)))
    if isinstance(a, (tuple, list)):
        return type(a)(tree_map2(fn, x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return {k: tree_map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def tree_leaves(tree: Any) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def to_device(tree: Any, device) -> Any:
    """numpy leaves → tensors on ``device`` (dtypes kept)."""
    return tree_map(lambda a: torch.from_numpy(
        np.ascontiguousarray(a)).to(device), tree)


@dataclass(frozen=True)
class SweepReport:
    """How one sweep was executed, and how well its lanes stayed busy.

    The reference's compaction and quarantine counters return with the
    compacting scheduler (ROADMAP item A13)."""
    n_cells: int
    chunk_size: int
    n_chunks: int
    devices: int
    bucketed: bool
    # Σ lane iterations / Σ_chunks (chunk max iterations × chunk lanes),
    # from the observed per-lane iteration counts.
    active_lane_fraction: Optional[float] = None
    # The same statistic had the whole grid run as one dispatch.
    active_lane_fraction_monolithic: Optional[float] = None
    lane_iterations: Optional[np.ndarray] = None
    # The fraction predicted_cost expected under the same chunk schedule.
    active_lane_fraction_predicted: Optional[float] = None
    sharding: Optional[str] = None

    def report_fields(self) -> Dict[str, Any]:
        """The uniform schedule slice every consumer records."""
        return dict(
            devices=self.devices, chunk_size=self.chunk_size,
            n_chunks=self.n_chunks, bucketed=self.bucketed,
            sharding=self.sharding,
            observed_active_lane_fraction=(
                round(self.active_lane_fraction, 4)
                if self.active_lane_fraction is not None else None),
            active_lane_fraction_predicted=(
                round(self.active_lane_fraction_predicted, 4)
                if self.active_lane_fraction_predicted is not None else None),
        )


@dataclass(frozen=True)
class SweepConfig:
    """How to *schedule* a sweep, separate from the scenario's parameters
    (the reference's fields, less ``donate``: the port's chunks reuse no
    buffers).

    ``precision`` is ``"exact"`` (f64) or ``"fast"`` (f32 loop) where the
    engine offers the opt-in (``fleet_batch``); ``None`` defers to the
    engine's default.

    ``use_pallas`` is accepted and ignored, so reference call sites run
    unchanged: in the port the device of the tensors decides whether a
    kernel runs.  ``compact``, ``sharding``, ``devices`` > 1,
    ``segment_iters``, ``progress`` and ``quarantine`` belong to paths not
    ported yet and raise ``NotImplementedError`` when set.  Only non-default
    fields are forwarded (:meth:`to_kwargs`).
    """

    compact: bool = False
    chunk_size: Optional[int] = None
    segment_iters: Optional[int] = None
    devices: Any = None
    sharding: Optional[str] = None
    on_chunk: Optional[Callable] = None
    progress: Optional[Callable] = None
    precision: Optional[str] = None
    use_pallas: Any = False
    quarantine: bool = False

    def __post_init__(self):
        if self.sharding not in (None, "pmap", "shard_map"):
            raise ValueError(
                f"sharding must be None, 'pmap' or 'shard_map': "
                f"{self.sharding!r}")
        if self.precision not in (None, "exact", "fast"):
            raise ValueError(
                f"precision must be None, 'exact' or 'fast': "
                f"{self.precision!r}")
        for name in ("chunk_size", "segment_iters"):
            v = getattr(self, name)
            if v is not None and int(v) < 1:
                raise ValueError(f"{name} must be ≥ 1: {v!r}")

    @classmethod
    def field_names(cls) -> tuple:
        return tuple(f.name for f in dataclasses.fields(cls))

    def to_kwargs(self) -> Dict[str, Any]:
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is not f.default and v != f.default:
                out[f.name] = v
        return out

    def replace(self, **changes: Any) -> "SweepConfig":
        return dataclasses.replace(self, **changes)


def check_single_device(devices: Any) -> None:
    """Accept ``None``/``"auto"``/``1``; anything asking for more devices
    raises ``NotImplementedError``."""
    if devices is None or devices == "auto" or devices == 1:
        return
    if isinstance(devices, (list, tuple)) and len(devices) == 1:
        return
    raise NotImplementedError(f"devices={devices!r}: {NOT_PORTED}")


def auto_chunk_size(n_cells: int, predicted_cost, n_devices: int) -> int:
    """Default chunking policy (verbatim from the reference): monolithic
    unless ``predicted_cost`` shows a spread; then ~8 balanced chunks of at
    least ``MIN_CHUNK`` lanes per device."""
    n_devices = max(1, min(int(n_devices), max(int(n_cells), 1)))
    if predicted_cost is None or n_cells < 2 * MIN_CHUNK * n_devices:
        return n_cells
    pred = np.asarray(predicted_cost, np.float64)
    pos = pred[pred > 0]
    if pos.size == 0 or float(pos.max()) / float(pos.min()) <= \
            _DIVERGENCE_SPREAD:
        return n_cells
    raw = max(MIN_CHUNK * n_devices, n_cells // 8)
    n_chunks = max(1, n_cells // raw)
    chunk = -(-n_cells // n_chunks)                      # balanced split
    chunk = int(-(-chunk // n_devices) * n_devices)      # device multiple
    return n_cells if chunk >= n_cells else chunk


def _take(params, idx: np.ndarray):
    """Gather cells ``idx`` along every leaf's leading axis (host side)."""
    return tree_map(lambda leaf: np.take(np.asarray(leaf), idx, axis=0),
                    params)


def _to_host(out: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in out.items()}


def execute_sweep(fn: Callable[[Any], Dict[str, Any]], params: Any, *,
                  device, chunk_size: Optional[int] = None,
                  devices: Any = None, predicted_cost=None,
                  iterations_key: str = "iterations",
                  sharding: Optional[str] = None,
                  on_chunk: Optional[Callable] = None):
    """Run a batched simulator over its cell axis in scheduled chunks.

    ``fn(params) -> dict of tensors`` takes a params tree of tensors on
    ``device`` with the cell axis first and returns per-cell outputs with
    the cell axis first.  Returns ``(outputs, SweepReport)`` with numpy
    outputs in the original cell order, bit-identical to one monolithic
    call.  ``on_chunk(cells, outputs)`` receives each finished chunk.
    """
    check_single_device(devices)
    if sharding is not None:
        raise NotImplementedError(f"sharding={sharding!r}: {NOT_PORTED}")
    leaves = tree_leaves(params)
    if not leaves:
        raise ValueError("execute_sweep: params pytree has no array leaves")
    n_cells = int(np.shape(leaves[0])[0])
    if n_cells == 0:
        out = _to_host(fn(to_device(params, device)))
        return out, SweepReport(
            n_cells=0, chunk_size=0, n_chunks=0, devices=1, bucketed=False)
    if chunk_size is None:
        chunk_size = auto_chunk_size(n_cells, predicted_cost, 1)
    chunk_size = max(1, min(int(chunk_size), n_cells))

    bucketed = predicted_cost is not None and chunk_size < n_cells
    if bucketed:
        pred = np.asarray(predicted_cost, np.float64)
        if pred.shape != (n_cells,):
            raise ValueError(
                f"predicted_cost shape {pred.shape} != ({n_cells},)")
        order = np.argsort(-pred, kind="stable")     # longest lanes together
    else:
        order = np.arange(n_cells)

    chunks, chunk_meta = [], []
    for lo in range(0, n_cells, chunk_size):
        idx = order[lo:lo + chunk_size]
        real = len(idx)
        if real < chunk_size:                        # pad: repeat final cell
            idx = np.concatenate(
                [idx, np.full(chunk_size - real, idx[-1], idx.dtype)])
        out = _to_host(fn(to_device(_take(params, idx), device)))
        chunks.append({k: v[:real] for k, v in out.items()})
        chunk_meta.append(real)
        if on_chunk is not None:
            on_chunk(idx[:real].copy(),
                     {k: v[:real].copy() for k, v in out.items()})

    inv = np.argsort(order, kind="stable")
    outputs = {k: np.concatenate([c[k] for c in chunks])[inv]
               for k in chunks[0]}

    spans = list(zip(range(0, n_cells, chunk_size), chunk_meta))

    def _schedule_fraction(per_lane) -> Optional[float]:
        per_lane = np.asarray(per_lane, np.float64)
        if per_lane.shape != (n_cells,) or per_lane.max() <= 0:
            return None
        ordered = per_lane[order]
        executed = sum(float(ordered[lo:lo + chunk_size].max()) * real
                       for lo, real in spans)
        return float(per_lane.sum()) / executed if executed > 0 else None

    frac = frac_mono = lane_iters = None
    if iterations_key in outputs:
        lane_iters = np.asarray(outputs[iterations_key], np.int64)
        if lane_iters.shape == (n_cells,) and lane_iters.max() > 0:
            frac = _schedule_fraction(lane_iters)
            frac_mono = (int(lane_iters.sum())
                         / (int(lane_iters.max()) * n_cells))
    frac_pred = (_schedule_fraction(predicted_cost)
                 if predicted_cost is not None else None)
    report = SweepReport(
        n_cells=n_cells, chunk_size=chunk_size,
        n_chunks=len(chunk_meta), devices=1, bucketed=bucketed,
        active_lane_fraction=frac,
        active_lane_fraction_monolithic=frac_mono,
        lane_iterations=lane_iters,
        active_lane_fraction_predicted=frac_pred)
    return outputs, report
