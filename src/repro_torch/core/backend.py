"""The port's scenario registry and its sweep entry point.

Port of ``repro/core/backend.py``'s ``scenario``, ``run_scenario``,
``run_sweep``, ``ScenarioResult`` and ``validate_scenario_params``, with the
``vec`` backend only.  Scenario modules register on first dispatch; the
registry counts as loaded only once every module imported, so one failed
import does not leave it partial for the rest of the process.

A kind that is not ported raises :class:`ScenarioUnsupported`, naming the
ported kinds.  ``device`` (default ``"cuda"``) selects where the sweep runs;
without CUDA the default raises and ``device="cpu"`` runs the plain
PyTorch versions.
"""
from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, List, Mapping, Tuple

import numpy as np


class BackendError(LookupError):
    """Unknown backend or scenario kind."""


class ScenarioUnsupported(BackendError):
    """The scenario kind exists in the reference but is not ported."""


BACKEND = "vec"

_SCENARIOS: Dict[str, Callable[..., Any]] = {}
_SCENARIO_MODULES: Tuple[str, ...] = (
    "repro_torch.core.vec_cluster",
    "repro_torch.core.vec_netdc",
    "repro_torch.core.vec_power",
)
_loaded = False


def scenario(kind: str):
    """Decorator: register ``fn(**params)`` as the ``vec`` implementation
    of ``kind``."""
    def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
        _SCENARIOS[kind] = fn
        return fn
    return deco


def _load_scenarios() -> None:
    global _loaded
    if _loaded:
        return
    for mod in _SCENARIO_MODULES:
        importlib.import_module(mod)
    _loaded = True


def scenario_kinds() -> List[str]:
    _load_scenarios()
    return sorted(_SCENARIOS)


def _handler(kind: str, backend: str) -> Callable[..., Any]:
    if backend != BACKEND:
        raise BackendError(f"unknown backend {backend!r}; the port has "
                           f"only {BACKEND!r}")
    _load_scenarios()
    handler = _SCENARIOS.get(kind)
    if handler is None:
        raise ScenarioUnsupported(
            f"scenario {kind!r} is not ported to repro_torch; ported: "
            f"{', '.join(scenario_kinds())}")
    return handler


def run_scenario(kind: str, *, backend: str = BACKEND, device="cuda",
                 **params: Any) -> Any:
    """Run one batched scenario kind on ``device``."""
    return _handler(kind, backend)(device=device, **params)


class ScenarioResult(tuple):
    """``(outputs, SweepReport)`` with typed accessors, as in the
    reference."""

    def __new__(cls, outputs: Any, report: Any, *, kind: str = "",
                backend: str = "") -> "ScenarioResult":
        self = tuple.__new__(cls, (outputs, report))
        self.kind = kind
        self.backend = backend
        return self

    @property
    def outputs(self) -> Any:
        return self[0]

    @property
    def report(self) -> Any:
        return self[1]

    def report_fields(self) -> Dict[str, Any]:
        return self.report.report_fields()

    def summary(self) -> Dict[str, Any]:
        """Scalar digest: the finite mean of every numeric output array."""
        s: Dict[str, Any] = {"kind": self.kind, "backend": self.backend,
                             "n_cells": self.report.n_cells}
        out = self.outputs
        items = sorted(out.items()) if isinstance(out, Mapping) else ()
        for k, v in items:
            a = np.asarray(v)
            if a.dtype.kind not in "bifu" or a.size == 0:
                continue
            finite = a[np.isfinite(a.astype(np.float64))]
            s[k] = float(finite.mean()) if finite.size else None
        return s

    def __repr__(self) -> str:
        return (f"ScenarioResult(kind={self.kind!r}, "
                f"backend={self.backend!r}, n_cells={self.report.n_cells})")


# -- scenario-parameter validation (run_sweep entry), verbatim -----------------

_POSITIVE_PARAMS = frozenset({
    "mean_gap_s", "link_bw", "dc_mips", "host_mips", "vm_mips",
    "guest_mips", "mtbf_hours", "mtbf_hours_node", "degrade_mtbf_hours",
    "interval", "total_steps", "n_samples",
})
_NONNEGATIVE_PARAMS = frozenset({
    "hop_latency_s", "slo_ttft_s", "kv_penalty_s", "payload_mb",
    "locality_weight", "up_thr", "lo_thr", "cooldown", "offline_frac",
    "demand", "placement_weight", "repair_bias_s",
})
_INF_OK = frozenset({"timeout_s", "budget_s"})


def validate_scenario_params(kind: str, params: Mapping[str, Any]) -> None:
    """Reject non-finite or sign-invalid scenario parameter arrays before
    anything runs, naming the offending key and index."""
    for key, val in params.items():
        try:
            arr = np.asarray(val)
        except Exception:
            continue
        if arr.dtype.kind == "f":
            bad = np.isnan(arr) if key in _INF_OK else ~np.isfinite(arr)
            if bad.any():
                idx = np.unravel_index(int(np.argmax(bad)), arr.shape)
                loc = "".join(f"[{i}]" for i in idx)
                raise ValueError(
                    f"run_sweep({kind!r}): params[{key!r}]{loc} = "
                    f"{arr[idx]} — scenario parameters must be finite")
        if arr.dtype.kind not in "fiu" or arr.size == 0:
            continue
        if key in _POSITIVE_PARAMS:
            bad = ~(arr > 0)
        elif key in _NONNEGATIVE_PARAMS:
            bad = ~(arr >= 0)
        else:
            continue
        if bad.any():
            idx = np.unravel_index(int(np.argmax(bad)), arr.shape)
            loc = "".join(f"[{i}]" for i in idx)
            bound = ("> 0 (a positive rate/capacity/MTBF)"
                     if key in _POSITIVE_PARAMS else ">= 0")
            raise ValueError(
                f"run_sweep({kind!r}): params[{key!r}]{loc} = {arr[idx]} "
                f"— must be {bound}")


def run_sweep(kind: str, params: Mapping[str, Any], *,
              backend: str = BACKEND, config: Any = None,
              device="cuda") -> ScenarioResult:
    """Run a batched scenario kind and return a :class:`ScenarioResult`.

    ``run_sweep("netdc_batch", dict(seeds=range(64), n_dcs=8),
    config=SweepConfig(chunk_size=32), device="cuda")``: scenario
    parameters go in ``params``, sweep controls in ``config``.
    """
    from .sweep import SweepConfig
    if config is None:
        config = SweepConfig()
    if not isinstance(config, SweepConfig):
        raise TypeError(
            f"config must be a SweepConfig, got {type(config).__name__}; "
            f"scenario parameters go in the params dict")
    if not isinstance(params, Mapping):
        raise TypeError(
            f"params must be a mapping of scenario parameters, got "
            f"{type(params).__name__}")
    misplaced = sorted(set(params) & set(SweepConfig.field_names()))
    if misplaced:
        raise TypeError(
            f"sweep control(s) {misplaced} belong in "
            f"config=SweepConfig(...), not in the params dict")
    validate_scenario_params(kind, params)
    out, report = run_scenario(kind, backend=backend, device=device,
                               with_report=True, **params,
                               **config.to_kwargs())
    return ScenarioResult(out, report, kind=kind, backend=backend)
