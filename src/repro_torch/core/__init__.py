"""The port's simulator core: sweep driver, registry and ported engines.

``run_sweep(kind, params, config=SweepConfig(...), device="cuda")`` is the
entry point; ported kinds: ``fleet``, ``fleet_batch``, ``netdc_batch``,
``power_batch``.
"""
from .backend import (BackendError, ScenarioResult,  # noqa: F401
                      ScenarioUnsupported, run_scenario, run_sweep,
                      scenario_kinds, validate_scenario_params)
from .sweep import SweepConfig, SweepReport, execute_sweep  # noqa: F401
