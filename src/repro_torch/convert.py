"""Carry a reference ``BatchPlan``'s tables into the port.

``params_from_reference`` turns the numpy leaves of a JAX-package plan
(``vec_netdc._Params``, ``vec_power._Params``, ``vec_cluster._Params``, by
field name) and its statics (a mapping of the same field names) into the
port's params tensors and statics, so both engines can run identical
tables — the simulator's counterpart of carrying weights across.  For
``fleet_batch`` the reference draws its random schedules inside the loop's
build; the caller passes them as ``tables`` (``fail_start``,
``degrade_t``, ``bias0``), so the port runs the reference's own sample.
No JAX object is touched: the caller hands over numpy arrays and plain
values.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from .core import vec_cluster, vec_netdc, vec_power
from .core.sweep import to_device
from .device import resolve_device

_KINDS = {
    "fleet_batch": (vec_cluster._Params, vec_cluster._Statics),
    "netdc_batch": (vec_netdc._Params, vec_netdc._Statics),
    "power_batch": (vec_power._Params, vec_power._Statics),
}


def _fleet_tables(tables: Mapping[str, np.ndarray], b: int, st):
    """The port's ``_Tables`` from the reference's schedules: ``fail_start
    [B, n, K]``, ``bias0`` (``[B, n]``, or ``[B]`` when the per-node path
    is off) and, when ``st.degrade``, ``degrade_t [B, n, k_degrade]``.
    Only σ = 0 runs are carried (the per-step draws differ), so the lane
    seeds are 0; planned-outage windows are not carried."""
    if st.n_fault_windows:
        raise ValueError("params_from_reference('fleet_batch'): fault "
                         "windows are not carried")
    missing = [k for k in ("fail_start", "bias0") if k not in tables]
    if st.degrade and "degrade_t" not in tables:
        missing.append("degrade_t")
    if missing:
        raise ValueError(f"params_from_reference('fleet_batch'): missing "
                         f"tables {missing}")
    bias0 = np.asarray(tables["bias0"], np.float64)
    return vec_cluster._Tables(
        fail_start=np.asarray(tables["fail_start"], np.float64),
        bias0=np.broadcast_to(bias0.reshape(b, -1), (b, st.n_total)).copy(),
        seed=np.zeros(b, np.int64),
        degrade_t=(np.asarray(tables["degrade_t"], np.float64)
                   if st.degrade else None))


def params_from_reference(kind: str, arrays: Mapping[str, np.ndarray],
                          statics: Mapping[str, Any], device="cuda",
                          tables: Mapping[str, np.ndarray] = None):
    """``(params, statics)`` for the port's engine of ``kind``.

    ``arrays`` maps each ``_Params`` field to a numpy array with the cell
    axis first (a missing optional field stays ``None``); dtypes are kept.
    ``statics`` supplies the port's statics fields (the reference's
    ``use_pallas`` field, which the port does not have, is ignored).
    ``tables`` carries the fleet's random schedules (``fleet_batch`` only,
    where it is required): the params tree is then ``(_Params,
    _Tables)``.
    """
    try:
        params_t, statics_t = _KINDS[kind]
    except KeyError:
        raise ValueError(f"params_from_reference: kind {kind!r} is not "
                         f"ported; ported: {sorted(_KINDS)}") from None
    dev = resolve_device(device)
    missing = [f for f in params_t._fields
               if f not in arrays and f not in params_t._field_defaults]
    if missing:
        raise ValueError(f"params_from_reference({kind!r}): missing "
                         f"arrays {missing}")
    params = params_t(**{f: (np.asarray(arrays[f]) if f in arrays else None)
                         for f in params_t._fields})
    names = (statics_t._fields if hasattr(statics_t, "_fields")
             else tuple(statics_t.__dataclass_fields__))
    st = statics_t(**{k: statics[k] for k in names if k in statics})
    if kind == "fleet_batch":
        if tables is None:
            raise ValueError("params_from_reference('fleet_batch') needs "
                             "tables= (fail_start, bias0, degrade_t)")
        b = int(np.shape(params.base_step_s)[0])
        params = (params, _fleet_tables(tables, b, st))
    elif tables is not None:
        raise ValueError(f"params_from_reference({kind!r}) takes no "
                         f"tables")
    return to_device(params, dev), st


__all__ = ["params_from_reference"]
