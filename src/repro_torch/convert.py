"""Carry a reference ``BatchPlan``'s tables into the port.

``params_from_reference`` turns the numpy leaves of a JAX-package plan
(``vec_netdc._Params``, ``vec_power._Params``, by field name) and its
statics (a mapping of the same field names) into the
port's params tensors and statics, so both engines can run identical
tables — the simulator's counterpart of carrying weights across.  No JAX
object is touched: the caller hands over numpy arrays and plain values.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from .core import vec_netdc, vec_power
from .core.sweep import to_device
from .device import resolve_device

_KINDS = {
    "netdc_batch": (vec_netdc._Params, vec_netdc._Statics),
    "power_batch": (vec_power._Params, vec_power._Statics),
}


def params_from_reference(kind: str, arrays: Mapping[str, np.ndarray],
                          statics: Mapping[str, Any], device="cuda"):
    """``(params, statics)`` for the port's engine of ``kind``.

    ``arrays`` maps each ``_Params`` field to a numpy array with the cell
    axis first (a missing optional field stays ``None``); dtypes are kept.
    ``statics`` supplies the port's statics fields (the reference's
    ``use_pallas`` field, which the port does not have, is ignored).
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
    return to_device(params, dev), st


__all__ = ["params_from_reference"]
