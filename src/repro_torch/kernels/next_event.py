"""Fused masked (min, argmin) next-event reduction — CUDA kernel + plain version.

Port of ``repro/kernels/next_event.py``.  ``times [..., M]`` (optional bool
``mask``, False ⇒ ignore the slot) → ``(vmin [...], argmin [...] int32)``
over the last axis: ties go to the first occurrence, and an all-masked row
gives ``(inf, 0)``, exactly like ``min``/``argmin`` over an all-+inf row.

A CUDA tensor runs the hand-written kernel (``csrc/next_event.cu``) or the
call raises; a CPU tensor runs :func:`next_event_ref`.  Inputs must not hold
NaN (the engines never produce one).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_DTYPES = {torch.float32: "next_event_f32", torch.float64: "next_event_f64"}


def next_event_ref(times: torch.Tensor, mask: torch.Tensor | None = None):
    """Plain PyTorch version: two separate reductions."""
    if mask is not None:
        times = torch.where(mask, times, float("inf"))
    return (torch.amin(times, dim=-1),
            torch.argmin(times, dim=-1).to(torch.int32))


def _check(times: torch.Tensor, mask):
    if times.dtype not in _DTYPES:
        raise TypeError(f"next_event takes float32 or float64, got "
                        f"{times.dtype}")
    if times.dim() < 1 or times.shape[-1] == 0:
        raise ValueError(f"next_event needs a non-empty last axis, got "
                         f"shape {tuple(times.shape)}")
    if mask is not None:
        if mask.dtype != torch.bool or mask.shape != times.shape:
            raise ValueError(f"mask must be bool of shape "
                             f"{tuple(times.shape)}, got {mask.dtype} "
                             f"{tuple(mask.shape)}")
        if mask.device != times.device:
            raise ValueError("mask and times lie on different devices")


@functools.lru_cache(maxsize=None)
def _entry(symbol: str):
    p, n = ctypes.c_void_p, ctypes.c_longlong
    return _build.entry("next_event", symbol, (p, p, n, n, p, p, p))


def _launch(times: torch.Tensor, mask):
    fn = _entry(_DTYPES[times.dtype])
    lead, m = times.shape[:-1], times.shape[-1]
    t2 = times.reshape(-1, m).contiguous()
    m2 = None if mask is None else mask.reshape(-1, m).contiguous()
    rows = t2.shape[0]
    vmin = torch.empty(rows, dtype=times.dtype, device=times.device)
    imin = torch.empty(rows, dtype=torch.int32, device=times.device)
    if rows:
        with torch.cuda.device(times.device):
            rc = fn(t2.data_ptr(), None if m2 is None else m2.data_ptr(),
                    rows, m, vmin.data_ptr(), imin.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
        _build.check("next_event", rc, "next_event")
        next_event.launches += 1
    return vmin.reshape(lead), imin.reshape(lead)


def next_event(times: torch.Tensor, mask: torch.Tensor | None = None):
    """Fused masked (min, argmin) over the last axis; see module doc.

    ``next_event.launches`` counts kernel launches (CPU calls run the
    plain version and do not count)."""
    _check(times, mask)
    if times.device.type == "cuda":
        return _launch(times, mask)
    if times.device.type == "cpu":
        return next_event_ref(times, mask)
    raise ValueError(f"next_event runs on cuda or cpu, got {times.device}")


next_event.launches = 0
