"""Masked next-event reductions — the engines' shared ops.

Port of ``repro/kernels/ops.py``'s ``masked_min``/``masked_argmin``/
``masked_argmax`` and ``MaskedOps``.  Contracts (from the reference's
``tests/test_masked_ops.py``):

  * the reduction is over the **last** axis; ``mask=False`` slots are
    ignored;
  * an all-masked row returns ``(inf, 0)``;
  * ties break to the **first occurrence**.

All three go through :func:`repro_torch.kernels.next_event.next_event`, so
the tensor's device decides: the CUDA kernel on the card, the plain version
on the CPU.  There is no switch and no fallback: the reference's
``use_pallas`` resolution has no counterpart here.  Indices are int32.
"""
from __future__ import annotations

from dataclasses import dataclass

from .next_event import next_event, next_event_ref


def masked_min(values, mask=None):
    """Masked min over the last axis (``inf`` when everything is masked)."""
    return next_event(values, mask)[0]


def masked_argmin(values, mask=None):
    """First-occurrence masked argmin over the last axis (0 when all
    masked)."""
    return next_event(values, mask)[1]


def masked_argmax(values, mask=None):
    """First-occurrence masked argmax over the last axis (0 when all
    masked): the first occurrence of the minimum of ``-values`` is the first
    occurrence of the maximum of ``values``."""
    return next_event(-values, mask)[1]


@dataclass(frozen=True)
class MaskedOps:
    """The masked reductions an engine's ``build`` receives, so scenario
    code writes ``ops.argmin(...)``."""

    def min(self, values, mask=None):
        return masked_min(values, mask)

    def argmin(self, values, mask=None):
        return masked_argmin(values, mask)

    def argmax(self, values, mask=None):
        return masked_argmax(values, mask)


class PlainOps:
    """The same reductions through the plain next_event on any device: the
    kernels' plain versions use them, so that a comparison on the card
    launches no kernel."""

    @staticmethod
    def min(values, mask=None):
        return next_event_ref(values, mask)[0]

    @staticmethod
    def argmin(values, mask=None):
        return next_event_ref(values, mask)[1]

    @staticmethod
    def argmax(values, mask=None):
        return next_event_ref(-values, mask)[1]
