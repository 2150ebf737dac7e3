"""PyTorch port of the batched ``vec`` simulator, for one NVIDIA H100.

Layout mirrors the JAX package: ``core/`` holds the sweep driver, the
scenario registry and the engines; ``kernels/`` holds the hand-written
CUDA kernels (``kernels/csrc``) with a plain PyTorch version beside each.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; the device of the tensors decides whether a kernel or
its plain version runs.  Nothing here imports JAX.

Ported so far: ``netdc_batch``, ``power_batch`` and ``fleet_batch`` (with
the single-scenario ``fleet``) through ``repro_torch.core.run_sweep``.
"""
from .device import resolve_device  # noqa: F401
