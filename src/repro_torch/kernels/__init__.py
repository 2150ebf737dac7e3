"""Hand-written CUDA kernels of the port, each with its plain version.

  next_event.py / csrc/next_event.cu — fused masked (min, argmin) over the
      last axis (replaces ``repro/kernels/next_event.py::next_event``)
  power_scan.py / csrc/power_scan.cu — the whole ``power_batch`` interval
      loop in one launch (replaces ``repro/kernels/step.py::fused_scan``)
  ops.py — the masked reductions the engines call
  _build.py — nvcc build of ``csrc/`` at first use, loaded with ctypes

Nothing is compiled or loaded at import time.
"""
