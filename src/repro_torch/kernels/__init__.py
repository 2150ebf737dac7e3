"""Hand-written CUDA kernels of the port, each with its plain version.

  next_event.py / csrc/next_event.cu — fused masked (min, argmin) over the
      last axis (replaces ``repro/kernels/next_event.py::next_event``)
  power_scan.py / csrc/power_scan.cu — the whole ``power_batch`` interval
      loop in one launch (replaces ``repro/kernels/step.py::fused_scan``)
  fleet_step.py / csrc/fleet_loop.cu — the whole ``fleet_batch``
      while-loop per lane in one launch (replaces
      ``repro/kernels/step.py::fused_step_body``)
  fleet_rng.py — the fleet loop's counter-based random stream (Philox,
      Box–Muller, AS241), repeated op for op in the kernel
  ops.py — the masked reductions the engines call
  _build.py — nvcc build of ``csrc/`` at first use, loaded with ctypes

Nothing is compiled or loaded at import time.
"""
