"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, one or more lines each:

1. device — ``nvidia-smi`` name and power limit, torch's device name;
2. build — the three CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, started together);
3. kernels — each kernel against its plain PyTorch version on the card,
   bit-exact, at the main path's shapes, with times: next_event at the
   netdc shape ([1024, 16] f64) and at [4096, 1500] f32/f64 with ties and
   all-masked rows, and its launch floor at [1, 1]; power_scan on 8 lanes
   at H = 800 (unfaulted, faulted, scaling out) and at H = 2000, and at
   the full sweep's shape (1024 lanes, H = 800), checked and timed;
   fleet_loop on 8 lanes of 1056 nodes in every statics branch (eviction
   and degradation with σ > 0, the inverse-CDF max, σ = 0, degradation
   only, a FaultPlan; f64 and f32), at ``max_iters`` 1 and 7 and one
   ``fleet_step``, and on all 1152 lanes of the main path's grid for its
   first 4096 iterations, checked and timed;
4. golden — ``tests/golden/{netdc_batch,netdc_chaos,power_batch}.json``
   reproduced on the card, bit-exact;
5. main path — ``run_sweep`` on the card at full size: netdc_batch (1024
   cells, 16 DCs, 2048 jobs), power_batch (1024 cells, 800 hosts, 1052
   VMs, 288 five-minute intervals) and fleet_batch (1152 cells: the
   reference's default 1024 + 32-node fleet, MTBF {100, 500, 2000} h ×
   checkpoint every {50, 200, 1000} steps × 128 seeds, 2000 steps), each
   with its kernel launch counts set to 0 just before and read just
   after; the first 8 cells rerun on the CPU must match bit for bit (for
   the fleet, of a σ = 0, degradation-off copy of the grid); then the
   same plans again with the host table build, the copies, the event loop
   and the finalize timed apart, and the torch ops dispatched per netdc
   routing decision counted.

Any failed check exits non-zero before the last line.  The line before
the last is a JSON object ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the
repository around it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time
from dataclasses import replace

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
F64_OPS_PER_S = 34e12            # H100 SXM FP64 outside the tensor cores
F32_OPS_PER_S = 67e12            # H100 SXM FP32 outside the tensor cores


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(tag: str, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call, CUDA events around ``reps`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> float:
    """Largest |a - b| over matching tensors (0.0 when bit-identical);
    inf when any element differs in an infinite slot or in shape."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return math.inf
    if a.dtype == torch.bool:
        return float((a != b).sum())
    if a.is_floating_point():
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        if bool(same.all()):
            return 0.0
        d = (a.double() - b.double()).abs()
        return float(torch.where(same, 0.0, d).max())
    return float((a.long() - b.long()).abs().max()) if a.numel() else 0.0


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"src/repro_torch not found beside {__file__}: run from a "
             f"checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core import run_sweep
    from repro_torch.core.cluster import FleetConfig, StepCost
    from repro_torch.core.faults import FaultEvent, FaultPlan, RetryPolicy
    from repro_torch.core.sweep import to_device
    from repro_torch.core.vec_cluster import (FLEET_ENGINE, _fleet_build,
                                              _prepare_fleet, loop_inputs)
    from repro_torch.core.vec_engine import run_one
    from repro_torch.core.vec_netdc import NETDC_ENGINE, _prepare_netdc
    from repro_torch.core.vec_power import (POWER_ENGINE, _power_build,
                                            _prepare_power)
    from repro_torch.kernels import _build
    from repro_torch.kernels import next_event as ne_mod
    from repro_torch.kernels.fleet_step import (fleet_loop, fleet_loop_ref,
                                                fleet_step)
    from repro_torch.kernels.next_event import next_event, next_event_ref
    from repro_torch.kernels.ops import MaskedOps, PlainOps
    from repro_torch.kernels.power_scan import power_scan, power_scan_ref

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # -- 1. device -------------------------------------------------------------
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except OSError as e:
        fail(f"nvidia-smi did not run: {e}")
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    device_name = torch.cuda.get_device_name(0)
    phase("device", torch=torch.__version__, cuda=torch.version.cuda,
          name=repr(device_name), count=torch.cuda.device_count())

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    took = _build.build(["next_event", "power_scan", "fleet_loop"])
    phase("build", seconds=f"{time.perf_counter() - t0:.2f}",
          per_source={k: round(v, 2) for k, v in took.items()},
          into=_build.BUILD_DIR.relative_to(ROOT))

    results = {}

    # -- 3a. next_event against its plain version ------------------------------
    def ne_inputs(r, m, dtype, seed):
        g = torch.Generator(device="cpu").manual_seed(seed)
        vals = torch.tensor([0.25, 1.5, 3.0, 7.25, math.inf], dtype=dtype)
        t = vals[torch.randint(0, 5, (r, m), generator=g)]
        mask = torch.rand((r, m), generator=g) < 0.7
        t[1] = math.inf                # an all-+inf row
        mask[2] = False                # an all-masked row
        return t.to(dev), mask.to(dev)

    ne_rows = []
    for r, m, dtype, reps in ((1024, 16, torch.float64, 500),
                              (4096, 1500, torch.float32, 50),
                              (4096, 1500, torch.float64, 50)):
        t, mask = ne_inputs(r, m, dtype, seed=r + m)
        v_k, i_k = next_event(t, mask)
        v_p, i_p = next_event_ref(t, mask)
        torch.cuda.synchronize()
        err = max(max_abs_err(v_k, v_p), max_abs_err(i_k, i_p))
        ties = int((t == t.amin(-1, keepdim=True)).sum(-1).gt(1).sum())
        if err != 0.0:
            fail(f"next_event [{r}, {m}] {dtype}: kernel != plain "
                 f"(max_abs_err {err})")
        inf = torch.tensor(math.inf, dtype=dtype, device=dev)
        ms = cuda_ms(lambda: next_event(t, mask), reps)
        # The bare C entry on preallocated outputs: the kernel without the
        # Python wrapper's checks and allocations.
        c_fn = ne_mod._entry(ne_mod._DTYPES[dtype])
        vout = torch.empty(r, dtype=dtype, device=dev)
        iout = torch.empty(r, dtype=torch.int32, device=dev)
        c_args = (t.data_ptr(), mask.data_ptr(), r, m, vout.data_ptr(),
                  iout.data_ptr(), torch.cuda.current_stream().cuda_stream)
        bare = cuda_ms(lambda: c_fn(*c_args), reps)
        plain = cuda_ms(lambda: next_event_ref(t, mask), reps)
        lib = cuda_ms(lambda: torch.min(torch.where(mask, t, inf), dim=-1),
                      reps)
        item = t.element_size()
        nbytes = r * m * (item + 1) + r * (item + 4)
        b_ms, b_by = bound_ms(nbytes, r * m, F64_OPS_PER_S
                              if dtype == torch.float64 else F32_OPS_PER_S)
        ne_rows.append(dict(shape=[r, m], dtype=str(dtype), ms=ms,
                            plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                            bound_by=b_by, max_abs_err=err))
        phase("kernel", name="next_event", shape=f"[{r},{m}]",
              dtype=str(dtype).replace("torch.", ""), rows_with_ties=ties,
              bit_exact=True, ms=f"{ms:.5f}", bare_c_entry_ms=f"{bare:.5f}",
              plain_ms=f"{plain:.5f}",
              library_ms=f"{lib:.5f}", bound_ms=f"{b_ms:.6f}")
    # The launch floor: the same kernel on one element, through the wrapper
    # and through the bare C entry (the least a call of it can take).
    t1 = torch.ones((1, 1), dtype=torch.float64, device=dev)
    m1 = torch.ones((1, 1), dtype=torch.bool, device=dev)
    floor = cuda_ms(lambda: next_event(t1, m1), 500)
    c_fn = ne_mod._entry(ne_mod._DTYPES[torch.float64])
    vout = torch.empty(1, dtype=torch.float64, device=dev)
    iout = torch.empty(1, dtype=torch.int32, device=dev)
    c_args = (t1.data_ptr(), m1.data_ptr(), 1, 1, vout.data_ptr(),
              iout.data_ptr(), torch.cuda.current_stream().cuda_stream)
    bare_floor = cuda_ms(lambda: c_fn(*c_args), 500)
    phase("kernel", name="next_event", shape="[1,1]", ms=f"{floor:.5f}",
          bare_c_entry_ms=f"{bare_floor:.5f}",
          note="launch floor: one element through the wrapper / bare entry")
    ne_rows[0]["launch_floor_ms"] = bare_floor
    results["next_event"] = ne_rows

    # -- 3b. power_scan against its plain version ------------------------------
    def power_plan(b, fault_plan=None, **kw):
        cfg = dict(seeds=np.arange(b), n_hosts=800, n_vms=1052,
                   n_samples=288, interval=300.0,
                   up_thr=np.resize([0.7, 0.8, 0.9], b),
                   cooldown=np.resize([1, 3], b))
        cfg.update(kw)
        plan = _prepare_power(fault_plan=fault_plan, **cfg)
        params = to_device(plan.params, dev)
        init = _power_build(params, plan.statics, MaskedOps()).init
        return params, plan.statics, init

    crash = FaultPlan([FaultEvent("node", 3000.0, 40000.0, target=h)
                       for h in range(0, 800, 3)]
                      + [FaultEvent("node", 50000.0, 60000.0, target=h)
                         for h in range(100, 700)], seed=1)
    ps_checks = []
    for label, fp, kw in (
            ("unfaulted", None, {}),
            ("faulted", crash, {}),
            ("busy", crash, dict(n_vms=6000, init_active=300, lo_thr=0.4,
                                 cooldown=0)),
            # Beyond 1024 hosts: threads stride, the shared carry exceeds
            # the default 48 KB of shared memory.
            ("wide", None, dict(n_hosts=2000, n_vms=20000, init_active=1200,
                                cooldown=0))):
        params, st, init = power_plan(8, fp, **kw)
        got = power_scan(init, params, st)
        want = power_scan_ref(init, params, st)
        torch.cuda.synchronize()
        err = max(max_abs_err(a, b) for a, b in zip(got, want))
        if err != 0.0:
            bad = [f for f, a, b in zip(got._fields, got, want)
                   if max_abs_err(a, b) != 0.0]
            fail(f"power_scan {label}: kernel != plain in {bad}")
        ps_checks.append(err)
        phase("kernel", name="power_scan", lanes=8, hosts=st.n_hosts,
              intervals=st.n_intervals, case=label, bit_exact=True,
              scale_out=got.scale_out.tolist(),
              scale_in=got.scale_in.tolist(),
              migrations=got.migrations.tolist())
    # The main path's shape: all 1024 lanes held against the plain version.
    params, st, init = power_plan(1024)
    ms = cuda_ms(lambda: power_scan(init, params, st), 5, warmup=1)
    got = power_scan(init, params, st)
    t0 = time.perf_counter()
    want = power_scan_ref(init, params, st)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    errs = {f: max_abs_err(a, b) for f, a, b in zip(got._fields, got, want)}
    if any(e != 0.0 for e in errs.values()):
        fail(f"power_scan 1024 lanes: kernel != plain in "
             f"{[f for f, e in errs.items() if e != 0.0]}")
    ps_checks.append(max(errs.values()))
    phase("kernel", name="power_scan", lanes=1024, hosts=st.n_hosts,
          intervals=st.n_intervals, case="main path shape", bit_exact=True,
          fields=len(errs))
    del got, want
    b, h, k, s = 1024, 800, 288, 10
    carry = h * (4 + 1 + 4 + 8 + s * (4 + 8)) + 4 * 4
    nbytes = b * (k * 8 + h * 16 + 8 * 3 + 4 + 2 * carry)
    # ~10 f64 operations per host and interval (multiply, divide, min,
    # multiply, fmod, compare, add, max, subtract, add).
    b_ms, b_by = bound_ms(nbytes, 10 * b * h * k, F64_OPS_PER_S)
    results["power_scan"] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                                 bound_by=b_by, max_abs_err=max(ps_checks))
    phase("kernel", name="power_scan", lanes=b, hosts=h, intervals=k,
          ms=f"{ms:.4f}", plain_ms=f"{plain:.2f}", bound_ms=f"{b_ms:.5f}",
          bound_by=b_by)
    del params, init

    # -- 3c. fleet_loop against its plain version ------------------------------
    # The step cost of benchmarks/cluster_sim.py:15-16 (a llama3-405b-class
    # step on 256 chips) and the reference's default FleetConfig: 1024
    # nodes + 32 spares, σ 0.08, evict at 1.6 × median after 20 steps,
    # degradation every 800 h per node to 2.5×.
    fleet_cost = StepCost(compute_s=1.2, memory_s=0.5, collective_s=0.4,
                          overlap_collective=0.6)

    def fleet_inputs(cfg, steps, seeds, **kw):
        plan = _prepare_fleet(fleet_cost, cfg, steps, seeds=seeds, **kw)
        params = to_device(plan.params, dev)
        st = plan.statics
        p, tb = loop_inputs(params, st)
        return p, tb, st, _fleet_build(params, st, MaskedOps()).init

    def fleet_check(label, got, want):
        errs = {f: max_abs_err(a, b) for f, a, b in
                zip(got[0]._fields + ("it",), (*got[0], got[1]),
                    (*want[0], want[1]))}
        if any(e != 0.0 for e in errs.values()):
            fail(f"fleet_loop {label}: kernel != plain in "
                 f"{[f for f, e in errs.items() if e != 0.0]}")
        return max(errs.values())

    fl_checks = []
    # Faster failure and degradation than the defaults, so that 300 steps
    # reach rollbacks, degradation and eviction.
    busy = FleetConfig(mtbf_hours_node=100.0, degrade_mtbf_hours=20.0)
    max_only = FleetConfig(mtbf_hours_node=50.0, straggler_evict_factor=1e9,
                           degrade_mtbf_hours=1e9)
    outages = FaultPlan([FaultEvent("node", 100.0 + 37.0 * k,
                                    900.0 + 37.0 * k, target=3 * k)
                         for k in range(40)])
    for label, cfg, kw in (
            ("evict+degrade", busy, {}),
            ("inverse-cdf", max_only, {}),
            ("sigma=0", replace(busy, straggler_sigma=0.0), {}),
            ("degrade only", replace(busy, straggler_evict_factor=1e9), {}),
            ("fault plan", busy, dict(fault_plan=outages)),
            ("f32 evict+degrade", busy, dict(precision="fast")),
            ("f32 inverse-cdf", max_only, dict(precision="fast")),
            ("f32 fault plan", busy, dict(fault_plan=outages,
                                          precision="fast"))):
        p, tb, st, init = fleet_inputs(cfg, 300, np.arange(8), **kw)
        got = fleet_loop(init, p, tb, st)
        want = fleet_loop_ref(init, p, tb, st)
        torch.cuda.synchronize()
        fl_checks.append(fleet_check(label, got, want))
        end, it = got
        phase("kernel", name="fleet_loop", lanes=8, nodes=st.n_total,
              case=label, dtype=str(end.t.dtype).replace("torch.", ""),
              bit_exact=True, iterations=it.tolist(),
              failures=end.failures.tolist(),
              restarts=end.restarts.tolist(),
              evictions=end.evictions.tolist())
    # One step and a few: max_iters against the plain loop and one
    # fleet_step (the TPU kernel's unit of work).
    p, tb, st, init = fleet_inputs(busy, 300, np.arange(8))
    for cap in (1, 7):
        fl_checks.append(fleet_check(
            f"max_iters={cap}", fleet_loop(init, p, tb, st, cap),
            fleet_loop_ref(init, p, tb, st, cap)))
    one = fleet_step(init, torch.zeros_like(init.step), p, tb, st, PlainOps)
    fl_checks.append(fleet_check("one fleet_step",
                                 fleet_loop(init, p, tb, st, 1),
                                 (one, torch.ones_like(init.step))))
    phase("kernel", name="fleet_loop", lanes=8, nodes=st.n_total,
          case="max_iters 1 and 7, one fleet_step", bit_exact=True)
    # The main path's grid (section 5), all 1152 lanes, first 4096
    # iterations of each: the plain loop pays ~12 ms an iteration here,
    # and the longest lanes run for ~3·10^5.
    fleet_grid = dict(
        seeds=np.tile(np.arange(128), 9),
        mtbf_hours=np.repeat([100.0, 500.0, 2000.0], 3 * 128),
        ckpt_every=np.tile(np.repeat([50, 200, 1000], 128), 3))
    cap = 4096
    p, tb, st, init = fleet_inputs(FleetConfig(), 2000, **fleet_grid)
    ms = cuda_ms(lambda: fleet_loop(init, p, tb, st, cap), 2, warmup=1)
    got = fleet_loop(init, p, tb, st, cap)
    t0 = time.perf_counter()
    want = fleet_loop_ref(init, p, tb, st, cap)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    fl_checks.append(fleet_check("1152 lanes", got, want))
    it = got[1]
    b, n = it.shape[0], st.n_total
    # Bytes: the tables, per-lane scalars and seed read once, the carry
    # read and written once (22 B a node, 44 B of scalars a lane) and the
    # iteration counts written.  Operations: 2K + k_degrade + 16 f64
    # operations per node and iteration (the compares and adds of the
    # schedule lookups, the slowdown product and its exp, the masks),
    # counted over the iterations this run's lanes take.
    nbytes = b * (n * (st.k_fail_rounds + st.k_degrade) * 8 + n * 8
                  + 13 * 8 + 8 + 2 * (n * 22 + 44) + 4)
    n_ops = float(it.double().sum()) * n * (
        2 * st.k_fail_rounds + st.k_degrade + 16)
    b_ms, b_by = bound_ms(nbytes, n_ops, F64_OPS_PER_S)
    results["fleet_loop"] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                                 bound_by=b_by, max_abs_err=max(fl_checks))
    phase("kernel", name="fleet_loop", lanes=b, nodes=n, max_iters=cap,
          case="main path grid", bit_exact=True,
          lanes_finished=int((got[0].step >= 2000).sum()),
          iterations_sum=int(it.sum()), ms=f"{ms:.3f}",
          plain_ms=f"{plain:.1f}", bound_ms=f"{b_ms:.5f}", bound_by=b_by)
    del p, tb, init, got, want

    # -- 4. golden fixtures on the card ----------------------------------------
    def golden(name):
        return json.loads((ROOT / "tests" / "golden" / f"{name}.json")
                          .read_text())

    def same_as_golden(name, out, drop=()):
        want = golden(name)["outputs"]
        got = {k: v for k, v in out.items() if k not in drop}
        if sorted(got) != sorted(want):
            fail(f"golden {name}: keys {sorted(got)} != {sorted(want)}")
        for key, w in want.items():
            g, w = np.asarray(got[key]), np.asarray(w)
            if g.shape != w.shape or not np.array_equal(g, w):
                fail(f"golden {name}: {key} differs")
        phase("golden", fixture=name, bit_exact=True, keys=len(want))

    out, _ = run_sweep("netdc_batch", dict(
        seeds=[0, 1, 2, 3], n_dcs=4, n_jobs=32,
        locality_weight=np.array([1.0, 1.0, 2.5, 2.5]),
        offline_dc=np.array([-1, 1, -1, 1])), device=dev)
    same_as_golden("netdc_batch", out)
    chaos = FaultPlan([FaultEvent("node", 10.0, 30.0, target=1),
                       FaultEvent("node", 40.0, 55.0, target=0),
                       FaultEvent("link", 20.0, 50.0, severity=3.0),
                       FaultEvent("transient", 0.0, 64.0, severity=0.4)],
                      seed=11)
    retry = RetryPolicy(max_retries=2, base_delay_s=0.5, backoff=2.0,
                        jitter_frac=0.25, budget_s=60.0)
    out, _ = run_sweep("netdc_batch", dict(
        seeds=[0, 1, 2], n_dcs=4, n_jobs=32, mean_gap_s=2.0,
        fault_plan=chaos, retry=retry, timeout_s=240.0), device=dev)
    same_as_golden("netdc_chaos", out, drop=("iterations",))
    out, _ = run_sweep("power_batch", dict(golden("power_batch")["config"]),
                       device=dev)
    same_as_golden("power_batch", out)

    # -- 5. the main path at full size -----------------------------------------
    counters = dict(next_event=next_event, power_scan=power_scan,
                    fleet_loop=fleet_loop)
    launches = {}

    def main_path(kind, params, expect, cpu_params=None):
        for c in counters.values():
            c.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_sweep(kind, params, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {n: c.launches for n, c in counters.items()}
        peak = torch.cuda.max_memory_allocated(dev)
        for name in expect:
            if counts[name] <= 0:
                fail(f"{kind}: kernel {name} was never launched on the "
                     f"main path")
            launches[name] = counts[name]
        out = res.outputs
        for key, v in out.items():
            v = np.asarray(v)
            if v.shape[:1] != (res.report.n_cells,):
                fail(f"{kind}: output {key} has shape {v.shape}")
            if v.dtype.kind == "f" and np.isnan(v).any():
                fail(f"{kind}: output {key} holds NaN")
        n = res.report.n_cells
        its = np.asarray(out.get("iterations", [0]))
        phase("main", kind=kind, cells=n, wall_s=f"{wall:.3f}",
              cells_per_s=f"{n / wall:.1f}", launches=counts,
              peak_device_mb=f"{peak / 2**20:.1f}",
              chunks=res.report.n_chunks,
              iterations_min_mean_max=f"{its.min()}/{its.mean():.1f}/"
                                      f"{its.max()}")
        # The first 8 cells again on the CPU, bit for bit (of cpu_params
        # where the main run's draws go through transcendentals, which
        # differ between the CPU's and the card's math libraries).
        check = params if cpu_params is None else cpu_params
        sub = {k: (v[:8] if isinstance(v, np.ndarray) and v.ndim
                   and v.shape[0] == n else v) for k, v in check.items()}
        sub["seeds"] = np.asarray(check["seeds"])[:8]
        card = out if cpu_params is None else \
            run_sweep(kind, sub, device=dev).outputs
        cpu, _ = run_sweep(kind, sub, device="cpu")
        for key, v in cpu.items():
            g = np.asarray(card[key])[:8]
            if g.dtype != v.dtype or not np.array_equal(g, v):
                fail(f"{kind}: card and CPU differ on {key} (first 8 cells)")
        phase("main", kind=kind, cpu_rerun_cells=8, bit_exact=True,
              cpu_iterations=np.asarray(cpu.get("iterations", [])).tolist())
        return res, wall

    nb = 1024
    netdc_params = dict(seeds=np.arange(nb), n_dcs=16, n_jobs=2048,
                        locality_weight=np.resize([1.0, 1.5, 2.5, 1.0], nb),
                        offline_dc=np.resize([-1, -1, -1, 2], nb))
    # Warm the path once at small size, then the measured run.
    run_sweep("netdc_batch", dict(seeds=np.arange(4), n_dcs=16, n_jobs=8),
              device=dev)
    netdc_out = main_path("netdc_batch", netdc_params,
                          ["next_event"])[0].outputs
    power_params = dict(seeds=np.arange(nb), n_hosts=800, n_vms=1052,
                        n_samples=288, interval=300.0,
                        up_thr=np.resize([0.7, 0.8, 0.9], nb),
                        cooldown=np.resize([1, 3], nb))
    power_out = main_path("power_batch", power_params,
                          ["power_scan"])[0].outputs
    fleet_params = dict(cost=fleet_cost, cfg=FleetConfig(), total_steps=2000,
                        **fleet_grid)
    quiet = dict(fleet_params, cfg=FleetConfig(straggler_sigma=0.0,
                                               degrade_mtbf_hours=1e9))
    fleet_res, _ = main_path("fleet_batch", fleet_params, ["fleet_loop"],
                             cpu_params=quiet)
    if launches["fleet_loop"] != fleet_res.report.n_chunks:
        fail(f"fleet_batch: {launches['fleet_loop']} fleet_loop launches "
             f"for {fleet_res.report.n_chunks} chunks")
    fleet_out = fleet_res.outputs
    for key in ("goodput", "wallclock_s"):
        v = fleet_out[key]
        if not (np.isfinite(v).all() and (v > 0).all()):
            fail(f"fleet_batch: {key} not finite and positive")
    if not (fleet_out["goodput"] <= 1.0).all():
        fail("fleet_batch: goodput above 1")
    phase("main", netdc_mean_makespan_s=float(netdc_out["makespan"].mean()),
          power_mean_energy_wh=float(power_out["energy_total_wh"].mean()),
          fleet_mean_goodput=float(fleet_out["goodput"].mean()),
          fleet_mean_failures=float(fleet_out["failures"].mean()),
          fleet_mean_evictions=float(fleet_out["evictions"].mean()))

    # Where the wall time goes, for the same full-size plans run again:
    # host table build, copy to the card, the event loop, copy back and
    # the host-side finalize (outputs checked against the main run).
    # (fleet_batch runs as one launch here, all 1152 lanes, where the main
    # run had one launch per chunk of lanes of similar predicted length.)
    for kname, engine, prepare, params, ref_out in (
            ("netdc_batch", NETDC_ENGINE, _prepare_netdc, netdc_params,
             netdc_out),
            ("power_batch", POWER_ENGINE, _prepare_power, power_params,
             power_out),
            ("fleet_batch", FLEET_ENGINE, _prepare_fleet, fleet_params,
             fleet_out)):
        t0 = time.perf_counter()
        plan = prepare(**params)
        t1 = time.perf_counter()
        dparams = to_device(plan.params, dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        raw = run_one(engine, dparams, plan.statics)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        out = {k: v.cpu().numpy() for k, v in raw.items()}
        if plan.finalize is not None:
            out = plan.finalize(out)
        t4 = time.perf_counter()
        if any(not np.array_equal(out[k], ref_out[k]) for k in ref_out):
            fail(f"{kname}: a second run of the same plan differs")
        iters = (int(out["iterations"].max()) if kname == "fleet_batch"
                 else int(plan.statics.n_jobs if kname == "netdc_batch"
                          else plan.statics.n_intervals))
        phase("breakdown", kind=kname, host_tables_s=f"{t1 - t0:.3f}",
              to_device_s=f"{t2 - t1:.3f}", loop_s=f"{t3 - t2:.3f}",
              to_host_and_finalize_s=f"{t4 - t3:.3f}",
              loop_iterations=iters,
              loop_ms_per_iteration=f"{(t3 - t2) / iters * 1e3:.4f}")
        del plan, dparams, raw, out
    # Torch ops dispatched per netdc routing decision (host-side count).
    from torch.profiler import ProfilerActivity, profile
    plan = _prepare_netdc(seeds=np.arange(64), n_dcs=16, n_jobs=32)
    dparams = to_device(plan.params, dev)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_one(NETDC_ENGINE, dparams, plan.statics)
        torch.cuda.synchronize()
    ops = [e for e in prof.events()
           if e.cpu_parent is None and e.name.startswith("aten::")]
    phase("breakdown", kind="netdc_batch",
          torch_ops_per_iteration=f"{len(ops) / 32:.2f}")

    # -- the kernels line and the result ---------------------------------------
    ne = results["next_event"][0]             # the netdc path's shape
    ps = results["power_scan"]
    fl = results["fleet_loop"]
    kernels = [
        dict(name="next_event", route="cuda",
             source="src/repro_torch/kernels/csrc/next_event.cu",
             replaces="src/repro/kernels/next_event.py:92",
             launches=launches["next_event"],
             max_abs_err=max(r["max_abs_err"] for r in results["next_event"]),
             ms=ne["ms"], plain_ms=ne["plain_ms"], bound_ms=ne["bound_ms"],
             bound_by=ne["bound_by"], library_ms=ne["library_ms"],
             launch_floor_ms=ne["launch_floor_ms"]),
        dict(name="power_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/power_scan.cu",
             replaces="src/repro/kernels/step.py:252",
             launches=launches["power_scan"], max_abs_err=ps["max_abs_err"],
             ms=ps["ms"], plain_ms=ps["plain_ms"], bound_ms=ps["bound_ms"],
             bound_by=ps["bound_by"], library_ms=None),
        dict(name="fleet_loop", route="cuda",
             source="src/repro_torch/kernels/csrc/fleet_loop.cu",
             replaces="src/repro/kernels/step.py:165",
             launches=launches["fleet_loop"], max_abs_err=fl["max_abs_err"],
             ms=fl["ms"], plain_ms=fl["plain_ms"], bound_ms=fl["bound_ms"],
             bound_by=fl["bound_by"], library_ms=None,
             shape=f"1152 lanes x 1056 nodes, first {cap} iterations"),
    ]
    phase("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
