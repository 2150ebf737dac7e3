"""``fleet_batch`` / ``fleet`` in the port against the JAX reference.

The reference (``vec`` with ``use_pallas=False``: its fused step path
cannot run on the installed JAX and was bit-identical to the plain path by
construction) runs in one child process per module; the port runs here on
the CPU, where the driver's where-live loop runs the fleet step.

* **Deterministic domain** (σ = 0, MTBF and degradation beyond the run,
  with and without a ``FaultPlan``): every output key, dtype and shape is
  bit-identical, though each side draws its own (unused) schedules.
* **Reference schedules carried across** (σ = 0 with failures, rollbacks,
  cascades, checkpoint hits, stalls and a stall-out; degradation with
  ``degrade_factor=1.5`` and eviction): the child hands over the
  reference's own ``fail_start``/``degrade_t``/``bias0`` and both engines
  must agree bit for bit.  (Other degrade factors are not bit-exact here:
  XLA's and torch's CPU ``exp`` differ in the last bit on some
  ``k·log f``; 1.5 agrees for every k ≤ 8.)
* **Stochastic** configs draw different random numbers (threefry against
  the port's Philox stream): mean goodput within 2% over 256 fixed seeds,
  for eviction on, the inverse-CDF path, and ``fast`` against ``exact``.

``tests/golden/fleet_batch.json`` is a σ = 0.08 run on threefry draws, so
the port cannot reproduce it bit for bit and is not compared with it.
"""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

from test_torch_reference import assert_same, run_reference
from test_torch_vec_engine import COSTS, DRAIN, MASK, STARTS, _drain_build

from repro_torch.convert import params_from_reference
from repro_torch.core import SweepConfig, run_scenario, run_sweep
from repro_torch.core.cluster import FleetConfig, RunStats, StepCost
from repro_torch.core.faults import FaultEvent, FaultPlan
from repro_torch.core.vec_cluster import (FLEET_ENGINE, _fleet_build,
                                          _prepare_fleet, loop_inputs,
                                          simulate_fleet_batch,
                                          simulate_fleet_vec)
from repro_torch.core.sweep import to_device
from repro_torch.core.vec_engine import VecEngine, run_one
from repro_torch.kernels.fleet_step import (fleet_loop, fleet_loop_ref,
                                            fleet_step)
from repro_torch.kernels.ops import MaskedOps, PlainOps

COST = dict(compute_s=1.0, memory_s=0.4, collective_s=0.3,
            overlap_collective=0.5)
_QUIET = dict(straggler_sigma=0.0, mtbf_hours_node=1e9,
              degrade_mtbf_hours=1e9)

# σ = 0, nothing fails or degrades within the run (tests/test_vec_cluster.py
# and tests/test_differential.py of the reference).
DET = {
    "ckpt_mid": dict(cfg=dict(n_nodes=64, n_spares=4, ckpt_every_steps=50,
                              seed=3, **_QUIET), steps=300, seeds=[3]),
    "ckpt_final": dict(cfg=dict(n_nodes=8, n_spares=0, ckpt_every_steps=100,
                                **_QUIET), steps=200, seeds=[0]),
    "pod_overhead": dict(cfg=dict(n_nodes=16, n_spares=1,
                                  ckpt_every_steps=33,
                                  pod_boundary_overhead_s=0.25, seed=7,
                                  **_QUIET), steps=120, seeds=[7]),
    "swept": dict(cost=dict(compute_s=1.7, memory_s=0.6, collective_s=0.55,
                            overlap_collective=0.3),
                  cfg=dict(n_nodes=8, n_spares=2, straggler_evict_factor=1e9,
                           **_QUIET),
                  steps=70, seeds=[0, 1, 2, 3], ckpt_every=[5, 12, 20, 29]),
    "faulted": dict(cfg=dict(n_nodes=8, n_spares=0, restart_s=5.0,
                             straggler_evict_factor=1e9, **_QUIET),
                    steps=70, seeds=[0, 1, 2, 3], ckpt_every=[6, 11, 17, 25],
                    fault_plan=[(2, 12.3, 41.7), (5, 52.9, 83.1)]),
    "faulted_spares": dict(cfg=dict(n_nodes=8, n_spares=2, restart_s=5.0,
                                    **_QUIET),
                           steps=90, seeds=[4, 5], ckpt_every=[7, 30],
                           fault_plan=[(1, 3.3, 60.2), (8, 10.1, 30.4),
                                       (1, 75.5, 90.0), (0, 20.7, 26.9)]),
}

# σ = 0 with the reference's schedules: failures, degradation, eviction.
CARRIED = {
    "failures": dict(cfg=dict(n_nodes=16, n_spares=2, straggler_sigma=0.0,
                              mtbf_hours_node=0.2, repair_hours=0.5,
                              restart_s=60.0, ckpt_every_steps=10,
                              ckpt_write_s=5.0, degrade_mtbf_hours=1e9,
                              min_nodes_frac=0.9),
                     steps=300, seeds=list(range(8)),
                     mtbf_hours=[0.1, 0.2, 0.5, 2.0] * 2,
                     ckpt_every=[5, 10, 20, 50, 5, 10, 20, 50],
                     max_wallclock_s=3000.0),
    "degrade": dict(cfg=dict(n_nodes=16, n_spares=4, straggler_sigma=0.0,
                             mtbf_hours_node=1.0, repair_hours=0.2,
                             restart_s=30.0, ckpt_every_steps=20,
                             ckpt_write_s=5.0, degrade_mtbf_hours=0.05,
                             degrade_factor=1.5, straggler_window=5),
                    steps=200, seeds=list(range(6))),
}

# The reference's STOCH config (tests/test_vec_cluster.py), 256 seeds.
STOCH = dict(n_nodes=64, n_spares=8, straggler_sigma=0.08,
             mtbf_hours_node=2.0, repair_hours=0.2, restart_s=60.0,
             ckpt_every_steps=20, ckpt_write_s=10.0, degrade_mtbf_hours=1e9)
STOCH_CASES = {
    "evict": dict(cfg=STOCH, steps=300, seeds=list(range(256))),
    "inverse_cdf": dict(cfg=dict(STOCH, straggler_evict_factor=1e9),
                        steps=300, seeds=list(range(256))),
}
_STATICS = ("n_nodes", "n_spares", "k_fail_rounds", "k_degrade", "window",
            "track_stragglers", "degrade", "sigma_zero", "fast",
            "n_fault_windows")


def make_kwargs(case, FleetConfig, StepCost, FaultEvent, FaultPlan,
                cost=COST):
    """Scenario kwargs from plain data (shipped to the reference child as
    source)."""
    kw = {k: v for k, v in case.items()
          if k not in ("cfg", "cost", "steps", "fault_plan")}
    kw["cost"] = StepCost(**case.get("cost", cost))
    kw["cfg"] = FleetConfig(**case["cfg"])
    kw["total_steps"] = case["steps"]
    if "fault_plan" in case:
        kw["fault_plan"] = FaultPlan([FaultEvent("node", ts, te, target=nid)
                                      for nid, ts, te in case["fault_plan"]])
    return kw


_CHILD = inspect.getsource(make_kwargs).replace("cost=COST", f"cost={COST!r}") \
    + f"""
import dataclasses
import jax.numpy as jnp
from repro.core.backend import run_sweep
from repro.core import vec_engine
from repro.core.cluster import FleetConfig, StepCost
from repro.core.faults import FaultEvent, FaultPlan
from repro.core.vec_cluster import (FLEET_ENGINE, _prepare_fleet,
                                    simulate_fleet_batch,
                                    simulate_fleet_vec)
from repro.kernels.ops import MaskedOps
DET, CARRIED, STOCH_CASES = {DET!r}, {CARRIED!r}, {STOCH_CASES!r}
STATICS = {_STATICS!r}

def build(case):
    return make_kwargs(case, FleetConfig, StepCost, FaultEvent, FaultPlan)

for name, case in DET.items():
    out, _ = run_sweep("fleet_batch", build(case))
    for k, v in out.items():
        OUT[name + "/" + k] = v
kw = build(DET["ckpt_mid"])
st = simulate_fleet_vec(kw["cost"], kw["cfg"], kw["total_steps"])
OUT["runstats"] = np.asarray([getattr(st, f.name) for f in
                              dataclasses.fields(st)], np.float64)

def schedules(plan):
    # The reference draws its schedules inside the loop's build; read them
    # out of the step's closure, under the same vmap the driver uses.
    def one(args):
        loop = FLEET_ENGINE.build(args, plan.statics, MaskedOps(False))
        step = loop.step_kernel.step
        cells = dict(zip(step.__code__.co_freevars, step.__closure__))
        dt = (cells["degrade_t"].cell_contents if plan.statics.degrade
              else jnp.zeros(()))
        return cells["fail_start"].cell_contents, dt, loop.init.bias
    with jax.experimental.enable_x64():
        return [np.asarray(a) for a in jax.jit(jax.vmap(one))(plan.params)]

for name, case in CARRIED.items():
    plan = _prepare_fleet(use_pallas=False, **build(case))
    raw = vec_engine.run_plan(FLEET_ENGINE, plan)
    for k, v in raw.items():
        OUT["raw_" + name + "/" + k] = v
    fs, dt, b0 = schedules(plan)
    OUT["tab_" + name + "/fail_start"] = fs
    OUT["tab_" + name + "/degrade_t"] = dt
    OUT["tab_" + name + "/bias0"] = b0
    for f in plan.params[0]._fields:
        OUT["par_" + name + "/" + f] = np.asarray(getattr(plan.params[0], f))
    sd = dataclasses.asdict(plan.statics)
    OUT["statics_" + name] = np.asarray([int(sd[k]) for k in STATICS])

for name, case in STOCH_CASES.items():
    kw = build(case)
    OUT["stoch_" + name] = simulate_fleet_batch(**kw)["goodput"]
fast = simulate_fleet_batch(precision="fast", **build(STOCH_CASES["inverse_cdf"]))
for k, v in fast.items():
    OUT["fast/" + k] = v
"""


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The fleet step is many small ops on [B, n] tensors: a few intra-op
    threads run them fastest, and many spin against the other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(_CHILD, tmp_path_factory.mktemp("fleet_ref"),
                         timeout=600.0)


def _kwargs(case):
    return make_kwargs(case, FleetConfig, StepCost, FaultEvent, FaultPlan)


@pytest.mark.parametrize("name", sorted(DET))
def test_deterministic_domain_matches_reference(ref, name):
    out, report = run_sweep("fleet_batch", _kwargs(DET[name]), device="cpu")
    assert_same(ref, out, prefix=name + "/")
    assert report.n_cells == len(DET[name]["seeds"])


def test_simulate_fleet_vec_and_fleet_scenario_match_reference(ref):
    kw = _kwargs(DET["ckpt_mid"])
    st = simulate_fleet_vec(kw["cost"], kw["cfg"], kw["total_steps"],
                            device="cpu")
    assert isinstance(st, RunStats)
    want = ref["runstats"]
    got = [getattr(st, f.name) for f in dataclasses.fields(st)]
    assert got == want.tolist()
    assert st.goodput == want[-1] / want[0]
    via = run_scenario("fleet", cost=kw["cost"], cfg=kw["cfg"],
                       total_steps=kw["total_steps"], device="cpu")
    assert via == st


def _carried(ref, name):
    fields = [k.split("/", 1)[1] for k in ref if k.startswith(f"par_{name}/")]
    arrays = {f: ref[f"par_{name}/{f}"] for f in fields}
    statics = dict(zip(_STATICS, (int(v) for v in ref["statics_" + name])))
    for k in ("track_stragglers", "degrade", "sigma_zero", "fast"):
        statics[k] = bool(statics[k])
    tables = {k: ref[f"tab_{name}/{k}"]
              for k in ("fail_start", "degrade_t", "bias0")}
    params, st = params_from_reference("fleet_batch", arrays, statics,
                                       device="cpu", tables=tables)
    return {k: v.numpy() for k, v in run_one(FLEET_ENGINE, params,
                                             st).items()}


@pytest.mark.parametrize("name", sorted(CARRIED))
def test_reference_schedules_carried_across(ref, name):
    assert_same(ref, _carried(ref, name), prefix=f"raw_{name}/")


def test_carried_runs_exercise_failures_and_eviction(ref):
    """The carried configs reach every branch the comparison is meant to
    hold: failures, rollbacks, lost steps, stalls, a lane that runs out of
    wall-clock, and evictions."""
    fail = {k: ref["raw_failures/" + k] for k in
            ("failures", "restarts", "lost_steps", "stall_s", "steps_done")}
    assert (fail["failures"] > 0).any() and (fail["restarts"] > 0).any()
    assert (fail["lost_steps"] > 0).any() and (fail["stall_s"] > 0).any()
    assert (fail["steps_done"] < CARRIED["failures"]["steps"]).any()
    assert (ref["raw_degrade/evictions"] > 0).any()


@pytest.mark.parametrize("name", sorted(STOCH_CASES))
def test_stochastic_mean_goodput_within_2pct(ref, name):
    got = simulate_fleet_batch(**_kwargs(STOCH_CASES[name]),
                               device="cpu")["goodput"]
    want = ref["stoch_" + name]
    assert got.shape == want.shape == (256,)
    rel = abs(got.mean() - want.mean()) / want.mean()
    assert rel < 0.02, (got.mean(), want.mean(), rel)


def test_fast_precision_matches_exact_and_reference(ref):
    kw = _kwargs(STOCH_CASES["inverse_cdf"])
    fast = simulate_fleet_batch(precision="fast", device="cpu", **kw)
    exact = simulate_fleet_batch(device="cpu", **kw)
    for k, v in fast.items():
        assert v.dtype == ref["fast/" + k].dtype, k
        assert v.shape == ref["fast/" + k].shape, k
    assert fast["goodput"].dtype == np.float32
    for other in (exact["goodput"], ref["fast/goodput"]):
        rel = abs(fast["goodput"].mean() - other.mean()) / other.mean()
        assert rel < 0.02, rel


def test_lane_equals_its_singleton_run_whatever_the_chunking():
    case = dict(cfg=dict(STOCH, n_nodes=12, n_spares=2, degrade_mtbf_hours=2.0,
                         straggler_window=4),
                steps=50, seeds=[0, 1, 2, 3, 4, 5, 1],
                mtbf_hours=[2.0, 0.5, 8.0, 1.0, 4.0, 0.3, 0.3],
                ckpt_every=[10, 5, 20, 7, 3, 12, 12], k_fail_rounds=16)
    kw = _kwargs(case)
    mono, rep = run_sweep("fleet_batch", kw, device="cpu")
    assert rep.bucketed is False and rep.n_chunks == 1
    for chunk in (2, 3):
        out, rep = run_sweep("fleet_batch", kw,
                             config=SweepConfig(chunk_size=chunk),
                             device="cpu")
        assert rep.bucketed and rep.n_chunks == -(-7 // chunk)
        for k in mono:
            assert np.array_equal(out[k], mono[k]), (chunk, k)
    assert mono["failures"].sum() > 0 and mono["evictions"].sum() > 0
    for j in (1, 5):
        one = dict(kw, seeds=[kw["seeds"][j]], mtbf_hours=[kw["mtbf_hours"][j]],
                   ckpt_every=[kw["ckpt_every"][j]])
        solo, _ = run_sweep("fleet_batch", one, device="cpu")
        for k in mono:
            assert np.array_equal(solo[k], mono[k][j:j + 1]), (j, k)


def test_precision_must_be_exact_or_fast():
    kw = _kwargs(DET["ckpt_final"])
    with pytest.raises(ValueError, match="precision"):
        simulate_fleet_batch(precision="half", device="cpu", **kw)
    with pytest.raises(ValueError, match="precision"):
        SweepConfig(precision="half")
    out, _ = run_sweep("fleet_batch", kw, config=SweepConfig(precision="fast"),
                       device="cpu")
    assert out["wallclock_s"].dtype == np.float32


@pytest.mark.parametrize("events,match", [
    ([FaultEvent("link", 1.0, 5.0, severity=2.0)], "only 'node'"),
    ([FaultEvent("node", 1.0, 5.0, target=-1)], "explicit node target"),
    ([FaultEvent("node", 1.0, np.inf, target=2)], "finite"),
    ([FaultEvent("node", 1.0, 5.0, target=2),
      FaultEvent("node", 4.0, 9.0, target=2)], "overlap"),
    ([FaultEvent("node", 1.0, 5.0, target=99)], "only 8 exist"),
])
def test_fault_plans_the_fleet_cannot_take_raise(events, match):
    with pytest.raises(ValueError, match=match):
        simulate_fleet_batch(**_kwargs(DET["ckpt_final"]), device="cpu",
                             fault_plan=FaultPlan(events))


def test_dynamic_step_kernel_replaces_the_driver_loop():
    """A dynamic loop's ``step_kernel(init) -> (state, it)`` (the hook the
    fleet loop uses) runs in place of the where-live loop and gives the
    same outputs as the step loop."""
    params = (torch.from_numpy(STARTS), torch.from_numpy(COSTS),
              torch.from_numpy(MASK))

    def build(p, s, ops):
        loop = _drain_build(p, s, ops)

        def whole(init):
            it = torch.ceil(init[0]).clamp(min=0).to(torch.int32)
            left = init[0] - it.to(torch.float64)
            return (left, ops.argmin(p[1], p[2])), it

        def no_body(c, it):
            raise AssertionError("the driver ran the step loop")
        return loop._replace(body=no_body, step_kernel=whole)

    want = run_one(DRAIN, params, None)
    got = run_one(VecEngine("_drain_kernel", build), params, None)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert got["iterations"].tolist() == STARTS.astype(int).tolist()


def test_fleet_loop_on_the_cpu_is_the_driver_loop():
    """On CPU tensors ``fleet_loop`` runs the plain loop, which equals the
    driver's; ``max_iters=1`` is one step on the live lanes."""
    case = dict(cfg=dict(STOCH, n_nodes=10, n_spares=2,
                         degrade_mtbf_hours=1.0, straggler_window=3),
                steps=40, seeds=[0, 1, 2], mtbf_hours=[0.5, 1.0, 2.0])
    plan = _prepare_fleet(**_kwargs(case))
    params = to_device(plan.params, "cpu")
    s = plan.statics
    p, tb = loop_inputs(params, s)
    init = _fleet_build(params, s, MaskedOps()).init
    driver = run_one(FLEET_ENGINE, params, s)
    end, it = fleet_loop(init, p, tb, s)
    assert torch.equal(it, driver["iterations"]) and it.dtype == torch.int32
    assert torch.equal(end.step, driver["steps_done"])
    assert torch.equal(end.lost_steps, driver["lost_steps"])
    assert fleet_loop.launches == 0
    one, it1 = fleet_loop(init, p, tb, s, max_iters=1)
    step = fleet_step(init, torch.zeros_like(init.step), p, tb, s, PlainOps)
    assert it1.tolist() == [1, 1, 1]
    for a, b in zip(one, step):
        assert torch.equal(a, b)
    seven, it7 = fleet_loop_ref(init, p, tb, s, max_iters=7)
    assert it7.tolist() == [7, 7, 7] and bool((seven.step > 0).all())


def test_empty_batch_short_circuits():
    out = simulate_fleet_batch(**dict(_kwargs(DET["ckpt_final"]), seeds=[]),
                               device="cpu")
    assert out["goodput"].shape == (0,) and out["steps_done"].dtype == np.int32


def test_params_from_reference_fleet_needs_tables():
    statics = dict(n_nodes=4, n_spares=0, k_fail_rounds=4, k_degrade=8,
                   window=20, track_stragglers=False, degrade=False,
                   sigma_zero=True)
    arrays = {f: np.zeros(2) for f in
              ("base_step_s", "mtbf_s", "repair_s", "ckpt_every",
               "ckpt_write_s", "restart_s", "sigma", "evict_factor",
               "degrade_s", "degrade_factor", "min_nodes", "total_steps",
               "max_wall_s")}
    with pytest.raises(ValueError, match="tables="):
        params_from_reference("fleet_batch", arrays, statics, device="cpu")
    with pytest.raises(ValueError, match="missing tables"):
        params_from_reference("fleet_batch", arrays, statics, device="cpu",
                              tables=dict(bias0=np.zeros(2)))
    (p, tb), st = params_from_reference(
        "fleet_batch", arrays, statics, device="cpu",
        tables=dict(fail_start=np.zeros((2, 4, 4)), bias0=np.zeros(2)))
    assert tb.bias0.shape == (2, 4) and tb.seed.dtype == torch.int64
    assert tb.degrade_t is None and st.n_total == 4
