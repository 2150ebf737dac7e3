"""The port's VecEngine driver and sweep executor against the reference.

The toy engines of the reference's ``tests/test_vec_engine.py``, rebuilt
in torch: a "drain" engine whose lanes stop at different iterations (the
``while_loop`` form) and a counting engine with a static trip count.  The
same lanes run through the reference driver in a child process; outputs
must be bit-identical, and the sweep reports must agree for every chunking
and bucketing schedule.
"""
import math

import numpy as np
import pytest
import torch

from test_torch_reference import run_reference

from repro_torch.core import backend, vec_engine
from repro_torch.core.backend import (BackendError, ScenarioUnsupported,
                                      run_scenario, run_sweep)
from repro_torch.core.sweep import (SweepConfig, SweepReport,
                                    auto_chunk_size, execute_sweep)
from repro_torch.core.vec_engine import (BatchPlan, Done, Loop, VecEngine,
                                         make_batch_entry, run_one)

I32 = torch.int32


def _drain_build(params, statics, ops):
    start, costs, mask = params

    def body(c, it):
        left, pick = c
        return left - 1.0, ops.argmin(costs, mask)

    return Loop(init=(start, torch.full(start.shape, -1, dtype=I32)),
                cond=lambda c, it: c[0] > 0,
                body=body,
                finalize=lambda c, it: dict(left=c[0], pick=c[1]))


def _count_build(params, statics, ops):
    (step,) = params

    def body(acc, it):
        return acc + step * it.to(torch.float64)

    return Loop(init=torch.zeros_like(step), cond=lambda c, it: it < 5,
                body=body, finalize=lambda c, it: dict(acc=c),
                trip_count=5)


DRAIN = VecEngine("_drain", _drain_build)
COUNT = VecEngine("_count", _count_build)

N = 40
STARTS = np.random.default_rng(3).integers(1, 13, N).astype(np.float64)
COSTS = np.tile([3.0, 1.0, 1.0, 2.0], (N, 1))
MASK = np.tile([True, False, True, True], (N, 1))
MASK[::5] = [True, True, False, True]
STEPS = np.linspace(0.5, 2.0, N)
# (name, chunk_size, bucket by predicted cost?)
SCHEDULES = [("mono", None, False), ("auto_pred", None, True),
             ("c1", 1, False), ("c3", 3, False), ("c7", 7, False),
             ("c3_pred", 3, True), ("c7_pred", 7, True)]
REPORT_KEYS = ("n_chunks", "chunk_size", "bucketed", "active_lane_fraction",
               "active_lane_fraction_monolithic",
               "active_lane_fraction_predicted")

_CHILD = f"""
import jax.numpy as jnp
from repro.core import vec_engine
from repro.core.vec_engine import BatchPlan, Loop, VecEngine

class _Statics:
    use_pallas = False

def _drain_build(params, statics, ops):
    start, costs, mask = params
    def body(c, it):
        left, pick = c
        return left - 1.0, ops.argmin(costs, mask).astype(jnp.int32)
    return Loop(init=(start, jnp.asarray(-1, jnp.int32)),
                cond=lambda c, it: c[0] > 0, body=body,
                finalize=lambda c, it: dict(left=c[0], pick=c[1]))

def _count_build(params, statics, ops):
    (step,) = params
    return Loop(init=jnp.zeros_like(step), cond=lambda c, it: it < 5,
                body=lambda acc, it: acc + step * it.astype(jnp.float64),
                finalize=lambda c, it: dict(acc=c), trip_count=5)

DRAIN = VecEngine("_drain", _drain_build)
COUNT = VecEngine("_count", _count_build)
params = (IN["starts"], IN["costs"], IN["mask"])
for name, chunk, pred in {SCHEDULES!r}:
    plan = BatchPlan(params, _Statics(),
                     predicted_cost=IN["starts"] if pred else None)
    out, rep = vec_engine.run_plan(DRAIN, plan, chunk_size=chunk,
                                   with_report=True)
    for k, v in out.items():
        OUT[name + "/" + k] = v
    for k in {REPORT_KEYS!r}:
        v = getattr(rep, k)
        OUT[name + "/report_" + k] = np.asarray(np.nan if v is None else v)
out = vec_engine.run_plan(COUNT, BatchPlan((IN["steps"],), _Statics()))
for k, v in out.items():
    OUT["count/" + k] = v
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(_CHILD, tmp_path_factory.mktemp("engine_ref"),
                         dict(starts=STARTS, costs=COSTS, mask=MASK,
                              steps=STEPS))


def _drain_plan(pred):
    return BatchPlan((STARTS, COSTS, MASK), None,
                     predicted_cost=STARTS if pred else None)


@pytest.mark.parametrize("name,chunk,pred", SCHEDULES,
                         ids=[s[0] for s in SCHEDULES])
def test_sweep_schedules_match_reference(ref, name, chunk, pred):
    out, rep = vec_engine.run_plan(DRAIN, _drain_plan(pred), device="cpu",
                                   chunk_size=chunk, with_report=True)
    for k in ("left", "pick", "iterations"):
        want = ref[f"{name}/{k}"]
        assert out[k].dtype == want.dtype, k
        assert np.array_equal(out[k], want), k
    for k in REPORT_KEYS:
        want = ref[f"{name}/report_{k}"].item()
        got = getattr(rep, k)
        if isinstance(want, float) and math.isnan(want):
            assert got is None, k
        else:
            assert got == want, (k, got, want)


def test_lanes_stop_at_different_iterations():
    starts = torch.tensor([3.0, 7.0, 1.0, 5.0], dtype=torch.float64)
    costs = torch.tensor([[3.0, 1.0, 1.0, 2.0]] * 4, dtype=torch.float64)
    mask = torch.tensor([[True, False, True, True]] * 4)
    out = run_one(DRAIN, (starts, costs, mask), None)
    assert out["iterations"].tolist() == [3, 7, 1, 5]
    assert out["iterations"].dtype == I32
    assert out["left"].tolist() == [0.0] * 4
    assert out["pick"].tolist() == [2] * 4     # masked first-occurrence


def test_trip_count_loop_matches_reference(ref):
    out = vec_engine.run_plan(COUNT, BatchPlan((STEPS,), None),
                              device="cpu")
    for k in ("acc", "iterations"):
        assert out[k].dtype == ref["count/" + k].dtype
        assert np.array_equal(out[k], ref["count/" + k]), k


def test_chunked_equals_monolithic_with_in_place_body():
    """A body that writes a leaf in place (as netdc's does) keeps the
    chunked == monolithic contract."""
    def build(params, statics, ops):
        (n,) = params
        lanes = torch.arange(n.shape[0])

        def body(c, it):
            # In place: a lane whose cond is false writes spare column 8.
            c[lanes, torch.where(it < n, it, 8).long()] = it
            return c
        return Loop(init=torch.full((n.shape[0], 9), -1, dtype=I32),
                    cond=lambda c, it: it < n, body=body,
                    finalize=lambda c, it: dict(log=c[:, :8]))
    eng = VecEngine("_log", build)
    plan = BatchPlan((np.array([8, 2, 5, 8, 1], np.int32),), None,
                     predicted_cost=np.array([8, 2, 5, 8, 1.0]))
    mono = vec_engine.run_plan(eng, plan, device="cpu")
    chunked = vec_engine.run_plan(eng, plan, device="cpu", chunk_size=2)
    assert mono["log"][1].tolist() == [0, 1, -1, -1, -1, -1, -1, -1]
    for k in mono:
        assert np.array_equal(mono[k], chunked[k]), k


def test_finalize_may_override_iterations():
    eng = VecEngine("_drain2", lambda p, s, ops: Loop(
        init=torch.tensor([2.0]), cond=lambda c, it: c > 0,
        body=lambda c, it: c - 1.0,
        finalize=lambda c, it: dict(iterations=it + 10)))
    assert run_one(eng, None, None)["iterations"].tolist() == [12]


def test_done_short_circuits_without_dispatch():
    marker = dict(empty=True)
    out, report = vec_engine.run_plan(DRAIN, Done(marker), device="cpu",
                                      with_report=True)
    assert out is marker
    assert report.n_cells == 0 and report.n_chunks == 0


@pytest.mark.parametrize("control", ["chunk_size", "use_pallas", "devices"])
def test_run_sweep_takes_controls_only_through_config(control):
    with pytest.raises(TypeError, match="config=SweepConfig"):
        run_sweep("netdc_batch", {"seeds": [0], control: 1}, device="cpu")


def test_run_sweep_rejects_a_config_that_is_not_a_sweep_config():
    with pytest.raises(TypeError, match="must be a SweepConfig"):
        run_sweep("netdc_batch", dict(seeds=[0]), config=dict(chunk_size=1),
                  device="cpu")


def test_auto_chunk_size_policy():
    assert auto_chunk_size(40, None, 1) == 40
    assert auto_chunk_size(40, np.ones(40), 1) == 40          # no spread
    assert auto_chunk_size(40, STARTS, 1) == 20
    assert auto_chunk_size(10, STARTS[:10], 1) == 10          # too few


def test_make_batch_entry_registers_and_routes_sweep():
    try:
        entry = make_batch_entry(
            DRAIN, lambda starts: BatchPlan(
                (np.asarray(starts, np.float64),
                 np.tile([1.0, 2.0], (len(starts), 1)),
                 np.ones((len(starts), 2), bool)), None),
            kind="_drain_batch", name="simulate_drain")
        assert entry.__name__ == "simulate_drain"
        out = entry([2.0, 4.0], device="cpu", use_pallas=True)
        assert out["iterations"].tolist() == [2, 4]
        via = run_scenario("_drain_batch", device="cpu", starts=[2.0, 4.0])
        assert via["iterations"].tolist() == [2, 4]
        res = run_sweep("_drain_batch", dict(starts=[3.0, 3.0]),
                        config=SweepConfig(use_pallas="force"), device="cpu")
        assert isinstance(res.report, SweepReport) and res.report.n_cells == 2
        assert res.summary()["iterations"] == 3.0
    finally:
        backend._SCENARIOS.pop("_drain_batch", None)


def test_unported_kind_and_unknown_backend_raise():
    with pytest.raises(ScenarioUnsupported,
                       match="fleet, fleet_batch, netdc_batch, power_batch"):
        run_sweep("llmserve_batch", dict(seeds=[0]), device="cpu")
    with pytest.raises(BackendError, match="only 'vec'"):
        run_sweep("netdc_batch", dict(seeds=[0]), backend="oo",
                  device="cpu")


def test_registry_is_loaded_only_after_every_import(monkeypatch):
    monkeypatch.setattr(backend, "_loaded", False)
    monkeypatch.setattr(backend, "_SCENARIO_MODULES",
                        ("repro_torch.core.vec_netdc",
                         "repro_torch.core._no_such_module"))
    with pytest.raises(ModuleNotFoundError):
        backend.scenario_kinds()
    assert backend._loaded is False
    monkeypatch.setattr(backend, "_SCENARIO_MODULES",
                        ("repro_torch.core.vec_netdc",))
    assert "netdc_batch" in backend.scenario_kinds()
    assert backend._loaded is True


@pytest.mark.parametrize("config", [
    dict(devices=2), dict(sharding="pmap"), dict(compact=True),
    dict(segment_iters=8)])
def test_paths_not_ported_raise(config):
    with pytest.raises(NotImplementedError, match="A13"):
        run_sweep("netdc_batch", dict(seeds=[0, 1], n_jobs=4),
                  config=SweepConfig(**config), device="cpu")


def test_execute_sweep_streams_chunks_in_original_order():
    seen = []
    fn = vec_engine.batched_sim(DRAIN, None)
    out, rep = execute_sweep(fn, (STARTS, COSTS, MASK), device="cpu",
                             chunk_size=16, predicted_cost=STARTS,
                             on_chunk=lambda cells, o: seen.append(
                                 (cells, o["iterations"])))
    assert rep.bucketed and rep.n_chunks == 3
    cells = np.concatenate([c for c, _ in seen])
    assert sorted(cells.tolist()) == list(range(N))
    for c, its in seen:
        assert np.array_equal(its, STARTS[c].astype(np.int32))
    assert np.array_equal(out["iterations"], STARTS.astype(np.int32))
