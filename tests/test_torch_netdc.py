"""``netdc_batch`` in the port against the JAX reference, bit for bit.

The reference runs in one child process per module
(:func:`test_torch_reference.run_reference`); the port runs here on the
CPU (``device="cpu"``, the plain PyTorch versions).  Every output key,
dtype, shape and value must match, unfaulted, under a fault plan with
retries, with a timeout, and against the committed golden fixtures.
"""
import inspect
import json
import math
import pathlib

import numpy as np
import pytest

from test_torch_reference import assert_same, run_reference

from repro_torch.convert import params_from_reference
from repro_torch.core import SweepConfig, run_sweep
from repro_torch.core.faults import FaultEvent, FaultPlan, RetryPolicy
from repro_torch.core.vec_engine import run_one
from repro_torch.core.vec_netdc import NETDC_ENGINE

GOLDEN = pathlib.Path(__file__).parent / "golden"

PLAN = dict(events=[("node", 10.0, 30.0, 1, 1.0),
                    ("node", 40.0, 55.0, 0, 1.0),
                    ("link", 20.0, 50.0, -1, 3.0),
                    ("transient", 0.0, 64.0, -1, 0.4)], seed=11)
RETRY = dict(max_retries=2, base_delay_s=0.5, backoff=2.0,
             jitter_frac=0.25, budget_s=60.0)

CASES = {
    "grid": dict(seeds=list(range(8)), n_dcs=4, n_jobs=40,
                 locality_weight=[1.0, 1.5, 2.5, 1.0] * 2,
                 offline_dc=[-1, -1, -1, 2] * 2),
    "fault": dict(seeds=[0, 1, 2, 3], n_dcs=4, n_jobs=40, mean_gap_s=2.0,
                  fault_plan=PLAN, retry=RETRY, timeout_s=240.0),
    "timeout": dict(seeds=[0, 1, 2], n_dcs=5, n_jobs=30,
                    locality_weight=2.0, timeout_s=25.0),
}


def make_kwargs(case, FaultEvent, FaultPlan, RetryPolicy):
    """Scenario kwargs from plain data, with either package's fault
    types (shipped to the reference child as source)."""
    kw = dict(case)
    if "fault_plan" in kw:
        p = kw["fault_plan"]
        kw["fault_plan"] = FaultPlan(
            [FaultEvent(k, ts, te, target=t, severity=s)
             for k, ts, te, t, s in p["events"]], seed=p["seed"])
    if "retry" in kw:
        kw["retry"] = RetryPolicy(**kw["retry"])
    return kw


_CHILD = inspect.getsource(make_kwargs) + f"""
import math
from repro.core.backend import run_sweep
from repro.core import vec_engine
from repro.core.faults import FaultEvent, FaultPlan, RetryPolicy
from repro.core.vec_netdc import NETDC_ENGINE, _prepare_netdc
CASES = {CASES!r}
for name, case in CASES.items():
    kw = make_kwargs(case, FaultEvent, FaultPlan, RetryPolicy)
    out, rep = run_sweep("netdc_batch", kw)
    for k, v in out.items():
        OUT[name + "/" + k] = v
    # The engine alone: the plan's tables and its raw outputs.
    plan = _prepare_netdc(use_pallas=False, **kw)
    for f in plan.params._fields:
        OUT["plan_" + name + "/" + f] = np.asarray(getattr(plan.params, f))
    OUT["statics_" + name] = np.asarray(
        [plan.statics.n_jobs, plan.statics.n_dcs, plan.statics.timeout,
         float(plan.statics.guarded)], np.float64)
    raw = vec_engine.run_plan(NETDC_ENGINE, plan._replace(finalize=None))
    for k, v in raw.items():
        OUT["raw_" + name + "/" + k] = v
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(_CHILD, tmp_path_factory.mktemp("netdc_ref"))


def _port(case, **config):
    kw = make_kwargs(case, FaultEvent, FaultPlan, RetryPolicy)
    return run_sweep("netdc_batch", kw, config=SweepConfig(**config),
                     device="cpu")


@pytest.mark.parametrize("name", sorted(CASES))
def test_sweep_matches_reference(ref, name):
    out, report = _port(CASES[name])
    assert_same(ref, out, prefix=name + "/")
    assert report.n_cells == len(CASES[name]["seeds"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_engine_alone_reproduces_reference_raw_outputs(ref, name):
    """The reference's own tables, loaded through params_from_reference,
    give the reference's raw loop outputs — independent of the port's
    copy of the table builders."""
    n_jobs, n_dcs, timeout, guarded = ref["statics_" + name]
    arrays = {k.split("/", 1)[1]: v for k, v in ref.items()
              if k.startswith(f"plan_{name}/")}
    params, statics = params_from_reference(
        "netdc_batch", arrays,
        dict(n_jobs=int(n_jobs), n_dcs=int(n_dcs), timeout=float(timeout),
             guarded=bool(guarded), use_pallas=False), device="cpu")
    got = {k: v.numpy() for k, v in
           run_one(NETDC_ENGINE, params, statics).items()}
    assert_same(ref, got, prefix=f"raw_{name}/")


@pytest.mark.parametrize("chunk_size", [1, 3])
def test_chunked_sweep_matches_reference(ref, chunk_size):
    out, report = _port(CASES["fault"], chunk_size=chunk_size)
    assert report.n_chunks == math.ceil(4 / chunk_size)
    assert_same(ref, out, prefix="fault/")


def _golden(name):
    stored = json.loads((GOLDEN / f"{name}.json").read_text())
    return stored["outputs"]


def _assert_golden(stored, out):
    assert sorted(stored) == sorted(out)
    for k, want in stored.items():
        got, want = np.asarray(out[k]), np.asarray(want)
        assert got.shape == want.shape, k
        assert np.array_equal(got, want), k     # JSON floats round-trip


def test_golden_netdc_batch():
    """Config of tests/test_golden.py::_netdc_case."""
    out, _ = run_sweep("netdc_batch", dict(
        seeds=[0, 1, 2, 3], n_dcs=4, n_jobs=32,
        locality_weight=np.array([1.0, 1.0, 2.5, 2.5]),
        offline_dc=np.array([-1, 1, -1, 1])), device="cpu")
    _assert_golden(_golden("netdc_batch"), out)


def test_golden_netdc_chaos():
    """Config of tests/test_golden.py::_netdc_chaos_case (frozen from
    the reference's OO broker; the reference has no iteration count
    there)."""
    kw = make_kwargs(dict(fault_plan=PLAN, retry=RETRY), FaultEvent,
                     FaultPlan, RetryPolicy)
    out, _ = run_sweep("netdc_batch", dict(
        seeds=[0, 1, 2], n_dcs=4, n_jobs=32, mean_gap_s=2.0,
        timeout_s=240.0, **kw), device="cpu")
    out = dict(out)
    assert np.array_equal(out.pop("iterations"), [32, 32, 32])
    _assert_golden(_golden("netdc_chaos"), out)


def test_empty_batch_short_circuits():
    out, report = run_sweep("netdc_batch", dict(seeds=[], n_dcs=3),
                            device="cpu")
    assert report.n_cells == 0 and out["finish"].shape == (0, 0)


def test_delay_rows_equal_scalar_store_and_forward():
    """The vectorized routing table is the scalar closed form, entry for
    entry (the reference asserts the same of its copy)."""
    from repro_torch.core.network import InterDCTopology
    topo = InterDCTopology(6, link_bw=8e9, hop_latency_s=0.015)
    rng = np.random.default_rng(0)
    src = rng.integers(0, 6, 50)
    payload = rng.uniform(1e6, 2e8, 50)
    rows = topo.delay_rows(src, payload)
    want = [[topo.transfer_delay(int(s), d, float(p)) for d in range(6)]
            for s, p in zip(src, payload)]
    assert np.array_equal(rows, np.asarray(want))


def test_params_from_reference_rejects_what_it_cannot_carry():
    with pytest.raises(ValueError, match="not ported"):
        params_from_reference("llmserve_batch", {}, {}, device="cpu")
    with pytest.raises(ValueError, match="missing arrays"):
        params_from_reference("netdc_batch", {"submit": np.zeros((1, 2))},
                              {}, device="cpu")
