"""``power_batch`` in the port against the JAX reference, bit for bit.

The reference (``vec`` with ``use_pallas=False``; its fused scan path
cannot run on the installed JAX, and was made bit-identical to the plain
path by construction) runs in one child process per module; the port runs
here on the CPU, where the driver's Python loop runs the power step.
"""
import inspect
import itertools
import json
import pathlib

import numpy as np
import pytest
import torch

from test_torch_reference import assert_same, run_reference

from repro_torch.convert import params_from_reference
from repro_torch.core import SweepConfig, run_sweep
from repro_torch.core.faults import FaultEvent, FaultPlan
from repro_torch.core.vec_engine import run_one
from repro_torch.core.vec_power import POWER_ENGINE
from repro_torch.kernels.power_scan import even_counts

GOLDEN = pathlib.Path(__file__).parent / "golden"

_GRID = list(itertools.product([0.7, 0.9], [0.2, 0.4], [0, 2],
                               [700.0, 1000.0]))
CASES = {
    "grid": dict(seeds=list(range(len(_GRID))), n_hosts=10, n_vms=28,
                 n_samples=40, up_thr=[g[0] for g in _GRID],
                 lo_thr=[g[1] for g in _GRID],
                 cooldown=[g[2] for g in _GRID],
                 vm_mips=[g[3] for g in _GRID]),
    "fault": dict(seeds=[3, 4, 5, 6], n_hosts=9, n_vms=30, n_samples=36,
                  interval=300.0, up_thr=[0.75, 0.85, 0.75, 0.85],
                  cooldown=1, min_active=2,
                  fault_plan=dict(events=[("node", 900.0, 4200.0, 0),
                                          ("node", 3000.0, 6000.0, 4),
                                          ("node", 7200.0, 9000.0, -1)],
                                  seed=5)),
}


def make_kwargs(case, FaultEvent, FaultPlan):
    """Scenario kwargs from plain data (shipped to the reference child
    as source)."""
    kw = dict(case)
    if "fault_plan" in kw:
        p = kw["fault_plan"]
        evs = []
        for kind, ts, te, tgt in p["events"]:
            if tgt < 0:     # every host but the last: one must survive
                evs += [FaultEvent(kind, ts, te, target=h)
                        for h in range(kw["n_hosts"] - 1)]
            else:
                evs.append(FaultEvent(kind, ts, te, target=tgt))
        kw["fault_plan"] = FaultPlan(evs, seed=p["seed"])
    return kw


_CHILD = inspect.getsource(make_kwargs) + f"""
import dataclasses
from repro.core.backend import run_sweep
from repro.core import vec_engine
from repro.core.faults import FaultEvent, FaultPlan
from repro.core.vec_power import POWER_ENGINE, _prepare_power
CASES = {CASES!r}
for name, case in CASES.items():
    kw = make_kwargs(case, FaultEvent, FaultPlan)
    out, rep = run_sweep("power_batch", kw)
    for k, v in out.items():
        OUT[name + "/" + k] = v
    plan = _prepare_power(use_pallas=False, **kw)
    for f in plan.params._fields:
        v = getattr(plan.params, f)
        if v is not None:
            OUT["plan_" + name + "/" + f] = np.asarray(v)
    st = dataclasses.asdict(plan.statics)
    OUT["statics_" + name] = np.asarray(
        [st[k] for k in ("n_hosts", "n_points", "n_intervals", "n_vms",
                         "min_active", "faults")], np.int64)
    raw = vec_engine.run_plan(POWER_ENGINE, plan._replace(finalize=None))
    for k, v in raw.items():
        OUT["raw_" + name + "/" + k] = v
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(_CHILD, tmp_path_factory.mktemp("power_ref"))


def _port(case, **config):
    kw = make_kwargs(case, FaultEvent, FaultPlan)
    return run_sweep("power_batch", kw, config=SweepConfig(**config),
                     device="cpu")


@pytest.mark.parametrize("name", sorted(CASES))
def test_sweep_matches_reference(ref, name):
    out, report = _port(CASES[name])
    assert_same(ref, out, prefix=name + "/")
    assert report.n_chunks == 1


@pytest.mark.parametrize("name", sorted(CASES))
def test_engine_alone_reproduces_reference_raw_outputs(ref, name):
    """The reference plan's tables, loaded through params_from_reference,
    give its raw accumulators (segment hits and frac sums included)."""
    fields = ("n_hosts", "n_points", "n_intervals", "n_vms", "min_active",
              "faults")
    statics = dict(zip(fields, (int(v) for v in ref["statics_" + name])))
    statics["faults"] = bool(statics["faults"])
    arrays = {k.split("/", 1)[1]: v for k, v in ref.items()
              if k.startswith(f"plan_{name}/")}
    params, st = params_from_reference("power_batch", arrays, statics,
                                       device="cpu")
    assert (params.fail_tbl is not None) == st.faults
    got = {k: v.numpy() for k, v in run_one(POWER_ENGINE, params,
                                             st).items()}
    assert_same(ref, got, prefix=f"raw_{name}/")


@pytest.mark.parametrize("chunk_size", [3, 5])
def test_chunked_sweep_matches_reference(ref, chunk_size):
    out, report = _port(CASES["grid"], chunk_size=chunk_size)
    assert report.n_chunks == -(-len(_GRID) // chunk_size)
    assert_same(ref, out, prefix="grid/")


def test_golden_power_batch():
    """Config of tests/test_golden.py::_power_case (frozen from the
    reference's OO manager)."""
    stored = json.loads((GOLDEN / "power_batch.json").read_text())
    out, _ = run_sweep("power_batch", dict(stored["config"]), device="cpu")
    assert sorted(stored["outputs"]) == sorted(out)
    for k, want in stored["outputs"].items():
        got, want = np.asarray(out[k]), np.asarray(want)
        assert got.shape == want.shape and np.array_equal(got, want), k


def test_even_counts_spreads_remainder_to_first_active_hosts():
    act = torch.tensor([[True, False, True, True, False],
                        [False, False, False, False, False]])
    got = even_counts(act, 7)
    assert got.dtype == torch.int32
    assert got.tolist() == [[3, 0, 2, 2, 0], [0, 0, 0, 0, 0]]


def test_segment_energy_reproduces_table_interpolation():
    """Counting segment hits and summing fracs, then applying the table
    once, equals interpolating every interval (the exact decomposition
    both the reference and the port rely on)."""
    from repro_torch.core.power import (interp_table, make_power_fleet,
                                        power_points, segment_energy_j,
                                        table_segment)
    rng = np.random.default_rng(1)
    for model in make_power_fleet(6, "mixed"):
        pts = power_points(model, 11)
        utils = np.concatenate([rng.uniform(0, 1, 40), [0.0, 0.5, 1.0]])
        count, frac = np.zeros(10, np.int64), np.zeros(10)
        for u in utils:
            s, f = table_segment(float(u), 11)
            count[s] += 1
            frac[s] += f
        e = segment_energy_j(np.asarray(pts)[None], count[None], frac[None],
                             1.0)[0]
        direct = sum(interp_table(pts, float(u)) for u in utils)
        assert abs(e - direct) <= 1e-9 * direct
