"""Rules of the port that hold for every file of it.

* ``src/repro_torch/**`` and ``chip_smoke.py`` import neither JAX nor the
  JAX package (``repro``): the port keeps its own copy of what it needs.
* The device is the card unless the caller says otherwise: without CUDA,
  an entry point called without ``device=`` raises ``RuntimeError``.
* A CUDA tensor goes to the hand-written kernel or the call raises; the
  plain version never runs in its place.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core import run_sweep
from repro_torch.core import vec_cluster as vc
from repro_torch.core.cluster import FleetConfig, StepCost
from repro_torch.core.vec_netdc import simulate_netdc_batch
from repro_torch.core.vec_power import (_Carry, _Params, _Statics,
                                        simulate_power_batch)
from repro_torch.device import resolve_device
from repro_torch.kernels import next_event as ne_mod
from repro_torch.kernels import power_scan as ps_mod

ROOT = pathlib.Path(__file__).resolve().parents[1]
# The fleet slice's files are checked in test_torch_fleet_rules.py.  Split
# so, no tests/test_torch_*.py file holds more than 24 tests: with
# ``--dist loadfile`` pytest-xdist hands the six largest files out first,
# one to each worker, and those must stay reference files (ROADMAP.md).
FLEET_SLICE = ("src/repro_torch/core/cluster.py",
               "src/repro_torch/core/vec_cluster.py",
               "src/repro_torch/kernels/fleet_rng.py",
               "src/repro_torch/kernels/fleet_step.py")
PORT_FILES = [p for p in sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              if str(p.relative_to(ROOT)) not in FLEET_SLICE] + [
    ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_and_no_reference_import(path):
    assert path.exists(), path
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_sweep("netdc_batch", dict(seeds=[0], n_jobs=4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate_netdc_batch(seeds=[0], n_jobs=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate_power_batch(seeds=[0], n_samples=4, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vc.simulate_fleet_batch(StepCost(1.0, 0.5, 0.2), FleetConfig(n_nodes=4),
                                10, seeds=[0])


class _CudaLike:
    """Stands in for a CUDA tensor where there is none: it carries the
    metadata the wrappers check and fails on anything else."""

    def __init__(self, t):
        self._t = t
        self.dtype, self.shape = t.dtype, t.shape
        self.device = torch.device("cuda", 0)

    def dim(self):
        return self._t.dim()

    def __getattr__(self, name):
        raise RuntimeError(f"kernel path touched .{name}")


def _no_plain(*a, **k):
    raise AssertionError("the plain version ran for a CUDA tensor")


def test_next_event_on_cuda_tensor_never_runs_plain(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: chip_smoke.py covers the kernel")
    monkeypatch.setattr(ne_mod, "next_event_ref", _no_plain)
    before = ne_mod.next_event.launches
    with pytest.raises(Exception) as err:
        ne_mod.next_event(_CudaLike(torch.zeros(4, 16, dtype=torch.float64)))
    assert not isinstance(err.value, AssertionError)
    assert ne_mod.next_event.launches == before


def test_power_scan_on_cuda_tensor_never_runs_plain(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: chip_smoke.py covers the kernel")
    monkeypatch.setattr(ps_mod, "power_scan_ref", _no_plain)
    monkeypatch.setattr(ps_mod, "power_step", _no_plain)
    b, h, k, p = 2, 5, 3, 11
    s = _Statics(n_hosts=h, n_points=p, n_intervals=k, n_vms=7,
                 min_active=1)
    f64, i32 = torch.float64, torch.int32
    params = _Params(*(_CudaLike(t) for t in (
        torch.zeros(b, k, dtype=f64), torch.ones(b, h, dtype=f64),
        torch.ones(b, h, dtype=f64), torch.zeros(b, dtype=f64),
        torch.zeros(b, dtype=f64), torch.ones(b, dtype=f64),
        torch.zeros(b, dtype=i32), torch.ones(b, dtype=i32))))
    init = _Carry(*(_CudaLike(t) for t in (
        torch.zeros(b, h, dtype=i32), torch.zeros(b, h, dtype=torch.bool),
        torch.zeros(b, dtype=i32), torch.zeros(b, h, p - 1, dtype=i32),
        torch.zeros(b, h, p - 1, dtype=f64), torch.zeros(b, h, dtype=i32),
        torch.zeros(b, h, dtype=f64), torch.zeros(b, dtype=i32),
        torch.zeros(b, dtype=i32), torch.zeros(b, dtype=i32))))
    before = ps_mod.power_scan.launches
    with pytest.raises(Exception) as err:
        ps_mod.power_scan(init, params, s)
    assert not isinstance(err.value, AssertionError)
    assert ps_mod.power_scan.launches == before


def test_wrappers_refuse_other_devices():
    t = torch.zeros(2, 3, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ne_mod.next_event(t)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
    assert np.array_equal(
        run_sweep("netdc_batch", dict(seeds=[0], n_jobs=3), device="cpu")
        .outputs["iterations"], [3])


def test_kernel_build_is_keyed_by_every_source(tmp_path, monkeypatch):
    """A library is rebuilt when any file of csrc/ changes, and one that
    is already built loads without calling nvcc."""
    import shutil
    from repro_torch.kernels import _build
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build._target("power_scan")
    assert _build._target("power_scan") == first
    assert first.parent == tmp_path / "build"
    (src / "reduce.cuh").write_text((src / "reduce.cuh").read_text() + "\n")
    second = _build._target("power_scan")
    assert second != first
    second.parent.mkdir()
    second.write_bytes(b"")

    def no_nvcc():
        raise AssertionError("nvcc called for a library already built")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    assert _build.build(["power_scan"]) == {}
