"""The rules of ``test_torch_hygiene.py`` for the fleet slice's files.

* They import neither JAX nor the JAX package (``repro``).
* A CUDA tensor goes to the hand-written fleet loop or the call raises;
  the plain version never runs in its place.
"""
import pytest
import torch

from test_torch_hygiene import (FLEET_SLICE, ROOT, _CudaLike, _imports,
                                _no_plain)

from repro_torch.core import vec_cluster as vc
from repro_torch.kernels import fleet_step as fs_mod


@pytest.mark.parametrize("rel", FLEET_SLICE)
def test_no_jax_and_no_reference_import(rel):
    path = ROOT / rel
    assert path.exists(), path
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_fleet_loop_on_cuda_tensor_never_runs_plain(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: chip_smoke.py covers the kernel")
    monkeypatch.setattr(fs_mod, "fleet_loop_ref", _no_plain)
    monkeypatch.setattr(fs_mod, "fleet_step", _no_plain)
    b, n, k = 2, 6, 4
    s = vc._Statics(n_nodes=5, n_spares=1, k_fail_rounds=k, k_degrade=8,
                    window=20, degrade=False)
    f64, i32, cuda = torch.float64, torch.int32, lambda t: _CudaLike(t)
    params = vc._Params(*(cuda(torch.zeros(b, dtype=i32 if name in (
        "ckpt_every", "total_steps") else f64)) for name in vc._Params._fields))
    tables = vc._Tables(fail_start=cuda(torch.zeros(b, n, k, dtype=f64)),
                        bias0=cuda(torch.ones(b, n, dtype=f64)),
                        seed=cuda(torch.zeros(b, dtype=torch.int64)))
    per_node = dict(bias=f64, slow_count=i32, evict_until=f64,
                    was_up=torch.bool, was_active=torch.bool)
    scalar = dict(step=i32, last_ckpt=i32, failures=i32, restarts=i32,
                  evictions=i32)
    init = vc._Carry(**{
        name: cuda(torch.zeros((b, n), dtype=per_node[name]))
        if name in per_node else
        cuda(torch.zeros(b, dtype=scalar.get(name, f64)))
        for name in vc._Carry._fields})
    before = fs_mod.fleet_loop.launches
    with pytest.raises(Exception) as err:
        fs_mod.fleet_loop(init, params, tables, s)
    assert not isinstance(err.value, AssertionError)
    assert "kernel path touched" in str(err.value)
    assert fs_mod.fleet_loop.launches == before
