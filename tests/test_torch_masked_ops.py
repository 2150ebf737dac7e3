"""The port's masked reductions against the reference's next_event.

The port's plain ``next_event_ref`` and ``masked_min``/``masked_argmin``/
``masked_argmax`` (CPU tensors) must equal, bit for bit, the reference's
Pallas ``next_event(..., interpret=True)`` and its ``next_event_ref`` on
the same inputs: f32 and f64, short and long rows (M = 1, 16, 513, 1500),
planted ties, all-masked rows, and a row count that is no multiple of the
kernel's tile.  Plus the contracts of the reference's
``tests/test_masked_ops.py``.  The CUDA kernel itself is held against this
plain version on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from test_torch_reference import run_reference

from repro_torch.kernels.next_event import next_event, next_event_ref
from repro_torch.kernels.ops import (MaskedOps, masked_argmax, masked_argmin,
                                     masked_min)

SHAPES = [(37, 1), (37, 16), (37, 513), (37, 1500)]
DTYPES = ["float32", "float64"]


def _inputs(r, m, dtype, seed):
    rng = np.random.default_rng(seed)
    # Few distinct values ⇒ many ties; some +inf slots; some rows fully
    # masked and some fully +inf.
    vals = np.array([0.25, 1.5, 3.0, 7.25, np.inf], dtype)
    t = rng.choice(vals, size=(r, m)).astype(dtype)
    t[3] = np.inf
    mask = rng.random((r, m)) < 0.7
    mask[5] = False
    mask[6] = True
    return t, mask


CASES = {f"{d}_{r}x{m}": (r, m, d) for d in DTYPES for r, m in SHAPES}

_CHILD = """
import jax.numpy as jnp
from repro.kernels.next_event import next_event, next_event_ref
from repro.kernels.ops import masked_argmax, masked_argmin, masked_min
with jax.experimental.enable_x64():
    for key in sorted({k.split("/")[0] for k in IN}):
        t, m = jnp.asarray(IN[key + "/t"]), jnp.asarray(IN[key + "/mask"])
        v, i = next_event(t, m, interpret=True)
        OUT[key + "/kernel_v"], OUT[key + "/kernel_i"] = v, i
        v, i = next_event(t, interpret=True)
        OUT[key + "/kernel_nomask_v"], OUT[key + "/kernel_nomask_i"] = v, i
        v, i = next_event_ref(t, m)
        OUT[key + "/ref_v"], OUT[key + "/ref_i"] = v, i
        OUT[key + "/min"] = masked_min(t, m)
        OUT[key + "/argmin"] = masked_argmin(t, m)
        OUT[key + "/argmax"] = masked_argmax(t, m)
        OUT[key + "/argmax_pallas"] = masked_argmax(t, m, use_pallas=True)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    inputs = {}
    for n, (key, (r, m, d)) in enumerate(sorted(CASES.items())):
        t, mask = _inputs(r, m, d, seed=n)
        inputs[key + "/t"], inputs[key + "/mask"] = t, mask
    out = run_reference(_CHILD, tmp_path_factory.mktemp("ne_ref"), inputs)
    return inputs, out


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("key", sorted(CASES))
def test_plain_next_event_matches_reference_kernel(ref, key):
    inputs, out = ref
    t = torch.from_numpy(inputs[key + "/t"])
    m = torch.from_numpy(inputs[key + "/mask"])
    v, i = next_event(t, m)                 # CPU tensor ⇒ plain version
    assert v.dtype == t.dtype and i.dtype == torch.int32
    assert out[key + "/kernel_v"].dtype == v.numpy().dtype
    assert _eq(v, out[key + "/kernel_v"]) and _eq(i, out[key + "/kernel_i"])
    assert _eq(v, out[key + "/ref_v"]) and _eq(i, out[key + "/ref_i"])
    v, i = next_event_ref(t)
    assert _eq(v, out[key + "/kernel_nomask_v"])
    assert _eq(i, out[key + "/kernel_nomask_i"])


@pytest.mark.parametrize("key", sorted(CASES))
def test_masked_ops_match_reference(ref, key):
    inputs, out = ref
    t = torch.from_numpy(inputs[key + "/t"])
    m = torch.from_numpy(inputs[key + "/mask"])
    ops = MaskedOps()
    assert _eq(ops.min(t, m), out[key + "/min"])
    assert _eq(ops.argmin(t, m), out[key + "/argmin"])
    assert _eq(ops.argmax(t, m), out[key + "/argmax"])
    assert _eq(ops.argmax(t, m), out[key + "/argmax_pallas"])


def test_masked_min_basic_and_mask():
    v = torch.tensor([3.0, 1.0, 2.0, 0.5], dtype=torch.float64)
    assert float(masked_min(v)) == 0.5
    m = torch.tensor([True, True, True, False])
    assert float(masked_min(v, m)) == 1.0
    assert int(masked_argmin(v, m)) == 1
    assert int(masked_argmax(v, m)) == 0


def test_all_masked_returns_inf_and_index_zero():
    v = torch.tensor([5.0, 7.0, 9.0], dtype=torch.float64)
    m = torch.zeros(3, dtype=torch.bool)
    assert np.isinf(float(masked_min(v, m)))
    assert int(masked_argmin(v, m)) == 0
    assert int(masked_argmax(v, m)) == 0


def test_first_occurrence_tie_breaking():
    v = torch.tensor([4.0, 2.0, 2.0, 4.0], dtype=torch.float64)
    assert int(masked_argmin(v)) == 1
    assert int(masked_argmax(v)) == 0
    m = torch.tensor([True, False, True, True])
    assert int(masked_argmin(v, m)) == 2
    assert int(masked_argmax(v, m)) == 0
    assert int(masked_argmax(v, torch.tensor([False, True, True, True]))) == 3


def test_last_axis_reduction_with_leading_dims():
    v = torch.tensor([[[3.0, 1.0], [2.0, 5.0]]], dtype=torch.float32)
    assert masked_min(v).tolist() == [[1.0, 2.0]]
    assert masked_argmin(v).tolist() == [[1, 0]]
    assert masked_argmax(v).tolist() == [[0, 1]]


def test_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError, match="float32 or float64"):
        next_event(torch.zeros(2, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="non-empty"):
        next_event(torch.zeros(2, 0))
    with pytest.raises(ValueError, match="mask must be bool"):
        next_event(torch.zeros(2, 3), torch.ones(2, 3))
    with pytest.raises(ValueError, match="cuda or cpu"):
        next_event(torch.zeros(2, 3, device="meta"))
