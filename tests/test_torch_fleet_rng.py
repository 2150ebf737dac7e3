"""The fleet loop's random stream (``repro_torch.kernels.fleet_rng``).

The kernel repeats these operations word for word, so on the card the two
agree bit for bit (``chip_smoke.py``); here the plain versions are held to
known answers and to torch's own special functions.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import fleet_rng as rng

I64 = torch.int64


def _w(*vals):
    return [torch.tensor(v, dtype=I64) for v in vals]


# Known-answer vectors of Philox4x32-10 (Random123's kat_vectors).
@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, want):
    got = rng.philox4x32(*_w(*ctr), *_w(*key))
    assert [int(x) for x in got] == list(want)


def test_draw_broadcasts_and_separates_streams():
    seed = torch.tensor([[7], [8]], dtype=I64)
    it = torch.tensor([[3], [3]], dtype=torch.int32)
    node = torch.arange(5)[None, :]
    w = rng.draw(seed, rng.STREAM_JITTER, it, node)
    assert all(x.shape == (2, 5) and x.dtype == I64 for x in w)
    assert all(bool(((x >= 0) & (x <= rng.MASK32)).all()) for x in w)
    one = rng.draw(torch.tensor(8), rng.STREAM_JITTER, torch.tensor(3),
                   torch.tensor(4))
    assert [int(x) for x in one] == [int(x[1, 4]) for x in w]
    other = rng.draw(torch.tensor(8), rng.STREAM_EVICT, torch.tensor(3),
                     torch.tensor(4))
    assert [int(x) for x in other] != [int(x) for x in one]


def test_uniforms_are_exact_and_in_range():
    lo, hi = torch.tensor(0, dtype=I64), torch.tensor(rng.MASK32, dtype=I64)
    assert float(rng.uniform24(lo)) == 2.0 ** -24
    assert float(rng.uniform24(hi)) == 1.0
    assert float(rng.uniform53(lo, lo)) == 2.0 ** -53
    assert float(rng.uniform53(hi, hi)) == 1.0
    assert rng.uniform24(hi).dtype == torch.float32
    for dtype in (torch.float32, torch.float64):
        u = rng.uniform_min(lo, lo, dtype, 1e-12)
        assert u.dtype == dtype and float(u) == float(torch.tensor(
            1e-12, dtype=dtype))
        assert float(rng.uniform_min(hi, hi, dtype, 1e-12)) < 1.0


def test_normals_have_unit_moments():
    w = rng.draw(torch.tensor(11, dtype=I64), rng.STREAM_JITTER,
                 torch.tensor(0), torch.arange(200_000))
    for z in (rng.normal_f32(w[0], w[1]), rng.normal_f64(*w)):
        assert bool(torch.isfinite(z).all())
        assert abs(float(z.double().mean())) < 0.01
        assert abs(float(z.double().std()) - 1.0) < 0.01
        assert abs(float((z.double() > 1.959964).double().mean()) - 0.025) \
            < 0.002


def test_ndtri_matches_torch_special_to_1e14():
    g = np.random.default_rng(0)
    p = torch.tensor(np.concatenate([
        g.uniform(0.0, 1.0, 100_000), np.logspace(-300, -1, 2000),
        1.0 - np.logspace(-15, -1, 2000), [0.5, 0.075, 0.925, 1e-12]]))
    got, want = rng.ndtri(p), torch.special.ndtri(p)
    rel = (got - want).abs() / want.abs().clamp(min=1e-300)
    assert float(rel.max()) <= 1e-14, float(rel.max())
    assert rng.ndtri(torch.tensor([0.0, 1.0])).tolist() == [-math.inf,
                                                            math.inf]
    f = rng.ndtri(torch.tensor([0.025, 0.5, 0.975], dtype=torch.float32))
    assert f.dtype == torch.float32
    assert torch.allclose(f.double(), torch.tensor([-1.959964, 0.0,
                                                    1.959964],
                                                   dtype=torch.float64),
                          atol=1e-5)


def test_root_is_pow_to_a_few_ulp():
    g = np.random.default_rng(1)
    u = torch.tensor(g.uniform(1e-12, 1.0, 10_000))
    e = 1.0 / torch.tensor(g.integers(1, 2000, 10_000), dtype=torch.float64)
    got, want = rng.root(u, e), torch.pow(u, e)
    assert float(((got - want).abs() / want).max()) < 1e-13
