"""The JAX reference, run in a child process for the port's tests.

The port's tests never import ``repro`` in the pytest process: loading it
on the installed JAX needs two process-global patches, and applying them
here would change what the reference's own test files see when they share
an xdist worker.  :func:`run_reference` starts one child ``python`` with
``PYTHONPATH=src`` and ``JAX_PLATFORMS=cpu`` that applies the patches,
runs a block of reference code on inputs handed over as an ``.npz``, and
writes the arrays that code stores in ``OUT`` to another ``.npz``.

Each ``test_torch_*`` module batches its reference calls into one child
(a module-scoped fixture), so JAX starts a few times per run, not once
per case.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

# Applied only inside the child: the installed JAX moved
# ``shaped_abstractify`` and removed ``jax.experimental.enable_x64``, which
# the reference imports.
_PRELUDE = """\
import sys
import numpy as np
import jax
import jax._src.api_util
import jax._src.core
import jax.experimental
jax._src.api_util.shaped_abstractify = jax._src.core.shaped_abstractify
jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)
IN = dict(np.load(sys.argv[1]))
OUT = {}
"""

_EPILOGUE = """
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in OUT.items()})
"""


def run_reference(code: str, tmp_dir, inputs=None, timeout: float = 240.0):
    """Run ``code`` against the reference in a child process.

    ``code`` sees ``IN`` (the ``inputs`` arrays by name) and stores numpy
    arrays into ``OUT``; the returned dict holds them.  Raises with the
    child's output when it fails.
    """
    tmp_dir = pathlib.Path(tmp_dir)
    tmp_dir.mkdir(parents=True, exist_ok=True)
    src = tmp_dir / "reference_job.py"
    src.write_text(_PRELUDE + textwrap.dedent(code) + _EPILOGUE)
    fin, fout = tmp_dir / "reference_in.npz", tmp_dir / "reference_out.npz"
    np.savez(fin, **{k: np.asarray(v) for k, v in (inputs or {}).items()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(src), str(fin), str(fout)], cwd=str(ROOT),
        env=env, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(
            f"reference child failed ({proc.returncode}):\n"
            f"{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}")
    with np.load(fout) as z:
        return {k: z[k] for k in z.files}


def assert_same(ref: dict, got: dict, prefix: str = "", keys=None):
    """Every reference array equals the port's bit for bit: same keys,
    dtype, shape and values (NaN-free; ``inf`` compares equal)."""
    names = sorted(k[len(prefix):] for k in ref if k.startswith(prefix))
    if keys is None:
        assert names == sorted(got), (names, sorted(got))
    for k in names if keys is None else keys:
        want, have = ref[prefix + k], np.asarray(got[k])
        assert have.dtype == want.dtype, (k, have.dtype, want.dtype)
        assert have.shape == want.shape, (k, have.shape, want.shape)
        assert np.array_equal(have, want), (k, have, want)


def test_child_runs_reference_and_returns_arrays(tmp_path):
    out = run_reference("""
        from repro.kernels.next_event import next_event_ref
        import jax.numpy as jnp
        with jax.experimental.enable_x64():
            v, i = next_event_ref(jnp.asarray(IN["t"]))
        OUT["v"], OUT["i"] = np.asarray(v), np.asarray(i)
        OUT["jax_in_child"] = np.asarray("jax" in sys.modules)
    """, tmp_path, inputs=dict(t=np.array([[3.0, 1.0, 1.0], [2.0, 5.0, 0.5]])))
    assert out["v"].dtype == np.float64
    assert np.array_equal(out["v"], [1.0, 0.5])
    assert np.array_equal(out["i"], [1, 2])
    assert bool(out["jax_in_child"])


def test_child_failure_raises_with_its_output(tmp_path):
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        run_reference("1 / 0\n", tmp_path)


def test_port_tests_do_not_load_the_reference_here():
    """The port's test modules reach the reference only through the
    child: importing them pulls neither ``repro`` nor the JAX patches
    into this process."""
    code = textwrap.dedent("""
        import sys
        sys.path[:0] = [sys.argv[1], sys.argv[2]]
        import test_torch_masked_ops, test_torch_vec_engine  # noqa: F401
        import test_torch_netdc, test_torch_power  # noqa: F401
        import test_torch_fleet, test_torch_fleet_rng  # noqa: F401
        import test_torch_hygiene  # noqa: F401
        bad = [m for m in sys.modules
               if m == "repro" or m.startswith("repro.") or m == "jax"]
        print(bad)
        sys.exit(1 if bad else 0)
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code, str(ROOT / "tests"), str(ROOT / "src")],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
