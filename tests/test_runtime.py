"""The backend decision (vch_tpu/runtime.py) and the GPU smoke test's
refusal to run without a GPU."""
import os
import subprocess
import sys

import jax
import pytest

from vch_tpu import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_cache_dir_defaults_to_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.setup_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_cache_dir_follows_environment(monkeypatch, tmp_path,
                                       restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    assert runtime.setup_compile_cache() == str(tmp_path)
    # no other directory is set in code
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


@pytest.mark.parametrize("backend,dtype,donate", [
    ("cpu", "float64", ()),
    ("gpu", "float32", (0, 2)),
])
def test_dtype_and_donation_by_backend(monkeypatch, backend, dtype, donate):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert runtime.on_accelerator() == (backend != "cpu")
    assert runtime.default_dtype() == dtype
    assert runtime.donated(0, 2) == donate


def test_batched_problem_jits_without_donation_on_cpu():
    """On the CPU the merge programs are compiled without donated inputs
    (XLA's CPU backend would only warn)."""
    import warnings

    import jax.numpy as jnp
    from vch_tpu.config import ForwardSolverConfig1D
    from vch_tpu.parallel.batch import BatchedProblem1D

    prob = BatchedProblem1D(ForwardSolverConfig1D(N=16, T=0.03))
    old = (jnp.zeros(3), jnp.ones(3))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = prob._merge_v(jnp.asarray([True, False, True]),
                            (jnp.full(3, 2.0), jnp.full(3, 3.0)), old)
    assert out[0].tolist() == [2.0, 0.0, 2.0]
    assert not old[0].is_deleted()


def test_chip_smoke_refuses_cpu():
    """Without a GPU the smoke test exits non-zero and prints no result."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr
