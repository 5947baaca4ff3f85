"""The program's one backend decision: CPU or accelerator.

On the CPU the solvers default to float64 (exact reference parity) and
buffers are not donated (XLA's CPU backend does not implement donation and
only warns). On an accelerator (the GPU) the default solver dtype is
float32 and the search donates the buffers it no longer needs. This module
also places JAX's persistent compilation cache.
"""
from __future__ import annotations

import os

import jax

# the checkout root: the directory that holds the package
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def on_accelerator() -> bool:
    """Whether JAX's default backend is an accelerator rather than the CPU."""
    return jax.default_backend() != "cpu"


def default_dtype() -> str:
    """Solver dtype when the caller names none."""
    return "float32" if on_accelerator() else "float64"


def donated(*argnums: int) -> tuple:
    """`donate_argnums` for jax.jit: the given positions on an accelerator,
    none on the CPU."""
    return tuple(argnums) if on_accelerator() else ()


def setup_compile_cache() -> str:
    """Enable JAX's persistent compilation cache and return its directory.

    JAX_COMPILATION_CACHE_DIR, when set, is the directory (JAX reads the
    variable itself and no other is set here); otherwise
    `<checkout>/.jax_cache`. Programs that compile in under a second are
    not cached."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(_CHECKOUT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
