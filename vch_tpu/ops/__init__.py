"""Spatial operators, spectral transforms, quadrature, and potential terms.

These are the building blocks replacing the reference's
NumPy/SciPy operator assembly (ref: Forward_solver.py:57-91,
Forward2_solver.py:86-181). Everything here is either a host-side numpy
precomputation (grid constants, eigenbases) or a pure-jnp function safe
under jit/vmap.
"""
from vch_tpu.ops.grids import trapz_weights, grid_1d, grid_2d
from vch_tpu.ops.laplacian import (
    laplacian_matrix_neumann,
    neumann_eigendecomposition,
    apply_laplacian_1d,
    apply_laplacian_2d,
    stencil_laplacian_1d,
    stencil_laplacian_2d,
)
from vch_tpu.ops.potential import (
    regularized_log,
    f_prime,
    fpp_log,
    free_energy_1d,
    free_energy_2d,
    init_phi_random_1d,
    init_phi_random_2d,
)
from vch_tpu.ops.stability import dispersion_relation, instability_report

__all__ = [
    "trapz_weights", "grid_1d", "grid_2d",
    "laplacian_matrix_neumann", "neumann_eigendecomposition",
    "apply_laplacian_1d", "apply_laplacian_2d",
    "stencil_laplacian_1d", "stencil_laplacian_2d",
    "regularized_log", "f_prime", "fpp_log",
    "free_energy_1d", "free_energy_2d",
    "init_phi_random_1d", "init_phi_random_2d",
    "dispersion_relation", "instability_report",
]
