"""vch_tpu — sparse optimal control of the viscous Cahn–Hilliard system in JAX.

A brand-new JAX/XLA engine (not a port) with the capabilities of the
reference NumPy/SciPy code `Sparse-optimal-control-of-Viscous-Chan-hilliard-
via-Gradient-descent--1D-2D`:

- Crank–Nicolson forward solver with convex–concave splitting and monolithic
  Newton–Raphson on the coupled (phi, mu) system (ref: Forward_solver.py,
  Forward2_solver.py), re-architected as a `lax.scan` time marcher whose Newton
  linear solve is a Schur-complement system — dense batched solve in 1D,
  DCT-preconditioned matrix-free Krylov (pure matmuls) in 2D.
- Adjoint (p, q, r) backward sweep (ref: backward_solver.py,
  backward2_solver.py) as a reverse `lax.scan` over the stored trajectory.
- Proximal-gradient (ISTA) outer loop with soft-thresholding, box projection,
  optimistic step + backtracking line search, plateau detection, alpha advisor
  (ref: GD_1D.py, GD2_configured.py).
- KKT sparsity verification and second-order coercivity probes
  (ref: second_order_conditions*.py).
- Scenario batching via vmap and multi-device sharding via `jax.sharding.Mesh`
  + NamedSharding (new capability; the reference is single-process CPU).

Layout:
  ops/       spatial operators, spectral transforms, quadrature, potential
  models/    forward + adjoint PDE solvers (1D and 2D)
  control/   cost functional, prox, PGD loop, targets, diagnostics
  parallel/  mesh construction, sharded batched runners
  utils/     timers, checkpointing, io
  viz/       plotting / animation suite
"""

__version__ = "0.1.0"

# On the GPU, float32 matmuls at JAX's default precision may run in TF32,
# which keeps about three decimal digits; the cosine eigenbasis transforms
# and Laplacian applies at the heart of every solve are condition-sensitive
# (the adjoint operator reaches condition ~1e6), so the package asks for
# "highest", which keeps float32 products out of TF32 (float64 never uses
# it). Override via VCH_MATMUL_PRECISION for experiments.
import os as _os

import jax as _jax

_jax.config.update("jax_default_matmul_precision",
                   _os.environ.get("VCH_MATMUL_PRECISION", "highest"))

from vch_tpu.config import (  # noqa: F401
    ForwardSolverConfig1D,
    ForwardSolverConfig2D,
    OptimizationConfig,
    SimulationParameters,
    load_params,
    save_params,
)
