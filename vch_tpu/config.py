"""Typed configuration, JSON persistence, and interactive prompting.

Mirrors the reference's config surface (ref: src/1D/Vch_control_1D/config.py,
src/2D/Vch_control_2D/config.py) — models with the same field names,
defaults, and validators (c2 > c1 at 1D config.py:104-109; u_max > u_min at
:125-129), JSON round-trip persistence of the last run (config.py:142-171),
and an interactive prompter that displays previous-run values and re-prompts
only invalid fields (config.py:180-265). The models are standard-library
dataclasses: construction coerces each value to its field's type (so the
prompter can pass raw strings), then checks the bounds and cross-field rules
and raises ConfigError listing every invalid field.

Additions absent in the reference:
  - `dtype` / `newton_tol` / `newton_max_iter` / Krylov solver knobs,
  - `BatchConfig` describing the scenario batch + mesh sharding.
"""
from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Type

# Numerical safeguard: keep |phi| <= 1 - delta_sep (ref: Forward_solver.py:42).
DELTA_SEP = 1e-2


class ConfigError(ValueError):
    """Invalid configuration values; `errors` lists (field, message) pairs."""

    def __init__(self, errors: List[Tuple[str, str]]):
        self.errors = errors
        super().__init__("; ".join(f"{name}: {msg}" for name, msg in errors))


def _field(default, description: str = "", *, gt=None, ge=None):
    return field(default=default, metadata={"description": description,
                                            "gt": gt, "ge": ge})


def _coerce(value, tp):
    """Convert `value` to the annotated field type `tp` (str, int, float or
    Optional of one); strings are parsed, so prompted input round-trips."""
    args = typing.get_args(tp)
    if typing.get_origin(tp) is typing.Union and type(None) in args:
        if value is None or (isinstance(value, str)
                             and value.strip().lower() in ("none", "null")):
            return None
        tp = next(a for a in args if a is not type(None))
    if isinstance(value, bool):
        raise ValueError(f"expected {tp.__name__}, got a boolean")
    if tp is int:
        if isinstance(value, float) and value.is_integer():
            return int(value)
        if isinstance(value, (int, str)):
            return int(value)
    elif tp is float:
        if isinstance(value, (int, float, str)):
            return float(value)
    elif tp is str:
        if isinstance(value, str):
            return value
    raise ValueError(f"expected {tp.__name__}, got {value!r}")


class _Model:
    """Coercion, bounds (`gt`/`ge` field metadata) and cross-field rules
    (`_checks`) run on construction and on `dataclasses.replace`."""

    def _checks(self) -> List[Tuple[str, str]]:
        return []

    def __post_init__(self):
        hints = typing.get_type_hints(type(self))
        errors = []
        for f in dataclasses.fields(self):
            if not f.metadata:          # nested containers
                continue
            try:
                value = _coerce(getattr(self, f.name), hints[f.name])
            except ValueError as e:
                errors.append((f.name, str(e)))
                continue
            object.__setattr__(self, f.name, value)
            gt, ge = f.metadata["gt"], f.metadata["ge"]
            if value is not None and gt is not None and not value > gt:
                errors.append((f.name, f"must be greater than {gt}"))
            if value is not None and ge is not None and not value >= ge:
                errors.append((f.name, f"must be greater than or equal to {ge}"))
        if not errors:
            errors = self._checks()
        if errors:
            raise ConfigError(errors)


@dataclass
class _SolverKnobs(_Model):
    """Solver knobs shared by the 1D and 2D configs."""

    dtype: str = _field("float64", "Solver dtype: float64 (reference parity) or float32 (accelerator throughput)")
    newton_tol: float = _field(1e-6, "Newton residual L2 tolerance (ref: Forward_solver.py:143)", gt=0)
    newton_rtol: float = _field(1e-5, "Newton tolerance relative to the step's initial residual; active in float32 where the absolute tol can sit below the noise floor", ge=0)
    newton_max_iter: int = _field(50, "Max Newton iterations per step", gt=0)
    krylov_tol: float = _field(1e-9, "Relative tolerance of the inner Krylov solve (2D)", gt=0)
    krylov_max_iter: int = _field(200, "Max inner Krylov iterations (2D)", gt=0)
    krylov_fixed_iters: int = _field(4, "Fixed Krylov trip count of the float32 forward solve (no convergence barrier; the Newton while_loop's residual tolerance absorbs the slack). On the vmapped path 3 trips stall the lockstep Newton loop and 2 burn extra Newton solves", gt=0)
    adjoint_krylov_fixed_iters: Optional[int] = _field(5, "Fixed Krylov trip count for the ADJOINT step solves on the float32 path. None inherits krylov_fixed_iters. Kept separate because the adjoint operator is condition-1e6 and has NO outer Newton loop to absorb an under-converged solve; the warm-started split-preconditioned solve reaches the float32 noise floor by 4 trips, and 5 keeps one trip of margin", gt=0)
    linsolve_1d: str = _field("auto", "1D Newton/adjoint linear solver: 'dense' (exact LU, reference parity), 'spectral' (matrix-free cosine-preconditioned BiCGStab), or 'auto' (dense for f64 N<=256, spectral otherwise)")
    forward_matmul_precision: Optional[str] = _field(None, "Matmul precision override for the FORWARD solver only ('default'|'high'|'highest'; None inherits the package-global 'highest'). On the GPU 'high' and 'default' allow TF32 products; the condition-1e6 adjoint always keeps full precision")

    def _checks(self):
        errors = []
        if self.dtype not in ("float32", "float64"):
            errors.append(("dtype", "dtype must be 'float32' or 'float64'"))
        if self.linsolve_1d not in ("auto", "dense", "spectral"):
            errors.append(("linsolve_1d", "linsolve_1d must be 'auto', "
                           "'dense', or 'spectral'"))
        if self.c2 <= self.c1:
            errors.append(("c2", f"c2 ({self.c2}) must be greater than c1 "
                           f"({self.c1})"))
        return errors


@dataclass
class ForwardSolverConfig1D(_SolverKnobs):
    """Parameters of the 1D forward simulation (ref: 1D config.py:91-109)."""

    N: int = _field(128, "Number of spatial intervals", gt=10)
    Lx: float = _field(1.0, "Domain length", gt=0)
    T: float = _field(1.0, "Total simulation time", gt=0)
    dt_initial: float = _field(1e-2, "Initial time step size", gt=0)
    tau: float = _field(0.05, "Viscosity parameter for phi-equation")
    gamma: float = _field(10.0, "Relaxation parameter", gt=0)
    c1: float = _field(0.75, "Flory-Huggins convex coefficient")
    c2: float = _field(1.0, "Concave (quadratic) coefficient")
    kappa: float = _field(0.03**2, "Gradient energy coefficient", ge=0)
    newton_max_iter: int = _field(50, "Max Newton iterations (ref 1D: 50)", gt=0)


@dataclass
class ForwardSolverConfig2D(_SolverKnobs):
    """Parameters of the 2D forward simulation (ref: 2D config.py:83-120)."""

    Nx: int = _field(128, "Number of spatial intervals in x", gt=10)
    Ny: int = _field(128, "Number of spatial intervals in y", gt=10)
    Lx: float = _field(1.0, "Domain length in x", gt=0)
    Ly: float = _field(1.0, "Domain length in y", gt=0)
    T: float = _field(1.0, "Total simulation time", gt=0)
    dt_initial: float = _field(1e-2, "Initial time step size", gt=0)
    tau: float = _field(0.05, "Viscosity parameter for phi-equation")
    gamma: float = _field(10.0, "Relaxation parameter", gt=0)
    c1: float = _field(0.75, "Flory-Huggins convex coefficient")
    c2: float = _field(1.0, "Concave (quadratic) coefficient")
    kappa: float = _field(0.01**2, "Gradient energy coefficient", ge=0)
    newton_max_iter: int = _field(500, "Max Newton iterations (ref 2D: 500)", gt=0)
    newton_rtol: float = _field(5e-8, "Newton tolerance relative to the step's initial residual (float32 only). 5e-8 keeps the 64x64 float32 sweep within 4e-6 of the float64 path's cost at the float64 path's Newton-solve count; 1e-5 halves the solves but sits 7e-4 away (CPU float32, 2 PGD iterations)", ge=0)


# The reference names both dim variants `ForwardSolverConfig`; keep an alias so
# 1D-centric call sites read like the reference.
ForwardSolverConfig = ForwardSolverConfig1D


@dataclass
class OptimizationConfig(_Model):
    """PGD loop parameters (ref: 1D config.py:113-129, 2D config.py:123-150).

    Defaults differ by dimension in the reference; use the classmethods
    `defaults_1d()` / `defaults_2d()` to pick the matching set.
    """

    b1: float = _field(0.3, "Weight for space-time tracking cost", ge=0)
    b2: float = _field(13.0, "Weight for terminal cost", ge=0)
    b3: float = _field(0.0019, "Weight for control energy cost", ge=0)
    kappa_sparsity: float = _field(9e-5, "Sparsity weight for L1 term", ge=0)
    alpha_max: float = _field(100.0, "Initial step size for line search", gt=0)
    max_iter: int = _field(1000, "Max number of gradient descent iterations", gt=10)
    u_min: float = _field(-1.0, "Lower bound for the control")
    u_max: float = _field(1.0, "Upper bound for the control")

    def _checks(self):
        if self.u_max <= self.u_min:
            return [("u_max", "u_max must be strictly greater than u_min.")]
        return []

    @classmethod
    def defaults_1d(cls, **over) -> "OptimizationConfig":
        return cls(**over)

    @classmethod
    def defaults_2d(cls, **over) -> "OptimizationConfig":
        base = dict(b1=5.0, b2=10.0, b3=1e-4, kappa_sparsity=1e-4,
                    alpha_max=50.0, max_iter=500)
        base.update(over)
        return cls(**base)


@dataclass
class BatchConfig(_Model):
    """Scenario-batch + sharding description (no reference analog)."""

    batch: int = _field(1, "Number of control scenarios", ge=1)
    mesh_axis: str = _field("scenarios", "Mesh axis name the batch is sharded over")
    data_shards: int = _field(1, "Number of mesh shards along the batch axis", ge=1)


@dataclass
class SimulationParameters(_Model):
    """Container persisted between sessions (ref: 1D config.py:135-139)."""

    forward_solver: ForwardSolverConfig1D = field(default_factory=ForwardSolverConfig1D)
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)
    last_run_iterations: int = _field(0, "Number of iterations from the last run.")

    @classmethod
    def from_dict(cls, data: Dict[str, Any]):
        hints = typing.get_type_hints(cls)
        kw = dict(data)
        for name in ("forward_solver", "optimization"):
            if name in kw:
                kw[name] = hints[name](**kw[name])
        return cls(**kw)


@dataclass
class SimulationParameters2D(SimulationParameters):
    """2D variant of the persisted container (ref: 2D config.py:153-157)."""

    forward_solver: ForwardSolverConfig2D = field(default_factory=ForwardSolverConfig2D)
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig.defaults_2d)


def save_params(fwd_config, opt_config: OptimizationConfig,
                iteration_count: int, filepath: str = "last_run_config.json") -> None:
    """Persist configs + final iteration count (ref: 1D config.py:142-159)."""
    container = (SimulationParameters2D if isinstance(fwd_config, ForwardSolverConfig2D)
                 else SimulationParameters)
    params = container(forward_solver=fwd_config, optimization=opt_config,
                       last_run_iterations=iteration_count)
    try:
        with open(filepath, "w") as f:
            f.write(json.dumps(dataclasses.asdict(params), indent=4))
        print(f"Configuration saved to '{filepath}'.")
    except IOError as e:
        print(f"[Warning] Could not save configuration file: {e}")


def load_params(filepath: str = "last_run_config.json", two_d: bool = False):
    """Load persisted params or defaults (ref: 1D config.py:162-171)."""
    container = SimulationParameters2D if two_d else SimulationParameters
    try:
        with open(filepath, "r") as f:
            data = json.load(f)
        params = container.from_dict(data)
        print(f"Loaded previous configuration from '{filepath}'.")
        return params
    except (FileNotFoundError, ValueError, TypeError, json.JSONDecodeError):
        print("No valid previous configuration found. Using default parameters.")
        return container()


def get_yes_no_input(prompt: str) -> bool:
    """Simple y/n confirmation (ref: 1D config.py:26-34)."""
    while True:
        response = input(f"{prompt} (y/n): ").lower().strip()
        if response in ("y", "yes"):
            return True
        if response in ("n", "no"):
            return False
        print("Invalid input. Please enter 'y' or 'n'.")


def get_user_input_for_config(config_model: Type[_Model], title: str,
                              previous_instance: Optional[_Model] = None) -> _Model:
    """Interactive per-field prompting with validation re-prompts.

    Behavior mirrors the reference (1D config.py:180-265): show previous-run
    values as a reference table, prompt each field with the class default in
    brackets, validate, re-prompt only the invalid fields.
    """
    print("\n" + "=" * 60)
    print(f"--- {title} ---")
    if previous_instance is not None:
        print("For your reference, here are the parameters from the last run:")
        print("." * 50)
        for name, value in dataclasses.asdict(previous_instance).items():
            print(f"  {name:<15}: {value}")
        print("." * 50)
    print("Press Enter to accept the original default value shown in [brackets].")
    print("=" * 60)

    user_params: Dict[str, Any] = {}
    fields = {f.name: f for f in dataclasses.fields(config_model)}
    for name, f in fields.items():
        desc = f.metadata.get("description", "")
        raw = input(f"-> Enter '{name}' ({desc}) [default: {f.default}]: ").strip()
        user_params[name] = f.default if raw == "" else raw

    while True:
        try:
            validated = config_model(**user_params)
            print("\nConfiguration accepted and validated.")
            return validated
        except ConfigError as e:
            print("\nPARAMETER ERROR: Please correct the following value(s):")
            for name, msg in e.errors:
                print(f"  - {name}: {msg}")
            for name in dict(e.errors):
                f = fields[name]
                raw = input(f"-> (Correction) Enter '{name}' "
                            f"({f.metadata.get('description', '')}) "
                            f"[default: {f.default}]: ").strip()
                user_params[name] = f.default if raw == "" else raw
