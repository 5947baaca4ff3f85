"""The standard-library config models: bounds, cross-field rules, string
coercion, JSON round-trips and the interactive prompter (reference
config.py:91-265 semantics)."""
import dataclasses
import json

import pytest

from vch_tpu.config import (
    BatchConfig,
    ConfigError,
    ForwardSolverConfig1D,
    ForwardSolverConfig2D,
    OptimizationConfig,
    SimulationParameters,
    SimulationParameters2D,
    get_user_input_for_config,
    load_params,
    save_params,
)

_MODELS = (ForwardSolverConfig1D, ForwardSolverConfig2D, OptimizationConfig,
           BatchConfig)
# every bounded field of every model: (model, field, kind, bound)
_BOUNDS = [(cls, f.name, kind, f.metadata[kind])
           for cls in _MODELS for f in dataclasses.fields(cls)
           for kind in ("gt", "ge")
           if f.metadata and f.metadata.get(kind) is not None]


def test_bounds_table_covers_the_reference_validators():
    names = {(cls.__name__, name) for cls, name, _, _ in _BOUNDS}
    assert ("ForwardSolverConfig1D", "N") in names        # gt=10
    assert ("ForwardSolverConfig2D", "kappa") in names    # ge=0
    assert ("OptimizationConfig", "max_iter") in names    # gt=10
    assert len(_BOUNDS) == 36


@pytest.mark.parametrize("cls,name,kind,bound", _BOUNDS,
                         ids=[f"{c.__name__}.{n}" for c, n, _, _ in _BOUNDS])
def test_field_bound(cls, name, kind, bound):
    """A value past the bound is rejected naming the field; the bound itself
    is rejected for gt and accepted for ge."""
    is_int = isinstance(getattr(cls(), name), int)
    step = 1 if is_int else 1e-3
    with pytest.raises(ConfigError) as e:
        cls(**{name: bound - step})
    assert [n for n, _ in e.value.errors] == [name]
    if kind == "gt":
        with pytest.raises(ConfigError):
            cls(**{name: bound})
    else:
        assert getattr(cls(**{name: bound}), name) == bound
    assert getattr(cls(**{name: bound + step}), name) == bound + step


@pytest.mark.parametrize("make,field", [
    (lambda: ForwardSolverConfig1D(c1=1.0, c2=1.0), "c2"),
    (lambda: ForwardSolverConfig2D(c1=2.0, c2=1.0), "c2"),
    (lambda: OptimizationConfig(u_min=1.0, u_max=1.0), "u_max"),
    (lambda: ForwardSolverConfig2D(dtype="float16"), "dtype"),
    (lambda: ForwardSolverConfig1D(linsolve_1d="lu"), "linsolve_1d"),
], ids=["c2>c1_1d", "c2>c1_2d", "u_max>u_min", "dtype", "linsolve_1d"])
def test_cross_field_rule(make, field):
    with pytest.raises(ConfigError) as e:
        make()
    assert [n for n, _ in e.value.errors] == [field]


def test_replace_revalidates():
    cfg = ForwardSolverConfig2D(Nx=32, Ny=32)
    assert dataclasses.replace(cfg, dtype="float32").dtype == "float32"
    with pytest.raises(ConfigError):
        dataclasses.replace(cfg, Nx=4)


@pytest.mark.parametrize("raw,name,expected", [
    ("64", "N", 64), ("0.5", "T", 0.5), ("1e-3", "dt_initial", 1e-3),
    ("float32", "dtype", "float32"), ("None", "adjoint_krylov_fixed_iters",
                                      None), ("7", "adjoint_krylov_fixed_iters", 7),
    (256.0, "N", 256),
])
def test_string_and_number_coercion(raw, name, expected):
    value = getattr(ForwardSolverConfig1D(**{name: raw}), name)
    assert value == expected and type(value) is type(expected)


@pytest.mark.parametrize("raw,name", [("abc", "N"), (12.5, "N"),
                                      (True, "T"), ("x", "gamma")])
def test_coercion_rejects(raw, name):
    with pytest.raises(ConfigError) as e:
        ForwardSolverConfig1D(**{name: raw})
    assert e.value.errors[0][0] == name


@pytest.mark.parametrize("fwd,opt,two_d,container", [
    (ForwardSolverConfig1D(N=64, T=0.5, dtype="float32", newton_rtol=0.0),
     OptimizationConfig(b3=0.01, u_min=-2.0), False, SimulationParameters),
    (ForwardSolverConfig2D(Nx=32, Ny=16, adjoint_krylov_fixed_iters=None,
                           forward_matmul_precision="high"),
     OptimizationConfig.defaults_2d(kappa_sparsity=3e-4), True,
     SimulationParameters2D),
], ids=["1d", "2d"])
def test_json_round_trip_is_exact(tmp_path, fwd, opt, two_d, container):
    path = str(tmp_path / "cfg.json")
    save_params(fwd, opt, 17, filepath=path)
    with open(path) as f:
        assert json.load(f)["last_run_iterations"] == 17
    loaded = load_params(path, two_d=two_d)
    assert isinstance(loaded, container)
    assert loaded.forward_solver == fwd
    assert loaded.optimization == opt
    assert loaded.last_run_iterations == 17


def test_load_params_rejects_invalid_saved_values(tmp_path):
    """A saved file that fails validation falls back to the defaults."""
    path = tmp_path / "bad.json"
    data = dataclasses.asdict(SimulationParameters())
    data["forward_solver"]["N"] = 3
    path.write_text(json.dumps(data))
    assert load_params(str(path)) == SimulationParameters()


def test_prompter_coerces_input_and_reprompts_only_invalid(monkeypatch,
                                                           capsys):
    """Each field is prompted once; Enter keeps the default; strings are
    coerced by field type; after a validation failure only the invalid
    fields are asked again."""
    names = [f.name for f in dataclasses.fields(OptimizationConfig)]
    first = {"b3": "0.004", "max_iter": "5", "u_min": "2", "u_max": "1"}
    answers = [first.get(n, "") for n in names] + ["40", "3"]
    asked = []

    def fake_input(prompt):
        asked.append(prompt)
        return answers[len(asked) - 1]

    monkeypatch.setattr("builtins.input", fake_input)
    prev = OptimizationConfig(b1=0.7)
    cfg = get_user_input_for_config(OptimizationConfig, "Opt", prev)
    out = capsys.readouterr().out
    assert "b1             : 0.7" in out           # previous run shown
    assert "max_iter" in out and "u_max" in out     # errors listed
    assert len(asked) == len(names) + 2
    assert "(Correction) Enter 'max_iter'" in asked[-2]
    assert "(Correction) Enter 'u_max'" in asked[-1]
    assert cfg == OptimizationConfig(b3=0.004, max_iter=40, u_min=2.0,
                                     u_max=3.0)
    assert isinstance(cfg.max_iter, int) and isinstance(cfg.b3, float)
