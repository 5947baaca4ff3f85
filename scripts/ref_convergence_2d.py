"""2D convergence north star: run the REFERENCE 2D PGD to convergence and
ours (f64 CPU) on the same config; compare converged costs (BASELINE.md
acceptance: <= 1e-4 relative). The 1D analog closed at 6e-8 after 144
iterations; this closes the 2D side.

The reference loop below uses the reference's own functions (imported from
/root/reference, executed not copied) under the GD2_configured.py __main__
schedule (optimistic step at alpha_prev, backtracking alpha_init=0.8*alpha,
beta=0.8, <=10 trials, keep-last-on-failure, alpha growth 1.2, plateau
boost 1.5 after 5 flat iters at tol 1e-5, convergence rel-du < 1e-5 after
iter 20 — GD2_configured.py:231-441), which is also exactly the schedule of
our ProximalGradientLoop + PGDSettings.defaults_2d().

    MPLBACKEND=Agg python scripts/ref_convergence_2d.py <N> <T> <max_iters>

Prints the comparison as JSON.
"""
import json
import os
import sys
import time

import numpy as np

REF = "/root/reference/src/2D/Vch_control_2D"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REF)
sys.path.insert(0, REPO)

import matplotlib

matplotlib.use("Agg")

from Forward2_solver import run_main_simulation  # noqa: E402
from backward2_solver import run_backward  # noqa: E402
from cost2_and_function import calculate_cost, calculate_gradient, proximal_step  # noqa: E402
from config import ForwardSolverConfig, OptimizationConfig  # noqa: E402
from GD2_configured import build_targets  # noqa: E402


def run_reference(N, T, max_iters, verbose=True):
    fwd = ForwardSolverConfig(Nx=N, Ny=N, T=T)
    opt = OptimizationConfig()
    phi_k, (x, y), t_hist = run_main_simulation(fwd, store_history=True,
                                                verbose=False)
    phi_T, phi_Q = build_targets(x, y, t_hist, phi_k[0].copy(),
                                 float(fwd.Lx), float(fwd.Ly), float(fwd.T),
                                 interactive=False, choice_t=1, choice_q=1)
    u_k = np.zeros_like(phi_k)
    cost_k = calculate_cost(phi_k, u_k, phi_Q, phi_T, x, y, t_hist, opt)
    cost_traj = [cost_k]
    alpha_prev = opt.alpha_max
    plateau = 0
    conv_iter = None
    for k in range(max_iters):
        _, _, r_k = run_backward(phi_k, x, y, t_hist, fwd, opt.b1, opt.b2,
                                 phi_Q, phi_T)
        grad = calculate_gradient(r_k, u_k, opt)
        # optimistic trial at alpha_prev, then the 2D backtracking ladder
        # alpha_prev*0.8*0.8^(j-1) (GD2_configured.py:324, <=10 trials),
        # keep-last-on-failure (GD_1D.py:110-113 semantics)
        accepted = False
        alpha_try = alpha_prev
        for j in range(1 + 10):
            u_t = proximal_step(u_k, grad, alpha_try, opt)
            phi_t, _, _ = run_main_simulation(fwd, store_history=True,
                                              control_input=u_t,
                                              verbose=False)
            c_t = calculate_cost(phi_t, u_t, phi_Q, phi_T, x, y, t_hist, opt)
            if c_t < cost_k:
                accepted = True
                alpha_k = alpha_try
                break
            alpha_k = alpha_try * 0.8       # shrunk once more on failure
            alpha_try = (alpha_prev * 0.8 if j == 0 else alpha_try * 0.8)
        u_prev = u_k
        u_k, phi_k, cost_k = u_t, phi_t, c_t
        cost_traj.append(cost_k)
        # plateau + alpha growth (GD2_configured.py:365-373)
        if abs(cost_traj[-1] - cost_traj[-2]) < 1e-5:
            plateau += 1
        else:
            plateau = 0
        if plateau >= 5:
            alpha_prev = min(opt.alpha_max, alpha_k * 1.5)
            plateau = 0
        else:
            alpha_prev = min(opt.alpha_max, alpha_k * 1.2)
        change = (np.linalg.norm(u_k - u_prev)
                  / (np.linalg.norm(u_prev) + 1e-9))
        if verbose and (k % 5 == 0 or k < 3):
            print(f"[ref2d] iter {k+1}: cost {cost_k:.8f} "
                  f"alpha {alpha_k:.3f} rel-du {change:.2e}", flush=True)
        if change < 1e-5 and k > 20:
            conv_iter = k + 1
            print(f"[ref2d] converged at iteration {conv_iter}", flush=True)
            break
    return np.array(cost_traj), conv_iter


def run_ours(N, T, max_iters):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from vch_tpu.config import ForwardSolverConfig2D
    from vch_tpu.control.problems import ControlProblem2D
    prob = ControlProblem2D(ForwardSolverConfig2D(Nx=N, Ny=N, T=T))
    res = prob.optimize(max_iter=max_iters, verbose=False)
    return np.array(res.cost_history), (res.iterations if res.converged
                                        else None)


def main():
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    T = float(sys.argv[2]) if len(sys.argv) > 2 else 0.25
    max_iters = int(sys.argv[3]) if len(sys.argv) > 3 else 200

    t0 = time.perf_counter()
    ours, ours_conv = run_ours(N, T, max_iters)
    t_ours = time.perf_counter() - t0
    print(f"[ours] final cost {ours[-1]:.10f} after {len(ours)-1} iters "
          f"(converged at {ours_conv}) in {t_ours:.0f}s", flush=True)

    t0 = time.perf_counter()
    ref, ref_conv = run_reference(N, T, max_iters)
    t_ref = time.perf_counter() - t0
    print(f"[ref ] final cost {ref[-1]:.10f} after {len(ref)-1} iters "
          f"(converged at {ref_conv}) in {t_ref:.0f}s", flush=True)

    rel = abs(ours[-1] - ref[-1]) / abs(ref[-1])
    n = min(len(ours), len(ref))
    traj_rel = np.abs(ours[:n] - ref[:n]) / np.abs(ref[:n])
    entry = {
        "grid": f"{N}x{N}", "T": T, "dtype_ours": "float64 (CPU)",
        "ref_final_cost": float(ref[-1]), "ours_final_cost": float(ours[-1]),
        "final_cost_rel_diff": float(rel),
        "ref_converged_at": ref_conv, "ours_converged_at": ours_conv,
        "iters_ref": len(ref) - 1, "iters_ours": len(ours) - 1,
        "traj_rel_diff_max": float(traj_rel.max()),
        "ref_elapsed_s": round(t_ref, 1), "ours_elapsed_s": round(t_ours, 1),
        "acceptance": "<= 1e-4 relative at the converged iterate "
                      "(BASELINE.md north star)",
        "pass": bool(rel <= 1e-4),
    }
    print(json.dumps(entry, indent=1))


if __name__ == "__main__":
    main()
