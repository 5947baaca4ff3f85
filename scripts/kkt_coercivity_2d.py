"""KKT sparsity + second-order coercivity record for a CONVERGED 2D run.

The reference driver always finishes with the Theorem-4.7 sparsity check and
the critical-cone second-order probe (GD2_configured.py:384-441, 5 directions
at epsilon=1e-4 seed=42, second_order_conditions_2d.py:120-236). This runs
the converged 32x32, T=0.25 setup through BOTH pipelines — ours
(ControlProblem2D.verify_sparsity / second_order_check) and the reference's
own functions, imported from the reference tree (REF below) — and prints
the side-by-side match as JSON.

    MPLBACKEND=Agg python scripts/kkt_coercivity_2d.py [N] [T] [max_iters]
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


def run_ours(N, T, max_iters):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from vch_tpu.config import ForwardSolverConfig2D
    from vch_tpu.control.problems import ControlProblem2D

    prob = ControlProblem2D(ForwardSolverConfig2D(Nx=N, Ny=N, T=T))
    res = prob.optimize(max_iter=max_iters, verbose=False)
    sp = prob.verify_sparsity(res, verbose=True)
    d2 = prob.second_order_check(res, num_directions=5, epsilon=1e-4,
                                 seed=42)
    return res, sp, [float(v) for v in d2]


def run_reference(N, T, max_iters):
    """Reference PGD to convergence (GD2_configured.py __main__ schedule —
    same loop as scripts/ref_convergence_2d.py), then the reference's own
    final analysis (run_backward + second-order + sparsity)."""
    from Forward2_solver import run_main_simulation
    from backward2_solver import run_backward
    from cost2_and_function import (calculate_cost, calculate_gradient,
                                    proximal_step)
    from config import ForwardSolverConfig, OptimizationConfig
    from GD2_configured import build_targets
    from second_order_conditions_2d import (
        approximate_second_order_condition_2d, verify_sparsity_condition)

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
    for k in range(max_iters):
        _, _, r_k = run_backward(phi_k, x, y, t_hist, fwd, opt.b1, opt.b2,
                                 phi_Q, phi_T)
        grad = calculate_gradient(r_k, u_k, opt)
        alpha_try = alpha_prev
        for j in range(1 + 10):
            u_t = proximal_step(u_k, grad, alpha_try, opt)
            phi_t, _, _ = run_main_simulation(fwd, store_history=True,
                                              control_input=u_t,
                                              verbose=False)
            c_t = calculate_cost(phi_t, u_t, phi_Q, phi_T, x, y, t_hist, opt)
            if c_t < cost_k:
                alpha_k = alpha_try
                break
            alpha_k = alpha_try * 0.8
            alpha_try = (alpha_prev * 0.8 if j == 0 else alpha_try * 0.8)
        u_prev = u_k
        u_k, phi_k, cost_k = u_t, phi_t, c_t
        cost_traj.append(cost_k)
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
        if k % 5 == 0 or k < 3:
            print(f"[ref2d] iter {k+1}: cost {cost_k:.8f} "
                  f"rel-du {change:.2e}", flush=True)
        if change < 1e-5 and k > 20:
            print(f"[ref2d] converged at iteration {k+1}", flush=True)
            break

    # reference final analysis (GD2_configured.py:428-441)
    _, _, r_opt = run_backward(phi_k, x, y, t_hist, fwd, opt.b1, opt.b2,
                               phi_Q, phi_T)
    d2 = approximate_second_order_condition_2d(
        u_star=u_k, r_star=r_opt, phi_star=phi_k, x=x, y=y, t_hist=t_hist,
        b1=opt.b1, b2=opt.b2, b3=opt.b3, kappa=opt.kappa_sparsity,
        phi_Q_target=phi_Q, phi_T_target=phi_T, u_min=opt.u_min,
        u_max=opt.u_max, num_directions=5, epsilon=1e-4, seed=42,
        fwd_config=fwd)
    verify_sparsity_condition(u_k, r_opt, opt.kappa_sparsity)  # prints only
    # the reference's verifier returns None; recompute the identical
    # Theorem-4.7 statistics for the record (same tol=1e-6 formulas)
    is_u_zero = np.abs(u_k) < 1e-6
    is_r_small = np.abs(r_opt) <= opt.kappa_sparsity
    match = is_u_zero == is_r_small
    sp = {
        "sparsity_percentage": 100.0 * is_u_zero.sum() / u_k.size,
        "r_small_percentage": 100.0 * is_r_small.sum() / u_k.size,
        "match_percentage": 100.0 * match.sum() / u_k.size,
        "u_zero_count": int(is_u_zero.sum()),
        "total_points": int(u_k.size),
        "satisfied": bool(100.0 * match.sum() / u_k.size > 99.0),
    }
    return cost_traj, sp, [float(v) for v in d2]


def main():
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    T = float(sys.argv[2]) if len(sys.argv) > 2 else 0.25
    max_iters = int(sys.argv[3]) if len(sys.argv) > 3 else 200

    t0 = time.perf_counter()
    res, sp_ours, d2_ours = run_ours(N, T, max_iters)
    t_ours = time.perf_counter() - t0
    print(f"[ours] cost {res.cost_history[-1]:.8f}, "
          f"match {sp_ours['match_percentage']:.2f}%, d2 {d2_ours} "
          f"({t_ours:.0f}s)", flush=True)

    t0 = time.perf_counter()
    _, sp_ref, d2_ref = run_reference(N, T, max_iters)
    t_ref = time.perf_counter() - t0

    def _stats(sp):
        return {k: (float(v) if isinstance(v, (int, float, np.floating))
                    else bool(v) if isinstance(v, (bool, np.bool_)) else v)
                for k, v in sp.items()}

    entry = {
        "grid": f"{N}x{N}", "T": T, "setup": "convergence_2d_n32_T0.25",
        "ours": {"sparsity": _stats(sp_ours), "d2_values": d2_ours,
                 "coercive": bool(all(v > 0 for v in d2_ours)),
                 "elapsed_s": round(t_ours, 1)},
        "reference": {"sparsity": _stats(sp_ref), "d2_values": d2_ref,
                      "coercive": bool(all(v > 0 for v in d2_ref)),
                      "elapsed_s": round(t_ref, 1)},
        "protocol": "5 critical-cone directions, epsilon=1e-4, seed=42 "
                    "(GD2_configured.py:428-432); sparsity per Theorem 4.7 "
                    "(second_order_conditions_2d.py verify_sparsity_"
                    "condition)",
    }
    print(json.dumps(entry, indent=1))


if __name__ == "__main__":
    main()
