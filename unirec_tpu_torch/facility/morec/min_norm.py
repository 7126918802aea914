"""Frank-Wolfe min-norm-point solver over task gradients (MGDA).

The port's copy of unirec_tpu/facility/morec/min_norm.py (numpy on the
host; the port imports nothing of the JAX package). The reference finds
Sener & Koltun's MGDA min-norm element over full flattened gradients
(_min_norm_solver.py:11-213); here the k per-objective gradients are reduced
to their k x k Gram matrix on the device (facility/morec/integration.py) and
the Frank-Wolfe iteration runs on that k x k matrix on the host, k being the
number of objectives (2-4).
"""
from __future__ import annotations

import numpy as np


def _pair_gamma(a2: float, ab: float, b2: float) -> float:
    """argmin_g ||(1-g)a + g b||^2 in closed form, clipped to [0, 1]."""
    denom = a2 - 2.0 * ab + b2
    if denom <= 1e-12:
        return 0.0
    return float(np.clip((a2 - ab) / denom, 0.0, 1.0))


def min_norm_point_gram(M: np.ndarray, max_iter: int = 250,
                        stop_crit: float = 1e-5) -> np.ndarray:
    """Weights w (simplex) minimizing wᵀ M w, for Gram matrix M = G Gᵀ.

    Matches the fixed point of the reference's find_min_norm_element
    (projected Frank-Wolfe with analytic 2-point line search).
    """
    M = np.asarray(M, dtype=np.float64)
    n = M.shape[0]
    if n == 1:
        return np.ones(1)

    # init from the best pair (i, j) (reference _min_norm_2d)
    best = (np.inf, 0, 1, 0.5)
    for i in range(n):
        for j in range(i + 1, n):
            g = _pair_gamma(M[i, i], M[i, j], M[j, j])
            cost = ((1 - g) ** 2 * M[i, i] + 2 * (1 - g) * g * M[i, j]
                    + g ** 2 * M[j, j])
            if cost < best[0]:
                best = (cost, i, j, g)
    sol = np.zeros(n)
    sol[best[1]] = 1 - best[3]
    sol[best[2]] = best[3]

    for _ in range(max_iter):
        grad = M @ sol
        t = int(np.argmin(grad))
        a2 = float(sol @ M @ sol)
        ab = float(grad[t])
        b2 = float(M[t, t])
        g = _pair_gamma(a2, ab, b2)
        new_sol = (1 - g) * sol
        new_sol[t] += g
        if np.abs(new_sol - sol).sum() < stop_crit:
            sol = new_sol
            break
        sol = new_sol
    return sol
