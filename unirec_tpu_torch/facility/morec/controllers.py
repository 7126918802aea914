"""Multi-objective weight controllers (MoRec).

The port's copy of unirec_tpu/facility/morec/controllers.py: numpy ports of
the reference controllers (facility/morec/morec_objective_controller.py).
The per-step math is k-dimensional (k = #objectives <= 4), so it runs on
the host; only the gradients' Gram matrix (for the Pareto-type solvers) is
computed on the device. ``build_controller`` takes the JAX package's names
(Static, Pareto, PIX, PID) and, beyond them, MGDA (the Pareto solver),
ParetoMTL and EPO over all n_obj + 1 losses, which the JAX package builds
only by hand (ROADMAP.md, deliberate differences).

EPOSolver's two LPs use scipy.optimize.linprog instead of cvxpy+GLPK (cvxpy
is not in this environment); on any solver failure it falls back to the
preference vector, matching the reference's exception path
(morec_objective_controller.py:205-207).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from unirec_tpu_torch.facility.morec.min_norm import min_norm_point_gram


class StaticWeightSolver:
    """Fixed (or uniform) objective weights (morec_objective_controller.py:9-18)."""

    needs_grads = False

    def __init__(self, num_tasks: int, weight: Optional[Sequence[float]] = None):
        self.num_tasks = num_tasks
        self.weight = None if weight is None else np.asarray(weight, np.float64)

    def solve(self, gram: Optional[np.ndarray], values: np.ndarray) -> np.ndarray:
        if self.weight is None:
            return np.full(self.num_tasks, 1.0 / self.num_tasks)
        return self.weight.copy()


class MGDASolver(StaticWeightSolver):
    """Min-norm-point weights over per-objective gradients
    (morec_objective_controller.py:22-25)."""

    needs_grads = True

    def solve(self, gram: Optional[np.ndarray], values: np.ndarray) -> np.ndarray:
        return min_norm_point_gram(gram)


class ParetoMTLSolver(StaticWeightSolver):
    """Preference-vector-guided Pareto MTL (morec_objective_controller.py:29-130).

    Works on the Gram matrix: the reference's `w[idx] @ grads` rows are
    linear combinations of gradients, so their pairwise inner products are
    W M Wᵀ blocks of the base Gram matrix.
    """

    needs_grads = True

    def __init__(self, num_tasks: int, pref_id: int = 0, init_steps: int = 10):
        super().__init__(num_tasks)
        self.pref_vectors = self._fixed_pref_vectors(num_tasks)
        self.pref_id = pref_id
        self._step = 0
        self._init_flag = False
        self.init_steps = init_steps

    @staticmethod
    def _fixed_pref_vectors(n_tasks: int) -> np.ndarray:
        if n_tasks == 3:
            return np.array([
                [0.8, 0.1, 0.1], [0.6, 0.2, 0.2], [0.4, 0.3, 0.3],
                [0.3, 0.4, 0.3], [0.3, 0.3, 0.4], [0.2, 0.6, 0.2],
                [0.2, 0.2, 0.6], [0.1, 0.8, 0.1], [0.1, 0.1, 0.8]])
        if n_tasks == 2:
            return np.array([[0.9, 0.1], [0.7, 0.3], [0.5, 0.5],
                             [0.1, 0.9], [0.3, 0.7]])
        raise NotImplementedError(f"no preset preference vectors for {n_tasks} tasks")

    def solve(self, gram: np.ndarray, values: np.ndarray) -> np.ndarray:
        if (not self._init_flag) and self._step < self.init_steps:
            return self._init_step(gram, values)
        cur = self.pref_vectors[self.pref_id]
        w = self.pref_vectors - cur
        gx = w @ (values / (np.linalg.norm(values) + 1e-12))
        idx = gx > 0
        if idx.sum() <= 0:
            return min_norm_point_gram(gram)
        # extended vector set: base grads + active-constraint combinations
        W = np.concatenate([np.eye(self.num_tasks), w[idx]], axis=0)
        ext_gram = W @ gram @ W.T
        sol = min_norm_point_gram(ext_gram)
        weight = sol[self.num_tasks:] @ w[idx] + sol[: self.num_tasks]
        return weight / (np.abs(weight).sum() + 1e-8)

    def _init_step(self, gram: np.ndarray, values: np.ndarray) -> np.ndarray:
        cur = self.pref_vectors[self.pref_id]
        w = self.pref_vectors - cur
        gx = w @ (values / (np.linalg.norm(values) + 1e-12))
        idx = gx > 0
        self._init_flag = False
        if idx.sum() <= 0:
            self._init_flag = True
            return np.zeros(self.num_tasks)
        if idx.sum() == 1:
            sol = np.ones(1)
        else:
            ext_gram = w[idx] @ gram @ w[idx].T
            sol = min_norm_point_gram(ext_gram)
        self._step += 1
        return sol @ w[idx]


def _mu(rl: np.ndarray, normed: bool = False) -> float:
    if (rl < 0).any():
        raise ValueError(f"rl<0: {rl}")
    l_hat = rl if normed else rl / rl.sum()
    eps = np.finfo(rl.dtype).eps
    l_hat = l_hat[l_hat > eps]
    return float(np.sum(l_hat * np.log(l_hat * len(rl))))


def _adjustments(l: np.ndarray, r):
    rl = r * l
    l_hat = rl / rl.sum()
    mu_rl = _mu(l_hat, normed=True)
    a = r * (np.log(l_hat * len(l)) - mu_rl)
    return rl, mu_rl, a


class EPOSolver(StaticWeightSolver):
    """Exact Pareto Optimal search (EPO) via two small LPs
    (morec_objective_controller.py:133-207), solved with scipy linprog."""

    needs_grads = True

    def __init__(self, num_tasks: int, pref: np.ndarray, eps: float = 1e-4):
        super().__init__(num_tasks)
        pref = np.asarray(pref, np.float64)
        self.pref = pref / pref.sum()
        self.eps = eps
        self.last_move = None

    def solve(self, gram: np.ndarray, values: np.ndarray) -> np.ndarray:
        from scipy.optimize import linprog
        try:
            m = self.num_tasks
            l = np.asarray(values, np.float64)
            G = np.asarray(gram, np.float64)
            rl, mu_rl, a = _adjustments(l, self.pref)
            C = G @ G.T
            Ca = C @ a
            if mu_rl > self.eps:  # balance LP: max alpha·Ca
                J = Ca > 0
                rhs = Ca.copy()
                if J.sum() > 0:
                    J_star = rl == rl.max()
                    rhs[J] = -np.inf
                    rhs[J_star] = 0.0
                else:
                    rhs = np.zeros_like(Ca)
                res = linprog(-Ca, A_ub=-C, b_ub=-rhs,
                              A_eq=np.ones((1, m)), b_eq=[1.0],
                              bounds=[(0, None)] * m, method="highs")
                self.last_move = "bal"
            else:  # dominance LP: max sum(alpha @ C) s.t. alpha·Ca >= 0, C alpha >= 0
                A_ub = -np.concatenate([C, Ca[None, :]], axis=0)
                b_ub = np.zeros(m + 1)
                res = linprog(-C.sum(0), A_ub=A_ub, b_ub=b_ub,
                              A_eq=np.ones((1, m)), b_eq=[1.0],
                              bounds=[(0, None)] * m, method="highs")
                self.last_move = "dom"
            if not res.success:
                raise RuntimeError(res.message)
            return res.x * m
        except Exception:
            return (self.pref / self.pref.sum()) * self.num_tasks


class PIController:
    """PI feedback controller on the accuracy loss → β weight
    (morec_objective_controller.py:220-296)."""

    needs_grads = False

    def __init__(self, expect_loss: float, beta_min: float = 0.2,
                 beta_max: float = 1.0, K_p: float = 0.01, K_i: float = 0.0001,
                 max_iter: int = int(1e6)):
        self.t = 0
        self.K_p = K_p
        self.K_i = K_i
        self.beta_min = beta_min
        self.beta_max = beta_max
        self.beta = 0.0
        self.expect_loss = expect_loss
        self._integral_error = 0.0
        self._max_iter = max_iter

    def control(self, loss: float) -> float:
        if self.t < self._max_iter:
            e_t = self.expect_loss - float(loss)
            P_t = self.K_p / (1.0 + math.exp(e_t))
            I_t = self._integral_error
            if self.beta_min <= self.beta <= self.beta_max:
                I_t -= self.K_i * e_t
            beta = float(np.clip(P_t + I_t + self.beta_min,
                                 self.beta_min, self.beta_max))
            self.beta = beta
            self._integral_error = I_t
            self.t += 1
        return min(self.beta, self.beta_max)


class PIXController(PIController):
    """PI on accuracy + a Pareto solver over the other objectives
    (morec_objective_controller.py:309-320)."""

    def __init__(self, expect_loss: float, beta_min: float = 0.2,
                 beta_max: float = 1.0, K_p: float = 0.01, K_i: float = 0.0001,
                 max_iter: int = int(1e6), pareto_solver=None):
        super().__init__(expect_loss, beta_min, beta_max, K_p, K_i, max_iter)
        self.pareto_solver = pareto_solver

    @property
    def needs_grads(self):
        return getattr(self.pareto_solver, "needs_grads", False)

    def pareto_solve(self, gram, values) -> np.ndarray:
        return self.pareto_solver.solve(gram, values)


def build_controller(config, n_objectives: int):
    """Controller construction keyed on morec_objective_controller
    (reference main.py:347-364): 'Static' → fixed weights over all
    n_obj+1 losses; 'Pareto' (or 'MGDA') → MGDA over all; 'ParetoMTL' →
    ParetoMTL over all (the first preference vector); 'EPO' → EPO
    over all with ``morec_objective_weights`` (n_obj+1 entries, else
    uniform) as its preference; otherwise (PID/PIX) a
    PIXController whose inner solver is static weights ('PID', the
    reference default wiring) or MGDA ('PIX')."""
    import ast
    kind = config.get("morec_objective_controller", "PID")
    wstr = config.get("morec_objective_weights", "[0.3,0.3,0.4]")
    weights = ast.literal_eval(wstr) if isinstance(wstr, str) else list(wstr)
    if kind == "Static":
        if weights is not None and len(weights) != n_objectives + 1:
            raise ValueError(
                f"morec_objective_weights needs {n_objectives + 1} entries for "
                f"the Static controller (last one weights the accuracy block, "
                f"reference tests/test_model/test_morec.py:135), got {weights}")
        return StaticWeightSolver(n_objectives + 1, weights)
    if kind in ("Pareto", "MGDA"):
        return MGDASolver(n_objectives + 1)
    if kind == "ParetoMTL":
        return ParetoMTLSolver(n_objectives + 1)
    if kind == "EPO":
        pref = weights if weights is not None and len(weights) == n_objectives + 1 \
            else [1.0] * (n_objectives + 1)
        return EPOSolver(n_objectives + 1, np.asarray(pref, np.float64))
    if kind == "PIX":
        inner = MGDASolver(n_objectives)
    else:  # PID: static inner weights over the non-accuracy objectives
        if n_objectives == 1:
            weights = [1.0]
        elif weights is not None and len(weights) != n_objectives:
            # the default 3-entry weights only fit 3 objectives; fall back
            # to uniform rather than crash inside the jitted step
            weights = None
        inner = StaticWeightSolver(n_objectives, weights)
    return PIXController(float(config.get("morec_expect_loss", 0.2)),
                         float(config.get("morec_beta_min", 0.6)),
                         float(config.get("morec_beta_max", 1.3)),
                         float(config.get("morec_K_p", 0.01)),
                         float(config.get("morec_K_i", 0.001)),
                         pareto_solver=inner)
