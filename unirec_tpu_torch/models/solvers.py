"""Closed-form and iterative "solver" CF models: EASE, AdmmSLIM, SLIM, SAR,
UserCF (counterpart of unirec_tpu/models/solvers.py).

The reference solves these on the CPU with numpy, scipy and sklearn
(unirec/model/cf/{ease,slim,admmslim,sar,usercf}.py). Here the dense work
runs on the model's device as torch ops: the Gram matrices as dense f32
products over row blocks of the user-item graph (peak [N, N] + [block, N];
the JAX package builds them with scipy on the host, and both are exact for
the integer counts of a binary graph), the inverse (``_regularized_inverse``),
ADMM's iterations and SLIM's coordinate descent. Only the edge
normalization of SAR and UserCF stays on the host (scipy, O(nnz)).

These models hold their solved matrices rather than parameters, and expose
what the evaluators call: ``user_emb(batch)``, ``all_item_emb()``,
``bias_terms()`` -> (None, None), ``predict(batch)`` and ``.device``. The
user rows are built on the device from the graph's CSR arrays, moved there
once, with one scatter a batch; they carry the CSR's values (a
``csr_matrix`` sums duplicate entries, data/datasets.py::get_graph).
``state_dict()`` returns the JAX package's types (numpy ``item_similarity``,
for UserCF a scipy CSR ``user_similarity``, and the scipy CSR
``user_item``), so each package reads the other's ``.solver.pkl``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from unirec_tpu_torch.constants import EdgeNormType
from unirec_tpu_torch.ops.linalg import full_f32, spd_inverse_columns
from unirec_tpu_torch.utils.registry import register_model

_GRAM_BLOCK_ELEMS = 1 << 28      # one dense row block of the graph: at most 1 GiB of f32
_GATHER_INDEX_ELEMS = 1 << 26    # SLIM's candidate gather: index tensors of at most 512 MiB


class _DeviceCSR:
    """A scipy CSR matrix's arrays on a device (values as f32), with dense
    row blocks and gathered rows built from them by one scatter each."""

    def __init__(self, m, device):
        m = m.tocsr()
        self.shape = m.shape
        self.indptr = np.asarray(m.indptr, np.int64)
        lens = np.diff(self.indptr)
        self.width = max(int(lens.max()) if len(lens) else 0, 1)
        self.device = torch.device(device)
        self._indptr = torch.as_tensor(self.indptr, device=device)
        self.rows = torch.as_tensor(np.repeat(np.arange(m.shape[0], dtype=np.int64), lens),
                                    device=device)
        self.cols = torch.as_tensor(np.asarray(m.indices, np.int64), device=device)
        self.vals = torch.as_tensor(np.asarray(m.data, np.float32), device=device)

    def dense(self, r0: int = 0, r1: int = -1) -> torch.Tensor:
        """Rows r0..r1 (all when r1 < 0) as a dense [r1 - r0, n_cols] tensor."""
        r1 = self.shape[0] if r1 < 0 else r1
        lo, hi = int(self.indptr[r0]), int(self.indptr[r1])
        out = torch.zeros(r1 - r0, self.shape[1], device=self.device)
        out.index_put_((self.rows[lo:hi] - r0, self.cols[lo:hi]), self.vals[lo:hi],
                       accumulate=True)
        return out

    def gather(self, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` (a device int tensor [B]) as a dense [B, n_cols]."""
        ids = ids.to(self.device, torch.int64).reshape(-1)
        out = torch.zeros(len(ids), self.shape[1], device=self.device)
        if self.cols.numel() == 0:
            return out
        start = self._indptr[ids]
        j = torch.arange(self.width, device=self.device)
        valid = j[None, :] < (self._indptr[ids + 1] - start)[:, None]
        pos = torch.where(valid, start[:, None] + j[None, :], 0)
        vals = torch.where(valid, self.vals[pos], 0.0)
        return out.scatter_add_(1, self.cols[pos], vals)


def _gram(m, device) -> torch.Tensor:
    """m^T m as a dense f32 [n_cols, n_cols] tensor on ``device``, summed
    over dense row blocks of m (peak [n_cols, n_cols] + [block, n_cols])."""
    X = _DeviceCSR(m, device)
    n_rows, n_cols = X.shape
    G = torch.zeros(n_cols, n_cols, device=X.device)
    block = max(1, _GRAM_BLOCK_ELEMS // max(n_cols, 1))
    with full_f32():
        for r0 in range(0, n_rows, block):
            Xb = X.dense(r0, min(r0 + block, n_rows))
            G.addmm_(Xb.T, Xb)
    return G


def _regularized_inverse(G: torch.Tensor, cfg, spd: bool = True) -> torch.Tensor:
    """Dense [N, N] inverse on G's device, in tiers by size and definiteness:

    - N <= ``solver_device_inverse_max`` (12,000): ``torch.linalg.inv``;
    - larger, when ``spd`` and ``torch.linalg.cholesky_ex`` finds G
      positive definite: ``ops/linalg.py::spd_inverse_columns`` (blocked
      Cholesky, blocked triangular inverse, column slabs of X^T X written
      into a new device [N, N]; G is overwritten by the factors);
    - otherwise ``torch.linalg.inv``.

    Deliberate difference from the JAX package (unirec_tpu/models/
    solvers.py:98-121), which catches every exception and ends in host
    LAPACK: nothing here moves the solve to the host, and a failure on the
    device raises."""
    n = G.shape[0]
    with full_f32():
        if n <= int(cfg.get("solver_device_inverse_max", 12_000)):
            return torch.linalg.inv(G)
        if spd and int(torch.linalg.cholesky_ex(G).info) == 0:
            nb = min(int(cfg.get("solver_inverse_block", 4096)), n)
            out = torch.empty_like(G)
            for c, slab in spd_inverse_columns(G, nb):
                out[:, c:c + slab.shape[1]] = slab
            return out
        return torch.linalg.inv(G)


def _edge_normalized(graph, edge_norm: str):
    """sqrt-degree edge normalization (sar.py:20-33), on the host."""
    import scipy.sparse as ssp

    if edge_norm == EdgeNormType.NONE.value:
        return graph.astype(np.float32)
    user_deg = np.squeeze(np.asarray(graph.sum(1)))
    item_deg = np.squeeze(np.asarray(graph.sum(0)))
    w = np.ones_like(graph.data, dtype=np.float64) / item_deg[graph.indices]
    reps = np.diff(graph.indptr)
    w = np.sqrt(w / np.repeat(np.maximum(user_deg, 1e-12), reps) + 1e-8)
    return ssp.csr_matrix((w.astype(np.float32), graph.indices, graph.indptr),
                          shape=graph.shape)


class SolverRecommender:
    """Base of the models that are solved once rather than trained by SGD
    (reference ease.py:38-41: ``__optimized_by_SGD__ = False``)."""

    optimized_by_sgd = False
    is_seqrec = False

    def __init__(self, cfg: Dict[str, Any]):
        self.cfg = cfg
        self.n_users = int(cfg["n_users"])
        self.n_items = int(cfg["n_items"])
        self.device = torch.device("cpu")
        self.item_similarity = None      # [N, N] on the device
        self.user_item = None            # scipy CSR [U, N] (host)
        self._rows = None                # its _DeviceCSR

    def to(self, device) -> "SolverRecommender":
        self.device = torch.device(device)
        if self.item_similarity is not None:
            self.item_similarity = self.item_similarity.to(self.device)
        if self.user_item is not None:
            self._set_user_item(self.user_item)
        return self

    def _set_user_item(self, graph) -> None:
        self.user_item = graph.tocsr()
        self._rows = _DeviceCSR(self.user_item, self.device)

    def solve(self, graph):
        raise NotImplementedError

    # ------------------------------------------------- what the evaluators call
    def user_emb(self, batch) -> torch.Tensor:
        """The batch users' history rows [B, N] (the graph's values)."""
        return self._rows.gather(batch["user_id"])

    def all_item_emb(self) -> torch.Tensor:
        """[N, N]: row i is item i's column of the similarity (a view)."""
        return self.item_similarity.T

    def bias_terms(self):
        return None, None

    def predict(self, batch) -> torch.Tensor:
        """Scores of the batch's (user, item) rows, [B] or [B, G]."""
        user = self.user_emb(batch)
        cols = self.all_item_emb()[batch["item_id"].to(self.device, torch.int64)]
        if cols.dim() == 3:
            return torch.einsum("bn,bgn->bg", user, cols)
        return torch.einsum("bn,bn->b", user, cols)

    # ------------------------------------------------------------ state dict
    def state_dict(self) -> Dict[str, Any]:
        return {"item_similarity": self.item_similarity.cpu().numpy(),
                "user_item": self.user_item}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for k, v in state.items():
            if k == "user_item":
                self._set_user_item(v)
            elif k == "item_similarity":
                self.item_similarity = torch.tensor(np.asarray(v, np.float32), device=self.device)
            else:
                setattr(self, k, v)


@register_model("EASE")
class EASE(SolverRecommender):
    """Closed form B = P / (-diag P) with a zero diagonal, P = (R^T R +
    l2 I)^-1 (ease.py:54-68), written over P."""

    def solve(self, graph):
        G = _gram(graph, self.device)
        G.diagonal().add_(float(self.cfg.get("l2_coef", 200)))
        P = _regularized_inverse(G, self.cfg)
        del G
        P.div_(-P.diagonal().clone()[None, :])
        self.item_similarity = P.fill_diagonal_(0.0)
        self._set_user_item(graph)


@register_model("AdmmSLIM")
class AdmmSLIM(SolverRecommender):
    """ADMM iterations with soft-thresholding and positivity
    (admmslim.py:23-61). The Gram X^T X is dropped once B_aux = P X^T X is
    formed, and C and Gamma are updated in place: the loop holds P, B_aux,
    C, Gamma and two temporaries, six [N, N] in all."""

    def solve(self, graph):
        cfg = self.cfg
        rho = float(cfg.get("admm_penalty", 4000.0))
        l1 = float(cfg.get("l1_coef", 3.0))
        l2 = float(cfg.get("l2_coef", 400.0)) * 2.0
        alpha = float(cfg.get("item_spec_reg", 0.5))
        n_iter = int(cfg.get("epochs", 100))
        XtX = _gram(graph, self.device)
        item_means = np.squeeze(np.asarray(graph.mean(axis=0))).astype(np.float32)
        A = XtX.clone()
        A.diagonal().add_(torch.as_tensor(l2 * np.power(item_means, alpha)).to(self.device))
        A.diagonal().add_(rho)
        P = _regularized_inverse(A, cfg)
        del A
        with full_f32():
            B_aux = P @ XtX
            del XtX
            P_diag = P.diagonal() + 1e-7
            C, Gamma = torch.zeros_like(P), torch.zeros_like(P)
            T1, T2 = torch.empty_like(P), torch.empty_like(P)
            for _ in range(n_iter):
                torch.mul(C, rho, out=T1).sub_(Gamma)            # rho C - Gamma
                torch.matmul(P, T1, out=T2).add_(B_aux)           # B~ = B_aux + P (rho C - Gamma)
                gamma = T2.diagonal() / P_diag
                T2.sub_(torch.mul(P, gamma[None, :], out=T1))     # B = B~ - P diag(gamma)
                torch.div(Gamma, rho, out=T1).add_(T2)            # T = B + Gamma / rho
                torch.sub(T1, l1 / rho, out=C).clamp_(min=0.0)    # soft threshold, then >= 0
                torch.sub(T2, C, out=T1).mul_(rho)
                Gamma.add_(T1)                                    # Gamma += rho (B - C)
        self.item_similarity = C
        self._set_user_item(graph)


@register_model("SLIM")
class SLIM(SolverRecommender):
    """SLIM: one positive ElasticNet per column. The reference loops n_items
    sklearn fits (slim.py:22-66); here cyclic coordinate descent runs for
    every column at once on the Gram G (each coordinate step is a row
    update of the [N, N] weights).

    Objective per column c (sklearn ElasticNet with alpha = 2 l2 + l1,
    l1_ratio = l1 / alpha, positive, X[:, c] zeroed during its own fit):
        1/(2n) ||a_c - X w||^2 + l1 |w|_1 + l2 |w|^2,  w >= 0, w_cc = 0.

    Above ``slim_active_set_threshold`` items (or with
    ``slim_active_set_k``) each column is restricted to its K most
    co-occurring items (``_candidates``) and the same descent runs on the
    [K, K] subproblems."""

    def solve(self, graph):
        cfg = self.cfg
        l1 = float(cfg.get("l1_coef", 0.004))
        l2 = float(cfg.get("l2_coef", 0.098))
        sweeps = min(int(cfg.get("epochs", 100)), int(cfg.get("slim_max_sweeps", 30)))
        G = _gram(graph, self.device)
        n = float(graph.shape[0])
        N = G.shape[0]
        K = int(cfg.get("slim_active_set_k", 0) or 0)
        if K <= 0 and N > int(cfg.get("slim_active_set_threshold", 4096)):
            K = 256
        if 0 < K < N - 1:
            sim = self._solve_active_set(G, n, l1, l2, sweeps, self._candidates(G, K))
        else:
            sim = self._solve_full(G, n, l1, l2, sweeps)
        self.item_similarity = sim
        self._set_user_item(graph)

    @staticmethod
    def _candidates(G: torch.Tensor, K: int) -> torch.Tensor:
        """[N, K]: each column's K largest entries of G off the diagonal,
        by ``torch.topk`` on G's device. The JAX package takes
        ``np.argpartition`` on a host copy; G holds integer counts, so
        where the K-th value ties, the two may pick other tied items."""
        d = G.diagonal().clone()
        G.fill_diagonal_(float("-inf"))
        cand = torch.topk(G, K, dim=0).indices.T.contiguous()
        G.diagonal().copy_(d)
        return cand

    @staticmethod
    def _solve_full(G, n, l1, l2, sweeps) -> torch.Tensor:
        """Exact cyclic descent over all coordinates, O(N^3) a sweep."""
        N = G.shape[0]
        diag = G.diagonal()
        denom = diag + 2.0 * n * l2
        thr = n * l1
        W = torch.zeros_like(G)
        with full_f32():
            for _ in range(sweeps):
                for j in range(N):
                    # residual correlation of coordinate j with every target
                    r = G[j] @ W - diag[j] * W[j]
                    w = torch.clamp(G[j] - r - thr, min=0.0) / denom[j]
                    w[j] = 0.0                   # the diagonal constraint
                    W[j] = w
        return W

    @staticmethod
    def _solve_active_set(G, n, l1, l2, sweeps, cand: torch.Tensor) -> torch.Tensor:
        """Cyclic descent restricted to ``cand`` [N, K] (column c's
        candidate coordinates), on all columns' [K, K] subproblems at once:
        O(N K^2) a sweep. The gathered Gs is [N, K, K] (10.7 GB at
        N = 40,982, K = 256). The JAX package's probe found K = 256 exact
        against the full descent at N = 2,000 (unirec_tpu/models/
        solvers.py:261-282)."""
        N, K = cand.shape
        cand = cand.to(G.device, torch.int64)
        # Gs[c] = G[cand[c], cand[c]], gathered a slab of columns at a time:
        # one advanced index over all N would broadcast two [N, K, K] int64
        # index tensors (43 GB at N = 40,982)
        Gs = torch.empty(N, K, K, dtype=G.dtype, device=G.device)
        step = max(1, _GATHER_INDEX_ELEMS // (K * K))
        for c0 in range(0, N, step):
            cc = cand[c0:c0 + step]
            Gs[c0:c0 + step] = G[cc[:, :, None], cc[:, None, :]]
        b = torch.gather(G, 0, cand.T).T             # b[c, k] = G[cand[c, k], c]
        d = G.diagonal()[cand]
        denom = d + 2.0 * n * l2
        thr = n * l1
        W = torch.zeros(N, K, dtype=G.dtype, device=G.device)
        with full_f32():
            for _ in range(sweeps):
                for j in range(K):
                    r = torch.einsum("nk,nk->n", Gs[:, j, :], W) - d[:, j] * W[:, j]
                    W[:, j] = torch.clamp(b[:, j] - r - thr, min=0.0) / denom[:, j]
        del Gs
        sim = torch.zeros(N, N, dtype=G.dtype, device=G.device)
        sim.T.scatter_(1, cand, W)                   # sim[cand[c, k], c] = W[c, k]
        return sim.fill_diagonal_(0.0)


@register_model("SAR")
class SAR(SolverRecommender):
    """Edge-normalized co-occurrence A^T A with a zero diagonal
    (sar.py:14-38)."""

    def solve(self, graph):
        A = _edge_normalized(graph.tocsr(), self.cfg.get("edge_norm", "sqrt_degree"))
        self.item_similarity = _gram(A, self.device).fill_diagonal_(0.0)
        self._set_user_item(graph)


@register_model("UserCF")
class UserCF(SolverRecommender):
    """User-user similarity A A^T with a zero diagonal (usercf.py:31-55):
    score(u, i) = sum over v of sim(u, v) R(v, i). Its "user embedding" is
    the user's similarity row [B, U] and its item table the dense R^T
    [N, U]; both live on the device."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.user_similarity = None      # [U, U] on the device
        self._dense_items = None         # R [U, N] on the device

    def to(self, device) -> "UserCF":
        super().to(device)
        if self.user_similarity is not None:
            self.user_similarity = self.user_similarity.to(self.device)
        return self

    def _set_user_item(self, graph) -> None:
        super()._set_user_item(graph)
        self._dense_items = self._rows.dense()

    def solve(self, graph):
        A = _edge_normalized(graph.tocsr(), self.cfg.get("edge_norm", "sqrt_degree"))
        self.user_similarity = _gram(A.T.tocsr(), self.device).fill_diagonal_(0.0)
        self._set_user_item(graph)

    def user_emb(self, batch) -> torch.Tensor:
        return self.user_similarity[batch["user_id"].to(self.device, torch.int64)]

    def all_item_emb(self) -> torch.Tensor:
        return self._dense_items.T

    def state_dict(self) -> Dict[str, Any]:
        import scipy.sparse as ssp

        S = self.user_similarity
        rows, cols = S.nonzero().T
        sim = ssp.csr_matrix((S[rows, cols].cpu().numpy(),
                              (rows.cpu().numpy(), cols.cpu().numpy())), shape=tuple(S.shape))
        return {"user_similarity": sim, "user_item": self.user_item}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        super().load_state_dict({k: v for k, v in state.items() if k != "user_similarity"})
        if "user_similarity" in state:
            self.user_similarity = _DeviceCSR(state["user_similarity"], self.device).dense()
