"""The port's closed-form models (unirec_tpu_torch/models/solvers.py), their
Solver (facility/solver.py) and main.run's solver branch against the JAX
package, on the CPU with one torch thread.

Inputs are numpy graphs from a seed (300 users, 120 items, density 0.07)
and tests/synth.py's dataset; both packages solve the same graph.
Tolerances:

- solved matrices within 1e-5 of the largest entry (f32 on both sides; the
  port sums its dense Gram products, its inverse and its iterations in
  another order; measured 1e-7 to 5e-6 of it);
- the inverse tiers within 2e-5 of the largest entry (tests/test_linalg.py's
  bound for the blocked tier);
- metrics within 1e-5, infer scores within 1e-5 of the largest score.

SLIM's active set is held on the same candidates: the test computes the JAX
package's ``np.argpartition`` choice and hands it to the port. The port's
own choice (``torch.topk``) is held to the tie rule: every chosen value is
at least the column's K-th largest, and it agrees with the JAX choice on
every value strictly above it.
"""
import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as ssp
import torch

from tests.synth import BASE_CONF
from unirec_tpu.main import main as jax_main
from unirec_tpu.models import solvers as J
from unirec_tpu_torch.main import main
from unirec_tpu_torch.models import solvers as T

MODELS = ("EASE", "AdmmSLIM", "SAR", "UserCF", "SLIM")
REL_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(U=300, N=120, density=0.07, seed=0):
    rng = np.random.default_rng(seed)
    return ssp.csr_matrix((rng.random((U, N)) < density).astype(np.float64))


def _close(got, want, rel=REL_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(), rtol=0)


def _solved(name, graph, **over):
    cfg = {"n_users": graph.shape[0], "n_items": graph.shape[1], **over}
    j, t = getattr(J, name)(dict(cfg)), getattr(T, name)(dict(cfg))
    j.solve(graph)
    t.solve(graph)
    return j, t


@pytest.mark.parametrize("name,over", [
    ("EASE", {}), ("EASE", {"l2_coef": 20}), ("AdmmSLIM", {"epochs": 20}),
    ("SAR", {}), ("SAR", {"edge_norm": "none"}), ("SLIM", {"epochs": 30}),
], ids=["EASE", "EASE-l2-20", "AdmmSLIM", "SAR", "SAR-none", "SLIM-full"])
def test_item_similarity_matches_jax(name, over):
    j, t = _solved(name, _graph(), **over)
    _close(t.item_similarity.numpy(), j.item_similarity)
    assert np.all(np.diag(t.item_similarity.numpy()) == 0)


@pytest.mark.parametrize("edge_norm", ["sqrt_degree", "none"])
def test_user_similarity_matches_jax(edge_norm):
    j, t = _solved("UserCF", _graph(), edge_norm=edge_norm)
    _close(t.user_similarity.numpy(), j.user_similarity.toarray())


def test_ease_blocked_tier_matches_jax():
    """N = 120 above solver_device_inverse_max = 64: the blocked Cholesky
    tier in both packages, a ragged last block of 24."""
    over = {"solver_device_inverse_max": 64, "solver_inverse_block": 48}
    j, t = _solved("EASE", _graph(), **over)
    _close(t.item_similarity.numpy(), j.item_similarity)


def _spd(n, seed=4):
    rng = np.random.default_rng(seed)
    R = rng.normal(size=(n + 32, n))
    return (R.T @ R + 10 * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("cfg", [{}, {"solver_device_inverse_max": 64,
                                      "solver_inverse_block": 48}], ids=["lu", "blocked"])
def test_regularized_inverse_tiers_match_jax(cfg):
    A = _spd(150)
    want = J._regularized_inverse(A.copy(), cfg)
    got = T._regularized_inverse(torch.tensor(A), cfg).numpy()
    _close(got, want, 2e-5)
    _close(got, np.linalg.inv(A.astype(np.float64)), 2e-5)


def test_regularized_inverse_of_an_indefinite_matrix_takes_the_lu_tier(monkeypatch):
    """Above the LU limit, cholesky_ex's info sends a matrix that is not
    positive definite to torch.linalg.inv, not to the blocked Cholesky."""
    A = _spd(100)
    A[0, 0] = -50.0
    monkeypatch.setattr(T, "spd_inverse_columns", None)       # must not be reached
    got = T._regularized_inverse(torch.tensor(A), {"solver_device_inverse_max": 10}).numpy()
    _close(got, np.linalg.inv(A.astype(np.float64)), 2e-5)


def test_regularized_inverse_raises_and_never_moves_to_the_host():
    """A solve that fails on its device raises (the JAX package ends in host
    LAPACK instead, which raises too on an exactly singular matrix)."""
    A = np.zeros((20, 20), np.float32)
    with pytest.raises(torch.linalg.LinAlgError):
        T._regularized_inverse(torch.tensor(A), {})


def _jax_candidates(G, K):
    """unirec_tpu/models/solvers.py:283-286, verbatim."""
    Gq = np.array(G, copy=True)
    np.fill_diagonal(Gq, -np.inf)
    return np.argpartition(-Gq, K, axis=0)[:K, :].T.astype(np.int32)


@pytest.mark.parametrize("K", [40, 119])
def test_slim_active_set_matches_jax_on_the_same_candidates(K):
    graph = _graph()
    G = (graph.T @ graph).toarray().astype(np.float32)
    n, l1, l2, sweeps = float(graph.shape[0]), 0.004, 0.098, 30
    cand = _jax_candidates(G, K)
    want = J.SLIM._solve_active_set(G, n, l1, l2, sweeps, K)    # the same argpartition inside
    got = T.SLIM._solve_active_set(torch.tensor(G), n, l1, l2, sweeps, torch.tensor(cand))
    _close(got.numpy(), want)


def test_slim_active_set_over_every_coordinate_is_the_full_descent():
    graph = _graph()
    G = torch.tensor((graph.T @ graph).toarray().astype(np.float32))
    N, n = G.shape[0], float(graph.shape[0])
    full = T.SLIM._solve_full(G, n, 0.004, 0.098, 30)
    cand = torch.stack([torch.tensor([i for i in range(N) if i != c]) for c in range(N)])
    # the same coordinates in the same order: the same arithmetic
    active = T.SLIM._solve_active_set(G, n, 0.004, 0.098, 30, cand)
    _close(active.numpy(), full.numpy())


def test_slim_candidates_follow_the_tie_rule():
    """Integer Gram counts tie often at the K-th value: the port's choice
    holds only values at least the column's K-th largest (off the
    diagonal), and agrees with the JAX choice on every value above it."""
    graph = _graph(density=0.05, seed=3)
    G = (graph.T @ graph).toarray().astype(np.float32)
    K = 30
    Gt = torch.tensor(G)
    ours = T.SLIM._candidates(Gt, K).numpy()
    assert np.array_equal(Gt.numpy(), G)                      # the diagonal restored
    theirs = _jax_candidates(G, K)
    off = G.copy()
    np.fill_diagonal(off, -np.inf)
    ties = 0
    for c in range(G.shape[0]):
        col = off[:, c]
        kth = np.sort(col)[::-1][K - 1]
        assert c not in ours[c] and len(set(ours[c])) == K
        assert np.all(col[ours[c]] >= kth)
        above = set(np.flatnonzero(col > kth))
        assert above <= set(ours[c]) and above <= set(theirs[c])
        ties += set(ours[c]) != set(theirs[c])
    assert ties > 0, "no column with ties at the K-th value: the test would be vacuous"


def test_user_rows_carry_the_graphs_summed_values():
    """A graph with a duplicate (user, item) pair: csr_matrix sums it, and the
    port's device rows hold the sum as the JAX package's host rows do."""
    users, items = np.array([1, 1, 1, 2, 3]), np.array([4, 4, 7, 2, 0])
    graph = ssp.csr_matrix((np.ones(5), (users, items)), shape=(5, 9))
    t = T.SAR({"n_users": 5, "n_items": 9})
    t.solve(graph)
    ids = torch.tensor([0, 1, 2, 3, 1])
    rows = t.user_emb({"user_id": ids}).numpy()
    np.testing.assert_array_equal(rows, graph[ids.numpy()].toarray())
    assert rows[1, 4] == 2.0


@pytest.mark.parametrize("name", MODELS)
def test_predict_and_embeddings_match_jax(name):
    graph = _graph()
    j, t = _solved(name, graph, epochs=10)
    rng = np.random.default_rng(7)
    users = rng.integers(0, graph.shape[0], 6)
    for items in (rng.integers(0, graph.shape[1], 6), rng.integers(0, graph.shape[1], (6, 4))):
        batch = {"user_id": users, "item_id": items}
        want = np.asarray(j.apply(None, batch, method="predict"))
        got = t.predict({k: torch.tensor(v) for k, v in batch.items()}).numpy()
        _close(got, want)
    _close(t.user_emb({"user_id": torch.tensor(users)}).numpy(),
           np.asarray(j.apply(None, {"user_id": users}, method="user_emb")))
    _close(t.all_item_emb().numpy(), np.asarray(j.apply(None, method="all_item_emb")))
    assert t.bias_terms() == (None, None)


@pytest.mark.parametrize("name", MODELS)
def test_state_dict_has_the_jax_types_and_round_trips(name):
    graph = _graph()
    j, t = _solved(name, graph, epochs=10)
    state, ref = t.state_dict(), j.state_dict()
    assert set(state) == set(ref)
    for k in state:
        assert type(state[k]) is type(ref[k]) or (ssp.issparse(state[k]) and ssp.issparse(ref[k]))
        if ssp.issparse(ref[k]):
            _close(state[k].toarray(), ref[k].toarray())
        else:
            assert state[k].dtype == np.float32
            _close(state[k], ref[k])
    back = getattr(T, name)({"n_users": graph.shape[0], "n_items": graph.shape[1]})
    back.load_state_dict(ref)                                 # the JAX package's state
    batch = {"user_id": torch.arange(8), "item_id": torch.arange(8)}
    _close(back.predict(batch).numpy(), t.predict(batch).numpy())


# ------------------------------------------------------------ main.run
def _conf(root, out, model, **kw):
    conf = copy.deepcopy(BASE_CONF)
    conf.update(model=model, dataset_path=root, dataloader="AERecDataset",
                n_sample_neg_train=0, task="train", exp_name=model,
                output_path=os.path.join(out, model), **kw)
    return conf


@pytest.fixture(scope="module")
def solver_runs(synth_dataset, tmp_path_factory):
    """main.run(task=train) of each solver in both packages (AdmmSLIM and
    SLIM at 20 iterations)."""
    root, _ = synth_dataset
    out = str(tmp_path_factory.mktemp("solvers"))
    runs = {}
    for name in MODELS:
        over = {"epochs": 20} if name in ("AdmmSLIM", "SLIM") else {}
        port = _conf(root, os.path.join(out, "port"), name, **over)
        ref = _conf(root, os.path.join(out, "jax"), name, **over)
        runs[name] = (port, main.run(dict(port, device="cpu")), ref, jax_main.run(dict(ref)))
    return runs


def _pkl(args):
    return os.path.join(args["output_path"], "checkpoint", f"{args['exp_name']}.solver.pkl")


def _same_metrics(got, want):
    assert set(got) == set(want)
    for m in want:
        assert abs(got[m] - want[m]) <= 1e-5, (m, got[m], want[m])


@pytest.mark.parametrize("name", MODELS)
def test_main_run_trains_to_the_jax_metrics(solver_runs, name):
    port, result, _, ref = solver_runs[name]
    assert result["hit@5"] > 0.05, result                     # tests/test_e2e_cf.py's gate
    _same_metrics(result, ref)
    assert os.path.exists(_pkl(port))
    assert os.path.exists(os.path.join(port["output_path"], f"{name}.result.tsv"))


@pytest.mark.parametrize("name", MODELS)
def test_test_task_from_the_solver_pkl_repeats_the_run(solver_runs, name):
    port, result, _, _ = solver_runs[name]
    again = main.run({"task": "test", "model_file": _pkl(port), "device": "cpu",
                      "dataset_path": port["dataset_path"],
                      "output_path": port["output_path"] + "_test"})
    assert again == result


@pytest.mark.parametrize("name", MODELS)
def test_each_package_reads_the_others_solver_pkl(solver_runs, name):
    port, result, ref_args, ref = solver_runs[name]
    jax_reads_port = jax_main.run({"task": "test", "model_file": _pkl(port),
                                   "dataset_path": port["dataset_path"],
                                   "output_path": port["output_path"] + "_jax"})
    _same_metrics(jax_reads_port, result)
    port_reads_jax = main.run({"task": "test", "model_file": _pkl(ref_args), "device": "cpu",
                               "dataset_path": ref_args["dataset_path"],
                               "output_path": ref_args["output_path"] + "_port"})
    _same_metrics(port_reads_jax, ref)


@pytest.mark.parametrize("name", ["EASE", "UserCF"])
def test_infer_task_writes_the_jax_scores(solver_runs, name):
    port, _, _, _ = solver_runs[name]
    task = {"task": "infer", "model_file": _pkl(port), "dataset_path": port["dataset_path"]}
    assert main.run(dict(task, device="cpu", output_path=port["output_path"] + "_inf")) is None
    jax_main.run(dict(task, output_path=port["output_path"] + "_jinf"))
    got = np.loadtxt(os.path.join(port["output_path"] + "_inf", f"{name}.infer.txt"))
    want = np.loadtxt(os.path.join(port["output_path"] + "_jinf", f"{name}.infer.txt"))
    assert got.shape == want.shape and len(got) > 0
    _close(got, want)


def test_cli_trains_a_solver(synth_dataset, tmp_path, capsys):
    from unirec_tpu_torch import cli
    root, _ = synth_dataset
    assert cli.main(["train", "--model", "SAR", "--dataloader", "AERecDataset",
                     "--dataset_path", root, "--output_path", str(tmp_path),
                     "--exp_name", "cli_sar", "--n_sample_neg_train", "0",
                     "--valid_protocol", "one_vs_all", "--test_protocol", "one_vs_all",
                     "--user_history_filename", "user_history",
                     "--metrics", "['hit@5;10']", "--device", "cpu"]) == 0
    assert "hit@5" in capsys.readouterr().out
    assert (tmp_path / "checkpoint" / "cli_sar.solver.pkl").exists()


def test_get_graph_matches_jax(synth_dataset):
    from unirec_tpu import config as jax_config
    from unirec_tpu.data.datasets import AERecDataset as JaxAERec
    from unirec_tpu_torch import config as torch_config
    from unirec_tpu_torch.data.datasets import AERecDataset
    root, _ = synth_dataset
    args = dict(model="EASE", dataset_path=root, data_loader_task="train",
                data_format="user-item")
    jd = JaxAERec(jax_config.parse_arguments(args, argv=[]), root, "train")
    td = AERecDataset(torch_config.parse_arguments(args, argv=[], device="cpu"), root, "train")
    want, got = jd.get_graph(), td.get_graph()
    assert got.shape == want.shape and (got != want).nnz == 0
    evald = AERecDataset(torch_config.parse_arguments(
        dict(args, data_loader_task="test"), argv=[], device="cpu"), root, "test")
    with pytest.raises(ValueError, match="training split"):
        evald.get_graph()


def test_jax_apply_shape_of_all_item_emb_is_the_transpose():
    """The evaluators' item table is the similarity's transpose in both
    packages (a view in the port)."""
    graph = _graph()
    j, t = _solved("EASE", graph)
    emb = t.all_item_emb()
    assert emb.data_ptr() == t.item_similarity.data_ptr()
    np.testing.assert_array_equal(np.asarray(j.apply(None, method="all_item_emb")),
                                  jnp.asarray(j.item_similarity.T))
