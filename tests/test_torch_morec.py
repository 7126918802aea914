"""The port's MoRec (facility/morec, the MoRec metrics, main.run with
enable_morec) against the JAX package.

MF (BPR, user embeddings) on tests/synth.py's data, whose item_meta_morec.csv
holds prices, fair groups (item clusters) and align groups (popularity
quintiles); f32, the same weights in both packages through the flax bridge.

- The controllers and ``min_norm_point_gram``: the same weights from the
  same Gram and loss values (numpy in both, so to 1e-12), over several
  steps where a controller keeps state.
- ``load_morec_meta_data``, the alignment distribution and the sampler's
  groups equal; ``MoRecBatcher``'s blocks from the same seed equal, batch
  for batch (the same numpy draws over the same host Batcher).
- One MoRec batch: the per-block loss vector, and the Gram of the k
  per-objective gradients (k backward passes in the port, one jacrev in
  JAX), within 1e-5 of the largest entry; one PI step, one Static step and
  one MGDA step's parameters within 1e-6 (Adam's first step moves each by
  about the learning rate, 2e-3, its sign set by the gradient's).
- The MoRec metrics of one-vs-all evaluation (rhit, rndcg, pop-kl,
  least-misery's min-*) within 1e-5 of JAX's on the same weights (the tie
  noise differs between the frameworks and breaks no rank at f32), the
  session protocol's price-weighted rhit, rrecall and rndcg on the same
  scores to 1e-9; the signal sweeps' top-k lists equal.
- ``main.run`` fine-tunes a pretrained MF with every controller under
  tests/test_morec.py's gates, and the CLI trains with enable_morec.
"""
import copy
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synth import BASE_CONF
from unirec_tpu import config as jax_config
from unirec_tpu.data.datasets import BaseDataset as JaxBaseDataset
from unirec_tpu.data.history import UserHistory as JaxHistory
from unirec_tpu.data.pipeline import make_negative_sampler as jax_negative_sampler
from unirec_tpu.data.pipeline import make_train_batcher as jax_train_batcher
from unirec_tpu.facility.evaluation import build_evaluator as jax_build_evaluator
from unirec_tpu.facility.evaluation.evaluators import SessionWiseEvaluator as JaxSessionWise
from unirec_tpu.facility.morec import controllers as JC
from unirec_tpu.facility.morec import integration as JI
from unirec_tpu.facility.morec import load_alignment_distribution as jax_align
from unirec_tpu.facility.morec import load_morec_meta_data as jax_meta
from unirec_tpu.facility.morec.min_norm import min_norm_point_gram as jax_min_norm
from unirec_tpu.facility.morec.sampler import MoRecBatcher as JaxMoRecBatcher
from unirec_tpu.core.optim import build_optimizer as jax_optimizer
from unirec_tpu.main.main import _task_config as jax_task_config
from unirec_tpu.utils.registry import get_model_class as jax_model_class
from unirec_tpu_torch import cli
from unirec_tpu_torch import config as torch_config
from unirec_tpu_torch.data import construct_item_popularity
from unirec_tpu_torch.data.datasets import BaseDataset
from unirec_tpu_torch.data.history import UserHistory
from unirec_tpu_torch.data.pipeline import make_host_train_batcher, make_negative_sampler
from unirec_tpu_torch.facility.evaluation import SessionWiseEvaluator, build_evaluator
from unirec_tpu_torch.facility.morec import controllers as TC
from unirec_tpu_torch.facility.morec import integration as TI
from unirec_tpu_torch.facility.morec import (MoRecBatcher, load_alignment_distribution,
                                             load_morec_meta_data)
from unirec_tpu_torch.facility.morec.min_norm import min_norm_point_gram
from unirec_tpu_torch.facility.trainer import Trainer
from unirec_tpu_torch.main import main
from unirec_tpu_torch.main.main import _task_config
from unirec_tpu_torch.utils import to_device
from unirec_tpu_torch.utils.flax_bridge import load_flax_params, to_flax_params
from unirec_tpu_torch.utils.registry import get_model_class

MOREC_METRICS = ("['hit@5;10', 'ndcg@5;10', 'rhit@5;10', 'rndcg@5;10', 'rrecall@5', "
                 "'pop-kl@5;10', 'least-misery']")
OBJECTIVES = ["fairness", "alignment", "revenue"]
ARGS = dict(BASE_CONF, model="MF", dataloader="BaseDataset", loss_type="bpr",
            has_user_emb=True, metrics=MOREC_METRICS, key_metric="ndcg@5",
            compute_dtype="float32", morec_objectives=OBJECTIVES, morec_ngroup=5,
            morec_alpha=0.01, batch_size=64)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op torch thread: six xdist workers with eight-thread teams
    each stall small ops by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env(synth_dataset):
    """Both packages' configs (item meta loaded), histories, MF models with
    the same weights, and the training tables."""
    root, _ = synth_dataset
    args = dict(ARGS, dataset_path=root)
    jcfg = jax_config.parse_arguments(copy.deepcopy(args), argv=[])
    tcfg = torch_config.parse_arguments(copy.deepcopy(args), argv=[], device="cpu")
    th = UserHistory.load(f"{root}/user_history", int(tcfg["n_users"]), "user-item_seq")
    jh = JaxHistory.load(f"{root}/user_history", int(jcfg["n_users"]), "user-item_seq")
    pop = construct_item_popularity(th, int(tcfg["n_items"]))
    meta_file = f"{root}/item_meta_morec.csv"
    for cfg, load, align in ((tcfg, load_morec_meta_data, load_alignment_distribution),
                             (jcfg, jax_meta, jax_align)):
        cfg["_item_meta_morec"] = load(int(cfg["n_items"]), meta_file, OBJECTIVES)
        cfg["_alignment_dist"] = align(cfg["_item_meta_morec"], pop)
    jmodel = jax_model_class("MF")(cfg=jcfg)
    b = {"user_id": jnp.ones(2, jnp.int32), "item_id": jnp.ones((2, 10), jnp.int32),
         "label": jnp.ones((2, 10))}
    params = jmodel.init(jax.random.PRNGKey(3), b, train=False)["params"]
    tmodel = get_model_class("MF")(tcfg)
    load_flax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    tt, jt = _task_config(tcfg, "train"), jax_task_config(jcfg, "train")
    return dict(root=root, tcfg=tcfg, jcfg=jcfg, th=th, jh=jh, pop=pop, jmodel=jmodel,
                params=params, tmodel=tmodel, tt=tt, jt=jt,
                tds=BaseDataset(tt, root, "train"), jds=JaxBaseDataset(jt, root, "train"))


def _batchers(env, seed_ngroup=None):
    """The MoRec batchers of both packages over the same training table."""
    tt, jt = dict(env["tt"]), dict(env["jt"])
    if seed_ngroup:
        for c in (tt, jt):
            c["seed"], c["morec_ngroup"] = seed_ngroup
    tb = MoRecBatcher(env["tds"], tt, history=env["th"],
                      sampler=make_negative_sampler(tt, env["th"], env["pop"]),
                      item_meta=tt["_item_meta_morec"], align_dist=tt["_alignment_dist"])
    jb = JaxMoRecBatcher(env["jds"], jt, history=env["jh"],
                         sampler=jax_negative_sampler(jt, env["jh"], env["pop"]),
                         item_meta=jt["_item_meta_morec"], align_dist=jt["_alignment_dist"])
    return tb, jb


# -------------------------------------------------------------- controllers
def _gram(seed, k):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(k, 7))
    return g @ g.T, rng.uniform(0.2, 2.0, size=k)


@pytest.mark.parametrize("seed,k", [(0, 2), (1, 3), (2, 4), (3, 5)])
def test_min_norm_point_matches_jax(seed, k):
    M, _ = _gram(seed, k)
    np.testing.assert_allclose(min_norm_point_gram(M), jax_min_norm(M), atol=1e-12)
    assert abs(min_norm_point_gram(M).sum() - 1.0) < 1e-9


def _solvers(k):
    return {"Static": (TC.StaticWeightSolver(k, [0.1] * (k - 1) + [1 - 0.1 * (k - 1)]),
                       JC.StaticWeightSolver(k, [0.1] * (k - 1) + [1 - 0.1 * (k - 1)])),
            "uniform": (TC.StaticWeightSolver(k), JC.StaticWeightSolver(k)),
            "MGDA": (TC.MGDASolver(k), JC.MGDASolver(k)),
            "ParetoMTL": (TC.ParetoMTLSolver(k, pref_id=1, init_steps=2),
                          JC.ParetoMTLSolver(k, pref_id=1, init_steps=2)),
            "EPO": (TC.EPOSolver(k, np.arange(1.0, k + 1)),
                    JC.EPOSolver(k, np.arange(1.0, k + 1)))}


@pytest.mark.parametrize("name", ["Static", "uniform", "MGDA", "ParetoMTL", "EPO"])
def test_solvers_match_jax(name):
    """Five steps each on fresh Grams and values (ParetoMTL's two warm-up
    steps, then its constrained solve; EPO's balance or dominance LP)."""
    for k in (2, 3):
        mine, ref = _solvers(k)[name]
        for step in range(5):
            M, v = _gram(10 * step + k, k)
            np.testing.assert_allclose(mine.solve(M, v), ref.solve(M, v), atol=1e-12,
                                       err_msg=f"{name} k={k} step {step}")
        assert getattr(mine, "last_move", None) == getattr(ref, "last_move", None)


def test_pi_controllers_match_jax():
    args = dict(expect_loss=0.3, beta_min=0.2, beta_max=1.2, K_p=0.05, K_i=0.01)
    mine, ref = TC.PIController(**args), JC.PIController(**args)
    pix = TC.PIXController(**args, pareto_solver=TC.MGDASolver(3))
    jpix = JC.PIXController(**args, pareto_solver=JC.MGDASolver(3))
    for loss in np.random.default_rng(0).uniform(0.0, 1.0, size=40):
        assert mine.control(loss) == ref.control(loss)
        assert pix.control(loss) == jpix.control(loss)
    assert (mine.beta, mine._integral_error, mine.t) == (ref.beta, ref._integral_error, ref.t)
    M, v = _gram(5, 3)
    np.testing.assert_allclose(pix.pareto_solve(M, v), jpix.pareto_solve(M, v), atol=1e-12)
    assert pix.needs_grads and not TC.PIXController(0.2, pareto_solver=TC.StaticWeightSolver(3)).needs_grads


@pytest.mark.parametrize("kind,n_obj", [("PID", 3), ("PID", 1), ("Static", 3), ("Pareto", 3),
                                        ("PIX", 2)])
def test_build_controller_matches_jax(kind, n_obj):
    cfg = {"morec_objective_controller": kind, "morec_expect_loss": 0.25,
           "morec_objective_weights": "[0.1,0.1,0.1,0.7]" if kind == "Static"
           else "[0.3,0.3,0.4]"}
    mine, ref = TC.build_controller(cfg, n_obj), JC.build_controller(cfg, n_obj)
    assert type(mine).__name__ == type(ref).__name__
    M, v = _gram(7, n_obj + 1)
    if kind in ("Static", "Pareto"):
        np.testing.assert_allclose(mine.solve(M, v), ref.solve(M, v), atol=1e-12)
    else:
        assert (mine.expect_loss, mine.beta_min, mine.beta_max, mine.K_p, mine.K_i) == \
            (ref.expect_loss, ref.beta_min, ref.beta_max, ref.K_p, ref.K_i)
        Mi, vi = M[:-1, :-1], v[:-1]
        np.testing.assert_allclose(mine.pareto_solve(Mi, vi), ref.pareto_solve(Mi, vi),
                                   atol=1e-12)


def test_build_controller_takes_the_other_solvers_by_name():
    """Beyond the JAX names: MGDA, ParetoMTL and EPO over all n_obj + 1
    losses (ROADMAP.md, deliberate differences)."""
    assert isinstance(TC.build_controller({"morec_objective_controller": "MGDA"}, 3),
                      TC.MGDASolver)
    mtl = TC.build_controller({"morec_objective_controller": "ParetoMTL"}, 2)
    assert isinstance(mtl, TC.ParetoMTLSolver) and mtl.pref_id == 0 and mtl.num_tasks == 3
    epo = TC.build_controller({"morec_objective_controller": "EPO",
                               "morec_objective_weights": "[1,1,2]"}, 2)
    np.testing.assert_allclose(epo.pref, [0.25, 0.25, 0.5])


# ------------------------------------------------------------ meta, sampler
def test_item_meta_and_alignment_match_jax(env):
    tm, jm = env["tcfg"]["_item_meta_morec"], env["jcfg"]["_item_meta_morec"]
    assert set(tm) == set(jm) == {"weight", "fair_group", "align_group"}
    for k in tm:
        np.testing.assert_array_equal(tm[k], jm[k])
    np.testing.assert_array_equal(env["tcfg"]["_alignment_dist"], env["jcfg"]["_alignment_dist"])
    assert abs(env["tcfg"]["_alignment_dist"].sum() - 1.0) < 1e-6


@pytest.mark.parametrize("seed_ngroup", [None, (7, [3, 4, 6]), (11, [5, 5, -1])])
def test_morec_batcher_blocks_match_jax(env, seed_ngroup):
    """Two epochs of batches (negatives, labels, weights) equal, the groups
    and their weights equal; each batch is n_blocks blocks of batch_size
    (revenue's -1: one group an item)."""
    tb, jb = _batchers(env, seed_ngroup)
    assert tb.n_blocks == jb.n_blocks == 4 and len(tb) == len(jb)
    for obj in OBJECTIVES:
        np.testing.assert_array_equal(tb.item2group[obj], jb.item2group[obj])
        np.testing.assert_allclose(tb.group2weights[obj], jb.group2weights[obj], atol=0)
        assert len(tb.group2dataindex[obj]) == len(jb.group2dataindex[obj])
        for a, b in zip(tb.group2dataindex[obj], jb.group2dataindex[obj]):
            np.testing.assert_array_equal(a, b)
    for _ in range(2):
        n = 0
        for a, b in zip(tb, jb):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a["item_id"].shape[0] == 4 * tb.batch_size
            n += 1
        assert n == len(tb)


# ---------------------------------------------------- the step and the Gram
def _jax_trainer(env, controller, sampler):
    tx = jax_optimizer(env["jcfg"])
    # a copy: the JAX step donates the parameters it is given
    params = jax.tree_util.tree_map(lambda x: jnp.asarray(np.array(x)), env["params"])
    return types.SimpleNamespace(model=env["jmodel"], tx=tx, constants=None,
                                 config=env["jcfg"], params=params, opt_state=tx.init(params),
                                 objective_controller=controller, _morec_sampler=sampler)


def _torch_trainer(env, controller, sampler):
    model = get_model_class("MF")(env["tcfg"])
    load_flax_params(model, jax.tree_util.tree_map(np.asarray, env["params"]))
    tr = Trainer(env["tcfg"], model, device="cpu")
    tr.params = list(model.parameters())
    tr.opt_state = tr.tx.init(tr.params)
    tr.add_objective_controller(controller)
    tr._morec_sampler = sampler
    return tr


def _morec_batch(env):
    tb, _ = _batchers(env)
    return next(iter(tb)), tb


def test_loss_vector_and_gram_match_jax(env):
    """The k = 4 block losses and their gradients' Gram: the port's k
    backward passes against JAX's jacrev, within 1e-5 of the largest entry."""
    batch, tb = _morec_batch(env)
    jt = _jax_trainer(env, JC.MGDASolver(4), tb)
    eval_vec, eval_gram, _, _ = JI._ensure_compiled(jt, 4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(0)
    jvec, jgram = np.asarray(eval_vec(jt.params, jb, rng)), np.asarray(eval_gram(jt.params, jb, rng))
    tr = _torch_trainer(env, TC.MGDASolver(4), tb)
    vec = TI.loss_vector(tr, to_device(batch, "cpu"), 0, 4)
    G = TI.gram(TI.objective_grads(tr.params, vec)).numpy()
    np.testing.assert_allclose(vec.detach().numpy(), jvec, atol=1e-5 * np.abs(jvec).max())
    np.testing.assert_allclose(G, jgram, atol=1e-5 * np.abs(jgram).max())
    assert np.all(np.linalg.eigvalsh(G) > -1e-5 * np.abs(G).max())


@pytest.mark.parametrize("kind", ["PID", "Static", "MGDA", "PIX"])
def test_one_step_matches_jax(env, kind):
    """One morec_train_step of each branch from the same weights and batch:
    the parameters (Adam's first step) within 1e-6, the loss within 1e-5."""
    batch, tb = _morec_batch(env)
    cfg = {"morec_objective_controller": {"MGDA": "Pareto"}.get(kind, kind),
           "morec_objective_weights": "[0.1,0.1,0.1,0.7]" if kind == "Static"
           else "[0.3,0.3,0.4]", "morec_expect_loss": 0.25, "morec_beta_min": 0.1,
           "morec_beta_max": 1.5, "morec_K_p": 0.05, "morec_K_i": 0.001}
    jt = _jax_trainer(env, JC.build_controller(cfg, 3), tb)
    jloss, params, _ = JI.morec_train_step(jt, {k: jnp.asarray(v) for k, v in batch.items()},
                                           jax.random.PRNGKey(0))
    tr = _torch_trainer(env, TC.build_controller(cfg, 3), tb)
    loss = TI.morec_train_step(tr, to_device(batch, "cpu"), 0)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * max(1.0, abs(float(jloss)))
    got = to_flax_params(tr.model)
    ref = jax.tree_util.tree_map(np.asarray, params)
    for path, a in jax.tree_util.tree_leaves_with_path(ref):
        b = got
        for p in path:
            b = b[p.key]
        np.testing.assert_allclose(np.asarray(b), a, atol=1e-6, err_msg=str(path))
    if kind == "PID":
        beta = float(tr._morec_pi_state["beta"])
        assert abs(beta - float(jt._morec_pi_state["beta"])) < 1e-6 and 0.1 <= beta <= 1.5


# ------------------------------------------------------------------ metrics
def test_one_vs_all_morec_metrics_match_jax(env):
    from unirec_tpu.data.pipeline import make_eval_batcher as jax_eval_batcher
    from unirec_tpu_torch.data.pipeline import make_eval_batcher
    tc = _task_config(dict(env["tcfg"], valid_protocol="one_vs_all"), "valid")
    jc = jax_task_config(dict(env["jcfg"], valid_protocol="one_vs_all"), "valid")
    tb = make_eval_batcher(BaseDataset(tc, env["root"], "valid"), tc, env["th"], task="valid")
    jb = jax_eval_batcher(JaxBaseDataset(jc, env["root"], "valid"), jc, env["jh"], task="valid")
    tev = build_evaluator(env["tcfg"], env["tmodel"], "one_vs_all", tc["data_format"], "cpu")
    jev = jax_build_evaluator(env["jcfg"], env["jmodel"], "one_vs_all", jc["data_format"])
    got, ref = tev.evaluate_full(tb, env["th"]), jev.evaluate_full(jb, env["params"], env["jh"])
    assert set(got) == set(ref)
    assert {"rhit@5", "rndcg@10", "rrecall@5", "pop-kl@5", "min-hit@5", "min-rhit@10"} <= set(got)
    for m in ref:
        assert abs(got[m] - ref[m]) <= 1e-5 * max(1.0, abs(ref[m])), (m, got[m], ref[m])


@pytest.mark.parametrize("metrics", ["['rhit@1;3', 'rrecall@2;5', 'rndcg@3']",
                                     "['rndcg', 'hit@2', 'ndcg@3', 'group_auc']"])
def test_session_price_metrics_match_jax(env, metrics):
    rng = np.random.default_rng(4)
    n = 400
    sessions = rng.integers(0, 40, size=n)
    labels = (rng.uniform(size=n) < 0.3).astype(np.float32)
    scores = rng.normal(size=n).astype(np.float32)
    prices = rng.uniform(1.0, 50.0, size=n)
    cfg = dict(env["tcfg"], metrics=metrics)
    mine = SessionWiseEvaluator(cfg, env["tmodel"], "cpu").evaluate_with_scores(
        scores, labels, sessions, prices=prices)
    ref = JaxSessionWise(dict(env["jcfg"], metrics=metrics), env["jmodel"]).evaluate_with_scores(
        scores, labels, sessions, prices=prices)
    assert set(mine) == set(ref)
    for m in ref:
        assert abs(mine[m] - ref[m]) <= 1e-9 * max(1.0, abs(ref[m])), (m, mine[m], ref[m])


def test_signal_sweeps_match_jax(env):
    """gather_topk's lists and gather_per_row_loss's losses over the
    validation split read as training rows, the port against JAX."""
    tv = make_host_train_batcher(BaseDataset(env["tt"], env["root"], "valid"), env["tt"],
                                 env["th"], env["pop"])
    jv = jax_train_batcher(JaxBaseDataset(env["jt"], env["root"], "valid"), env["jt"],
                           env["jh"], env["pop"])
    tr = _torch_trainer(env, None, None)
    tr.set_user_history(env["th"])
    jt = types.SimpleNamespace(model=env["jmodel"], constants=None, user_history=env["jh"],
                               config=env["jcfg"], params=env["params"])
    ids, pos = TI.gather_topk(tr, tv, 20)
    jids, jpos = JI.gather_topk(jt, jv, 20)
    np.testing.assert_array_equal(pos, jpos)
    assert (ids[:, :10] == jids[:, :10]).mean() > 0.999
    loss, items = TI.gather_per_row_loss(tr, tv)
    jloss, jitems = JI.gather_per_row_loss(jt, jv)
    np.testing.assert_array_equal(items, jitems)
    np.testing.assert_allclose(loss, jloss, atol=1e-5)


# ---------------------------------------------------------------- main.run
@pytest.fixture(scope="module")
def pretrained(synth_dataset, tmp_path_factory):
    """tests/test_morec.py's pretrain: MF by BPR with the MoRec metrics."""
    root, _ = synth_dataset
    tmp = str(tmp_path_factory.mktemp("morec"))
    conf = copy.deepcopy(BASE_CONF)
    conf.update(model="MF", dataloader="BaseDataset", loss_type="bpr", has_user_emb=True,
                dataset_path=root, output_path=os.path.join(tmp, "pretrain"), task="train",
                epochs=3, exp_name="morec-pre", metrics=MOREC_METRICS, key_metric="ndcg@5",
                device="cpu")
    result = main.run(conf)
    return conf, os.path.join(tmp, "pretrain", "checkpoint", "morec-pre.pkl"), result, tmp


@pytest.mark.parametrize("controller", ["PID", "Static", "Pareto", "PIX", "ParetoMTL", "EPO"])
def test_morec_finetune_gates(pretrained, controller):
    """tests/test_morec.py's fine-tune and gates through the port's
    main.run, for every controller (ParetoMTL's preference vectors exist
    for 2 and 3 losses: two objectives there)."""
    conf, ckpt, pre, tmp = pretrained
    for key in ("rhit@5", "rndcg@5", "pop-kl@5", "min-hit@5"):
        assert key in pre, pre.keys()
    assert pre["hit@5"] > 0.04
    objectives = ["fairness", "revenue"] if controller == "ParetoMTL" else OBJECTIVES
    fconf = dict(conf)
    fconf.update(enable_morec=1, load_pretrained_model=True, model_file=ckpt,
                 output_path=os.path.join(tmp, f"fine-{controller}"),
                 exp_name=f"morec-fine-{controller}", morec_objectives=objectives,
                 morec_objective_controller=controller,
                 morec_objective_weights="[0.1,0.1,0.1,0.7]" if controller in ("Static", "EPO")
                 else "[0.3,0.3,0.4]",
                 morec_ngroup=5, morec_alpha=0.01, morec_lambda=0.2, morec_expect_loss=0.25,
                 morec_beta_min=0.1, morec_beta_max=1.5, morec_K_p=0.05, morec_K_i=0.001,
                 epochs=3)
    result = main.run(fconf)
    assert result is not None
    assert result["hit@5"] > 0.5 * pre["hit@5"], (pre, result)
    assert np.isfinite(result["pop-kl@5"])
    assert result["min-ndcg@5"] <= result["ndcg@5"] + 1e-9
    again = main.run({"task": "test", "model_file": os.path.join(
        tmp, f"fine-{controller}", "checkpoint", f"morec-fine-{controller}.pkl"),
        "dataset_path": conf["dataset_path"], "device": "cpu",
        "output_path": os.path.join(tmp, f"again-{controller}")})
    assert again == result


def test_cli_trains_with_morec(pretrained, capsys):
    conf, ckpt, _, tmp = pretrained
    argv = ["train", "--model", "MF", "--dataloader", "BaseDataset", "--loss_type", "bpr",
            "--has_user_emb", "1", "--dataset_path", conf["dataset_path"],
            "--output_path", os.path.join(tmp, "cli"), "--epochs", "2", "--exp_name", "cli",
            "--metrics", "['hit@5', 'rhit@5', 'pop-kl@5']", "--key_metric", "hit@5",
            "--valid_protocol", "one_vs_all", "--test_protocol", "one_vs_all",
            "--user_history_filename", "user_history", "--n_sample_neg_train", "9",
            "--enable_morec", "1", "--morec_ngroup", "5", "--device", "cpu"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "rhit@5" in out and "pop-kl@5" in out
