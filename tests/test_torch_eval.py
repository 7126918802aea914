"""The port's datasets, eval batchers and evaluators against the JAX package
(one_vs_k, one_vs_all with one and with several positives, session_aware).

The synthetic dataset of tests/synth.py, a small SASRec in the slice's
configuration (use_fused_attention, use_fused_ffn, last_query_only) at f32
with the same weights in both packages (flax bridge). The eval batches are
built with the same numpy generators, so they must be identical, sampled
negatives included. Metrics: the tie noise of the two frameworks differs,
but the f32 scores are continuous and the noise (1e-8) breaks no rank
between them, so each metric must agree to 1e-5 (an f32 score difference
flipping one rank would move a metric by 1/200). The session-wise
reduction is numpy in both packages, the same noise from the same seed, so
its metrics agree to 1e-6.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synth import BASE_CONF
from unirec_tpu import config as jax_config
from unirec_tpu.data.datasets import SeqRecDataset as JaxSeqRecDataset
from unirec_tpu.data.history import UserHistory as JaxHistory
from unirec_tpu.data.pipeline import make_eval_batcher as jax_eval_batcher
from unirec_tpu.facility.evaluation import build_evaluator as jax_build_evaluator
from unirec_tpu.facility.evaluation.evaluators import SessionWiseEvaluator as JaxSessionWise
from unirec_tpu.main.main import _task_config as jax_task_config
from unirec_tpu.utils.registry import get_model_class as jax_model_class
from unirec_tpu_torch import config as torch_config
from unirec_tpu_torch.data.datasets import SeqRecDataset, get_dataset_class
from unirec_tpu_torch.data.history import UserHistory
from unirec_tpu_torch.data.pipeline import make_eval_batcher
from unirec_tpu_torch.facility.evaluation import (MultiPositiveEvaluator, SessionWiseEvaluator,
                                                  build_evaluator)
from unirec_tpu_torch.main.main import _task_config
from unirec_tpu_torch.utils.flax_bridge import load_flax_params
from unirec_tpu_torch.utils.registry import get_model_class

ARGS = dict(BASE_CONF, model="SASRec", dataloader="SeqRecDataset", embedding_size=16,
            hidden_size=16, n_layers=2, n_heads=2, inner_size=32, use_fused_attention=1,
            use_fused_ffn=1, last_query_only=1, compute_dtype="float32",
            n_sample_neg_valid=20, test_batch_size=64,
            metrics="['group_auc', 'hit@1;5;10', 'ndcg@5;10', 'mrr', 'mrr@5', 'ndcg']")


@pytest.fixture(scope="module")
def pair(synth_dataset):
    """(port config, port model, JAX config, JAX model, JAX params, path)."""
    root, _ = synth_dataset
    args = dict(ARGS, dataset_path=root)
    jcfg = jax_config.parse_arguments(copy.deepcopy(args), argv=[])
    tcfg = torch_config.parse_arguments(copy.deepcopy(args), argv=[], device="cpu")
    jmodel = jax_model_class("SASRec")(cfg=jcfg)
    batch = {"item_seq": jnp.ones((2, 10), jnp.int32), "user_id": jnp.ones(2, jnp.int32),
             "item_id": jnp.ones(2, jnp.int32), "label": jnp.ones(2)}
    params = jmodel.init(jax.random.PRNGKey(1), batch, train=False)["params"]
    tmodel = get_model_class("SASRec")(tcfg)
    load_flax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return tcfg, tmodel, jcfg, jmodel, params, root


def _histories(tcfg, jcfg, root):
    prefix = f"{root}/user_history"
    return (UserHistory.load(prefix, int(tcfg["n_users"]), "user-item_seq"),
            JaxHistory.load(prefix, int(jcfg["n_users"]), "user-item_seq"))


def _batchers(pair, task, protocol, fname=None, fmt=None):
    tcfg, _, jcfg, _, _, root = pair
    th, jh = _histories(tcfg, jcfg, root)
    out = []
    for cfg, task_config, ds_cls, make, hist in (
            (tcfg, _task_config, SeqRecDataset, make_eval_batcher, th),
            (jcfg, jax_task_config, JaxSeqRecDataset, jax_eval_batcher, jh)):
        c = task_config(dict(cfg, **{f"{task}_protocol": protocol}), task)
        if fmt:
            c["data_format"] = fmt
        out.append((make(ds_cls(c, root, fname or task), c, hist, task=task), c, hist))
    return out


@pytest.mark.parametrize("protocol", ["one_vs_k", "one_vs_all"])
def test_eval_batches_equal_jax(pair, protocol):
    (tb, _, _), (jb, _, _) = _batchers(pair, "valid", protocol)
    assert len(tb) == len(jb) == 4
    for a, b in zip(tb, jb):
        assert set(a) == set(b) - {"reparam_seed"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if protocol == "one_vs_k":
        assert a["item_id"].shape == (64, 21) and (a["label"][:, 0] == 1).all()


@pytest.mark.parametrize("protocol", ["one_vs_k", "one_vs_all"])
def test_evaluator_matches_jax(pair, protocol):
    tcfg, tmodel, jcfg, jmodel, params, _ = pair
    (tb, tc, th), (jb, jc, jh) = _batchers(pair, "valid", protocol)
    tev = build_evaluator(tcfg, tmodel, protocol, tc["data_format"], "cpu")
    jev = jax_build_evaluator(jcfg, jmodel, protocol, jc["data_format"])
    if protocol == "one_vs_all":
        got, ref = tev.evaluate_full(tb, th), jev.evaluate_full(jb, params, jh)
    else:
        got, ref = tev.evaluate(tb), jev.evaluate(jb, params)
    assert set(got) == set(ref) and len(got) == 9
    for m in ref:
        assert abs(got[m] - ref[m]) <= 1e-5, (m, got[m], ref[m])
    assert 0.0 < got["group_auc"] < 1.0


MULTIPOS_METRICS = {"slice": ARGS["metrics"],
                    "recall": "['group_auc', 'hit@3', 'recall@1;5;20', 'ndcg@20', 'mrr@20']"}


@pytest.mark.parametrize("metrics", sorted(MULTIPOS_METRICS))
def test_multi_positive_evaluator_matches_jax(pair, metrics):
    """test_multipos (T5 rows, two positives per user) under one_vs_all: the
    port builds the same eval batches as the JAX package, and its
    multi-positive evaluator gives JAX evaluate_full's metrics (the @k ones
    and group_auc) within 1e-5."""
    tcfg, tmodel, jcfg, jmodel, params, _ = pair
    spec = MULTIPOS_METRICS[metrics]
    tcfg, jcfg = dict(tcfg, metrics=spec), dict(jcfg, metrics=spec)
    (tb, _, th), (jb, _, jh) = _batchers(pair, "test", "one_vs_all", "test_multipos",
                                         "user-item_seq")
    for a, b in zip(tb, jb):
        assert a["item_id"].ndim == 2
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    tev = build_evaluator(tcfg, tmodel, "one_vs_all", "user-item_seq", "cpu")
    assert isinstance(tev, MultiPositiveEvaluator)
    got = tev.evaluate_full(tb, th)
    ref = jax_build_evaluator(jcfg, jmodel, "one_vs_all", "user-item_seq").evaluate_full(
        jb, params, jh)
    assert set(got) == set(ref) and "group_auc" in got and "mrr" not in got
    for m in ref:
        assert abs(got[m] - ref[m]) <= 1e-5, (m, got[m], ref[m])
    assert 0.0 < got["group_auc"] < 1.0


def _session_table(seed, n_sessions=40):
    """Ragged sessions (1-9 rows, ids out of order), some all positive or
    all negative, scores with exact ties inside sessions."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 10, n_sessions)
    sid = np.repeat(rng.permutation(n_sessions) * 7 + 3, sizes)
    labels = (rng.random(len(sid)) < 0.35).astype(np.float32)
    scores = np.round(rng.normal(size=len(sid)), 1).astype(np.float32)
    order = rng.permutation(len(sid))
    return scores[order], labels[order], sid[order]


SESSION_METRICS = "['group_auc', 'ndcg', 'mrr', 'hit@1;3', 'recall@2;5', 'ndcg@3;5', 'mrr@3']"


@pytest.mark.parametrize("seed", [0, 1])
def test_session_wise_metrics_match_jax_on_given_scores(seed):
    cfg = {"metrics": SESSION_METRICS, "seed": 5, "n_items": 10}
    scores, labels, sid = _session_table(seed)
    got = SessionWiseEvaluator(cfg, None, "cpu").evaluate_with_scores(scores, labels, sid)
    ref = JaxSessionWise(cfg, None).evaluate_with_scores(scores, labels, sid)
    assert set(got) == set(ref) and len(got) == 10
    for m in ref:
        assert abs(got[m] - ref[m]) <= 1e-6, (m, got[m], ref[m])


def test_session_wise_evaluator_matches_jax_through_predict(pair):
    """test_session (T2_1: one positive and four random negatives a user's
    session) under session_aware: scores from model.predict, grouped by
    session; the port's metrics equal JAX's within 1e-6."""
    tcfg, tmodel, jcfg, jmodel, params, _ = pair
    tcfg, jcfg = dict(tcfg, metrics=SESSION_METRICS), dict(jcfg, metrics=SESSION_METRICS)
    (tb, _, _), (jb, _, _) = _batchers(pair, "test", "session_aware", "test_session",
                                       "user-item-label-session")
    assert tb.ds.cols["session_id"].shape == tb.ds.cols["label"].shape == (1000,)
    got = build_evaluator(tcfg, tmodel, "session_aware", None, "cpu").evaluate(tb)
    ref = jax_build_evaluator(jcfg, jmodel, "session_aware", None).evaluate(jb, params)
    assert set(got) == set(ref) and len(got) == 10
    for m in ref:
        assert abs(got[m] - ref[m]) <= 1e-6, (m, got[m], ref[m])
    assert 0.0 < got["group_auc"] < 1.0


def test_global_auc_matches_jax(pair):
    tcfg, tmodel, jcfg, jmodel, params, _ = pair
    tcfg, jcfg = dict(tcfg, metrics="['auc', 'hit@5']"), dict(jcfg, metrics="['auc', 'hit@5']")
    (tb, tc, _), (jb, jc, _) = _batchers(pair, "valid", "one_vs_k")
    got = build_evaluator(tcfg, tmodel, "one_vs_k", tc["data_format"], "cpu").evaluate(tb)
    ref = jax_build_evaluator(jcfg, jmodel, "one_vs_k", jc["data_format"]).evaluate(jb, params)
    assert set(got) == {"auc", "hit@5"}
    assert abs(got["auc"] - ref["auc"]) <= 1e-5


def test_evaluation_repeats_exactly(pair):
    """Fresh batchers (a batcher's autoregressive cut draws from its epoch's
    generator) and the evaluator's fresh tie-noise generator: the same
    weights give the same metrics, bit for bit."""
    tcfg, tmodel, *_ = pair
    runs = []
    for _ in range(2):
        (tb, tc, th), _ = _batchers(pair, "valid", "one_vs_all")
        ev = build_evaluator(tcfg, tmodel, "one_vs_all", tc["data_format"], "cpu")
        runs.append(ev.evaluate_full(tb, th))
    assert runs[0] == runs[1]


def test_unported_protocols_and_metrics_raise(pair):
    """The MoRec metrics are ported (tests/test_torch_morec.py): one-vs-all
    takes them as its MoRec family, the session protocol its price-weighted
    ones; an unknown protocol still raises."""
    tcfg, tmodel, *_ = pair
    ev = build_evaluator(dict(tcfg, metrics="['hit@5', 'rhit@5', 'pop-kl@5', 'rndcg']"),
                         tmodel, "one_vs_all", None, "cpu")
    assert ev.morec_names == ["rhit@5", "pop-kl@5"] and ev.base_names == ["hit@5"]
    for m in ("rhit@5", "rrecall@5", "rndcg"):   # the price-weighted session metrics
        ev = build_evaluator(dict(tcfg, metrics=f"['{m}']"), tmodel, "session_aware",
                             "user-item-label-session", "cpu")
        assert isinstance(ev, SessionWiseEvaluator) and ev._need_prices
    with pytest.raises(ValueError):
        build_evaluator(tcfg, tmodel, "bogus", None, "cpu")
    # RankDataset and the solvers (evaluated from their closed-form scores,
    # tests/test_torch_solvers.py) are ported
    assert get_dataset_class("RankDataset").__name__ == "RankDataset"
    from unirec_tpu_torch.utils.registry import get_model_class
    assert get_model_class("EASE").optimized_by_sgd is False


def test_predict_matches_jax(pair):
    """Grouped scores of the one-vs-k batch: the port's model.predict against
    the JAX model's, f32 to 1e-5."""
    tcfg, tmodel, jcfg, jmodel, params, _ = pair
    (tb, _, _), _ = _batchers(pair, "valid", "one_vs_k")
    batch = next(iter(tb))
    ref = jmodel.apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()},
                       method="predict")
    with torch.no_grad():
        got = tmodel.predict({k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
