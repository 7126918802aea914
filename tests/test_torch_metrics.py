"""unirec_tpu_torch/ops/metrics.py against unirec_tpu/ops/metrics.py.

The same score matrices go through both packages. The tie noise is the
JAX package's, drawn from its key and injected into the port (the two
frameworks draw different numbers from one seed). Scores are small
integers, so ties are common and only the noise breaks them; ranks must
then be equal, and the per-row metric values equal to 1e-6 (f32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unirec_tpu.ops import metrics as JM
from unirec_tpu_torch.ops import metrics as M

NAMES = ("group_auc", "ndcg", "mrr", "hit@1", "hit@5", "ndcg@3", "ndcg@10",
         "mrr@5", "recall@10")


def _jax_noise(key, shape):
    return np.array(jax.random.uniform(key, shape, minval=-JM.TIE_NOISE,
                                       maxval=JM.TIE_NOISE, dtype=jnp.float32))


@pytest.fixture
def same_noise(monkeypatch):
    """Make the port add exactly the noise the JAX function adds for key."""
    def inject(key, shape):
        noise = torch.from_numpy(_jax_noise(key, shape))
        monkeypatch.setattr(M, "add_tie_noise", lambda s, gen: s + noise.to(s.dtype))
    return inject


def _case(B=40, N=60, cap=12, seed=0):
    rng = np.random.default_rng(seed)
    scores = rng.integers(0, 4, (B, N)).astype(np.float32) * 1e-7   # many ties
    pos = rng.integers(1, N, B).astype(np.int32)
    hist = rng.integers(0, N, (B, cap)).astype(np.int32)
    hist[:4, 0] = pos[:4]                         # a positive that is in the history
    hlen = rng.integers(0, cap + 1, B).astype(np.int32)
    return scores, pos, hist, hlen


@pytest.mark.parametrize("spec", ["['hit@5;10', 'ndcg@5;10']", "['group_auc', 'mrr@1;3;5']",
                                  ["auc", "ndcg"]])
def test_parse_metrics_matches_jax(spec):
    assert M.parse_metrics(spec) == JM.parse_metrics(spec)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_full_catalog_rank_matches_jax(same_noise, seed):
    scores, pos, hist, hlen = _case(seed=seed)
    key = jax.random.PRNGKey(seed)
    same_noise(key, scores.shape)
    ref, _ = JM.onepos_rank_full_catalog(jnp.asarray(scores), jnp.asarray(pos),
                                         jnp.asarray(hist), jnp.asarray(hlen), key)
    got = M.onepos_rank_full_catalog(torch.from_numpy(scores), torch.from_numpy(pos),
                                     torch.from_numpy(hist), torch.from_numpy(hlen), None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n_scores", [10, 60])
def test_onepos_metrics_match_jax(n_scores):
    rank = np.random.default_rng(3).integers(0, n_scores, 64).astype(np.int32)
    ref = JM.onepos_metrics(jnp.asarray(rank), n_scores, NAMES)
    got = M.onepos_metrics(torch.from_numpy(rank), n_scores, NAMES)
    assert set(got) == set(ref)
    for m in NAMES:
        np.testing.assert_allclose(got[m].numpy(), np.asarray(ref[m]), atol=1e-6, err_msg=m)


def test_group_rank_matches_jax():
    scores = np.random.default_rng(4).integers(0, 3, (30, 10)).astype(np.float32)
    noisy = scores + _jax_noise(jax.random.PRNGKey(5), scores.shape)
    np.testing.assert_array_equal(
        M.onepos_rank_from_group(torch.from_numpy(noisy)).numpy(),
        np.asarray(JM.onepos_rank_from_group(jnp.asarray(noisy))))


@pytest.mark.parametrize("names", [("hit@5", "recall@5", "ndcg@10", "mrr@10"),
                                   ("group_auc", "ndcg@3")])
def test_multipos_metrics_match_jax(same_noise, names):
    scores, _, hist, hlen = _case(seed=6)
    scores = scores + np.random.default_rng(7).normal(size=scores.shape).astype(np.float32)
    pos = np.random.default_rng(8).integers(1, 60, (40, 3)).astype(np.int32)
    pos[::5, 2] = 0                                # padded positive slots
    key = jax.random.PRNGKey(9)
    same_noise(key, scores.shape)
    ref = JM.multipos_topk_and_metrics(jnp.asarray(scores), jnp.asarray(pos),
                                       jnp.asarray(hist), jnp.asarray(hlen), names, 10, key)
    got = M.multipos_topk_and_metrics(torch.from_numpy(scores), torch.from_numpy(pos),
                                      torch.from_numpy(hist), torch.from_numpy(hlen),
                                      names, 10, None)
    for m in names:
        np.testing.assert_allclose(got[m].numpy(), np.asarray(ref[m]), atol=1e-6, err_msg=m)


def test_roc_auc_matches_jax_with_ties():
    rng = np.random.default_rng(10)
    labels = rng.integers(0, 2, 500)
    scores = rng.integers(0, 20, 500).astype(np.float64)
    assert M.roc_auc(labels, scores) == pytest.approx(JM.roc_auc(labels, scores), abs=1e-12)
    assert np.isnan(M.roc_auc(np.ones(4), np.arange(4.0)))


def test_tie_noise_is_small_and_seeded():
    s = torch.zeros(50, 70)
    a = M.add_tie_noise(s, torch.Generator().manual_seed(2022 + 202))
    b = M.add_tie_noise(s, torch.Generator().manual_seed(2022 + 202))
    assert torch.equal(a, b) and float(a.abs().max()) <= M.TIE_NOISE
    assert len(torch.unique(a)) > 3000            # ties broken
