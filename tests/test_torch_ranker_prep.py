"""The port's AdaRanker data builder and item2vec pretraining
(data/ranker_prep.py) and ``cli prepare-adaranker`` against the JAX
package's (unirec_tpu/data/ranker_prep.py, tests/test_ranker_prep.py).

- ``build_adaranker_dataset`` writes the same files as the JAX package's
  from one seed: every split's pkl and text twin, the histories and
  data.info, byte for byte where they are text.
- ``distribution_mixer_sample`` draws the JAX function's negatives from
  the same numpy generator, and never the target, an excluded item or a
  duplicate.
- ``pretrain_item2vec`` (a torch SGD loop, its own generator) learns the
  co-occurrence of two disjoint item cliques as tests/test_ranker_prep.py
  holds the JAX one to, and its (center, context) pairs are the JAX
  loop's as a multiset.
- ``cli prepare-adaranker`` builds a dataset with item2vec rows on the CPU
  that ``main.run`` trains an AdaRanker on with ``use_pre_item_emb``.
"""
import json
import os
from collections import Counter

import numpy as np
import pandas as pd
import pytest
import torch

from tests.test_ranker_prep import _raw
from unirec_tpu.data import ranker_prep as JRP
from unirec_tpu_torch.data import ranker_prep as RP


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op torch thread: six xdist workers with eight-thread teams
    each stall small ops by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed,n_neg_k", [(1, 5), (7, 19)])
def test_build_adaranker_dataset_writes_the_jax_files(tmp_path, seed, n_neg_k):
    infile, catefile = _raw(tmp_path, n_users=40, n_items=70, seed=seed)
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    info = RP.build_adaranker_dataset(infile, catefile, ours, n_neg_k=n_neg_k, seed=seed)
    assert info == JRP.build_adaranker_dataset(infile, catefile, ref, n_neg_k=n_neg_k, seed=seed)
    assert sorted(os.listdir(ours)) == sorted(os.listdir(ref))
    for name in os.listdir(ref):
        if name.endswith(".pkl"):
            a, b = pd.read_pickle(os.path.join(ours, name)), pd.read_pickle(os.path.join(ref, name))
            assert list(a.columns) == list(b.columns) and len(a) == len(b) > 0
            for col in b.columns:
                for x, y in zip(a[col], b[col]):
                    np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        else:
            with open(os.path.join(ours, name), "rb") as f, \
                    open(os.path.join(ref, name), "rb") as g:
                assert f.read() == g.read(), name
    train = pd.read_pickle(os.path.join(ours, "train.pkl"))
    assert np.stack(train["item_id_list"].to_numpy()).shape[1] == 1 + n_neg_k


def test_distribution_mixer_rejects_exclusions_as_jax_does():
    pop = {1: np.array([2, 2, 3, 4, 5]), 2: np.array([6, 7, 8])}
    uni = {c: np.unique(v) for c, v in pop.items()}
    ours, ref = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(40):
        kw = dict(target=3, n_cates=2, cate2items_pop=pop, cate2items_uni=uni, n_neg=3,
                  exclude=[4])
        negs = RP.distribution_mixer_sample(ours, 1, **kw)
        assert negs == JRP.distribution_mixer_sample(ref, 1, **kw)
        assert 3 not in negs and 4 not in negs
        assert len(negs) == len(set(negs))


def test_item2vec_pairs_are_the_jax_loops():
    rng = np.random.default_rng(0)
    hists = [rng.integers(1, 30, size=rng.integers(1, 25)) for _ in range(20)]
    hists[3][2] = 0
    window = 4
    want = Counter()
    for h in hists:
        for i in range(len(h)):
            for j in range(max(0, i - window), min(len(h), i + window + 1)):
                if j != i and h[i] > 0 and h[j] > 0:
                    want[(int(h[i]), int(h[j]))] += 1
    c, x = RP._pairs(hists, window)
    assert Counter(zip(c.tolist(), x.tolist())) == want


def test_pretrain_item2vec_learns_cooccurrence(tmp_path):
    """Two disjoint cliques: within-clique cosine beats across-clique by 0.2
    (tests/test_ranker_prep.py:66), the file in the reference's layout."""
    rng = np.random.default_rng(0)
    a, b = np.arange(1, 7), np.arange(7, 13)
    hists = [rng.permutation(a) for _ in range(60)] + [rng.permutation(b) for _ in range(60)]
    out = str(tmp_path / "item_emb_16.txt")
    emb = RP.pretrain_item2vec(hists, n_items=13, dim=16, epochs=40, lr=0.1, batch_size=256,
                               out_path=out, device="cpu")

    def sim(i, j):
        x, y = emb[i], emb[j]
        return float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y) + 1e-9))

    within = np.mean([sim(i, j) for i in a for j in a if i != j])
    across = np.mean([sim(i, j) for i in a for j in b])
    assert within > across + 0.2, (within, across)
    assert not emb[0].any()
    lines = open(out).read().splitlines()
    assert len(lines) == 12 and len(lines[0].split("\t")[1].split(",")) == 16


def test_cli_prepare_adaranker_then_train_on_it(tmp_path):
    """The reference workflow (ada-ranker/run_adaranker_pipeline) through
    the port's surfaces: build, pretrain item2vec, train an AdaRanker from
    the pretrained item rows."""
    import copy

    from tests.synth import BASE_CONF
    from unirec_tpu_torch import cli
    from unirec_tpu_torch.main import main

    infile, catefile = _raw(tmp_path, n_users=60, n_items=80, seed=3)
    out = str(tmp_path / "ds")
    assert cli.main(["prepare-adaranker", "--infile", infile, "--item2cate_file", catefile,
                     "--out_dir", out, "--n_neg_k", "5", "--pretrain_item_emb", "1",
                     "--embedding_size", "16", "--device", "cpu"]) == 0
    emb_file = os.path.join(out, "item_emb_16.txt")
    info = json.load(open(os.path.join(out, "data.info")))
    assert len(open(emb_file).read().splitlines()) == info["n_items"] - 1
    conf = copy.deepcopy(BASE_CONF)
    conf.update(model="AdaRanker", dataloader="SeqRecDataset", train_type="Ada-Ranker",
                base_model="GRU", dataset_path=out, task="train", epochs=2,
                n_sample_neg_train=0, group_size=-1, valid_protocol="one_vs_k",
                test_protocol="one_vs_k", metrics="['auc','group_auc']", key_metric="auc",
                embedding_size=16, hidden_size=16, max_seq_len=8, use_pre_item_emb=1,
                item_emb_path=emb_file, exp_name="ada-prep", output_path=str(tmp_path / "run"),
                device="cpu")
    res = main.run(conf)
    assert 0.0 <= res["auc"] <= 1.0 and 0.0 <= res["group_auc"] <= 1.0
