"""Row-sharded top-k serving of the port against the JAX package.

The port's ``sharded_catalog_topk`` and ``masked_sharded_topk`` run S
logical shards of one table in one process, and in a real 2-process gloo
group (subprocesses of this file, tests/test_torch_distributed.py's
``run_ranks``, 180 s each) with one shard a rank; JAX's run on a ``model``
= S mesh of tests/conftest.py's 8 CPU devices, its blockmax kernel in
interpret mode. Cases: with and without an item bias, an int8 catalog (the
port's quantization handed to both), an item count that S does not divide
(zero rows pad the last shard), and history exclusion. Random f32 factors
do not tie, so the ids must be equal, and the values within 1e-5.
``fused_catalog_topk`` with ``invalid_from``/``max_invalid`` is held to
JAX's the same way, and reco-topk at ``mesh_model=2`` in 2 processes
writes the JAX package's CSV byte for byte.
"""
import functools
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_distributed import run_ranks
from unirec_tpu_torch.ops import topk as T

N, D, B, K, C = 601, 16, 12, 7, 5
CASES = {"plain": {}, "bias": {"bias": True}, "int8": {"int8": True},
         "bias_int8": {"bias": True, "int8": True}}


def _inputs(case, seed=0):
    """(users [B, D], items [N, D], bias [N] or None, scale [N] or None,
    history [B, C], history lengths [B]) as numpy."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, D)).astype(np.float32)
    items = rng.standard_normal((N, D)).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32) if CASES[case].get("bias") else None
    scale = None
    if CASES[case].get("int8"):
        q, s = T.quantize_catalog(torch.from_numpy(items))
        items, scale = q.numpy(), s.numpy()
    hist = rng.integers(0, N, (B, C)).astype(np.int32)
    hlen = rng.integers(0, C + 1, B).astype(np.int32)
    return u, items, bias, scale, hist, hlen


def _port(case, S, masked, mesh=None, rank=None):
    u, items, bias, scale, hist, hlen = _inputs(case)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    table, _ = T.place_item_table(t(items), S, rank)
    b = None if bias is None else T.place_item_table(t(bias), S, rank)[0]
    sc = None if scale is None else T.place_item_table(t(scale), S, rank)[0]
    kw = dict(n_real=N, n_shards=S, item_bias=b, item_scale=sc)
    if masked:
        v, i = T.masked_sharded_topk(t(u), table, t(hist), t(hlen), K, mesh, **kw)
    else:
        v, i = T.sharded_catalog_topk(t(u), table, K, mesh, **kw)
    return v.numpy(), i.numpy()


@functools.lru_cache(maxsize=None)
def _jax(case, S, masked):
    import jax.numpy as jnp

    from unirec_tpu.core.mesh import create_mesh
    from unirec_tpu.ops import topk as JT
    u, items, bias, scale, hist, hlen = _inputs(case)
    mesh = create_mesh(data=1, model=S).mesh
    table, n_pad = JT.place_item_table(jnp.asarray(items), mesh)
    pad = lambda a: None if a is None else jnp.concatenate(  # noqa: E731
        [jnp.asarray(a), jnp.zeros(n_pad - N, jnp.float32)])
    kw = dict(item_bias=pad(bias), n_real=N, item_scale=pad(scale))
    if masked:
        v, i = JT.masked_sharded_topk(jnp.asarray(u), table, jnp.asarray(hist),
                                      jnp.asarray(hlen), K, mesh, **kw)
    else:
        v, i = JT.sharded_catalog_topk(jnp.asarray(u), table, K, mesh, **kw)
    return np.asarray(v), np.asarray(i)


def _agree(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "history"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("S", [2, 4])
def test_logical_shards_match_jax(S, case, masked):
    _agree(_port(case, S, masked), _jax(case, S, masked))


def test_logical_shards_match_the_unsharded_top_k():
    """The 4 shards' merge equals fused_catalog_topk over the whole table,
    history excluded."""
    u, items, _, _, hist, hlen = _inputs("plain")
    t = torch.from_numpy
    want = T.fused_catalog_topk(t(u), t(items), K, hist_items=t(hist), hist_len=t(hlen),
                                exclude_pad_item=True)
    got = _port("plain", 4, True)
    np.testing.assert_array_equal(got[1], want[1].numpy())


@pytest.mark.parametrize("invalid_from", [N, 580, 0])
def test_fused_catalog_topk_invalid_from_matches_jax(invalid_from):
    """Rows from ``invalid_from`` on are banned, at most ``max_invalid`` of
    them; the blockmax pass runs (N > 4 k 16). With every row banned the
    values are all -inf in both and the order of the ids is arbitrary."""
    import jax.numpy as jnp

    from unirec_tpu.ops import topk as JT
    u, items, *_ = _inputs("plain", seed=1)
    mi = N - invalid_from
    v, i = T.fused_catalog_topk(torch.from_numpy(u), torch.from_numpy(items), K,
                                invalid_from=invalid_from, max_invalid=mi)
    jv, ji = JT.fused_catalog_topk(jnp.asarray(u), jnp.asarray(items), K,
                                   invalid_from=jnp.asarray(invalid_from), max_invalid=mi,
                                   interpret=True)
    if invalid_from:
        _agree((v.numpy(), i.numpy()), (np.asarray(jv), np.asarray(ji)))
        assert (i.numpy() < invalid_from).all()
    else:
        assert np.isneginf(v.numpy()).all() and np.isneginf(np.asarray(jv)).all()


# ------------------------------------------------------ two ranks, gloo
@pytest.fixture(scope="module")
def served(synth_dataset, tmp_path_factory):
    """A SASRec checkpoint the JAX package writes: 4,096 items (only the
    first 300 in histories), an item bias, f32 (tests/test_torch_reco_topk.py's)."""
    import jax
    import jax.numpy as jnp

    from unirec_tpu import config as jax_config
    from unirec_tpu.utils import checkpoint as jax_ckpt
    from unirec_tpu.utils.registry import get_model_class as jax_model_class
    root, _ = synth_dataset
    out = tmp_path_factory.mktemp("sharded")
    cfg = jax_config.parse_arguments(dict(
        model="SASRec", dataset_path=root, n_items=4096, embedding_size=16, n_heads=2,
        inner_size=32, n_layers=2, max_seq_len=12, init_std=0.1, compute_dtype="float32",
        has_item_bias=1, test_batch_size=64, user_history_filename="user_history"),
        argv=[])
    model = jax_model_class("SASRec")(cfg=cfg)
    batch = {"item_seq": jnp.ones((2, 12), jnp.int32), "user_id": jnp.zeros(2, jnp.int32),
             "item_id": jnp.zeros(2, jnp.int32), "label": jnp.zeros(2)}
    params = model.init(jax.random.PRNGKey(11), batch, train=False)["params"]
    ckpt = str(out / "sasrec.pkl")
    jax_ckpt.save_checkpoint(ckpt, {"config": cfg, "params": params})
    ids_file = str(out / "users.txt")
    np.savetxt(ids_file, np.arange(1, 201), fmt="%i")
    return {"model_file": ckpt, "dataset_path": root, "dataset_name": ids_file,
            "user_history_filename": "user_history", "topk": 10}, out


@pytest.fixture(scope="module")
def two_ranks(served):
    base, out = served
    run_ranks("tests.test_torch_sharded_topk", "ranks", out, 2, base["model_file"],
              base["dataset_path"], base["dataset_name"])
    res = []
    for r in range(2):
        with open(out / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


@pytest.mark.parametrize("masked", [False, True], ids=["all", "history"])
@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_jax(two_ranks, case, masked):
    want = _jax(case, 2, masked)
    for r in two_ranks:
        _agree(r[(case, masked)], want)


@pytest.mark.parametrize("int8", [0, 1])
def test_reco_topk_mesh_model_2_writes_the_jax_csv(served, two_ranks, int8):
    """Rank 0 writes the CSV (rank 1 none); the JAX package's reco-topk at
    mesh_model=2 (its sharded path) on the same checkpoint writes the same
    bytes."""
    from unirec_tpu.main import reco_topk as jax_reco
    base, out = served
    jax_csv = out / f"jax_{int8}.csv"
    jax_reco.do_topk_reco(dict(base, mesh_model=2, catalog_int8=int8,
                               output_path=str(jax_csv)))
    assert open(out / f"torch_{int8}.csv").read() == open(jax_csv).read()
    assert len(open(jax_csv).read().splitlines()) == 200


def _ranks_main():
    """A rank: ``ranks <out> <checkpoint> <dataset dir> <user id file>``."""
    out, ckpt, root, users = sys.argv[2:6]
    torch.set_num_threads(1)
    from unirec_tpu_torch.core.distributed import initialize_distributed
    from unirec_tpu_torch.core.mesh import create_mesh
    from unirec_tpu_torch.main import reco_topk
    assert initialize_distributed({}, "cpu")
    import torch.distributed as dist
    rank = dist.get_rank()
    mesh = create_mesh(data=1, model=2, device="cpu")
    result = {(case, masked): _port(case, 2, masked, mesh, mesh.rank("model"))
              for case in CASES for masked in (False, True)}
    for int8 in (0, 1):
        reco_topk.do_topk_reco(dict(model_file=ckpt, dataset_path=root, dataset_name=users,
                                    user_history_filename="user_history", topk=10,
                                    mesh_model=2, catalog_int8=int8,
                                    output_path=os.path.join(out, f"torch_{int8}.csv")),
                               device="cpu")
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    dist.destroy_process_group()


if __name__ == "__main__" and sys.argv[1] == "ranks":
    _ranks_main()
