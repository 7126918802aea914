"""Distribution in the port against one process and against the JAX package.

The port runs one process a device on torch.distributed. Here the
processes are subprocesses of this file on the CPU over gloo
(``python -m tests.test_torch_distributed <case> <out dir>``, two ranks,
each with a 180 s timeout); the JAX side runs in the test process on
tests/conftest.py's 8 forced CPU devices, its Pallas kernels in interpret
mode. Every model is f32, at dropout 0 unless a test says otherwise. Tolerances: parameters after 3
steps within rel 1e-5 (+ 1e-6) of the one-process run (the ranks'
gradients are summed in another order), both ranks bit-identical, step 1's loss within
rel 1e-5 of the JAX package's at ``mesh_data=2``; main.run's metrics within
1e-6 of one process's (tests/test_multiprocess.py:89-94 asks as much of
JAX); checkpoints within rel 1e-5 of the one-process tensors.

- the placement rules: ``shard_rule`` shards the tables JAX's
  ``MeshContext.param_shardings`` shards on the same tree, and
  ``shard_batch`` keeps the rows and zero-weight padding of JAX's;
- data-parallel SASRec (``mesh_data=2``) through the fused layers' plain
  versions; then one rank's loss made non-finite: both ranks skip the step;
- data parallelism at dropout 0.3 (the fused layers, fused attention with
  the unfused layers' plain dropout, MultiVAE's noise) against one process;
- MF with BPR at ``mesh_model=2`` with ``shard_embeddings`` (as
  tests/test_distributed.py:42-52): the sharded tables' lookup and gather,
  their row-6 backward, gradient clipping by the global norm; the pickle it
  writes loads in both packages, its ``.dcp`` directory in one process;
  a JAX ``.orbax`` directory is refused by name, its pickle conversion read;
- main.run(task=train), then task=test from the checkpoint, at
  ``mesh_data=2``; the CLI under torchrun;
- MoRec at ``mesh_data=2`` is refused by name.
"""
import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 180
N_USERS, N_ITEMS, CAP, B, STEPS = 60, 80, 24, 32, 3
SASREC = dict(model="SASRec", n_users=N_USERS, n_items=N_ITEMS, embedding_size=16,
              hidden_size=16, n_heads=2, inner_size=32, n_layers=2, max_seq_len=10,
              loss_type="bce", n_sample_neg_train=3, dataloader="SeqRecDataset",
              history_mask_mode="autoregressive", last_query_only=1, fused_layer=1,
              fused_lastq=1, vmem_embedding_grad=1, neg_membership_pallas=1,
              hidden_dropout_prob=0.0, attn_dropout_prob=0.0, learning_rate=1e-2,
              compute_dtype="float32", group_size=-1, seed=3, exp_name="dist")
# dropout on: rows 1-4 (the fused layers), rows 10-11 (fused attention, the
# unfused layers' plain dropout), MultiVAE's dropout and training noise
DROPOUT = {
    "fused_layer": dict(SASREC, hidden_dropout_prob=0.3, attn_dropout_prob=0.3),
    "fused_attention": dict(SASREC, hidden_dropout_prob=0.3, attn_dropout_prob=0.3,
                            last_query_only=0, fused_layer=0, fused_lastq=0,
                            use_fused_attention=1),
    "MultiVAE": dict(model="MultiVAE", dataloader="AERecDataset", n_users=N_USERS,
                     n_items=N_ITEMS, embedding_size=16, encoder_dims=[16],
                     decoder_dims=[16], dropout_prob=0.3, learning_rate=1e-2,
                     compute_dtype="float32", group_size=-1, seed=5, exp_name="vae"),
}
MF = dict(model="MF", dataloader="BaseDataset", n_users=N_USERS, n_items=N_ITEMS,
          embedding_size=16, has_user_emb=1, loss_type="bpr", n_sample_neg_train=3,
          optimizer="sgd", learning_rate=0.5, compute_dtype="float32", group_size=-1,
          seed=4, shard_embeddings=1, shard_min_rows=8, grad_clip_value=0.005,
          exp_name="mf")


# ------------------------------------------------------------- the ranks
def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(module: str, case: str, out, n: int = 2, *args) -> None:
    """``python -m <module> <case> <out> <args>`` as ``n`` ranks of one gloo
    group on this machine; each must exit 0 within RANK_TIMEOUT."""
    port = free_port()
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(n), PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", module, case, str(out), *map(str, args)],
                              cwd=ROOT, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"


def _history(seed=0):
    from unirec_tpu_torch.data.history import UserHistory
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, CAP + 1, N_USERS).astype(np.int32)
    items = np.zeros((N_USERS, CAP), np.int32)
    m = np.arange(CAP)[None] < lens[:, None]
    items[m] = rng.integers(1, N_ITEMS, int(m.sum()))
    return UserHistory(items, lens)


def _raw_batches(seed=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        w = np.ones(B, np.float32)
        w[-3:] = 0.0                                    # padded rows
        out.append({"user_id": rng.integers(1, N_USERS, B).astype(np.int32),
                    "item_id": rng.integers(1, N_ITEMS, B).astype(np.int32),
                    "weight": w})
    return out


def _trainer(args, tmp):
    from unirec_tpu_torch import config as torch_config
    from unirec_tpu_torch.data.device_pipeline import DeviceAugmenter
    from unirec_tpu_torch.facility.trainer import Trainer
    from unirec_tpu_torch.utils.registry import get_model_class
    cfg = torch_config.parse_arguments(dict(args, output_path=str(tmp)), argv=[],
                                       device="cpu")
    tr = Trainer(cfg, get_model_class(cfg["model"])(cfg), device="cpu")
    tr.set_device_augmenter(DeviceAugmenter(cfg, _history(), device="cpu",
                                            aerec=cfg["model"] == "MultiVAE"))
    tr.init_params()
    return tr


def _steps(tr, capture=None):
    """STEPS train steps on the raw batches; returns the losses. With
    ``capture`` a list, step 1's gradients (the summed ones, before the
    optimizer; a sharded table's rows) are appended to it."""
    from unirec_tpu_torch.utils import to_device
    apply = tr.apply_update

    def spy(loss, grads):
        if capture is not None and not capture:
            capture.append(list(grads))
        return apply(loss, grads)

    tr.apply_update = spy
    losses = [float(tr.train_step(to_device(tr.mesh.pad_batch(b), "cpu")))
              for b in _raw_batches()]
    tr.apply_update = apply
    return losses


def _flat_params(tr):
    from unirec_tpu_torch.utils.flax_bridge import to_flax_params
    return dict(_flat(to_flax_params(tr.model)))


def _flat(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float32)


def _rank_main():
    """A rank: ``<case> <out dir> [dataset dir]``."""
    case, out = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    from unirec_tpu_torch.core.distributed import initialize_distributed
    assert initialize_distributed({}, "cpu")
    import torch.distributed as dist
    rank = dist.get_rank()
    result = {}
    if case == "dp":
        tr = _trainer(dict(SASREC, mesh_data=2), out)
        result["losses"] = _steps(tr)
        result["params"] = _flat_params(tr)
        # one rank's loss made non-finite: the summed loss is NaN on both
        # ranks and the NaN guard skips the step on both
        forward = tr.model.forward

        def poisoned(batch, **kw):
            loss, per_row = forward(batch, **kw)
            return (loss * float("nan") if rank == 1 else loss), per_row

        tr.model.forward = poisoned
        from unirec_tpu_torch.utils import to_device
        result["nan_loss"] = float(tr.train_step(
            to_device(tr.mesh.pad_batch(_raw_batches(9)[0]), "cpu")))
        result["after_nan"] = _flat_params(tr)
    elif case == "drop":
        for name, args in DROPOUT.items():
            tr = _trainer(dict(args, mesh_data=2), out)
            result[name] = (_steps(tr), _flat_params(tr))
    elif case == "mf":
        tr = _trainer(dict(MF, mesh_data=1, mesh_model=2), out)
        grads = []
        result["sharded"] = sorted(n for n, p in tr.model.named_parameters()
                                   if getattr(p, "row_shard", None) is not None)
        result["losses"] = _steps(tr, grads)
        from unirec_tpu_torch.utils.flax_bridge import to_flax_tree
        result["grads"] = dict(_flat(to_flax_tree(tr.model, grads[0])))
        result["params"] = _flat_params(tr)
        tr.save_model(os.path.join(out, "mf.pkl"), quiet=True)
        # Adam's moments are sharded with their tables: the same state as a
        # pickle and as a .dcp directory
        tr = _trainer(dict(MF, mesh_data=1, mesh_model=2, optimizer="adam"), out)
        _steps(tr)
        tr.save_model(os.path.join(out, "adam.pkl"), quiet=True)
        tr.config["checkpoint_backend"] = "orbax"
        tr.save_model(os.path.join(out, "adam_dcp.pkl"), quiet=True)
    elif case == "run":
        from unirec_tpu_torch.main import main
        conf = json.loads(sys.argv[3])
        result["train"] = main.run(dict(conf, mesh_data=2), device="cpu")
        ckpt = os.path.join(conf["output_path"], "checkpoint", f"{conf['exp_name']}.pkl")
        result["test"] = main.run({"task": "test", "model_file": ckpt, "mesh_data": 2,
                                   "dataset_path": conf["dataset_path"],
                                   "output_path": conf["output_path"]}, device="cpu")
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    dist.destroy_process_group()


def _results(out, n=2):
    res = []
    for r in range(n):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


def _close(got, want, rel=1e-5, what=""):
    """Each leaf within rel of its largest value, plus 1e-6 (the atol of
    tests/test_torch_train.py's Adam step: the key biases, zero-gradient in
    exact arithmetic, move by rounding noise)."""
    for k in want:
        scale = float(np.abs(want[k]).max())
        err = float(np.abs(np.asarray(got[k]) - want[k]).max())
        assert err <= rel * scale + 1e-6, (what, k, err, scale)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------- placement
def _jax_mesh(data, model):
    from unirec_tpu.core.mesh import create_mesh as jax_create_mesh
    return jax_create_mesh(data=data, model=model)


@pytest.mark.parametrize("n_model", [2, 4])
def test_shard_rule_matches_jax_param_shardings(n_model):
    """On SASRec's tree (4,096 items) and on a tree with a table whose
    2,049 rows neither 2 nor 4 divides, a table under shard_min_rows, a
    wide dense kernel and a bias, the port shards exactly what JAX
    shards."""
    import jax
    from jax.sharding import PartitionSpec as P

    from unirec_tpu import config as jax_config
    from unirec_tpu.utils.registry import get_model_class as jax_model_class
    from unirec_tpu_torch import config as torch_config
    from unirec_tpu_torch.core.mesh import MeshContext
    from unirec_tpu_torch.utils.flax_bridge import named_flax_params
    from unirec_tpu_torch.utils.registry import get_model_class
    mesh = _jax_mesh(8 // n_model, n_model)
    args = dict(SASREC, n_items=4096, max_seq_len=16)
    jmodel = jax_model_class("SASRec")(cfg=jax_config.parse_arguments(dict(args), argv=[]))
    import jax.numpy as jnp
    batch = {"item_seq": jnp.ones((2, 16), jnp.int32), "user_id": jnp.zeros(2, jnp.int32),
             "item_id": jnp.zeros(2, jnp.int32), "label": jnp.zeros(2)}
    trees = [jmodel.init(jax.random.PRNGKey(0), batch, train=False)["params"],
             {"item_embedding": {"embedding": np.zeros((4096, 8), np.float32)},
              "features_embedding": {"embedding": np.zeros((1024, 8), np.float32)},
              "user_embedding": {"embedding": np.zeros((2049, 8), np.float32)},
              "position_embedding": {"embedding": np.zeros((16, 8), np.float32)},
              "dense": {"kernel": np.zeros((2048, 8), np.float32)},
              "item_bias": np.zeros(4096, np.float32)}]
    tmodel = get_model_class("SASRec")(torch_config.parse_arguments(dict(args), argv=[],
                                                                    device="cpu"))
    port_shapes = [{k: tuple(p.shape) for k, p in named_flax_params(tmodel).items()}, None]
    for tree, shapes in zip(trees, port_shapes):
        leaves = jax.tree_util.tree_flatten_with_path(
            mesh.param_shardings(tree, min_rows=1024))[0]
        jax_rule = {"/".join(str(getattr(p, "key", p)) for p in path): s.spec == P("model", None)
                    for path, s in leaves}
        flat = dict(_flat(jax.tree_util.tree_map(np.asarray, tree)))
        shapes = shapes or {k: v.shape for k, v in flat.items()}
        assert set(shapes) == set(jax_rule)
        port = MeshContext(8 // n_model, n_model).param_shardings(shapes, min_rows=1024)
        assert port == jax_rule
        assert any(port.values()) and not all(port.values())


@pytest.mark.parametrize("n_data", [2, 3])
def test_shard_batch_keeps_the_rows_of_jax(n_data, monkeypatch):
    """7 rows over 2 or 3 data ranks: each rank's rows and the zero-weight
    copies of the last row equal the addressable shards of JAX's
    shard_batch; a scalar stays replicated."""
    from unirec_tpu_torch.core.mesh import MeshContext
    rng = np.random.default_rng(1)
    batch = {"user_id": np.arange(1, 8, dtype=np.int32),
             "item_id": rng.integers(1, 50, (7, 3)).astype(np.int32),
             "weight": np.linspace(0.5, 1.0, 7).astype(np.float32),
             "reparam_seed": np.int32(5)}
    jb = _jax_mesh(n_data, 1).shard_batch(batch)
    for r in range(n_data):
        ctx = MeshContext(n_data, 1)
        monkeypatch.setattr(ctx, "rank", lambda axis, r=r: r)
        mine = ctx.shard_batch(batch)
        for k in ("user_id", "item_id", "weight"):
            shards = sorted(jb[k].addressable_shards, key=lambda s: s.index[0].start or 0)
            np.testing.assert_array_equal(mine[k], np.asarray(shards[r].data))
        assert mine["reparam_seed"] == 5
    assert ctx.padded_rows(7) == (8 if n_data == 2 else 9)


@pytest.mark.parametrize("which", ["layer", "lastq"])
def test_fused_layer_dropout_is_keyed_by_the_global_example(which):
    """Rows 1-4's plain versions (the kernels' Philox keying): a rank's
    rows [8, 16) with b0 = 8 draw the masks of rows 8-15 of the whole
    batch, forward and backward; with b0 = 0 they draw rows 0-7's."""
    from unirec_tpu_torch.ops import layer as LY
    g = torch.Generator().manual_seed(2)
    B, L, D, F = 16, 10, 16, 32
    x = torch.randn(B, L, D, generator=g)
    madd = torch.zeros(B, L)
    rn = lambda *s: torch.randn(*s, generator=g) * 0.2  # noqa: E731
    params = tuple((rn(D, D), rn(D)) for _ in range(4)) + ((1 + rn(D), rn(D)),) + \
        ((rn(D, F), rn(F)), (rn(F, D), rn(D)), (1 + rn(D), rn(D)))
    xp, mp, _ = LY._pad_L(x, madd, L)
    drop = LY.drop_params(0.3, 0.3, True, 77)
    if which == "layer":
        flat, args = LY._layer_weights(params, x.dtype), (2, "swish", 1e-10, True)
        fwd, bwd = LY._layer_fwd_plain, LY._layer_bwd_plain
        dy = torch.randn(xp.shape, generator=g)
    else:
        flat, args = LY._lastq_weights(params, x.dtype), (L - 1, 2, "swish", 1e-10)
        fwd, bwd = LY._lastq_fwd_plain, LY._lastq_bwd_plain
        dy = torch.randn(B, D, generator=g)
    whole, part = fwd(xp, mp, flat, *args, drop), drop._replace(b0=8)
    torch.testing.assert_close(fwd(xp[8:], mp[8:], flat, *args, part), whole[8:])
    assert not torch.allclose(fwd(xp[8:], mp[8:], flat, *args, drop), whole[8:])
    torch.testing.assert_close(bwd(xp[8:], mp[8:], flat, dy[8:], *args, part)[0],
                               bwd(xp, mp, flat, dy, *args, drop)[0][8:])


# ------------------------------------------------------- data parallelism
@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    run_ranks("tests.test_torch_distributed", "dp", out)
    return _results(out)


def test_data_parallel_params_equal_one_process(dp_run, tmp_path):
    ref = _trainer(dict(SASREC, mesh_data=1), tmp_path)
    ref_losses = _steps(ref)
    want = _flat_params(ref)
    for r in dp_run:
        np.testing.assert_allclose(r["losses"], ref_losses, rtol=1e-5)
        _close(r["params"], want, what="data-parallel SASRec")
    for k in want:
        np.testing.assert_array_equal(dp_run[0]["params"][k], dp_run[1]["params"][k])


def test_data_parallel_first_loss_equals_jax_at_mesh_data_2(dp_run, tmp_path, monkeypatch):
    """The JAX trainer at mesh_data=2 (its batch split over 2 of the 8 CPU
    devices) on step 1's augmented batch from the port's initial weights."""
    import jax
    import jax.numpy as jnp

    import unirec_tpu.ops.layer as jax_layer
    import unirec_tpu.ops.member as jax_member
    import unirec_tpu.ops.scatter_accum as jax_sa
    from unirec_tpu import config as jax_config
    from unirec_tpu.facility.trainer import Trainer as JaxTrainer
    from unirec_tpu.utils.registry import get_model_class as jax_model_class
    from unirec_tpu_torch.utils import to_device
    from unirec_tpu_torch.utils.flax_bridge import to_flax_params
    for mod in (jax_layer, jax_sa, jax_member):
        monkeypatch.setattr(mod, "_INTERPRET", True)
    tr = _trainer(dict(SASREC, mesh_data=1), tmp_path)
    from unirec_tpu_torch.facility.trainer import step_seeds
    gen = torch.Generator().manual_seed(step_seeds(tr.seed, 0)[0])
    batch = tr._augmenter.augment(to_device(_raw_batches()[0], "cpu"), gen)
    batch = {k: v.numpy() for k, v in batch.items()}
    jcfg = jax_config.parse_arguments(dict(SASREC, mesh_data=2, output_path=str(tmp_path)),
                                      argv=[])
    jt = JaxTrainer(jcfg, jax_model_class("SASRec")(cfg=jcfg))
    assert jt.mesh.n_data == 2
    jt.init_params(batch)
    jt.params = jt.mesh.replicate(jax.tree_util.tree_map(jnp.asarray,
                                                         to_flax_params(tr.model)))
    jt.opt_state = jax.jit(jt.tx.init)(jt.params)
    jt._build_train_step()
    _, _, loss = jt._train_step(jt.params, jt.opt_state, jnp.asarray(0, jnp.int32),
                                jt.mesh.shard_batch(batch), jt._rng)
    assert abs(dp_run[0]["losses"][0] - float(loss)) <= 1e-5 * abs(float(loss))


def test_a_non_finite_loss_on_one_rank_skips_the_step_on_both(dp_run):
    for r in dp_run:
        assert np.isnan(r["nan_loss"])
        for k, v in r["params"].items():
            np.testing.assert_array_equal(r["after_nan"][k], v)


@pytest.fixture(scope="module")
def drop_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("drop")
    run_ranks("tests.test_torch_distributed", "drop", out)
    return _results(out)


@pytest.mark.parametrize("which", sorted(DROPOUT))
def test_data_parallel_with_dropout_equals_one_process(drop_run, which, tmp_path):
    """At dropout 0.3 every random draw of a step (the plain sites' masks,
    MultiVAE's noise, the fused kernels' Philox masks keyed by global
    example) is the one a one-process run draws for the same rows: the
    losses and the parameters after 3 steps equal the one-process run's,
    and both ranks hold identical parameters. The dropout is live: the
    one-process run at dropout 0 ends elsewhere."""
    args = DROPOUT[which]
    ref = _trainer(dict(args, mesh_data=1), tmp_path / "one")
    ref_losses, want = _steps(ref), _flat_params(ref)
    for losses, params in (r[which] for r in drop_run):
        np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
        _close(params, want, what=which)
    for k in want:
        np.testing.assert_array_equal(drop_run[0][which][1][k], drop_run[1][which][1][k])
    off = {k: 0.0 for k in ("hidden_dropout_prob", "attn_dropout_prob", "dropout_prob")
           if k in args}
    plain = _trainer(dict(args, mesh_data=1, **off), tmp_path / "off")
    _steps(plain)
    moved = _flat_params(plain)
    assert any(not np.allclose(moved[k], want[k], rtol=1e-4, atol=1e-6) for k in want)


# --------------------------------------------------------- sharded tables
@pytest.fixture(scope="module")
def mf_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mf")
    run_ranks("tests.test_torch_distributed", "mf", out)
    return out, _results(out)


@pytest.fixture(scope="module")
def mf_ref(tmp_path_factory):
    tr = _trainer(dict(MF, mesh_model=1), tmp_path_factory.mktemp("mf_ref"))
    grads = []
    losses = _steps(tr, grads)
    from unirec_tpu_torch.utils.flax_bridge import to_flax_tree
    return losses, dict(_flat(to_flax_tree(tr.model, grads[0]))), _flat_params(tr)


def test_row_sharded_tables_train_as_one_process(mf_run, mf_ref):
    """Both MF tables are sharded over 2 model ranks; step 1's gradients and
    the parameters after 3 SGD steps equal the one-process run's. The
    gradients are clipped (0.005 is below the norm), and SGD's update scales
    with the clip factor, so a norm of one rank's rows would show."""
    _, res = mf_run
    losses, grads, params = mf_ref
    for r in res:
        assert r["sharded"] == ["item_embedding.weight", "user_embedding.weight"]
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        _close(r["grads"], grads, what="grads")
        _close(r["params"], params, what="params")
    norm = np.sqrt(sum(float((g ** 2).sum()) for g in grads.values()))
    assert norm > MF["grad_clip_value"]


def test_sharded_pickle_loads_in_both_packages(mf_run, mf_ref):
    from unirec_tpu.utils import checkpoint as jax_ckpt
    from unirec_tpu_torch.utils import checkpoint as torch_ckpt
    out, _ = mf_run
    params = mf_ref[2]
    for load in (jax_ckpt.load_checkpoint, torch_ckpt.load_checkpoint):
        ckpt = load(os.path.join(out, "mf.pkl"))
        got = dict(_flat(ckpt["params"]))
        assert set(got) == set(params)
        _close(got, params, what=load.__module__)
        assert got["item_embedding/embedding"].shape == (N_ITEMS, 16)


def test_dcp_checkpoint_from_two_ranks_loads_in_one_process(mf_run, tmp_path):
    """The 1x2 Adam run's .dcp directory read back whole by one process (no
    process group): the tensors of its pickle, the sharded moments too; a
    1x1 trainer resumes from it."""
    from unirec_tpu_torch.utils import checkpoint as torch_ckpt
    out, _ = mf_run
    pkl = torch_ckpt.load_checkpoint(os.path.join(out, "adam.pkl"))
    dcp = torch_ckpt.load_checkpoint(os.path.join(out, "adam_dcp.pkl"))
    assert set(os.listdir(os.path.join(out, "adam_dcp.pkl.dcp"))) >= {"side.pkl", ".metadata"}
    for key in ("params",):
        a, b = dict(_flat(pkl[key])), dict(_flat(dcp[key]))
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for k in ("mu", "nu"):
        a, b = dict(_flat(pkl["opt_state"][k])), dict(_flat(dcp["opt_state"][k]))
        for name in a:
            np.testing.assert_array_equal(a[name], b[name])
    assert int(dcp["opt_state"]["count"]) == STEPS
    tr = _trainer(dict(MF, mesh_model=1, optimizer="adam"), tmp_path)
    tr.resume(os.path.join(out, "adam_dcp.pkl"))
    assert tr._global_step == STEPS and np.isfinite(_steps(tr)).all()


def test_a_jax_orbax_directory_is_refused_by_name(tmp_path):
    """The JAX package's sharded checkpoint (orbax, OCDBT/tensorstore) is
    refused by name; its conversion, the JAX load_checkpoint then
    save_checkpoint (pickle), loads in the port."""
    import jax.numpy as jnp

    from unirec_tpu.utils import checkpoint as jax_ckpt
    from unirec_tpu_torch.utils import checkpoint as torch_ckpt
    path = str(tmp_path / "mf.pkl")
    table = np.arange(32, dtype=np.float32).reshape(8, 4)
    jax_ckpt.save_checkpoint_orbax(path, {"config": {"model": "MF"}, "cur_epoch": 1,
                                          "params": {"item_embedding": {
                                              "embedding": jnp.asarray(table)}}})
    assert os.path.isdir(path + ".orbax")
    for name in (path, path + ".orbax"):
        with pytest.raises(ValueError, match="JAX orbax checkpoint"):
            torch_ckpt.load_checkpoint(name)
    converted = str(tmp_path / "converted.pkl")
    jax_ckpt.save_checkpoint(converted, jax_ckpt.load_checkpoint(path))
    got = torch_ckpt.load_checkpoint(converted)
    np.testing.assert_array_equal(got["params"]["item_embedding"]["embedding"], table)


# ----------------------------------------------------------------- main.run
def _run_conf(root, out):
    from tests.synth import BASE_CONF
    return dict(BASE_CONF, model="SASRec", dataloader="SeqRecDataset", n_layers=1,
                n_heads=2, epochs=2, hidden_dropout_prob=0.0, attn_dropout_prob=0.0,
                dataset_path=root, output_path=str(out), exp_name="mp")


def test_main_run_train_then_test_two_processes_match_one(synth_dataset, tmp_path):
    from unirec_tpu_torch.main import main
    root, _ = synth_dataset
    one = main.run(_run_conf(root, tmp_path / "one"), device="cpu")
    out = tmp_path / "two"
    out.mkdir()
    run_ranks("tests.test_torch_distributed", "run", out, 2,
              json.dumps(_run_conf(root, out)))
    for r in _results(out):
        for which in ("train", "test"):
            assert set(r[which]) == set(one)
            for k, v in one.items():
                assert r[which][k] == pytest.approx(v, abs=1e-6), (which, k)
    # one log file, rank 0's (the test task logs to the same logger), and
    # the result file
    assert len([f for f in os.listdir(out) if f.endswith(".log")]) == 1
    assert (out / "mp.result.tsv").exists()


def test_torchrun_cli_train_then_test_in_one_process(synth_dataset, tmp_path, capsys):
    """The documented launch, ``torchrun --nproc_per_node 2 -m
    unirec_tpu_torch.cli train --mesh_data 2``: both ranks print the test
    metrics, and the checkpoint rank 0 wrote gives them again through
    ``cli test`` in one process (within 1e-6; its config records
    mesh_data 2, so the one-process run passes -1, the world size)."""
    import ast

    from unirec_tpu_torch import cli
    root, _ = synth_dataset
    flags = ["--model", "SASRec", "--dataloader", "SeqRecDataset", "--dataset_path", root,
             "--output_path", str(tmp_path), "--exp_name", "cli", "--epochs", "1",
             "--embedding_size", "8", "--n_heads", "2", "--inner_size", "16",
             "--device", "cpu", "--valid_protocol", "one_vs_all", "--test_protocol",
             "one_vs_all", "--user_history_filename", "user_history",
             "--n_sample_neg_train", "3", "--metrics", "['hit@10', 'ndcg@10']",
             "--key_metric", "hit@10", "--mesh_data", "2"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_addr", "127.0.0.1", "--master_port", str(free_port()),
           "-m", "unirec_tpu_torch.cli", "train", *flags]
    out = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT,
                                                 OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=RANK_TIMEOUT)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    trained = [ast.literal_eval(ln) for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert len(trained) == 2 and trained[0] == trained[1]
    assert cli.main(["test", "--model_file", str(tmp_path / "checkpoint" / "cli.pkl"),
                     "--dataset_path", root, "--device", "cpu", "--mesh_data", "-1",
                     "--output_path", str(tmp_path / "t")]) == 0
    tested = ast.literal_eval(capsys.readouterr().out.splitlines()[-1])
    assert set(tested) == set(trained[0])
    for k, v in tested.items():
        assert trained[0][k] == pytest.approx(v, abs=1e-6), k


def test_morec_at_mesh_data_2_is_refused(tmp_path):
    from unirec_tpu_torch.core.mesh import MeshContext
    from unirec_tpu_torch.facility.trainer import Trainer
    from unirec_tpu_torch import config as torch_config
    from unirec_tpu_torch.utils.registry import get_model_class
    cfg = torch_config.parse_arguments(dict(MF, output_path=str(tmp_path)), argv=[],
                                       device="cpu")
    tr = Trainer(cfg, get_model_class("MF")(cfg), device="cpu", mesh=MeshContext(2, 1))
    with pytest.raises(NotImplementedError, match="MoRec under data parallelism"):
        tr.add_objective_controller(object())


if __name__ == "__main__":
    _rank_main()
