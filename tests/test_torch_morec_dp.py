"""MoRec under data parallelism in the port, against one process and
against the JAX package at ``mesh_data=2``.

MF (BPR, user embeddings, f32) on tests/synth.py's data with two objectives
(fairness, alignment) and the accuracy block: 3 blocks of 64 rows, so
rank 0's 96 rows end inside block 1 and each rank's rows cross a block
boundary. ``batch_size`` 63 at ``mesh_data=2`` is rounded up to 64 by
``build_morec``, as the JAX package rounds it. Two gloo ranks (subprocesses
of this file, ``python -m tests.test_torch_morec_dp run <out> <dataset>``,
tests/test_torch_distributed.py's ``run_ranks``) each train 3 steps under
PID and 3 under MGDA on their rows of the MoRec sampler's batches; the
sampler refreshes its weights from the signal sweeps before the epoch
(rank 0's kept). Tolerances: each step's loss and the parameters after 3
steps within rel 1e-5 (+ 1e-6) of one process's (the ranks' sums run in
another order), step 1's loss vector and Gram within 1e-5 of their largest
entry, both ranks bit-identical, step 1's PID loss within rel 1e-5 of the
JAX package's on its CPU mesh of 2 data devices.
"""
import itertools
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from tests.synth import BASE_CONF

STEPS = 3
OBJECTIVES = ["fairness", "alignment"]
ARGS = dict(BASE_CONF, model="MF", dataloader="BaseDataset", loss_type="bpr",
            has_user_emb=True, compute_dtype="float32", morec_objectives=OBJECTIVES,
            morec_ngroup=5, morec_alpha=0.01, enable_morec=1, learning_rate=1e-2,
            n_sample_neg_train=3, exp_name="morec_dp")
CONTROLLERS = ("PID", "Pareto")


def _setup(root, out, n_data, controller, batch_size):
    """A Trainer on MF with the MoRec sampler wired as main.run wires it;
    returns (trainer, batcher)."""
    from unirec_tpu_torch import config as torch_config
    from unirec_tpu_torch.data import construct_item_popularity
    from unirec_tpu_torch.data.datasets import BaseDataset
    from unirec_tpu_torch.data.history import UserHistory
    from unirec_tpu_torch.data.pipeline import make_host_train_batcher, make_negative_sampler
    from unirec_tpu_torch.facility.morec import (build_morec, load_alignment_distribution,
                                                 load_morec_meta_data)
    from unirec_tpu_torch.facility.trainer import Trainer
    from unirec_tpu_torch.main.main import _task_config
    from unirec_tpu_torch.utils.registry import get_model_class
    cfg = torch_config.parse_arguments(
        dict(ARGS, dataset_path=root, output_path=str(out), mesh_data=n_data,
             batch_size=batch_size, morec_objective_controller=controller),
        argv=[], device="cpu")
    history = UserHistory.load(f"{root}/user_history", int(cfg["n_users"]), "user-item_seq")
    pop = construct_item_popularity(history, int(cfg["n_items"]))
    cfg["_item_meta_morec"] = load_morec_meta_data(int(cfg["n_items"]),
                                                   f"{root}/item_meta_morec.csv", OBJECTIVES)
    cfg["_alignment_dist"] = load_alignment_distribution(cfg["_item_meta_morec"], pop)
    tr = Trainer(cfg, get_model_class("MF")(cfg), device="cpu")
    tr.set_user_history(history)
    tr.init_params()
    tcfg = _task_config(cfg, "train")
    signal = make_host_train_batcher(BaseDataset(tcfg, root, "valid"), tcfg, history, pop, None)
    batcher = build_morec(tr, tcfg, BaseDataset(tcfg, root, "train"), signal, history, pop,
                          None, item_sampler=make_negative_sampler(tcfg, history, pop))
    return tr, batcher


def _flat_params(tr):
    from unirec_tpu_torch.utils.flax_bridge import to_flax_params
    tree = to_flax_params(tr.model)
    return {f"{a}/{b}": np.array(v, copy=True) for a, sub in sorted(tree.items())
            for b, v in sorted(sub.items())}


def _train(root, out, n_data, controller, batch_size):
    """STEPS MoRec steps through Trainer.train_step; step 1's loss vector
    and Gram (the global ones) and its batch are recorded first."""
    from unirec_tpu_torch.facility.morec import integration as TI
    from unirec_tpu_torch.facility.trainer import step_seeds
    from unirec_tpu_torch.utils import to_device
    tr, batcher = _setup(root, out, n_data, controller, batch_size)
    res = {"init": _flat_params(tr), "batch_size": batcher.batch_size, "losses": []}
    for i, b in enumerate(itertools.islice(iter(batcher), STEPS)):
        b = to_device(tr.mesh.pad_batch(b), "cpu")
        if i == 0:
            res["first"] = {k: v.numpy() for k, v in b.items() if torch.is_tensor(v)}
            vec = TI.loss_vector(tr, b, step_seeds(tr.seed, 0)[1], batcher.n_blocks)
            mesh = tr.mesh if tr.mesh.distributed else None
            res["vec"] = TI.global_vector(tr, vec).numpy()
            res["gram"] = TI.gram(TI.objective_grads(tr.params, vec, mesh)).numpy()
        res["losses"].append(float(tr.train_step(b)))
    res["params"] = _flat_params(tr)
    res["weights"] = {k: np.asarray(v) for k, v in batcher.group2weights.items()}
    return res


def _rank_main():
    case, out, root = sys.argv[1], sys.argv[2], sys.argv[3]
    assert case == "run"
    torch.set_num_threads(1)
    from unirec_tpu_torch.core.distributed import initialize_distributed
    assert initialize_distributed({}, "cpu")
    import torch.distributed as dist
    result = {c: _train(root, os.path.join(out, c), 2, c, 63) for c in CONTROLLERS}
    with open(os.path.join(out, f"rank{dist.get_rank()}.pkl"), "wb") as f:
        pickle.dump(result, f)
    dist.destroy_process_group()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(synth_dataset, tmp_path_factory):
    from tests.test_torch_distributed import _results, run_ranks
    root, _ = synth_dataset
    out = tmp_path_factory.mktemp("morec_dp")
    run_ranks("tests.test_torch_morec_dp", "run", out, 2, root)
    return _results(out)


@pytest.fixture(scope="module")
def one_process(synth_dataset, tmp_path_factory):
    root, _ = synth_dataset
    out = tmp_path_factory.mktemp("morec_one")
    return {c: _train(root, out / c, 1, c, 64) for c in CONTROLLERS}


def test_batch_size_is_rounded_to_the_data_axis(ranks):
    for r in ranks:
        for c in CONTROLLERS:
            assert r[c]["batch_size"] == 64
            assert r[c]["first"]["weight"].shape == (3 * 64,)


@pytest.mark.parametrize("controller", CONTROLLERS)
def test_two_ranks_train_as_one_process(ranks, one_process, controller):
    ref = one_process[controller]
    for r in (x[controller] for x in ranks):
        for k, v in ref["first"].items():
            np.testing.assert_array_equal(r["first"][k], v, err_msg=k)
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-5)
        for what in ("vec", "gram"):
            scale = float(np.abs(ref[what]).max())
            assert float(np.abs(r[what] - ref[what]).max()) <= 1e-5 * scale, what
        for k, v in ref["params"].items():
            err = float(np.abs(r["params"][k] - v).max())
            assert err <= 1e-5 * float(np.abs(v).max()) + 1e-6, (k, err)
        for k, v in ref["weights"].items():
            np.testing.assert_allclose(r["weights"][k], v, rtol=1e-12, err_msg=k)
    a, b = (x[controller] for x in ranks)
    assert a["losses"] == b["losses"]
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k])
    for k in a["weights"]:
        np.testing.assert_array_equal(a["weights"][k], b["weights"][k])
    # the step moved the parameters
    assert any(not np.allclose(a["params"][k], a["init"][k]) for k in a["params"])


def test_first_step_loss_equals_jax_at_mesh_data_2(ranks, synth_dataset, tmp_path):
    """The JAX package's MoRec step (PID) on its 2-device data mesh: the
    same global batch, sharded by its shard_batch, from the ranks' initial
    weights."""
    import types

    import jax
    import jax.numpy as jnp

    from unirec_tpu import config as jax_config
    from unirec_tpu.core.mesh import create_mesh
    from unirec_tpu.core.optim import build_optimizer
    from unirec_tpu.facility.morec import controllers as JC
    from unirec_tpu.facility.morec import integration as JI
    from unirec_tpu.utils.registry import get_model_class
    root, _ = synth_dataset
    r = ranks[0]["PID"]
    jcfg = jax_config.parse_arguments(dict(ARGS, dataset_path=root, output_path=str(tmp_path),
                                           batch_size=64), argv=[])
    mesh = create_mesh(data=2, model=1)
    tree = {}
    for path, v in r["init"].items():
        a, b = path.split("/")
        tree.setdefault(a, {})[b] = jnp.asarray(v)
    params = mesh.replicate(tree)
    tx = build_optimizer(jcfg)
    jt = types.SimpleNamespace(model=get_model_class("MF")(cfg=jcfg), tx=tx, constants=None,
                               config=jcfg, params=params, opt_state=jax.jit(tx.init)(params),
                               objective_controller=JC.build_controller(jcfg, 2),
                               _morec_sampler=types.SimpleNamespace(n_blocks=3))
    loss, _, _ = JI.morec_train_step(jt, mesh.shard_batch(r["first"]), jax.random.PRNGKey(0))
    assert abs(r["losses"][0] - float(loss)) <= 1e-5 * abs(float(loss))


if __name__ == "__main__":
    _rank_main()
