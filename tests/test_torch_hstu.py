"""HSTU on the port (models/sequential.py::HSTU, models/modules.py::HSTULayer,
ops/hstu_attention.py) against the benchmark's plain reference,
portbench/reference/hstu.py, on seeded random weights at a small size: d =
16, two heads of 8, L = 24, three layers, left-padded rows and one row of
padding only. The JAX package has no HSTU, so the reference is the
yardstick; it imports nothing of the port.

Tolerances, each with its reason:

* ``EMB_TOL`` 1e-5 on the unit-norm user embeddings: the port in f32
  against the reference in f64; f32 rounding of three layers of 16-wide
  sums reads about 1e-7 (100x room);
* ``LOSS_RTOL`` 1e-5 on the loss and ``GRAD_RTOL`` 1e-4 on every leaf's
  gradient (its worst element over the leaf's largest): the same rounding,
  about 2e-9 and 5e-7, with the gradient's sums over the batch;
* a reference without the relative bias, without the division by L or
  without the norm of the attention's output moves the embeddings by 0.05
  to 0.2 and the loss and gradients by more than a hundred times their
  tolerances, so each part is held by the comparison.
"""
import copy
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "portbench")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from reference import hstu as ref  # noqa: E402
from unirec_tpu_torch import config as torch_config  # noqa: E402
from unirec_tpu_torch.models.modules import DropoutRNG  # noqa: E402
from unirec_tpu_torch.ops import hstu_attention as HA  # noqa: E402
from unirec_tpu_torch.utils.registry import get_model_class  # noqa: E402

EMB_TOL, LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-5, 1e-4
B, L, N_ITEMS, N_CAND = 32, 24, 97, 8
CFG = dict(model="HSTU", n_users=64, n_items=N_ITEMS, max_seq_len=L, embedding_size=16,
           hidden_size=16, n_layers=3, n_heads=2, loss_type="softmax",
           n_sample_neg_train=N_CAND - 1, distance_type="cosine", tau=0.05,
           hidden_dropout_prob=0.2, compute_dtype="float32", init_std=0.1,
           history_mask_mode="autoregressive", learning_rate=0.001, optimizer="adam")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(the port's model, its weights by name, the reference's sizes, a batch)."""
    cfg = torch_config.parse_arguments(dict(CFG), argv=[], device="cpu")
    model = get_model_class("HSTU")(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    W = {n: p.detach().clone() for n, p in model.named_parameters()}
    g = torch.Generator().manual_seed(1)
    lens = torch.randint(0, L + 1, (B,), generator=g)
    lens[0], lens[1] = 0, L                       # a row of padding only, a full row
    seq = torch.randint(1, N_ITEMS, (B, L), generator=g) \
        * (torch.arange(L)[None] >= L - lens[:, None])
    cands = torch.randint(0, N_ITEMS, (B, N_CAND), generator=g)   # some id 0 negatives
    cands[:, 0] = torch.randint(1, N_ITEMS, (B,), generator=g)
    label = torch.zeros(B, N_CAND)
    label[:, 0] = 1.0
    weight = torch.ones(B)
    weight[-3:] = 0.0                             # padded batch rows
    batch = {"item_seq": seq, "item_id": cands, "label": label, "weight": weight,
             "item_seq_len": lens}
    return model, W, ref.Sizes(cfg), batch


def _ref_loss_and_grads(W, s, batch, seed, parts=(), row_block=B):
    P = {k: v.double().requires_grad_(True) for k, v in W.items()}
    keeps = ref.dropout_keeps(s, seed, B, L, "cpu")
    total = batch["weight"].double().sum()
    loss, grads = 0.0, {k: torch.zeros_like(v) for k, v in P.items()}
    for lo in range(0, B, row_block):
        part = ref.block_loss(P, s, batch, slice(lo, lo + row_block), keeps, total,
                              parts=parts)
        for k, g in zip(P, torch.autograd.grad(part, list(P.values()), allow_unused=True)):
            if g is not None:
                grads[k] += g
        loss += float(part)
    return loss, grads


def _port_loss_and_grads(model, batch, seed):
    model.zero_grad()
    model.train()
    loss, _ = model(batch, train=True, rng=DropoutRNG(seed, "cpu"))
    loss.backward()
    return float(loss), {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _worst_grad_gap(got, want):
    return max(float((got[n].double() - want[n]).abs().max()
                     / want[n].abs().max().clamp(min=1e-30)) for n in want)


# ------------------------------------------------------------ the kernel
def _direct(q, k, v, rab, keys):
    """The [B, H, L, L] formula written out pair by pair (f64)."""
    Bq, Lq, H, _ = q.shape
    bias = torch.empty(Lq, Lq, dtype=rab.dtype)
    for i in range(Lq):
        for j in range(Lq):
            bias[i, j] = rab[j - i + Lq - 1]
    out = torch.zeros(Bq, Lq, H, v.shape[-1], dtype=q.dtype)
    for b in range(Bq):
        for h in range(H):
            s = q[b, :, h] @ k[b, :, h].T + bias
            a = s * torch.sigmoid(s) / Lq
            mask = torch.tril(torch.ones(Lq, Lq, dtype=torch.bool)) & keys[b][None, :]
            out[b, :, h] = torch.where(mask, a, torch.zeros_like(a)) @ v[b, :, h]
    return out


def test_plain_body_matches_the_direct_formula_with_its_gradients():
    g = torch.Generator().manual_seed(3)
    Bq, Lq, H = 3, 9, 2
    q, k = (torch.randn(Bq, Lq, H, 5, generator=g, dtype=torch.float64) for _ in range(2))
    v = torch.randn(Bq, Lq, H, 4, generator=g, dtype=torch.float64)
    rab = torch.randn(2 * Lq - 1, generator=g, dtype=torch.float64)
    keys = torch.arange(Lq)[None, :] >= torch.tensor([[0], [4], [Lq]])  # full, padded, none
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, rab)]
    want = _direct(*leaves, keys)
    go = torch.randn(want.shape, generator=g, dtype=torch.float64)
    dwant = torch.autograd.grad((want * go).sum(), leaves)
    # the plain body computes in f32, as the kernel does: f32 rounding only
    torch.testing.assert_close(HA._fwd_plain(q, k, v, rab, keys).double(), want, rtol=1e-5,
                               atol=1e-6)
    for got, exp in zip(HA._bwd_plain(q, k, v, rab, keys, go), dwant):
        torch.testing.assert_close(got.double(), exp, rtol=1e-5, atol=1e-5)
    assert not HA._fwd_plain(q, k, v, rab, keys)[2].any()      # padding only: nothing


def test_autograd_function_runs_the_plain_bodies_on_the_cpu():
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, 6, 2, 4, generator=g, requires_grad=True) for _ in range(3))
    rab = torch.randn(11, generator=g, requires_grad=True)
    keys = torch.ones(2, 6, dtype=torch.bool)
    before = (HA.hstu_attention.launches_plain, HA.hstu_attention_bwd.launches_plain)
    out = HA.hstu_attention(q, k, v, rab, keys)
    grads = torch.autograd.grad(out.sum(), [q, k, v, rab])
    want = torch.autograd.grad(HA._fwd_plain(q, k, v, rab, keys).sum(), [q, k, v, rab])
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert (HA.hstu_attention.launches_plain, HA.hstu_attention_bwd.launches_plain) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("shape,dtype,rtol", [
    ((2, 7, 2, 25), torch.bfloat16, 2e-2), ((2, 7, 1, 64), torch.bfloat16, 2e-2),
    ((1, 6, 2, 65), torch.bfloat16, 2e-2), ((2, 7, 2, 25), torch.float32, 1e-5),
    ((2, 7, 2, 25), torch.float64, 1e-5)])
def test_cpu_path_takes_every_dtype_and_head_width(shape, dtype, rtol):
    """On CPU tensors ``hstu_attention`` runs the plain version at any dtype
    and head width, those the card's kernels refuse (f32, f64, 65) too. The
    output within ``rtol`` of its largest value of the f64 formula: bf16
    rounds the operands, a and the output (2e-2), f32 and f64 sum in f32
    (1e-5)."""
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(shape, generator=g, dtype=torch.float64) for _ in range(3))
    rab = torch.randn(2 * shape[1] - 1, generator=g, dtype=torch.float64)
    keys = torch.arange(shape[1])[None, :] >= torch.tensor([[0], [2]])[:shape[0]]
    q, k, v = (t.to(dtype) for t in (q, k, v))
    before = HA.hstu_attention.launches_plain
    got = HA.hstu_attention(q, k, v, rab.float(), keys)
    assert got.dtype == dtype and HA.hstu_attention.launches_plain == before + 1
    want = _direct(q.double(), k.double(), v.double(), rab, keys)
    assert float((got.double() - want).abs().max() / want.abs().max()) <= rtol


def test_bias_table_is_centred_on_offset_zero(pair):
    model = pair[0]
    rab = model.hstu.layer_0.rab
    t = rab.table(5)
    assert t.shape == (9,) and torch.equal(t[4], rab.weight[L - 1])
    assert torch.equal(HA.rel_index(3, "cpu"), torch.tensor([[2, 3, 4], [1, 2, 3], [0, 1, 2]]))


# --------------------------------------------------- against the reference
def test_user_embedding_matches_the_reference(pair):
    model, W, s, batch = pair
    model.eval()
    with torch.no_grad():
        got = model.forward_user_emb(item_seq=batch["item_seq"])
    want = ref.user_embedding({k: v.double() for k, v in W.items()}, s, batch["item_seq"])
    assert float((got.double() - want).abs().max()) < EMB_TOL
    assert torch.allclose(want.norm(dim=-1), torch.ones(B, dtype=torch.float64))


def test_loss_and_every_gradient_match_the_reference(pair):
    model, W, s, batch = pair
    loss, grads = _port_loss_and_grads(model, batch, seed=77)
    want, wgrads = _ref_loss_and_grads(W, s, batch, seed=77)
    assert abs(loss - want) <= LOSS_RTOL * abs(want)
    assert set(grads) == set(wgrads)
    assert _worst_grad_gap(grads, wgrads) < GRAD_RTOL


def test_reference_in_row_blocks_sums_to_the_whole_batch(pair):
    _, W, s, batch = pair
    whole, g1 = _ref_loss_and_grads(W, s, batch, seed=5)
    blocks, g2 = _ref_loss_and_grads(W, s, batch, seed=5, row_block=7)
    assert abs(whole - blocks) < 1e-12
    assert _worst_grad_gap(g2, g1) < 1e-10


@pytest.mark.parametrize("part", ["rab", "len", "norm"])
def test_a_reference_without_a_part_fails_every_tolerance(pair, part):
    model, W, s, batch = pair
    model.eval()
    with torch.no_grad():
        got = model.forward_user_emb(item_seq=batch["item_seq"])
    W64 = {k: v.double() for k, v in W.items()}
    off = ref.user_embedding(W64, s, batch["item_seq"], parts=(part,))
    assert float((got.double() - off).abs().max()) > 100 * EMB_TOL
    loss, grads = _port_loss_and_grads(model, batch, seed=77)
    want, wgrads = _ref_loss_and_grads(W, s, batch, seed=77, parts=(part,))
    assert abs(loss - want) > 100 * LOSS_RTOL * abs(want)
    assert _worst_grad_gap(grads, wgrads) > 100 * GRAD_RTOL


def test_three_training_steps_through_the_benchmark_harness_match_the_reference(tmp_path):
    """The benchmark's training harness (harness/train.py) on the CPU: the
    port's Trainer, its device pipeline and Adam, on the plain bodies,
    against the reference's three steps from the same weights, rows and
    seeds."""
    import time

    from harness import cell, train
    cfg = dict(CFG, dataloader="SeqRecDataset", group_size=-1, neg_oversample_factor=4,
               vmem_embedding_grad=1, neg_membership_pallas=1, test_batch_size=32)
    traffic = {"kind": "train", "batch": 24, "rows_batches": 4,
               "items": {"kind": "zipf", "s": 0.9}, "history_length": [2, 40],
               "history_capacity": 40, "options": {}, "warmup_steps": 1, "trace_steps": 2}
    files = {"cell": {"name": "tiny_hstu", "chips": 1},
             "config": {"config": cfg, "flops": {}, "reference": "hstu"}, "traffic": traffic}
    ctx = cell.Context(name="tiny_hstu", files=files, seed=2 ** 31 + 12345, seconds=0.2,
                       trace=False, device=torch.device("cpu"), tmpdir=str(tmp_path),
                       metrics=[], t_top=time.perf_counter(),
                       limits={"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap_median": 1e-3,
                               "batch_rows_off": 0})
    out = train.run(ctx)
    r = out["readings"]
    assert r["batch_rows_off"] == 0 and out["failed"] == 0
    assert r["loss_gap"] < LOSS_RTOL and r["grad_gap"] < GRAD_RTOL and r["change_gap"] < 1e-3
    assert cell.verdict(r, ctx.limits)[0]


def test_defaults_are_hstu_large():
    cfg = torch_config.parse_arguments({"model": "HSTU", "n_items": 3707, "n_users": 6041},
                                       argv=[], device="cpu")
    assert (cfg["n_layers"], cfg["n_heads"], cfg["hidden_size"], cfg["embedding_size"],
            cfg["max_seq_len"], cfg["hidden_dropout_prob"]) == (8, 2, 50, 50, 200, 0.2)
    model = get_model_class("HSTU")(cfg)
    layer = model.hstu.layer_0
    assert (layer.dqk, layer.dv) == (25, 25) and layer.uvqk.weight.shape == (200, 50)
    assert model.hstu.n_layers == 8


# ----------------------------------------------------------- entry points
def test_main_run_trains_and_reco_topk_serves(synth_dataset, tmp_path):
    from tests.synth import BASE_CONF
    from unirec_tpu_torch.main import main
    from unirec_tpu_torch.main import reco_topk
    root, _ = synth_dataset
    out = str(tmp_path / "out")
    args = dict(copy.deepcopy(BASE_CONF), model="HSTU", dataloader="SeqRecDataset",
                dataset_path=root, task="train", output_path=out, exp_name="hstu",
                device="cpu", embedding_size=16, hidden_size=16, n_layers=2, n_heads=2,
                max_seq_len=10, loss_type="softmax", n_sample_neg_train=9, epochs=4,
                learning_rate=0.005, hidden_dropout_prob=0.1)
    result = main.run(dict(args))
    assert result["hit@5"] > 2 * 5.0 / 300.0, result
    ckpt = os.path.join(out, "checkpoint", "hstu.pkl")
    again = main.run({"task": "test", "model_file": ckpt, "dataset_path": root,
                      "output_path": out + "_test", "device": "cpu"})
    assert again == result
    users = tmp_path / "users.txt"
    np.savetxt(users, np.arange(1, 41), fmt="%i")
    ids = reco_topk.do_topk_reco({"model_file": ckpt, "dataset_path": root,
                                  "dataset_name": str(users), "topk": 10,
                                  "user_history_filename": "user_history",
                                  "output_path": str(tmp_path / "topk.csv"),
                                  "use_fused_topk": 1}, device="cpu")
    assert ids.shape == (40, 10) and (ids > 0).all()
    assert all(len(set(row)) == 10 for row in ids.tolist())
    dense = reco_topk.do_topk_reco({"model_file": ckpt, "dataset_path": root,
                                    "dataset_name": str(users), "topk": 10,
                                    "user_history_filename": "user_history",
                                    "output_path": str(tmp_path / "dense.csv"),
                                    "use_fused_topk": 0}, device="cpu")
    assert np.array_equal(ids, dense)
