"""The plain reference: float32 against a float64 evaluation at a tiny
size, its Philox bits against the port's, and the program at a tiny size
on the CPU (the port's plain versions) against it."""
import copy
import warnings

import numpy as np
import pytest
import torch

import tiny
from harness import train
from reference import sasrec as ref


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    warnings.filterwarnings("ignore", category=UserWarning)
    yield
    torch.set_num_threads(n)


def _inputs(cfg, seed=3):
    g = torch.Generator().manual_seed(seed)
    n_users, n_items, cap = cfg["n_users"], cfg["n_items"], 12
    lens = torch.randint(2, cap, (n_users,), generator=g)
    items = torch.randint(1, n_items, (n_users, cap), generator=g)
    items = items * (torch.arange(cap)[None] < lens[:, None])
    shapes = {"item_embedding.weight": (n_items, 16), "position_embedding.weight": (7, 16),
              "LayerNorm.weight": (16,), "LayerNorm.bias": (16,)}
    for i in range(2):
        a, f = f"trm_encoder.layer_{i}.multi_head_attention.", f"trm_encoder.layer_{i}.feed_forward."
        for n in ("query", "key", "value", "dense"):
            shapes[a + n + ".weight"], shapes[a + n + ".bias"] = (16, 16), (16,)
        shapes[a + "LayerNorm.weight"], shapes[a + "LayerNorm.bias"] = (16,), (16,)
        shapes[f + "dense_1.weight"], shapes[f + "dense_1.bias"] = (32, 16), (32,)
        shapes[f + "dense_2.weight"], shapes[f + "dense_2.bias"] = (16, 32), (16,)
        shapes[f + "LayerNorm.weight"], shapes[f + "LayerNorm.bias"] = (16,), (16,)
    W = {k: torch.randn(s, generator=g) * 0.1 for k, s in shapes.items()}
    raw = [{"user_id": torch.randint(1, n_users, (24,), generator=g).numpy(),
            "item_id": torch.randint(1, n_items, (24,), generator=g).numpy(),
            "weight": np.ones(24, np.float32)} for _ in range(3)]
    pop = np.bincount(items[items > 0].numpy(), minlength=n_items)
    return W, items.int(), lens.int(), raw, pop


@pytest.mark.parametrize("variant", ["chain", "fused_attention", "plain"])
def test_f32_reference_against_f64(variant):
    cfg = copy.deepcopy(tiny.TINY_CONFIG)
    cfg["neg_by_pop_alpha"] = 1.0
    if variant != "chain":
        cfg.update(fused_layer=0, fused_lastq=0, dropout_bits=32,
                   use_fused_attention=int(variant == "fused_attention"))
    W, items, lens, raw, pop = _inputs(cfg)
    got = ref.train(W, cfg, raw, items, lens, seed=11, popularity=pop)
    want = ref.train(W, cfg, raw, items, lens, seed=11, popularity=pop, dtype=torch.float64)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for k in W:
        assert got["grad_norm"][k] == pytest.approx(want["grad_norm"][k], rel=1e-3, abs=1e-7)
    for a, b in zip(got["batches"], want["batches"]):
        for k in a:
            assert torch.equal(a[k], b[k])
    users = torch.arange(1, 9)
    s32 = ref.catalog_scores(W, cfg, users, items, lens)
    s64 = ref.catalog_scores(W, cfg, users, items, lens, dtype=torch.float64)
    fin = torch.isfinite(s64)
    assert torch.equal(torch.isfinite(s32), fin)
    torch.testing.assert_close(s32[fin].double(), s64[fin], rtol=1e-5, atol=1e-6)


def test_philox_bits_match_the_ports():
    from unirec_tpu_torch.ops.layer import philox_bits
    b = torch.arange(0, 7)[:, None]
    e = torch.arange(0, 300)[None, :]
    for seed, site in ((0, 0), (123456789, 3), (2 ** 31 - 2, 17)):
        assert torch.equal(ref.philox_word0(seed, site, b, e), philox_bits(seed, site, b, e))


def test_alias_table_is_walkers():
    w = np.array([0.0, 1.0, 5.0, 2.0, 0.5, 9.0])
    t = ref.AliasTable(w)
    n = len(w)
    # each slot's threshold plus what aliases bring it gives n * w / sum
    mass = t.thresh.astype(np.float64).copy()
    for i in range(n):
        mass[t.alias[i]] += 1.0 - t.thresh[i]
    np.testing.assert_allclose(mass / n, w / w.sum(), atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_program_on_the_cpu_against_the_reference(dtype):
    ctx = tiny.context(tiny.TRAIN, config={"compute_dtype": dtype})
    out = train.run(ctx)
    r = out["readings"]
    assert r["batch_rows_off"] == 0
    if dtype == "float32":
        assert r["loss_gap"] < 1e-5 and r["grad_gap"] < 1e-4 and r["change_gap"] < 1e-3
    else:
        assert r["loss_gap"] < 1e-3 and r["grad_gap"] < 0.05 and r["change_gap"] < 0.1
