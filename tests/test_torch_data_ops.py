"""The training slice's data-side ops against the JAX package.

- ops/scatter_accum.py: scatter_add_rows / scatter_add_rows2 / gather_vmem
  (plain versions of csrc/scatter_add.cu) against the JAX interpret-mode
  Pallas kernels and np.add.at, f32, within 1e-5 (plus 1e-5 relative for
  sums of a few unit rows); a table size that is not a multiple of 8 and a
  ragged row count, as tests/test_kernels.py covers them.
- ops/member.py: member_mask against the JAX interpret-mode kernel, exact.
- data/device_pipeline.py: history_window equal to the JAX augmenter's for
  the same rows, lengths and targets; sampled negatives held to their
  invariants (the two frameworks draw different random numbers).
- popularity negatives (data/sampler.py's alias table, on the device in the
  augmenter): the table equal to JAX's, the draws' frequencies against its
  probabilities, and the first-survivor rule on skewed histories, in the
  device pipeline and in the host sampler of one-vs-k evaluation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unirec_tpu.ops.member as jax_member
import unirec_tpu.ops.scatter_accum as jax_sa
from unirec_tpu.data.device_pipeline import DeviceAugmenter as JaxAugmenter
from unirec_tpu.data.history import UserHistory as JaxHistory
from unirec_tpu.data.sampler import AliasTable as JaxAliasTable
from unirec_tpu.data.sampler import NegativeSampler as JaxNegativeSampler
from unirec_tpu_torch.data.device_pipeline import DeviceAugmenter, RawIdBatcher
from unirec_tpu_torch.data.history import UserHistory
from unirec_tpu_torch.data.sampler import AliasTable, NegativeSampler
from unirec_tpu_torch.ops import member as MB
from unirec_tpu_torch.ops import scatter_accum as SA

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jax_sa, "_INTERPRET", True)
    monkeypatch.setattr(jax_member, "_INTERPRET", True)


# ------------------------------------------------------------------ scatter
@pytest.mark.parametrize("M,N,D", [(4096, 500, 16), (3001, 498, 16), (300, 37, 8)])
def test_scatter_add_rows_matches_jax_and_numpy(interpret, M, N, D):
    rng = np.random.default_rng(M)
    ids = rng.integers(0, N, M).astype(np.int32)
    g = rng.normal(size=(M, D)).astype(np.float32)
    want = np.zeros((N, D), np.float32)
    np.add.at(want, ids, g)
    got = SA.scatter_add_rows(torch.from_numpy(ids), torch.from_numpy(g), N).numpy()
    jax1 = np.asarray(jax_sa.scatter_add_rows(jnp.asarray(ids), jnp.asarray(g), N, block=512))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, jax1, **TOL)
    if N % 2 == 0:
        got2 = SA.scatter_add_rows2(torch.from_numpy(ids), torch.from_numpy(g), N).numpy()
        jax2 = np.asarray(jax_sa.scatter_add_rows2(jnp.asarray(ids), jnp.asarray(g), N,
                                                   block=512))
        np.testing.assert_allclose(got2, jax2, **TOL)
        np.testing.assert_allclose(got2, want, **TOL)


def _skewed_ids(kind, M, N, rng):
    """Ids of M rows that pile onto few table rows: 80% padding (id 0, what
    the windows' left padding sends), all one id, or Zipf over the table."""
    if kind == "zero80":
        return np.where(rng.random(M) < 0.8, 0, rng.integers(1, N, M)).astype(np.int32)
    if kind == "equal":
        return np.full(M, N // 3, np.int32)
    return ((rng.zipf(1.3, M) - 1) % N).astype(np.int32)


@pytest.mark.parametrize("M", [3001, 1537])
@pytest.mark.parametrize("kind", ["zero80", "equal", "zipf"])
def test_scatter_add_rows_matches_jax_and_numpy_on_skewed_ids(interpret, kind, M):
    """The ids the card's sorted-tile body combines (csrc/scatter_add.cu),
    with a ragged row count: the plain version against np.add.at and the
    interpret-mode JAX kernel; f32 within 1e-5 plus 1e-5 of the sum of the
    magnitudes added at each element (sums of up to M unit rows in other
    orders)."""
    N, D = 500, 16
    rng = np.random.default_rng(M + len(kind))
    ids = _skewed_ids(kind, M, N, rng)
    g = rng.normal(size=(M, D)).astype(np.float32)
    want = np.zeros((N, D), np.float32)
    np.add.at(want, ids, g)
    mag = np.zeros((N, D), np.float32)
    np.add.at(mag, ids, np.abs(g))
    tol = 1e-5 + 1e-5 * mag
    got = SA.scatter_add_rows(torch.from_numpy(ids), torch.from_numpy(g), N).numpy()
    jax1 = np.asarray(jax_sa.scatter_add_rows(jnp.asarray(ids), jnp.asarray(g), N, block=512))
    assert (np.abs(got - want) <= tol).all()
    assert (np.abs(got - jax1) <= tol).all()


@pytest.mark.parametrize("dtype,D,N,body", [
    (torch.bfloat16, 64, 50_000, "sorted"),   # the paths' item-embedding gradient
    (torch.float32, 64, 50_000, "sorted"),
    (torch.bfloat16, 8, 10, "sorted"),        # two 4-column chunks: a walker of two lanes
    (torch.bfloat16, 48, 10, "sorted"),       # 12 chunks: 16 lanes, four of them idle
    (torch.float32, 1024, 10, "sorted"),      # 256 chunks: 32 lanes, eight passes
    (torch.float32, 2048, 10, "sorted"),      # 512 chunks: 32 lanes, sixteen passes
    (torch.bfloat16, 72, 10, "sorted"),       # 18 chunks: 32 lanes, a pass and a part
    (torch.bfloat16, 18, 10, "per_row"),      # not whole 4-column chunks
    (torch.bfloat16, 64, 2 ** 21 - 1, "sorted"),
    (torch.bfloat16, 64, 2 ** 21, "per_row"),  # an id no longer fits its 21 bits of a key
    (torch.float16, 64, 10, "per_row"),
])
def test_scatter_body_rule(dtype, D, N, body):
    """ops/scatter_accum.py's copy of csrc/scatter_add.cu's rule at its
    boundaries (tests/test_torch_gpu.py holds the two together on the card)."""
    assert SA._scatter_body(dtype, D, N) == body


def test_scatter_rows2_needs_an_even_table():
    with pytest.raises(ValueError):
        SA.scatter_add_rows2(torch.zeros(4, dtype=torch.long), torch.zeros(4, 8), 7)


def test_gather_vmem_grad_matches_jax(interpret):
    rng = np.random.default_rng(5)
    table = rng.normal(size=(301, 16)).astype(np.float32)
    ids = rng.integers(0, 301, (24, 17)).astype(np.int32)
    G = rng.normal(size=(24, 17, 16)).astype(np.float32)
    t = torch.from_numpy(table).requires_grad_()
    out = SA.gather_vmem(t, torch.from_numpy(ids).long())
    np.testing.assert_array_equal(out.detach().numpy(), table[ids])
    (out * torch.from_numpy(G)).sum().backward()
    ref = jax.grad(lambda tt: jnp.vdot(jax_sa.gather_vmem(tt, jnp.asarray(ids)),
                                       jnp.asarray(G)))(jnp.asarray(table))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), **TOL)


def test_gather_vmem_grad_is_in_the_table_dtype():
    t = torch.randn(50, 8, dtype=torch.bfloat16, requires_grad=True)
    SA.gather_vmem(t, torch.tensor([1, 1, 3])).float().sum().backward()
    assert t.grad.dtype == torch.bfloat16
    assert float(t.grad[1, 0]) == 2.0 and float(t.grad[0].abs().sum()) == 0.0


# ------------------------------------------------------------------ member
def test_member_mask_matches_jax_exactly(interpret):
    rng = np.random.default_rng(9)
    rows = rng.integers(0, 40, (16, 30)).astype(np.int32)
    cand = rng.integers(0, 45, (16, 12)).astype(np.int32)
    cand[:, 0] = 0                                # 0 is never a member
    got = MB.member_mask(torch.from_numpy(rows), torch.from_numpy(cand)).numpy()
    ref = np.asarray(jax_member.member_mask(jnp.asarray(rows), jnp.asarray(cand)))
    np.testing.assert_array_equal(got, ref)
    assert got.any() and not got.all() and not got[:, 0].any()


@pytest.mark.parametrize("B,C", [(37, 200), (37, 13)])
def test_member_mask_matches_jax_on_padded_histories(interpret, B, C):
    """The paths' data: histories left-padded with 0 before their 0..C
    items, candidates drawn partly from the history (its padding among
    them) and partly at or below 0; an odd batch, and a history width the
    card's warp body loads in one pass (200) or that is not a multiple of 4
    (13). Exact against the interpret-mode JAX kernel."""
    rng = np.random.default_rng(C)
    lens = rng.integers(0, C + 1, B)
    lens[:2] = (0, C)
    rows = np.zeros((B, C), np.int32)
    for b in range(B):
        rows[b, C - lens[b]:] = rng.integers(1, 60, lens[b])
    cand = rng.integers(-3, 60, (B, 36)).astype(np.int32)
    cand[:, ::3] = rows[np.arange(B)[:, None], rng.integers(0, C, (B, 12))]
    got = MB.member_mask(torch.from_numpy(rows), torch.from_numpy(cand)).numpy()
    ref = np.asarray(jax_member.member_mask(jnp.asarray(rows), jnp.asarray(cand)))
    np.testing.assert_array_equal(got, ref)
    assert got.any() and not got[cand <= 0].any() and (cand <= 0).any()
    assert not got[0].any()                      # an empty history holds nothing


@pytest.mark.parametrize("C,K,body", [
    (200, 36, "warp"),     # the paths: 9 negatives x oversample 4
    (13, 36, "warp"),
    (7264, 64, "warp"),    # any history length, in passes of 256 ids
    (20_000, 1, "warp"),
    (200, 0, "warp"),
    (200, 65, "block"),    # more than two candidates a lane
    (13, 400, "block"),
])
def test_member_body_rule(C, K, body):
    """ops/member.py's copy of csrc/member.cu's rule at its boundaries
    (tests/test_torch_gpu.py holds the two together on the card)."""
    assert MB._member_body(C, K) == body


def test_member_gate_is_the_kernels_shared_memory():
    """The gate holds what csrc/member.cu needs (8 histories staged in
    shared memory), not the TPU's row-block rule and VMEM budget."""
    assert MB.member_supported(200) and MB.member_supported(7264)
    assert not MB.member_supported(7265) and not MB.member_supported(8000)


@pytest.mark.parametrize("B", [50, 37])
def test_membership_flag_reaches_member_mask_at_any_batch(monkeypatch, B):
    items, lens = _history(1, U=50, C=12, n_items=25)
    calls, real = [], MB.member_mask
    monkeypatch.setattr(MB, "member_mask",
                        lambda r, c: calls.append(tuple(r.shape)) or real(r, c))
    aug = DeviceAugmenter(_cfg(n_items=25, neg_membership_pallas=1),
                          UserHistory(items, lens), device="cpu")
    aug.sample_negatives(torch.Generator().manual_seed(0), torch.from_numpy(items[:B]),
                         torch.ones(B, 1, dtype=torch.int32))
    assert calls == [(B, 12)]


# --------------------------------------------------------- device pipeline
def _history(seed=0, U=30, C=20, n_items=40):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, C + 1, U).astype(np.int32)
    items = np.zeros((U, C), np.int32)
    m = np.arange(C)[None] < lens[:, None]
    items[m] = rng.integers(1, n_items, int(m.sum()))
    return items, lens


def _cfg(**kw):
    return dict(dict(n_items=40, n_sample_neg_train=3, neg_oversample_factor=4,
                     max_seq_len=8, dataloader="SeqRecDataset",
                     history_mask_mode="autoregressive", seq_last=1), **kw)


@pytest.mark.parametrize("mode,seq_last,explicit", [
    ("unorder", 0, False), ("autoregressive", 1, False), ("autoregressive", 0, True)])
def test_history_window_matches_jax(mode, seq_last, explicit):
    items, lens = _history()
    cfg = _cfg(history_mask_mode=mode, seq_last=seq_last)
    rng = np.random.default_rng(4)
    uid = rng.integers(0, 30, 24)
    rows, ln = items[uid], lens[uid]
    tgt = np.where(rng.random(24) < 0.7, rows[np.arange(24), rng.integers(0, 20, 24)],
                   rng.integers(1, 40, 24))[:, None].astype(np.int32)
    max_len = rng.integers(0, 25, 24).astype(np.int32) if explicit else None
    jaug = JaxAugmenter(cfg, JaxHistory(items, lens))
    jseq, jlen, _ = jaug.history_window(jax.random.PRNGKey(0), jnp.asarray(rows),
                                        jnp.asarray(ln), jnp.asarray(tgt),
                                        explicit_max_len=None if max_len is None
                                        else jnp.asarray(max_len))
    aug = DeviceAugmenter(cfg, UserHistory(items, lens), device="cpu")
    seq, slen, _ = aug.history_window(
        torch.Generator().manual_seed(0), torch.from_numpy(rows), torch.from_numpy(ln),
        torch.from_numpy(tgt),
        explicit_max_len=None if max_len is None else torch.from_numpy(max_len))
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    np.testing.assert_array_equal(slen.numpy(), np.asarray(jlen))


@pytest.mark.parametrize("membership", ["pallas", "compare"])
def test_sampled_negatives_obey_the_invariants(membership):
    items, lens = _history(1, U=50, C=12, n_items=25)
    flags = {"pallas": dict(neg_membership_pallas=1), "compare": {}}[membership]
    cfg = _cfg(n_items=25, n_sample_neg_train=5, **flags)
    aug = DeviceAugmenter(cfg, UserHistory(items, lens), device="cpu")
    uid = torch.arange(50, dtype=torch.int32)
    pos = torch.randint(1, 25, (50,), generator=torch.Generator().manual_seed(2))
    batch = aug.augment(aug.with_state({"user_id": uid, "item_id": pos,
                                        "weight": torch.ones(50)}),
                        torch.Generator().manual_seed(3))
    neg = batch["item_id"][:, 1:].numpy()
    assert batch["item_id"].shape == (50, 6) and (batch["item_id"][:, 0] == pos).all()
    assert batch["label"][:, 0].eq(1).all() and batch["label"][:, 1:].eq(0).all()
    for b in range(50):
        hist = set(items[b, :lens[b]].tolist())
        for n in neg[b]:
            assert n == 0 or (n not in hist and n != int(pos[b]))
    # with a crowded 24-item catalog some rows exhaust every proposal
    assert (neg > 0).mean() > 0.3
    assert batch["item_seq"].shape == (50, 8) and batch["item_seq_len"].max() <= 8


def test_zero_when_every_proposal_fails():
    """A user whose history holds the whole catalog gets only 0 negatives."""
    items = np.tile(np.arange(1, 11, dtype=np.int32), (2, 1))
    aug = DeviceAugmenter(_cfg(n_items=11, n_sample_neg_train=4),
                          UserHistory(items, np.array([10, 10], np.int32)), device="cpu")
    negs = aug.sample_negatives(torch.Generator().manual_seed(0),
                                torch.from_numpy(items), torch.tensor([[3], [4]]))
    assert negs.shape == (2, 4) and not negs.any()


def test_raw_batcher_matches_jax_order():
    from unirec_tpu.data.device_pipeline import RawIdBatcher as JaxBatcher
    uid, iid = np.arange(10), np.arange(10, 20)
    a, b = RawIdBatcher(uid, iid, 4, seed=3), JaxBatcher(uid, iid, 4, seed=3)
    a.set_epoch(2)
    b.set_epoch(2)
    for x, y in zip(a, b):
        for k in ("user_id", "item_id", "weight"):
            np.testing.assert_array_equal(x[k], y[k])


def test_unported_sampling_options_raise():
    """AERec rows are ported (they equal the JAX package's,
    tests/test_torch_cf.py); so is MoRec's objective-aware training
    (tests/test_torch_morec.py): a Trainer with enable_morec builds, and
    trains through the MoRec step once build_morec gives it a controller."""
    from unirec_tpu_torch.facility.trainer import Trainer
    from unirec_tpu_torch.models.cf import MF
    items, lens = _history()
    aug = DeviceAugmenter(_cfg(), UserHistory(items, lens), aerec=True, device="cpu")
    raw = {"user_id": torch.tensor([1, 2]), "item_id": torch.zeros(2, dtype=torch.int32),
           "weight": torch.ones(2)}
    out = aug.augment(raw, torch.Generator().manual_seed(0))
    assert torch.equal(out["item_seq"], torch.from_numpy(items[[1, 2]]))
    cfg = dict(_cfg(), n_users=30, enable_morec=1)
    tr = Trainer(cfg, MF(cfg), device="cpu")
    assert tr.objective_controller is None and tr._morec_sampler is None


# ---------------------------------------------------- popularity negatives
def _popularity(n_items, seed=0):
    """Zipf-like interaction counts over a shuffled catalog; item 0 none."""
    rng = np.random.default_rng(seed)
    pop = np.floor(5000.0 / rng.permutation(np.arange(1, n_items + 1)) ** 0.9)
    pop[0] = 0
    return pop.astype(np.int64)


@pytest.mark.parametrize("kind", ["zipf", "with_zeros", "one_heavy"])
def test_alias_table_equals_jax(kind):
    rng = np.random.default_rng(7)
    w = {"zipf": _popularity(300).astype(np.float64) ** 0.75,
         "with_zeros": np.where(rng.random(257) < 0.3, 0.0, rng.random(257)),
         "one_heavy": np.r_[1000.0, np.ones(99)]}[kind]
    got, ref = AliasTable(w), JaxAliasTable(w)
    np.testing.assert_array_equal(got.thresh, ref.thresh)
    np.testing.assert_array_equal(got.alias, ref.alias)
    p = got.thresh.copy()                  # each index's probability under sample()
    np.add.at(p, got.alias, 1.0 - got.thresh)
    np.testing.assert_allclose(p / len(w), w / w.sum(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("alpha", [0.5, 1.0])
def test_device_draws_follow_the_alias_table(alpha):
    """The augmenter's device table is JAX's (f32 thresholds, int32
    aliases, the same values), and 10^6 draws from it match the table's
    probabilities (popularity ** alpha, item 0 never) within a total
    variation distance of 0.01 (about 0.005 is expected from sampling)."""
    n, pop = 200, _popularity(200)
    items, lens = _history(U=4, n_items=n)
    cfg = _cfg(n_items=n, neg_by_pop_alpha=alpha)
    aug = DeviceAugmenter(cfg, UserHistory(items, lens), item_popularity=pop, device="cpu")
    ref = JaxAugmenter(cfg, JaxHistory(items, lens), item_popularity=pop).state
    for k in ("alias_thresh", "alias_alias"):
        np.testing.assert_array_equal(aug.state[k].numpy(), np.asarray(ref[k]))
    assert aug.state["alias_thresh"].dtype == torch.float32
    assert aug.state["alias_alias"].dtype == torch.int32
    draws = aug._draw(torch.Generator().manual_seed(0), (1000, 1000))
    assert draws.dtype == torch.int32 and int(draws.min()) >= 1
    freq = np.bincount(draws.numpy().ravel(), minlength=n) / draws.numel()
    p = pop.astype(np.float64) ** alpha
    assert 0.5 * np.abs(freq - p / p.sum()).sum() < 0.01


def _popular_history(n_items, pop, U=64, C=24, seed=3):
    """Histories drawn by popularity, so popularity draws hit them often."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, C + 1, U).astype(np.int32)
    items = np.zeros((U, C), np.int32)
    m = np.arange(C)[None] < lens[:, None]
    items[m] = rng.choice(n_items, int(m.sum()), p=pop / pop.sum())
    return items, lens


def _hold_first_survivor(negs, cand, items, lens, pos, n_neg, over):
    """Each slot is its first proposal that is neither in the history nor
    the positive, and 0 exactly when every proposal failed."""
    zeros = 0
    for b in range(len(negs)):
        bad = set(items[b, :lens[b]].tolist()) | {int(pos[b])}
        for j in range(n_neg):
            ok = [c for c in cand[b, j * over:(j + 1) * over] if c not in bad]
            assert negs[b, j] == (ok[0] if ok else 0), (b, j)
            zeros += not ok
    return zeros


@pytest.mark.parametrize("membership", ["pallas", "compare"])
def test_popularity_negatives_obey_the_invariants(membership):
    n = 60
    pop = _popularity(n, seed=2)
    items, lens = _popular_history(n, pop)
    flags = {"pallas": dict(neg_membership_pallas=1), "compare": {}}[membership]
    cfg = _cfg(n_items=n, n_sample_neg_train=6, neg_by_pop_alpha=1.0, **flags)
    aug = DeviceAugmenter(cfg, UserHistory(items, lens), item_popularity=pop, device="cpu")
    drawn, draw = [], aug._draw
    aug._draw = lambda gen, shape: drawn.append(draw(gen, shape)) or drawn[-1]
    uid = torch.arange(64, dtype=torch.int32)
    pos = torch.from_numpy(np.where(lens > 0, items[:, 0], 1).astype(np.int32))
    batch = aug.augment(aug.with_state({"user_id": uid, "item_id": pos,
                                        "weight": torch.ones(64)}),
                        torch.Generator().manual_seed(4))
    negs = batch["item_id"][:, 1:].numpy()
    assert batch["item_id"].shape == (64, 7) and (batch["item_id"][:, 0] == pos).all()
    zeros = _hold_first_survivor(negs, drawn[0].numpy(), items, lens, pos.numpy(), 6, 4)
    assert 0 < zeros < negs.size // 2      # popular histories exhaust some slots


def test_host_sampler_popularity_negatives_obey_the_invariants():
    """The one-vs-k eval sampler with item_popularity: draws from the same
    alias table, the same first-survivor rule."""
    n = 60
    pop = _popularity(n, seed=2)
    items, lens = _popular_history(n, pop)
    sampler = NegativeSampler(n, 6, user_history=UserHistory(items, lens),
                              item_popularity=pop, neg_by_pop_alpha=1.0)
    ref = JaxNegativeSampler(n, 6, item_popularity=pop, neg_by_pop_alpha=1.0).alias
    np.testing.assert_array_equal(sampler.alias.thresh, ref.thresh)
    np.testing.assert_array_equal(sampler.alias.alias, ref.alias)
    drawn, draw = [], sampler._draw
    sampler._draw = lambda rng, shape: drawn.append(draw(rng, shape)) or drawn[-1]
    uid = np.arange(64)
    pos = np.where(lens > 0, items[:, 0], 1)
    negs = sampler(np.random.default_rng(5), uid, pos)
    assert negs.shape == (64, 6) and negs.dtype == np.int32 and (drawn[0] > 0).all()
    zeros = _hold_first_survivor(negs, drawn[0], items, lens, pos, 6, 4)
    assert 0 < zeros < negs.size // 2
