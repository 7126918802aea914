"""The port's blocked linear algebra (unirec_tpu_torch/ops/linalg.py) against
the JAX package's (unirec_tpu/ops/linalg.py) and numpy, on the CPU.

The same f32 SPD matrices (R^T R + 10 I from a numpy seed) go through both
packages, with block sizes that leave a ragged last block. Tolerances, as
tests/test_linalg.py states them for the JAX routines: the Cholesky factor
within 5e-5 of numpy's (f64) and of the JAX one; X L = I within 2e-4 for
the triangular inverses; inverses within 2e-5 of the largest entry; the
port against the JAX package within the same bounds (both are f32, with
products summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unirec_tpu.ops import linalg as JL
from unirec_tpu_torch.ops import linalg as TL


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spd(n, seed=0):
    rng = np.random.default_rng(seed)
    R = rng.normal(size=(n + 32, n)).astype(np.float64)
    return (R.T @ R + 10 * np.eye(n)).astype(np.float32)


def _close_scaled(got, want, atol):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0)


@pytest.mark.parametrize("n,nb", [(64, 32), (100, 32), (257, 64), (33, 33)])
def test_block_bounds_match_jax(n, nb):
    assert TL._block_bounds(n, nb) == JL._block_bounds(n, nb)


@pytest.mark.parametrize("n,nb", [(64, 32), (100, 32), (257, 64)])
def test_blocked_cholesky_matches_jax_and_numpy(n, nb):
    A = _spd(n)
    got = TL.blocked_cholesky(torch.tensor(A), nb).numpy()
    np.testing.assert_allclose(got, np.linalg.cholesky(A.astype(np.float64)), atol=5e-5)
    np.testing.assert_allclose(got, np.asarray(JL.blocked_cholesky(jnp.asarray(A), nb)),
                               atol=5e-5)
    assert np.all(np.triu(got, 1) == 0)


def test_blocked_cholesky_works_in_place():
    A = torch.tensor(_spd(100, seed=5))
    out = TL.blocked_cholesky(A, 32)
    assert out.data_ptr() == A.data_ptr()


@pytest.mark.parametrize("n,nb", [(100, 32), (130, 48)])
def test_blocked_tri_inv_lower_matches_jax(n, nb):
    A = _spd(n, seed=1)
    L = np.linalg.cholesky(A.astype(np.float64)).astype(np.float32)
    X = TL.blocked_tri_inv_lower(torch.tensor(L), nb).numpy()
    np.testing.assert_allclose(X @ L, np.eye(n), atol=2e-4)
    np.testing.assert_allclose(X, np.asarray(JL.blocked_tri_inv_lower(jnp.asarray(L), nb)),
                               atol=2e-5)


def test_blocked_tri_inv_upper_matches_jax_and_is_the_lower_transposed():
    A = _spd(130, seed=3)
    L = np.linalg.cholesky(A.astype(np.float64)).astype(np.float32)
    XU = TL.blocked_tri_inv_upper(torch.tensor(L.T.copy()), 32).numpy()
    np.testing.assert_allclose(XU @ L.T, np.eye(130), atol=2e-4)
    np.testing.assert_allclose(XU, np.asarray(JL.blocked_tri_inv_upper(jnp.asarray(L.T), 32)),
                               atol=2e-5)
    X = TL.blocked_tri_inv_lower(torch.tensor(L), 32).numpy()
    np.testing.assert_allclose(XU, X.T, atol=1e-5)
    # assume_triangular=False zeroes junk below the diagonal first
    junk = L.T + np.tril(np.ones_like(L), -1)
    XU2 = TL.blocked_tri_inv_upper(torch.tensor(junk), 32).numpy()
    np.testing.assert_allclose(XU2, XU, atol=1e-6)


@pytest.mark.parametrize("n,nb", [(100, 32), (200, 64)])
def test_spd_inverse_matches_jax_and_numpy(n, nb):
    A = _spd(n, seed=1)
    got = TL.spd_inverse(torch.tensor(A), nb).numpy()
    _close_scaled(got, np.linalg.inv(A.astype(np.float64)), 2e-5)
    _close_scaled(got, np.asarray(JL.spd_inverse(jnp.asarray(A), nb)), 2e-5)


@pytest.mark.parametrize("out_block", [48, 0])
def test_spd_inverse_columns_stream_matches_jax(out_block):
    A = _spd(130, seed=2)
    got = np.zeros((130, 130), np.float32)
    widths = []
    for c, slab in TL.spd_inverse_columns(torch.tensor(A), 32, out_block=out_block):
        got[:, c:c + slab.shape[1]] = slab.numpy()
        widths.append(slab.shape[1])
    cb = out_block or 32
    assert sum(widths) == 130 and max(widths) == cb      # the last slab is ragged
    want = np.zeros((130, 130), np.float32)
    for c, slab in JL.spd_inverse_columns(jnp.asarray(A), 32, out_block=out_block):
        want[:, c:c + slab.shape[1]] = slab
    _close_scaled(got, want, 2e-5)
    _close_scaled(got, np.linalg.inv(A.astype(np.float64)), 2e-5)


def test_full_f32_restores_the_callers_tf32_setting():
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        for setting in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = setting
            with TL.full_f32():
                assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cuda.matmul.allow_tf32 is setting
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
