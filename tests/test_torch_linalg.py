"""The port's blocked Cholesky pair (``ops/linalg.py``: ``blocked_cholesky``,
``blocked_tril_inv``) against the JAX package's (JAX linalg.py:293-383) on
the CPU, on the same matrices made with numpy.

n = 1,000 with the default block of 384 pads the last panel (3 panels,
152 rows of identity). Measured gaps to JAX's factor, relative to its
largest entry: float64 3.1e-16, float32 1.6e-7 (JAX's own factor lies
1.1e-7 from the float64 one); inverses 1.0e-16 and 5.6e-8. The tolerances
sit 12-30x above.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (sizes torch's thread pool to the xdist worker)

from bundleadjustment_benchmarks_tpu.ops import linalg as jlinalg
from bundleadjustment_benchmarks_tpu_torch.ops import linalg

N = 1000
BLOCK = 384
#: Factor and inverse gaps to JAX's, relative to the largest entry.
RTOL = {torch.float32: 2e-6, torch.float64: 1e-14}
NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def spd(n=N, seed=0) -> np.ndarray:
    """A well-conditioned SPD matrix: G G^T / n + I."""
    g = np.random.default_rng(seed).normal(size=(n, n))
    return g @ g.T / n + np.eye(n)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_blocked_cholesky_matches_jax(dtype):
    S = spd().astype(NP_DTYPE[dtype])
    L, info = linalg.blocked_cholesky(torch.from_numpy(S), block=BLOCK)
    Lj = jlinalg.blocked_cholesky(jnp.asarray(S), block=BLOCK)
    assert L.dtype == dtype and L.shape == (N, N)
    assert info.item() == 0 and bool(torch.isfinite(L).all())
    assert rel(L.numpy(), Lj) < RTOL[dtype]
    assert torch.equal(L, torch.tril(L))
    exact = np.linalg.cholesky(S.astype(np.float64))
    assert rel(L.numpy(), exact) < RTOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_blocked_tril_inv_matches_jax(dtype):
    L = np.linalg.cholesky(spd(seed=1)).astype(NP_DTYPE[dtype])
    X = linalg.blocked_tril_inv(torch.from_numpy(L), block=BLOCK)
    Xj = jlinalg.blocked_tril_inv(jnp.asarray(L), block=BLOCK)
    assert rel(X.numpy(), Xj) < RTOL[dtype]
    eye = (X @ torch.from_numpy(L)).double() - torch.eye(N, dtype=torch.float64)
    assert eye.abs().max().item() < 10 * RTOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_blocked_solve_matches_cholesky_solve(dtype):
    """The two products through the blocked inverse solve S x = b as
    ``torch.cholesky_solve`` does."""
    S = torch.from_numpy(spd(seed=2).astype(NP_DTYPE[dtype]))
    b = torch.from_numpy(np.random.default_rng(3).normal(size=N)).to(dtype)
    L, _ = linalg.blocked_cholesky(S, block=BLOCK)
    X = linalg.blocked_tril_inv(L, block=BLOCK)
    x = X.T @ (X @ b)
    ref = torch.cholesky_solve(b[:, None], torch.linalg.cholesky(S))[:, 0]
    assert rel(x.numpy(), ref.numpy()) < 10 * RTOL[dtype]


@pytest.mark.parametrize("column", [0, 200, 500, 999])
def test_indefinite_input_reports_info(column):
    """A negative pivot in the first, a middle or the last (padded) panel:
    ``info`` names the same leading minor as ``cholesky_ex``'s, where JAX's
    factor turns NaN."""
    S = spd()
    S[column, column] = -10.0
    L, info = linalg.blocked_cholesky(torch.from_numpy(S), block=BLOCK)
    assert info.dtype == torch.int32 and info.shape == ()
    assert info.item() == column + 1
    assert info.item() == torch.linalg.cholesky_ex(torch.from_numpy(S)).info.item()
    Lj = np.asarray(jlinalg.blocked_cholesky(jnp.asarray(S), block=BLOCK))
    assert not np.isfinite(Lj).all()
    # Columns before the breaking panel are the factor's, as in JAX's.
    done = (column // BLOCK) * BLOCK
    if done:
        assert rel(L[:, :done].numpy(), Lj[:, :done]) < RTOL[torch.float64]


def test_unpadded_and_single_panel():
    """n a multiple of the block (no padding) and n below one block."""
    for n, block in ((768, 384), (100, 384)):
        S = spd(n, seed=4)
        L, info = linalg.blocked_cholesky(torch.from_numpy(S), block=block)
        Lj = jlinalg.blocked_cholesky(jnp.asarray(S), block=block)
        assert info.item() == 0
        assert rel(L.numpy(), Lj) < RTOL[torch.float64]
