"""The port's w8a16 matmul op (``repro_torch.kernels.int8_matmul``): its
plain version against the JAX oracle and the Pallas kernel in interpret
mode, on inputs made with numpy from a seed.  The CUDA kernel is held
against the plain version in ``tests/test_torch_cuda.py``.

Tolerance: max|a - b| <= 1e-5 * max|b| (fp32 sums in another order; the
Pallas kernel and the CUDA kernel scale after the sum, the oracle before
it), well inside JAX's own ``atol=5e-2, rtol=1e-2``.  bf16 x is widened
to fp32 exactly by both, so it takes the same tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import int8_matmul_kernel as pallas_int8_matmul
from repro.kernels import int8_matmul_ref as jax_int8_matmul_ref
from repro_torch.kernels import int8_matmul, int8_matmul_kernel, int8_matmul_ref

REL_TOL = 1e-5


def _inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    sc = rng.uniform(1e-3, 1e-2, (n,)).astype(np.float32)
    return x, wq, sc


def _torch_x(x, xdtype):
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if xdtype == "bfloat16" else t


def _jax_x(x, xdtype):
    return jnp.asarray(x).astype(jnp.bfloat16 if xdtype == "bfloat16" else jnp.float32)


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=1e-2)


# the shapes and Pallas tiles of tests/test_kernels.py::test_int8_matmul_sweep
SWEEP = [(32, 128, 64, 16, 32, 64), (64, 256, 96, 32, 32, 64),
         (13, 70, 33, 8, 16, 32)]      # ragged everywhere


@pytest.mark.parametrize("m,k,n,bm,bn,bk", SWEEP)
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_oracle_and_pallas_interpret(m, k, n, bm, bn, bk, xdtype):
    x, wq, sc = _inputs(m, k, n, seed=m + k + n)
    got = int8_matmul_ref(_torch_x(x, xdtype), torch.from_numpy(wq), torch.from_numpy(sc))
    assert got.dtype == torch.float32
    jx, jw, js = _jax_x(x, xdtype), jnp.asarray(wq), jnp.asarray(sc)
    _close(got.numpy(), jax_int8_matmul_ref(jx, jw, js))
    _close(got.numpy(), pallas_int8_matmul(jx, jw, js, block_m=bm, block_n=bn, block_k=bk,
                                           interpret=True))


@pytest.mark.parametrize("direction", ["up", "down"])
def test_plain_version_matches_jax_oracle_at_mixtral_expert_shapes(direction):
    """(4, 4096) x (4096, 14336) and (4, 14336) x (14336, 4096): the
    matrices of a Mixtral-8x7B expert."""
    d, f = 4096, 14336
    k, n = (d, f) if direction == "up" else (f, d)
    x, wq, sc = _inputs(4, k, n, seed=7)
    got = int8_matmul_ref(torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(sc))
    _close(got.numpy(), jax_int8_matmul_ref(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(sc)))


def test_op_takes_the_plain_version_on_the_host_and_refuses_other_devices():
    x, wq, sc = _inputs(5, 40, 12, seed=3)
    tx, tw, ts = torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(sc)
    before = int8_matmul_kernel.launches
    assert torch.equal(int8_matmul(tx, tw, ts), int8_matmul_ref(tx, tw, ts))
    with pytest.raises(ValueError):
        int8_matmul(tx.to("meta"), tw.to("meta"), ts.to("meta"))
    with pytest.raises(ValueError):
        int8_matmul_kernel(tx, tw, ts)              # the kernel takes CUDA tensors only
    assert int8_matmul_kernel.launches == before
