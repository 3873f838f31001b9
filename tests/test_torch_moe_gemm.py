"""The port's grouped expert FFN on the host: the plain PyTorch version
against the JAX oracle and the Pallas kernel in interpret mode, the
top-k gather/mask/combine wrappers against JAX, the invariance the
engine relies on, and the CUDA wrapper's refusals.  Tolerance: fp32
sums in another order (rtol = atol = 1e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.moe_gemm import combine_topk as jcombine
from repro.kernels.moe_gemm import grouped_topk_contrib as jcontrib
from repro.kernels.moe_gemm import moe_ffn_kernel as jkernel
from repro.kernels.moe_gemm import moe_ffn_ref as jref
from repro_torch.kernels.moe_gemm import (combine_topk, grouped_topk_contrib,
                                          moe_ffn, moe_ffn_kernel, moe_ffn_ref)

TOL = dict(rtol=1e-5, atol=1e-5)


def _ffn_inputs(seed, e, c, d, f):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((e, c, d)).astype(np.float32),
            (rng.standard_normal((e, d, f)) * d ** -0.5).astype(np.float32),
            (rng.standard_normal((e, d, f)) * d ** -0.5).astype(np.float32),
            (rng.standard_normal((e, f, d)) * f ** -0.5).astype(np.float32))


@settings(deadline=None, max_examples=6)
@given(seed=st.integers(0, 1000), e=st.integers(1, 4), c=st.integers(1, 6),
       f=st.sampled_from([32, 96, 100]))
def test_plain_ffn_matches_jax_oracle(seed, e, c, f):
    arrs = _ffn_inputs(seed, e, c, 64, f)
    ours = moe_ffn_ref(*map(torch.from_numpy, arrs)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jref(*map(jnp.asarray, arrs))), **TOL)


@pytest.mark.parametrize("e,c,d,f,bf", [(2, 3, 64, 96, 64), (3, 8, 32, 160, 64),
                                        (1, 1, 64, 128, 128)])
def test_plain_ffn_matches_pallas_interpret(e, c, d, f, bf):
    """Including a ragged final F tile (96 over 64-wide tiles), which the
    Pallas kernel masks to zero."""
    arrs = _ffn_inputs(e * 100 + f, e, c, d, f)
    ker = jkernel(*map(jnp.asarray, arrs), block_c=8, block_f=bf, interpret=True)
    ours = moe_ffn(*map(torch.from_numpy, arrs)).numpy()
    np.testing.assert_allclose(ours, np.asarray(ker), **TOL)


def test_plain_ffn_takes_bf16_weights():
    x, wg, wu, wd = _ffn_inputs(3, 2, 2, 64, 96)
    wb = [torch.from_numpy(w).to(torch.bfloat16) for w in (wg, wu, wd)]
    got = moe_ffn_ref(torch.from_numpy(x), *wb)
    want = moe_ffn_ref(torch.from_numpy(x), *(w.float() for w in wb))
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


def _contrib_inputs(seed, n, k, es, d=64, f=96):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, d)).astype(np.float32)
    wg = (rng.standard_normal((es, d, f)) * d ** -0.5).astype(np.float32)
    wu = (rng.standard_normal((es, d, f)) * d ** -0.5).astype(np.float32)
    wd = (rng.standard_normal((es, f, d)) * f ** -0.5).astype(np.float32)
    slot = rng.integers(-1, es, (n, k)).astype(np.int32)     # -1: not in this call
    gates = rng.random((n, k)).astype(np.float32)
    return h, wg, wu, wd, slot, gates


@settings(deadline=None, max_examples=6)
@given(seed=st.integers(0, 1000), n=st.sampled_from([1, 3, 5, 6]),
       k=st.integers(1, 3), es=st.integers(1, 5))
def test_grouped_contrib_and_combine_match_jax(seed, n, k, es):
    """Non-pow2 rows and experts, ``-1`` slots masked to exact zeros."""
    arrs = _contrib_inputs(seed, n, k, es)
    jc = np.asarray(jcontrib(*map(jnp.asarray, arrs)))
    tc = grouped_topk_contrib(*map(torch.from_numpy, arrs))
    assert tc.shape == (n, k, 64) and tc.dtype == torch.float32
    np.testing.assert_allclose(tc.numpy(), jc, **TOL)
    masked = arrs[4] < 0
    assert (tc.numpy()[masked] == 0).all()
    np.testing.assert_allclose(combine_topk(tc).numpy(),
                               np.asarray(jcombine(jnp.asarray(jc))), **TOL)


def test_pair_values_do_not_depend_on_what_rode_along():
    """A (row, rank) contribution computed with one stacked expert equals
    the one computed with all of them stacked, bit for bit — the property
    that makes engine waves equal the reference dispatch."""
    h, wg, wu, wd, _, gates = _contrib_inputs(7, 1, 2, 8)
    slot_all = np.array([[2, 5]], np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    full = grouped_topk_contrib(t(h), t(wg), t(wu), t(wd), t(slot_all), t(gates))
    for rank, expert in enumerate((2, 5)):
        slot = np.full((1, 2), -1, np.int32)
        slot[0, rank] = 0
        one = grouped_topk_contrib(t(h), t(wg[expert:expert + 1]), t(wu[expert:expert + 1]),
                                   t(wd[expert:expert + 1]), t(slot), t(gates))
        assert torch.equal(one[0, rank], full[0, rank])


@pytest.mark.parametrize("budget", [4, 16, 64])
def test_row_blocks_change_no_bit(monkeypatch, budget):
    """A long row set runs in blocks of ``MAX_EXPERT_ROWS // experts``
    rows (1, 4 and 16 rows for 4 experts here); the contributions equal
    those of one call, bit for bit, and still match JAX."""
    from repro_torch.kernels.moe_gemm import ops
    arrs = _contrib_inputs(11, 37, 2, 4)
    args = tuple(map(torch.from_numpy, arrs))
    whole = grouped_topk_contrib(*args)
    monkeypatch.setattr(ops, "MAX_EXPERT_ROWS", budget)
    blocked = grouped_topk_contrib(*args)
    assert torch.equal(blocked, whole)
    np.testing.assert_allclose(blocked.numpy(), np.asarray(jcontrib(*map(jnp.asarray, arrs))),
                               **TOL)


@pytest.mark.parametrize("budget", [4, 16])
def test_bf16_weights_take_their_own_row_budget_and_it_changes_no_bit(monkeypatch, budget):
    """bf16 weights run in blocks of ``MAX_EXPERT_ROWS_BF16 // experts``
    rows (their kernel's workspace is far smaller than fp32's), fp32
    weights still in blocks of ``MAX_EXPERT_ROWS // experts``; either split
    gives the bits of one call."""
    from repro_torch.kernels.moe_gemm import ops
    h, wg, wu, wd, slot, gates = map(torch.from_numpy, _contrib_inputs(12, 37, 2, 4))
    wg, wu, wd = (w.to(torch.bfloat16) for w in (wg, wu, wd))
    whole = grouped_topk_contrib(h, wg, wu, wd, slot, gates)
    calls = []
    monkeypatch.setattr(ops, "MAX_EXPERT_ROWS_BF16", budget)
    monkeypatch.setattr(ops, "MAX_EXPERT_ROWS", 1 << 20)
    real = ops._grouped_contrib
    monkeypatch.setattr(ops, "_grouped_contrib",
                        lambda h, *a: calls.append(h.shape[0]) or real(h, *a))
    blocked = grouped_topk_contrib(h, wg, wu, wd, slot, gates)
    assert torch.equal(blocked, whole)
    assert max(calls) == budget // 4 and len(calls) == -(-37 // (budget // 4))


def test_combine_sums_in_rank_order():
    """(1e8 + 1) - 1e8 is 0 in fp32, where (1e8 - 1e8) + 1 would be 1."""
    contrib = torch.tensor([[[1e8], [1.0], [-1e8]]], dtype=torch.float32)
    assert combine_topk(contrib).item() == 0.0


def test_kernel_wrapper_refuses_host_tensors():
    """On a CPU tensor only the plain version runs; the kernel wrapper
    itself refuses before building anything."""
    x, wg, wu, wd = map(torch.from_numpy, _ffn_inputs(0, 1, 1, 64, 96))
    with pytest.raises(ValueError, match="CUDA"):
        moe_ffn_kernel(x, wg, wu, wd)
    assert moe_ffn_kernel.launches == 0
