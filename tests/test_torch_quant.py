"""The port's quantizers and transport codecs are byte-equal to
``repro.quant``: int8 codes and scales, nf4 codes (packed high nibble
first) and absmax, packed byte counts — including stacked leaves, whose
int8 scales are shared across repeats and experts."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_bridge import bridge, torch_cfg
from conftest import tiny_moe
from repro.models import init_params as jinit
from repro_torch.models.transformer import tree_leaves

# the packages re-export a function named ``quantize``: fetch the modules
jq = importlib.import_module("repro.quant.quantize")
jt = importlib.import_module("repro.quant.transport")
tq = importlib.import_module("repro_torch.quant.quantize")
tt = importlib.import_module("repro_torch.quant.transport")

SHAPES = [(64, 96), (3, 64, 100), (2, 4, 16, 24), (5, 7)]


def _w(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@settings(deadline=None, max_examples=8)
@given(seed=st.integers(0, 10_000), shape=st.sampled_from(SHAPES))
def test_int8_codes_and_scales_byte_equal(seed, shape):
    w = _w(seed, shape)
    jqv, js = jq.quantize_int8(jnp.asarray(w))
    tqv, ts = tq.quantize_int8(torch.from_numpy(w))
    assert tqv.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_int8_round_half_to_even_matches():
    """Values landing exactly on .5 steps round to even in both."""
    w = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5]], np.float32).T.copy()
    np.testing.assert_array_equal(tq.quantize_int8(torch.from_numpy(w))[0].numpy(),
                                  np.asarray(jq.quantize_int8(jnp.asarray(w))[0]))


@settings(deadline=None, max_examples=8)
@given(seed=st.integers(0, 10_000), shape=st.sampled_from(SHAPES))
def test_nf4_codes_scales_and_packing_byte_equal(seed, shape):
    w = _w(seed, shape)
    jc, js = jq.quantize_nf4(jnp.asarray(w))
    tc, ts = tq.quantize_nf4(torch.from_numpy(w))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jp = np.asarray(jq.pack_nf4_codes(jc))
    tp = tq.pack_nf4_codes(tc)
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(tq.unpack_nf4_codes(tp, tc.shape[0]).numpy(),
                                  tc.numpy())
    np.testing.assert_array_equal(
        tq.dequantize_nf4(tc, ts, shape).numpy(),
        np.asarray(jq.dequantize_nf4(jc, js, shape)))


def test_nf4_argmin_ties_take_the_first_level():
    """A value exactly between two levels picks the lower index, as
    ``jnp.argmin`` does."""
    lv = tq.NF4_LEVELS
    mid = float((lv[7] + lv[8]) / 2)
    w = np.zeros((1, 64), np.float32)
    w[0, 0], w[0, 1] = 1.0, mid
    np.testing.assert_array_equal(tq.quantize_nf4(torch.from_numpy(w))[0].numpy(),
                                  np.asarray(jq.quantize_nf4(jnp.asarray(w))[0]))


@pytest.mark.parametrize("scheme", ["fp32", "fp16", "int8", "nf4"])
@pytest.mark.parametrize("shape", [(64, 96), (96, 64), (13, 7)])
def test_codec_pack_unpack_and_nbytes_match(scheme, shape):
    w = _w(7 * len(scheme) + sum(shape), shape)
    jpw = jt.get_codec(scheme).pack(jnp.asarray(w))
    tpw = tt.get_codec(scheme).pack(torch.from_numpy(w))
    assert tpw.nbytes == jpw.nbytes
    assert tt.get_codec(scheme).packed_nbytes(shape) == tpw.nbytes
    for a, b in zip(tpw.parts, jpw.parts):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tt.get_codec(scheme).unpack(tpw).numpy(),
                                  np.asarray(jt.get_codec(scheme).unpack(jpw)))


@pytest.mark.parametrize("scheme", ["fp16", "int8", "nf4"])
def test_shadow_params_and_nbytes_match_on_stacked_leaves(scheme):
    """``shadow_params`` quantizes every large STACKED leaf as one tensor
    (int8 scales over all axes but the last), exactly like the reference."""
    cfg = tiny_moe()
    params = jinit(cfg, jax.random.PRNGKey(0))
    js = jq.shadow_params(params, scheme)
    ts = tq.shadow_params(bridge(params), scheme)
    for a, b in zip(jax.tree.leaves(js), tree_leaves(ts)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert tq.shadow_nbytes(ts, scheme) == jq.shadow_nbytes(js, scheme)


@pytest.mark.parametrize("scheme", ["fp32", "int8", "nf4"])
def test_transport_params_match(scheme):
    cfg = tiny_moe()
    params = jinit(cfg, jax.random.PRNGKey(1))
    jp = jt.transport_params(cfg, params, scheme)
    tp = tt.transport_params(torch_cfg(cfg), bridge(params), scheme)
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_policy_resolution_and_unknown_schemes():
    assert tt.resolve_policy(None).trivial
    assert tt.resolve_policy("int8").describe() == "uniform/int8"
    pol = tt.UniformPolicy("nf4")
    assert tt.resolve_policy(pol) is pol
    with pytest.raises(ValueError):
        tt.UniformPolicy("int4")
    with pytest.raises(TypeError):
        tt.resolve_policy(3)
