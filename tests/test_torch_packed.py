"""The port's packed-resident path on the host, held against the JAX
package on the same numpy inputs and bridged weights: the tile-aligned
device layout and its dequantization (bitwise), the plain packed grouped
FFN (fp32 tolerance: XLA and PyTorch sum in other orders), the tiered
policy, and ``ODMoEEngine(packed_slots=True)`` — tokens, load events,
bytes moved, stats and every ``memory_report`` field exactly."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_bridge import bridge, prompt, torch_cfg, torch_trace
from conftest import tiny_moe
from repro.core import ODMoEEngine as JEngine
from repro.kernels.moe_gemm import grouped_topk_contrib_packed as jcontrib_packed
from repro.kernels.moe_gemm import moe_ffn_packed as jffn_packed
from repro.quant import TieredPolicy as JTiered
from repro.quant import device_layout as jlayout
from repro.quant import tileable as jtileable
from repro.quant.quantize import dequantize_tiles as jdeq
from repro.quant.quantize import nf4_pair_unpack as junpack
from repro.quant.transport import get_codec as jcodec
from repro_torch.core import ODMoEEngine
from repro_torch.kernels.moe_gemm import (grouped_topk_contrib, grouped_topk_contrib_packed,
                                          moe_ffn_packed, moe_ffn_packed_kernel,
                                          moe_ffn_packed_ref, moe_ffn_ref, packed_logical_f)
from repro_torch.models import greedy_generate
from repro_torch.models.transformer import tree_map
from repro_torch.quant import (TieredPolicy, dequantize_tiles, device_layout,
                               get_codec, nf4_pair_unpack, tileable)

N_TOK = 6
NAMES = ("w_gate", "w_up", "w_down")
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


def _weights(seed, e, d, f):
    rng = np.random.default_rng(seed)
    return {name: [(rng.standard_normal(shp) * shp[0] ** -0.5).astype(np.float32)
                   for _ in range(e)]
            for name, shp in (("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d)))}


def _stack_both(scheme, ws):
    """The same numpy weights packed and laid out by each package, stacked
    on the expert axis: (port parts, JAX parts)."""
    tparts, jparts = {}, {}
    for name, per in ws.items():
        tl = [device_layout(get_codec(scheme).pack(torch.from_numpy(w))) for w in per]
        jl = [jlayout(jcodec(scheme).pack(jnp.asarray(w))) for w in per]
        tparts[name] = tuple(torch.stack([p[j] for p in tl]) for j in range(len(tl[0])))
        jparts[name] = tuple(jnp.stack([jnp.asarray(p[j]) for p in jl])
                             for j in range(len(jl[0])))
    return tparts, jparts


@settings(deadline=None, max_examples=6)
@given(seed=st.integers(0, 10**6), scheme=st.sampled_from(["fp16", "int8", "nf4"]),
       e=st.integers(1, 3), d=st.sampled_from([64, 128]), f=st.sampled_from([64, 192]))
def test_device_layout_and_dequantize_tiles_bitwise(seed, scheme, e, d, f):
    tparts, jparts = _stack_both(scheme, _weights(seed, e, d, f))
    for name in NAMES:
        for tp, jp in zip(tparts[name], jparts[name]):
            assert tuple(tp.shape) == tuple(jp.shape)
            np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        got = dequantize_tiles(scheme, tparts[name])
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jdeq(scheme, jparts[name])))
    if scheme == "nf4":
        codes = tparts["w_gate"][0]
        np.testing.assert_array_equal(nf4_pair_unpack(codes).numpy(),
                                      np.asarray(junpack(jparts["w_gate"][0])))


@pytest.mark.parametrize("scheme", ["fp32", "fp16", "int8", "nf4"])
@pytest.mark.parametrize("shape", [(64, 96), (64, 128), (96, 64), (8, 8, 64), (128,)])
def test_tileable_equals_jax(scheme, shape):
    assert tileable(scheme, shape) == jtileable(scheme, shape)


def test_device_layout_refuses_untileable():
    pw = get_codec("nf4").pack(torch.zeros(64, 96))
    with pytest.raises(ValueError, match="tile-aligned"):
        device_layout(pw)


@pytest.mark.parametrize("scheme", ["fp16", "int8", "nf4"])
@pytest.mark.parametrize("e", [1, 2, 3])
def test_plain_packed_ffn_matches_jax_cpu_path(scheme, e):
    """JAX's ``moe_ffn_packed`` off the TPU is ``dequantize_tiles`` +
    ``moe_ffn_ref``; the port's plain version on the same parts agrees
    within fp32 tolerance (rtol 1e-5)."""
    d, f, c = 64, 128, 3
    tparts, jparts = _stack_both(scheme, _weights(e * 7, e, d, f))
    x = np.random.default_rng(e).standard_normal((e, c, d)).astype(np.float32)
    got = moe_ffn_packed(torch.from_numpy(x), tparts, scheme=scheme)
    want = np.asarray(jffn_packed(jnp.asarray(x), jparts, scheme=scheme))
    assert got.shape == (e, c, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert packed_logical_f(scheme, tparts) == f
    # the plain version IS dequantize + moe_ffn_ref, bit for bit
    full = [dequantize_tiles(scheme, tparts[n]) for n in NAMES]
    assert torch.equal(moe_ffn_packed_ref(torch.from_numpy(x), tparts, scheme=scheme),
                       moe_ffn_ref(torch.from_numpy(x), *full))


@pytest.mark.parametrize("scheme", ["int8", "nf4"])
def test_packed_contrib_equals_full_width_and_jax(scheme):
    """The packed top-k carrier is the full-width hot path on the
    dequantized weights, bit for bit, and agrees with JAX's."""
    d, f, k, e, n = 64, 128, 2, 3, 5
    tparts, jparts = _stack_both(scheme, _weights(11, e, d, f))
    rng = np.random.default_rng(3)
    h = rng.standard_normal((n, d)).astype(np.float32)
    slot = rng.integers(-1, e, (n, k)).astype(np.int32)
    gates = rng.random((n, k)).astype(np.float32)
    t = torch.from_numpy
    got = grouped_topk_contrib_packed(t(h), tparts, t(slot), t(gates), scheme=scheme)
    full = [dequantize_tiles(scheme, tparts[nm]) for nm in NAMES]
    assert torch.equal(got, grouped_topk_contrib(t(h), *full, t(slot), t(gates)))
    want = np.asarray(jcontrib_packed(jnp.asarray(h), jparts, jnp.asarray(slot),
                                      jnp.asarray(gates), scheme=scheme))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert (got.numpy()[slot < 0] == 0).all()


def test_packed_kernel_wrapper_refuses_without_launching():
    tparts, _ = _stack_both("nf4", _weights(0, 1, 64, 128))
    x = torch.zeros(1, 1, 64)
    with pytest.raises(ValueError, match="CUDA"):
        moe_ffn_packed_kernel(x, tparts, scheme="nf4")
    with pytest.raises(ValueError, match="no packed kernel"):
        moe_ffn_packed_kernel(x, tparts, scheme="int4")
    with pytest.raises(ValueError, match="aligned"):      # d = 32 is not a 64-multiple
        moe_ffn_packed_kernel(torch.zeros(1, 1, 32), tparts, scheme="nf4")
    assert moe_ffn_packed_kernel.launches == 0


# ---------------------------------------------------------------- engine
_SETUP = {}


def _setup(d_expert=128, dtype=None):
    key = (d_expert, dtype)
    if key not in _SETUP:
        from repro.models import init_params
        cfg = tiny_moe(num_layers=3, d_expert=d_expert)
        params = init_params(cfg, jax.random.PRNGKey(0))
        tparams = bridge(params)
        if dtype == "bfloat16":
            import dataclasses
            cfg = dataclasses.replace(cfg, dtype="bfloat16")
            params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
            tparams = tree_map(lambda t: t.to(torch.bfloat16), tparams)
        _SETUP[key] = (cfg, params, torch_cfg(cfg), tparams, prompt(cfg, 2))
    return _SETUP[key]


def _tiered(cfg):
    return {"jax": JTiered(low_experts=frozenset((li, e) for li in range(cfg.num_layers)
                                                 for e in range(cfg.num_experts)
                                                 if e % 2 == 0)),
            "port": TieredPolicy(low_experts=frozenset((li, e) for li in range(cfg.num_layers)
                                                       for e in range(cfg.num_experts)
                                                       if e % 2 == 0))}


def _events(events):
    return [(e.token, e.layer, e.expert, e.worker, e.predicted, e.bytes, e.scheme)
            for e in events]


def _run_both(setup, jpolicy, tpolicy, jax_side=True):
    cfg, params, tcfg, tparams, toks = setup
    eng = ODMoEEngine(tcfg, tparams, n_workers=8, predictor="sep", transport=tpolicy,
                      packed_slots=True, device="cpu")
    out, _ = eng.generate({"tokens": torch.from_numpy(toks)}, N_TOK)
    ref = greedy_generate(tcfg, tparams, {"tokens": torch.from_numpy(toks)}, N_TOK,
                          transport=tpolicy)
    assert torch.equal(out, ref)
    jeng = None
    if jax_side:
        jeng = JEngine(cfg, params, n_workers=8, predictor="sep", transport=jpolicy,
                       packed_slots=True)
        jout, _ = jeng.generate({"tokens": jnp.asarray(toks)}, N_TOK)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    return eng, jeng


def _assert_accounting_equal(eng, jeng):
    assert _events(eng.slots.events) == _events(jeng.slots.events)
    assert eng.slots.bytes_moved == jeng.slots.bytes_moved
    assert eng.slots.stats == {k: jeng.slots.stats[k] for k in eng.slots.stats}
    assert all(v == 0 for k, v in jeng.slots.stats.items() if k not in eng.slots.stats)
    assert eng.memory_report() == jeng.memory_report()
    assert eng.slots.slot_unit_bytes() == jeng.slots.slot_unit_bytes()
    assert eng.slots.transient_packed_bytes() == jeng.slots.transient_packed_bytes()
    assert eng.slots.device_bytes_per_worker() == jeng.slots.device_bytes_per_worker()


@pytest.mark.parametrize("scheme", ["int8", "nf4", "fp16", "tiered"])
def test_packed_engine_matches_greedy_and_jax(scheme):
    """Packed-resident decode: tokens equal the port's greedy_generate
    under the same policy and the JAX engine's; records and bytes equal
    JAX's; tileable experts shrink the slot to the packed payload."""
    setup = _setup()
    if scheme == "tiered":
        pols = _tiered(setup[0])
        jpol, tpol = pols["jax"], pols["port"]
    else:
        jpol, tpol = scheme, scheme
    eng, jeng = _run_both(setup, jpol, tpol)
    _assert_accounting_equal(eng, jeng)
    st_ = eng.store
    packed_max = max(st_.packed_bytes(li, e) for li in st_.moe_layers
                     for e in range(setup[0].num_experts))
    assert all(st_.resident_tileable(li, e) for li in st_.moe_layers
               for e in range(setup[0].num_experts))
    assert eng.slots.transient_packed_bytes() == 0
    assert eng.slots.device_bytes_per_worker() == packed_max < st_.expert_bytes
    assert eng.memory_report()["per_worker_bytes"] == packed_max
    if scheme == "tiered":
        assert {e.scheme for e in eng.slots.events} == {"fp16", "int8"}


def test_packed_engine_mixed_wave_splits_per_scheme():
    """A tiered wave holds both schemes: one grouped call per scheme."""
    setup = _setup()
    tpol = _tiered(setup[0])["port"]
    cfg, _, tcfg, tparams, toks = setup
    eng = ODMoEEngine(tcfg, tparams, n_workers=8, predictor="none", transport=tpol,
                      packed_slots=True, device="cpu")
    li = eng.moe_layers[0]
    for w, e in enumerate((0, 1, 2)):
        eng.slots.load(0, li, e, w, predicted=True)
    experts, groups = eng.slots.gather_stack_packed(li, {0: 0, 1: 1, 2: 2})
    assert experts == [0, 1, 2]
    assert [(s, ids) for s, ids, _ in groups] == [("int8", [0, 2]), ("fp16", [1])]
    assert tuple(groups[0][2]["w_gate"][0].shape) == (2, cfg.d_model, cfg.d_expert)
    assert groups[0][2]["w_gate"][0].dtype == torch.int8


def test_untileable_nf4_falls_back_to_full_width():
    """d_expert = 96: nf4 absmax blocks cross rows, so there is no
    tile-aligned layout; the slots fall back to dequantize-on-arrival with
    JAX's byte accounting, and tokens still equal greedy and JAX."""
    setup = _setup(d_expert=96)
    eng, jeng = _run_both(setup, "nf4", "nf4")
    _assert_accounting_equal(eng, jeng)
    li = eng.moe_layers[0]
    assert not eng.store.resident_tileable(li, 0)
    assert eng.slots.slot_unit_bytes() == eng.store.expert_bytes
    assert eng.slots.transient_packed_bytes() == eng.store.packed_bytes(li, 0)


def test_bf16_params_fall_back_to_full_width():
    """A bf16 deployment cannot stay packed (the kernel dequantizes to
    fp32); every expert falls back.  Byte accounting equals JAX's on the
    same bf16 weights; tokens equal the port's greedy."""
    setup = _setup(dtype="bfloat16")
    cfg, params, _, _, _ = setup
    eng, _ = _run_both(setup, "int8", "int8", jax_side=False)
    jeng = JEngine(cfg, params, n_workers=8, predictor="sep", transport="int8",
                   packed_slots=True)
    li = eng.moe_layers[0]
    assert not eng.store.resident_tileable(li, 0)
    assert not jeng.store.resident_tileable(li, 0)
    assert eng.store.expert_bytes == jeng.store.expert_bytes
    for fn in ("slot_unit_bytes", "transient_packed_bytes", "device_bytes_per_worker"):
        assert getattr(eng.slots, fn)() == getattr(jeng.slots, fn)()
    assert eng.memory_report() == jeng.memory_report()
    assert all(e.scheme == "int8" for e in eng.slots.events)


def test_packed_slots_need_the_grouped_wave_path():
    _, _, tcfg, tparams, _ = _setup()
    with pytest.raises(ValueError, match="grouped"):
        ODMoEEngine(tcfg, tparams, device="cpu", packed_slots=True, wave_compute="loop")


def test_tiered_from_trace_matches_jax():
    """The same calibration trace (a JAX decode, bridged) gives the same
    tier map in both packages, with and without ``num_experts``."""
    cfg, params, _, _, toks = _setup()
    jeng = JEngine(cfg, params, n_workers=8, predictor="none")
    _, jtrace = jeng.generate({"tokens": jnp.asarray(toks)}, N_TOK)
    trace = torch_trace(jtrace)
    for kw in ({"num_experts": cfg.num_experts}, {}, {"low_fraction": 0.25}):
        ours = TieredPolicy.from_trace(trace, **kw)
        theirs = JTiered.from_trace(jtrace, **kw)
        assert ours.low_experts == theirs.low_experts
        assert ours.describe() == theirs.describe()
        assert ours.default_scheme == theirs.default_scheme == "fp16"
    with pytest.raises(ValueError):
        TieredPolicy.from_trace(trace, low_fraction=1.5)


def test_serve_cli_packed_tiered_on_the_host():
    """The CPU drive of the packed tiered path prints the bit-exactness
    line and the modelled speed."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--packed-slots", "--transport-precision", "tiered", "--tokens", "6"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "tokens == dense reference (same transport policy): True" in proc.stdout
    assert "transport: calibrated tiered/fp16+int8" in proc.stdout
    assert "modelled (rtx3090-edge profile, not measured): decode" in proc.stdout
