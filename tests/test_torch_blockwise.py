"""The port's blockwise online-softmax attention (``attn_seq`` above
2048 tokens) against the JAX package's on bridged weights, against the
port's own full ``attn_seq``, and through ``prefill`` /
``greedy_generate`` / the engine across the threshold.  Tolerance: rtol =
atol = 1e-5 in fp32 for the attention function (the same recurrence, sums
in other orders), 1e-4 for logits after a whole model (as the model
tests); tokens and cache positions exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import bridge, prompt, torch_cfg
from conftest import tiny_dense, tiny_moe
from repro.models import attention as jattn
from repro.models import decode_step as jdecode_step
from repro.models import init_params as jinit
from repro.models import prefill as jprefill
import repro_torch.models as tm
from repro_torch.core import ODMoEEngine
from repro_torch.models import attention as tattn

ATT_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
LONG = 2050          # past BLOCKWISE_THRESHOLD: the port pads it to its 4096 bucket


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The 4096-token prefills run large elementwise passes (``exp`` over
    masked scores is slow on the host); one intra-op thread keeps them from
    oversubscribing a host that other test workers share.  Restored after
    the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layer0(cfg, seed):
    params = jinit(cfg, jax.random.PRNGKey(seed))
    p0 = jax.tree.map(lambda a: a[0], params["layers"][0])["mixer"]
    return p0, bridge(p0), torch_cfg(cfg)


def _inputs(cfg, t, seed, b=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
    return x, pos


@pytest.mark.parametrize("kv_heads,causal,window,qb,kb", [
    (2, True, 0, 8, 8), (2, True, 0, 16, 8), (2, True, 9, 8, 16), (2, True, 9, 16, 16),
    (2, False, 0, 8, 16), (2, False, 13, 16, 8), (4, True, 0, 16, 16), (4, True, 9, 8, 8)],
    ids=["gqa-causal-8x8", "gqa-causal-16x8", "gqa-window-8x16", "gqa-window-16x16",
         "gqa-full-8x16", "gqa-full-window-16x8", "mha-causal-16x16", "mha-window-8x8"])
def test_blockwise_matches_jax(kv_heads, causal, window, qb, kb):
    """T = 41 (ragged against every block size, so P_INVALID rows and keys
    pad both axes); a window of 9 masks whole leading KV blocks of the
    later query blocks, which the first real block washes out."""
    cfg = tiny_dense(num_heads=4, num_kv_heads=kv_heads)
    p0, tp0, tcfg = _layer0(cfg, 1)
    x, pos = _inputs(cfg, 41, seed=qb + kb)
    want = jattn.attn_seq_blockwise(cfg, p0, jnp.asarray(x), jnp.asarray(pos), causal=causal,
                                    window=window, q_block=qb, kv_block=kb)
    got = tattn.attn_seq_blockwise(tcfg, tp0, torch.from_numpy(x), torch.from_numpy(pos),
                                   causal=causal, window=window, q_block=qb, kv_block=kb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)


@pytest.mark.parametrize("t,qb,kb,window", [(300, 64, 128, 0), (300, 128, 64, 37),
                                            (2048, 512, 512, 0)])
def test_blockwise_matches_full_attn_seq(t, qb, kb, window):
    """At T <= 2048 the full path runs; the blockwise recurrence gives the
    same attention within fp32 tolerance."""
    cfg = tiny_dense(num_heads=4, num_kv_heads=2)
    _, tp0, tcfg = _layer0(cfg, 2)
    x, pos = _inputs(cfg, t, seed=t, b=1)
    x, pos = torch.from_numpy(x), torch.from_numpy(pos)
    full = tattn.attn_seq(tcfg, tp0, x, pos, window=window)
    blk = tattn.attn_seq_blockwise(tcfg, tp0, x, pos, window=window, q_block=qb, kv_block=kb)
    np.testing.assert_allclose(blk.numpy(), full.numpy(), **ATT_TOL)


def test_attn_seq_switches_to_blockwise_above_the_threshold(monkeypatch):
    """As the reference's test does, with the threshold lowered to 64: an
    80-token sequence takes the blockwise path, a 64-token one the full
    path, and the two agree."""
    cfg = tiny_dense(num_heads=4, num_kv_heads=2)
    _, tp0, tcfg = _layer0(cfg, 3)
    calls, blockwise = [], tattn.attn_seq_blockwise

    def spy(cfg, params, x, *args, **kw):
        calls.append(x.shape[1])
        return blockwise(cfg, params, x, *args, **kw)

    monkeypatch.setattr(tattn, "BLOCKWISE_THRESHOLD", 64)
    monkeypatch.setattr(tattn, "attn_seq_blockwise", spy)
    x, pos = _inputs(cfg, 80, seed=5, b=1)
    x, pos = torch.from_numpy(x), torch.from_numpy(pos)
    auto = tattn.attn_seq(tcfg, tp0, x, pos)
    full = tattn.attn_seq(tcfg, tp0, x[:, :64], pos[:, :64])
    assert calls == [80]
    assert torch.equal(auto, blockwise(tcfg, tp0, x, pos))
    np.testing.assert_allclose(auto[:, :64].numpy(), full.numpy(), **ATT_TOL)


@pytest.mark.parametrize("dtype,t,bucket", [(torch.float32, 40, 64), (torch.bfloat16, 40, 64),
                                             (torch.float32, 3000, 4096)],
                         ids=["fp32-40", "bf16-40", "fp32-3000"])
def test_padded_prompt_gives_its_real_rows_the_same_bits(dtype, t, bucket):
    """Rows padded onto a prompt (as ``prefill`` pads it to its pow2
    bucket) sit behind every real row causally: the KV blocks they add or
    fill are fully masked for real rows, p is exactly 0 and corr exactly
    1 there, so every real row keeps its bits."""
    tcfg = torch_cfg(tiny_dense(num_heads=2, num_kv_heads=1, d_model=32))
    # the port's own weights: no JAX side here, so none is initialised
    mixer = tm.init_params(tcfg, seed=4, device="cpu")["layers"][0]["mixer"]
    tp0 = {k: v[0].to(dtype) for k, v in mixer.items()}
    x, pos = _inputs(tcfg, bucket, seed=bucket, b=1)
    x, pos = torch.from_numpy(x).to(dtype), torch.from_numpy(pos)
    blocks = dict(q_block=8, kv_block=8) if bucket == 64 else {}
    padded = tattn.attn_seq_blockwise(tcfg, tp0, x, pos, **blocks)
    alone = tattn.attn_seq_blockwise(tcfg, tp0, x[:, :t].contiguous(),
                                     pos[:, :t].contiguous(), **blocks)
    assert torch.equal(padded[:, :t], alone)


def _greedy_steps(prefill_fn, decode_fn, argmax, n):
    """Prefill once, then ``n - 1`` greedy decode steps: the prefill logits
    and the ``n`` tokens (what ``greedy_generate`` does, without its
    prefill of its own)."""
    logits, state = prefill_fn()
    first, toks = logits, []
    for _ in range(n):
        tok = argmax(logits)
        toks.append(tok)
        if len(toks) < n:
            logits, state = decode_fn(tok, state)
    return first, toks


@pytest.fixture(scope="module")
def long_moe():
    """tiny_moe (2 layers, 2 query heads on 1 kv head, to keep the host's
    4096-token prefills short) with a 2050-token prompt: JAX prefills it
    unpadded (its bucket exceeds the cache), the port at its 4096 bucket;
    both run the blockwise path.  JAX's prefill logits and 2 greedy
    tokens (the second from a decode step over the 2050-token cache),
    shared by this module's tests."""
    cfg = tiny_moe(num_layers=2, num_heads=2, num_kv_heads=1)
    params = jinit(cfg, jax.random.PRNGKey(7))
    toks = prompt(cfg, 8, length=LONG)
    jl, jtok = _greedy_steps(
        lambda: jprefill(cfg, params, {"tokens": jnp.asarray(toks)}, LONG + 2,
                         moe_method="grouped"),
        lambda t, st: jdecode_step(cfg, params, t, st),
        lambda lg: jnp.argmax(lg, axis=-1).astype(jnp.int32), 2)
    return (cfg, torch_cfg(cfg), bridge(params), toks, np.asarray(jl),
            np.stack([np.asarray(t) for t in jtok], axis=1))


def test_long_prompt_prefill_and_greedy_equal_jax(long_moe):
    cfg, tcfg, tparams, toks, jl, jtok = long_moe
    batch = {"tokens": torch.from_numpy(toks)}
    tl, state = tm.prefill(tcfg, tparams, batch, LONG + 2, moe_method="grouped")
    np.testing.assert_allclose(tl.numpy(), jl, **LOGIT_TOL)
    assert state["pos"].tolist() == [LONG]
    assert state["caches"][0]["pos"].shape[-1] == LONG + 2
    out = tm.greedy_generate(tcfg, tparams, batch, 2)
    np.testing.assert_array_equal(out.numpy(), jtok)


def test_long_prompt_engine_equals_greedy(long_moe):
    """The cacheless engine prefills the same long prompt (main model and
    SEP shadow) and decodes JAX's greedy tokens, which the previous test
    holds the port's ``greedy_generate`` to."""
    _, tcfg, tparams, toks, _, jtok = long_moe
    eng = ODMoEEngine(tcfg, tparams, n_workers=8, predictor="sep", device="cpu")
    out, trace = eng.generate({"tokens": torch.from_numpy(toks)}, 2)
    np.testing.assert_array_equal(out.numpy(), jtok)
    assert len(trace.records) == 1 and eng.slots.stats["loads"] > 0

