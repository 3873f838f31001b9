"""The port's encoder-decoder family against the JAX package on the same
numpy-seeded weights, on the ``audio-encdec`` case of
``tests/test_models.py``: the encoder, the cross memories, teacher-forced
logits, the prefill's logits, caches and memories, six decode steps,
greedy tokens (the reference's ``greedy_generate`` loop, compiled) and
``loss_fn``; cross-attention with a memory mask, and one decoder row's
cross-attention through the plain ``flash_decode`` against the
reference's ``cross_attn``.

Tolerance: rtol = atol = 1e-4 in fp32 for logits and losses after a whole
model (as the model tests), 1e-5 for one layer's encoder or attention
output; tokens and cache positions exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import bridge, numpy_params, torch_cfg
from repro.models import ModelConfig
from repro.models import attention as jattn
from repro.models import decode_step as jdecode_step
from repro.models import encdec as jencdec
from repro.models import loss_fn as jloss_fn
from repro.models import prefill as jprefill
import repro_torch.models as tm
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tencdec

CASE = dict(family="audio", num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
            vocab_size=97, is_encoder_decoder=True, num_encoder_layers=2, frontend="audio",
            frontend_tokens=7, frontend_dim=40, norm_type="layernorm")
TOL = dict(rtol=1e-4, atol=1e-4)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
T, PROMPT = 12, 6            # teacher-forced tokens; the prompt is the first PROMPT


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread keeps torch from oversubscribing a host that
    other test workers share.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg = ModelConfig(name="audio-encdec", **CASE)
    tree = numpy_params(cfg, 0)
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((2, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, T)).astype(np.int32)
    return (cfg, jax.tree.map(jnp.asarray, tree), torch_cfg(cfg), tm.from_numpy(tree, "cpu"),
            frames, toks)


MASK = (np.arange(T)[None] < np.array([[T], [8]])).astype(np.float32)


@pytest.fixture(scope="module")
def jax_run(model):
    """The reference's encoder, memories, teacher-forced logits, loss,
    prefill and six decode steps: teacher-forced, and greedy (its
    ``greedy_generate`` loop: argmax fed back), in one compiled function
    and one compiled step."""
    cfg, params, _, _, frames, toks = model

    def forward(p, f, tk):
        enc = jencdec.encode(cfg, p, f)
        seq, _ = jencdec.encdec_seq(cfg, p, f, tk)
        loss = jloss_fn(cfg, p, {"tokens": tk, "loss_mask": jnp.asarray(MASK),
                                 "frontend_embeds": f})
        pre = jprefill(cfg, p, {"tokens": tk[:, :PROMPT], "frontend_embeds": f}, T + 4)
        return enc, jencdec.build_memories(cfg, p, enc), seq, loss, pre

    enc, mem, seq, loss, (logits, state) = jax.jit(forward)(
        params, jnp.asarray(frames), jnp.asarray(toks))
    step = jax.jit(lambda p, tok, st: jdecode_step(cfg, p, tok, st))
    steps, js = [], state
    for t in range(PROMPT, T):
        lg, js = step(params, jnp.asarray(toks[:, t]), js)
        steps.append(np.asarray(lg))
    greedy, js, lg = [], state, logits
    for _ in range(6):
        greedy.append(np.asarray(jnp.argmax(lg, axis=-1)))
        lg, js = step(params, jnp.asarray(greedy[-1], jnp.int32), js)
    return {"enc": np.asarray(enc), "mem": jax.tree.map(np.asarray, mem),
            "seq": np.asarray(seq), "loss": jax.tree.map(np.asarray, loss),
            "prefill": (np.asarray(logits), jax.tree.map(np.asarray, state)),
            "steps": steps, "greedy": np.stack(greedy, axis=1)}


def _tree_close(a, b, **tol):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _tree_close(a[k], b[k], **tol)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _tree_close(x, y, **tol)
    else:
        assert tuple(a.shape) == tuple(np.shape(b))
        np.testing.assert_allclose(a.numpy(), b, **tol)


def test_encode_and_memories_match(model, jax_run):
    _, _, tcfg, tparams, frames, _ = model
    enc = tencdec.encode(tcfg, tparams, torch.from_numpy(frames))
    np.testing.assert_allclose(enc.numpy(), jax_run["enc"], **LAYER_TOL)
    _tree_close(tencdec.build_memories(tcfg, tparams, enc), jax_run["mem"], **LAYER_TOL)


def test_encdec_seq_logits_match(model, jax_run):
    _, _, tcfg, tparams, frames, toks = model
    logits, aux = tencdec.encdec_seq(tcfg, tparams, torch.from_numpy(frames),
                                     torch.from_numpy(toks))
    np.testing.assert_allclose(logits.numpy(), jax_run["seq"], **TOL)
    assert aux == {"load_balance_loss": 0.0}


def test_prefill_logits_caches_and_memories_match(model, jax_run):
    _, _, tcfg, tparams, frames, toks = model
    logits, state = tm.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks[:, :PROMPT]),
                                               "frontend_embeds": torch.from_numpy(frames)},
                               T + 4)
    jl, js = jax_run["prefill"]
    np.testing.assert_allclose(logits.numpy(), jl, **TOL)
    assert sorted(state) == sorted(js)
    assert state["pos"].tolist() == js["pos"].tolist() == [PROMPT, PROMPT]
    _tree_close(state["memories"], js["memories"], **LAYER_TOL)
    empty = tencdec.init_dec_caches(tcfg, 2, T + 4, torch.float32, "cpu")
    jempty = jencdec.init_dec_caches(model[0], 2, T + 4, jnp.float32)
    for tc, jc, e, je in zip(state["caches"], js["caches"], empty, jempty):
        for name in ("k", "v", "pos"):
            assert tuple(e[name].shape) == tuple(je[name].shape) == tuple(tc[name].shape)
        assert bool((e["pos"] == -1).all())
        np.testing.assert_array_equal(tc["pos"].numpy(), jc["pos"])
        np.testing.assert_allclose(tc["k"].numpy(), jc["k"], **LAYER_TOL)
        np.testing.assert_allclose(tc["v"].numpy(), jc["v"], **LAYER_TOL)


def test_six_decode_steps_match(model, jax_run):
    """Teacher-forced on the same tokens: every step's logits agree (the
    port's decoder attends its memory through ``flash_decode``)."""
    _, _, tcfg, tparams, frames, toks = model
    _, state = tm.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks[:, :PROMPT]),
                                          "frontend_embeds": torch.from_numpy(frames)}, T + 4)
    for t, want in zip(range(PROMPT, T), jax_run["steps"]):
        logits, state = tm.decode_step(tcfg, tparams, torch.from_numpy(toks[:, t]), state)
        np.testing.assert_allclose(logits.numpy(), want, **TOL)
    assert state["pos"].tolist() == [T, T]


def test_greedy_tokens_equal(model, jax_run):
    _, _, tcfg, tparams, frames, toks = model
    out = tm.greedy_generate(tcfg, tparams, {"tokens": torch.from_numpy(toks[:, :PROMPT]),
                                             "frontend_embeds": torch.from_numpy(frames)}, 6,
                             max_cache_len=T + 4)
    np.testing.assert_array_equal(out.numpy(), jax_run["greedy"])


def test_loss_fn_matches_with_loss_mask(model, jax_run):
    _, _, tcfg, tparams, frames, toks = model
    tl, tmet = tm.loss_fn(tcfg, tparams, {"tokens": torch.from_numpy(toks),
                                          "loss_mask": torch.from_numpy(MASK),
                                          "frontend_embeds": torch.from_numpy(frames)})
    jl, jm = jax_run["loss"]
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    np.testing.assert_allclose(float(tmet["ce"]), float(jm["ce"]), **TOL)
    assert float(tmet["load_balance_loss"]) == float(jm["load_balance_loss"]) == 0.0


def _cross_layer(model):
    cfg, params, tcfg, tparams, _, _ = model
    jp = jax.tree.map(lambda a: a[0], params["layers"][0]["cross"])
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    mask = np.ones((2, cfg.frontend_tokens), bool)
    mask[0, 4:] = False
    mask[1, :2] = False
    return cfg, jp, tcfg, bridge(jp), x, enc, mask


def test_cross_attention_has_no_qkv_bias():
    """A cross block never has a qkv bias, whatever the config says."""
    tcfg = tm.ModelConfig(name="bias", qkv_bias=True, **CASE)
    p = tm.init_params(tcfg, device="cpu")
    assert "bq" in p["layers"][0]["mixer"] and "bq" not in p["layers"][0]["cross"]


@pytest.mark.parametrize("masked", [False, True])
def test_cross_attn_with_memory_mask_matches(model, masked):
    cfg, jp, tcfg, tp, x, enc, mask = _cross_layer(model)
    jmem = jattn.cross_attn_memory(cfg, jp, jnp.asarray(enc))
    tmem = tattn.cross_attn_memory(tcfg, tp, torch.from_numpy(enc))
    _tree_close(tmem, jax.tree.map(np.asarray, jmem), **LAYER_TOL)
    want = jattn.cross_attn(cfg, jp, jnp.asarray(x), jmem,
                            memory_mask=jnp.asarray(mask) if masked else None)
    got = tattn.cross_attn(tcfg, tp, torch.from_numpy(x), tmem,
                           memory_mask=torch.from_numpy(mask) if masked else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_attn_decode_through_flash_decode_matches(model, masked):
    """One decoder row per batch row through the plain ``flash_decode``
    (every frame at slot position 0, -1 where masked) against the
    reference's ``cross_attn`` on that row, at decoder positions 5 and 11."""
    cfg, jp, tcfg, tp, x, enc, mask = _cross_layer(model)
    jmem = jattn.cross_attn_memory(cfg, jp, jnp.asarray(enc))
    tmem = tattn.cross_attn_memory(tcfg, tp, torch.from_numpy(enc))
    m = mask if masked else None
    want = jattn.cross_attn(cfg, jp, jnp.asarray(x[:, :1]), jmem,
                            memory_mask=None if m is None else jnp.asarray(m))
    got = tattn.cross_attn_decode(tcfg, tp, torch.from_numpy(x[:, :1]), tmem,
                                  torch.tensor([5, 11], dtype=torch.int32),
                                  memory_mask=None if m is None else torch.from_numpy(m))
    assert got.shape == (2, 1, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
