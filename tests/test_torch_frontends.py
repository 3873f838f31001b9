"""The port's modality-frontend path (a VLM's projected patch embeddings
prepended to its tokens) against the JAX package on the same numpy-seeded
weights, on the ``vlm`` case of ``tests/test_models.py``: the stub
frontends' shapes, ``lm_seq``'s ``n_front`` and logits, the unpadded
prefill (next position ``T + n_front``), decode steps, greedy tokens
under the reference's default cache sizing (prompt + new tokens, which
drops the first patch from the ring buffer) and under an explicit one
that keeps the image, and ``loss_fn``.

Tolerance: rtol = atol = 1e-4 in fp32 for logits and losses (as the model
tests), 1e-5 for cached K/V; tokens and cache positions exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import numpy_params, torch_cfg
from repro.configs import get_config as jget_config
from repro.models import ModelConfig
from repro.models import decode_step as jdecode_step
from repro.models import frontends as jfrontends
from repro.models import loss_fn as jloss_fn
from repro.models import prefill as jprefill
from repro.models.transformer import lm_seq as jlm_seq
import repro_torch.configs as tconfigs
import repro_torch.models as tm
from repro_torch.models import frontends as tfrontends
from repro_torch.models.transformer import lm_seq

CASE = dict(family="vlm", num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
            vocab_size=97, frontend="vision", frontend_tokens=5, frontend_dim=48)
TOL = dict(rtol=1e-4, atol=1e-4)
KV_TOL = dict(rtol=1e-5, atol=1e-5)
PROMPT, NEW = 6, 4
N_FRONT = CASE["frontend_tokens"]
# the reference's default cache, prompt + new tokens, is one slot short of
# the N + T prompt positions; the explicit one holds the image throughout
CACHES = {"default": PROMPT + NEW, "explicit": N_FRONT + PROMPT + NEW}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg = ModelConfig(name="vlm", **CASE)
    tree = numpy_params(cfg, 1)
    rng = np.random.default_rng(4)
    front = rng.standard_normal((2, N_FRONT, cfg.frontend_dim)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, PROMPT + NEW)).astype(np.int32)
    return (cfg, jax.tree.map(jnp.asarray, tree), torch_cfg(cfg), tm.from_numpy(tree, "cpu"),
            front, toks)


MASK = (np.arange(PROMPT + NEW)[None] < np.array([[PROMPT + NEW], [7]])).astype(np.float32)


@pytest.fixture(scope="module")
def jax_run(model):
    """The reference's full-sequence logits and aux, loss, both prefills, the
    teacher-forced steps and, per cache, the ``greedy_generate`` loop
    (argmax fed back), compiled once per cache width."""
    cfg, params, _, _, front, toks = model

    def forward(p, fe, tk):
        logits, aux, _ = jlm_seq(cfg, p, tk, frontend_embeds=fe, moe_method="dense")
        loss = jloss_fn(cfg, p, {"tokens": tk, "loss_mask": jnp.asarray(MASK),
                                 "frontend_embeds": fe})
        batch = {"tokens": tk[:, :PROMPT], "frontend_embeds": fe}
        return logits, aux["n_front"], loss, {
            name: jprefill(cfg, p, batch, w) for name, w in CACHES.items()}

    logits, n_front, loss, pre = jax.jit(forward)(
        params, jnp.asarray(front), jnp.asarray(toks))
    step = jax.jit(lambda p, tok, st: jdecode_step(cfg, p, tok, st))
    out = {"logits": np.asarray(logits), "n_front": int(n_front),
           "loss": jax.tree.map(np.asarray, loss),
           "prefill": {k: jax.tree.map(np.asarray, v) for k, v in pre.items()}}
    lg, js = pre["explicit"]
    out["steps"] = []
    for t in range(PROMPT, PROMPT + NEW):
        lg, js = step(params, jnp.asarray(toks[:, t]), js)
        out["steps"].append(np.asarray(lg))
    out["greedy"] = {}
    for name, (lg, js) in pre.items():
        got = []
        for _ in range(NEW):
            got.append(np.asarray(jnp.argmax(lg, axis=-1)))
            lg, js = step(params, jnp.asarray(got[-1], jnp.int32), js)
        out["greedy"][name] = np.stack(got, axis=1)
    return out


def _batch(front, toks):
    return {"tokens": torch.from_numpy(np.ascontiguousarray(toks)),
            "frontend_embeds": torch.from_numpy(front)}


@pytest.mark.parametrize("arch", ["internvl2-26b", "seamless-m4t-large-v2"])
def test_frontend_embed_shape_and_synthetic_embeds(arch):
    """256 frames where the config leaves ``frontend_tokens`` at 0."""
    cfg, tcfg = jget_config(arch), tconfigs.get_config(arch)
    assert tfrontends.frontend_embed_shape(tcfg, 3) == jfrontends.frontend_embed_shape(cfg, 3)
    small = tcfg.reduced()
    e = tfrontends.synthetic_frontend_embeds(small, torch.Generator().manual_seed(0), 2,
                                             dtype=torch.bfloat16)
    assert e.dtype == torch.bfloat16
    assert tuple(e.shape) == jfrontends.frontend_embed_shape(cfg.reduced(), 2)


def test_lm_seq_prepends_the_front_and_matches(model, jax_run):
    _, _, tcfg, tparams, front, toks = model
    logits, aux, _ = lm_seq(tcfg, tparams, torch.from_numpy(toks),
                            frontend_embeds=torch.from_numpy(front), moe_method="dense")
    assert aux["n_front"] == jax_run["n_front"] == N_FRONT
    assert tuple(logits.shape) == (2, N_FRONT + PROMPT + NEW, tcfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), jax_run["logits"], **TOL)


@pytest.mark.parametrize("cache", list(CACHES))
def test_unpadded_prefill_matches(model, jax_run, cache):
    """The prompt with an image takes the unpadded path; the next position is
    ``T + n_front``; with the default cache the ring buffer keeps the last
    W of the N + T positions."""
    _, _, tcfg, tparams, front, toks = model
    logits, state = tm.prefill(tcfg, tparams, _batch(front, toks[:, :PROMPT]), CACHES[cache])
    jl, js = jax_run["prefill"][cache]
    np.testing.assert_allclose(logits.numpy(), jl, **TOL)
    assert state["pos"].tolist() == js["pos"].tolist() == [PROMPT + N_FRONT] * 2
    for tc, jc in zip(state["caches"], js["caches"]):
        assert tc["pos"].shape[-1] == CACHES[cache]
        np.testing.assert_array_equal(tc["pos"].numpy(), jc["pos"])
        np.testing.assert_allclose(tc["k"].numpy(), jc["k"], **KV_TOL)
        np.testing.assert_allclose(tc["v"].numpy(), jc["v"], **KV_TOL)
    kept = state["caches"][0]["pos"][0, 0]
    assert int(kept[kept >= 0].min()) == (1 if cache == "default" else 0)


def test_decode_steps_match(model, jax_run):
    _, _, tcfg, tparams, front, toks = model
    _, state = tm.prefill(tcfg, tparams, _batch(front, toks[:, :PROMPT]), CACHES["explicit"])
    for t, want in zip(range(PROMPT, PROMPT + NEW), jax_run["steps"]):
        logits, state = tm.decode_step(tcfg, tparams, torch.from_numpy(toks[:, t]), state)
        np.testing.assert_allclose(logits.numpy(), want, **TOL)


@pytest.mark.parametrize("cache", list(CACHES))
def test_greedy_tokens_equal(model, jax_run, cache):
    """Under the default sizing (``max_cache_len=0``) and an explicit one."""
    _, _, tcfg, tparams, front, toks = model
    out = tm.greedy_generate(tcfg, tparams, _batch(front, toks[:, :PROMPT]), NEW,
                             max_cache_len=0 if cache == "default" else CACHES[cache])
    np.testing.assert_array_equal(out.numpy(), jax_run["greedy"][cache])


def test_loss_fn_leaves_out_the_front_and_matches(model, jax_run):
    _, _, tcfg, tparams, front, toks = model
    batch = dict(_batch(front, toks), loss_mask=torch.from_numpy(MASK))
    tl, tmet = tm.loss_fn(tcfg, tparams, batch)
    jl, jm = jax_run["loss"]
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    np.testing.assert_allclose(float(tmet["ce"]), float(jm["ce"]), **TOL)
    assert float(tmet["load_balance_loss"]) == float(jm["load_balance_loss"]) == 0.0
