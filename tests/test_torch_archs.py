"""The registry's other MoE configs in the port: qwen3-moe-30b-a3b and
granite-moe-3b-a800m reduced, but with their top-8 routing (granite with
its 48 padded expert rows) through the cacheless engine on 8 and 16
workers, against the port's ``greedy_generate`` and the JAX engine
(tokens, routing records, load events, bytes moved), a served burst
against solo decodes, and the decode half of ``tests/test_archs_smoke.py``
for every decoder-only architecture (bridged prefill logits within
rtol = atol = 1e-4, as the model tests; 3 decode tokens equal)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import bridge, prompt, torch_cfg
from repro.configs import get_config as jget_config
from repro.configs import list_archs
from repro.core import ODMoEEngine as JEngine
from repro.models import decode_step as jdecode_step
from repro.models import init_params as jinit
from repro.models import prefill as jprefill
import repro_torch.models as tm
from repro_torch.core import ODMoEEngine
from repro_torch.serve import Request, ServingLoop

TOL = dict(rtol=1e-4, atol=1e-4)
N_TOK = 6
# reductions that keep each family's routing: top-8 over 16 experts
# (qwen3), over 40 real experts in 48 padded rows (granite)
TOP8 = {"qwen3-moe-30b-a3b": dict(num_experts=16, top_k=8, d_expert=64),
        "granite-moe-3b-a800m": dict(num_experts=40, top_k=8, d_expert=64,
                                     padded_experts=48)}
DECODER_ONLY = [a for a in list_archs()
                if not (jget_config(a).is_encoder_decoder or jget_config(a).frontend)]


@pytest.fixture(scope="module", params=list(TOP8))
def top8(request):
    cfg = jget_config(request.param).reduced(**TOP8[request.param])
    params = jinit(cfg, jax.random.PRNGKey(0))
    return cfg, params, torch_cfg(cfg), bridge(params), prompt(cfg, 5)


def _records(trace):
    return [(lr.layer, lr.moe_index, lr.group,
             None if lr.predicted is None else np.asarray(lr.predicted).tolist(),
             np.asarray(lr.true).tolist(), lr.correct, lr.reloads,
             list(lr.assignments), [list(w) for w in lr.waves], tuple(lr.touched))
            for rec in trace.records for lr in rec.layers]


def _events(events):
    return [(e.token, e.layer, e.expert, e.worker, e.predicted, e.bytes, e.scheme)
            for e in events]


@pytest.mark.parametrize("workers", [8, 16])
def test_top8_engine_equals_greedy_and_jax(top8, workers):
    """8 workers make one group of 8 (no layer's loads overlap the layer
    before), 16 make two; the SEP shadow predicts every layer."""
    cfg, params, tcfg, tparams, toks = top8
    assert tcfg.top_k == 8
    jeng = JEngine(cfg, params, n_workers=workers, predictor="sep")
    jout, jtrace = jeng.generate({"tokens": jnp.asarray(toks)}, N_TOK)
    eng = ODMoEEngine(tcfg, tparams, n_workers=workers, predictor="sep", device="cpu")
    out, trace = eng.generate({"tokens": torch.from_numpy(toks)}, N_TOK)
    ref = tm.greedy_generate(tcfg, tparams, {"tokens": torch.from_numpy(toks)}, N_TOK)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert eng.sched.n_groups == workers // 8
    assert _records(trace) == _records(jtrace)
    assert _events(eng.slots.events) == _events(jeng.slots.events)
    assert eng.slots.bytes_moved == jeng.slots.bytes_moved
    assert eng.slots.stats == {k: jeng.slots.stats[k] for k in eng.slots.stats}


def test_padded_expert_rows_are_never_stored_or_routed(top8):
    """The store holds the routed experts only (granite: 40 of its 48
    rows), and no routing record names a pad row."""
    _, _, tcfg, tparams, toks = top8
    eng = ODMoEEngine(tcfg, tparams, n_workers=16, predictor="sep", device="cpu")
    _, trace = eng.generate({"tokens": torch.from_numpy(toks)}, 3)
    assert tparams["layers"][0]["ff"]["w_gate"].shape[1] == tcfg.num_experts_padded
    assert sorted({e for (_, e) in eng.store._packed}) == list(range(tcfg.num_experts))
    routed = {int(e) for rec in trace.records for lr in rec.layers
              for e in np.asarray(lr.true).reshape(-1)}
    assert max(routed) < tcfg.num_experts


def test_top8_served_burst_equals_solo(top8):
    """Three requests at t=0 through the serving loop on 16 workers: each
    request's tokens equal its solo ``greedy_generate``."""
    _, _, tcfg, tparams, _ = top8
    rng = np.random.default_rng(11)
    reqs = [Request(rid=i, prompt=rng.integers(0, tcfg.vocab_size, 6 + 3 * i).astype(np.int32),
                    max_new_tokens=4, arrival_s=0.0) for i in range(3)]
    eng = ODMoEEngine(tcfg, tparams, n_workers=16, predictor="sep", device="cpu")
    res = ServingLoop(eng, max_batch=3).run(reqs)
    assert res.mean_batch > 1
    for r in reqs:
        solo = tm.greedy_generate(tcfg, tparams, {"tokens": torch.from_numpy(r.prompt)[None]},
                                  r.max_new_tokens)[0].numpy()
        np.testing.assert_array_equal(res.outputs[r.rid], solo)


@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_decode_smoke_matches_jax(arch):
    """The decode half of the reference's arch smoke test on the port: a
    batch of 2 prompts of 8 tokens, prefill into a 32-slot cache, then 3
    greedy decode steps teacher-forced on JAX's tokens (the reference's
    grouped dispatch, the port's only one)."""
    cfg = jget_config(arch).reduced()
    params = jinit(cfg, jax.random.PRNGKey(1))
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    jl, js = jprefill(cfg, params, {"tokens": jnp.asarray(toks)}, 32, moe_method="grouped")
    jstep = jax.jit(lambda p, tok, st: jdecode_step(cfg, p, tok, st))   # one trace, 3 steps
    tcfg, tparams = torch_cfg(cfg), bridge(params)
    tl, ts = tm.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)}, 32,
                        moe_method="grouped")
    assert tuple(tl.shape) == (2, cfg.vocab_size)
    for _ in range(3):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert bool(torch.isfinite(tl).all())
        tok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        assert torch.argmax(tl, -1).tolist() == np.asarray(tok).tolist()
        jl, js = jstep(params, tok, js)
        tl, ts = tm.decode_step(tcfg, tparams, torch.from_numpy(np.array(tok)), ts)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert torch.argmax(tl, -1).tolist() == np.asarray(jnp.argmax(jl, -1)).tolist()


@pytest.mark.parametrize("arch", [a for a in list_archs() if a not in DECODER_ONLY])
def test_decode_smoke_encdec_and_frontend(arch):
    """The decode smoke for the two archs with frame or patch embeddings
    (seamless-m4t encoder-decoder, internvl2 VLM), reduced, on the port
    alone: the JAX side only gives the parameter tree's shapes
    (``jax.eval_shape``; its seamless decode smoke is a slow test).  A batch
    of 2 prompts of 8 tokens with their embeddings, prefill into a 32-slot
    cache, 3 greedy decode steps: finite logits of the vocabulary's width,
    each within 5e-4 of the teacher-forced full-sequence logits at its
    position (the reference's own check of a family)."""
    from repro_torch.models.encdec import encdec_seq
    from repro_torch.models.frontends import synthetic_frontend_embeds
    from repro_torch.models.transformer import lm_seq
    cfg = jget_config(arch).reduced()
    shapes = jax.eval_shape(lambda k: jinit(cfg, k), jax.random.PRNGKey(1))
    tcfg = torch_cfg(cfg)
    params = tm.init_params(tcfg, seed=1, device="cpu")
    assert [tuple(t.shape) for t in jax.tree.leaves(params)] == \
        [tuple(s.shape) for s in jax.tree.leaves(shapes)]
    front = synthetic_frontend_embeds(tcfg, torch.Generator().manual_seed(2), 2)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 8))
                            .astype(np.int32))
    logits, state = tm.prefill(tcfg, params, {"tokens": toks, "frontend_embeds": front}, 32)
    steps = [logits]
    for _ in range(3):
        tok = torch.argmax(steps[-1], -1).to(torch.int32)
        toks = torch.cat([toks, tok[:, None]], 1)
        logits, state = tm.decode_step(tcfg, params, tok, state)
        steps.append(logits)
    if tcfg.is_encoder_decoder:
        full, _ = encdec_seq(tcfg, params, front, toks)
    else:
        full, aux, _ = lm_seq(tcfg, params, toks, frontend_embeds=front)
        full = full[:, aux["n_front"]:]
    for i, lg in enumerate(steps):
        assert tuple(lg.shape) == (2, cfg.vocab_size) and bool(torch.isfinite(lg).all())
        np.testing.assert_allclose(lg.numpy(), full[:, 7 + i].numpy(), rtol=0, atol=5e-4)
