"""Mamba and hybrid models through the port against the JAX package on
bridged weights: ``greedy_generate`` on ``tiny_ssm`` and on a tiny hybrid
MoE (Mamba layers with attention at in-period index 4 and MoE on odd
layers, Jamba's pattern), the OD-MoE engine on the hybrid (tokens, load
events, bytes, stats; ``simulate_odmoe`` within 1e-12), the serving loop
through a paged pool that preempts (outputs, ``StepRecord``s, ``kv_stats``
and load events equal; each request equal to its solo decode), SSM states
through cache and shadow-state composition, and the refusals."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import bridge, prompt, step_fields, torch_cfg, torch_requests, torch_trace
from conftest import tiny_ssm
from repro.core import ODMoEEngine as JEngine
from repro.core import node_memory_report as jnode_memory_report
from repro.core import timing as jt
from repro.core.align import kv_bytes_per_token as jkv_bytes
from repro.models import decode_step as jdecode_step
from repro.models import init_params as jinit
from repro.models import prefill as jprefill
from repro.models.config import ModelConfig
from repro.serve import KVPool as JPool
from repro.serve import ServingLoop as JLoop
from repro.serve import dense_cache_footprint as jdense_footprint
from repro.serve import make_traffic as jmake_traffic
from repro_torch.core import (ODMoEEngine, concat_cache_lists, concat_shadow_states,
                              node_memory_report, slice_cache_list, slice_shadow_state)
from repro_torch.core import timing as tt
from repro_torch.core.align import kv_bytes_per_token
from repro_torch.core.schedule import GroupSchedule
from repro_torch.launch.serve import main
from repro_torch.models import decode_step, greedy_generate, prefill
from repro_torch.serve import KVPool, ServingLoop, dense_cache_footprint

PROMPT, N_TOK, PAGE = 21, 6, 4
LOGIT_TOL = 1e-4
TIME_TOL = 1e-12


def tiny_hybrid(**kw):
    base = dict(name="t-hybrid", family="hybrid", num_layers=8, d_model=64, num_heads=4,
                num_kv_heads=2, d_ff=128, d_expert=96, vocab_size=97, num_experts=8, top_k=2,
                moe_every=2, moe_offset=1, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
                attn_every=8, attn_offset=4)
    base.update(kw)
    return ModelConfig(**base)


@pytest.fixture(scope="module")
def hybrid():
    cfg = tiny_hybrid()
    params = jinit(cfg, jax.random.PRNGKey(0))
    return cfg, params, torch_cfg(cfg), bridge(params)


def _logits_close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("which", ["tiny_ssm", "tiny_hybrid"])
def test_greedy_and_logits_match_jax(hybrid, which):
    """Equal greedy tokens, and prefill and decode logits within 1e-4 at
    every step (the prompt's 21 tokens leave a padded last SSD chunk).
    The JAX side's greedy tokens are the argmax of its own logits."""
    if which == "tiny_ssm":
        cfg = tiny_ssm(ssm_chunk=8)
        params = jinit(cfg, jax.random.PRNGKey(1))
        tcfg, tparams = torch_cfg(cfg), bridge(params)
    else:
        cfg, params, tcfg, tparams = hybrid
    toks = prompt(cfg, 1, PROMPT)
    jl, js = jprefill(cfg, params, {"tokens": jnp.asarray(toks)}, PROMPT + N_TOK,
                      moe_method="grouped")
    tl, ts = prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)}, PROMPT + N_TOK,
                     moe_method="grouped")
    _logits_close(tl.numpy(), jl)
    want = [np.argmax(np.asarray(jl), -1).astype(np.int32)]
    jstep = jax.jit(jdecode_step, static_argnums=0)      # one trace for every step
    for _ in range(N_TOK - 1):
        jl, js = jstep(cfg, params, jnp.asarray(want[-1]), js)
        tl, ts = decode_step(tcfg, tparams, torch.from_numpy(want[-1]), ts)
        _logits_close(tl.numpy(), jl)
        want.append(np.argmax(np.asarray(jl), -1).astype(np.int32))
    got = greedy_generate(tcfg, tparams, {"tokens": torch.from_numpy(toks)}, N_TOK).numpy()
    np.testing.assert_array_equal(got, np.stack(want, axis=1))


@pytest.fixture(scope="module")
def engines(hybrid):
    cfg, params, tcfg, tparams = hybrid
    toks = prompt(cfg, 1, PROMPT)
    jeng = JEngine(cfg, params, n_workers=8, predictor="sep")
    jout, jtrace = jeng.generate({"tokens": jnp.asarray(toks)}, N_TOK)
    teng = ODMoEEngine(tcfg, tparams, n_workers=8, predictor="sep", device="cpu")
    tout, trace = teng.generate({"tokens": torch.from_numpy(toks)}, N_TOK)
    return dict(jeng=jeng, jout=jout, jtrace=jtrace, teng=teng, tout=tout, trace=trace,
                toks=toks)


def _events(ev):
    return [(e.token, e.layer, e.expert, e.worker, e.predicted, e.bytes, e.scheme) for e in ev]


def test_engine_matches_jax_and_greedy(hybrid, engines):
    _, _, tcfg, tparams = hybrid
    e = engines
    np.testing.assert_array_equal(e["tout"].numpy(), np.asarray(e["jout"]))
    np.testing.assert_array_equal(
        e["tout"].numpy(),
        greedy_generate(tcfg, tparams, {"tokens": torch.from_numpy(e["toks"])}, N_TOK).numpy())
    assert _events(e["teng"].slots.events) == _events(e["jeng"].slots.events)
    assert e["teng"].slots.bytes_moved == e["jeng"].slots.bytes_moved
    assert e["teng"].slots.stats == {k: e["jeng"].slots.stats[k] for k in e["teng"].slots.stats}
    assert e["trace"].recall() == e["jtrace"].recall()
    assert [[(lr.layer, np.asarray(lr.true).tolist(), lr.reloads, lr.assignments)
             for lr in r.layers] for r in e["trace"].records] == \
        [[(lr.layer, np.asarray(lr.true).tolist(), lr.reloads, lr.assignments)
          for lr in r.layers] for r in e["jtrace"].records]
    assert e["teng"].memory_report() == e["jeng"].memory_report()


def test_simulate_odmoe_on_the_hybrid_trace_matches_jax(hybrid, engines):
    """The hybrid's Mamba layers price ``t_main_mamba`` and only its
    attention layers align KV bytes, in both packages."""
    cfg, _, tcfg, _ = hybrid
    jtrace = engines["jtrace"]
    want = jt.simulate_odmoe(cfg, jtrace, engines["jeng"].sched, jt.RTX3090_EDGE)
    got = tt.simulate_odmoe(tcfg, torch_trace(jtrace), GroupSchedule(8, 2), tt.RTX3090_EDGE)
    np.testing.assert_allclose(got.per_token_s, want.per_token_s, rtol=TIME_TOL, atol=0)
    np.testing.assert_allclose(got.io_stall_s, want.io_stall_s, rtol=TIME_TOL, atol=0)
    assert kv_bytes_per_token(tcfg) == jkv_bytes(cfg)
    jclock = jt.DecodeClock(cfg, engines["jeng"].sched, jt.RTX3090_EDGE)
    tclock = tt.DecodeClock(tcfg, GroupSchedule(8, 2), tt.RTX3090_EDGE)
    np.testing.assert_allclose(tclock.t_main_mamba, jclock.t_main_mamba, rtol=TIME_TOL)


def _pages(reqs):
    window = max(len(r.prompt) + r.max_new_tokens for r in reqs) + 2
    return -(-window // PAGE) * len(reqs) // 2     # half the dense footprint


@pytest.fixture(scope="module")
def served(hybrid):
    """Both loops on the same 3-request burst through a paged pool over the
    one attention layer, at half the dense footprint (seed 2 makes it
    preempt; three requests because each JAX prefill of a hybrid traces
    anew, about 6 s on one core)."""
    cfg, params, tcfg, tparams = hybrid
    jreqs = jmake_traffic(cfg, 3, 0.0, prompt_len=20, max_new=N_TOK, seed=2)
    jeng = JEngine(cfg, params, n_workers=8, predictor="sep")
    jpool = JPool(cfg, num_pages=_pages(jreqs), page_tokens=PAGE)
    jres = JLoop(jeng, max_batch=4, kv_pool=jpool).run(jreqs)
    teng = ODMoEEngine(tcfg, tparams, n_workers=8, predictor="sep", device="cpu")
    tpool = KVPool(tcfg, num_pages=_pages(jreqs), page_tokens=PAGE, device="cpu")
    tres = ServingLoop(teng, max_batch=4, kv_pool=tpool).run(torch_requests(jreqs))
    return dict(jreqs=jreqs, jeng=jeng, jpool=jpool, jres=jres, teng=teng, tpool=tpool,
                tres=tres)


def test_served_outputs_equal_jax_and_solo_greedy(hybrid, served):
    _, _, tcfg, tparams = hybrid
    tres, jres = served["tres"], served["jres"]
    assert sorted(tres.outputs) == sorted(jres.outputs)
    for r in torch_requests(served["jreqs"]):
        np.testing.assert_array_equal(tres.outputs[r.rid], np.asarray(jres.outputs[r.rid]))
        solo = greedy_generate(tcfg, tparams, {"tokens": torch.from_numpy(r.prompt)[None]},
                               r.max_new_tokens)[0].numpy()
        np.testing.assert_array_equal(tres.outputs[r.rid], solo)
    assert tres.mean_batch > 1


def test_served_records_kv_stats_and_events_equal_jax(served):
    tres, jres = served["tres"], served["jres"]
    assert [step_fields(s) for s in tres.steps] == [step_fields(s) for s in jres.steps]
    assert tres.kv_stats == jres.kv_stats
    assert tres.kv_stats["preemptions"] >= 1 and tres.kv_stats["resumes"] >= 1
    trep, jrep = tres.timings.report(), jres.timings.report()
    assert trep.keys() == jrep.keys()
    for key in trep:
        assert abs(trep[key] - jrep[key]) <= TIME_TOL, key
    assert [e + (tuple(x.requests),) for e, x in zip(_events(served["teng"].slots.events),
                                                     served["teng"].slots.events)] == \
        [e + (tuple(x.requests),) for e, x in zip(_events(served["jeng"].slots.events),
                                                  served["jeng"].slots.events)]


def test_pool_pages_attention_only_and_memory_matches_jax(hybrid, served):
    """The pool pages the one attention layer; SSM states stay dense in the
    handles.  Footprints count attention KV only, as in the reference."""
    cfg, _, tcfg, _ = hybrid
    pool = served["tpool"]
    assert pool.attn_layers == served["jpool"].attn_layers == [4]
    assert pool.page_set_bytes == served["jpool"].page_set_bytes
    assert dense_cache_footprint(tcfg, 40, 3) == jdense_footprint(cfg, 40, 3)
    assert node_memory_report(served["teng"], pool, budget_bytes=10 ** 9) == \
        jnode_memory_report(served["jeng"], served["jpool"], budget_bytes=10 ** 9)


def test_paged_handles_keep_ssm_states_dense_through_compose_and_swap(hybrid):
    _, _, tcfg, tparams = hybrid
    eng = ODMoEEngine(tcfg, tparams, n_workers=8, predictor="none", device="cpu")
    pool = KVPool(tcfg, num_pages=12, page_tokens=PAGE, device="cpu")
    pool.set_window(24)
    handles, dense = [], []
    for rid, n in enumerate((9, 14)):
        toks = {"tokens": torch.from_numpy(prompt(tcfg, rid, n))}
        _, cache_list, _ = eng.prefill_request(toks, 24)
        dense.append(cache_list)
        handles.append(eng.prefill_request(toks, 24, kv_pool=pool, rid=rid)[1])
    assert sorted(handles[0].states) == [0, 1, 2, 3, 5, 6, 7]
    batch = concat_cache_lists(handles)
    both = concat_cache_lists(dense)
    for li in range(tcfg.num_layers):
        got = batch[li]
        for name in both[li]:
            assert torch.equal(got[name], both[li][name]), (li, name)
    new = {k: v + 1 for k, v in batch[0].items()}
    batch[0] = new
    assert torch.equal(slice_cache_list(batch, 1)[0]["h"], new["h"][1:2])
    for h in handles:                  # a member's state does not hold the batch's
        for a in h.states[0].values():
            assert a.untyped_storage().nbytes() == a.numel() * a.element_size()
    h_before = handles[0][0]["h"].clone()
    pool.swap_out(0)
    pool.swap_in(0)
    assert torch.equal(handles[0][0]["h"], h_before)           # states stay where they are
    assert torch.equal(handles[0][4]["k"], batch[4]["k"][:1])    # pages come back byte for byte


def test_shadow_states_with_ssm_layers_round_trip(hybrid):
    _, _, tcfg, tparams = hybrid
    eng = ODMoEEngine(tcfg, tparams, n_workers=8, predictor="sep", device="cpu")
    states = [eng.shadow.prefill_state({"tokens": torch.from_numpy(prompt(tcfg, s, 10 + s))},
                                       24) for s in range(3)]
    composed = concat_shadow_states(states)
    for i, st in enumerate(states):
        back = slice_shadow_state(composed, i)
        for c_back, c_st in zip(back["caches"], st["caches"]):
            assert set(c_back) == set(c_st)
            assert all(torch.equal(c_back[k], c_st[k]) for k in c_st)


def test_refusals_match_jax(hybrid):
    cfg, params, tcfg, tparams = hybrid
    with pytest.raises(ValueError):
        JEngine(cfg, params, speculate=2)
    with pytest.raises(ValueError, match="all-attention"):
        ODMoEEngine(tcfg, tparams, speculate=2, device="cpu")
    ssm = tiny_ssm()
    with pytest.raises(ValueError):
        JPool(ssm, num_pages=4, page_tokens=PAGE)
    with pytest.raises(ValueError, match="attention layer"):
        KVPool(torch_cfg(ssm), num_pages=4, page_tokens=PAGE, device="cpu")


def test_cli_runs_jamba_reduced_and_refuses_archs_without_experts(capsys):
    main(["--device", "cpu", "--arch", "jamba-v0.1-52b", "--tokens", "4", "--prompt-len", "20"])
    out = capsys.readouterr().out
    assert "jamba-v0.1-52b-smoke" in out
    assert "tokens == dense reference (same transport policy): True" in out
    assert "'ssd_scan': 0" in out                       # the host runs the plain path
    with pytest.raises(SystemExit, match="no experts"):
        main(["--device", "cpu", "--arch", "mamba2-2.7b"])


def test_reduced_jamba_keeps_the_hybrid_pattern():
    from repro_torch.configs import get_config
    cfg = get_config("jamba-v0.1-52b").reduced()
    kinds = cfg.layer_kinds()
    assert [m for m, _ in kinds] == ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
    assert [f for _, f in kinds] == ["dense", "moe"] * 4
    six = dataclasses.replace(get_config("jamba-v0.1-52b"), num_layers=6)
    assert six.pattern() == (six.layer_kinds(), 1)
