"""Shadow-drafted speculative decoding in the port
(``repro_torch.core.specdecode``) against the JAX package's on bridged
``tiny_moe`` weights.

Speculation changes when tokens appear, never which: every width and
alignment policy gives the port's own ``greedy_generate`` tokens, and on
the same weights the port equals the JAX engine in tokens, wave records
(``spec_len``, ``committed``), per-layer routing and loads, the
``LoadEvent`` log and ``bytes_moved``; speculative serving, dense and
paged, equals solo decode and JAX's ``spec_stats``.  Tolerance: fp32
floats within ``rtol = atol = 1e-5`` of JAX; tokens and host records
exact; modelled times within 1e-12 relative.  Each JAX speculation width
compiles anew, so every JAX run happens once, in a module fixture."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import bridge, prompt, step_fields, torch_cfg, torch_requests, torch_trace
from conftest import tiny_moe
from repro.core import AlignmentPolicy as JAlign
from repro.core import ODMoEEngine as JEngine
from repro.core import accept_prefix as jaccept_prefix
from repro.core import select_commit as jselect_commit
from repro.core import spec_attn_decode as jspec_attn_decode
from repro.core import timing as jt
from repro.core.predictor import SEPShadow as JShadow
from repro.models import init_params as jinit
from repro.models.transformer import layer_params as jlayer_params
from repro.serve import KVPool as JPool
from repro.serve import ServingLoop as JLoop
from repro.serve import make_traffic as jmake_traffic
from repro_torch.core import (AlignmentPolicy, ODMoEEngine, accept_prefix, select_commit,
                              simulate_odmoe, slice_rollout, spec_attn_decode, RTX3090_EDGE)
from repro_torch.core.schedule import GroupSchedule
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import greedy_generate
from repro_torch.models.attention import attn_decode
from repro_torch.models.transformer import layer_params
from repro_torch.serve import KVPool, ServingLoop

TOL = dict(rtol=1e-5, atol=1e-5)
N_TOK = 9                       # 9 - 1 decoded tokens: a multiple of neither width
PROMPT_SEED = 3                 # int8 drafts on this prompt are partly rejected at k = 2 and 4
POLICY = (1, 1)
N_REQ, PAGE = 5, 4           # the serving tests' burst: the paged k = 4 run preempts


@pytest.fixture(scope="module")
def model():
    cfg = tiny_moe(num_layers=4)
    params = jinit(cfg, jax.random.PRNGKey(0))
    return cfg, params, torch_cfg(cfg), bridge(params)


def _events(eng):
    return [(e.token, e.layer, e.expert, e.worker, e.predicted, e.bytes, e.scheme)
            for e in eng.slots.events]


def _waves(trace):
    return [(r.index, r.aligned_token, r.aligned_kv, r.spec_len, r.committed,
             [(lr.layer, None if lr.predicted is None else np.asarray(lr.predicted).tolist(),
               np.asarray(lr.true).tolist(), lr.correct, lr.reloads, list(lr.assignments))
              for lr in r.layers])
            for r in trace.records]


def _port_generate(model, k, policy=POLICY, batch=None, **kw):
    _, _, tcfg, tparams = model
    batch = batch if batch is not None else prompt(tcfg, PROMPT_SEED)
    eng = ODMoEEngine(tcfg, tparams, n_workers=8, predictor="sep", speculate=k,
                      device="cpu", **kw)
    out, trace = eng.generate({"tokens": torch.from_numpy(batch)}, N_TOK,
                              AlignmentPolicy(*policy))
    eng.close()
    return eng, out.numpy(), trace


@pytest.fixture(scope="module")
def jax_engines(model):
    """The JAX engine at k = 2 and 4 on the fixed prompt (one run each)."""
    cfg, params, _, _ = model
    out = {}
    for k in (2, 4):
        jeng = JEngine(cfg, params, n_workers=8, predictor="sep", speculate=k)
        jout, jtrace = jeng.generate({"tokens": jnp.asarray(prompt(cfg, PROMPT_SEED))}, N_TOK,
                                     JAlign(*POLICY))
        out[k] = (jeng, np.asarray(jout), jtrace)
    return out


# ------------------------------------------------------------------ units
ACCEPT_CASES = [
    # (drafts, verified): all confirmed, a late and an early mismatch, reconfirmed
    ([[7, 3, 5], [7, 3, 5], [7, 3, 5], [7, 9, 9]],
     [[3, 5, 8], [3, 4, 8], [4, 5, 8], [9, 9, 2]]),
    ([[5], [6]], [[9], [1]]),                       # a single column commits 1
    ([[7, 3, 5, 8]], [[3, 9, 5, 1]]),               # no resurrection after a mismatch
    (np.random.default_rng(0).integers(0, 3, (6, 4)).tolist(),
     np.random.default_rng(1).integers(0, 3, (6, 4)).tolist()),
]


@pytest.mark.parametrize("drafts,verified", ACCEPT_CASES)
def test_accept_prefix_and_select_commit_equal_jax(drafts, verified):
    d, v = np.asarray(drafts, np.int32), np.asarray(verified, np.int32)
    c = accept_prefix(torch.from_numpy(d), torch.from_numpy(v))
    jc = np.asarray(jaccept_prefix(d, v))
    assert c.dtype == torch.int32 and c.tolist() == jc.tolist()
    S = d.shape[1]
    leaf = np.arange(d.shape[0] * S * 6, dtype=np.float32).reshape(d.shape[0] * S, 3, 2)
    got = select_commit({"k": torch.from_numpy(leaf)}, c, S)["k"]
    want = np.asarray(jselect_commit({"k": jnp.asarray(leaf)}, jnp.asarray(jc), S)["k"])
    np.testing.assert_array_equal(got.numpy(), want)
    # the committed rows lie in storage of their own, not the wave's
    assert got.untyped_storage().nbytes() == got.numel() * got.element_size()


def _wave_inputs(cfg, bases, S, w, seed):
    """A wave over requests at ``bases``: rows ``b*S + s`` at ``base_b + s``,
    each request's cache holding its positions below ``base_b``."""
    rng = np.random.default_rng(seed)
    b, nk, hd = len(bases), cfg.num_kv_heads, cfg.resolved_head_dim
    x = rng.standard_normal((b * S, 1, cfg.d_model)).astype(np.float32)
    k = rng.standard_normal((b, w, nk, hd)).astype(np.float32)
    v = rng.standard_normal((b, w, nk, hd)).astype(np.float32)
    kpos = np.full((b, w), -1, np.int32)
    for i, base in enumerate(bases):
        kpos[i, :base] = np.arange(base)
        k[i, base:] = v[i, base:] = 0.0
    pos = (np.asarray(bases)[:, None] + np.arange(S)).reshape(-1).astype(np.int32)
    return x, {"k": k, "v": v, "pos": kpos}, pos


@pytest.mark.parametrize("S", [2, 4])
def test_spec_attn_decode_equals_jax(model, S):
    cfg, params, tcfg, tparams = model
    x, cache, pos = _wave_inputs(cfg, [5, 9, 2], S, 16, seed=S)
    jp = jlayer_params(cfg, params, 1)["mixer"]
    jcache = {n: jnp.repeat(jnp.asarray(a), S, axis=0) for n, a in cache.items()}
    jout, jc = jspec_attn_decode(cfg, jp, jnp.asarray(x), jcache, jnp.asarray(pos), S)
    tp = layer_params(tcfg, tparams, 1)["mixer"]
    out, c = spec_attn_decode(tcfg, tp, torch.from_numpy(x),
                              {n: torch.from_numpy(a) for n, a in cache.items()},
                              torch.from_numpy(pos), S)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(c[name].numpy(), np.asarray(jc[name]), **TOL)
    np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("S", [2, 4])
def test_verify_rows_equal_one_token_decode(model, S):
    """Row ``s`` of a wave gives, bit for bit, what ``attn_decode`` gives on
    the cache sequential decode holds after the wave's earlier rows."""
    cfg, _, tcfg, tparams = model
    x, cache, pos = _wave_inputs(cfg, [5, 11], S, 16, seed=7 + S)
    tp = layer_params(tcfg, tparams, 0)["mixer"]
    x, pos = torch.from_numpy(x), torch.from_numpy(pos)
    cache = {n: torch.from_numpy(a) for n, a in cache.items()}
    out, wave_cache = spec_attn_decode(tcfg, tp, x, cache, pos, S)
    for b in range(2):
        seq = {n: a[b:b + 1] for n, a in cache.items()}
        for s in range(S):
            r = b * S + s
            one, seq = attn_decode(tcfg, tp, x[r:r + 1], seq, pos[r:r + 1])
            assert torch.equal(one, out[r:r + 1]), (b, s)
            for name in ("k", "v", "pos"):
                assert torch.equal(seq[name], wave_cache[name][r:r + 1]), (b, s, name)


def test_rollout_states_is_chained_step_state_and_equals_jax(model):
    cfg, params, tcfg, tparams = model
    from repro_torch.core import SEPShadow
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    shadow = SEPShadow(tcfg, tparams, "int8")
    st = shadow.prefill_state({"tokens": torch.from_numpy(toks)}, 24)
    jshadow = JShadow(cfg, params, "int8")
    jst = jshadow.prefill_state({"tokens": jnp.asarray(toks)}, 24)
    for S in (1, 3):
        drafts, preds, roll = shadow.rollout_states(st, st["token"], S)
        assert drafts.shape == (2, S - 1)
        cur, tok = st, st["token"]
        for s in range(S):
            p, cur = shadow.step_state(cur, tok)
            tok = cur["token"]
            assert p.keys() == preds[s].keys()
            assert all(np.array_equal(p[li], preds[s][li]) for li in p)
            got = slice_rollout(roll, s)
            assert torch.equal(got["token"], cur["token"]) and torch.equal(got["pos"], cur["pos"])
            for c_got, c_cur in zip(got["caches"], cur["caches"]):
                assert all(torch.equal(c_got[n], c_cur[n]) for n in c_cur)
            if s + 1 < S:
                assert torch.equal(drafts[:, s], cur["token"])
        jdrafts, jpreds, _ = jshadow.rollout_states(jst, jst["token"], S)
        np.testing.assert_array_equal(drafts.numpy(), np.asarray(jdrafts))
        for p, jp in zip(preds, jpreds):
            assert p.keys() == jp.keys()
            assert all(np.array_equal(p[li], np.asarray(jp[li])) for li in p)


# ---------------------------------------------------------------- engine
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("policy", [(1, 1), (3, 5), (0, 0)])
def test_generate_speculate_equals_port_greedy(model, k, policy):
    """Every width and alignment policy gives greedy's tokens, and the waves
    commit exactly the decoded tokens."""
    _, _, tcfg, tparams = model
    toks = prompt(tcfg, PROMPT_SEED)
    ref = greedy_generate(tcfg, tparams, {"tokens": torch.from_numpy(toks)}, N_TOK).numpy()
    _, out, trace = _port_generate(model, k, policy)
    np.testing.assert_array_equal(out, ref)
    assert all(1 <= r.committed <= r.spec_len <= k for r in trace.records)
    assert sum(r.committed for r in trace.records) == N_TOK - 1
    assert all(r.seconds > 0 for r in trace.records)


def test_generate_speculate_commits_a_batch_in_lockstep(model):
    _, _, tcfg, tparams = model
    toks = np.concatenate([prompt(tcfg, PROMPT_SEED), prompt(tcfg, 1)])
    ref = greedy_generate(tcfg, tparams, {"tokens": torch.from_numpy(toks)}, N_TOK).numpy()
    _, out, trace = _port_generate(model, 4, batch=toks)
    np.testing.assert_array_equal(out, ref)
    assert all(r.committed % 2 == 0 for r in trace.records)
    assert sum(r.committed for r in trace.records) == 2 * (N_TOK - 1)


@pytest.mark.parametrize("k", [2, 4])
def test_spec_engine_equals_jax_engine(model, jax_engines, k):
    """Tokens, each wave's width and commits, per-layer routing, predictions,
    assignments and reloads, the load events and bytes moved; and the wave
    trace replays to JAX's modelled times."""
    cfg, _, tcfg, _ = model
    jeng, jout, jtrace = jax_engines[k]
    eng, out, trace = _port_generate(model, k)
    np.testing.assert_array_equal(out, jout)
    assert _waves(trace) == _waves(jtrace)
    assert any(r.committed < r.spec_len for r in trace.records)      # drafts were rejected
    assert any(r.committed > 1 for r in trace.records)               # and accepted
    for lr, jlr in zip((lr for r in trace.records for lr in r.layers),
                       (lr for r in jtrace.records for lr in r.layers)):
        np.testing.assert_allclose(lr.gates, np.asarray(jlr.gates), **TOL)
    assert _events(eng) == _events(jeng)
    assert eng.slots.bytes_moved == jeng.slots.bytes_moved
    assert eng.slots.stats == {k: jeng.slots.stats[k] for k in eng.slots.stats}
    assert trace.recall() == pytest.approx(jtrace.recall(), abs=0)
    want = jt.simulate_odmoe(cfg, jtrace, jeng.sched, jt.RTX3090_EDGE)
    for tr in (trace, torch_trace(jtrace)):
        got = simulate_odmoe(tcfg, tr, GroupSchedule(8, 2), RTX3090_EDGE)
        np.testing.assert_allclose(got.per_token_s, want.per_token_s, rtol=1e-12, atol=0)
        np.testing.assert_allclose(got.io_stall_s, want.io_stall_s, rtol=1e-12, atol=0)


def test_spec_prefetch_executors_change_no_event(model):
    base, out0, _ = _port_generate(model, 4)
    for prefetch in ("sync", "thread"):
        eng, out, _ = _port_generate(model, 4, prefetch=prefetch)
        np.testing.assert_array_equal(out, out0)
        assert _events(eng) == _events(base), prefetch
        assert eng.prefetch_report()["prefetch_prefetched"] + \
            eng.prefetch_report()["prefetch_inline"] > 0


def test_spec_packed_slots_equal_greedy_under_transport(model):
    _, _, tcfg, tparams = model
    toks = prompt(tcfg, PROMPT_SEED)
    ref = greedy_generate(tcfg, tparams, {"tokens": torch.from_numpy(toks)}, N_TOK,
                          transport="int8").numpy()
    eng, out, trace = _port_generate(model, 4, packed_slots=True, transport="int8")
    np.testing.assert_array_equal(out, ref)
    assert len(trace.records) < N_TOK - 1
    assert {e.scheme for e in eng.slots.events} == {"int8"}


@pytest.mark.parametrize("kw,match", [
    ({"speculate": 0}, "speculate must be >= 1"),
    ({"speculate": 2, "predictor": "none"}, "SEP shadow"),
    ({"speculate": 2, "wave_compute": "loop"}, "grouped wave path"),
    ({"speculate": 3, "window": 2}, "sliding window"),
])
def test_speculation_guards_raise_as_jax_does(kw, match):
    kw = dict(kw)
    cfg = tiny_moe(num_layers=2, sliding_window=kw.pop("window", 0))
    params = jinit(cfg, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match=match):
        JEngine(cfg, params, n_workers=8, **kw)
    with pytest.raises(ValueError, match=match):
        ODMoEEngine(torch_cfg(cfg), bridge(params), n_workers=8, device="cpu", **kw)


# --------------------------------------------------------------- serving
def _pages(reqs):
    window = max(len(r.prompt) + r.max_new_tokens for r in reqs) + 2
    return -(-window // PAGE) * 4 // 2          # half the dense footprint of 4 windows


@pytest.fixture(scope="module")
def served(model):
    """Both packages' loops on the same burst: ``speculate=2`` dense, and
    ``speculate=4`` paged at half the dense budget with chunked prefill."""
    cfg, params, tcfg, tparams = model
    jreqs = jmake_traffic(cfg, N_REQ, 0.0, prompt_len=12, max_new=6, seed=3)
    out = {"jreqs": jreqs}
    for k, paged in ((2, False), (4, True)):
        kw = dict(max_batch=4, prefill_chunk=4 if paged else 0)
        jeng = JEngine(cfg, params, n_workers=8, predictor="sep", speculate=k)
        jpool = JPool(cfg, num_pages=_pages(jreqs), page_tokens=PAGE) if paged else None
        jres = JLoop(jeng, kv_pool=jpool, **kw).run(jreqs)
        teng = ODMoEEngine(tcfg, tparams, n_workers=8, predictor="sep", speculate=k,
                           device="cpu")
        tpool = (KVPool(tcfg, num_pages=_pages(jreqs), page_tokens=PAGE, device="cpu")
                 if paged else None)
        tres = ServingLoop(teng, kv_pool=tpool, **kw).run(torch_requests(jreqs))
        out[k] = dict(jeng=jeng, jres=jres, teng=teng, tres=tres)
    return out


@pytest.mark.parametrize("k", [2, 4], ids=["dense-2", "paged-4"])
def test_spec_serving_equals_solo_and_jax(model, served, k):
    _, _, tcfg, tparams = model
    run = served[k]
    tres, jres = run["tres"], run["jres"]
    for r in torch_requests(served["jreqs"]):
        solo = greedy_generate(tcfg, tparams, {"tokens": torch.from_numpy(r.prompt)[None]},
                               r.max_new_tokens)[0].numpy()
        np.testing.assert_array_equal(tres.outputs[r.rid], solo)
        np.testing.assert_array_equal(tres.outputs[r.rid], np.asarray(jres.outputs[r.rid]))
    assert tres.spec_stats == jres.spec_stats
    ss = tres.spec_stats
    assert ss["speculate"] == k and 0.0 < ss["acceptance"] <= 1.0
    for r in served["jreqs"]:
        assert ss["per_request"][r.rid]["committed"] == r.max_new_tokens - 1
    assert tres.mean_batch > 1
    assert tres.kv_stats == jres.kv_stats
    assert [step_fields(s) for s in tres.steps] == [step_fields(s) for s in jres.steps]
    for t, j in zip(tres.steps, jres.steps):
        for name in ("start_s", "duration_s", "stall_s"):
            assert getattr(t, name) == pytest.approx(getattr(j, name), rel=1e-12, abs=1e-15)
    assert _events(run["teng"]) == _events(run["jeng"])
    for rid, st in tres.states.items():
        jst = jres.states[rid]
        assert [(r.index, r.spec_len, r.committed) for r in st.trace.records] == \
            [(r.index, r.spec_len, r.committed) for r in jst.trace.records]
        assert st.last_experts == jst.last_experts


def test_spec_serving_preempts_in_the_paged_pool(served):
    """The paged run under k = 4 exercises preemption and resume."""
    st = served[4]["tres"].kv_stats
    assert st["preemptions"] >= 1 and st["resumes"] >= 1


@pytest.mark.parametrize("mode", [[], ["--requests", "3", "--arrival-rate", "0"]],
                         ids=["single", "serving"])
def test_cli_speculate_prints_acceptance(mode, capsys):
    serve_main(["--device", "cpu", "--tokens", "6", "--prompt-len", "8", "--speculate", "2"]
               + mode)
    text = capsys.readouterr().out
    assert "speculation k=2: acceptance" in text
    assert ("per-request tokens == solo reference (same transport policy): True" in text
            if mode else "tokens == dense reference (same transport policy): True" in text)
