"""The port's continuous-batching serving against the JAX package's on
bridged ``tiny_moe`` weights: the same ``make_traffic`` requests through
both ``ServingLoop``s, dense and with a paged KV pool at half the dense
budget, give equal tokens, ``StepRecord``s, ``kv_stats`` and load events,
and modelled times within 1e-12; every served request equals the port's
own solo ``greedy_generate``.  Then the pieces: traces, the pool, the
composer, shadow-state composition and the unported options."""
import argparse

import jax
import numpy as np
import pytest
import torch

from _torch_bridge import bridge, step_fields, torch_cfg, torch_requests
from conftest import tiny_moe
from repro.core import ODMoEEngine as JEngine
from repro.core import node_memory_report as jnode_memory_report
from repro.models import init_params as jinit
from repro.serve import BatchComposer as JComposer
from repro.serve import KVPool as JPool
from repro.serve import RequestState as JState
from repro.serve import ServingLoop as JLoop
from repro.serve import WorkloadSpec as JSpec
from repro.serve import dense_cache_footprint as jdense_footprint
from repro.serve import make_trace as jmake_trace
from repro.serve import make_traffic as jmake_traffic
from repro_torch.core import (ODMoEEngine, TokenRecord, concat_cache_lists,
                              concat_shadow_states, node_memory_report, slice_shadow_state)
from repro_torch.launch.serve import build_parser, serve_traffic
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import greedy_generate
from repro_torch.serve import (BatchComposer, KVPool, PoolExhausted, Request, RequestQueue,
                               RequestState, ServingLoop, WorkloadSpec, dense_cache_footprint,
                               make_trace, make_traffic)

N_REQ, PROMPT, MAX_NEW, PAGE = 5, 12, 6, 4
TIME_TOL = 1e-12


def _pages(reqs):
    window = max(len(r.prompt) + r.max_new_tokens for r in reqs) + 2
    return -(-window // PAGE) * 4 // 2          # half the dense footprint of 4 windows


@pytest.fixture(scope="module")
def served():
    """Both packages' loops on the same requests: dense, then paged (one
    JAX run each, shared by every test of this module)."""
    cfg = tiny_moe()
    params = jinit(cfg, jax.random.PRNGKey(0))
    tcfg, tparams = torch_cfg(cfg), bridge(params)
    jreqs = jmake_traffic(cfg, N_REQ, 0.0, prompt_len=PROMPT, max_new=MAX_NEW, seed=3)
    out = {"cfg": cfg, "tcfg": tcfg, "tparams": tparams, "jreqs": jreqs}
    for paged in (False, True):
        jeng = JEngine(cfg, params, n_workers=8, predictor="sep")
        jpool = JPool(cfg, num_pages=_pages(jreqs), page_tokens=PAGE) if paged else None
        jres = JLoop(jeng, max_batch=4, kv_pool=jpool).run(jreqs)
        teng = ODMoEEngine(tcfg, tparams, n_workers=8, predictor="sep", device="cpu")
        tpool = (KVPool(tcfg, num_pages=_pages(jreqs), page_tokens=PAGE, device="cpu")
                 if paged else None)
        tres = ServingLoop(teng, max_batch=4, kv_pool=tpool).run(torch_requests(jreqs))
        out[paged] = dict(jeng=jeng, jres=jres, jpool=jpool, teng=teng, tres=tres, tpool=tpool)
    return out


def test_make_traffic_equals_jax():
    cfg = tiny_moe()
    for rate in (0.0, 3.0):
        mine = make_traffic(torch_cfg(cfg), 6, rate, prompt_len=20, max_new=7, seed=5)
        theirs = torch_requests(jmake_traffic(cfg, 6, rate, prompt_len=20, max_new=7, seed=5))
        assert [(r.rid, r.prompt.tolist(), r.max_new_tokens, r.arrival_s) for r in mine] == \
            [(r.rid, r.prompt.tolist(), r.max_new_tokens, r.arrival_s) for r in theirs]


@pytest.mark.parametrize("arrival,dist", [("poisson", "lognormal"), ("bursty", "zipf"),
                                          ("diurnal", "lognormal")])
def test_make_trace_equals_jax(arrival, dist):
    cfg = tiny_moe()
    kw = dict(n_requests=12, rate=20.0, arrival=arrival, length_dist=dist)
    mine = make_trace(torch_cfg(cfg), WorkloadSpec(**kw), seed=4)
    theirs = torch_requests(jmake_trace(cfg, JSpec(**kw), seed=4))

    def fields(r):
        return (r.rid, r.prompt.tolist(), r.max_new_tokens, r.arrival_s, r.tenant, r.weight,
                r.ttft_slo_s, r.tpot_slo_s)
    assert [fields(r) for r in mine] == [fields(r) for r in theirs]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_outputs_equal_jax_and_solo_greedy(served, paged):
    run, tcfg, tparams = served[paged], served["tcfg"], served["tparams"]
    tres, jres = run["tres"], run["jres"]
    assert sorted(tres.outputs) == sorted(jres.outputs) == list(range(N_REQ))
    for r in torch_requests(served["jreqs"]):
        np.testing.assert_array_equal(tres.outputs[r.rid], np.asarray(jres.outputs[r.rid]))
        solo = greedy_generate(tcfg, tparams, {"tokens": torch.from_numpy(r.prompt)[None]},
                               r.max_new_tokens)[0].numpy()
        np.testing.assert_array_equal(tres.outputs[r.rid], solo)
    assert tres.mean_batch > 1


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_step_records_equal_jax(served, paged):
    tres, jres = served[paged]["tres"], served[paged]["jres"]
    assert [step_fields(s) for s in tres.steps] == [step_fields(s) for s in jres.steps]
    for t, j in zip(tres.steps, jres.steps):
        for name in ("start_s", "duration_s", "stall_s"):
            assert abs(getattr(t, name) - getattr(j, name)) <= TIME_TOL
        for lt, lj in zip(t.record.layers, j.record.layers):
            np.testing.assert_allclose(lt.gates, np.asarray(lj.gates), rtol=1e-5, atol=1e-6)
        assert t.wall_s > 0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_timings_kv_stats_and_load_events_equal_jax(served, paged):
    run = served[paged]
    tres, jres = run["tres"], run["jres"]
    assert tres.kv_stats == jres.kv_stats
    trep, jrep = tres.timings.report(), jres.timings.report()
    assert trep.keys() == jrep.keys()
    for key in trep:
        assert abs(trep[key] - jrep[key]) <= TIME_TOL, key
    assert tres.degraded_report() == jres.degraded_report()
    assert tres.tenant_report().keys() == jres.tenant_report().keys()

    def events(ev):
        return [(e.token, e.layer, e.expert, e.worker, e.predicted, e.bytes, e.scheme,
                 tuple(e.requests)) for e in ev]
    assert events(run["teng"].slots.events) == events(run["jeng"].slots.events)
    assert any(len(e.requests) > 1 for e in run["teng"].slots.events)
    tstats, jstats = run["teng"].slots.stats, run["jeng"].slots.stats
    assert tstats == jstats
    for rid, state in tres.states.items():
        jstate = jres.states[rid]
        assert [(r.index, r.spec_len, [(lr.layer, np.asarray(lr.true).tolist(), lr.correct)
                                       for lr in r.layers]) for r in state.trace.records] == \
            [(r.index, r.spec_len, [(lr.layer, np.asarray(lr.true).tolist(), lr.correct)
                                    for lr in r.layers]) for r in jstate.trace.records]


def test_paged_run_preempts_resumes_and_fits_its_budget(served):
    run = served[True]
    st, pool = run["tres"].kv_stats, run["tpool"]
    assert st["preemptions"] >= 1 and st["resumes"] == st["preemptions"]
    assert st["swap_in_bytes"] == st["swap_out_bytes"] > 0
    assert st["peak_pages_used"] <= pool.num_pages
    mine = node_memory_report(run["teng"], pool, budget_bytes=10 ** 9)
    theirs = jnode_memory_report(run["jeng"], run["jpool"], budget_bytes=10 ** 9)
    assert mine == theirs and mine["within_budget"]
    assert dense_cache_footprint(served["tcfg"], 40, 3) == \
        jdense_footprint(served["cfg"], 40, 3)
    assert pool.page_set_bytes == run["jpool"].page_set_bytes


def _run_capped(loop, reqs, ticks: int = 200):
    """``loop.run`` with a bound on iterations, so a livelock fails the test
    instead of hanging it."""
    loop.start(reqs)
    for _ in range(ticks):
        if not loop.tick():
            return loop.finish()
    raise AssertionError(f"serving did not finish within {ticks} iterations")


def test_scheduling_policies_equal_jax():
    """A multi-tenant trace through priority admission, deadline-slack
    preemption, fair composition and chunked prefill on a small pool:
    the same tokens, steps and counters as the reference.  (Trace seed 3:
    with seed 2 both packages preempt and resume the same request forever;
    ROADMAP.md queue 3.)"""
    cfg = tiny_moe(num_layers=2)
    params = jinit(cfg, jax.random.PRNGKey(1))
    tcfg, tparams = torch_cfg(cfg), bridge(params)
    spec = dict(n_requests=5, rate=40.0, arrival="bursty", prompt_median=8, max_prompt=20,
                output_median=4, max_output=6)
    jreqs = jmake_trace(cfg, JSpec(**spec), seed=3)
    kw = dict(max_batch=3, prefill_chunk=8, preempt="slack", admit="priority")
    jpool = JPool(cfg, num_pages=8, page_tokens=PAGE)
    jeng = JEngine(cfg, params, n_workers=8, predictor="sep")
    jres = _run_capped(JLoop(jeng, composer=JComposer(3, "fair", kv_pool=jpool),
                             kv_pool=jpool, **kw), jreqs)
    tpool = KVPool(tcfg, num_pages=8, page_tokens=PAGE, device="cpu")
    teng = ODMoEEngine(tcfg, tparams, n_workers=8, predictor="sep", device="cpu")
    tres = _run_capped(ServingLoop(teng, composer=BatchComposer(3, "fair", kv_pool=tpool),
                                   kv_pool=tpool, **kw), torch_requests(jreqs))
    assert {k: v.tolist() for k, v in tres.outputs.items()} == \
        {k: np.asarray(v).tolist() for k, v in jres.outputs.items()}
    assert [step_fields(s) for s in tres.steps] == [step_fields(s) for s in jres.steps]
    assert tres.kv_stats == jres.kv_stats and tres.kv_stats["preemptions"] >= 1
    trep, jrep = tres.tenant_report(), jres.tenant_report()
    assert trep.keys() == jrep.keys() == {"batch", "interactive"}
    for name in trep:
        for key in trep[name]:
            assert abs(trep[name][key] - jrep[name][key]) <= TIME_TOL


# ------------------------------------------------------------------- pieces
def _pool(n=6, page=4):
    return KVPool(torch_cfg(tiny_moe(num_layers=2)), num_pages=n, page_tokens=page,
                  device="cpu")


def test_kvpool_alloc_release_exhaust():
    pool = _pool()
    assert pool.set_window(10) == 12 and pool.window_pages == 3
    assert pool.ensure(0, 5) == 2 and pool.ensure(0, 8) == 0 and pool.ensure(0, 9) == 1
    assert pool.ensure(1, 12) == 3
    assert pool.free_pages == 0 and pool.pages_used == 6
    with pytest.raises(PoolExhausted):
        pool.ensure(2, 1)
    pool.release(0)
    assert pool.free_pages == 3 and pool.stats.released_pages == 3
    assert pool.stats.peak_pages_used == 6 and pool.stats.allocated_pages == 6
    with pytest.raises(ValueError):
        pool.set_window(40)
    with pytest.raises(ValueError):
        KVPool(torch_cfg(tiny_moe()), num_pages=0, page_tokens=4, device="cpu")


def test_kvpool_gather_scatter_and_swap_round_trips_are_bitwise():
    pool = _pool(n=8)
    pool.set_window(12)
    rng = np.random.default_rng(0)
    layers = []
    for li in range(2):
        k = torch.from_numpy(rng.standard_normal((1, 12, 2, 16)).astype(np.float32))
        v = torch.from_numpy(rng.standard_normal((1, 12, 2, 16)).astype(np.float32))
        pos = torch.tensor([list(range(7)) + [-1] * 5], dtype=torch.int32)
        layers.append({"k": k, "v": v, "pos": pos})
    handle = pool.adopt(7, layers, prompt_len=7)
    assert pool.table_pages(7) == 2
    for li in range(2):
        got = handle[li]
        np.testing.assert_array_equal(got["k"][0, :8].numpy(), layers[li]["k"][0, :8].numpy())
        np.testing.assert_array_equal(got["pos"][0].numpy(),
                                      np.array(list(range(7)) + [-1] * 5))
        assert torch.equal(got["k"][0, 8:], torch.zeros_like(got["k"][0, 8:]))
    before = [handle[li] for li in range(2)]
    nbytes = pool.swap_out(7)
    assert nbytes == 2 * pool.page_set_bytes and pool.swapped_pages(7) == 2
    pool.ensure(8, 12)                  # another request takes and dirties pages
    pool.scatter_layer(0, [8], {name: torch.ones_like(t) if name != "pos" else t + 100
                                for name, t in pool.gather_layer(0, [8]).items()})
    pool.release(8)
    assert pool.swap_in(7) == nbytes
    for li in range(2):
        for name in ("k", "v", "pos"):
            assert torch.equal(handle[li][name], before[li][name])
    batch = concat_cache_lists([handle, handle])
    assert torch.equal(batch[0]["k"][1], before[0]["k"][0])
    with pytest.raises(TypeError):
        concat_cache_lists([handle, [dict(layers[0])]])
    with pytest.raises(ValueError):
        concat_cache_lists([])


def _state(rid, experts, pos=0, tenant="default", weight=1.0, cls=RequestState, req_cls=Request):
    req = req_cls(rid=rid, prompt=np.zeros(3, np.int32), max_new_tokens=4, tenant=tenant,
                  weight=weight)
    st = cls(request=req, token=None, cache_list=[], pos=torch.tensor([pos]))
    st.last_experts = frozenset(experts)
    return st


COMPOSE = [
    ("overlap", [{(0, 1), (2, 3)}, {(0, 5)}, {(0, 1), (2, 3)}, {(2, 3)}, {(0, 7)}], 3),
    ("fifo", [{(0, 1)}, {(0, 5)}, {(0, 1)}, {(2, 3)}], 2),
    ("overlap", [{(0, 1)}, {(1, 1)}, {(2, 2)}, {(0, 1), (1, 1)}], 4),
]


@pytest.mark.parametrize("policy,sigs,max_batch", COMPOSE)
def test_composer_choices_equal_jax(policy, sigs, max_batch):
    from repro.serve import Request as JRequest
    mine = BatchComposer(max_batch, policy).compose([_state(i, s) for i, s in enumerate(sigs)])
    theirs = JComposer(max_batch, policy).compose(
        [_state(i, s, cls=JState, req_cls=JRequest) for i, s in enumerate(sigs)])
    assert [s.rid for s in mine] == [s.rid for s in theirs]
    if policy == "overlap" and max_batch == 3:
        assert [s.rid for s in mine] == [0, 2, 3]


def test_composer_fair_and_budget_aware():
    states = [_state(0, {(0, 1)}, tenant="a"), _state(1, {(0, 1)}, tenant="a"),
              _state(2, {(0, 2)}, tenant="b", weight=4.0), _state(3, {(0, 3)}, tenant="b",
                                                               weight=4.0)]
    assert [s.rid for s in BatchComposer(2, "fair").compose(states)] == [0, 2]
    pool = _pool(n=3)
    pool.set_window(12)
    pool.ensure(0, 4)
    pool.ensure(1, 4)
    for st, p in zip(states[:2], (4, 4)):
        st.pos = torch.tensor([p])          # both cross into a new page next step
    pool.ensure(2, 1)
    picked = BatchComposer(4, "fifo", kv_pool=pool).compose(states[:3])
    assert [s.rid for s in picked] == [0, 2]
    with pytest.raises(ValueError):
        BatchComposer(0)
    with pytest.raises(ValueError):
        BatchComposer(2, "lifo")


def test_request_queue_lifecycle():
    reqs = [Request(rid=i, prompt=np.zeros(2, np.int32), max_new_tokens=2,
                    arrival_s=float(t)) for i, t in enumerate((0.5, 0.0, 2.0))]
    q = RequestQueue(reqs)
    assert q.next_arrival_s() == 0.0
    assert [r.rid for r in q.pop_arrived(1.0)] == [1, 0]
    st = RequestState(request=reqs[1], token=None, cache_list=[], pos=torch.tensor([2]))
    q.activate(st)
    assert q.runnable() == [st] and q.state_counts()["runnable"] == 1
    st.generated = [5, 6]
    q.retire(st)
    assert q.finished == {1: st} and not q.all_done
    with pytest.raises(ValueError):
        RequestQueue(reqs + reqs[:1])
    with pytest.raises(ValueError):
        Request(rid=9, prompt=np.zeros(2, np.int32), max_new_tokens=0)


def test_shadow_state_concat_slice_round_trip(served):
    tcfg, tparams = served["tcfg"], served["tparams"]
    eng = ODMoEEngine(tcfg, tparams, n_workers=8, predictor="sep", device="cpu")
    states = [eng.shadow.prefill_state({"tokens": torch.from_numpy(r.prompt)[None]}, 24)
              for r in torch_requests(served["jreqs"][:3])]
    composed = concat_shadow_states(states)
    assert composed["pos"].shape == (3,)
    for i, st in enumerate(states):
        back = slice_shadow_state(composed, i)
        assert torch.equal(back["pos"], st["pos"]) and torch.equal(back["token"], st["token"])
        for c_back, c_st in zip(back["caches"], st["caches"]):
            for name in ("k", "v", "pos"):
                assert torch.equal(c_back[name], c_st[name])
    assert concat_shadow_states(states[:1]) is states[0]


def test_unported_serving_options_raise():
    """``--replicas 2`` without ``--requests`` exits before building
    anything, as the JAX launcher does."""
    with pytest.raises(SystemExit, match="needs --requests"):
        serve_main(["--replicas", "2", "--device", "cpu"])


def test_cli_serving_mode_on_the_host(served, capsys):
    args = build_parser().parse_args(["--requests", "3", "--arrival-rate", "0", "--prompt-len",
                                      "8", "--tokens", "4", "--kv-pages", "8",
                                      "--page-tokens", "4", "--device", "cpu"])
    assert isinstance(args, argparse.Namespace)
    out = serve_traffic(served["tcfg"], served["tparams"], args)
    text = capsys.readouterr().out
    assert "per-request tokens == solo reference (same transport policy): True" in text
    assert "modelled (rtx3090-edge profile, not measured)" in text
    assert "measured composed decode step on cpu" in text
    assert out["launches_serving"]["flash_decode"] == 0          # the host runs the plain path
    assert len(out["result"].outputs) == 3
    assert out["build_peak_bytes"] is None and out["serving_peak_bytes"] is None
    assert "peak allocated device memory" not in text            # a card's counter only


@pytest.mark.parametrize("model", ["tiny_moe", "tiny_hybrid"])
def test_stored_request_state_holds_only_its_own_bytes(model):
    """After a composed step, each request's stored cache list and shadow
    state lie in storage of their own: a stored request does not keep the
    composed batch alive.  Their values are the composed batch's rows."""
    from repro_torch.core import slice_cache_list
    from repro_torch.models import init_params
    from repro_torch.models.transformer import tree_leaves
    from test_torch_hybrid import tiny_hybrid
    tcfg = torch_cfg(tiny_moe() if model == "tiny_moe" else tiny_hybrid())
    tparams = init_params(tcfg, seed=0, device="cpu")
    eng = ODMoEEngine(tcfg, tparams, n_workers=8, predictor="sep", device="cpu")
    gen = np.random.default_rng(5)
    batches = [{"tokens": torch.from_numpy(gen.integers(0, tcfg.vocab_size, (1, n)))}
               for n in (9, 12, 10)]
    toks, caches, pos = zip(*(eng.prefill_request(b, 24) for b in batches))
    shadow = concat_shadow_states([eng.shadow.prefill_state(b, 24) for b in batches])
    preds, shadow = eng.shadow.step_state(shadow, shadow["token"])
    rec = TokenRecord(index=1, aligned_token=False, aligned_kv=False)
    _, composed, _ = eng.decode_batch(torch.cat(toks), concat_cache_lists(list(caches)),
                                      torch.cat(pos), preds, 1, rec)

    def own(leaf):
        return leaf.untyped_storage().nbytes() == leaf.numel() * leaf.element_size()

    for i in range(len(batches)):
        mine = slice_cache_list(composed, i)
        for li, layer in enumerate(mine):
            for name, leaf in layer.items():
                assert own(leaf), (i, li, name)
                assert torch.equal(leaf, composed[li][name][i:i + 1])
        st = slice_shadow_state(shadow, i)
        assert all(own(leaf) for leaf in tree_leaves(st))
        for c_st, c_all in zip(st["caches"], shadow["caches"]):
            assert all(torch.equal(c_st[k], c_all[k][:, i:i + 1]) for k in c_st)
