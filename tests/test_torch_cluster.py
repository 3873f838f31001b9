"""The port's compute-vs-ship (``ODMoEEngine(compute_vs_ship=...)``, the
hosted-expert pricing of ``DecodeClock``) and its cluster router
(``repro_torch.serve.cluster``) against the JAX package on bridged
``tiny_moe`` weights.

Exact: tokens, per-layer ``hosted`` experts, reloads, load events,
routing assignments and autoscale events.  Modelled times and reports
within ``TIME_TOL`` (the same float64 arithmetic in the same order), a
hosted trace's replay within ``REPLAY_TOL``.  Routing, placement and
compute-vs-ship are scheduling: every request equals its solo
``greedy_generate``, whatever replica served it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import bridge, torch_cfg, torch_faults, torch_profiles, torch_requests
from conftest import tiny_moe
from repro.core import RTX3090_EDGE as J_EDGE
from repro.core import ChaosExecutor as JChaos
from repro.core import DecodeClock as JClock
from repro.core import ODMoEEngine as JEngine
from repro.core import simulate_odmoe as jsimulate
from repro.fleet import FaultEvent as JFaultEvent
from repro.fleet import FaultInjector as JInjector
from repro.fleet import FleetSchedule as JFleetSchedule
from repro.fleet import GateStatsRecorder as JRecorder
from repro.fleet import WorkerProfile as JProfile
from repro.fleet import optimize_placement as joptimize_placement
from repro.fleet import uniform_plan as juniform_plan
from repro.models import init_params
from repro.serve import ClusterRouter as JRouter
from repro.serve import Request as JRequest
from repro.serve import RequestQueue as JQueue
from repro.serve import ServingLoop as JLoop
from repro.serve import make_cluster as jmake_cluster
from repro_torch.core import (RTX3090_EDGE, ChaosExecutor, DecodeClock, ODMoEEngine,
                              simulate_odmoe)
from repro_torch.fleet import (FaultInjector, FleetSchedule, GateStatsRecorder,
                               optimize_placement, uniform_plan)
from repro_torch.launch.serve import build_parser, serve_cluster
from repro_torch.models import greedy_generate
from repro_torch.serve import ClusterRouter, RequestQueue, ServingLoop, make_cluster
from repro_torch.serve.cluster import ROUTING_POLICIES

N_TOK = 5
TIME_TOL = 1e-12
REPLAY_TOL = 1e-9


@functools.lru_cache(maxsize=None)
def _model():
    cfg = tiny_moe(d_expert=128)                      # packed tiles need 128
    params = init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params, torch_cfg(cfg), bridge(params)


def _tokens(cfg):
    """The single-stream prompts: plan calibration and the compute-vs-ship
    runs share them, so the JAX side compiles one set of shapes."""
    return np.asarray(jax.random.randint(jax.random.PRNGKey(2), (2, 8), 0, cfg.vocab_size),
                      np.int32)


def _jrequests(n=6, rate=40.0, seed=3):
    cfg = _model()[0]
    rng = np.random.default_rng(seed)
    arrive = np.cumsum(rng.exponential(1.0 / rate, size=n))
    return [JRequest(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                6 + int(rng.integers(0, 4))).astype(np.int32),
                     max_new_tokens=N_TOK, arrival_s=float(arrive[i]),
                     weight=float(1 + (i % 3)))
            for i in range(n)]


def _burst(n, late=None):
    """``n`` requests at t=0 (and one at ``late``), with the longest prompt
    of ``_jrequests()``: the JAX side reuses the grid's compiled shapes."""
    arrivals = [0.0] * n + ([late] if late is not None else [])
    return [JRequest(rid=i, prompt=np.arange(9, dtype=np.int32) + i, max_new_tokens=N_TOK,
                     arrival_s=t) for i, t in enumerate(arrivals)]


@functools.lru_cache(maxsize=None)
def _solo(prompt: tuple, n: int, transport=None):
    _, _, tcfg, tparams = _model()
    return greedy_generate(tcfg, tparams, {"tokens": torch.tensor([prompt], dtype=torch.int32)},
                           n, transport=transport)[0].numpy()


def _check_solo(res, reqs, transport=None):
    assert set(res.outputs) == {r.rid for r in reqs}
    for r in reqs:
        np.testing.assert_array_equal(
            res.outputs[r.rid], _solo(tuple(int(t) for t in r.prompt), r.max_new_tokens,
                                      transport), err_msg=f"rid={r.rid}")


def _events(slots):
    return [(e.token, e.layer, e.expert, e.worker, e.predicted, e.bytes, e.scheme,
             tuple(e.requests)) for e in slots.events]


def _layers(trace):
    return [(rec.index, lr.layer, lr.moe_index, np.asarray(lr.true).tolist(), lr.reloads,
             list(lr.assignments), [list(w) for w in lr.waves], tuple(lr.touched),
             tuple(lr.hosted))
            for rec in trace.records for lr in rec.layers]


def _same_report(rep, jrep):
    assert rep.keys() == jrep.keys()
    for k, v in jrep.items():
        if k == "per_replica":
            assert len(rep[k]) == len(v)
            for a, b in zip(rep[k], v):
                _same_report(a, b)
        elif isinstance(v, float):
            assert rep[k] == pytest.approx(v, rel=TIME_TOL, abs=TIME_TOL), k
        else:
            assert rep[k] == v, k


def _same_cluster(res, jres):
    """Outputs, assignments, autoscale events, each replica's steps,
    composed records and events, and the reports."""
    assert res.outputs.keys() == jres.outputs.keys()
    for rid, out in jres.outputs.items():
        np.testing.assert_array_equal(res.outputs[rid], np.asarray(out))
    assert res.assignments == jres.assignments
    assert res.autoscale_events == jres.autoscale_events
    assert res.policy == jres.policy
    for r, jr in zip(res.replicas, jres.replicas):
        assert [s.request_ids for s in r.steps] == [s.request_ids for s in jr.steps]
        assert _layers(r.trace) == _layers(jr.trace)
        for s, js in zip(r.steps, jr.steps):
            for name in ("start_s", "duration_s", "stall_s"):
                assert getattr(s, name) == pytest.approx(getattr(js, name), rel=TIME_TOL,
                                                         abs=TIME_TOL)
    _same_report(res.report(), jres.report())
    assert res.tenant_report().keys() == jres.tenant_report().keys()


def _run_both(engine_kw=None, jengine_kw=None, reqs=None, loop_kw=None, **router_kw):
    """The same cluster in both packages over the same requests."""
    cfg, params, tcfg, tparams = _model()
    jreqs = reqs if reqs is not None else _jrequests()
    jengine_kw = dict(jengine_kw if jengine_kw is not None else engine_kw)
    engine_kw = dict(engine_kw, device="cpu")
    loop_kw = loop_kw or dict(max_batch=2)
    jrouter = jmake_cluster(cfg, params, engine_kw=jengine_kw, loop_kw=loop_kw, **router_kw)
    router = make_cluster(tcfg, tparams, engine_kw=engine_kw, loop_kw=loop_kw, **router_kw)
    jres = jrouter.run(jreqs)
    res = router.run(torch_requests(jreqs))
    return router, res, jrouter, jres, torch_requests(jreqs)


# ============================================================ the grid
@functools.lru_cache(maxsize=None)
def _plans(kind):
    """(port plan, JAX plan): uniform, or optimized on a short decode's
    gate statistics, each package calibrating on its own engine."""
    if kind == "uniform":
        return uniform_plan(4, 2), juniform_plan(4, 2)
    cfg, params, tcfg, tparams = _model()
    tokens = _tokens(cfg)
    jrec, rec = JRecorder(), GateStatsRecorder()
    JEngine(cfg, params, n_workers=4, group_size=2, gate_stats=jrec).generate(
        {"tokens": jnp.asarray(tokens)}, N_TOK)
    ODMoEEngine(tcfg, tparams, n_workers=4, group_size=2, gate_stats=rec,
                device="cpu").generate({"tokens": torch.tensor(tokens)}, N_TOK)
    kw = dict(num_experts=cfg.num_experts, n_moe=rec.n_layers)
    plan = optimize_placement(rec, FleetSchedule(4, 2), **kw)
    jplan = joptimize_placement(jrec, JFleetSchedule(4, 2), **kw)
    assert (plan.orders, plan.expert_workers) == (jplan.orders, jplan.expert_workers)
    return plan, jplan


@pytest.mark.parametrize("placement", [None, "uniform", "opt"])
@pytest.mark.parametrize("transport", [None, "int8"])
def test_cluster_equals_jax_and_solo(placement, transport):
    if placement is None:
        kw = jkw = dict(n_workers=4, group_size=2, transport=transport)
    else:
        plan, jplan = _plans(placement)
        kw = dict(sched=FleetSchedule(4, 2, plan=plan), transport=transport)
        jkw = dict(sched=JFleetSchedule(4, 2, plan=jplan), transport=transport)
    router, res, jrouter, jres, reqs = _run_both(kw, jkw, replicas=2)
    _same_cluster(res, jres)
    for loop, jloop in zip(router.loops, jrouter.loops):
        assert _events(loop.engine.slots) == _events(jloop.engine.slots)
    _check_solo(res, reqs, transport)
    assert sorted(set(res.assignments.values())) == [0, 1]


@pytest.mark.parametrize("policy", ["round_robin", "weighted"])
def test_routing_policies_equal_jax(policy):
    router, res, _, jres, reqs = _run_both(dict(n_workers=4, group_size=2), replicas=2,
                                           policy=policy)
    _same_cluster(res, jres)
    _check_solo(res, reqs)
    if policy == "round_robin":
        order = [res.assignments[r.rid] for r in sorted(reqs, key=lambda r: (r.arrival_s,
                                                                            r.rid))]
        assert order == [0, 1] * 3
    again = make_cluster(*_model()[2:], replicas=2, policy=policy,
                         engine_kw=dict(n_workers=4, group_size=2, device="cpu"),
                         loop_kw=dict(max_batch=2)).run(reqs)
    assert again.assignments == res.assignments                   # deterministic


def test_least_loaded_spreads_simultaneous_arrivals_as_jax():
    _, res, _, jres, reqs = _run_both(dict(n_workers=4, group_size=2), reqs=_burst(4),
                                      replicas=2)
    _same_cluster(res, jres)
    assert sorted(res.assignments.values()) == [0, 0, 1, 1]      # ties to the lower index
    _check_solo(res, reqs)


def test_replicas_share_the_fleet_store_and_statistics():
    rec = GateStatsRecorder()
    router, res, jrouter, jres, reqs = _run_both(
        dict(n_workers=4, group_size=2, gate_stats=rec),
        dict(n_workers=4, group_size=2, gate_stats=JRecorder()), replicas=3)
    engines = [l.engine for l in router.loops]
    assert all(e.sched is engines[0].sched and e.store is engines[0].store
               and e.gate_stats is rec for e in engines)
    assert len({id(e.slots) for e in engines}) == 3
    assert len({id(e.shadow) for e in engines}) == 3
    clocks = [l.clock for l in router.loops]
    assert all(c.worker_free is clocks[0].worker_free for c in clocks)
    assert len({id(c) for c in clocks}) == 3
    jrec = jrouter.loops[0].engine.gate_stats
    assert rec.counts == jrec.counts and rec.rows == jrec.rows
    assert all(rows == sum(r.max_new_tokens - 1 for r in reqs) for rows in rec.rows.values())
    _same_cluster(res, jres)


def test_single_replica_cluster_equals_its_serving_loop():
    _, _, tcfg, tparams = _model()
    reqs = torch_requests(_jrequests())
    solo = ServingLoop(ODMoEEngine(tcfg, tparams, n_workers=4, group_size=2, device="cpu"),
                       max_batch=2).run(reqs)
    res = make_cluster(tcfg, tparams, replicas=1,
                       engine_kw=dict(n_workers=4, group_size=2, device="cpu"),
                       loop_kw=dict(max_batch=2)).run(reqs)
    for rid, out in solo.outputs.items():
        np.testing.assert_array_equal(res.outputs[rid], out)
    assert [s.duration_s for s in res.replicas[0].steps] == [s.duration_s for s in solo.steps]


# ============================================================ autoscale
AUTOSCALE = dict(replicas=2, autoscale=True, min_replicas=1, high_load=1.5, low_load=0.5,
                 sustain=1)


@pytest.fixture(scope="module")
def autoscaled():
    """One burst of four at t=0 spawns the parked replica; a late arrival,
    after the burst has drained, finds no pressure and drains it."""
    return _run_both(dict(n_workers=4, group_size=2), reqs=_burst(4, late=5.0), **AUTOSCALE)


def test_autoscale_spawns_as_jax(autoscaled):
    _, res, _, jres, reqs = autoscaled
    _same_cluster(res, jres)
    spawns = [e for e in res.autoscale_events if e["event"] == "spawn"]
    assert spawns == [dict(t=0.0, event="spawn", replica=1, pressure=2.0)]
    assert any(rep == 1 for rep in res.assignments.values())
    _check_solo(res, reqs)


def test_autoscale_drains_as_jax(autoscaled):
    _, res, _, jres, _ = autoscaled
    drains = [e for e in res.autoscale_events if e["event"] == "drain"]
    assert drains == [e for e in jres.autoscale_events if e["event"] == "drain"]
    assert drains == [dict(t=5.0, event="drain", replica=1, pressure=0.0)]
    assert res.assignments[4] == 0
    assert res.report()["autoscale_events"] == 2


# ============================================ chaos, faults, compute-vs-ship
def test_chaos_executor_cluster_equals_jax():
    """Each replica's prefetch executor runs its own chaos schedule over
    the shared fleet and store: the journals, events and tokens equal
    JAX's."""
    cfg, params, tcfg, tparams = _model()
    jfirst = JEngine(cfg, params, n_workers=4, group_size=2,
                     prefetch=JChaos(1, p_drop=0.3, p_defer=0.3))
    jsecond = JEngine(cfg, params, sched=jfirst.sched, store=jfirst.store,
                      prefetch=JChaos(101, p_drop=0.3, p_defer=0.3))
    first = ODMoEEngine(tcfg, tparams, n_workers=4, group_size=2, device="cpu",
                        prefetch=ChaosExecutor(1, p_drop=0.3, p_defer=0.3))
    second = ODMoEEngine(tcfg, tparams, sched=first.sched, store=first.store, device="cpu",
                         prefetch=ChaosExecutor(101, p_drop=0.3, p_defer=0.3))
    jreqs = _jrequests()
    jres = JRouter([JLoop(e, max_batch=2) for e in (jfirst, jsecond)]).run(jreqs)
    res = ClusterRouter([ServingLoop(e, max_batch=2) for e in (first, second)]).run(
        torch_requests(jreqs))
    _same_cluster(res, jres)
    for eng, jeng in ((first, jfirst), (second, jsecond)):
        assert eng.prefetch.executor.log == jeng.prefetch.executor.log
        assert _events(eng.slots) == _events(jeng.slots)
        jeng.close()
    _check_solo(res, torch_requests(jreqs))


def test_cluster_under_faults_equals_jax():
    """One fault script shared by both replicas' engines, as ``make_cluster``
    shares it: the replica that reaches a step first fires its events,
    killing the worker in the shared fleet state and failing its own slots
    only.  Tokens, events, slot stats and liveness equal JAX's."""
    script = [JFaultEvent(2, 1, "kill", moe_index=0), JFaultEvent(3, 3, "kill"),
              JFaultEvent(5, 1, "recover")]
    router, res, jrouter, jres, reqs = _run_both(
        dict(n_workers=4, group_size=2, faults=FaultInjector(torch_faults(script))),
        dict(n_workers=4, group_size=2, faults=JInjector(script)), replicas=2)
    _same_cluster(res, jres)
    for loop, jloop in zip(router.loops, jrouter.loops):
        eng, jeng = loop.engine, jloop.engine
        assert _events(eng.slots) == _events(jeng.slots)
        assert eng.slots.stats == jeng.slots.stats
        assert eng.slots.alive == jeng.slots.alive
    eng0, eng1 = (l.engine for l in router.loops)
    assert eng0.faults is eng1.faults and len(eng0.faults.applied) == 3
    assert eng0.sched.state.alive == [True, True, True, False]
    # the replica whose step fired a kill failed its own slots only
    assert sorted(e.slots.stats["failures"] for e in (eng0, eng1)) == \
        sorted(j.engine.slots.stats["failures"] for j in jrouter.loops)
    _check_solo(res, reqs)


def _throttled(gbps=0.05):
    return tuple(JProfile(w, link_gbps=gbps) for w in range(4))


def test_cluster_with_compute_vs_ship_equals_jax():
    jkw = dict(profiles=_throttled(), group_size=2, predictor="none", compute_vs_ship=True)
    router, res, _, jres, reqs = _run_both(dict(jkw, profiles=torch_profiles(_throttled())),
                                           jkw, replicas=2)
    _same_cluster(res, jres)
    hosted = sum(len(lr.hosted) for r in res.replicas for rec in r.trace.records
                 for lr in rec.layers)
    assert hosted > 0 and all(l.engine.slots.bytes_moved == 0 for l in router.loops)
    _check_solo(res, reqs)


def test_empty_cluster_run_equals_jax():
    cfg, params, tcfg, tparams = _model()
    jres = jmake_cluster(cfg, params, replicas=2,
                         engine_kw=dict(n_workers=4, group_size=2)).run([])
    res = make_cluster(tcfg, tparams, replicas=2,
                       engine_kw=dict(n_workers=4, group_size=2, device="cpu")).run([])
    assert res.outputs == {} == jres.outputs and res.assignments == {}
    _same_report(res.report(), jres.report())
    assert len(res.replicas) == 2


# ======================================================== validation
_BAD_ROUTERS = {      # a loop stands in as an object: validation comes first
    "no replicas": lambda m: m.ClusterRouter([]),
    "policy": lambda m: m.ClusterRouter([object()], policy="fastest"),
    "min_replicas": lambda m: m.ClusterRouter([object()], min_replicas=2),
    "loads": lambda m: m.ClusterRouter([object()], high_load=1.0, low_load=2.0),
    "replicas 0": lambda m: m.make_cluster(None, None, replicas=0),
}


@pytest.mark.parametrize("case", sorted(_BAD_ROUTERS))
def test_router_validation_matches_jax(case):
    import repro.serve as jserve
    import repro_torch.serve as tserve
    msgs = []
    for mod in (jserve, tserve):
        with pytest.raises(ValueError) as err:
            _BAD_ROUTERS[case](mod)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert ROUTING_POLICIES == ("round_robin", "least_loaded", "weighted")


def test_request_queue_add_and_loop_start_match_jax():
    """Duplicates are refused while pending, active or finished, with JAX's
    message; a started loop takes requests online; an empty start needs a
    cache length, to which ``max_seq_len`` then applies."""
    cfg, params, tcfg, tparams = _model()
    jreqs = _jrequests(n=3)
    reqs = torch_requests(jreqs)
    msgs = []
    for queue, rs in ((JQueue(jreqs[:1]), jreqs), (RequestQueue(reqs[:1]), reqs)):
        queue.add(rs[1])
        for dup in (rs[0], rs[1]):
            with pytest.raises(ValueError) as err:
                queue.add(dup)
            msgs.append(str(err.value))
    assert msgs[:2] == msgs[2:] and "already in the queue" in msgs[0]
    jloop = JLoop(JEngine(cfg, params, n_workers=4, group_size=2))
    loop = ServingLoop(ODMoEEngine(tcfg, tparams, n_workers=4, group_size=2, device="cpu"))
    for lp in (jloop, loop):
        with pytest.raises(ValueError, match="cache_len is required"):
            lp.start([])
    jloop.run(jreqs[:2])
    res = loop.run(reqs[:2])
    for lp, dup in ((jloop, jreqs[0]), (loop, reqs[0])):
        with pytest.raises(ValueError, match="already in the queue"):
            lp._queue.add(dup)                                   # finished
    assert set(loop.finished) == set(res.outputs) == {0, 1}
    clock = DecodeClock(tcfg, loop.engine.sched, RTX3090_EDGE)
    loop.start([], clock=clock, cache_len=40)
    assert loop.clock is clock and loop._cache_len == 40 and not loop.has_work()
    loop.add_request(reqs[2])
    assert loop.has_work()
    while loop.tick():
        pass
    np.testing.assert_array_equal(loop.finish().outputs[2],
                                  _solo(tuple(int(t) for t in reqs[2].prompt), N_TOK))
    capped = ServingLoop(ODMoEEngine(tcfg, tparams, n_workers=4, group_size=2, device="cpu"),
                         max_seq_len=32)
    capped.start([], cache_len=40)
    assert capped._cache_len == 32


# ===================================================== compute-vs-ship
@functools.lru_cache(maxsize=None)
def _cvs_run(pkg, cvs=True, gbps=0.05, transport=None, speculate=1, predictor="none",
             packed=False, mixed=False):
    cfg, params, tcfg, tparams = _model()
    jprof = (tuple(JProfile(w, link_gbps=(6.0 if w % 2 else 24.0)) for w in range(4))
             if mixed else _throttled(gbps))
    kw = dict(group_size=2, predictor=predictor, compute_vs_ship=cvs, transport=transport,
              speculate=speculate, packed_slots=packed)
    tokens = _tokens(cfg)
    if pkg == "jax":
        eng = JEngine(cfg, params, profiles=jprof, **kw)
        out, trace = eng.generate({"tokens": jnp.asarray(tokens)}, N_TOK)
    else:
        eng = ODMoEEngine(tcfg, tparams, profiles=torch_profiles(jprof), device="cpu", **kw)
        out, trace = eng.generate({"tokens": torch.tensor(tokens)}, N_TOK)
    ref = greedy_generate(tcfg, tparams, {"tokens": torch.tensor(tokens)}, N_TOK,
                          transport=transport).numpy()
    return eng, np.asarray(out), trace, ref, cfg, tcfg


def _same_cvs(*args, **kw):
    eng, out, trace, ref, _, _ = _cvs_run("torch", *args, **kw)
    jeng, jout, jtrace, _, _, _ = _cvs_run("jax", *args, **kw)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(out, ref)
    assert _layers(trace) == _layers(jtrace)
    assert _events(eng.slots) == _events(jeng.slots)
    assert eng.slots.stats == jeng.slots.stats
    assert eng.slots.bytes_moved == jeng.slots.bytes_moved
    hosted = sum(len(lr.hosted) for rec in trace.records for lr in rec.layers)
    reloads = sum(lr.reloads for rec in trace.records for lr in rec.layers)
    for rec in trace.records:
        for lr in rec.layers:
            assert not set(lr.hosted) & {e for e, _ in lr.assignments}
            assert set(lr.hosted) | {e for e, _ in lr.assignments} == \
                set(np.asarray(lr.true).reshape(-1).tolist())
    return eng, trace, hosted, reloads


def test_cvs_on_throttled_links_hosts_every_cold_expert_as_jax():
    eng, _, hosted, reloads = _same_cvs()
    assert eng.cvs_gbps == 42.0 and isinstance(eng.sched, FleetSchedule)
    assert hosted > 0 and reloads == 0 and eng.slots.bytes_moved == 0
    assert eng.slots.events == []


def test_cvs_on_fast_int8_links_ships_everything_as_jax():
    eng, _, hosted, reloads = _same_cvs(gbps=24.0, transport="int8")
    assert hosted == 0 and reloads > 0 and eng.slots.bytes_moved > 0


def test_cvs_speculative_waves_equal_jax():
    _, trace, hosted, _ = _same_cvs(speculate=2, predictor="sep")
    assert hosted > 0 and any(rec.spec_len == 2 for rec in trace.records)


def test_cvs_packed_slots_on_mixed_links_equal_jax():
    """int8 packed slots on 24 and 6 GB/s links: a miss whose candidate is a
    slow worker is hosted (full-width kernel on ``unpack_shard``'s weights),
    the rest ship into packed slots (the packed kernel): the same tokens."""
    eng, _, hosted, reloads = _same_cvs(transport="int8", predictor="sep", packed=True,
                                        mixed=True)
    assert hosted > 0 and eng.slots.stats["loads"] > 0


def test_cvs_replay_equals_jax_and_is_faster_than_shipping():
    """``simulate_odmoe`` on the hosted trace within ``REPLAY_TOL`` of JAX,
    and strictly faster than the shipped trace on the same links."""
    eng, _, trace, _, cfg, tcfg = _cvs_run("torch")
    jeng, _, jtrace, _, _, _ = _cvs_run("jax")
    ship, _, strace, _, _, _ = _cvs_run("torch", cvs=None)
    got = simulate_odmoe(tcfg, trace, eng.sched, RTX3090_EDGE, predictor="none")
    want = jsimulate(cfg, jtrace, jeng.sched, J_EDGE, predictor="none")
    np.testing.assert_allclose(got.per_token_s, want.per_token_s, rtol=REPLAY_TOL, atol=0)
    np.testing.assert_allclose(got.io_stall_s, want.io_stall_s, rtol=REPLAY_TOL, atol=0)
    shipped = simulate_odmoe(tcfg, strace, ship.sched, RTX3090_EDGE, predictor="none")
    assert sum(got.per_token_s) < sum(shipped.per_token_s)
    assert sum(lr.reloads for rec in strace.records for lr in rec.layers) > 0


def test_cvs_validation_matches_jax():
    cfg, params, tcfg, tparams = _model()
    for kw in (dict(compute_vs_ship=0.0), dict(compute_vs_ship=-1.0),
               dict(compute_vs_ship=True, wave_compute="loop")):
        msgs = []
        for build in (lambda: JEngine(cfg, params, **kw),
                      lambda: ODMoEEngine(tcfg, tparams, device="cpu", **kw)):
            with pytest.raises(ValueError) as err:
                build()
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1], kw


def test_decode_clock_shares_worker_free_and_prices_hosts_as_jax():
    cfg, params, tcfg, tparams = _model()
    shared = {}
    clock = DecodeClock(tcfg, FleetSchedule(4, 2), RTX3090_EDGE, worker_free=shared)
    jclock = JClock(cfg, JFleetSchedule(4, 2), J_EDGE)
    assert clock.worker_free is shared
    assert clock.t_exp_host == pytest.approx(jclock.t_exp_host, rel=TIME_TOL, abs=0)
    assert DecodeClock(tcfg, FleetSchedule(4, 2), RTX3090_EDGE).worker_free == {}


# ============================================================ launcher
def test_cli_cluster_mode_on_the_host(capsys):
    _, _, tcfg, tparams = _model()
    args = build_parser().parse_args(
        ["--requests", "3", "--replicas", "2", "--routing", "round_robin", "--placement",
         "gate-stats", "--compute-vs-ship", "--device", "cpu", "--arrival-rate", "0",
         "--prompt-len", "6", "--tokens", "4", "--workers", "4"])
    out = serve_cluster(tcfg, tparams, args)          # raises unless every request == solo
    text = capsys.readouterr().out
    assert "per-request tokens == solo reference (same transport policy): True" in text
    assert "placement: gate-stats plan" in text and "cluster: 2 replicas" in text
    res = out["result"]
    assert sorted(res.assignments.values()) == [0, 0, 1]
    engines = [l.engine for l in out["router"].loops]
    assert engines[0].sched.plan is not None and engines[1].sched is engines[0].sched
    assert all(e.cvs_gbps == 42.0 for e in engines)
    assert out["launches_serving"]["moe_ffn"] == 0        # the host runs the plain path
    _check_solo(res, out["requests"])
