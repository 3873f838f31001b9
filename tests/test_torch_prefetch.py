"""Async expert prefetch in the port (``repro_torch.core.prefetch``)
against the JAX package on bridged weights.

The invariant carries over from ``repro.core.prefetch``: the fetch is a
pure function of (layer, expert) and every scheduling decision commits on
the main thread, so under every executor and completion order the
engine's tokens, ``LoadEvent`` log, ``bytes_moved`` and slot stats are the
synchronous engine's, and its tokens ``greedy_generate``'s.  Against JAX,
under ``"sync"`` and under ``ChaosExecutor(seed)``, the port also equals
the JAX engine in ``residency_stats``, ``prefetch_report`` and the chaos
journal, with and without residency, on full-width and packed slots, on
the hybrid and through the serving loop.  Modelled times agree within
1e-12.  The threaded executor's prefetched/inline split depends on
timing and is not compared; its tokens, events and bytes are."""
import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import bridge, prompt, torch_cfg, torch_requests, torch_trace
from conftest import tiny_moe
from repro.core import RTX3090_EDGE as J_EDGE
from repro.core import ChaosExecutor as JChaos
from repro.core import ODMoEEngine as JEngine
from repro.core import PrefetchExecutor as JPrefetch
from repro.core import SyncExecutor as JSync
from repro.core import layers_within_horizon as jlayers_within_horizon
from repro.core import simulate_odmoe as jsimulate
from repro.models import init_params
from repro.serve import Request as JRequest
from repro.serve import ServingLoop as JLoop
from repro_torch.core import (RTX3090_EDGE, ChaosExecutor, ODMoEEngine, PrefetchExecutor,
                              SyncExecutor, ThreadedExecutor, layers_within_horizon,
                              make_executor, simulate_odmoe)
from repro_torch.models import greedy_generate
from repro_torch.serve import ServingLoop
from test_torch_hybrid import tiny_hybrid

N_TOK = 5
TIME_TOL = 1e-12
# (predictor, transport) of an engine scenario
SCENARIOS = {"sep": ("sep", None), "freq": ("freq", None), "sep-int8": ("sep", "int8")}
RESIDENCIES = (None, "lru", "gate")


@functools.lru_cache(maxsize=None)
def _model():
    cfg = tiny_moe()
    params = init_params(cfg, jax.random.PRNGKey(0))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 10), 0,
                                           cfg.vocab_size), np.int32)
    return cfg, params, torch_cfg(cfg), bridge(params), tokens


@functools.lru_cache(maxsize=None)
def _greedy(transport):
    _, _, tcfg, tparams, tokens = _model()
    return greedy_generate(tcfg, tparams, {"tokens": torch.from_numpy(tokens)}, N_TOK,
                           transport=transport).numpy()


def _events(slots, requests=False):
    return tuple((e.token, e.layer, e.expert, e.worker, e.predicted, e.bytes, e.scheme)
                 + ((tuple(e.requests),) if requests else ()) for e in slots.events)


def _snapshot(eng, toks, trace):
    return dict(tokens=np.asarray(toks), events=_events(eng.slots),
                bytes=eng.slots.bytes_moved,
                stats={k: eng.slots.stats[k] for k in ("loads", "predicted_loads", "reloads",
                                                       "hits", "evictions")},
                rstats=dict(eng.slots.residency_stats), report=eng.prefetch_report(),
                trace=trace)


def _port_run(scenario, residency, executor, model=_model, packed=False, horizon=0):
    """One port engine decode; ``scenario`` is a ``SCENARIOS`` key or a
    (predictor, transport) pair."""
    _, _, tcfg, tparams, tokens = model()
    predictor, transport = SCENARIOS.get(scenario, scenario)
    eng = ODMoEEngine(tcfg, tparams, n_workers=8, predictor=predictor, transport=transport,
                      residency=residency, prefetch=executor, packed_slots=packed,
                      peek_horizon=horizon, device="cpu")
    try:
        toks, trace = eng.generate({"tokens": torch.from_numpy(tokens)}, N_TOK)
    finally:
        eng.close()
    return _snapshot(eng, toks.numpy(), trace)


def _jax_run(scenario, residency, executor, model=_model, packed=False, horizon=0):
    cfg, params, _, _, tokens = model()
    predictor, transport = SCENARIOS.get(scenario, scenario)
    eng = JEngine(cfg, params, n_workers=8, predictor=predictor, transport=transport,
                  residency=residency, prefetch=executor, packed_slots=packed,
                  peek_horizon=horizon)
    try:
        toks, trace = eng.generate({"tokens": jnp.asarray(tokens)}, N_TOK)
    finally:
        eng.close()
    return _snapshot(eng, toks, trace)


@functools.lru_cache(maxsize=None)
def _port_baseline(scenario, residency):
    return _port_run(scenario, residency, None)


def _same(a, b, why, report=True):
    np.testing.assert_array_equal(a["tokens"], b["tokens"], err_msg=why)
    assert a["events"] == b["events"], why
    assert a["bytes"] == b["bytes"], why
    assert a["stats"] == b["stats"], why
    assert a["rstats"] == b["rstats"], why
    if report:
        assert a["report"] == b["report"], why


def _records(trace):
    return [(lr.layer, None if lr.predicted is None else np.asarray(lr.predicted).tolist(),
             np.asarray(lr.true).tolist(), lr.correct, lr.reloads, list(lr.assignments),
             [list(w) for w in lr.waves], tuple(lr.touched), lr.shipped, lr.rehits)
            for rec in trace.records for lr in rec.layers]


def _chaos_params(seed):
    rng = random.Random(seed)
    return dict(p_run_ahead=rng.uniform(0.0, 1.0), p_drop=rng.uniform(0.0, 0.5),
                p_defer=rng.uniform(0.0, 0.5))


def _scenario(seed):
    """Everything about a chaos case derives from its seed."""
    rng = random.Random(seed + 7919)
    return rng.choice(sorted(SCENARIOS)), rng.choice(RESIDENCIES)


# ---------------------------------------------------------------- engine
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("residency", RESIDENCIES)
def test_sync_executor_equals_jax_and_the_synchronous_engine(scenario, residency):
    why = f"sync scenario={scenario} residency={residency}"
    port = _port_run(scenario, residency, "sync")
    jax_ = _jax_run(scenario, residency, "sync")
    _same(port, jax_, why)
    assert _records(port["trace"]) == _records(jax_["trace"]), why
    _same(port, _port_baseline(scenario, residency), why, report=False)
    np.testing.assert_array_equal(port["tokens"], _greedy(SCENARIOS[scenario][1]))


@pytest.mark.parametrize("seed", range(4))
def test_chaos_schedule_equals_jax(seed):
    """The same seed drives the same adversarial schedule in both
    packages: equal journals, and equal tokens, events, bytes, slot and
    residency stats and prefetch reports."""
    scenario, residency = _scenario(seed)
    why = f"chaos seed={seed} scenario={scenario} residency={residency}"
    port_ex, jax_ex = ChaosExecutor(seed, **_chaos_params(seed)), JChaos(seed, **_chaos_params(seed))
    port = _port_run(scenario, residency, port_ex)
    jax_ = _jax_run(scenario, residency, jax_ex)
    assert port_ex.log == jax_ex.log, why
    assert len(port_ex.log) > 0, why
    _same(port, jax_, why)
    assert _records(port["trace"]) == _records(jax_["trace"]), why
    _same(port, _port_baseline(scenario, residency), why, report=False)
    np.testing.assert_array_equal(port["tokens"], _greedy(SCENARIOS[scenario][1]))


@pytest.mark.parametrize("seed", range(4, 16))
def test_chaos_schedule_equals_the_synchronous_engine(seed):
    """Port-only seeds: every schedule leaves tokens, events, bytes and
    stats as the synchronous engine made them."""
    scenario, residency = _scenario(seed)
    why = f"chaos seed={seed} scenario={scenario} residency={residency}"
    port = _port_run(scenario, residency, ChaosExecutor(seed, **_chaos_params(seed)))
    _same(port, _port_baseline(scenario, residency), why, report=False)
    np.testing.assert_array_equal(port["tokens"], _greedy(SCENARIOS[scenario][1]))


def test_chaos_schedules_are_distinct():
    logs = set()
    for seed in range(6):
        scenario, residency = _scenario(seed)
        ex = ChaosExecutor(seed, **_chaos_params(seed))
        _port_run(scenario, residency, ex)
        logs.add(tuple(ex.log))
    assert len(logs) >= 5


@pytest.mark.parametrize("horizon", [1, 2])
@pytest.mark.parametrize("executor", ["sync", "chaos"])
def test_peek_horizon_engine_equals_jax(executor, horizon):
    """With a peek horizon, token start queues only the first layers and
    each MoE layer's bookkeeping queues the layers it brings into the
    window: the queue's submitted/stale accounting, the chaos journal,
    tokens, events and bytes equal the JAX engine's, and tokens, events
    and bytes equal the engine without prefetch."""
    why = f"peek_horizon={horizon} executor={executor}"
    seed = 3 + horizon
    if executor == "chaos":
        port_ex = ChaosExecutor(seed, **_chaos_params(seed))
        jax_ex = JChaos(seed, **_chaos_params(seed))
    else:
        port_ex, jax_ex = "sync", "sync"
    port = _port_run("sep", "lru", port_ex, horizon=horizon)
    jax_ = _jax_run("sep", "lru", jax_ex, horizon=horizon)
    if executor == "chaos":
        assert port_ex.log == jax_ex.log, why
        assert len(port_ex.log) > 0, why
    _same(port, jax_, why)
    assert _records(port["trace"]) == _records(jax_["trace"]), why
    assert port["report"]["prefetch_submitted"] > 0, why
    _same(port, _port_baseline("sep", "lru"), why, report=False)
    np.testing.assert_array_equal(port["tokens"], _greedy(None))


@pytest.mark.parametrize("residency", RESIDENCIES)
def test_threaded_executor_equals_sync(residency):
    """Real threads: tokens, events and bytes equal the synchronous
    engine's; every demanded prediction was either prefetched or fetched
    inline."""
    why = f"thread residency={residency}"
    port = _port_run("sep", residency, "thread")
    _same(port, _port_baseline("sep", residency), why, report=False)
    rep = port["report"]
    assert rep["executor"] == "thread"
    assert rep["prefetch_submitted"] > 0
    assert rep["prefetch_prefetched"] + rep["prefetch_inline"] > 0


@pytest.mark.parametrize("residency", ["lru", "gate"])
def test_modelled_times_on_shipped_records_equal_jax(residency):
    """``simulate_odmoe`` prices only the experts a residency-aware record
    shipped, within 1e-12 of the JAX package.  A slow host link makes the
    loads stall the replay, so what is priced shows in the time."""
    import dataclasses
    from repro.core import GroupSchedule as JSched
    from repro_torch.core import GroupSchedule
    cfg, _, tcfg, _, _ = _model()
    port = _port_run("freq", residency, ChaosExecutor(3))
    jax_ = _jax_run("freq", residency, JChaos(3))
    assert any(lr.rehits for rec in port["trace"].records for lr in rec.layers)
    slow, jslow = (dataclasses.replace(p, pcie_gbps=0.01) for p in (RTX3090_EDGE, J_EDGE))
    got = simulate_odmoe(tcfg, port["trace"], GroupSchedule(8, 2), slow, predictor="freq")
    want = jsimulate(cfg, jax_["trace"], JSched(8, 2), jslow, predictor="freq")
    np.testing.assert_allclose(got.per_token_s, want.per_token_s, rtol=TIME_TOL, atol=0)
    np.testing.assert_allclose(got.io_stall_s, want.io_stall_s, rtol=TIME_TOL, atol=0)
    # with nothing shipped and nothing reloaded the replay has no load to
    # wait for, in both packages; the same records without ``shipped`` are
    # priced as group-padded predicted loads
    import copy
    cut, jcut = copy.deepcopy(port["trace"]), copy.deepcopy(jax_["trace"])
    for tr in (cut, jcut):
        for lr in (lr for rec in tr.records for lr in rec.layers):
            lr.shipped, lr.reloads = (), 0
    got = simulate_odmoe(tcfg, cut, GroupSchedule(8, 2), slow, predictor="freq")
    want = jsimulate(cfg, jcut, JSched(8, 2), jslow, predictor="freq")
    np.testing.assert_allclose(got.per_token_s, want.per_token_s, rtol=TIME_TOL, atol=0)
    assert max(got.io_stall_s) == 0.0
    bare = simulate_odmoe(tcfg, torch_trace(jcut), GroupSchedule(8, 2), slow, predictor="freq")
    assert min(bare.io_stall_s) > 0.0


# ---------------------------------------------------------- packed slots
@functools.lru_cache(maxsize=None)
def _packed_model():
    """A 64-aligned expert width, so nf4 takes the tile-aligned layout."""
    cfg = tiny_moe(num_layers=3, d_expert=128)
    params = init_params(cfg, jax.random.PRNGKey(0))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 10), 0,
                                           cfg.vocab_size), np.int32)
    return cfg, params, torch_cfg(cfg), bridge(params), tokens


@pytest.mark.parametrize("scheme", ["int8", "nf4"])
def test_packed_slots_under_chaos_equal_jax_and_greedy(scheme):
    residency = "lru" if scheme == "int8" else "gate"
    why = f"packed chaos scheme={scheme} residency={residency}"
    port_ex = ChaosExecutor(2000, p_drop=0.3, p_defer=0.3)
    port = _port_run(("sep", scheme), residency, port_ex, _packed_model, packed=True)
    jax_ = _jax_run(("sep", scheme), residency, JChaos(2000, p_drop=0.3, p_defer=0.3),
                    _packed_model, packed=True)
    _same(port, jax_, why)
    full = _port_run(("sep", scheme), residency, None, _packed_model)
    assert port["events"] == full["events"] and port["bytes"] == full["bytes"], why
    _, _, tcfg, tparams, tokens = _packed_model()
    np.testing.assert_array_equal(
        port["tokens"], greedy_generate(tcfg, tparams, {"tokens": torch.from_numpy(tokens)},
                                        N_TOK, transport=scheme).numpy())


# --------------------------------------------------------------- hybrid
@functools.lru_cache(maxsize=None)
def _hybrid_model():
    cfg = tiny_hybrid()
    params = init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params, torch_cfg(cfg), bridge(params), prompt(cfg, 1, 21)


def test_hybrid_under_chaos_and_residency_equals_jax_and_greedy():
    """Mamba, attention and MoE layers: the chaos schedule, tokens, events
    and counters equal the JAX engine's, the tokens ``greedy_generate``'s."""
    port_ex, jax_ex = ChaosExecutor(11, p_drop=0.3, p_defer=0.3), JChaos(11, p_drop=0.3,
                                                                         p_defer=0.3)
    port = _port_run("sep", "lru", port_ex, _hybrid_model)
    jax_ = _jax_run("sep", "lru", jax_ex, _hybrid_model)
    assert port_ex.log == jax_ex.log
    _same(port, jax_, "hybrid chaos lru")
    _, _, tcfg, tparams, tokens = _hybrid_model()
    np.testing.assert_array_equal(
        port["tokens"], greedy_generate(tcfg, tparams, {"tokens": torch.from_numpy(tokens)},
                                        N_TOK).numpy())


# ------------------------------------------------------------- serving
def _requests():
    return [JRequest(rid=i, prompt=list(range(1, 7 + i)), max_new_tokens=4,
                     arrival_s=0.01 * i) for i in range(4)]


@pytest.mark.parametrize("seed", [0, 1])
def test_served_burst_under_chaos_equals_jax_and_solo(seed):
    cfg, params, tcfg, tparams, _ = _model()
    residency = ("lru", "gate")[seed]
    jeng = JEngine(cfg, params, n_workers=8, residency=residency,
                   prefetch=JChaos(seed, p_drop=0.3, p_defer=0.3))
    try:
        jres = JLoop(jeng, max_batch=3, profile=J_EDGE).run(_requests())
    finally:
        jeng.close()
    eng = ODMoEEngine(tcfg, tparams, n_workers=8, residency=residency,
                      prefetch=ChaosExecutor(seed, p_drop=0.3, p_defer=0.3), device="cpu")
    res = ServingLoop(eng, max_batch=3, profile=RTX3090_EDGE).run(torch_requests(_requests()))
    why = f"serving chaos seed={seed} residency={residency}"
    assert sorted(res.outputs) == sorted(jres.outputs), why
    for r in _requests():
        np.testing.assert_array_equal(res.outputs[r.rid], np.asarray(jres.outputs[r.rid]))
        solo = greedy_generate(tcfg, tparams, {"tokens": torch.tensor([r.prompt])},
                               r.max_new_tokens)[0].numpy()
        np.testing.assert_array_equal(res.outputs[r.rid], solo, err_msg=why)
    assert _events(eng.slots, requests=True) == _events(jeng.slots, requests=True), why
    assert eng.slots.bytes_moved == jeng.slots.bytes_moved, why
    assert res.prefetch_stats == jres.prefetch_stats, why
    assert res.prefetch_stats["executor"] == "chaos"
    np.testing.assert_allclose(res.timings.finish_s, jres.timings.finish_s, rtol=TIME_TOL,
                               atol=0)
    assert eng.prefetch.executor._pending == {} and eng.prefetch.executor._done == {}


def test_served_without_prefetch_reports_no_prefetch_stats():
    _, _, tcfg, tparams, _ = _model()
    eng = ODMoEEngine(tcfg, tparams, n_workers=8, device="cpu")
    res = ServingLoop(eng, max_batch=3).run(torch_requests(_requests()[:2]))
    assert res.prefetch_stats is None


# ----------------------------------------------------- executor level
class _StubStore:
    """Payload = (layer, expert): pins that executors deliver exactly the
    fetch result for the right key."""
    device = torch.device("cpu")

    def unpack_shard(self, layer, expert):
        return (layer, expert)


def _drive(executor, rng):
    """One random call sequence against an executor; the delivered map."""
    delivered = {}
    live = []
    for _ in range(30):
        op = rng.random()
        if op < 0.5 or not live:
            key = (rng.randint(0, 3), rng.randint(0, 7), rng.randint(0, 7))
            executor.submit(key, lambda k=key: ("payload", k))
            live.append(key)
        elif op < 0.85:
            demanded = [live.pop(rng.randrange(len(live)))
                        for _ in range(min(len(live), rng.randint(1, 3)))]
            for k, v in executor.collect(demanded).items():
                assert k in demanded
                delivered[k] = v
        else:
            executor.discard([live.pop(rng.randrange(len(live)))])
    return delivered


@pytest.mark.parametrize("seed", [0, 1, 2, 12345, 10 ** 9])
def test_chaos_journal_equals_jax_on_the_same_call_sequence(seed):
    port, jax_ = ChaosExecutor(seed), JChaos(seed)
    got = _drive(port, random.Random(seed + 1))
    want = _drive(jax_, random.Random(seed + 1))
    assert got == want
    assert port.log == jax_.log
    for k, v in got.items():
        assert v == ("payload", k)


@pytest.mark.parametrize("seed", range(6))
def test_prefetch_queue_accounting_equals_jax(seed):
    """Enqueue a token's predictions, join one layer, retire the rest:
    the same stats as the JAX queue, payloads from the store."""
    rng = random.Random(seed)
    pending = {li: np.asarray([[rng.randint(0, 7), rng.randint(0, 7)]]) for li in (1, 3, 5, 7)}
    demanded = sorted({int(e) for e in pending[3].reshape(-1)})
    pf = PrefetchExecutor(_StubStore(), SyncExecutor(), horizon=seed % 3)
    jpf = JPrefetch(type("S", (), {"unpack_shard": lambda self, l, e, d: (l, e)})(),
                    JSync(), horizon=seed % 3, physical=False)
    for q in (pf, jpf):
        q.enqueue(0, 0, pending)
    got = pf.collect(0, 3, demanded)
    jgot = jpf.collect(0, 3, demanded)
    assert sorted(got) == sorted(jgot)
    for e, payload in got.items():
        assert payload.data == (3, e) and payload.ready is None
    for q in (pf, jpf):
        q.finish_token(0)
    assert pf.stats == jpf.stats
    assert pf.stats["submitted"] == pf.stats["prefetched"] + pf.stats["stale"]
    assert not pf._enqueued


@pytest.mark.parametrize("cur,horizon", [(0, 0), (0, 2), (4, 1), (4, 0), (12, 3), (7, 6)])
def test_peek_horizon_window_equals_jax(cur, horizon):
    layers = [1, 3, 5, 7, 9, 11]
    assert layers_within_horizon(layers, cur, horizon) == \
        jlayers_within_horizon(layers, cur, horizon)


def test_threaded_executor_delivers_discards_and_restarts():
    ex = ThreadedExecutor(max_workers=2)
    keys = [(0, li, e) for li in range(3) for e in range(4)]
    for k in keys:
        ex.submit(k, lambda k=k: ("payload", k))
    assert ex.collect(keys[:6]) == {k: ("payload", k) for k in keys[:6]}
    assert ex.discard(keys[6:]) == 6
    assert ex.collect(keys[6:]) == {}
    ex.close()
    ex.submit(keys[0], lambda: "again")           # a closed executor starts anew
    assert ex.collect(keys[:1]) == {keys[0]: "again"}
    ex.close()


def test_a_failed_fetch_fails_the_run():
    """A fetch that raises is never retried: the collect that joins it
    raises, and one discarded while running fails the next collect."""
    def boom():
        raise RuntimeError("transfer failed")

    for make in (SyncExecutor, ThreadedExecutor, lambda: ChaosExecutor(0, p_drop=0.0,
                                                                       p_defer=0.0)):
        ex = make()
        ex.submit((0, 1, 2), boom)
        with pytest.raises(RuntimeError, match="transfer failed"):
            ex.collect([(0, 1, 2)])
        ex.close()
    import threading
    started, release = threading.Event(), threading.Event()

    def slow_boom():
        started.set()
        release.wait(10)
        raise RuntimeError("late failure")

    ex = ThreadedExecutor(max_workers=1)
    ex.submit((0, 0, 0), slow_boom)
    started.wait(10)
    assert ex.discard([(0, 0, 0)]) == 1
    release.set()
    with pytest.raises(RuntimeError, match="late failure"):
        ex.close()


def test_refusals_match_jax():
    cfg, params, tcfg, tparams, _ = _model()
    for kw in ({"prefetch": "sync"}, {"residency": "lru"}):
        with pytest.raises(ValueError):
            JEngine(cfg, params, wave_compute="loop", **kw)
        with pytest.raises(ValueError):
            ODMoEEngine(tcfg, tparams, wave_compute="loop", device="cpu", **kw)
    for bad in ({"prefetch": "eager"}, {"residency": "mru"}):
        with pytest.raises(ValueError):
            ODMoEEngine(tcfg, tparams, device="cpu", **bad)
    with pytest.raises(TypeError):
        make_executor(object())
    assert make_executor(None) is None
