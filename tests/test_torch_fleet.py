"""The port's heterogeneous, fault-tolerant worker fleet
(``repro_torch.fleet``: profiles, ``FleetSchedule``, fault scripts, and
their hooks in the slots, the engine, the timing model and serving)
against the JAX package on bridged ``tiny_moe`` weights.

Exact: schedule orders, fault scripts, slot stats and events (with the
worker's profile), every ``LayerRecord``, tokens and ``faults.applied``.
Modelled times and ``degraded_report`` within ``TIME_TOL`` (the same
float64 arithmetic in the same order).  The fleet rule is degraded but
correct: under every fault script, executor, residency policy, packed
slots and speculation, tokens equal the port's own ``greedy_generate``
and the prefetching engines' load events equal the synchronous engine's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_bridge import (bridge, fault_fields, profile_fields, prompt, step_fields,
                           torch_cfg, torch_faults, torch_profiles, torch_requests, torch_trace)
from conftest import tiny_moe
from repro.configs import get_config as jget_config
from repro.core import RTX3090_EDGE as J_EDGE
from repro.core import ChaosExecutor as JChaos
from repro.core import DecodeClock as JClock
from repro.core import ExpertStore as JStore
from repro.core import GroupSchedule as JGroupSchedule
from repro.core import ODMoEEngine as JEngine
from repro.core import WorkerSlots as JSlots
from repro.core import resolve_residency as jresolve_residency
from repro.core import node_memory_report as jnode_memory_report
from repro.core import simulate_odmoe as jsimulate
from repro.core import synthetic_trace as jsynthetic_trace
from repro.fleet import FaultEvent as JFaultEvent
from repro.fleet import FaultInjector as JInjector
from repro.fleet import FleetSchedule as JFleetSchedule
from repro.fleet import FleetState as JFleetState
from repro.fleet import WorkerProfile as JProfile
from repro.fleet import outage as joutage
from repro.fleet import random_fault_script as jrandom_fault_script
from repro.models import init_params
from repro.serve import Request as JRequest
from repro.serve import ServingLoop as JLoop
from repro_torch.configs import get_config
from repro_torch.core import (RTX3090_EDGE, ChaosExecutor, DecodeClock, ExpertStore,
                              GroupSchedule, ODMoEEngine, WorkerSlots, node_memory_report,
                              resolve_residency, simulate_odmoe)
from repro_torch.fleet import (DEFAULT_LINK_GBPS, FaultEvent, FaultInjector, FleetSchedule,
                               FleetState, WorkerProfile, outage, random_fault_script,
                               uniform_profiles)
from repro_torch.models import greedy_generate
from repro_torch.serve import ServingLoop

N_TOK = 8
TIME_TOL = 1e-12


def _events(slots):
    return [(e.token, e.layer, e.expert, e.worker, e.predicted, e.bytes, e.scheme,
             tuple(e.requests), profile_fields(e.profile)) for e in slots.events]


def _records(trace):
    return [(rec.index, rec.spec_len, rec.committed, lr.layer, lr.moe_index, lr.group,
             None if lr.predicted is None else np.asarray(lr.predicted).tolist(),
             np.asarray(lr.true).tolist(), lr.correct, lr.reloads, list(lr.assignments),
             [list(w) for w in lr.waves], tuple(lr.touched), lr.shipped, lr.rehits)
            for rec in trace.records for lr in rec.layers]


def _same_engines(eng, jeng, trace, jtrace, why=""):
    assert _records(trace) == _records(jtrace), why
    assert _events(eng.slots) == _events(jeng.slots), why
    assert eng.slots.stats == jeng.slots.stats, why
    assert eng.slots.bytes_moved == jeng.slots.bytes_moved, why
    assert eng.slots.residency_stats == jeng.slots.residency_stats, why
    assert eng.slots.alive == jeng.slots.alive, why
    assert eng.slots.resident == jeng.slots.resident, why
    assert fault_fields(eng.faults.applied) == fault_fields(jeng.faults.applied), why
    assert eng.sched.state.alive == jeng.sched.state.alive, why
    assert eng.sched.state.link_scale == jeng.sched.state.link_scale, why


# ============================================================== schedule
_LINKS = st.sampled_from([None, 6.0, 12.0, 24.0, 32.0])
_SCALES = st.sampled_from([1.0, 1.0, 0.25, 0.5, 2.0])


@settings(deadline=None, max_examples=20)
@given(n_groups=st.integers(1, 4), group_size=st.integers(1, 3),
       links=st.lists(_LINKS, min_size=12, max_size=12),
       caps=st.lists(st.integers(1, 3), min_size=12, max_size=12),
       alive=st.lists(st.booleans(), min_size=12, max_size=12),
       scales=st.lists(_SCALES, min_size=12, max_size=12),
       experts=st.lists(st.integers(0, 15), min_size=0, max_size=14),
       reserved=st.lists(st.integers(0, 11), min_size=0, max_size=4))
def test_fleet_schedule_methods_equal_jax(n_groups, group_size, links, caps, alive, scales,
                                          experts, reserved):
    """Every method of the port's ``FleetSchedule`` equals JAX's over random
    profiles, liveness and throttles."""
    n = n_groups * group_size
    jprof = tuple(JProfile(w, links[w], caps[w]) for w in range(n))
    js, s = JFleetSchedule(n, group_size, profiles=jprof), \
        FleetSchedule(n, group_size, profiles=torch_profiles(jprof))
    for sched in (js, s):
        for w in range(n):
            if not alive[w]:
                sched.state.kill(w)
            if scales[w] != 1.0:
                sched.state.throttle(w, scales[w])
    res = {}
    for w in reserved:
        if w < n:
            res[w] = res.get(w, 0) + 1
    assert s.n_groups == js.n_groups and s.state.n_alive == js.state.n_alive
    for m in range(n_groups + 2):
        assert s.group_of(m) == js.group_of(m)
        assert s.active_workers_of_group(m) == js.active_workers_of_group(m)
        assert s.spill_workers(m) == js.spill_workers(m)
        assert s.serving_order(m) == js.serving_order(m)
        assert s.load_targets(m) == js.load_targets(m)
        assert s.place(m, experts, res) == js.place(m, experts, res)
        if js.load_targets(m):
            assert s.assign(m, experts) == js.assign(m, experts)
        else:
            for sched in (s, js):
                with pytest.raises(RuntimeError, match="no alive workers"):
                    sched.assign(m, experts)
    for w in range(n):
        assert s.alive(w) == js.alive(w)
        for default in (DEFAULT_LINK_GBPS, 16.0):
            assert s.link_gbps_of(w, default) == js.link_gbps_of(w, default)
            assert s.t_load_s(w, 3.5e8, default) == js.t_load_s(w, 3.5e8, default)
            assert s.io_bottlenecked_worker(w, 3.5e8, 2e-3, 1e-3, default) == \
                js.io_bottlenecked_worker(w, 3.5e8, 2e-3, 1e-3, default)
    assert s.t_maxload(2e-3, 1e-3) == js.t_maxload(2e-3, 1e-3)
    assert s.io_bottlenecked(0.1, 2e-3, 1e-3) == js.io_bottlenecked(0.1, 2e-3, 1e-3)


def test_uniform_fleet_orders_like_group_schedule():
    """A uniform all-alive fleet orders exactly like the base schedule, in
    both packages."""
    base, fleet, jbase = GroupSchedule(8, 2), FleetSchedule(8, 2), JGroupSchedule(8, 2)
    for m in range(base.n_groups + 1):
        for name in ("active_workers_of_group", "spill_workers", "serving_order",
                     "load_targets"):
            assert getattr(fleet, name)(m) == getattr(base, name)(m) == \
                getattr(jbase, name)(m), name
        assert fleet.place(m, [5, 2, 7], {1: 1}) == base.place(m, [5, 2, 7], {1: 1})
        assert fleet.assign(m, [5, 2, 7]) == JFleetSchedule(8, 2).assign(m, [5, 2, 7])
    assert fleet.t_maxload(1.0, 2.0) == base.t_maxload(1.0, 2.0)
    assert fleet.profiles == uniform_profiles(8)
    assert fleet == FleetSchedule(8, 2, state=FleetState.fresh(8))   # state not compared


def test_fleet_schedule_skips_dead_prefers_fast_and_expands_capacity():
    profiles = tuple(WorkerProfile(w, link_gbps=(32.0 if w in (1, 5) else 16.0))
                     for w in range(8))
    s = FleetSchedule(8, 2, profiles=profiles)
    assert s.active_workers_of_group(0) == [1, 0]
    assert s.spill_workers(0) == [2, 3, 5, 4, 6, 7]
    s.state.kill(1)
    assert s.serving_order(0) == [0, 2, 3, 5, 4, 6, 7]
    assert [w for _, w in s.assign(0, [9, 4, 7])] == [0, 2, 3]
    s.state.recover(1)
    assert s.active_workers_of_group(0) == [1, 0]
    caps = FleetSchedule(4, 2, profiles=(WorkerProfile(0, capacity=3), WorkerProfile(1),
                                         WorkerProfile(2, capacity=2), WorkerProfile(3)))
    assert caps.load_targets(0) == [0, 1, 2, 3, 0, 2, 0]


_BAD_SCHEDULES = {
    "too few profiles": lambda m: m.FleetSchedule(8, 2, profiles=m.uniform_profiles(4)),
    "out of order": lambda m: m.FleetSchedule(2, 2, profiles=(m.WorkerProfile(1),
                                                              m.WorkerProfile(0))),
    "capacity 0": lambda m: m.WorkerProfile(0, capacity=0),
    "negative link": lambda m: m.WorkerProfile(0, link_gbps=-1.0),
    "negative worker": lambda m: m.WorkerProfile(-1),
    "indivisible": lambda m: m.FleetSchedule(7, 2),
    "throttle 0": lambda m: m.FleetState.fresh(2).throttle(0, 0.0),
}


@pytest.mark.parametrize("case", sorted(_BAD_SCHEDULES))
def test_validation_errors_match_jax(case):
    import repro.fleet as jfleet
    import repro_torch.fleet as tfleet
    msgs = []
    for mod in (jfleet, tfleet):
        with pytest.raises(ValueError) as err:
            _BAD_SCHEDULES[case](mod)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_placement_plan_raises_naming_its_roadmap_item():
    """A plan sized for another fleet is refused, as in the JAX package."""
    from repro.fleet import FleetSchedule as JFleetSchedule, uniform_plan as juniform_plan
    from repro_torch.fleet import uniform_plan
    for sched, plan in ((JFleetSchedule, juniform_plan), (FleetSchedule, uniform_plan)):
        with pytest.raises(ValueError, match="plan sized for a different fleet"):
            sched(8, 2, plan=plan(6, 2))
        assert sched(8, 2, plan=plan(8, 2)).plan.n_workers == 8


# ================================================================ faults
@pytest.mark.parametrize("seed", range(20))
def test_random_fault_script_equals_jax(seed):
    """``random.Random(seed)`` is drawn in JAX's order: the same script."""
    for n_workers, n_steps, n_moe, max_kills in ((8, 5, 4, None), (6, 9, 2, 2), (3, 2, 0, None)):
        want = jrandom_fault_script(seed, n_workers, n_steps, n_moe, max_kills)
        got = random_fault_script(seed, n_workers, n_steps, n_moe, max_kills)
        assert fault_fields(got) == fault_fields(want)


def _script():
    return [(2, 0, "kill", 1.0, None), (2, 1, "kill", 1.0, 1), (4, 0, "recover", 1.0, None),
            (3, 2, "throttle", 0.5, None), (6, 3, "kill", 1.0, 0)]


def test_fault_injector_equals_jax():
    """``apply`` fires step-scoped events, ``apply_layer`` that layer's,
    ``apply_step_all`` everything due; each event fires once, in script
    order; ``reset`` rearms.  Same states and ``applied`` as JAX."""
    jinj = JInjector([JFaultEvent(s, w, k, factor=f, moe_index=m) for s, w, k, f, m in _script()])
    inj = FaultInjector(torch_faults(jinj.events))
    calls = [("apply", 1), ("apply", 2), ("apply_layer", 2, 0), ("apply_layer", 2, 1),
             ("apply", 5), ("apply", 9), ("apply_step_all", 9)]
    for injector, state in ((inj, FleetState.fresh(4)), (jinj, JFleetState.fresh(4))):
        seen = []
        for name, *args in calls:
            getattr(injector, name)(*args, state)
            seen.append((list(state.alive), list(state.link_scale),
                         fault_fields(injector.applied)))
        injector.seen = seen
        injector.reset()
        assert injector.applied == []
        injector.apply_step_all(9, state)
        injector.after_reset = fault_fields(injector.applied)
    assert inj.seen == jinj.seen
    assert inj.after_reset == jinj.after_reset
    assert inj.seen[1][0] == [False, True, True, True]      # step-scoped only
    assert [e[2] for e in inj.seen[-1][2]] == ["kill", "kill", "recover", "throttle", "kill"]


@pytest.mark.parametrize("case", ["kind", "throttle", "outage"])
def test_fault_validation_matches_jax(case):
    import repro.fleet as jfleet
    import repro_torch.fleet as tfleet
    call = {"kind": lambda m: m.FaultEvent(0, 0, "explode"),
            "throttle": lambda m: m.FaultEvent(0, 0, "throttle", factor=0.0),
            "outage": lambda m: m.outage(0, 5, 5)}[case]
    msgs = []
    for mod in (jfleet, tfleet):
        with pytest.raises(ValueError) as err:
            call(mod)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert fault_fields(outage(2, 3, 6, moe_index=1)) == fault_fields(joutage(2, 3, 6, 1))


# ================================================================= slots
@functools.lru_cache(maxsize=None)
def _model():
    cfg = tiny_moe(num_layers=4)
    params = init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params, torch_cfg(cfg), bridge(params), prompt(cfg, 1)


@functools.lru_cache(maxsize=None)
def _stores():
    cfg, params, tcfg, tparams, _ = _model()
    return ExpertStore(tcfg, tparams), JStore(cfg, params)


def _slot_pair(residency, profiles=None, n=4):
    store, jstore = _stores()
    jprof = profiles
    return (WorkerSlots(store, n, residency=resolve_residency(residency),
                        profiles=torch_profiles(jprof) if jprof else None),
            JSlots(jstore, n, physical=False, residency=jresolve_residency(residency),
                   profiles=jprof))


def _same_slots(s, js):
    assert s.stats == js.stats
    assert list(s.stats) == list(js.stats)
    assert s.residency_stats == js.residency_stats
    assert s.bytes_moved == js.bytes_moved
    assert _events(s) == _events(js)
    assert s.resident == js.resident
    assert s.alive == js.alive
    assert [s.resident_slot_bytes(w) for w in range(s.n_workers)] == \
        [js.resident_slot_bytes(w) for w in range(js.n_workers)]


@pytest.mark.parametrize("residency", [None, "lru"])
def test_worker_slots_script_equals_jax(residency):
    """A two-slot worker and three one-slot workers under a scripted load /
    second slot / overwrite / release / fail / load-onto-dead / recover
    sequence: stats (JAX's keys, in JAX's order), residency counters,
    events with their profiles and residents equal JAX's at every step."""
    jprof = (JProfile(0, 24.0, 2), JProfile(1, 12.0), JProfile(2), JProfile(3))
    s, js = _slot_pair(residency, jprof)
    li = s.store.moe_layers[0]
    script = [("load", 0, li, 0, 0, True), ("load", 0, li, 1, 0, True),
              ("load", 0, li, 1, 0, True), ("load", 0, li, 5, 1, False),
              ("release", 0), ("load", 1, li, 2, 0, False), ("release", 1),
              ("fail", 0), ("dead", 1, li, 3, 0), ("fail", 0), ("recover", 0),
              ("load", 2, li, 3, 0, False), ("load", 2, li + 1, 4, 0, True),
              ("evict", 0), ("evict", 0), ("fail", 1), ("recover", 1), ("recover", 1)]
    for op, *args in script:
        for slots in (s, js):
            if op == "dead":
                with pytest.raises(RuntimeError, match="dead worker"):
                    slots.load(*args, predicted=False)
            elif op == "load":
                slots.load(*args[:4], predicted=args[4])
            else:
                getattr(slots, op)(*args)
        _same_slots(s, js)
        for e in range(8):
            assert s.worker_with(li, e) == js.worker_with(li, e)
    assert s.stats["failures"] == 2 and s.stats["recoveries"] == 2
    assert s.stats["failure_drops"] == (3 if residency else 1)
    assert s.events[0].profile == WorkerProfile(0, 24.0, 2)


def test_worker_failure_clears_released_residents():
    """``tests/test_residency.py``'s failure case: a released resident dies
    with its worker, the policy forgets it, and the recovered worker
    really reloads it."""
    s, js = _slot_pair("lru", n=2)
    li = s.store.moe_layers[0]
    for slots in (s, js):
        slots.load(0, li, 3, 0, predicted=True)
        slots.release(0)
        slots.fail(0)
        assert slots.stats["failure_drops"] == 1
        assert slots.reactivate(li, 3) is None
        slots.recover(0)
        assert slots.load(1, li, 3, 0, predicted=True) is True
    assert s.residency._last == js.residency._last       # the dead copy was forgotten
    _same_slots(s, js)


def test_multi_slot_gather_selects_by_layer_and_expert():
    """A two-slot worker's wave reads the slot of the expert it serves,
    whichever slot that is; a dead worker's slot cannot be read."""
    store, _ = _stores()
    s = WorkerSlots(store, 2, profiles=(WorkerProfile(0, capacity=2), WorkerProfile(1)))
    li = store.moe_layers[0]
    s.load(0, li, 4, 0, predicted=True)
    s.load(0, li, 6, 0, predicted=True)
    s.load(0, li, 1, 1, predicted=True)
    for wave in ({6: 0, 1: 1}, {4: 0}):
        experts, stacked = s.gather_stack(li, wave)
        want = [store.unpack_shard(li, e) for e in experts]
        for name, t in stacked.items():
            assert torch.equal(t, torch.stack([w[name] for w in want]))
    with pytest.raises(RuntimeError, match="not resident"):
        s.slot(1, li, 4)
    s.fail(0)
    with pytest.raises(RuntimeError, match="dead"):
        s.slot(0, li, 4)
    assert s.device_bytes_per_worker() == 2 * store.expert_bytes


# ================================================================ engine
def _engines(jkw=None, script=None, **kw):
    """A JAX and a port engine with the same options and fault script."""
    cfg, params, tcfg, tparams, _ = _model()
    jkw = dict(jkw or {})
    tkw = dict(jkw)
    if "profiles" in jkw:
        tkw["profiles"] = torch_profiles(jkw["profiles"])
    if script is not None:
        jkw["faults"] = JInjector(script)
        tkw["faults"] = FaultInjector(torch_faults(script))
    return (JEngine(cfg, params, **jkw, **kw),
            ODMoEEngine(tcfg, tparams, device="cpu", **tkw, **kw))


@functools.lru_cache(maxsize=None)
def _greedy(transport=None):
    _, _, tcfg, tparams, toks = _model()
    return greedy_generate(tcfg, tparams, {"tokens": torch.from_numpy(toks)}, N_TOK,
                           transport=transport).numpy()


KILL = JFaultEvent(step=3, worker=1, kind="kill", moe_index=0)


@pytest.fixture(scope="module")
def chaos_kill():
    """JAX's mid-decode kill: worker 1 dies at step 3 after MoE layer 0's
    predicted loads (a stranded expert)."""
    jeng, eng = _engines(dict(n_workers=8, predictor="sep", shadow_scheme="fp16"),
                         script=[KILL])
    toks = _model()[4]
    jout, jtrace = jeng.generate({"tokens": jnp.asarray(toks)}, N_TOK)
    out, trace = eng.generate({"tokens": torch.from_numpy(toks)}, N_TOK)
    return jeng, eng, np.asarray(jout), out.numpy(), jtrace, trace


def test_chaos_kill_mid_decode_equals_jax_and_greedy(chaos_kill):
    jeng, eng, jout, out, jtrace, trace = chaos_kill
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(out, _greedy())
    _same_engines(eng, jeng, trace, jtrace)
    assert isinstance(eng.sched, FleetSchedule)
    assert not eng.sched.state.alive[1] and not eng.slots.alive[1]
    reloads = [e for e in eng.slots.events if e.token == 3 and not e.predicted]
    assert reloads and all(e.worker != 1 for e in reloads)
    w1 = [e for e in eng.slots.events if e.worker == 1 and e.token == 3]
    assert [(e.layer, e.predicted) for e in w1] == [(0, True)]
    assert all(e.worker != 1 for e in eng.slots.events if e.token > 3)
    assert eng.slots.stats["failures"] == 1 and eng.slots.stats["failure_drops"] == 1


def test_chaos_kill_replay_equals_jax(chaos_kill):
    """``simulate_odmoe(faults=)`` over the engine's own schedule: per-step
    times, stalls, alive workers and ``degraded_report`` within
    ``TIME_TOL`` of JAX, and the replay restores the fleet state."""
    _, _, _, _, jtrace, trace = chaos_kill
    cfg, _, tcfg, _, _ = _model()
    sched = FleetSchedule(8, 2)
    want = jsimulate(cfg, jtrace, JFleetSchedule(8, 2), J_EDGE, shadow_scheme="fp16",
                     faults=JInjector([KILL]))
    got = simulate_odmoe(tcfg, trace, sched, RTX3090_EDGE, shadow_scheme="fp16",
                         faults=FaultInjector(torch_faults([KILL])))
    np.testing.assert_allclose(got.per_token_s, want.per_token_s, rtol=TIME_TOL, atol=0)
    np.testing.assert_allclose(got.io_stall_s, want.io_stall_s, rtol=TIME_TOL, atol=0)
    assert got.alive_workers == want.alive_workers
    assert min(got.alive_workers) == 7 and got.alive_workers[0] == 8
    rep, jrep = got.degraded_report(8), want.degraded_report(8)
    assert rep.keys() == jrep.keys()
    for k in rep:
        assert rep[k] == pytest.approx(jrep[k], rel=TIME_TOL, abs=0), k
    assert rep["degraded_steps"] > 0 and rep["min_alive_workers"] == 7
    assert sched.state.alive == [True] * 8                # the replay leaks nothing


def test_heterogeneous_capacity_engine_equals_jax():
    """Skewed links and two-slot workers change scheduling only; the memory
    report counts every slot."""
    jprof = tuple(JProfile(w, link_gbps=(24.0 if w % 2 == 0 else 6.0),
                           capacity=(2 if w < 4 else 1)) for w in range(8))
    jeng, eng = _engines(dict(predictor="multigate", profiles=jprof))
    toks = _model()[4]
    jout, jtrace = jeng.generate({"tokens": jnp.asarray(toks)}, N_TOK)
    out, trace = eng.generate({"tokens": torch.from_numpy(toks)}, N_TOK)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(out.numpy(), _greedy())
    assert _records(trace) == _records(jtrace)
    assert _events(eng.slots) == _events(jeng.slots)
    assert eng.slots.stats == jeng.slots.stats
    assert all(r is None for r in eng.slots.resident)
    assert eng.memory_report() == jeng.memory_report()
    assert node_memory_report(eng) == jnode_memory_report(jeng)
    assert eng.memory_report()["per_worker_bytes"] == 2 * eng.store.expert_bytes
    assert any(e.worker < 4 for e in eng.slots.events)


def test_multislot_resident_waits_next_wave_no_reload():
    """An expert predicted into a two-slot worker's second slot computes in
    the next wave and is not reloaded while its worker is busy."""
    jprof = (JProfile(0, capacity=2), JProfile(1))
    jeng, eng = _engines(dict(predictor="none", group_size=2, profiles=jprof))
    cfg = _model()[0]
    pred, true = np.array([[0, 1, 2]]), np.array([[0, 2]])
    gates = np.array([[0.5, 0.5]], np.float32)
    jlr, jy = jeng._serve_and_compute(1, eng.moe_layers[0], 0, pred, true,
                                      jnp.ones((1, cfg.d_model), jnp.float32), gates)
    lr, y = eng._serve_and_compute(1, eng.moe_layers[0], 0, pred, true,
                                   torch.ones((1, cfg.d_model)), torch.from_numpy(gates))
    assert lr.reloads == jlr.reloads == 0
    assert lr.waves == jlr.waves == [[(0, 0)], [(2, 0)]]
    assert lr.assignments == jlr.assignments
    assert _events(eng.slots) == _events(jeng.slots)
    # fp32 sums in two orders: within 1e-5 of the output's largest magnitude
    jy = np.asarray(jy)
    np.testing.assert_allclose(y.numpy(), jy, rtol=0, atol=1e-5 * np.abs(jy).max())


def test_whole_fleet_dead_raises():
    for eng in _engines(dict(n_workers=2, group_size=2, predictor="none"),
                        script=[JFaultEvent(1, w, "kill") for w in range(2)]):
        toks = _model()[4]
        batch = {"tokens": (torch.from_numpy(toks) if isinstance(eng, ODMoEEngine)
                            else jnp.asarray(toks))}
        with pytest.raises(RuntimeError, match="no alive workers"):
            eng.generate(batch, 4)


def test_engine_fleet_options_validate():
    _, _, tcfg, tparams, _ = _model()
    with pytest.raises(ValueError, match="divisible"):
        ODMoEEngine(tcfg, tparams, device="cpu", profiles=uniform_profiles(7))
    sched = FleetSchedule(8, 2)
    with pytest.raises(ValueError, match="prebuilt sched"):
        ODMoEEngine(tcfg, tparams, device="cpu", sched=sched, profiles=uniform_profiles(8))
    eng = ODMoEEngine(tcfg, tparams, device="cpu", sched=sched, predictor="none")
    assert eng.sched is sched and eng.slots.n_workers == 8
    assert [p.capacity for p in eng.slots.profiles] == [1] * 8
    assert type(ODMoEEngine(tcfg, tparams, device="cpu", predictor="none").sched) \
        is GroupSchedule


# ============================================ executors, packed, spec
N_TOK_CHAOS = 5
SCRIPTS = {
    "outage": lambda: joutage(1, 2) + joutage(5, 3, 5),
    "storm": lambda: jrandom_fault_script(123, 8, N_TOK_CHAOS, 4),
    "midwave": lambda: [JFaultEvent(2, 0, "kill", moe_index=1),
                        JFaultEvent(3, 2, "kill", moe_index=3),
                        JFaultEvent(4, 0, "recover")],
}


@functools.lru_cache(maxsize=None)
def _batch_model(d_expert=96):
    cfg = tiny_moe(d_expert=d_expert)
    params = init_params(cfg, jax.random.PRNGKey(0))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 10), 0,
                                           cfg.vocab_size), np.int32)
    return cfg, params, torch_cfg(cfg), bridge(params), tokens


def _chaos_run(pkg, script, executor, residency=None, predictor="freq", transport=None,
               packed=False, speculate=1, d_expert=96):
    cfg, params, tcfg, tparams, tokens = _batch_model(d_expert)
    kw = dict(n_workers=8, predictor=predictor, transport=transport, prefetch=executor,
              residency=residency, packed_slots=packed, speculate=speculate)
    if pkg == "jax":
        eng = JEngine(cfg, params, faults=JInjector(SCRIPTS[script]()), **kw)
        batch = {"tokens": jnp.asarray(tokens)}
    else:
        eng = ODMoEEngine(tcfg, tparams, device="cpu",
                          faults=FaultInjector(torch_faults(SCRIPTS[script]())), **kw)
        batch = {"tokens": torch.tensor(tokens)}
    try:
        toks, trace = eng.generate(batch, N_TOK_CHAOS)
    finally:
        eng.close()
    return eng, np.asarray(toks), trace


@functools.lru_cache(maxsize=None)
def _chaos_baseline(script, residency=None):
    return _chaos_run("torch", script, None, residency)


@functools.lru_cache(maxsize=None)
def _batch_greedy(transport=None, d_expert=96):
    _, _, tcfg, tparams, tokens = _batch_model(d_expert)
    return greedy_generate(tcfg, tparams, {"tokens": torch.tensor(tokens)}, N_TOK_CHAOS,
                           transport=transport).numpy()


def _same_run(a, b, why):
    (eng, toks, trace), (jeng, jtoks, jtrace) = a, b
    np.testing.assert_array_equal(toks, jtoks, err_msg=why)
    _same_engines(eng, jeng, trace, jtrace, why)


@pytest.mark.parametrize("script", ["outage", "storm"])
@pytest.mark.parametrize("executor", ["sync", "thread", "chaos"])
def test_executors_under_faults_equal_sync_engine_and_jax(script, executor):
    """``tests/test_prefetch_chaos.py``'s outage and storm scripts through
    each executor: tokens, records, events, stats and fired faults equal
    the port's engine without prefetch, JAX's engine under the same
    executor (the threaded one against JAX's sync), and greedy."""
    why = f"script={script} executor={executor}"
    residency = "lru" if executor == "thread" else None
    if executor == "chaos":
        tex, jex = ChaosExecutor(7, p_drop=0.3, p_defer=0.3), JChaos(7, p_drop=0.3, p_defer=0.3)
    else:
        tex, jex = executor, "sync"
    port = _chaos_run("torch", script, tex, residency)
    base = _chaos_baseline(script, residency)
    np.testing.assert_array_equal(port[1], base[1], err_msg=why)
    assert _records(port[2]) == _records(base[2]), why
    assert _events(port[0].slots) == _events(base[0].slots), why
    assert port[0].slots.stats == base[0].slots.stats, why
    _same_run(port, _chaos_run("jax", script, jex, residency), why)
    if executor == "chaos":
        assert tex.log == jex.log and tex.log, why
    np.testing.assert_array_equal(port[1], _batch_greedy(), err_msg=why)
    assert port[0].slots.stats["failures"] == \
        sum(e.kind == "kill" for e in port[0].faults.applied) > 0, why


def test_packed_int8_slots_under_faults_equal_jax_and_greedy():
    why = "packed int8 midwave"
    port = _chaos_run("torch", "midwave", "sync", "lru", predictor="sep", transport="int8",
                      packed=True, d_expert=128)
    _same_run(port, _chaos_run("jax", "midwave", "sync", "lru", predictor="sep",
                               transport="int8", packed=True, d_expert=128), why)
    np.testing.assert_array_equal(port[1], _batch_greedy("int8", 128), err_msg=why)
    assert port[0].slots.stats["failure_drops"] >= 1
    full = _chaos_run("torch", "midwave", None, "lru", predictor="sep", transport="int8",
                      d_expert=128)
    assert _events(port[0].slots) == _events(full[0].slots), why


def test_speculative_waves_under_faults_equal_jax_and_greedy():
    why = "speculate=2 midwave"
    port = _chaos_run("torch", "midwave", None, predictor="sep", speculate=2)
    _same_run(port, _chaos_run("jax", "midwave", None, predictor="sep", speculate=2), why)
    np.testing.assert_array_equal(port[1], _batch_greedy(), err_msg=why)
    assert any(rec.spec_len == 2 for rec in port[2].records)
    assert port[0].slots.stats["failures"] == 2


# =============================================================== serving
@pytest.fixture(scope="module")
def served():
    """Serving through failures: JAX's outage script plus a mid-layer kill,
    both loops on the same requests."""
    cfg, params, tcfg, tparams, _ = _model()
    rng = np.random.default_rng(3)
    jreqs = [JRequest(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                 int(rng.integers(5, 12))).astype(np.int32),
                      max_new_tokens=int(rng.integers(3, 8)), arrival_s=a)
             for i, a in enumerate([0.0, 0.0, 0.0, 0.02])]
    script = joutage(2, 2, 6) + joutage(6, 3) + [JFaultEvent(4, 4, "kill", moe_index=1)]
    jeng = JEngine(cfg, params, n_workers=8, predictor="sep", shadow_scheme="fp16",
                   faults=JInjector(script))
    jres = JLoop(jeng, max_batch=3).run(jreqs)
    eng = ODMoEEngine(tcfg, tparams, n_workers=8, predictor="sep", shadow_scheme="fp16",
                      device="cpu", faults=FaultInjector(torch_faults(script)))
    res = ServingLoop(eng, max_batch=3).run(torch_requests(jreqs))
    return dict(jeng=jeng, jres=jres, eng=eng, res=res, reqs=torch_requests(jreqs),
                script=script)


def test_serving_through_failures_equals_jax_and_solo(served):
    res, jres, eng, jeng = served["res"], served["jres"], served["eng"], served["jeng"]
    _, _, tcfg, tparams, _ = _model()
    for r in served["reqs"]:
        np.testing.assert_array_equal(res.outputs[r.rid], np.asarray(jres.outputs[r.rid]))
        solo = greedy_generate(tcfg, tparams, {"tokens": torch.from_numpy(r.prompt)[None]},
                               r.max_new_tokens)[0].numpy()
        np.testing.assert_array_equal(res.outputs[r.rid], solo)
    assert [step_fields(s) for s in res.steps] == [step_fields(s) for s in jres.steps]
    assert _events(eng.slots) == _events(jeng.slots)
    assert eng.slots.stats == jeng.slots.stats
    assert fault_fields(eng.faults.applied) == fault_fields(jeng.faults.applied)
    state, inj = FleetState.fresh(8), FaultInjector(torch_faults(served["script"]))
    want = []
    for s in res.steps:                   # liveness after each step's faults
        inj.apply_step_all(s.step, state)
        want.append(state.n_alive)
    assert [s.alive_workers for s in res.steps] == want
    assert min(want) == 5 and want[-1] == 6
    assert eng.slots.events[0].profile == WorkerProfile(eng.slots.events[0].worker)


def test_serving_degraded_report_equals_jax(served):
    res, jres = served["res"], served["jres"]
    for t, j in zip(res.steps, jres.steps):
        for name in ("start_s", "duration_s", "stall_s"):
            assert abs(getattr(t, name) - getattr(j, name)) <= TIME_TOL
    rep, jrep = res.degraded_report(), jres.degraded_report()
    assert rep.keys() == jrep.keys()
    for k in rep:
        assert rep[k] == pytest.approx(jrep[k], rel=TIME_TOL, abs=0), k
    assert rep["degraded_steps"] >= 1 and rep["steps"] == len(res.steps)


# ================================================================ timing
def test_decode_clock_per_link_durations_equal_jax():
    cfg, jcfg = get_config("mixtral-8x7b"), jget_config("mixtral-8x7b")
    jprof = tuple(JProfile(w, link_gbps=(24.0 if w == 0 else 6.0 if w < 4 else None))
                  for w in range(8))
    js, s = JFleetSchedule(8, 2, profiles=jprof), FleetSchedule(8, 2,
                                                                 profiles=torch_profiles(jprof))
    jclock, clock = JClock(jcfg, js, J_EDGE), DecodeClock(cfg, s, RTX3090_EDGE)
    assert clock.t_load_for(0) == pytest.approx(clock.t_load, rel=TIME_TOL)
    assert clock.t_load_for(1) == pytest.approx(4 * clock.t_load, rel=TIME_TOL)
    for sched in (js, s):
        sched.state.throttle(0, 0.5)
        sched.state.kill(3)
    assert clock.t_load_for(0) == pytest.approx(2 * clock.t_load, rel=TIME_TOL)
    for w in range(8):
        for nbytes in (None, 1.5e8):
            assert clock.t_load_for(w, nbytes) == pytest.approx(jclock.t_load_for(w, nbytes),
                                                               rel=TIME_TOL, abs=0)
    assert clock.alive_workers() == jclock.alive_workers() == 7
    assert DecodeClock(cfg, GroupSchedule(8, 2), RTX3090_EDGE).t_load_for(5) == \
        RTX3090_EDGE.t_load(clock._expert_bytes)


@pytest.mark.parametrize("fleet", ["kills", "skew", "throttle"])
def test_faulted_replay_equals_jax_and_leaks_no_state(fleet):
    """JAX's full-size fleet timing cases (two outages, skewed links, a
    throttled fleet) on one synthetic routing trace: per-step times and
    alive workers within ``TIME_TOL``; the replay restores the schedule's
    state, so a second, healthy replay equals a fresh schedule's."""
    cfg, jcfg = get_config("mixtral-8x7b"), jget_config("mixtral-8x7b")
    jtrace = jsynthetic_trace(jcfg, 24, recall=0.97)
    trace = torch_trace(jtrace)
    jprof = (tuple(JProfile(w, link_gbps=(24.0 if w % 2 == 0 else 6.0)) for w in range(8))
             if fleet == "skew" else None)
    script = {"kills": joutage(0, 8) + joutage(4, 8, 16),
              "skew": [],
              "throttle": [JFaultEvent(1, w, "throttle", factor=0.25) for w in range(8)]}[fleet]
    js = JFleetSchedule(8, 2, profiles=jprof or ())
    s = FleetSchedule(8, 2, profiles=torch_profiles(jprof) if jprof else ())
    want = jsimulate(jcfg, jtrace, js, J_EDGE, faults=JInjector(script))
    got = simulate_odmoe(cfg, trace, s, RTX3090_EDGE, faults=FaultInjector(torch_faults(script)))
    np.testing.assert_allclose(got.per_token_s, want.per_token_s, rtol=TIME_TOL, atol=0)
    np.testing.assert_allclose(got.io_stall_s, want.io_stall_s, rtol=TIME_TOL, atol=0)
    assert got.alive_workers == want.alive_workers
    rep, jrep = got.degraded_report(8), want.degraded_report(8)
    for k in rep:
        assert rep[k] == pytest.approx(jrep[k], rel=TIME_TOL, abs=0), k
    healthy = simulate_odmoe(cfg, trace, FleetSchedule(8, 2), RTX3090_EDGE)
    assert got.tokens_per_s < healthy.tokens_per_s
    assert s.state.alive == [True] * 8 and s.state.link_scale == [1.0] * 8
    again = simulate_odmoe(cfg, trace, s, RTX3090_EDGE)
    fresh = simulate_odmoe(cfg, trace, FleetSchedule(8, 2, profiles=s.profiles), RTX3090_EDGE)
    assert again.per_token_s == fresh.per_token_s
    if fleet == "kills":
        assert min(got.alive_workers) == 6 and rep["degraded_steps"] == 24 - 7
