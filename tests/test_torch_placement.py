"""The port's gate-statistics placement (``repro_torch.fleet.placement``,
``FleetSchedule(plan=...)`` and the engine's ``gate_stats=``) against the
JAX package on bridged ``tiny_moe`` weights.

Exact: recorder counts and rows, every plan, every schedule order under a
plan (with dead workers), tokens, ``LayerRecord``s and load events.
Within tolerance: gate mass (``MASS_TOL``: the same float64 sums, or the
sums of fp32 gates computed by two libraries) and ``expected_t_maxload``
(``TIME_TOL``).  Placement only moves where predicted loads land: every
engine under a plan, with any executor, residency or packed slots, equals
the port's own ``greedy_generate``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_bridge import bridge, torch_cfg, torch_profiles
from conftest import tiny_moe
from repro.core import ChaosExecutor as JChaos
from repro.core import ODMoEEngine as JEngine
from repro.fleet import FleetSchedule as JFleetSchedule
from repro.fleet import GateStatsRecorder as JRecorder
from repro.fleet import PlacementPlan as JPlan
from repro.fleet import WorkerProfile as JProfile
from repro.fleet import expected_t_maxload as jexpected_t_maxload
from repro.fleet import modulo_plan as jmodulo_plan
from repro.fleet import optimize_placement as joptimize_placement
from repro.fleet import uniform_plan as juniform_plan
from repro.models import init_params
from repro_torch.core import ChaosExecutor, ODMoEEngine
from repro_torch.fleet import (FleetSchedule, GateStatsRecorder, PlacementPlan, WorkerProfile,
                               expected_t_maxload, modulo_plan, optimize_placement,
                               uniform_plan)
from repro_torch.models import greedy_generate

TIME_TOL = 1e-12        # the same float64 arithmetic in the same order
MASS_TOL = 1e-6         # gate sums over fp32 gates that two libraries computed
N_TOK = 6


def _plan_fields(plan):
    return (plan.n_workers, plan.group_size, plan.orders, plan.expert_workers)


def _stats_fields(rec):
    return rec.counts, rec.rows, {m: sorted(c) for m, c in rec.mass.items()}


def _same_stats(rec, jrec, tol=TIME_TOL):
    assert _stats_fields(rec) == _stats_fields(jrec)
    assert rec.n_layers == jrec.n_layers
    for m in jrec.mass:
        for e in jrec.mass[m]:
            assert rec.mass[m][e] == pytest.approx(jrec.mass[m][e], rel=tol, abs=0)


def _observations(seed, n_moe=3, num_experts=8, skew=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(4):
        for m in range(n_moe):
            b = int(rng.integers(1, 6))
            if skew:
                t = np.where(rng.random((b, 2)) < 0.7, rng.integers(0, 2, (b, 2)),
                             rng.integers(0, num_experts, (b, 2)))
            else:
                t = rng.integers(0, num_experts, (b, 2))
            out.append((m, t.astype(np.int32), rng.normal(size=(b, 2)).astype(np.float32)))
    return out


def _recorders(seed, skew=False, gates=True):
    rec, jrec = GateStatsRecorder(), JRecorder()
    for m, t, g in _observations(seed, skew=skew):
        jrec.observe(m, t, g if gates else None)
        # the port takes torch tensors as well as arrays
        rec.observe(m, torch.from_numpy(t), torch.from_numpy(g) if gates else None)
    return rec, jrec


# ============================================================== recorder
@pytest.mark.parametrize("seed", range(3))
def test_recorder_and_merge_equal_jax(seed):
    """Counts and rows exactly, mass within ``TIME_TOL``, for torch and
    numpy inputs, with and without gates, and through ``merge`` in both
    orders and both groupings."""
    a, ja = _recorders(seed)
    b, jb = _recorders(seed + 10, gates=False)
    c, jc = _recorders(seed + 20, skew=True)
    for rec, jrec in ((a, ja), (b, jb), (c, jc)):
        _same_stats(rec, jrec)
    arr = GateStatsRecorder()
    for m, t, g in _observations(seed):
        arr.observe(m, t, g)
    _same_stats(arr, ja)
    for got, want in ((a.merge(b), ja.merge(jb)), (b.merge(a), jb.merge(ja)),
                      (a.merge(b).merge(c), ja.merge(jb).merge(jc)),
                      (a.merge(b.merge(c)), ja.merge(jb.merge(jc)))):
        _same_stats(got, want)
    ab, ba = a.merge(b), b.merge(a)
    assert ab.counts == ba.counts and ab.mass == ba.mass          # commutative, bit for bit
    for m in range(4):
        np.testing.assert_array_equal(a.freq(m, 8), ja.freq(m, 8))
    assert (GateStatsRecorder().freq(0, 8) == 1.0 / 8).all()


def test_recorder_widens_bf16_gates():
    rec = GateStatsRecorder()
    rec.observe(0, torch.tensor([[1, 2]]), torch.tensor([[0.5, -0.25]], dtype=torch.bfloat16))
    assert rec.mass == {0: {1: 0.5, 2: 0.25}} and rec.rows == {0: 1}


# ================================================================= plans
def _fleets():
    hetero = tuple(JProfile(w, link_gbps=(32.0 if w in (1, 5) else 16.0)) for w in range(8))
    return {"uniform": (8, 2, ()), "hetero": (8, 2, hetero),
            "two-fast": (2, 1, (JProfile(0, link_gbps=4.0), JProfile(1, link_gbps=64.0))),
            "four": (4, 2, ())}


def _sched_pair(name):
    n, g, jprof = _fleets()[name]
    return (FleetSchedule(n, g, profiles=torch_profiles(jprof) if jprof else ()),
            JFleetSchedule(n, g, profiles=jprof))


@pytest.mark.parametrize("fleet", sorted(_fleets()))
@pytest.mark.parametrize("skew", [False, True])
def test_plans_and_scores_equal_jax(fleet, skew):
    s, js = _sched_pair(fleet)
    rec, jrec = _recorders(4, skew=skew)
    for n_moe in (None, 2, 5):
        for sched, jsched in ((None, None), (s, js)):
            assert _plan_fields(uniform_plan(s.n_workers, s.group_size, n_moe, sched=sched)) == \
                _plan_fields(juniform_plan(js.n_workers, js.group_size, n_moe, sched=jsched))
    for expert_bytes in (1.0, 3.5e8):
        kw = dict(num_experts=8, expert_bytes=expert_bytes)
        plan = optimize_placement(rec, s, n_moe=3, **kw)
        jplan = joptimize_placement(jrec, js, n_moe=3, **kw)
        assert _plan_fields(plan) == _plan_fields(jplan)
        assert _plan_fields(optimize_placement(rec, s, **kw)) == \
            _plan_fields(joptimize_placement(jrec, js, **kw))
        mod = modulo_plan(s, num_experts=8, n_moe=3)
        jmod = jmodulo_plan(js, num_experts=8, n_moe=3)
        assert _plan_fields(mod) == _plan_fields(jmod)
        for p, jp in ((plan, jplan), (mod, jmod)):
            for n_moe in (None, 3):
                got = expected_t_maxload(p, rec, s, n_moe=n_moe, **kw)
                want = jexpected_t_maxload(jp, jrec, js, n_moe=n_moe, **kw)
                assert got == pytest.approx(want, rel=TIME_TOL, abs=0)
        if skew and fleet != "two-fast":
            # the optimizer's point: a lower modelled bound on skewed stats
            assert expected_t_maxload(plan, rec, s, n_moe=3, **kw) < \
                expected_t_maxload(mod, rec, s, n_moe=3, **kw)


def test_optimizer_prefers_fast_links_and_splits_the_hot_pair():
    rec = GateStatsRecorder()
    rec.observe(0, np.array([[0, 1]] * 50 + [[0, 2]] * 30 + [[3, 4]] * 2))
    s, _ = _sched_pair("two-fast")
    plan = optimize_placement(rec, s, num_experts=8, n_moe=1)
    assert plan.worker_of(0, 0) == 1 and plan.order_for(0)[0] == 1
    four = optimize_placement(rec, FleetSchedule(4, 2), num_experts=8, n_moe=1)
    assert four.worker_of(0, 0) != four.worker_of(0, 1)
    assert plan.worker_of(0, 99) is None and uniform_plan(4, 2).worker_of(0, 0) is None


_BAD_PLANS = {
    "no orders": lambda m: m.PlacementPlan(4, 2, ()),
    "not a permutation": lambda m: m.PlacementPlan(4, 2, ((0, 1, 2, 2),)),
    "row count": lambda m: m.PlacementPlan(4, 2, ((0, 1, 2, 3),) * 2,
                                           expert_workers=((0,) * 8,)),
    "fleet size": lambda m: m.FleetSchedule(8, 2, plan=m.uniform_plan(4, 2)),
    "unscorable": lambda m: m.expected_t_maxload(m.uniform_plan(4, 2), m.GateStatsRecorder(),
                                                 m.FleetSchedule(4, 2), num_experts=8),
}


@pytest.mark.parametrize("case", sorted(_BAD_PLANS))
def test_plan_validation_matches_jax(case):
    import repro.fleet as jfleet
    import repro_torch.fleet as tfleet
    msgs = []
    for mod in (jfleet, tfleet):
        with pytest.raises(ValueError) as err:
            _BAD_PLANS[case](mod)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# ================================================= the schedule under a plan
@settings(deadline=None, max_examples=20)
@given(data=st.data(), n_groups=st.integers(1, 3), group_size=st.integers(1, 3),
       n_orders=st.integers(1, 3), affinity=st.booleans(),
       caps=st.lists(st.integers(1, 2), min_size=9, max_size=9),
       alive=st.lists(st.booleans(), min_size=9, max_size=9),
       experts=st.lists(st.integers(0, 9), min_size=0, max_size=10),
       reserved=st.lists(st.integers(0, 8), min_size=0, max_size=3))
def test_plan_schedule_methods_equal_jax(data, n_groups, group_size, n_orders, affinity, caps,
                                         alive, experts, reserved):
    """Every order of a ``FleetSchedule`` carrying a random plan equals
    JAX's, with dead workers filtered at query time."""
    n = n_groups * group_size
    orders = tuple(tuple(data.draw(st.permutations(range(n)))) for _ in range(n_orders))
    aff = (tuple(tuple(data.draw(st.lists(st.integers(0, n - 1), min_size=8, max_size=8)))
                 for _ in range(n_orders)) if affinity else None)
    jprof = tuple(JProfile(w, capacity=caps[w]) for w in range(n))
    s = FleetSchedule(n, group_size, profiles=torch_profiles(jprof),
                      plan=PlacementPlan(n, group_size, orders, aff))
    js = JFleetSchedule(n, group_size, profiles=jprof, plan=JPlan(n, group_size, orders, aff))
    for sched in (s, js):
        for w in range(n):
            if not alive[w]:
                sched.state.kill(w)
    res = {}
    for w in reserved:
        if w < n:
            res[w] = res.get(w, 0) + 1
    for m in range(n_orders + 2):
        assert s._plan_alive(m) == js._plan_alive(m)
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


def _same_hooks(planned, planless, n_moe=8):
    for m in range(n_moe):
        for name in ("active_workers_of_group", "spill_workers", "serving_order",
                     "load_targets"):
            assert getattr(planned, name)(m) == getattr(planless, name)(m), name
        assert planned.assign(m, [5, 1, 3, 3, 7]) == planless.assign(m, [5, 1, 3, 3, 7])
        assert planned.place(m, [5, 1, 3], {0: 1}) == planless.place(m, [5, 1, 3], {0: 1})


def test_uniform_plan_orders_like_the_planless_schedule():
    """On a uniform fleet, healthy and degraded, and on a fast-first
    heterogeneous one."""
    planless, planned = FleetSchedule(8, 2), FleetSchedule(8, 2, plan=uniform_plan(8, 2))
    _same_hooks(planned, planless)
    for sched in (planless, planned):
        sched.state.kill(1)
    _same_hooks(planned, planless)
    profiles = tuple(WorkerProfile(w, link_gbps=(32.0 if w in (1, 5) else 16.0))
                     for w in range(8))
    hetero = FleetSchedule(8, 2, profiles=profiles)
    _same_hooks(FleetSchedule(8, 2, profiles=profiles, plan=uniform_plan(8, 2, sched=hetero)),
                hetero)


def test_plan_affinity_falls_back_when_its_worker_is_gone():
    rec = GateStatsRecorder()
    rec.observe(0, np.array([[0, 1]] * 50 + [[0, 2]] * 30 + [[3, 4]] * 2))
    plan = optimize_placement(rec, FleetSchedule(4, 2), num_experts=8, n_moe=1)
    planned = FleetSchedule(4, 2, plan=plan)
    w0, w1 = plan.worker_of(0, 0), plan.worker_of(0, 1)
    assert dict(planned.assign(0, [0, 1])) == {0: w0, 1: w1}
    assert dict(planned.place(0, [0, 5]))[0] == w0
    assert dict(planned.place(0, [0], reserved={w0: 1})).get(0) != w0
    planned.state.kill(w0)
    a = dict(planned.assign(0, [0, 1]))
    assert a[0] != w0 and a[1] == w1


# ================================================================ engine
@functools.lru_cache(maxsize=None)
def _model(d_expert=96):
    cfg = tiny_moe(d_expert=d_expert)
    params = init_params(cfg, jax.random.PRNGKey(0))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 10), 0, cfg.vocab_size),
                        np.int32)
    return cfg, params, torch_cfg(cfg), bridge(params), tokens


@functools.lru_cache(maxsize=None)
def _greedy(transport=None, d_expert=96):
    _, _, tcfg, tparams, tokens = _model(d_expert)
    return greedy_generate(tcfg, tparams, {"tokens": torch.tensor(tokens)}, N_TOK,
                           transport=transport).numpy()


@functools.lru_cache(maxsize=None)
def _calibrated(d_expert=96):
    """Gate statistics of one decode without a predictor, in both packages,
    and the plans optimized on them for 4 workers in groups of 2."""
    cfg, params, tcfg, tparams, tokens = _model(d_expert)
    jrec, rec = JRecorder(), GateStatsRecorder()
    jeng = JEngine(cfg, params, n_workers=4, group_size=2, predictor="none", gate_stats=jrec)
    jout, jtrace = jeng.generate({"tokens": jnp.asarray(tokens)}, N_TOK)
    eng = ODMoEEngine(tcfg, tparams, n_workers=4, group_size=2, predictor="none",
                      gate_stats=rec, device="cpu")
    out, trace = eng.generate({"tokens": torch.tensor(tokens)}, N_TOK)
    kw = dict(num_experts=cfg.num_experts, n_moe=rec.n_layers, expert_bytes=eng.store.expert_bytes)
    plan = optimize_placement(rec, FleetSchedule(4, 2), **kw)
    jplan = joptimize_placement(jrec, JFleetSchedule(4, 2), **kw)
    return dict(rec=rec, jrec=jrec, plan=plan, jplan=jplan, out=out.numpy(),
                jout=np.asarray(jout), trace=trace, kw=kw)


def _events(slots):
    return [(e.token, e.layer, e.expert, e.worker, e.predicted, e.bytes, e.scheme)
            for e in slots.events]


def _records(trace):
    return [(rec.index, rec.spec_len, rec.committed, lr.layer, lr.moe_index, lr.group,
             None if lr.predicted is None else np.asarray(lr.predicted).tolist(),
             np.asarray(lr.true).tolist(), lr.correct, lr.reloads, list(lr.assignments),
             [list(w) for w in lr.waves], tuple(lr.touched), lr.shipped, lr.rehits,
             tuple(lr.hosted))
            for rec in trace.records for lr in rec.layers]


def test_gate_stats_engine_equals_jax():
    """The engine's recorder: counts and rows exactly, mass within
    ``MASS_TOL``; a trace replayed through ``observe_trace`` gives the
    live counts; recording changes no token."""
    cal = _calibrated()
    np.testing.assert_array_equal(cal["out"], cal["jout"])
    np.testing.assert_array_equal(cal["out"], _greedy())
    _same_stats(cal["rec"], cal["jrec"], tol=MASS_TOL)
    assert cal["rec"].n_layers == 4
    assert all(rows == 2 * (N_TOK - 1) for rows in cal["rec"].rows.values())
    replay = GateStatsRecorder()
    replay.observe_trace(cal["trace"])
    assert replay.counts == cal["rec"].counts and replay.rows == cal["rec"].rows
    assert _plan_fields(cal["plan"]) == _plan_fields(cal["jplan"])
    mod = modulo_plan(FleetSchedule(4, 2), num_experts=8, n_moe=4)
    assert mod.expert_workers != cal["plan"].expert_workers


_PLAN_RUNS = {
    "sync": dict(predictor="sep"),
    "chaos": dict(predictor="sep", prefetch="chaos"),
    "lru": dict(predictor="sep", prefetch="sync", residency="lru"),
    "freq": dict(predictor="freq", prefetch="thread", residency="gate"),
    "packed-int8": dict(predictor="sep", transport="int8", packed_slots=True),
}


@pytest.mark.parametrize("run", sorted(_PLAN_RUNS))
def test_engine_on_an_optimized_plan_equals_jax_and_greedy(run):
    """A composed batch of two on 4 workers under the optimized plan:
    tokens, every ``LayerRecord`` and the load events equal JAX's (the
    threaded executor against JAX's synchronous one) and greedy; each
    predicted load whose planned worker was free lands on it."""
    kw = dict(_PLAN_RUNS[run])
    d_expert = 128 if kw.get("packed_slots") else 96      # packed tiles need 128
    cal = _calibrated(d_expert)
    cfg, params, tcfg, tparams, tokens = _model(d_expert)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("prefetch") == "chaos":
        jkw["prefetch"], tkw["prefetch"] = JChaos(5, p_drop=0.3, p_defer=0.3), \
            ChaosExecutor(5, p_drop=0.3, p_defer=0.3)
    elif kw.get("prefetch") == "thread":
        jkw["prefetch"] = "sync"
    jeng = JEngine(cfg, params, sched=JFleetSchedule(4, 2, plan=cal["jplan"]), **jkw)
    eng = ODMoEEngine(tcfg, tparams, sched=FleetSchedule(4, 2, plan=cal["plan"]),
                      device="cpu", **tkw)
    try:
        jout, jtrace = jeng.generate({"tokens": jnp.asarray(tokens)}, N_TOK)
        out, trace = eng.generate({"tokens": torch.tensor(tokens)}, N_TOK)
    finally:
        eng.close()
        jeng.close()
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(out.numpy(), _greedy(kw.get("transport"), d_expert))
    assert _records(trace) == _records(jtrace)
    assert _events(eng.slots) == _events(jeng.slots)
    assert eng.slots.stats == jeng.slots.stats
    assert eng.slots.bytes_moved == jeng.slots.bytes_moved
    if run == "chaos":
        assert tkw["prefetch"].log == jkw["prefetch"].log and tkw["prefetch"].log
    if eng.residency is not None:
        return      # a re-hit may hold the planned worker's slot
    plan, moe_of = cal["plan"], {li: i for i, li in enumerate(eng.moe_layers)}
    pinned = 0
    for rec in trace.records:
        step = [e for e in eng.slots.events if e.token == rec.index and e.predicted]
        for lr in rec.layers:
            taken = set()
            for e in (e for e in step if e.layer == lr.layer):
                want = plan.worker_of(moe_of[e.layer], e.expert)
                if want not in taken:
                    assert e.worker == want, (rec.index, e)
                    pinned += 1
                taken.add(e.worker)
    assert pinned > 0
