"""Opportunistic expert residency in the port (``WorkerSlots.release`` and
the ``LRUResidency`` / ``GateStatsResidency`` policies) against the JAX
package on bridged weights, and both policies against brute-force
references (the port of ``tests/test_residency.py``).

Residency may only remove loads: a re-hit appends no event and moves no
byte, an eviction frees exactly the slot bytes its load charged, and a
release without a policy is an eviction.  The worker-failure case of
``tests/test_residency.py`` is in ``tests/test_torch_fleet.py``, with the
rest of the fleet."""
import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import bridge, torch_cfg
from conftest import tiny_moe
from repro.core import ExpertStore as JStore
from repro.core import ODMoEEngine as JEngine
from repro.core import WorkerSlots as JSlots
from repro.core import resolve_residency as jresolve_residency
from repro.models import init_params
from repro_torch.core import (ExpertStore, GateStatsResidency, LRUResidency, ODMoEEngine,
                              WorkerSlots, resolve_residency)
from repro_torch.models import greedy_generate

N_TOK = 6


@functools.lru_cache(maxsize=None)
def _model():
    cfg = tiny_moe()
    params = init_params(cfg, jax.random.PRNGKey(0))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (1, 10), 0,
                                           cfg.vocab_size), np.int32)
    return cfg, params, torch_cfg(cfg), bridge(params), tokens


@functools.lru_cache(maxsize=None)
def _stores(transport=None):
    cfg, params, tcfg, tparams, _ = _model()
    return ExpertStore(tcfg, tparams, transport), JStore(cfg, params, transport)


def _slots(n, residency="lru", packed=False, transport=None):
    store, jstore = _stores(transport)
    return (WorkerSlots(store, n, packed_resident=packed, residency=resolve_residency(residency)),
            JSlots(jstore, n, physical=False, packed_resident=packed,
                   residency=jresolve_residency(residency)))


def _same_state(s, js):
    assert s.stats == {k: js.stats[k] for k in s.stats}
    assert s.residency_stats == js.residency_stats
    assert s.bytes_moved == js.bytes_moved
    assert [(e.token, e.layer, e.expert, e.worker, e.predicted, e.bytes)
            for e in s.events] == [(e.token, e.layer, e.expert, e.worker, e.predicted, e.bytes)
                                   for e in js.events]
    assert s.resident == js.resident
    assert [s.resident_slot_bytes(w) for w in range(s.n_workers)] == \
        [js.resident_slot_bytes(w) for w in range(js.n_workers)]


# -------------------------------------------------------- slot-level
def test_rehit_skips_reload():
    """A released resident re-hits: no event, zero bytes, the packed
    payload it saved recorded; the same counters as JAX."""
    s, js = _slots(2)
    li = s.store.moe_layers[0]
    for slots in (s, js):
        assert slots.load(0, li, 3, 0, predicted=True) is True
        slots.release(0)
        assert slots.is_released(0, li, 3)
        assert slots.load(1, li, 3, 0, predicted=True) is False      # re-hit
        assert not slots.is_released(0, li, 3)
    assert len(s.events) == 1 and s.stats["loads"] == 1
    assert s.residency_stats["rehits"] == 1
    assert s.residency_stats["rehit_bytes_saved"] == s.store.packed_bytes(li, 3)
    _same_state(s, js)


def test_reactivate_and_claim_find_released_residents():
    s, js = _slots(4)
    li = s.store.moe_layers[0]
    for slots in (s, js):
        slots.load(0, li, 5, 2, predicted=True)
        slots.load(0, li, 6, 3, predicted=True)
        slots.release(2)
        slots.release(3)
        assert slots.reactivate(li, 5) == 2
        assert slots.reactivate(li, 5) == 2                  # active: a plain claim
        assert slots.reactivate(li, 7) is None
        assert slots.claim_resident(li, 6, 3) is True
        assert slots.claim_resident(li, 6, 3) is False
    assert s.residency_stats["rehits"] == 2
    _same_state(s, js)


@pytest.mark.parametrize("packed,transport", [(False, None), (True, "int8")])
def test_eviction_frees_exactly_the_loaded_bytes(packed, transport):
    """Displacement and explicit eviction free exactly the slot bytes each
    load charged (full width, or packed in packed-resident mode)."""
    s, js = _slots(2, packed=packed, transport=transport)
    li = s.store.moe_layers[0]
    unit = s._resident_nbytes((li, 0))
    for slots in (s, js):
        slots.load(0, li, 0, 0, predicted=True)
        slots.load(0, li, 1, 1, predicted=True)
        assert slots.resident_slot_bytes(0) == unit
        slots.release(0)
        slots.release(1)
        slots.load(1, li, 4, 0, predicted=True)           # displaces the released resident
        assert slots.residency_stats["displaced"] == 1
        assert slots.residency_stats["evicted_bytes"] == unit
        slots.evict(0)
        slots.evict(1)
        assert slots.resident_slot_bytes(0) == 0
        assert slots.residency_stats["evicted_bytes"] == 3 * unit == slots.stats["loads"] * unit
    _same_state(s, js)


def test_an_active_resident_is_overwritten_without_the_policy():
    """A full worker whose resident is active (not released) evicts it as
    the cacheless engine does; only released residents are displaced."""
    s, js = _slots(1)
    li = s.store.moe_layers[0]
    for slots in (s, js):
        slots.load(0, li, 0, 0, predicted=True)
        slots.load(0, li, 1, 0, predicted=False)
        assert slots.residency_stats["displaced"] == 0 and slots.stats["evictions"] == 1
    _same_state(s, js)


def test_release_without_policy_degrades_to_evict():
    s, js = _slots(1, residency=None)
    li = s.store.moe_layers[0]
    for slots in (s, js):
        slots.load(0, li, 3, 0, predicted=True)
        slots.release(0)
        assert slots.stats["evictions"] == 1
        assert slots.worker_with(li, 3) is None
    assert s.residency_stats["released"] == 0
    _same_state(s, js)


@pytest.mark.parametrize("seed", range(4))
def test_random_slot_programs_equal_jax(seed):
    """Random load / release / evict / claim / gate sequences on both
    packages' slots: every counter, event and resident equal."""
    rng = random.Random(seed)
    residency = ("lru", "gate")[seed % 2]
    s, js = _slots(4, residency=residency)
    layers = s.store.moe_layers
    for step in range(60):
        op, w = rng.random(), rng.randrange(4)
        li, e = rng.choice(layers), rng.randrange(s.store.cfg.num_experts)
        predicted = rng.random() < 0.5
        for slots in (s, js):
            if op < 0.4:
                slots.load(step, li, e, w, predicted=predicted)
            elif op < 0.6:
                slots.release(w)
            elif op < 0.7:
                slots.evict(w)
            elif op < 0.85:
                slots.reactivate(li, e)
            else:
                true = np.asarray([[e, (e + 1) % 4]])
                gates = np.asarray([[0.75, 0.25]], np.float32)
                slots.observe_gates(li, true, gates)
        _same_state(s, js)


def test_resolve_residency():
    assert resolve_residency(None) is None
    assert isinstance(resolve_residency("lru"), LRUResidency)
    assert isinstance(resolve_residency("gate"), GateStatsResidency)
    pol = LRUResidency()
    assert resolve_residency(pol) is pol
    with pytest.raises(ValueError):
        resolve_residency("mru")


# ------------------------------------------- brute-force policy parity
class _BruteLRU:
    """Independent reference: victim = smallest (last use, key)."""

    def __init__(self):
        self.t = 0
        self.last = {}

    def use(self, key):
        self.last[key] = self.t
        self.t += 1

    def credit(self, key, mass):
        self.use(key)

    def victim(self, candidates):
        return min(candidates, key=lambda k: (self.last.get(k, -1), k))

    def forget(self, key):
        self.last.pop(key, None)


class _BruteGate(_BruteLRU):
    """Independent reference: victim = smallest (total gate mass, last use,
    key); mass survives displacement."""

    def __init__(self):
        super().__init__()
        self.mass = {}

    def credit(self, key, mass):
        self.mass[key] = self.mass.get(key, 0.0) + mass
        self.use(key)

    def victim(self, candidates):
        return min(candidates, key=lambda k: (self.mass.get(k, 0.0), self.last.get(k, -1), k))


@pytest.mark.parametrize("seed", range(12))
def test_policies_agree_with_brute_force(seed):
    """Random access traces: every victim choice matches the reference."""
    rng = random.Random(seed)
    pairs = [(LRUResidency(), _BruteLRU()), (GateStatsResidency(), _BruteGate())]
    keys = [(li, e) for li in (1, 3) for e in range(6)]
    resident = []
    for _ in range(60):
        op = rng.random()
        if op < 0.45 or not resident:
            key = rng.choice(keys)
            if key not in resident:
                resident.append(key)
            for pol, ref in pairs:
                pol.note(key)
                ref.use(key)
        elif op < 0.75:
            key, m = rng.choice(resident), rng.uniform(0.0, 1.0)
            for pol, ref in pairs:
                pol.credit(key, m)
                ref.credit(key, m)
        else:
            cands = rng.sample(resident, rng.randint(1, len(resident)))
            choices = []
            for pol, ref in pairs:
                got, want = pol.victim(cands), ref.victim(cands)
                assert got == want, f"seed={seed}: {type(pol).__name__}"
                choices.append(got)
            if rng.random() < 0.7:                 # actually displace
                resident.remove(choices[0])
                for pol, ref in pairs:
                    pol.forget(choices[0])
                    ref.forget(choices[0])


def test_policies_agree_with_brute_force_on_engine_trace():
    """A recorded engine trace (realized routing and gates) replayed
    through both policies and their references."""
    _, _, tcfg, tparams, tokens = _model()
    eng = ODMoEEngine(tcfg, tparams, n_workers=8, device="cpu")
    _, trace = eng.generate({"tokens": torch.from_numpy(tokens)}, N_TOK)
    accesses = [(lr.layer, int(e), abs(float(lr.gates[b, j])))
                for rec in trace.records for lr in rec.layers
                for b in range(lr.true.shape[0]) for j, e in enumerate(lr.true[b])]
    for pol, ref in ((LRUResidency(), _BruteLRU()), (GateStatsResidency(), _BruteGate())):
        resident = []
        for i, (li, e, g) in enumerate(accesses):
            key = (li, e)
            if key not in resident:
                resident.append(key)
            pol.credit(key, g)
            ref.credit(key, g)
            if i % 5 == 4 and len(resident) > 2:
                got, want = pol.victim(resident[-3:]), ref.victim(resident[-3:])
                assert got == want
                resident.remove(got)
                pol.forget(got)
                ref.forget(got)


# ------------------------------------------------------- engine-level
def _engines(residency, predictor="freq"):
    cfg, params, tcfg, tparams, tokens = _model()
    eng = ODMoEEngine(tcfg, tparams, n_workers=8, predictor=predictor, residency=residency,
                      device="cpu")
    toks, trace = eng.generate({"tokens": torch.from_numpy(tokens)}, N_TOK)
    jeng = JEngine(cfg, params, n_workers=8, predictor=predictor, residency=residency)
    jtoks, jtrace = jeng.generate({"tokens": jnp.asarray(tokens)}, N_TOK)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    _same_state(eng.slots, jeng.slots)
    assert eng.prefetch_report() == jeng.prefetch_report()
    assert [(lr.shipped, lr.rehits) for r in trace.records for lr in r.layers] == \
        [(lr.shipped, lr.rehits) for r in jtrace.records for lr in r.layers]
    return toks.numpy(), eng, trace


@pytest.mark.parametrize("residency", ["lru", "gate"])
def test_engine_rehits_remove_exactly_their_loads(residency):
    """The freq predictor asks for its top experts every token, so
    residency turns repeats into re-hits; tokens stay greedy's and
    ``bytes_moved`` drops by exactly the re-hit savings.  Equal to JAX."""
    _, _, tcfg, tparams, tokens = _model()
    ref = greedy_generate(tcfg, tparams, {"tokens": torch.from_numpy(tokens)}, N_TOK).numpy()
    base_toks, base, _ = _engines(None)
    res_toks, res, trace = _engines(residency)
    np.testing.assert_array_equal(base_toks, ref)
    np.testing.assert_array_equal(res_toks, ref)
    rs = res.slots.residency_stats
    assert rs["rehits"] > 0
    assert base.slots.bytes_moved - res.slots.bytes_moved == rs["rehit_bytes_saved"]
    assert base.slots.stats["loads"] - res.slots.stats["loads"] == rs["rehits"]
    rep = res.prefetch_report()
    assert rep["residency"] == residency
    assert rep["rehit_rate"] == pytest.approx(rs["rehits"] / (rs["rehits"]
                                                             + res.slots.stats["loads"]))
    events = {(e.token, e.layer, e.expert) for e in res.slots.events if e.predicted}
    for rec in trace.records:
        for lr in rec.layers:
            assert all((rec.index, lr.layer, e) in events for e in lr.shipped)
            if lr.rehits:
                assert len(lr.shipped) < len(dict.fromkeys(lr.predicted.reshape(-1).tolist()))


def test_engine_residency_with_the_shadow_equals_jax():
    toks, eng, _ = _engines("gate", predictor="sep")
    assert eng.slots.residency_stats["released"] > 0
