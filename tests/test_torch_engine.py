"""The port's OD-MoE engine: bitwise equal to the port's own
``greedy_generate`` for every ported predictor, and equal to the JAX
engine on the same bridged weights — tokens, per-layer routing and
predictions, load events, bytes moved, stats and recall."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import bridge, prompt, torch_cfg
from conftest import tiny_moe
from repro.core import AlignmentPolicy as JAlign
from repro.core import ODMoEEngine as JEngine
from repro_torch.core import AlignmentPolicy, ODMoEEngine
from repro_torch.models import greedy_generate

N_TOK = 8
PREDICTORS = ["sep", "nextgate", "multigate", "freq", "random", "none"]


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_moe(num_layers=4)
    from repro.models import init_params
    params = init_params(cfg, jax.random.PRNGKey(0))
    toks = prompt(cfg, 1)
    return cfg, params, torch_cfg(cfg), bridge(params), toks


def _port_engine(setup, predictor, **kw):
    _, _, tcfg, tparams, toks = setup
    eng = ODMoEEngine(tcfg, tparams, n_workers=8, predictor=predictor,
                      device="cpu", **kw)
    out, trace = eng.generate({"tokens": torch.from_numpy(toks)}, N_TOK,
                              AlignmentPolicy(1, 1))
    return eng, out.numpy(), trace


@pytest.mark.parametrize("predictor", PREDICTORS)
def test_port_engine_bitwise_equals_port_greedy(setup, predictor):
    """Mispredictions and reloads never change a token: the engine's
    tokens equal the port's dense reference for every predictor."""
    _, _, tcfg, tparams, toks = setup
    ref = greedy_generate(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                          N_TOK).numpy()
    _, out, _ = _port_engine(setup, predictor)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("scheme", ["int8", "nf4"])
def test_port_engine_under_transport_equals_greedy(setup, scheme):
    _, _, tcfg, tparams, toks = setup
    ref = greedy_generate(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                          N_TOK, transport=scheme).numpy()
    _, out, _ = _port_engine(setup, "sep", transport=scheme)
    np.testing.assert_array_equal(out, ref)


def _records(trace):
    return [(lr.layer, lr.moe_index, lr.group,
             None if lr.predicted is None else np.asarray(lr.predicted).tolist(),
             np.asarray(lr.true).tolist(), lr.correct, lr.reloads,
             list(lr.assignments), [list(w) for w in lr.waves], tuple(lr.touched))
            for rec in trace.records for lr in rec.layers]


def _events(events):
    return [(e.token, e.layer, e.expert, e.worker, e.predicted, e.bytes, e.scheme)
            for e in events]


@pytest.mark.parametrize("predictor,transport", [
    ("sep", None), ("nextgate", None), ("multigate", None), ("freq", None),
    ("random", None), ("none", None), ("sep", "int8")])
def test_port_engine_matches_jax_engine(setup, predictor, transport):
    """Same weights, same prompt: the two engines agree on every host-side
    record.  Gate weights are floats and agree within fp32 tolerance
    (XLA and PyTorch sum in different orders)."""
    cfg, params, _, _, toks = setup
    jeng = JEngine(cfg, params, n_workers=8, predictor=predictor,
                   transport=transport)
    jout, jtrace = jeng.generate({"tokens": jnp.asarray(toks)}, N_TOK, JAlign(1, 1))
    eng, out, trace = _port_engine(setup, predictor, transport=transport)
    np.testing.assert_array_equal(out, np.asarray(jout))
    assert _records(trace) == _records(jtrace)
    assert _events(eng.slots.events) == _events(jeng.slots.events)
    assert eng.slots.bytes_moved == jeng.slots.bytes_moved
    assert eng.slots.stats == {k: jeng.slots.stats[k] for k in eng.slots.stats}
    assert all(v == 0 for k, v in jeng.slots.stats.items() if k not in eng.slots.stats)
    assert trace.recall() == jtrace.recall()
    assert trace.recall_per_token() == jtrace.recall_per_token()
    assert trace.reload_fraction() == jtrace.reload_fraction()
    for rec, jrec in zip(trace.records, jtrace.records):
        assert (rec.index, rec.aligned_token, rec.aligned_kv) == \
            (jrec.index, jrec.aligned_token, jrec.aligned_kv)
        for lr, jlr in zip(rec.layers, jrec.layers):
            np.testing.assert_allclose(lr.gates, np.asarray(jlr.gates),
                                       rtol=1e-5, atol=1e-6)


def test_engine_with_dense_layers_between_moe_layers():
    """``moe_every=2``: dense FFN layers run on the main node between the
    expert layers; records and tokens still match JAX and greedy."""
    from repro.models import init_params
    cfg = tiny_moe(num_layers=4, moe_every=2, d_ff=128)
    params = init_params(cfg, jax.random.PRNGKey(5))
    toks = prompt(cfg, 6)
    jeng = JEngine(cfg, params, n_workers=8, predictor="sep")
    jout, jtrace = jeng.generate({"tokens": jnp.asarray(toks)}, N_TOK, JAlign(1, 1))
    tcfg, tparams = torch_cfg(cfg), bridge(params)
    eng = ODMoEEngine(tcfg, tparams, n_workers=8, predictor="sep", device="cpu")
    out, trace = eng.generate({"tokens": torch.from_numpy(toks)}, N_TOK)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(
        out.numpy(), greedy_generate(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                                     N_TOK).numpy())
    assert _records(trace) == _records(jtrace)
    assert _events(eng.slots.events) == _events(jeng.slots.events)


def test_memory_report_matches_jax(setup):
    cfg, params, _, _, _ = setup
    jeng = JEngine(cfg, params, n_workers=8, predictor="sep")
    eng, _, _ = _port_engine(setup, "sep")
    assert eng.memory_report() == jeng.memory_report()


def test_cacheless_after_generate(setup):
    """Prompt eviction: nothing stays resident; every load was evicted."""
    eng, _, _ = _port_engine(setup, "sep")
    assert all(r is None for r in eng.slots.resident)
    assert eng.slots.stats["evictions"] == eng.slots.stats["loads"] > 0
    assert eng.slots.stats["predicted_loads"] + eng.slots.stats["reloads"] == \
        eng.slots.stats["loads"]


@pytest.mark.parametrize("transport", [None, "int8"])
def test_shared_store_equals_own_store(setup, transport):
    """An engine handed another engine's store decodes as one that packed
    its own: tokens, load events and bytes."""
    _, _, tcfg, tparams, toks = setup
    batch = {"tokens": torch.from_numpy(toks)}
    first = ODMoEEngine(tcfg, tparams, n_workers=8, predictor="sep", transport=transport,
                        device="cpu")
    out = []
    for eng in (first, ODMoEEngine(tcfg, tparams, n_workers=8, predictor="sep",
                                   transport=transport, store=first.store, device="cpu")):
        got, _ = eng.generate(batch, N_TOK)
        out.append((got.numpy().tolist(), [(e.token, e.layer, e.expert, e.worker, e.bytes)
                                           for e in eng.slots.events],
                    eng.slots.bytes_moved))
    assert out[0] == out[1]
    assert out[0][2] > 0


def test_shared_store_of_another_policy_raises_as_jax_does(setup):
    cfg, params, tcfg, tparams, _ = setup
    jstore = JEngine(cfg, params, n_workers=8, predictor="sep").store
    with pytest.raises(ValueError, match="transport policy differs"):
        JEngine(cfg, params, n_workers=8, predictor="sep", transport="int8", store=jstore)
    store = ODMoEEngine(tcfg, tparams, predictor="sep", device="cpu").store
    with pytest.raises(ValueError, match="transport policy differs"):
        ODMoEEngine(tcfg, tparams, predictor="sep", transport="int8", store=store,
                    device="cpu")


@pytest.mark.parametrize("kw,item", [
    ({"wave_compute": "loop"}, "the wave_compute='loop' oracle")])
def test_unported_engine_options_raise(setup, kw, item):
    """Each unported option names its ROADMAP.md queue 1 item."""
    _, _, tcfg, tparams, _ = setup
    with pytest.raises(NotImplementedError, match="ROADMAP") as err:
        ODMoEEngine(tcfg, tparams, device="cpu", **kw)
    assert item in str(err.value)


@pytest.mark.parametrize("periods", [(0, 0), (2, 3), (0, 1), (3, 0)])
def test_alignment_policies_match_jax(setup, periods):
    """Token and KV alignment every N steps (0 = never): the engines agree
    on tokens, every ``LayerRecord``, the load events and recall."""
    cfg, params, _, _, toks = setup
    jeng = JEngine(cfg, params, n_workers=8, predictor="sep")
    jout, jtrace = jeng.generate({"tokens": jnp.asarray(toks)}, N_TOK, JAlign(*periods))
    _, _, tcfg, tparams, _ = setup
    eng = ODMoEEngine(tcfg, tparams, n_workers=8, predictor="sep", device="cpu")
    out, trace = eng.generate({"tokens": torch.from_numpy(toks)}, N_TOK,
                              AlignmentPolicy(*periods))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert _records(trace) == _records(jtrace)
    assert [(r.aligned_token, r.aligned_kv) for r in trace.records] == \
        [(r.aligned_token, r.aligned_kv) for r in jtrace.records]
    assert _events(eng.slots.events) == _events(jeng.slots.events)
    assert trace.recall() == jtrace.recall()


def test_cli_passes_the_alignment_periods(setup, monkeypatch, capsys):
    """``--token-period`` / ``--kv-period`` reach ``generate`` and the
    serving loop as an ``AlignmentPolicy``."""
    from repro_torch.launch import serve as cli
    seen = []
    real = ODMoEEngine.generate

    def spy(self, batch, num_tokens, policy=AlignmentPolicy(1, 1)):
        seen.append(policy)
        return real(self, batch, num_tokens, policy)

    monkeypatch.setattr(ODMoEEngine, "generate", spy)
    cli.main(["--device", "cpu", "--tokens", "4", "--prompt-len", "8",
              "--token-period", "2", "--kv-period", "3"])
    assert seen == [AlignmentPolicy(2, 3)]
    loops = []

    class Spy(cli.ServingLoop):
        def __init__(self, *args, policy, **kw):
            loops.append(policy)
            super().__init__(*args, policy=policy, **kw)

    monkeypatch.setattr(cli, "ServingLoop", Spy)
    cli.main(["--device", "cpu", "--requests", "2", "--arrival-rate", "0", "--tokens", "3",
              "--prompt-len", "6", "--token-period", "0", "--kv-period", "2"])
    assert loops == [AlignmentPolicy(0, 2)]
    assert "per-request tokens == solo reference" in capsys.readouterr().out


def test_engine_checks_its_device(setup):
    """The engine runs on the card by default; CPU parameters need an
    explicit ``device="cpu"`` (and a CUDA-less host raises outright)."""
    _, _, tcfg, tparams, _ = setup
    with pytest.raises((RuntimeError, ValueError), match="CUDA|cuda"):
        ODMoEEngine(tcfg, tparams)
