"""The port's decode timing model against the JAX package's on the same
traces: ``DecodeClock``/``simulate_odmoe`` (with and without packed
worker compute), the cached, CPU and offload-cache (LRU/LFU) baselines,
``synthetic_trace``, the prefill models, Eq. (1) and the byte budgets
behind them.  Tolerance: 1e-12 relative (the same
float64 arithmetic in the same order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_bridge import bridge, prompt, torch_cfg, torch_trace
from conftest import tiny_moe
from repro.configs import get_config as jget_config
from repro.core import ODMoEEngine as JEngine
from repro.core import prefill as jprefill
from repro.core import timing as jt
from repro.core.align import kv_bytes_per_token as jkv_bytes
from repro.core.schedule import GroupSchedule as JSched
from repro.quant import TieredPolicy as JTiered
from repro.quant.transport import transport_expert_bytes as jexpert_bytes
from repro_torch.configs import get_config
from repro_torch.core import prefill as tprefill
from repro_torch.core import timing as tt
from repro_torch.core.align import kv_bytes_per_token
from repro_torch.core.schedule import GroupSchedule
from repro_torch.quant import TieredPolicy, transport_expert_bytes

REL = 1e-12
MOE_ARCHS = ["mixtral-8x7b", "qwen3-moe-30b-a3b", "granite-moe-3b-a800m"]


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=REL, atol=0)


def _policies(cfg):
    low = [(li, e) for li in range(cfg.num_layers) for e in range(cfg.num_experts)
           if (li + e) % 3 == 0]
    return {None: (None, None), "int8": ("int8", "int8"), "nf4": ("nf4", "nf4"),
            "fp16": ("fp16", "fp16"),
            "tiered": (JTiered(low), TieredPolicy(low))}


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("predictor", ["sep", "none"])
@pytest.mark.parametrize("transport", ["none", "int8", "nf4", "tiered"])
def test_simulate_odmoe_matches_jax_on_full_size_trace(arch, predictor, transport):
    """A full-size config (the model prices its real byte counts) on a
    synthetic routing trace, with and without predictions, loads priced
    by packed bytes, with and without packed worker compute."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    jtrace = jt.synthetic_trace(jcfg, 6, recall=0.8, seed=3,
                                with_predictions=predictor == "sep")
    trace = torch_trace(jtrace)
    jpol, tpol = _policies(cfg)[None if transport == "none" else transport]
    for packed in (False, True):
        want = jt.simulate_odmoe(jcfg, jtrace, JSched(8, jcfg.top_k), jt.RTX3090_EDGE,
                                 predictor=predictor, transport=jpol,
                                 packed_compute=packed)
        got = tt.simulate_odmoe(cfg, trace, GroupSchedule(8, cfg.top_k), tt.RTX3090_EDGE,
                                predictor=predictor, transport=tpol,
                                packed_compute=packed)
        assert len(got.per_token_s) == len(want.per_token_s) == 6
        _close(got.per_token_s, want.per_token_s)
        _close(got.io_stall_s, want.io_stall_s)
        _close(got.tokens_per_s, want.tokens_per_s)


@pytest.fixture(scope="module")
def engine_trace():
    from repro.models import init_params
    cfg = tiny_moe(num_layers=4)
    params = init_params(cfg, jax.random.PRNGKey(0))
    jeng = JEngine(cfg, params, n_workers=8, predictor="sep", transport="int8")
    _, jtrace = jeng.generate({"tokens": jnp.asarray(prompt(cfg, 1))}, 8)
    return cfg, jeng, jtrace


@pytest.mark.parametrize("packed", [False, True])
def test_simulate_odmoe_matches_jax_on_engine_trace(engine_trace, packed):
    """A real engine trace (SEP predictions, reloads, waves) bridged from
    the JAX engine replays to the same modelled per-token times."""
    cfg, jeng, jtrace = engine_trace
    tcfg = torch_cfg(cfg)
    want = jt.simulate_odmoe(cfg, jtrace, jeng.sched, jt.RTX3090_EDGE, transport="int8",
                             packed_compute=packed)
    got = tt.simulate_odmoe(tcfg, torch_trace(jtrace), GroupSchedule(8, 2), tt.RTX3090_EDGE,
                            transport="int8", packed_compute=packed)
    _close(got.per_token_s, want.per_token_s)
    _close(got.io_stall_s, want.io_stall_s)


def test_decode_clock_stage_times_match_jax():
    jcfg, cfg = jget_config("mixtral-8x7b"), get_config("mixtral-8x7b")
    for jpol, tpol in _policies(cfg).values():
        j = jt.DecodeClock(jcfg, JSched(8, 2), jt.RTX3090_EDGE, transport=jpol,
                           packed_compute=True)
        t = tt.DecodeClock(cfg, GroupSchedule(8, 2), tt.RTX3090_EDGE, transport=tpol,
                           packed_compute=True)
        for name in ("t_main_attn", "t_main_mamba", "t_main_dense_ff", "t_router",
                     "t_worker", "t_load", "t_head", "t_shadow_layer", "align_payload",
                     "emb"):
            _close(getattr(t, name), getattr(j, name))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_cached_and_prefill_models_match_jax(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    _close(tt.simulate_cached(cfg, tt.RTX3090_EDGE),
           jt.simulate_cached(jcfg, jt.RTX3090_EDGE))
    for plen in (1, 16, 512):
        for workers, mb in ((8, 4), (4, 1), (16, 3)):
            _close(tt.simulate_prefill_odmoe(cfg, tt.RTX3090_EDGE, plen, workers, mb),
                   jt.simulate_prefill_odmoe(jcfg, jt.RTX3090_EDGE, plen, workers, mb))
        _close(tt.simulate_prefill_cached(cfg, tt.RTX3090_EDGE, plen),
               jt.simulate_prefill_cached(jcfg, jt.RTX3090_EDGE, plen))
    assert tt.layer_bytes(cfg, 4) == jt.layer_bytes(jcfg, 4)
    assert tt.embedding_payload(cfg) == jt.embedding_payload(jcfg)
    assert kv_bytes_per_token(cfg) == jkv_bytes(jcfg)
    for scheme in ("fp32", "fp16", "int8", "nf4"):
        for wb in (2, 4):
            assert transport_expert_bytes(cfg, scheme, wb) == jexpert_bytes(jcfg, scheme, wb)


def test_mixtral_expert_bytes_per_scheme():
    """The per-expert payloads the packed-resident slots hold at
    Mixtral-8x7B width: codes plus their scales."""
    cfg = get_config("mixtral-8x7b")
    assert [transport_expert_bytes(cfg, s) for s in ("fp32", "fp16", "int8", "nf4")] == \
        [704_643_072, 352_321_536, 176_291_840, 99_090_432]


def test_eq1_helpers_match_jax():
    for n, g in ((8, 2), (8, 4), (12, 3)):
        ours, theirs = GroupSchedule(n, g), JSched(n, g)
        for mi in range(5):
            assert ours.active_workers_of_group(mi) == theirs.active_workers_of_group(mi)
            assert ours.load_targets(mi) == theirs.load_targets(mi)
            assert ours.place(mi, [3, 1, 4]) == theirs.place(mi, [3, 1, 4])
        for t_main, t_worker, t_load in ((1e-3, 2e-3, 5e-3), (4e-3, 1e-3, 1e-2)):
            _close(ours.t_maxload(t_main, t_worker), theirs.t_maxload(t_main, t_worker))
            assert ours.io_bottlenecked(t_load, t_main, t_worker) == \
                theirs.io_bottlenecked(t_load, t_main, t_worker)


def test_prefill_helpers_match_jax():
    cfg, jcfg = get_config("mixtral-8x7b"), jget_config("mixtral-8x7b")
    for w in (1, 3, 8):
        assert tprefill.prefill_expert_assignment(cfg, w) == \
            jprefill.prefill_expert_assignment(jcfg, w)
    for n, m in ((16, 4), (5, 3), (0, 2), (3, 8)):
        assert tprefill.split_minibatches(n, m) == jprefill.split_minibatches(n, m)
    idx = np.array([[0, 3], [3, 5]])
    assert tprefill.experts_activated(idx, 8) == jprefill.experts_activated(idx, 8)
    with pytest.raises(ValueError):
        tprefill.prefill_expert_assignment(cfg, 0)
    with pytest.raises(ValueError):
        tprefill.split_minibatches(4, 0)


def _trace_fields(trace):
    def arr(a):
        return None if a is None else (np.asarray(a).dtype.str, np.asarray(a).tolist())
    return [(rec.index, rec.aligned_token, rec.aligned_kv, rec.spec_len, rec.committed,
             [(lr.layer, lr.moe_index, lr.group, arr(lr.predicted), arr(lr.true), lr.correct,
               lr.reloads, list(lr.assignments), lr.waves, tuple(lr.touched), arr(lr.gates),
               lr.shipped, lr.rehits, tuple(lr.hosted)) for lr in rec.layers])
            for rec in trace.records]


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("with_predictions", [True, False])
def test_synthetic_trace_equals_jax(arch, batch, with_predictions):
    """The same numpy draws in the same order: every record equal, field
    for field (dtypes of the routing arrays included)."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    for seed, recall, sticky in ((0, 0.8, 0.55), (7, 0.5, 0.0)):
        want = jt.synthetic_trace(jcfg, 5, recall, batch=batch, seed=seed,
                                  with_predictions=with_predictions, sticky=sticky)
        got = tt.synthetic_trace(cfg, 5, recall, batch=batch, seed=seed,
                                 with_predictions=with_predictions, sticky=sticky)
        assert _trace_fields(got) == _trace_fields(want)
        assert got.recall() == want.recall()


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("policy", ["lru", "lfu"])
def test_offload_cache_and_cpu_baselines_match_jax(arch, policy):
    """The paper's single-node offloading baselines on the same routing
    trace (a full-size config, batch 2), at several cache sizes and
    expert-quantization factors, and the CPU baseline."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    jtrace = jt.synthetic_trace(jcfg, 6, recall=0.8, batch=2, seed=4)
    trace = tt.synthetic_trace(cfg, 6, recall=0.8, batch=2, seed=4)
    for cache in (0, 1, cfg.top_k, cfg.num_experts, 3 * cfg.num_experts):
        for qf in (1.0, 0.5, 0.28125):
            kw = dict(policy=policy, cache_experts=cache, quant_factor=qf)
            got = tt.simulate_offload_cache(cfg, trace, tt.RTX3090_EDGE, **kw)
            want = jt.simulate_offload_cache(jcfg, jtrace, jt.RTX3090_EDGE, **kw)
            assert sorted(got) == sorted(want)
            _close(got["tokens_per_s"], want["tokens_per_s"])
            _close(got["cache_hit_rate"], want["cache_hit_rate"])
    _close(tt.simulate_cpu(cfg, tt.RTX3090_EDGE), jt.simulate_cpu(jcfg, jt.RTX3090_EDGE))


def test_lfu_ties_fall_as_in_jax():
    """A capacity-2 LFU over keys whose counts tie: the victims, hence the
    hit pattern, follow the reference's ``min`` over its resident set."""
    keys = [(0, 3), (1, 5), (0, 7), (0, 3), (2, 1), (1, 5), (0, 7), (2, 1), (3, 0), (0, 3)]
    ours, theirs = tt._LFU(2), jt._LFU(2)
    assert [ours.access(k) for k in keys] == [theirs.access(k) for k in keys]
    assert ours.resident == theirs.resident and dict(ours.counts) == dict(theirs.counts)
    lru, jlru = tt._LRU(2), jt._LRU(2)
    assert [lru.access(k) for k in keys] == [jlru.access(k) for k in keys]
    assert list(lru.od) == list(jlru.od)
