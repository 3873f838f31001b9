"""The port's reference model against ``repro.models`` on bridged weights:
greedy tokens equal and logits within rtol = atol = 1e-4 (XLA and
PyTorch sum in different orders, so bitwise float equality between them
is not a goal), plus the attention and routing pieces one by one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import bridge, prompt, torch_cfg
from conftest import tiny_dense, tiny_moe
from repro.models import attention as jattn
from repro.models import decode_step as jdecode_step
from repro.models import greedy_generate as jgreedy
from repro.models import init_params as jinit
from repro.models import moe as jmoe
from repro.models import prefill as jprefill
import repro_torch.models as tm
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe

TOL = dict(rtol=1e-4, atol=1e-4)
MAKERS = {"tiny_moe": tiny_moe, "tiny_dense": tiny_dense}


@pytest.fixture(scope="module", params=[(m, s) for m in MAKERS for s in (0, 1, 2)],
                ids=lambda p: f"{p[0]}-seed{p[1]}")
def model(request):
    name, seed = request.param
    cfg = MAKERS[name]()
    params = jinit(cfg, jax.random.PRNGKey(seed))
    return cfg, params, torch_cfg(cfg), bridge(params), prompt(cfg, seed + 10)


def test_greedy_tokens_equal(model):
    cfg, params, tcfg, tparams, toks = model
    ref = np.asarray(jgreedy(cfg, params, {"tokens": jnp.asarray(toks)}, 8))
    out = tm.greedy_generate(tcfg, tparams, {"tokens": torch.from_numpy(toks)}, 8)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_prefill_and_decode_logits_close(model):
    """Teacher-forced on JAX's tokens: every step's logits agree."""
    cfg, params, tcfg, tparams, toks = model
    jl, js = jprefill(cfg, params, {"tokens": jnp.asarray(toks)}, 20,
                      moe_method="grouped")
    tl, ts = tm.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)}, 20,
                        moe_method="grouped")
    for _ in range(5):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        jl, js = jdecode_step(cfg, params, tok, js)
        tl, ts = tm.decode_step(tcfg, tparams, torch.from_numpy(np.array(tok)), ts)
    assert np.asarray(js["pos"]).tolist() == ts["pos"].tolist()


@pytest.mark.parametrize("n", [1, 5, 8, 9, 100, 2048])
def test_seq_bucket_matches(n):
    assert tattn.seq_bucket(n) == jattn.seq_bucket(n)


def test_unbucketed_prefill_matches():
    """A cache shorter than the prompt's bucket: the reference takes the
    unpadded path, the port seeds at the bucket's width and cuts the
    cache to 13 slots; logits and slot positions agree."""
    cfg = tiny_moe()
    params = jinit(cfg, jax.random.PRNGKey(3))
    toks = prompt(cfg, 4, length=12)
    jl, js = jprefill(cfg, params, {"tokens": jnp.asarray(toks)}, 13,
                      moe_method="grouped")
    tl, ts = tm.prefill(torch_cfg(cfg), bridge(params),
                        {"tokens": torch.from_numpy(toks)}, 13, moe_method="grouped")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(ts["caches"][0]["pos"].numpy(),
                                  np.asarray(js["caches"][0]["pos"]))


def test_ring_buffer_decode_matches_with_sliding_window():
    """Sliding window narrower than the sequence: slot ``pos % w`` wraps,
    and the kpos/window mask must hide overwritten positions."""
    cfg = tiny_dense(sliding_window=4, num_layers=2)
    params = jinit(cfg, jax.random.PRNGKey(5))
    p0 = jax.tree.map(lambda a: a[0], params["layers"][0])["mixer"]
    tp0 = bridge(p0)
    tcfg = torch_cfg(cfg)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6))
    jc = jattn.seed_cache(cfg, p0, jnp.asarray(x), jnp.asarray(pos), 16)
    tc = tattn.seed_cache(tcfg, tp0, torch.from_numpy(x), torch.from_numpy(pos.copy()), 16)
    for name in ("k", "v", "pos"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **TOL)
    for step in range(6, 12):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        p = np.full((2,), step, np.int32)
        jo, jc = jattn.attn_decode(cfg, p0, jnp.asarray(xt), jc, jnp.asarray(p))
        to, tc = tattn.attn_decode(tcfg, tp0, torch.from_numpy(xt), tc, torch.from_numpy(p))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_attn_decode_leaves_its_input_cache_alone():
    """Cache updates are out of place: the SEP shadow adopts the main
    model's caches and must never see them change underneath."""
    cfg = torch_cfg(tiny_dense())
    p = tm.init_params(cfg, seed=0, device="cpu")
    mixer = {k: v[0] for k, v in p["layers"][0]["mixer"].items()}
    cache = tattn.init_cache(cfg, 1, 8, torch.float32, "cpu")
    before = {k: v.clone() for k, v in cache.items()}
    tattn.attn_decode(cfg, mixer, torch.ones(1, 1, cfg.d_model), cache,
                      torch.tensor([0], dtype=torch.int32))
    for k in cache:
        assert torch.equal(cache[k], before[k])


def test_route_matches_including_ties():
    """Top-k with ``jax.lax.top_k`` order: equal logits keep the lower
    expert index first; gates are the softmax over the top-k logits."""
    cfg = tiny_moe()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, cfg.d_model)).astype(np.float32)
    router = rng.standard_normal((cfg.d_model, cfg.num_experts)).astype(np.float32)
    router[:, 5] = router[:, 2]                      # exact tie between experts 2, 5
    ji, jg, _ = jmoe.route(cfg, {"router": jnp.asarray(router)}, jnp.asarray(x))
    ti, tg = tmoe.route(torch_cfg(cfg), {"router": torch.from_numpy(router)},
                        torch.from_numpy(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)
    vals = torch.tensor([[1.0, 3.0, 3.0, 0.0]])
    assert tmoe.top_k(vals, 2)[1].tolist() == [[1, 2]]


def test_moe_grouped_matches():
    cfg = tiny_moe()
    params = jinit(cfg, jax.random.PRNGKey(7))
    ff = jax.tree.map(lambda a: a[0], params["layers"][0])["ff"]
    x = np.random.default_rng(1).standard_normal((5, cfg.d_model)).astype(np.float32)
    jo, jaux = jmoe.moe_grouped(cfg, ff, jnp.asarray(x))
    to, tidx = tmoe.moe_grouped(torch_cfg(cfg), bridge(ff), torch.from_numpy(x))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jaux["topk_idx"]))


def test_bridge_keeps_the_stacked_layout():
    cfg = tiny_moe()
    params = jinit(cfg, jax.random.PRNGKey(0))
    tp = bridge(params)
    jl = jax.tree.leaves(params)
    tl = tm.transformer.tree_leaves(tp)
    assert [tuple(a.shape) for a in jl] == [tuple(t.shape) for t in tl]
    for a, t in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), t.numpy())


def test_bridge_takes_bfloat16_leaves():
    arr = np.asarray(jnp.asarray([[1.5, -2.25], [0.0, 3.0]], jnp.bfloat16))
    t = tm.from_numpy({"w": arr}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    assert t.float().tolist() == [[1.5, -2.25], [0.0, 3.0]]


def test_port_init_params_layout_matches_jax():
    """The port's own init draws from a torch generator, but its tree has
    the reference's structure, shapes and dtypes."""
    def flat(tree, path=()):
        if isinstance(tree, dict):
            return {k: v for key in tree for k, v in flat(tree[key], path + (key,)).items()}
        if isinstance(tree, (tuple, list)):
            return {k: v for i, t in enumerate(tree) for k, v in flat(t, path + (i,)).items()}
        return {path: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}

    cfg = tiny_moe()
    assert flat(jinit(cfg, jax.random.PRNGKey(0))) == \
        flat(tm.init_params(torch_cfg(cfg), seed=0, device="cpu"))


@pytest.mark.parametrize("overrides", [
    dict(norm_type="layernorm", tie_embeddings=True),
    dict(qkv_bias=True, rope_fraction=0.5, logit_soft_cap=30.0),
    dict(sliding_window=8),
], ids=["layernorm-tied", "bias-partial-rope-softcap", "sliding-window"])
def test_config_variants_match(overrides):
    """The options of the registry's dense configs (command-r, chatglm,
    qwen) on a tiny model; a window narrower than the prompt bucket takes
    the unpadded prefill and wraps the decode ring buffer."""
    cfg = tiny_dense(**overrides)
    params = jinit(cfg, jax.random.PRNGKey(11))
    toks = prompt(cfg, 12)
    ref = np.asarray(jgreedy(cfg, params, {"tokens": jnp.asarray(toks)}, 10))
    out = tm.greedy_generate(torch_cfg(cfg), bridge(params),
                             {"tokens": torch.from_numpy(toks)}, 10)
    np.testing.assert_array_equal(out.numpy(), ref)
    jl, _ = jprefill(cfg, params, {"tokens": jnp.asarray(toks)}, 22, moe_method="grouped")
    tl, _ = tm.prefill(torch_cfg(cfg), bridge(params), {"tokens": torch.from_numpy(toks)}, 22)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
