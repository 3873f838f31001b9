"""The port's capacity dispatches (``dense``, ``scatter``, ``einsum``)
and ``moe_ff`` against the JAX package, on ``tiny_moe`` with 12 padded
expert rows over its 8 routed experts: slot assignment exactly, outputs
and the load-balance loss within tolerance, ``drop_fraction`` with and
without drops, ``capacity`` on a grid, a callable method, a property
holding scatter and einsum to one placement; then ``loss_fn`` (loss,
cross-entropy, load-balance term) for a dense model and for the MoE model
under all four dispatches, with a loss mask.

Tolerance: rtol = atol = 1e-5 in fp32 for one layer's output and its
load-balance loss, 1e-4 for losses after a whole model (as the model
tests); indices, slot maps and dropped-pair counts exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from _torch_bridge import numpy_params, torch_cfg
from conftest import tiny_dense, tiny_moe
from repro.models import loss_fn as jloss_fn
from repro.models import moe as jmoe
import repro_torch.models as tm
from repro_torch.models import moe as tmoe

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
N_ROWS = 24
# the config's 1.25 (some drops at 24 rows), 0.5 (many), E / k (none can drop)
FACTORS = {"config": None, "tight": 0.5, "no-drop": 4.0}
METHODS = ("dense", "scatter", "einsum", "grouped")
B, T = 2, 10


def _cfg(**kw):
    return tiny_moe(padded_experts=12, **kw)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def layer():
    """One MoE layer's parameters, a row batch and the reference's
    dispatches at every capacity factor, compiled once."""
    cfg = _cfg()
    tree = jax.tree.map(lambda a: a[0], numpy_params(cfg, 5)["layers"][0]["ff"])
    x = np.random.default_rng(6).standard_normal((N_ROWS, cfg.d_model)).astype(np.float32)

    def run(p, xs):
        out = {m: jmoe.moe_ff(cfg, p, xs, m) for m in ("dense", "grouped")}
        for name, f in FACTORS.items():
            for m in ("scatter", "einsum"):
                out[f"{m}-{name}"] = jmoe.moe_ff(cfg, p, xs, m, cap_factor=f)
        return out

    ref = jax.jit(run)(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    return cfg, torch_cfg(cfg), tm.from_numpy(tree, "cpu"), x, jax.tree.map(np.asarray, ref)


def _random_routing(n, e, k, seed):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(e, k, replace=False) for _ in range(n)]).astype(np.int32)
    gate = rng.random((n, k)).astype(np.float32)
    return idx, gate / gate.sum(-1, keepdims=True)


@pytest.mark.parametrize("cap", [1, 3, 40])
def test_slot_assignment_equal(cap):
    """The same routing placed by both packages: slot maps, gates, validity
    and kept pairs exactly equal; padded experts' slots stay empty."""
    cfg = _cfg()
    idx, gate = _random_routing(N_ROWS, cfg.num_experts, cfg.top_k, cap)
    want = jmoe._slot_assignment(cfg, jnp.asarray(idx), jnp.asarray(gate), cap)
    got = tmoe._slot_assignment(torch_cfg(cfg), torch.from_numpy(idx).long(),
                                torch.from_numpy(gate), cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not got[2][cfg.num_experts * cap:].any()


@pytest.mark.parametrize("method", ["dense", "grouped"])
def test_uncapped_dispatch_matches(layer, method):
    _, tcfg, tparams, x, ref = layer
    out, aux = tmoe.moe_ff(tcfg, tparams, torch.from_numpy(x), method)
    want, jaux = ref[method]
    np.testing.assert_allclose(out.numpy(), want, **LAYER_TOL)
    np.testing.assert_array_equal(aux["topk_idx"].numpy(), jaux["topk_idx"])
    np.testing.assert_allclose(float(aux["load_balance_loss"]),
                               float(jaux["load_balance_loss"]), **LAYER_TOL)


@pytest.mark.parametrize("factor", list(FACTORS))
@pytest.mark.parametrize("method", ["scatter", "einsum"])
def test_capacity_dispatch_matches(layer, method, factor):
    """Outputs and the load-balance loss within tolerance, top-k exactly;
    ``drop_fraction`` gives the same count of dropped (token, rank) pairs
    (XLA's mean can leave a last-bit residue, -3e-8 where nothing drops),
    and none drops when every expert can take every row."""
    _, tcfg, tparams, x, ref = layer
    out, aux = tmoe.moe_ff(tcfg, tparams, torch.from_numpy(x), method,
                           cap_factor=FACTORS[factor])
    want, jaux = ref[f"{method}-{factor}"]
    np.testing.assert_allclose(out.numpy(), want, **LAYER_TOL)
    np.testing.assert_array_equal(aux["topk_idx"].numpy(), jaux["topk_idx"])
    np.testing.assert_allclose(float(aux["load_balance_loss"]),
                               float(jaux["load_balance_loss"]), **LAYER_TOL)
    pairs = N_ROWS * tcfg.top_k
    df, jdf = float(aux["drop_fraction"]), float(jaux["drop_fraction"])
    assert abs(df - jdf) < 1e-6
    assert round(df * pairs) == round(jdf * pairs)
    assert (df == 0.0) == (factor == "no-drop")


def test_capacity_agrees_on_a_grid():
    for cfg in (_cfg(), tiny_moe(num_experts=40, top_k=8, padded_experts=48)):
        for n in (1, 5, 24, 100, 1024):
            for f in (None, 0.25, 0.5, 1.0, 1.25, 5.0):
                assert tmoe.capacity(torch_cfg(cfg), n, f) == jmoe.capacity(cfg, n, f)


def test_callable_method_is_called_with_the_rows(layer):
    _, tcfg, tparams, x, _ = layer
    seen = []

    def method(cfg, params, rows):
        seen.append(tuple(rows.shape))
        return tmoe.moe_dense(cfg, params, rows)

    out, aux = tmoe.moe_ff(tcfg, tparams, torch.from_numpy(x), method)
    want, _ = tmoe.moe_ff(tcfg, tparams, torch.from_numpy(x), "dense")
    assert seen == [(N_ROWS, tcfg.d_model)]
    assert torch.equal(out, want)


@settings(max_examples=8, deadline=None)
@given(n=st.integers(1, 20), factor=st.sampled_from([0.25, 0.5, 1.0, 1.25, 4.0]),
       seed=st.integers(0, 10_000))
def test_scatter_and_einsum_place_the_same_pairs(n, factor, seed):
    """Whatever the rows and capacity: the two capacity dispatches keep the
    same (token, rank) pairs, so their outputs agree and their drop
    fractions are equal; the placement never fills a padded expert."""
    cfg = torch_cfg(_cfg(num_layers=1))
    params = tm.transformer.tree_map(lambda a: a[0],
                                     tm.init_params(cfg, seed=seed, device="cpu")["layers"][0])
    x = torch.randn((n, cfg.d_model), generator=torch.Generator().manual_seed(seed))
    so, saux = tmoe.moe_scatter(cfg, params["ff"], x, factor)
    eo, eaux = tmoe.moe_einsum(cfg, params["ff"], x, factor)
    assert torch.equal(saux["kept"], eaux["kept"])
    torch.testing.assert_close(so, eo, **LAYER_TOL)
    assert float(saux["drop_fraction"]) == pytest.approx(float(eaux["drop_fraction"]), abs=1e-6)
    idx, gate = tmoe.route(cfg, params["ff"], x)
    cap = tmoe.capacity(cfg, n, factor)
    _, _, valid, kept = tmoe._slot_assignment(cfg, idx, gate, cap)
    assert int(valid.sum()) == int(kept.sum())
    assert not valid[cfg.num_experts * cap:].any()


@pytest.fixture(scope="module")
def losses():
    """``loss_fn`` of a dense model and of the MoE model under every
    dispatch, with a loss mask, from the reference, compiled once."""
    rng = np.random.default_rng(8)
    toks = rng.integers(0, 97, (B, T)).astype(np.int32)
    mask = (np.arange(T)[None] < np.array([[T], [6]])).astype(np.float32)
    cfgs = {"dense": tiny_dense(num_layers=2), "moe": _cfg(num_layers=2)}
    trees = {name: numpy_params(cfg, 9) for name, cfg in cfgs.items()}

    def run(ps, tk, mk):
        batch = {"tokens": tk, "loss_mask": mk}
        out = {"dense": jloss_fn(cfgs["dense"], ps["dense"], batch)}
        for m in METHODS:
            out[f"moe-{m}"] = jloss_fn(cfgs["moe"], ps["moe"], batch, moe_method=m)
        return out

    ref = jax.jit(run)(jax.tree.map(jnp.asarray, trees), jnp.asarray(toks), jnp.asarray(mask))
    batch = {"tokens": torch.from_numpy(toks), "loss_mask": torch.from_numpy(mask)}
    return ({name: (torch_cfg(cfg), tm.from_numpy(trees[name], "cpu"))
             for name, cfg in cfgs.items()}, batch, jax.tree.map(np.asarray, ref))


@pytest.mark.parametrize("case", ["dense"] + [f"moe-{m}" for m in METHODS])
def test_loss_fn_matches(losses, case):
    models, batch, ref = losses
    name, method = (case.split("-") + ["scatter"])[:2]
    tcfg, tparams = models[name]
    loss, metrics = tm.loss_fn(tcfg, tparams, batch, moe_method=method)
    jl, jm = ref[case]
    np.testing.assert_allclose(float(loss), float(jl), **TOL)
    for key in ("ce", "load_balance_loss", "loss"):
        np.testing.assert_allclose(float(metrics[key]), float(jm[key]), **TOL)
    if name == "moe":
        assert float(metrics["load_balance_loss"]) > 0.0
