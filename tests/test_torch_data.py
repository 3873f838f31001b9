"""The port's training substrate against the JAX package: the synthetic
Markov stream, packing, batches and the byte tokenizer (bit for bit from
the same seeds), AdamW and its cosine schedule on identical trees of
parameters, gradients and moments (within 1e-6: fp32 arithmetic in the
same order but for the sum of the global norm), and npz checkpoints
written by either package and read by the other (bit for bit, bf16
leaves included)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import data as jdata
from repro import optim as jopt
from repro_torch import checkpoint as tckpt
from repro_torch import data as tdata
from repro_torch import optim as topt
from repro_torch.optim import adamw as tadamw

OPT_TOL = dict(rtol=1e-6, atol=1e-6)

STREAMS = [dict(vocab_size=97, seq_len=16, batch_size=3),
           dict(vocab_size=64, seq_len=32, batch_size=4, branching=2, zipf=1.3, seed=5),
           dict(vocab_size=50, seq_len=8, batch_size=2, seed=2, frontend_tokens=8,
                frontend_dim=12)]


@pytest.mark.parametrize("kw", STREAMS, ids=["default", "sharp", "frontend"])
def test_markov_stream_and_batches_equal_jax(kw):
    jcfg, tcfg = jdata.SyntheticConfig(**kw), tdata.SyntheticConfig(**kw)
    for off in (0, 3):
        np.testing.assert_array_equal(tdata.markov_tokens(tcfg, 200, seed_offset=off),
                                      jdata.markov_tokens(jcfg, 200, seed_offset=off))
    jit, tit = jdata.batch_iterator(jcfg), tdata.batch_iterator(tcfg)
    for _ in range(3):
        jb, tb = next(jit), next(tit)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert tb[k].dtype == jb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])


def test_pack_documents_equal_jax():
    rng = np.random.default_rng(0)
    docs = [rng.integers(1, 90, rng.integers(1, 23)).astype(np.int32) for _ in range(9)]
    for seq_len, pad in ((8, 0), (13, 7), (64, 1)):
        np.testing.assert_array_equal(tdata.pack_documents(docs, seq_len, pad),
                                      jdata.pack_documents(docs, seq_len, pad))
    np.testing.assert_array_equal(tdata.pack_documents([], 5), jdata.pack_documents([], 5))


def test_byte_tokenizer_equal_jax():
    texts = ["hello", "", "héllo wörld", "a longer line of text"]
    jt, tt = jdata.ByteTokenizer(), tdata.ByteTokenizer()
    for t in texts:
        np.testing.assert_array_equal(tt.encode(t), jt.encode(t))
        np.testing.assert_array_equal(tt.encode(t, bos=False), jt.encode(t, bos=False))
        assert tt.decode(tt.encode(t)) == jt.decode(jt.encode(t)) == t
    for pad in (0, 4, 30):
        np.testing.assert_array_equal(tt.encode_batch(texts, pad), jt.encode_batch(texts, pad))
    assert tt.vocab_size == jt.vocab_size


# ------------------------------------------------------------------ AdamW
def _tree(rng, scale=1.0):
    """A parameter-like tree: a stacked (R, D) norm, stacked matrices, a
    vector, a 4-D expert stack, in a tuple of layers."""
    shapes = {"embed": {"table": (11, 6)}, "final_norm": {"scale": (6,)},
              "layers": ({"norm": {"scale": (3, 6)}, "w": (3, 6, 5), "b": (3, 5)},
                         {"experts": (2, 4, 6, 3)})}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        if isinstance(s, tuple) and isinstance(s[0], dict):
            return tuple(make(v) for v in s)
        return (scale * rng.standard_normal(s)).astype(np.float32)
    return make(shapes)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_trees_close(got, want, **tol):
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol)


@functools.lru_cache(maxsize=None)
def _jax_adamw(cfg):
    """The reference's update, jitted once per config (every case's tree
    has the same shapes)."""
    return jax.jit(lambda p, g, s: jopt.adamw_update(p, g, s, cfg))


@pytest.mark.parametrize("grad_scale,step", [(0.05, 0), (3.0, 4), (0.2, 150)],
                         ids=["unclipped-first", "clipped", "decaying-lr"])
def test_adamw_update_matches_jax(grad_scale, step):
    """Identical params, grads and moments through one update of each
    package: params, moments, step, grad_norm and lr within 1e-6 (the
    stacked (R, D) norm scale decays in both, ndim >= 2 on the stacked
    leaf; the (D,) final norm in neither)."""
    rng = np.random.default_rng(step)
    params, grads = _tree(rng), _tree(rng, grad_scale)
    mu = _tree(rng, 0.01)
    nu = jax.tree.map(np.abs, _tree(rng, 0.01))
    cfg = dict(lr=1e-2, warmup_steps=10, total_steps=200, weight_decay=0.1)
    jstate = {"mu": _to_jax(mu), "nu": _to_jax(nu), "step": jnp.asarray(step, jnp.int32)}
    tstate = {"mu": _to_torch(mu), "nu": _to_torch(nu),
              "step": torch.tensor(step, dtype=torch.int32)}
    jp, js, jm = _jax_adamw(jopt.AdamWConfig(**cfg))(_to_jax(params), _to_jax(grads), jstate)
    tp, ts, tm = topt.adamw_update(_to_torch(params), _to_torch(grads), tstate,
                                   topt.AdamWConfig(**cfg))
    _assert_trees_close(tp, jp, **OPT_TOL)
    _assert_trees_close(ts["mu"], js["mu"], **OPT_TOL)
    _assert_trees_close(ts["nu"], js["nu"], **OPT_TOL)
    assert int(ts["step"]) == int(js["step"]) == step + 1 and ts["step"].dtype == torch.int32
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **OPT_TOL)


def test_adamw_chunked_update_is_bitwise_the_whole_one(monkeypatch):
    """Chunks of the leading axis change no bit of the update."""
    rng = np.random.default_rng(3)
    params, grads, mu = _tree(rng), _tree(rng, 0.3), _tree(rng, 0.01)
    nu = jax.tree.map(np.abs, _tree(rng, 0.01))
    outs = []
    for elements in (tadamw.CHUNK_ELEMENTS, 7):
        monkeypatch.setattr(tadamw, "CHUNK_ELEMENTS", elements)
        state = {"mu": _to_torch(mu), "nu": _to_torch(nu), "step": torch.tensor(2)}
        outs.append(topt.adamw_update(_to_torch(params), _to_torch(grads), state,
                                      topt.AdamWConfig(lr=1e-2, warmup_steps=1)))
    assert len(tadamw._chunks(torch.zeros(2, 4, 6, 3))) == 2    # one slice (72) > 7
    assert len(tadamw._chunks(torch.zeros(11, 6))) == 11
    for a, b in zip(jax.tree.leaves((outs[0][0], outs[0][1])),
                    jax.tree.leaves((outs[1][0], outs[1][1]))):
        assert torch.equal(a, b)


def test_cosine_schedule_and_init_match_jax():
    cfg = dict(lr=3e-3, warmup_steps=7, total_steps=50, min_lr_ratio=0.2)
    steps = np.arange(0, 60, dtype=np.int32)
    want = [float(jopt.cosine_schedule(jopt.AdamWConfig(**cfg), jnp.asarray(s))) for s in steps]
    got = [float(topt.cosine_schedule(topt.AdamWConfig(**cfg), torch.tensor(s))) for s in steps]
    np.testing.assert_allclose(got, want, **OPT_TOL)
    params = _to_torch(_tree(np.random.default_rng(1)))
    params["embed"]["table"] = params["embed"]["table"].to(torch.bfloat16)
    state = topt.init_opt_state(params)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    for mom in (state["mu"], state["nu"]):
        for m, p in zip(jax.tree.leaves(mom), jax.tree.leaves(params)):
            assert m.dtype == torch.float32 and m.shape == p.shape and not m.any()
    assert dataclasses.asdict(topt.AdamWConfig()) == dataclasses.asdict(jopt.AdamWConfig())


# ------------------------------------------------------------ checkpoints
def _opt_np(params, step):
    return {"mu": jax.tree.map(lambda a: a * 0.5, params),
            "nu": jax.tree.map(np.abs, params), "step": np.asarray(step, np.int32)}


def _np_bf16(tree):
    """The tree with its embedding in bf16 (ml_dtypes, as JAX hands it to
    numpy)."""
    tree = jax.tree.map(np.copy, tree)
    tree["embed"]["table"] = tree["embed"]["table"].astype(ml_dtypes.bfloat16)
    return tree


def _torch_from_np(tree):
    def leaf(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return jax.tree.map(leaf, tree)


def _bits(a):
    a = a.detach().numpy() if a.dtype != torch.bfloat16 else a.view(torch.int16).numpy()
    return a


def _np_bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 and a.dtype.kind == "V" else a


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16-embed"])
def test_port_checkpoint_loads_in_jax(tmp_path, bf16):
    """Written by the port, read by ``repro.checkpoint.load_checkpoint``:
    the same keys, every leaf bit for bit (a bf16 leaf comes back as the
    reference's own bf16 leaves do, raw 2-byte voids), step and extras."""
    params = _tree(np.random.default_rng(7))
    if bf16:
        params = _np_bf16(params)
    opt = _opt_np(jax.tree.map(lambda a: np.asarray(a, np.float32), params), 5)
    path = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(path, _torch_from_np(params), _torch_from_np(opt), step=5,
                          extra={"note": np.arange(3)})
    jp, jo, step = jckpt.load_checkpoint(path, params, opt)
    assert step == 5
    for got, want in zip(jax.tree.leaves((jp, jo)), jax.tree.leaves((params, opt))):
        np.testing.assert_array_equal(_np_bits(got), _np_bits(want))
    with np.load(path) as z:
        assert sorted(z.files) == sorted(
            ["meta/step", "extra/note"] + [f"params/{k}" for k in jckpt.tree_to_flat_dict(params)]
            + [f"opt/{k}" for k in jckpt.tree_to_flat_dict(opt)])
        np.testing.assert_array_equal(z["extra/note"], np.arange(3))


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16-embed"])
def test_jax_checkpoint_loads_in_the_port(tmp_path, bf16):
    """Written by ``repro.checkpoint.save_checkpoint``, restored by the
    port into torch templates: bit for bit, with the template's dtypes."""
    params = _tree(np.random.default_rng(8))
    if bf16:
        params = _np_bf16(params)
    opt = _opt_np(jax.tree.map(lambda a: np.asarray(a, np.float32), params), 9)
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, params, opt, step=9)
    template = jax.tree.map(torch.zeros_like, _torch_from_np(params))
    otemplate = topt.init_opt_state(template)
    tp, to, step = tckpt.load_checkpoint(path, template, otemplate)
    assert step == 9
    for got, want in zip(jax.tree.leaves((tp, to)), jax.tree.leaves((params, opt))):
        np.testing.assert_array_equal(_bits(got), _np_bits(want))
    assert tp["embed"]["table"].dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert to["step"].dtype == torch.int32
    assert tckpt.tree_to_flat_dict(tp).keys() == jckpt.tree_to_flat_dict(params).keys()
    bad = jax.tree.map(torch.zeros_like, template)
    bad["final_norm"]["scale"] = torch.zeros(7)
    with pytest.raises(ValueError):
        tckpt.load_checkpoint(path, bad)
    del bad["final_norm"]
    bad["extra_leaf"] = torch.zeros(2)
    with pytest.raises(KeyError):
        tckpt.load_checkpoint(path, bad)
