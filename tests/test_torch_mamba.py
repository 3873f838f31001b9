"""The port's Mamba2 (SSD) mixer against the JAX package's on bridged
weights: the plain SSD inter-chunk scan against the JAX oracle and the
Pallas kernel in interpret mode (1e-6), ``mamba_seq`` with T a multiple of
the chunk, not a multiple, and shorter than it (output and ``{"h",
"conv"}`` state within 1e-5, fp32), ``mamba_decode`` stepped after a
prefix, and the pieces (conv, gates, state layout, row invariance)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import bridge, torch_cfg
from conftest import tiny_ssm
from repro.kernels.ssd_scan import ssd_scan_kernel as jssd_kernel
from repro.kernels.ssd_scan import ssd_scan_ref as jssd_ref
from repro.models import blocks as jblocks
from repro.models import mamba as jmamba
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_kernel, ssd_scan_ref
from repro_torch.models import blocks as tblocks
from repro_torch.models import mamba as tmamba

SCAN_TOL = 1e-6
MAMBA_TOL = 1e-5
CHUNK = 8


def _cfg(**kw):
    return tiny_ssm(ssm_chunk=CHUNK, **kw)


def _scan_inputs(b, nc, h, p, n, seed=3):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((b, nc, h, p, n)).astype(np.float32)
    dec = rng.uniform(0.3, 1.0, (b, nc, h)).astype(np.float32)
    return s, dec


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("b,nc,h,p,n", [(1, 4, 4, 8, 16), (2, 7, 8, 16, 24), (1, 1, 6, 8, 8),
                                        (2, 5, 10, 8, 16), (3, 3, 3, 5, 7)])
def test_ssd_scan_ref_matches_jax_oracle_and_pallas_interpret(b, nc, h, p, n):
    s, dec = _scan_inputs(b, nc, h, p, n)
    t_in, t_last = ssd_scan_ref(torch.from_numpy(s), torch.from_numpy(dec))
    j_in, j_last = jssd_ref(jnp.asarray(s), jnp.asarray(dec))
    k_in, k_last = jssd_kernel(jnp.asarray(s), jnp.asarray(dec), block_h=4, interpret=True)
    assert t_in.shape == (b, nc, h, p, n) and t_last.shape == (b, h, p, n)
    for theirs_in, theirs_last in ((j_in, j_last), (k_in, k_last)):
        _close(t_in.numpy(), theirs_in, SCAN_TOL)
        _close(t_last.numpy(), theirs_last, SCAN_TOL)


def test_ssd_scan_ref_with_initial_state_matches_a_numpy_loop():
    """``h0`` is the ``initial_state`` JAX's ``mamba_seq`` feeds its scan."""
    s, dec = _scan_inputs(2, 5, 4, 8, 16, seed=4)
    h0 = np.random.default_rng(5).standard_normal((2, 4, 8, 16)).astype(np.float32)
    h, want = h0.copy(), []
    for c in range(5):
        want.append(h)
        h = dec[:, c, :, None, None] * h + s[:, c]
    t_in, t_last = ssd_scan_ref(torch.from_numpy(s), torch.from_numpy(dec), torch.from_numpy(h0))
    _close(t_in.numpy(), np.stack(want, axis=1), SCAN_TOL)
    _close(t_last.numpy(), h, SCAN_TOL)


def test_ssd_scan_on_the_host_takes_the_plain_version():
    s, dec = (torch.from_numpy(a) for a in _scan_inputs(1, 3, 2, 4, 4))
    before = ssd_scan_kernel.launches
    got = ssd_scan(s, dec)
    want = ssd_scan_ref(s, dec)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ssd_scan_kernel.launches == before
    with pytest.raises(ValueError):
        ssd_scan_kernel(s, dec)                         # the kernel runs on the card only


@pytest.fixture(scope="module")
def mixer():
    cfg = _cfg()
    params = jmamba.init_mamba(jax.random.PRNGKey(7), cfg)
    return cfg, params, torch_cfg(cfg), bridge(params)


def _x(cfg, b, t, seed):
    return np.random.default_rng(seed).standard_normal((b, t, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("t", [16, 21, 5], ids=["multiple", "ragged", "short"])
def test_mamba_seq_matches_jax(mixer, t):
    """T = 2 chunks, T = 21 (the last chunk padded by 3 identity steps) and
    T = 5 < chunk (one short chunk)."""
    cfg, params, tcfg, tparams = mixer
    x = _x(cfg, 2, t, seed=t)
    jout, jstate = jmamba.mamba_seq(cfg, params, jnp.asarray(x))
    tout, tstate = tmamba.mamba_seq(tcfg, tparams, torch.from_numpy(x))
    _close(tout.numpy(), jout, MAMBA_TOL)
    assert set(tstate) == {"h", "conv"}
    for name in ("h", "conv"):
        assert tuple(tstate[name].shape) == jstate[name].shape
        _close(tstate[name].numpy(), jstate[name], MAMBA_TOL)


def test_mamba_seq_with_initial_state_matches_jax(mixer):
    cfg, params, tcfg, tparams = mixer
    x = _x(cfg, 1, 19, seed=3)
    h0 = np.random.default_rng(4).standard_normal(
        (1, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)).astype(np.float32)
    jout, jstate = jmamba.mamba_seq(cfg, params, jnp.asarray(x),
                                    initial_state={"h": jnp.asarray(h0)})
    tout, tstate = tmamba.mamba_seq(tcfg, tparams, torch.from_numpy(x),
                                    initial_state={"h": torch.from_numpy(h0)})
    _close(tout.numpy(), jout, MAMBA_TOL)
    _close(tstate["h"].numpy(), jstate["h"], MAMBA_TOL)


def test_mamba_decode_after_a_prefix_matches_jax(mixer):
    cfg, params, tcfg, tparams = mixer
    x = _x(cfg, 3, 13, seed=11)
    _, jstate = jmamba.mamba_seq(cfg, params, jnp.asarray(x[:, :10]))
    _, tstate = tmamba.mamba_seq(tcfg, tparams, torch.from_numpy(x[:, :10]))
    for i in range(10, 13):
        jout, jstate = jmamba.mamba_decode(cfg, params, jnp.asarray(x[:, i:i + 1]), jstate)
        tout, tstate = tmamba.mamba_decode(tcfg, tparams, torch.from_numpy(x[:, i:i + 1]),
                                           tstate)
        assert tuple(tout.shape) == (3, 1, cfg.d_model)
        _close(tout.numpy(), jout, MAMBA_TOL)
        for name in ("h", "conv"):
            _close(tstate[name].numpy(), jstate[name], MAMBA_TOL)


def test_decode_continues_the_sequence_form(mixer):
    """Prefix + one decode step equals the sequence form's last output."""
    _, _, tcfg, tparams = mixer
    x = torch.from_numpy(_x(tcfg, 1, 12, seed=2))
    full, _ = tmamba.mamba_seq(tcfg, tparams, x)
    _, state = tmamba.mamba_seq(tcfg, tparams, x[:, :11])
    step, _ = tmamba.mamba_decode(tcfg, tparams, x[:, 11:], state)
    _close(step.numpy(), full[:, 11:].numpy(), MAMBA_TOL)


def test_mamba_decode_rows_do_not_depend_on_the_batch(mixer):
    """The whole decode step runs in fixed row blocks: a row's bits are its
    solo step's."""
    _, _, tcfg, tparams = mixer
    x = torch.from_numpy(_x(tcfg, 3, 9, seed=8))
    _, state = tmamba.mamba_seq(tcfg, tparams, x[:, :8])
    out, new = tmamba.mamba_decode(tcfg, tparams, x[:, 8:], state)
    for i in range(3):
        one = {k: v[i:i + 1] for k, v in state.items()}
        o, n = tmamba.mamba_decode(tcfg, tparams, x[i:i + 1, 8:], one)
        assert torch.equal(o, out[i:i + 1])
        assert all(torch.equal(n[k], new[k][i:i + 1]) for k in n)


@pytest.mark.parametrize("b", [1, 3, 9])
def test_mamba_decode_state_holds_only_its_own_rows(mixer, b):
    """The decode step runs in zero-padded 8-row blocks, but the state it
    returns lies in storage of its own rows: a request's stored ``h`` does
    not keep the padding rows alive."""
    _, _, tcfg, tparams = mixer
    x = torch.from_numpy(_x(tcfg, b, 9, seed=9))
    _, state = tmamba.mamba_seq(tcfg, tparams, x[:, :8])
    out, new = tmamba.mamba_decode(tcfg, tparams, x[:, 8:], state)
    for a in (out, new["h"], new["conv"]):
        assert a.shape[0] == b
        assert a.untyped_storage().nbytes() == a.numel() * a.element_size()


def test_conv_and_gate_helpers_match_jax(mixer):
    cfg, params, tcfg, tparams = mixer
    rng = np.random.default_rng(1)
    u = rng.standard_normal((2, 9, cfg.d_inner)).astype(np.float32)
    _close(tmamba._causal_conv(tparams["conv_x_w"], tparams["conv_x_b"],
                               torch.from_numpy(u)).numpy(),
           jmamba._causal_conv(params["conv_x_w"], params["conv_x_b"], jnp.asarray(u)),
           MAMBA_TOL)
    st = rng.standard_normal((2, cfg.ssm_conv - 1, cfg.d_inner)).astype(np.float32)
    t_out, t_win = tmamba._conv_step(tparams["conv_x_w"], tparams["conv_x_b"],
                                     torch.from_numpy(st), torch.from_numpy(u[:, 0]))
    j_out, j_win = jmamba._conv_step(params["conv_x_w"], params["conv_x_b"],
                                     jnp.asarray(st), jnp.asarray(u[:, 0]))
    _close(t_out.numpy(), j_out, MAMBA_TOL)
    np.testing.assert_array_equal(t_win.numpy(), np.asarray(j_win))
    dt_raw = rng.standard_normal((2, 3, cfg.ssm_heads)).astype(np.float32) * 4
    for got, want in zip(tmamba._gates(tcfg, tparams, torch.from_numpy(dt_raw)),
                         jmamba._gates(cfg, params, jnp.asarray(dt_raw))):
        _close(got.numpy(), want, MAMBA_TOL)
    conv = rng.standard_normal((1, 3, cfg.d_inner + 2 * cfg.ssm_state)).astype(np.float32)
    for got, want in zip(tmamba._split_conv_state(tcfg, torch.from_numpy(conv)),
                         jmamba._split_conv_state(cfg, jnp.asarray(conv))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_layout_equals_jax():
    """Parameter names and shapes, and the decode state's layout, are the
    reference's, so weights and states bridge leaf for leaf."""
    cfg = _cfg()
    tcfg = torch_cfg(cfg)
    jp = jmamba.init_mamba(jax.random.PRNGKey(0), cfg)
    tp = tmamba.init_mamba(torch.Generator().manual_seed(0), tcfg, torch.float32, "cpu")
    assert jax.tree.map(lambda a: a.shape, jp) == \
        {k: ({kk: tuple(vv.shape) for kk, vv in v.items()} if isinstance(v, dict)
             else tuple(v.shape)) for k, v in tp.items()}
    for kinds in (("mamba", "none"), ("attn", "dense")):
        js = jblocks.init_block_cache(cfg, kinds, 2, 12, jnp.float32)
        ts = tblocks.init_block_cache(tcfg, kinds, 2, 12, torch.float32, "cpu")
        assert {k: tuple(v.shape) for k, v in ts.items()} == \
            {k: tuple(v.shape) for k, v in js.items()}
        assert all(str(ts[k].dtype).split(".")[-1] == str(js[k].dtype) for k in ts)
