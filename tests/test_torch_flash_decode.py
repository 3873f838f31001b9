"""The port's flash-decode attention on the host: its plain version against
the JAX package's ``flash_decode_ref`` and its Pallas kernel in interpret
mode, fed the same numpy inputs, and the port's ``attn_decode`` (which
computes through it) against the reference ``attn_decode`` on bridged
weights.  Everything runs in fp32; the packages sum in different orders,
so they agree within 1e-5, not bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import bridge, torch_cfg
from conftest import tiny_dense, tiny_moe
from repro.kernels.flash_decode import flash_decode_kernel as jkernel
from repro.kernels.flash_decode import flash_decode_ref as jref
from repro.models import attention as jattn
from repro.models import init_params as jinit
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.models import attention as tattn

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(b, w, seed, kh=2, g=2, hd=16, fill=0.75):
    """Ring-buffer caches: positions past the window (wrap), unfilled slots
    (kpos = -1), and the slot of ``pos`` itself valid."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kh, g, hd)).astype(np.float32)
    k = rng.standard_normal((b, w, kh, hd)).astype(np.float32)
    v = rng.standard_normal((b, w, kh, hd)).astype(np.float32)
    pos = rng.integers(0, 3 * w, (b,)).astype(np.int32)
    slots = np.arange(w)
    kpos = pos[:, None] - (pos[:, None] - slots[None]) % w
    kpos = np.where((kpos < 0) | (rng.random((b, w)) > fill), -1, kpos).astype(np.int32)
    kpos[np.arange(b), pos % w] = pos
    return q, k, v, kpos, pos


def _port(args, window):
    return flash_decode(*(torch.from_numpy(a) for a in args), window=window).numpy()


CASES = [(1, 8, 0), (2, 24, 0), (3, 40, 0), (2, 40, 7), (3, 33, 16), (1, 5, 3)]


@pytest.mark.parametrize("b,w,window", CASES)
def test_plain_version_matches_jax_ref(b, w, window):
    args = _inputs(b, w, seed=b * 100 + w)
    want = np.asarray(jref(*(jnp.asarray(a) for a in args), window=window))
    np.testing.assert_allclose(_port(args, window), want, **TOL)


@pytest.mark.parametrize("b,w,window", CASES)
def test_plain_version_matches_pallas_kernel_in_interpret_mode(b, w, window):
    """block_w=16 cuts W into several blocks with a ragged last one."""
    args = _inputs(b, w, seed=b * 100 + w + 1)
    want = np.asarray(jkernel(*(jnp.asarray(a) for a in args), window=window, block_w=16,
                              interpret=True))
    np.testing.assert_allclose(_port(args, window), want, **TOL)


def test_plain_version_all_masked_row_follows_jax_ref():
    """A row with no valid slot (never on the decode path) averages V, as
    the reference's softmax over all -1e30 scores does; the card's kernel
    gives 0 there instead."""
    q, k, v, kpos, pos = _inputs(2, 12, seed=3)
    kpos[1] = -1
    args = (q, k, v, kpos, pos)
    want = np.asarray(jref(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(_port(args, 0), want, **TOL)


def test_plain_version_rows_do_not_depend_on_batch_or_masked_tail():
    """What lets a request served in a composed batch, over the loop's
    window, equal its solo decode on the host: a row's bits do not depend
    on the other rows or on masked slots appended to the cache."""
    q, k, v, kpos, pos = _inputs(3, 20, seed=9)
    full = _port((q, k, v, kpos, pos), 6)
    for i in range(3):
        one = _port((q[i:i + 1], k[i:i + 1], v[i:i + 1], kpos[i:i + 1], pos[i:i + 1]), 6)
        np.testing.assert_array_equal(one, full[i:i + 1])
    rng = np.random.default_rng(0)
    grow = rng.standard_normal((3, 9, 2, 16)).astype(np.float32)
    grown = _port((q, np.concatenate([k, grow], 1), np.concatenate([v, grow], 1),
                   np.concatenate([kpos, np.full((3, 9), -1, np.int32)], 1), pos), 6)
    np.testing.assert_array_equal(grown, full)


@pytest.mark.parametrize("maker", [tiny_dense, tiny_moe], ids=["tiny_dense", "tiny_moe"])
def test_attn_decode_matches_jax(maker):
    """Five decode steps of layer 0's attention from a seeded cache, with a
    batch of 3 rows at different positions; outputs within 1e-5 and the
    caches' slot positions equal."""
    cfg = maker()
    params = jinit(cfg, jax.random.PRNGKey(7))
    p0 = jax.tree.map(lambda a: a[0], params["layers"][0])["mixer"]
    tp0, tcfg = bridge(p0), torch_cfg(cfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 9, cfg.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(9, dtype=np.int32), (3, 9)).copy()
    jc = jattn.seed_cache(cfg, p0, jnp.asarray(x), jnp.asarray(positions), 16)
    tc = tattn.seed_cache(tcfg, tp0, torch.from_numpy(x), torch.from_numpy(positions), 16)
    pos = np.array([9, 9, 9], np.int32)
    for _ in range(5):
        xt = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        jo, jc = jattn.attn_decode(cfg, p0, jnp.asarray(xt), jc, jnp.asarray(pos))
        to, tc = tattn.attn_decode(tcfg, tp0, torch.from_numpy(xt), tc, torch.from_numpy(pos))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        pos = pos + np.array([1, 2, 3], np.int32)
