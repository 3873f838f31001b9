"""Card-only tests of the port: the hand-written CUDA grouped FFN, its
packed-weight twin, flash-decode attention, the SSD inter-chunk scan and
the w8a16 matmul against their plain PyTorch versions (and the two FFNs
against each other), their invariances and refusals, the engine on the
card (full-width and packed-resident slots, with prefetch on a side
stream and residency), speculative verify waves and decoding, the
serving loop on the card against solo decoding, attention-only, hybrid
and speculative, and the fleet: multi-slot workers' waves through both
FFN kernels and engines under fault scripts, with and without prefetch.

They skip on a host without CUDA.  This file imports neither JAX nor the
JAX package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import pytest
import torch

from repro_torch.core import (AlignmentPolicy, ChaosExecutor, ExpertStore, ODMoEEngine,
                              WorkerSlots, spec_attn_decode)
from repro_torch.fleet import FaultEvent, FaultInjector, WorkerProfile
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_kernel, flash_decode_ref
from repro_torch.kernels.flash_decode import kernel as flash_lib
from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_kernel, int8_matmul_ref
from repro_torch.kernels.moe_gemm import (grouped_topk_contrib, grouped_topk_contrib_packed,
                                          moe_ffn, moe_ffn_kernel, moe_ffn_packed,
                                          moe_ffn_packed_kernel, moe_ffn_packed_ref,
                                          moe_ffn_ref)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_kernel, ssd_scan_ref
from repro_torch.models import ModelConfig, decode_step, greedy_generate, init_params, prefill
from repro_torch.models import attention as attn_lib
from repro_torch.models.transformer import layer_params, tree_concat
from repro_torch.quant import TieredPolicy, dequantize_tiles, device_layout, get_codec
from repro_torch.serve import KVPool, ServingLoop, make_traffic

pytestmark = pytest.mark.cuda

# fp32 sums in another order than the plain version's matmuls
REL_TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, e, c, d, f, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((e, c, d), generator=g, device=dev)
    wg = (torch.randn((e, d, f), generator=g, device=dev) * d ** -0.5).to(dtype)
    wu = (torch.randn((e, d, f), generator=g, device=dev) * d ** -0.5).to(dtype)
    wd = (torch.randn((e, f, d), generator=g, device=dev) * f ** -0.5).to(dtype)
    return x, wg, wu, wd


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,d,f", [(1, 1, 64, 96), (3, 5, 33, 37), (2, 9, 128, 100),
                                     (4, 16, 256, 640)])
def test_kernel_matches_plain_version(dev, dtype, e, c, d, f):
    """Odd widths take the scalar-load path; F=100 leaves a ragged tile."""
    args = _inputs(dev, e, c, d, f, dtype)
    k = moe_ffn_kernel(*args)
    p = moe_ffn_ref(*args)
    torch.cuda.synchronize()
    assert k.dtype == torch.float32 and k.shape == (e, c, d)
    assert float((k - p).abs().max() / p.abs().max()) <= REL_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_rows_invariant_across_experts_and_rows(dev, dtype):
    x, wg, wu, wd = _inputs(dev, 1, 16, 96, 200, dtype)
    wg, wu, wd = (torch.cat([w] + [w * 0.5] * 7) for w in (wg, wu, wd))
    full = moe_ffn_kernel(x.expand(8, 16, 96).contiguous(), wg, wu, wd)
    for e in (1, 2, 3, 8):
        for c in (1, 2, 5, 16):
            part = moe_ffn_kernel(x[:, :c].expand(e, c, 96).contiguous(),
                                  wg[:e], wu[:e], wd[:e])
            assert torch.equal(part, full[:e, :c])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_misaligned_weights_give_the_same_bits(dev, dtype):
    """Weights that start off a 16-byte boundary take the element-by-
    element load path, which feeds the same sums in the same order."""
    x, wg, wu, wd = _inputs(dev, 2, 3, 64, 128, dtype)

    def shifted(w):
        buf = torch.empty(w.numel() + 1, dtype=dtype, device=dev)
        out = buf[1:].view(w.shape)
        out.copy_(w)
        return out

    moved = [shifted(w) for w in (wg, wu, wd)]
    assert moved[0].data_ptr() % 16 != 0
    assert torch.equal(moe_ffn_kernel(x, *moved), moe_ffn_kernel(x, wg, wu, wd))


# bf16 weights run on tensor cores: rows ride the MMA's N side (padded to 8,
# row tiles of 8/16/32/64), weight columns its M side (tiles of 64), the
# contraction in 256-row segments (split across blocks at small C).  D=320
# is two segments, F=200 a ragged column tile.
@pytest.mark.parametrize("e,c", [(1, 7), (8, 7), (8, 8), (2, 9), (8, 9), (8, 17), (16, 17),
                                 (8, 64), (1, 65), (8, 65)])
def test_bf16_kernel_rows_bitwise_across_row_tiles_and_experts(dev, e, c):
    """Every (row, expert) output equals the E=8 C=65 call's, bit for bit,
    whatever the row padding, the row tile, the expert count or the
    segment split."""
    x, wg, wu, wd = _inputs(dev, 16, 65, 320, 200, torch.bfloat16, seed=3)
    full = moe_ffn_kernel(x[:8].contiguous(), wg[:8], wu[:8], wd[:8])
    if e <= 8:
        want = full[:e, :c]
    else:
        want = moe_ffn_kernel(x[:e, :c].contiguous(), wg[:e], wu[:e], wd[:e])
        assert torch.equal(want[:8], full[:, :c])
    got = moe_ffn_kernel(x[:e, :c].contiguous(), wg[:e], wu[:e], wd[:e])
    assert torch.equal(got, want)
    plain = moe_ffn_ref(x[:e, :c], wg[:e], wu[:e], wd[:e])
    assert float((got - plain).abs().max() / plain.abs().max()) <= REL_TOL


@pytest.mark.parametrize("e,c,d,f", [(16, 3, 128, 96), (2, 5, 200, 136), (3, 4, 72, 520),
                                     (2, 2, 4096, 64), (1, 1, 64, 14336)])
def test_bf16_kernel_widths_off_the_tiles_match_plain_version(dev, e, c, d, f):
    """D and F that are not multiples of the 64-wide tiles or of a segment
    (TMA fills the rest with zeros), 16 experts, and a long contraction."""
    args = _inputs(dev, e, c, d, f, torch.bfloat16, seed=e + c)
    k = moe_ffn_kernel(*args)
    p = moe_ffn_ref(*args)
    torch.cuda.synchronize()
    assert k.shape == (e, c, d) and bool(torch.isfinite(k).all())
    assert float((k - p).abs().max() / p.abs().max()) <= REL_TOL


def test_bf16_kernel_repeats_bitwise_and_rows_do_not_depend_on_their_position(dev):
    """Back-to-back calls (the tile counters reused) give the same bits, and
    a row's output does not depend on its place among the MMA's rows."""
    x, wg, wu, wd = _inputs(dev, 2, 13, 320, 200, torch.bfloat16, seed=7)
    one = moe_ffn_kernel(x, wg, wu, wd)
    assert torch.equal(moe_ffn_kernel(x, wg, wu, wd), one)
    perm = torch.randperm(13, generator=torch.Generator().manual_seed(1)).to(dev)
    moved = moe_ffn_kernel(x[:, perm].contiguous(), wg, wu, wd)
    assert torch.equal(moved, one[:, perm])
    for i in range(13):
        solo = moe_ffn_kernel(x[:, i:i + 1].contiguous(), wg, wu, wd)
        assert torch.equal(solo, one[:, i:i + 1])


def test_kernel_counts_launches_and_moe_ffn_routes_to_it(dev):
    args = _inputs(dev, 2, 1, 64, 64, torch.bfloat16)
    before = moe_ffn_kernel.launches
    moe_ffn(*args)
    grouped_topk_contrib(args[0][0], *args[1:],
                         torch.tensor([[0, 1]], device=dev),
                         torch.tensor([[0.5, 0.5]], device=dev))
    assert moe_ffn_kernel.launches == before + 2


def test_kernel_refuses_bad_inputs(dev):
    x, wg, wu, wd = _inputs(dev, 2, 3, 64, 96, torch.bfloat16)
    with pytest.raises(TypeError):
        moe_ffn_kernel(x, wg.half(), wu.half(), wd.half())
    with pytest.raises(TypeError):
        moe_ffn_kernel(x.double(), wg, wu, wd)
    with pytest.raises(TypeError):
        moe_ffn_kernel(x, wg, wu.float(), wd)
    with pytest.raises(ValueError):
        moe_ffn_kernel(x, wg.transpose(1, 2), wu, wd)
    with pytest.raises(ValueError):
        moe_ffn_kernel(x, wg[:1], wu, wd)
    with pytest.raises(ValueError):
        moe_ffn_kernel(x.cpu(), wg, wu, wd)


# fp32 weights and the packed formats share the staged CUDA-core passes:
# column tiles of one 512-byte run of a weight row (128 fp32, 256 fp16, 512
# int8, 1024 nf4 columns), 32-row stages, 256-row segments cut across work
# units at small C and folded by the unit that draws a tile's last ticket,
# row tiles of 1, up to 4, or the format's largest (16 for fp32) rows.  These
# widths are off the column tile, the segment and the stage (D=72 is two
# stages and one ragged segment; D=4096 F=64 sixteen segments of one narrow
# tile; F=576 a ragged nf4 tile whose absmax rows are not whole 16-byte
# runs); C in {1, 7, 17, 65} crosses every row tile; E up to 16.
EDGE_WIDTHS = [(320, 200), (72, 520), (4096, 64), (320, 576)]


@pytest.mark.parametrize("d,f", EDGE_WIDTHS)
def test_fp32_kernel_rows_bitwise_across_row_tiles_and_experts(dev, d, f):
    """Every (row, expert) output of the fp32 path equals the E=16 C=65
    call's, bit for bit, whatever the row tile, the expert count or the
    segment split; back-to-back calls (the tile counters reused) repeat
    it."""
    x, wg, wu, wd = _inputs(dev, 16, 65, d, f, torch.float32, seed=d + f)
    full = moe_ffn_kernel(x, wg, wu, wd)
    assert torch.equal(moe_ffn_kernel(x, wg, wu, wd), full)
    for e in (1, 2, 8, 16):
        for c in (1, 7, 17, 65):
            got = moe_ffn_kernel(x[:e, :c].contiguous(), wg[:e], wu[:e], wd[:e])
            assert torch.equal(got, full[:e, :c]), (e, c)
    plain = moe_ffn_ref(x[:2, :17], wg[:2], wu[:2], wd[:2])
    assert float((full[:2, :17] - plain).abs().max() / plain.abs().max()) <= REL_TOL


PACKED_EDGES = [(s, d, f) for d, f in EDGE_WIDTHS for s in ("fp16", "int8", "nf4")
                if s != "nf4" or (d % 64 == 0 and f % 64 == 0)]


@pytest.mark.parametrize("scheme,d,f", PACKED_EDGES)
def test_packed_kernel_at_the_passes_edges_equals_kernel1(dev, scheme, d, f):
    """At the same edges the packed kernel equals kernel 1 on the
    dequantized weights bit for bit, its rows do not depend on E or C, and
    back-to-back calls repeat it."""
    parts = _packed(dev, scheme, 16, d, f, seed=d * 7 + f)
    x = torch.randn((16, 65, d), generator=torch.Generator(device=dev).manual_seed(f),
                    device=dev)
    full = moe_ffn_packed_kernel(x, parts, scheme=scheme)
    assert torch.equal(full, moe_ffn_kernel(x, *_full(scheme, parts)))
    assert torch.equal(moe_ffn_packed_kernel(x, parts, scheme=scheme), full)
    for e in (1, 2, 8):
        sub = {n: tuple(p[:e] for p in ps) for n, ps in parts.items()}
        for c in (1, 7, 17):
            got = moe_ffn_packed_kernel(x[:e, :c].contiguous(), sub, scheme=scheme)
            assert torch.equal(got, full[:e, :c]), (e, c)


@pytest.mark.parametrize("predictor", ["sep", "nextgate", "freq", "random", "none"])
def test_engine_on_the_card_equals_greedy(dev, predictor):
    cfg = ModelConfig(name="t-moe", family="moe", num_layers=4, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=0, d_expert=96,
                      vocab_size=97, num_experts=8, top_k=2)
    params = init_params(cfg, seed=3, device=dev)
    batch = {"tokens": torch.randint(0, 97, (1, 12), generator=torch.Generator()
                                     .manual_seed(4), dtype=torch.int32).to(dev)}
    before = moe_ffn_kernel.launches
    eng = ODMoEEngine(cfg, params, predictor=predictor, device=dev)
    toks, _ = eng.generate(batch, 8)
    assert moe_ffn_kernel.launches > before
    assert torch.equal(toks, greedy_generate(cfg, params, batch, 8))


# ------------------------------------------------------ packed-weight kernel
NAMES = ("w_gate", "w_up", "w_down")


def _packed(dev, scheme, e, d, f, seed=0):
    """Stacked device-layout parts of e random experts, packed on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    parts = {}
    for name, shape in (("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d))):
        per = [device_layout(get_codec(scheme).pack(
            torch.randn(shape, generator=g, device=dev) * shape[0] ** -0.5)) for _ in range(e)]
        parts[name] = tuple(torch.stack([p[j] for p in per]) for j in range(len(per[0])))
    return parts


def _full(scheme, parts):
    return [dequantize_tiles(scheme, parts[n]).contiguous() for n in NAMES]


SHAPES = [(1, 1, 64, 128), (3, 5, 128, 320), (2, 9, 64, 576), (4, 16, 256, 640)]


# nf4 needs 64-aligned widths (its refusal is tested below); fp16 and int8
# also take widths that are not whole runs, read element by element
CASES = ([(s, shape) for s in ("fp16", "int8", "nf4") for shape in SHAPES]
         + [(s, shape) for s in ("fp16", "int8") for shape in ((2, 3, 40, 100), (1, 2, 33, 37))])


@pytest.mark.parametrize("scheme,shape", CASES)
def test_packed_kernel_bit_equals_kernel1_and_matches_plain(dev, scheme, shape):
    """In-register dequantization is exact and the sums are kernel 1's:
    the packed kernel equals kernel 1 on the dequantized weights bit for
    bit, and its plain version within fp32 tolerance."""
    e, c, d, f = shape
    parts = _packed(dev, scheme, e, d, f, seed=e * 31 + c)
    x = torch.randn((e, c, d), generator=torch.Generator(device=dev).manual_seed(c), device=dev)
    got = moe_ffn_packed_kernel(x, parts, scheme=scheme)
    want = moe_ffn_kernel(x, *_full(scheme, parts))
    plain = moe_ffn_packed_ref(x, parts, scheme=scheme)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (e, c, d)
    assert torch.equal(got, want)
    assert float((got - plain).abs().max() / plain.abs().max()) <= REL_TOL


@pytest.mark.parametrize("scheme", ["fp16", "int8", "nf4"])
def test_packed_kernel_rows_invariant_across_experts_and_rows(dev, scheme):
    parts = _packed(dev, scheme, 8, 128, 192, seed=5)
    x = torch.randn((1, 16, 128), generator=torch.Generator(device=dev).manual_seed(6),
                    device=dev)
    full = moe_ffn_packed_kernel(x.expand(8, 16, 128).contiguous(), parts, scheme=scheme)
    for e in (1, 2, 3, 8):
        sub = {n: tuple(p[:e] for p in ps) for n, ps in parts.items()}
        for c in (1, 2, 5, 16):
            got = moe_ffn_packed_kernel(x[:, :c].expand(e, c, 128).contiguous(), sub,
                                        scheme=scheme)
            assert torch.equal(got, full[:e, :c])


@pytest.mark.parametrize("scheme", ["fp16", "int8", "nf4"])
def test_packed_kernel_misaligned_codes_give_the_same_bits(dev, scheme):
    """Codes that start off a 16-byte boundary take the element-by-element
    loads, which feed the same values to the same sums."""
    parts = _packed(dev, scheme, 2, 64, 128, seed=9)
    x = torch.randn((2, 3, 64), generator=torch.Generator(device=dev).manual_seed(1), device=dev)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    moved = {n: (shifted(ps[0]),) + ps[1:] for n, ps in parts.items()}
    assert moved["w_gate"][0].data_ptr() % 16 != 0
    assert torch.equal(moe_ffn_packed_kernel(x, moved, scheme=scheme),
                       moe_ffn_packed_kernel(x, parts, scheme=scheme))


def test_packed_kernel_counts_launches_and_ops_route_to_it(dev):
    parts = _packed(dev, "int8", 2, 64, 128)
    x = torch.randn((2, 1, 64), device=dev)
    before, before1 = moe_ffn_packed_kernel.launches, moe_ffn_kernel.launches
    moe_ffn_packed(x, parts, scheme="int8")
    grouped_topk_contrib_packed(x[0], parts, torch.tensor([[0, 1]], device=dev),
                                torch.tensor([[0.5, 0.5]], device=dev), scheme="int8")
    assert moe_ffn_packed_kernel.launches == before + 2
    full = {n: (w,) for n, w in zip(NAMES, _full("int8", parts))}
    moe_ffn_packed(x, full, scheme="fp32")      # full-width parts: kernel 1
    assert moe_ffn_kernel.launches == before1 + 1
    assert moe_ffn_packed_kernel.launches == before + 2


def test_packed_kernel_refuses_bad_inputs(dev):
    parts = _packed(dev, "nf4", 2, 64, 128)
    x = torch.randn((2, 3, 64), device=dev)
    with pytest.raises(ValueError, match="aligned"):
        moe_ffn_packed_kernel(torch.randn((2, 3, 32), device=dev),
                              {n: (ps[0][..., :16], ps[1][..., :1]) for n, ps in parts.items()},
                              scheme="nf4")
    with pytest.raises(ValueError, match="no packed kernel"):
        moe_ffn_packed_kernel(x, parts, scheme="int4")
    with pytest.raises(TypeError):
        moe_ffn_packed_kernel(x.double(), parts, scheme="nf4")
    with pytest.raises(TypeError):
        moe_ffn_packed_kernel(x, {**parts, "w_up": (parts["w_up"][0].to(torch.int8),
                                                    parts["w_up"][1])}, scheme="nf4")
    with pytest.raises(ValueError):
        moe_ffn_packed_kernel(x, {**parts, "w_down": parts["w_down"][:1]}, scheme="nf4")
    with pytest.raises(ValueError):
        moe_ffn_packed_kernel(x, {**parts, "w_gate": (parts["w_gate"][0][:1],
                                                      parts["w_gate"][1][:1])}, scheme="nf4")
    with pytest.raises(ValueError):
        moe_ffn_packed_kernel(x, {**parts, "w_gate": (parts["w_gate"][0].transpose(1, 2)
                                                      .contiguous().transpose(1, 2),
                                                      parts["w_gate"][1])}, scheme="nf4")
    with pytest.raises(ValueError):
        moe_ffn_packed_kernel(x.cpu(), parts, scheme="nf4")
    i8 = _packed(dev, "int8", 2, 64, 128)
    with pytest.raises(TypeError):
        moe_ffn_packed_kernel(x, {**i8, "w_gate": (i8["w_gate"][0], i8["w_gate"][1].half())},
                              scheme="int8")


@pytest.mark.parametrize("transport", ["int8", "nf4", "fp16", "tiered"])
def test_packed_engine_on_the_card_equals_greedy(dev, transport):
    cfg = ModelConfig(name="t-moe", family="moe", num_layers=3, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=0, d_expert=128,
                      vocab_size=97, num_experts=8, top_k=2)
    params = init_params(cfg, seed=3, device=dev)
    if transport == "tiered":
        transport = TieredPolicy(low_experts=[(li, e) for li in range(3) for e in range(0, 8, 2)])
    batch = {"tokens": torch.randint(0, 97, (1, 12), generator=torch.Generator()
                                     .manual_seed(4), dtype=torch.int32).to(dev)}
    before = moe_ffn_packed_kernel.launches
    eng = ODMoEEngine(cfg, params, predictor="sep", device=dev, transport=transport,
                      packed_slots=True)
    toks, _ = eng.generate(batch, 8)
    assert moe_ffn_packed_kernel.launches > before
    assert torch.equal(toks, greedy_generate(cfg, params, batch, 8, transport=transport))
    assert eng.slots.transient_packed_bytes() == 0
    assert eng.memory_report()["per_worker_bytes"] < eng.store.expert_bytes


# ------------------------------------------------------------ flash decode
def _flash(dev, b, w, kh, g, hd, dtype, seed=0):
    """Ring-buffer caches: wrapped positions, unfilled slots, and the slot
    of ``pos`` itself always valid."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, kh, g, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, w, kh, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, w, kh, hd), generator=gen, device=dev).to(dtype)
    pos = torch.randint(0, 3 * w, (b,), generator=gen, device=dev, dtype=torch.int32)
    slots = torch.arange(w, device=dev)
    kpos = pos[:, None] - (pos[:, None] - slots[None]) % w
    kpos = torch.where(kpos < 0, -1, kpos)
    kpos = torch.where(torch.rand((b, w), generator=gen, device=dev) > 0.75, -1, kpos)
    kpos = kpos.to(torch.int32)
    kpos[torch.arange(b, device=dev), (pos % w).long()] = pos
    return q, k, v, kpos.contiguous(), pos


FLASH = [(1, 7, 2, 2, 16), (3, 40, 2, 2, 16), (2, 300, 8, 4, 128), (4, 600, 2, 5, 24),
         (2, 1030, 4, 1, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,w,kh,g,hd", FLASH)
@pytest.mark.parametrize("window", [0, 5])
def test_flash_kernel_matches_plain_version(dev, dtype, b, w, kh, g, hd, window):
    """Head widths below or not a multiple of 32 (Hd=16, 24) leave a lane
    idle in the last column group, and W=300, 600, 1030 end in a partial
    256-slot chunk."""
    args = _flash(dev, b, w, kh, g, hd, dtype)
    o = flash_decode_kernel(*args, window=window)
    p = flash_decode_ref(*args, window=window)
    torch.cuda.synchronize()
    assert o.dtype == torch.float32 and o.shape == (b, kh, g, hd)
    assert float((o - p).abs().max() / p.abs().max()) <= REL_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_rows_do_not_depend_on_batch_or_masked_tail(dev, dtype):
    q, k, v, kpos, pos = _flash(dev, 5, 700, 8, 4, 128, dtype)
    full = flash_decode_kernel(q, k, v, kpos, pos, window=300)
    for i in range(5):
        one = flash_decode_kernel(q[i:i + 1], k[i:i + 1], v[i:i + 1], kpos[i:i + 1],
                                  pos[i:i + 1], window=300)
        assert torch.equal(one, full[i:i + 1])
    for extra in (1, 100, 2 * flash_lib.LIBRARY.lib.flash_decode_chunk() + 3):
        noise = torch.randn((5, extra, 8, 128), device=dev).to(dtype)
        grown = flash_decode_kernel(q, torch.cat([k, noise], 1), torch.cat([v, noise], 1),
                                    torch.cat([kpos, torch.full((5, extra), -1, dtype=torch.int32,
                                                                device=dev)], 1),
                                    pos, window=300)
        assert torch.equal(grown, full)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_windows_around_one_chunk(dev, dtype):
    """W of 1, chunk - 1, chunk and chunk + 1 slots: within tolerance, each
    row equal to its own launch, and equal when W grows by masked slots."""
    chunk = flash_lib.LIBRARY.lib.flash_decode_chunk()
    for w in (1, chunk - 1, chunk, chunk + 1):
        q, k, v, kpos, pos = _flash(dev, 3, w, 8, 4, 128, dtype, seed=w)
        o = flash_decode_kernel(q, k, v, kpos, pos)
        p = flash_decode_ref(q, k, v, kpos, pos)
        torch.cuda.synchronize()
        assert float((o - p).abs().max() / p.abs().max()) <= REL_TOL, w
        for i in range(3):
            assert torch.equal(flash_decode_kernel(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                                   kpos[i:i + 1], pos[i:i + 1]), o[i:i + 1])
        extra = chunk + 5
        noise = torch.randn((3, extra, 8, 128), device=dev).to(dtype)
        pad = torch.full((3, extra), -1, dtype=torch.int32, device=dev)
        grown = flash_decode_kernel(q, torch.cat([k, noise], 1), torch.cat([v, noise], 1),
                                    torch.cat([kpos, pad], 1), pos)
        assert torch.equal(grown, o), w


def test_flash_kernel_repeats_bitwise_on_its_reused_scratch(dev):
    """The workspace and the ticket counters are reused by every launch on
    a stream: repeated launches, with other shapes in between, give the
    same bits, and so do launches after the cache is released and a
    smaller pair is allocated first."""
    big = _flash(dev, 4, 3000, 8, 4, 128, torch.bfloat16, seed=1)
    small = _flash(dev, 2, 70, 8, 4, 128, torch.bfloat16, seed=2)
    first_big = flash_decode_kernel(*big)
    first_small = flash_decode_kernel(*small)
    for _ in range(3):
        assert torch.equal(flash_decode_kernel(*big), first_big)
        assert torch.equal(flash_decode_kernel(*small), first_small)
        assert torch.equal(flash_decode_kernel(*big, window=100),
                           flash_decode_kernel(*big, window=100))
    flash_lib.release_scratch()
    assert torch.equal(flash_decode_kernel(*small), first_small)
    assert torch.equal(flash_decode_kernel(*big), first_big)


def test_flash_kernel_launches_on_two_streams(dev):
    """A launch on a second stream right after one on the first: each has
    its own workspace and counters, and both give the default stream's
    bits."""
    args = _flash(dev, 4, 5000, 8, 4, 128, torch.bfloat16, seed=4)
    want = flash_decode_kernel(*args)
    s1, s2 = torch.cuda.Stream(device=dev), torch.cuda.Stream(device=dev)
    s1.wait_stream(torch.cuda.current_stream(dev))
    s2.wait_stream(torch.cuda.current_stream(dev))
    outs = []
    for _ in range(4):
        with torch.cuda.stream(s1):
            outs.append(flash_decode_kernel(*args))
        with torch.cuda.stream(s2):
            outs.append(flash_decode_kernel(*args))
    torch.cuda.synchronize()
    for o in outs:
        assert torch.equal(o, want)


def test_flash_kernel_counts_launches_and_gives_zero_on_an_empty_row(dev):
    q, k, v, kpos, pos = _flash(dev, 2, 40, 2, 2, 16, torch.float32)
    kpos[1] = -1
    before = flash_decode_kernel.launches
    out = flash_decode(q, k, v, kpos, pos)
    assert flash_decode_kernel.launches == before + 1
    assert torch.equal(out[1], torch.zeros_like(out[1]))


def test_flash_kernel_refuses_bad_inputs(dev):
    q, k, v, kpos, pos = _flash(dev, 2, 40, 2, 2, 16, torch.bfloat16)
    with pytest.raises(ValueError):
        flash_decode_kernel(q.cpu(), k.cpu(), v.cpu(), kpos.cpu(), pos.cpu())
    with pytest.raises(TypeError):
        flash_decode_kernel(q.half(), k.half(), v.half(), kpos, pos)
    with pytest.raises(TypeError):
        flash_decode_kernel(q, k.float(), v, kpos, pos)
    with pytest.raises(TypeError):
        flash_decode_kernel(q, k, v, kpos.long(), pos)
    with pytest.raises(ValueError):
        flash_decode_kernel(q, k.transpose(0, 1).contiguous().transpose(0, 1), v, kpos, pos)
    with pytest.raises(ValueError):
        flash_decode_kernel(q, k[:, :30], v, kpos, pos)
    with pytest.raises(ValueError):
        flash_decode_kernel(torch.zeros((2, 2, 17, 16), dtype=q.dtype, device=dev), k, v,
                            kpos, pos)
    with pytest.raises(NotImplementedError):
        flash_decode(q, k, v, kpos, pos, soft_cap=30.0)


def test_soft_cap_config_raises_on_the_card(dev):
    cfg = ModelConfig(name="t-cap", family="dense", num_layers=1, d_model=64, num_heads=4,
                      num_kv_heads=2, d_ff=128, vocab_size=97, logit_soft_cap=30.0)
    params = init_params(cfg, seed=0, device=dev)
    mixer = {k: v[0] for k, v in params["layers"][0]["mixer"].items()}
    cache = attn_lib.init_cache(cfg, 1, 8, torch.float32, dev)
    with pytest.raises(NotImplementedError):
        attn_lib.attn_decode(cfg, mixer, torch.ones(1, 1, 64, device=dev), cache,
                             torch.tensor([0], dtype=torch.int32, device=dev))


@pytest.mark.parametrize("paged", [False, True])
def test_served_tokens_equal_solo_greedy_on_the_card(dev, paged):
    """Composed batches, deferral and preemption are scheduling: every
    request's tokens equal its solo decode on the card."""
    cfg = ModelConfig(name="t-moe", family="moe", num_layers=4, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=0, d_expert=96,
                      vocab_size=97, num_experts=8, top_k=2)
    params = init_params(cfg, seed=5, device=dev)
    reqs = make_traffic(cfg, 6, 0.0, prompt_len=24, max_new=8, seed=2)
    pool = None
    if paged:
        window = max(len(r.prompt) + r.max_new_tokens for r in reqs) + 2
        pool = KVPool(cfg, num_pages=-(-window // 4) * 4 // 2, page_tokens=4, device=dev)
    before = flash_decode_kernel.launches
    eng = ODMoEEngine(cfg, params, predictor="sep", device=dev)
    res = ServingLoop(eng, max_batch=4, kv_pool=pool).run(reqs)
    assert flash_decode_kernel.launches > before
    assert res.mean_batch > 1
    if paged:
        assert res.kv_stats["preemptions"] >= 1
    for r in reqs:
        solo = greedy_generate(cfg, params, {"tokens": torch.as_tensor(r.prompt, device=dev)
                                             [None, :]}, r.max_new_tokens)
        assert solo[0].cpu().tolist() == res.outputs[r.rid].tolist(), r.rid


# ------------------------------------------------------------------ ssd scan
SSD = [(1, 1, 128, 64, 128), (1, 4, 128, 64, 128), (4, 8, 128, 64, 128),
       (2, 5, 3, 5, 12)]            # a head shorter than a block: ragged float4 tail


def _ssd(dev, b, nc, h, p, n, with_h0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    s = torch.randn((b, nc, h, p, n), generator=g, device=dev)
    decay = torch.rand((b, nc, h), generator=g, device=dev) * 0.7 + 0.3
    h0 = torch.randn((b, h, p, n), generator=g, device=dev) if with_h0 else None
    return s, decay, h0


@pytest.mark.parametrize("shape", SSD)
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_kernel_bitwise_equals_plain_version(dev, shape, with_h0):
    s, decay, h0 = _ssd(dev, *shape, with_h0)
    k_in, k_last = ssd_scan_kernel(s, decay, h0)
    p_in, p_last = ssd_scan_ref(s, decay, h0)
    torch.cuda.synchronize()
    assert k_in.shape == shape and k_last.shape == (shape[0],) + shape[2:]
    assert torch.equal(k_in, p_in) and torch.equal(k_last, p_last)


def test_ssd_kernel_rows_equal_their_own_launch(dev):
    s, decay, h0 = _ssd(dev, 4, 6, 16, 8, 16, True, seed=1)
    k_in, k_last = ssd_scan_kernel(s, decay, h0)
    for i in range(4):
        one_in, one_last = ssd_scan_kernel(s[i:i + 1].contiguous(), decay[i:i + 1].contiguous(),
                                           h0[i:i + 1].contiguous())
        assert torch.equal(one_in, k_in[i:i + 1]) and torch.equal(one_last, k_last[i:i + 1])


def test_ssd_kernel_refuses_what_float4_cannot_move(dev):
    """The kernel moves float4s: P*N not a multiple of 4 and a misaligned
    pointer raise before any launch."""
    before = ssd_scan_kernel.launches
    s, decay, _ = _ssd(dev, 2, 5, 3, 5, 7, False)
    with pytest.raises(ValueError):
        ssd_scan_kernel(s, decay)
    s, decay, h0 = _ssd(dev, 1, 4, 6, 8, 16, True, seed=2)
    shifted = torch.empty(s.numel() + 1, device=dev)[1:].view(s.shape)
    shifted.copy_(s)
    assert shifted.data_ptr() % 16 != 0
    with pytest.raises(ValueError):
        ssd_scan_kernel(shifted, decay)
    h0_shifted = torch.empty(h0.numel() + 1, device=dev)[1:].view(h0.shape)
    h0_shifted.copy_(h0)
    with pytest.raises(ValueError):
        ssd_scan_kernel(s, decay, h0_shifted)
    assert ssd_scan_kernel.launches == before


def test_ssd_kernel_counts_launches_and_ssd_scan_routes_to_it(dev):
    s, decay, _ = _ssd(dev, 1, 3, 4, 8, 8, False)
    before = ssd_scan_kernel.launches
    h_in, h_last = ssd_scan(s, decay)
    assert ssd_scan_kernel.launches == before + 1
    assert torch.equal(h_last, ssd_scan_ref(s, decay)[1])
    ssd_scan(s.cpu(), decay.cpu())                     # the host's plain path
    assert ssd_scan_kernel.launches == before + 1


def test_ssd_kernel_refuses_bad_inputs(dev):
    s, decay, h0 = _ssd(dev, 2, 3, 4, 8, 8, True)
    with pytest.raises(ValueError):
        ssd_scan_kernel(s.cpu(), decay.cpu())
    with pytest.raises(TypeError):
        ssd_scan_kernel(s.double(), decay)
    with pytest.raises(TypeError):
        ssd_scan_kernel(s, decay.half())
    with pytest.raises(ValueError):
        ssd_scan_kernel(s.transpose(3, 4).contiguous().transpose(3, 4), decay)
    with pytest.raises(ValueError):
        ssd_scan_kernel(s, decay[:, :2])
    with pytest.raises(ValueError):
        ssd_scan_kernel(s, decay, h0[:1])
    with pytest.raises(ValueError):
        ssd_scan_kernel(s[:, :0], decay[:, :0])


HYBRID = ModelConfig(name="t-hybrid", family="hybrid", num_layers=8, d_model=64, num_heads=4,
                     num_kv_heads=2, d_ff=128, d_expert=96, vocab_size=97, num_experts=8,
                     top_k=2, moe_every=2, moe_offset=1, ssm_state=16, ssm_head_dim=16,
                     ssm_chunk=8, attn_every=8, attn_offset=4)


def test_hybrid_composed_decode_rows_equal_solo_rows_on_the_card(dev):
    """Mamba and attention decode run their row-local work in fixed row
    blocks: a composed step gives each row the bits of its solo step."""
    params = init_params(HYBRID, seed=3, device=dev)
    prompts = [torch.randint(0, 97, (1, n), generator=torch.Generator().manual_seed(n),
                             dtype=torch.int32).to(dev) for n in (9, 21, 14)]
    before = ssd_scan_kernel.launches
    states = [prefill(HYBRID, params, {"tokens": t}, 32, moe_method="grouped")[1]
              for t in prompts]
    assert ssd_scan_kernel.launches > before
    token = torch.tensor([5, 17, 40], dtype=torch.int32, device=dev)
    solo = [decode_step(HYBRID, params, token[i:i + 1], st)[0] for i, st in enumerate(states)]
    pattern, _ = HYBRID.pattern()            # caches: (R, B, ...) per pattern position
    composed = {"caches": tuple(tree_concat([st["caches"][p] for st in states], dim=1)
                                for p in range(len(pattern))),
                "pos": torch.cat([st["pos"] for st in states])}
    logits, _ = decode_step(HYBRID, params, token, composed)
    for i in range(3):
        assert torch.equal(logits[i:i + 1], solo[i]), i


def test_hybrid_served_tokens_equal_solo_greedy_on_the_card(dev):
    """A hybrid model through a paged pool that preempts: every request's
    tokens equal its solo decode on the card."""
    params = init_params(HYBRID, seed=5, device=dev)
    reqs = make_traffic(HYBRID, 5, 0.0, prompt_len=20, max_new=6, seed=1)
    window = max(len(r.prompt) + r.max_new_tokens for r in reqs) + 2
    pool = KVPool(HYBRID, num_pages=-(-window // 4) * 4 // 2, page_tokens=4, device=dev)
    before = ssd_scan_kernel.launches
    eng = ODMoEEngine(HYBRID, params, predictor="sep", device=dev)
    res = ServingLoop(eng, max_batch=4, kv_pool=pool).run(reqs)
    assert ssd_scan_kernel.launches > before
    assert res.mean_batch > 1 and res.kv_stats["preemptions"] >= 1
    for r in reqs:
        solo = greedy_generate(HYBRID, params, {"tokens": torch.as_tensor(r.prompt, device=dev)
                                                [None, :]}, r.max_new_tokens)
        assert solo[0].cpu().tolist() == res.outputs[r.rid].tolist(), r.rid


# --------------------------------------------------------------- int8 matmul
# the shapes of tests/test_kernels.py::test_int8_matmul_sweep and the
# Mixtral-8x7B expert matrices, at M in {1, 4, 8}
INT8 = ([(32, 128, 64), (64, 256, 96), (13, 70, 33), (1, 70, 33), (8, 70, 33)]
        + [(m, k, n) for m in (1, 4, 8) for k, n in ((4096, 14336), (14336, 4096))])


def _int8(dev, m, k, n, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    wq = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    sc = torch.rand((n,), generator=g, device=dev) * 9e-3 + 1e-3
    return x, wq, sc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", INT8)
def test_int8_kernel_matches_plain_version_and_repeats_bitwise(dev, m, k, n, dtype):
    x, wq, sc = _int8(dev, m, k, n, dtype, seed=m + k + n)
    got = int8_matmul_kernel(x, wq, sc)
    want = int8_matmul_ref(x, wq, sc)
    torch.cuda.synchronize()
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= REL_TOL * float(want.abs().max())
    assert torch.equal(int8_matmul_kernel(x, wq, sc), got)


def test_int8_kernel_misaligned_or_odd_weights_take_the_scalar_path(dev):
    """A weight pointer off its 4-byte alignment reads byte by byte and
    gives the same bits as the char4 loads."""
    x, wq, sc = _int8(dev, 4, 300, 128, torch.float32, seed=5)
    shifted = torch.empty(wq.numel() + 1, dtype=torch.int8, device=dev)[1:].view(wq.shape)
    shifted.copy_(wq)
    assert shifted.data_ptr() % 4 != 0
    assert torch.equal(int8_matmul_kernel(x, shifted, sc), int8_matmul_kernel(x, wq, sc))


def test_int8_kernel_counts_launches_and_the_op_routes_to_it(dev):
    x, wq, sc = _int8(dev, 3, 64, 40, torch.bfloat16)
    before = int8_matmul_kernel.launches
    out = int8_matmul(x, wq, sc)
    assert int8_matmul_kernel.launches == before + 1
    assert torch.equal(out, int8_matmul_kernel(x, wq, sc))
    int8_matmul(x.cpu(), wq.cpu(), sc.cpu())          # the host's plain path
    assert int8_matmul_kernel.launches == before + 2


def test_int8_kernel_refuses_bad_inputs(dev):
    x, wq, sc = _int8(dev, 3, 64, 40, torch.float32)
    before = int8_matmul_kernel.launches
    with pytest.raises(ValueError):
        int8_matmul_kernel(x.cpu(), wq.cpu(), sc.cpu())
    with pytest.raises(TypeError):
        int8_matmul_kernel(x.half(), wq, sc)
    with pytest.raises(TypeError):
        int8_matmul_kernel(x, wq.int(), sc)
    with pytest.raises(TypeError):
        int8_matmul_kernel(x, wq, sc.double())
    with pytest.raises(ValueError):
        int8_matmul_kernel(x, wq[:32], sc)
    with pytest.raises(ValueError):
        int8_matmul_kernel(x, wq.t().contiguous().t(), sc)
    with pytest.raises(ValueError):
        int8_matmul_kernel(x[:0], wq, sc)
    assert int8_matmul_kernel.launches == before


def _bits(a):
    return a.view(torch.int32)


@pytest.mark.parametrize("k,n", [(4096, 14336), (14336, 4096)])
@pytest.mark.parametrize("m", [13, 8])
def test_int8_kernel_rows_equal_their_own_single_row_launch(dev, m, k, n):
    """A segment's sums and their fold depend on K alone: a row's bits do
    not depend on M, the row tile or the other rows."""
    x, wq, sc = _int8(dev, m, k, n, torch.float32, seed=m + 1)
    full = int8_matmul_kernel(x, wq, sc)
    for i in range(m):
        assert torch.equal(_bits(int8_matmul_kernel(x[i:i + 1], wq, sc)), _bits(full[i:i + 1])), i


@pytest.mark.parametrize("m,k,n", [(1, 4096, 14336), (4, 14336, 4096), (13, 4096, 14336),
                                   (5, 70, 33), (3, 5000, 160)])
def test_int8_kernel_bf16_x_gives_the_bits_of_fp32_x(dev, m, k, n):
    x, wq, sc = _int8(dev, m, k, n, torch.bfloat16, seed=k)
    assert torch.equal(_bits(int8_matmul_kernel(x, wq, sc)),
                       _bits(int8_matmul_kernel(x.float(), wq, sc)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(4, 700, 4096), (2, 1500, 528), (3, 2500, 160),
                                   (4, 3500, 1040), (4, 4100, 256), (4, 16385, 256),
                                   (4, 1, 4096), (1, 1, 16), (5, 4096, 33), (4, 14336, 100),
                                   (17, 600, 48)])
def test_int8_kernel_ragged_segments_one_row_of_k_and_narrow_n(dev, m, k, n, dtype):
    """K off the segment length (2, 3, 5 and 7 segments of 512 rows: clusters
    of 2, 3, 5 and 7 blocks; 9 and 31 segments of 512 and 544 rows: clusters
    of 3 and 8 blocks of four segments, the last with idle slots), K = 1, N
    below one column tile, two row tiles."""
    x, wq, sc = _int8(dev, m, k, n, dtype, seed=m + k + n)
    got = int8_matmul_kernel(x, wq, sc)
    want = int8_matmul_ref(x, wq, sc)
    torch.cuda.synchronize()
    assert got.shape == (m, n)
    assert float((got - want).abs().max()) <= REL_TOL * float(want.abs().max())


def test_int8_kernel_many_row_tiles_at_mixtral_width(dev):
    x, wq, sc = _int8(dev, 64, 4096, 14336, torch.float32, seed=64)
    got = int8_matmul_kernel(x, wq, sc)
    want = int8_matmul_ref(x, wq, sc)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= REL_TOL * float(want.abs().max())
    assert torch.equal(_bits(int8_matmul_kernel(x[40:41], wq, sc)), _bits(got[40:41]))


def test_int8_kernel_more_row_tiles_than_the_grid_spreads(dev):
    """Past 65535 row tiles of 16 a cluster walks several row tiles."""
    m = 16 * 65535 + 5
    x, wq, sc = _int8(dev, m, 8, 16, torch.float32, seed=2)
    got = int8_matmul_kernel(x, wq, sc)
    want = int8_matmul_ref(x, wq, sc)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= REL_TOL * float(want.abs().max())
    for i in (0, 16 * 65535 - 1, 16 * 65535, m - 1):
        assert torch.equal(_bits(int8_matmul_kernel(x[i:i + 1], wq, sc)), _bits(got[i:i + 1]))


def _offset(t, nbytes):
    """A copy of t whose data starts `nbytes` past a 16-byte boundary."""
    step = t.element_size()
    buf = torch.empty(t.numel() + nbytes // step, dtype=t.dtype, device=t.device)
    out = buf[nbytes // step:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == nbytes % 16
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(4, 4096, 14336), (4, 14336, 4096), (13, 700, 256)])
def test_int8_kernel_element_staging_gives_the_tensor_copy_bits(dev, m, k, n, dtype):
    """Codes or x off a 16-byte boundary are staged element by element into
    the tensor copies' layout: the same sums, bit for bit."""
    x, wq, sc = _int8(dev, m, k, n, dtype, seed=9)
    bulk = int8_matmul_kernel(x, wq, sc)
    assert torch.equal(_bits(int8_matmul_kernel(x, _offset(wq, 4), sc)), _bits(bulk))
    assert torch.equal(_bits(int8_matmul_kernel(_offset(x, 8), wq, sc)), _bits(bulk))


@pytest.mark.parametrize("n", [33, 100, 4090])
def test_int8_kernel_ragged_n_gives_the_bits_of_a_padded_call(dev, n):
    """N % 16 != 0 stages codes element by element; the columns equal those
    of the same codes padded to a whole tensor-map row."""
    pad = -(-n // 16) * 16
    x, wq, sc = _int8(dev, 4, 1000, pad, torch.float32, seed=n)
    full = int8_matmul_kernel(x, wq, sc)
    part = int8_matmul_kernel(x, wq[:, :n].contiguous(), sc[:n].contiguous())
    assert torch.equal(_bits(part), _bits(full[:, :n]))


def test_int8_kernel_plan_is_one_launch_with_segments_set_by_k(dev):
    from repro_torch.kernels.int8_matmul import kernel as int8_lib
    up, down = int8_lib.plan(4, 14336, 4096), int8_lib.plan(4, 4096, 14336)
    assert (up["segments"], up["segment_rows"], up["cluster_blocks"]) == (8, 512, 8)
    assert (down["segments"], down["segment_rows"], down["cluster_blocks"]) == (28, 512, 7)
    assert up["blocks"] == down["blocks"] == 224
    for m in (1, 8, 13, 64):                # the segments do not depend on M or N
        for n in (33, 4096):
            p = int8_lib.plan(m, n, 14336)
            assert (p["segments"], p["segment_rows"]) == (28, 512)
    assert int8_lib.plan(1, 16, 16385)["segments"] == 31
    x, wq, sc = _int8(dev, 4, 4096, 14336, torch.float32)
    before = torch.cuda.memory_allocated(dev)
    out = int8_matmul_kernel(x, wq, sc)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) - before == out.numel() * 4   # no workspace


# ------------------------------------------------------- prefetch on the card
@pytest.mark.parametrize("packed", [False, True])
def test_prefetch_and_residency_on_the_card_equal_sync_and_greedy(dev, packed):
    """Fetches on a side stream, joined by events: under threads and under
    a chaos schedule the tokens equal ``greedy_generate`` and the events
    and bytes the synchronous engine's (with and without residency)."""
    cfg = ModelConfig(name="t-moe", family="moe", num_layers=4, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=0, d_expert=128,
                      vocab_size=97, num_experts=8, top_k=2)
    params = init_params(cfg, seed=3, device=dev)
    batch = {"tokens": torch.randint(0, 97, (2, 12), generator=torch.Generator()
                                     .manual_seed(4), dtype=torch.int32).to(dev)}
    transport = "int8" if packed else None
    ref = greedy_generate(cfg, params, batch, 8, transport=transport)

    def run(prefetch, residency):
        eng = ODMoEEngine(cfg, params, device=dev, prefetch=prefetch, residency=residency,
                          transport=transport, packed_slots=packed)
        toks, _ = eng.generate(batch, 8)
        eng.close()
        return toks, [(e.token, e.layer, e.expert, e.worker, e.bytes)
                      for e in eng.slots.events], eng.prefetch_report()

    for residency in (None, "lru"):
        base = run(None, residency)
        for prefetch in ("thread", ChaosExecutor(7, p_drop=0.3, p_defer=0.3)):
            toks, events, rep = run(prefetch, residency)
            assert torch.equal(toks, ref)
            assert events == base[1]
            assert rep["bytes_moved"] == base[2]["bytes_moved"]


# -------------------------------------------------------------- speculation
SPEC = ModelConfig(name="t-spec", family="moe", num_layers=4, d_model=64, num_heads=4,
                   num_kv_heads=2, d_ff=0, d_expert=96, vocab_size=97, num_experts=8, top_k=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [2, 4])
def test_verify_rows_equal_one_token_rows_through_the_kernel(dev, dtype, S):
    """Mixtral's attention shape (8 kv heads of 4 queries, Hd 128): row
    ``b*S + s`` of a verify wave equals, bit for bit, ``attn_decode`` on
    the cache sequential decode holds, both through the flash-decode
    kernel, and the wave's cache rows equal the sequential caches."""
    cfg = dataclasses.replace(SPEC, d_model=512, num_heads=32, num_kv_heads=8, head_dim=128,
                              dtype=dtype)
    mixer = layer_params(cfg, init_params(cfg, seed=2, device=dev), 0)["mixer"]
    g = torch.Generator(device=dev).manual_seed(S)
    bases, w = [7, 20, 1], 25
    b = len(bases)
    x = torch.randn((b * S, 1, cfg.d_model), generator=g, device=dev).to(getattr(torch, dtype))
    cache = attn_lib.init_cache(cfg, b, w, x.dtype, dev)
    for i, base in enumerate(bases):
        cache["k"][i, :base] = torch.randn((base, 8, 128), generator=g, device=dev).to(x.dtype)
        cache["v"][i, :base] = torch.randn((base, 8, 128), generator=g, device=dev).to(x.dtype)
        cache["pos"][i, :base] = torch.arange(base, device=dev, dtype=torch.int32)
    pos = (torch.tensor(bases, device=dev)[:, None] + torch.arange(S, device=dev)).reshape(-1)
    before = flash_decode_kernel.launches
    out, wave = spec_attn_decode(cfg, mixer, x, cache, pos.to(torch.int32), S)
    assert flash_decode_kernel.launches == before + 1
    for i in range(b):
        seq = {n: t[i:i + 1] for n, t in cache.items()}
        for s in range(S):
            r = i * S + s
            one, seq = attn_lib.attn_decode(cfg, mixer, x[r:r + 1], seq,
                                            pos[r:r + 1].to(torch.int32))
            assert torch.equal(one, out[r:r + 1]), (i, s)
            for n in ("k", "v", "pos"):
                assert torch.equal(seq[n], wave[n][r:r + 1]), (i, s, n)


def test_speculative_generate_on_the_card_equals_greedy(dev):
    params = init_params(SPEC, seed=5, device=dev)
    batch = {"tokens": torch.randint(0, 97, (1, 12), generator=torch.Generator()
                                     .manual_seed(6), dtype=torch.int32).to(dev)}
    ref = greedy_generate(SPEC, params, batch, 9)
    before = flash_decode_kernel.launches, moe_ffn_kernel.launches
    for policy in ((1, 1), (0, 0)):
        eng = ODMoEEngine(SPEC, params, predictor="sep", speculate=4, device=dev)
        toks, trace = eng.generate(batch, 9, AlignmentPolicy(*policy))
        assert torch.equal(toks, ref), policy
        assert sum(r.committed for r in trace.records) == 8
    assert flash_decode_kernel.launches > before[0] and moe_ffn_kernel.launches > before[1]


def test_speculative_paged_serving_on_the_card_equals_solo(dev):
    params = init_params(SPEC, seed=5, device=dev)
    reqs = make_traffic(SPEC, 6, 0.0, prompt_len=24, max_new=8, seed=2)
    window = max(len(r.prompt) + r.max_new_tokens for r in reqs) + 2
    pool = KVPool(SPEC, num_pages=-(-window // 4) * 4 // 2, page_tokens=4, device=dev)
    eng = ODMoEEngine(SPEC, params, predictor="sep", speculate=2, device=dev)
    res = ServingLoop(eng, max_batch=4, kv_pool=pool).run(reqs)
    assert res.mean_batch > 1
    for r in reqs:
        solo = greedy_generate(SPEC, params, {"tokens": torch.as_tensor(r.prompt, device=dev)
                                              [None, :]}, r.max_new_tokens)
        assert solo[0].cpu().tolist() == res.outputs[r.rid].tolist(), r.rid
        assert res.spec_stats["per_request"][r.rid]["committed"] == r.max_new_tokens - 1


# ------------------------------------------------------------------ fleet
FLEET = dataclasses.replace(SPEC, name="t-fleet", d_expert=128)


@pytest.mark.parametrize("packed", [False, True])
def test_two_slot_worker_waves_select_their_expert_through_the_kernels(dev, packed):
    """A worker holding two experts serves one of them per wave: the
    gathered stack is the store's copy of that expert, selected by (layer,
    expert), and the kernel's output on it equals, bit for bit, its output
    on the store's weights, within tolerance of the plain version."""
    params = init_params(FLEET, seed=3, device=dev)
    store = ExpertStore(FLEET, params, "int8" if packed else None)
    slots = WorkerSlots(store, 2, packed_resident=packed,
                        profiles=(WorkerProfile(0, capacity=2), WorkerProfile(1)))
    li = store.moe_layers[1]
    for e, w in ((5, 0), (2, 0), (7, 1)):
        slots.load(0, li, e, w, predicted=True)
    assert slots.resident == [((li, 5), (li, 2)), (li, 7)]
    g = torch.Generator(device=dev).manual_seed(9)
    for wave in ({2: 0, 7: 1}, {5: 0, 7: 1}, {5: 0}, {2: 0}):
        x = torch.randn((len(wave), 3, FLEET.d_model), generator=g, device=dev)
        if packed:
            experts, groups = slots.gather_stack_packed(li, wave)
            ((scheme, eids, parts),) = groups
            want = {n: tuple(torch.stack([store.device_shard(li, e).parts[n][j] for e in eids])
                             for j in range(len(parts[n]))) for n in NAMES}
            for n in NAMES:
                assert all(torch.equal(a, b) for a, b in zip(parts[n], want[n])), (wave, n)
            before = moe_ffn_packed_kernel.launches
            got = moe_ffn_packed(x, parts, scheme=scheme)
            assert moe_ffn_packed_kernel.launches == before + 1
            assert torch.equal(got, moe_ffn_packed_kernel(x, want, scheme=scheme))
            plain = moe_ffn_packed_ref(x, want, scheme=scheme)
        else:
            experts, stacked = slots.gather_stack(li, wave)
            shards = [store.unpack_shard(li, e) for e in experts]
            want = [torch.stack([sh[n] for sh in shards]) for n in NAMES]
            for n, w in zip(NAMES, want):
                assert torch.equal(stacked[n], w), (wave, n)
            before = moe_ffn_kernel.launches
            got = moe_ffn(x, *(stacked[n] for n in NAMES))
            assert moe_ffn_kernel.launches == before + 1
            assert torch.equal(got, moe_ffn_kernel(x, *want))
            plain = moe_ffn_ref(x, *want)
        assert experts == sorted(wave)
        assert float((got - plain).abs().max() / plain.abs().max()) <= REL_TOL


def test_kill_during_inflight_threaded_prefetch_on_the_card(dev):
    """Workers die mid-layer while the token's later fetches are still in
    flight on the side stream, and their slot tensors (filled there) are
    freed through the eviction path: the stranded experts reload on
    survivors, every wave after the kill computes what
    ``greedy_generate`` does, and the events and stats equal the
    synchronous engine's under the same script."""
    params = init_params(FLEET, seed=3, device=dev)
    batch = {"tokens": torch.randint(0, 97, (2, 12), generator=torch.Generator()
                                     .manual_seed(4), dtype=torch.int32).to(dev)}
    ref = greedy_generate(FLEET, params, batch, 8)
    script = [FaultEvent(2, 1, "kill", moe_index=0), FaultEvent(3, 5, "kill", moe_index=2),
              FaultEvent(5, 1, "recover"), FaultEvent(6, 6, "kill", moe_index=1)]

    def run(prefetch, residency):
        eng = ODMoEEngine(FLEET, params, device=dev, prefetch=prefetch, residency=residency,
                          faults=FaultInjector(script))
        toks, _ = eng.generate(batch, 8)
        eng.close()
        return toks, [(e.token, e.layer, e.expert, e.worker, e.predicted, e.bytes)
                      for e in eng.slots.events], dict(eng.slots.stats)

    for residency in (None, "lru"):
        base = run(None, residency)
        assert torch.equal(base[0], ref)
        assert base[2]["failures"] == 3 and base[2]["failure_drops"] >= 2
        assert any(not p and t == 2 for t, _, _, _, p, _ in base[1])
        for prefetch in ("thread", "thread", ChaosExecutor(11, p_drop=0.3, p_defer=0.3)):
            toks, events, stats = run(prefetch, residency)
            assert torch.equal(toks, ref), (prefetch, residency)
            assert events == base[1] and stats == base[2], (prefetch, residency)


def test_fleet_engine_on_the_card_equals_greedy(dev):
    """Heterogeneous links, two-slot workers and a kill, throttle and
    recovery through the engine on the card: tokens equal
    ``greedy_generate`` and every wave ran on the kernel."""
    params = init_params(FLEET, seed=5, device=dev)
    batch = {"tokens": torch.randint(0, 97, (1, 12), generator=torch.Generator()
                                     .manual_seed(6), dtype=torch.int32).to(dev)}
    profiles = [WorkerProfile(w, link_gbps=24.0 if w < 4 else 12.0, capacity=2 if w < 4 else 1)
                for w in range(8)]
    script = [FaultEvent(2, 2, "kill", moe_index=1), FaultEvent(3, 6, "throttle", factor=0.25),
              FaultEvent(5, 2, "recover")]
    before = moe_ffn_kernel.launches
    eng = ODMoEEngine(FLEET, params, predictor="sep", device=dev, profiles=profiles,
                      faults=FaultInjector(script))
    toks, _ = eng.generate(batch, 8)
    assert moe_ffn_kernel.launches > before
    assert torch.equal(toks, greedy_generate(FLEET, params, batch, 8))
    assert (eng.slots.stats["failures"], eng.slots.stats["recoveries"]) == (1, 1)
    assert len(eng.faults.applied) == 3
    assert eng.memory_report()["per_worker_bytes"] == 2 * eng.store.expert_bytes


# ------------------------------------------------- compute-vs-ship, cluster
def _hosted_inputs(dev, eng, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    true = np.stack([rng.choice(8, 2, replace=False) for _ in range(3)]).astype(np.int32)
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn((3, FLEET.d_model), generator=g, device=dev)
    gates = torch.rand((3, 2), generator=g, device=dev)
    return h, true, gates, eng.store.moe_layers[1]


@pytest.mark.parametrize("packed", [False, True])
def test_hosted_contributions_equal_the_slot_wave_bitwise(dev, packed):
    """An expert computed on the main node from the store's shard gives the
    slot wave's contributions bit for bit: full-width slots through the
    same kernel, packed int8 slots through the packed kernel against the
    full-width kernel on the dequantized shard."""
    params = init_params(FLEET, seed=3, device=dev)
    eng = ODMoEEngine(FLEET, params, device=dev, transport="int8" if packed else None,
                      packed_slots=packed)
    h, true, gates, li = _hosted_inputs(dev, eng, 5)
    experts = sorted({int(e) for e in true.reshape(-1)})
    for w, e in enumerate(experts):
        eng.slots.load(0, li, e, w, predicted=False)
    kernel = moe_ffn_packed_kernel if packed else moe_ffn_kernel
    before, full = kernel.launches, moe_ffn_kernel.launches
    slot = eng._compute_wave(li, h, true, gates, {e: w for w, e in enumerate(experts)}, None)
    assert kernel.launches > before
    hosted = eng._compute_hosted(li, h, true, gates, experts[::-1], None)
    assert moe_ffn_kernel.launches > full + (0 if packed else 1)
    assert torch.equal(hosted, slot)
    part = eng._compute_hosted(li, h, true, gates, experts[:1], None)
    rest = eng._compute_wave(li, h, true, gates, {e: experts.index(e) for e in experts[1:]},
                             part)
    assert torch.equal(rest, slot)                       # any split between the two paths


def test_hosted_stack_is_freed_after_the_call(dev):
    """The hosted stack is transient: allocated memory returns to its value
    before the call, and the call's peak holds the stack, one shard and the
    contributions, no more."""
    params = init_params(FLEET, seed=3, device=dev)
    eng = ODMoEEngine(FLEET, params, device=dev, compute_vs_ship=True)
    h, true, gates, li = _hosted_inputs(dev, eng, 7)
    experts = sorted({int(e) for e in true.reshape(-1)})
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = eng._compute_hosted(li, h, true, gates, experts, None)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - before
    out_bytes = out.numel() * out.element_size()
    assert peak <= (len(experts) + 1) * eng.store.expert_bytes + 2 * out_bytes + (1 << 20)
    del out
    assert torch.cuda.memory_allocated(dev) == before
    assert eng.slots.events == [] and eng.slots.bytes_moved == 0


def test_two_replicas_on_the_card_equal_solo_greedy(dev):
    """Two replicas over one store and one fleet, least-loaded, then
    round-robin under a plan with compute-vs-ship on 24 GB/s links: every
    request equals its solo ``greedy_generate``, both replicas serve, and
    the waves and attention ran on the kernels."""
    from repro_torch.fleet import FleetSchedule, GateStatsRecorder, optimize_placement
    from repro_torch.serve import make_cluster
    params = init_params(FLEET, seed=5, device=dev)
    reqs = make_traffic(FLEET, 6, 0.0, prompt_len=12, max_new=6, seed=2)
    solo = {r.rid: greedy_generate(FLEET, params, {"tokens": torch.as_tensor(
        r.prompt, device=dev)[None]}, r.max_new_tokens)[0].cpu().numpy() for r in reqs}
    rec = GateStatsRecorder()
    links = tuple(WorkerProfile(w, link_gbps=24.0) for w in range(8))
    runs = [dict(policy="least_loaded",
                 engine_kw=dict(n_workers=8, predictor="sep", device=dev, gate_stats=rec))]
    for run in range(2):
        if run == 1:
            plan = optimize_placement(rec, FleetSchedule(8, 2), num_experts=8, n_moe=4)
            runs.append(dict(policy="round_robin", engine_kw=dict(
                sched=FleetSchedule(8, 2, profiles=links, plan=plan), predictor="sep",
                device=dev, compute_vs_ship=True)))
        before = (moe_ffn_kernel.launches, flash_decode_kernel.launches)
        router = make_cluster(FLEET, params, replicas=2, loop_kw=dict(max_batch=4),
                              **runs[run])
        res = router.run(reqs)
        assert moe_ffn_kernel.launches > before[0] and flash_decode_kernel.launches > before[1]
        for r in reqs:
            assert (res.outputs[r.rid] == solo[r.rid]).all(), (run, r.rid)
        assert sorted(set(res.assignments.values())) == [0, 1]
        engines = [l.engine for l in router.loops]
        assert engines[0].store is engines[1].store and engines[0].sched is engines[1].sched
    assert rec.n_layers == 4
    assert sum(len(lr.hosted) for r in res.replicas for s in r.trace.records
               for lr in s.layers) > 0


# ------------------------------- long prompts and top-8 configs at their widths
# qwen3-moe (D=2048, F=768: three 256-row contraction segments) and
# granite-moe (D=1536, F=512: two): an engine wave on a group of 8, a served
# row block, the shadow's and reference's all-expert decode (128 experts),
# granite's 40 experts padded to 64 on a prefill row block
TOP8_FFN = [(8, 1, 2048, 768), (16, 8, 2048, 768), (128, 1, 2048, 768), (64, 8, 1536, 512)]
# the long phase's W=3008 at Mixtral's heads; qwen3's G=8; granite's G=3, Hd=64
TOP8_FLASH = [(1, 3008, 8, 4, 128), (2, 300, 4, 8, 128), (2, 300, 8, 3, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,d,f", TOP8_FFN)
def test_kernel_at_top8_widths_matches_plain_version(dev, dtype, e, c, d, f):
    """Within tolerance of the plain version, and the first two experts'
    first row bitwise equal to their own small launch (an engine wave's
    bits equal the all-expert reference's)."""
    args = _inputs(dev, e, c, d, f, dtype, seed=e + c)
    k = moe_ffn_kernel(*args)
    p = moe_ffn_ref(*args)
    torch.cuda.synchronize()
    assert float((k - p).abs().max() / p.abs().max()) <= REL_TOL
    x, wg, wu, wd = args
    sub = moe_ffn_kernel(x[:2, :1].contiguous(), wg[:2], wu[:2], wd[:2])
    assert torch.equal(sub, k[:2, :1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,w,kh,g,hd", TOP8_FLASH)
def test_flash_kernel_at_long_and_top8_layouts(dev, dtype, b, w, kh, g, hd):
    args = _flash(dev, b, w, kh, g, hd, dtype, seed=w + g)
    o = flash_decode_kernel(*args)
    p = flash_decode_ref(*args)
    torch.cuda.synchronize()
    assert float((o - p).abs().max() / p.abs().max()) <= REL_TOL
    for i in range(b):
        one = flash_decode_kernel(*(t[i:i + 1].contiguous() for t in args))
        assert torch.equal(one, o[i:i + 1])


def test_ssd_kernel_at_a_long_prompts_chunks(dev):
    """A 3000-token Jamba prompt scans 12 chunks of 256."""
    s, decay, h0 = _ssd(dev, 1, 12, 128, 64, 128, False, seed=3)
    k_in, k_last = ssd_scan_kernel(s, decay)
    p_in, p_last = ssd_scan_ref(s, decay)
    assert torch.equal(k_in, p_in) and torch.equal(k_last, p_last)


BLOCKWISE = ModelConfig(name="t-blk", family="dense", num_layers=1, d_model=256, num_heads=8,
                        num_kv_heads=2, d_ff=64, vocab_size=16, head_dim=64)


def _blockwise_inputs(dev, t, dtype):
    from repro_torch.models.attention import init_attention
    gen = torch.Generator(device=dev).manual_seed(t)
    params = init_attention(gen, BLOCKWISE, dtype, dev)
    x = torch.randn((1, t, BLOCKWISE.d_model), generator=gen, device=dev).to(dtype)
    pos = torch.arange(t, device=dev, dtype=torch.int32)[None]
    return params, x, pos


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_blockwise_attention_on_the_card_matches_the_host(dev, dtype, tol):
    """A 2200-token sequence takes the blockwise path on both devices: the
    same recurrence, sums in other orders (bf16 rounds p and the products
    on each device's own way, hence its looser tolerance)."""
    params, x, pos = _blockwise_inputs(dev, 2200, dtype)
    card = attn_lib.attn_seq(BLOCKWISE, params, x, pos)
    host = attn_lib.attn_seq(BLOCKWISE, {k: v.cpu() for k, v in params.items()}, x.cpu(),
                             pos.cpu())
    assert card.device.type == "cuda" and card.shape == host.shape
    assert float((card.cpu().float() - host.float()).abs().max()
                 / host.float().abs().max()) <= tol


@pytest.mark.parametrize("window", [0, 300])
def test_blockwise_attention_matches_attn_seq_at_2048_on_the_card(dev, window):
    params, x, pos = _blockwise_inputs(dev, 2048, torch.float32)
    full = attn_lib.attn_seq(BLOCKWISE, params, x, pos, window=window)
    blk = attn_lib.attn_seq_blockwise(BLOCKWISE, params, x, pos, window=window)
    assert float((blk - full).abs().max() / full.abs().max()) <= 1e-5


TOP8_CFGS = {
    "qwen3": ModelConfig(name="t-qwen3", family="moe", num_layers=3, d_model=64, num_heads=8,
                         num_kv_heads=1, d_ff=0, d_expert=64, vocab_size=97, num_experts=16,
                         top_k=8, head_dim=16, dtype="bfloat16"),
    "granite": ModelConfig(name="t-granite", family="moe", num_layers=3, d_model=48,
                           num_heads=6, num_kv_heads=2, d_ff=0, d_expert=32, vocab_size=97,
                           num_experts=40, top_k=8, padded_experts=48, tie_embeddings=True,
                           dtype="bfloat16"),
}


@pytest.mark.parametrize("name", list(TOP8_CFGS))
@pytest.mark.parametrize("workers", [8, 16])
def test_top8_engine_on_the_card_equals_greedy(dev, name, workers):
    """Top-8 routing over 16 experts, and over 40 real of 48 padded rows,
    in bf16: the engine's tokens equal greedy_generate's through both
    kernels."""
    cfg = TOP8_CFGS[name]
    params = init_params(cfg, seed=6, device=dev)
    batch = {"tokens": torch.randint(0, 97, (1, 10), generator=torch.Generator()
                                     .manual_seed(7), dtype=torch.int32).to(dev)}
    before = (moe_ffn_kernel.launches, flash_decode_kernel.launches)
    eng = ODMoEEngine(cfg, params, n_workers=workers, predictor="sep", device=dev)
    toks, trace = eng.generate(batch, 6)
    assert moe_ffn_kernel.launches > before[0] and flash_decode_kernel.launches > before[1]
    assert torch.equal(toks, greedy_generate(cfg, params, batch, 6))
    assert max(int(e) for r in trace.records for lr in r.layers
               for e in lr.true.reshape(-1)) < cfg.num_experts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,kh,g,hd", [(2, 256, 16, 1, 64), (3, 37, 2, 1, 64),
                                         (1, 280, 8, 6, 128), (2, 300, 4, 6, 32)])
def test_flash_kernel_at_the_cross_attention_layout(dev, dtype, b, s, kh, g, hd):
    """Cross-attention decode: every memory frame at slot position 0, some
    hidden at -1 (a memory mask), decoder positions past 0; at G=1 (one
    query head per kv head, the MMA tile's rows mostly padding) and at
    G=6 (not a power of two)."""
    gen = torch.Generator(device=dev).manual_seed(s + g)
    q = torch.randn((b, kh, g, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, kh, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, kh, hd), generator=gen, device=dev).to(dtype)
    pos = torch.randint(1, 50, (b,), generator=gen, device=dev, dtype=torch.int32)
    for masked in (False, True):
        kpos = torch.zeros((b, s), dtype=torch.int32, device=dev)
        if masked:
            hide = torch.rand((b, s), generator=gen, device=dev) > 0.7
            hide[:, 0] = False
            kpos = torch.where(hide, -1, kpos).to(torch.int32)
        o = flash_decode_kernel(q, k, v, kpos, pos)
        p = flash_decode_ref(q, k, v, kpos, pos)
        torch.cuda.synchronize()
        assert float((o - p).abs().max() / p.abs().max()) <= REL_TOL


ENCDEC = ModelConfig(name="t-encdec", family="audio", num_layers=2, d_model=64, num_heads=4,
                     num_kv_heads=4, d_ff=128, vocab_size=97, is_encoder_decoder=True,
                     num_encoder_layers=2, frontend="audio", frontend_tokens=7,
                     frontend_dim=40, norm_type="layernorm")
VLM = ModelConfig(name="t-vlm", family="vlm", num_layers=2, d_model=96, num_heads=6,
                  num_kv_heads=1, d_ff=128, vocab_size=97, frontend="vision",
                  frontend_tokens=5, frontend_dim=48)


@pytest.mark.parametrize("cfg", [ENCDEC, VLM], ids=["encdec", "vlm"])
def test_frame_and_patch_models_on_the_card_equal_the_host(dev, cfg):
    """Greedy tokens of the tiny encoder-decoder (self and cross attention
    through the flash-decode kernel) and VLM (G=6) on the card equal the
    plain host path's, and the card's launched the kernel."""
    from repro_torch.models.frontends import synthetic_frontend_embeds
    from repro_torch.models.transformer import tree_map
    params = init_params(cfg, seed=4, device="cpu")
    front = synthetic_frontend_embeds(cfg, torch.Generator().manual_seed(5), 2)
    toks = torch.randint(0, 97, (2, 6), generator=torch.Generator().manual_seed(6),
                         dtype=torch.int32)
    host = greedy_generate(cfg, params, {"tokens": toks, "frontend_embeds": front}, 6,
                           max_cache_len=20)
    before = flash_decode_kernel.launches
    card = greedy_generate(cfg, tree_map(lambda t: t.to(dev), params),
                           {"tokens": toks.to(dev), "frontend_embeds": front.to(dev)}, 6,
                           max_cache_len=20)
    per_step = (2 if cfg.is_encoder_decoder else 1) * cfg.num_layers
    assert flash_decode_kernel.launches - before == 5 * per_step
    assert torch.equal(card.cpu(), host)


@pytest.mark.parametrize("method", ["dense", "scatter", "einsum", "grouped"])
def test_moe_dispatches_on_the_card_equal_the_host(dev, method):
    """Each dispatch's output and load-balance loss on the card within
    1e-5 of the host's, fp32, at a capacity factor that drops pairs;
    ``loss_fn`` under it too."""
    from repro_torch.models import loss_fn
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.transformer import tree_map
    cfg = ModelConfig(name="t-moe-pad", family="moe", num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=2, d_ff=0, d_expert=96, vocab_size=97, num_experts=8,
                      top_k=2, padded_experts=12)
    params = init_params(cfg, seed=7, device="cpu")
    ff = tree_map(lambda a: a[0], params["layers"][0])["ff"]
    x = torch.randn((24, 64), generator=torch.Generator().manual_seed(8))
    kw = {"cap_factor": 0.5} if method in ("scatter", "einsum") else {}
    out, aux = moe_lib.moe_ff(cfg, ff, x, method, **kw)
    out_d, aux_d = moe_lib.moe_ff(cfg, tree_map(lambda t: t.to(dev), ff), x.to(dev), method, **kw)
    assert float((out_d.cpu() - out).abs().max()) <= 1e-5 * float(out.abs().max())
    assert torch.equal(aux_d["topk_idx"].cpu(), aux["topk_idx"])
    assert abs(float(aux_d["load_balance_loss"]) - float(aux["load_balance_loss"])) <= 1e-5
    toks = torch.randint(0, 97, (2, 12), generator=torch.Generator().manual_seed(9))
    loss, _ = loss_fn(cfg, params, {"tokens": toks}, moe_method=method)
    loss_d, _ = loss_fn(cfg, tree_map(lambda t: t.to(dev), params), {"tokens": toks.to(dev)},
                        moe_method=method)
    assert abs(float(loss_d) - float(loss)) <= 1e-4 * abs(float(loss))


# ------------------------------------------------------------------ training
@pytest.mark.parametrize("shape", [(1, 4, 80, 64, 128), (2, 5, 3, 5, 12)],
                         ids=["mamba2-layer", "ragged-tail"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_gradient_through_the_kernel_matches_plain_version(dev, shape, with_h0):
    """The scan's ``autograd.Function`` on the card (kernel forward, kernel
    reverse scan: 2 launches) against autograd through ``ssd_scan_ref`` on
    the same inputs and upstream gradients: ``ds`` and ``dh0`` bitwise,
    ``d(decay)`` within 1e-5 of its largest (a reduction in another
    order)."""
    s, decay, h0 = _ssd(dev, *shape, with_h0, seed=4)
    g = torch.Generator(device=dev).manual_seed(5)
    g_in = torch.randn(s.shape, generator=g, device=dev)
    g_last = torch.randn(s[:, 0].shape, generator=g, device=dev)
    grads = []
    for fn in (ssd_scan, ssd_scan_ref):
        ins = [None if t is None else t.clone().requires_grad_(True) for t in (s, decay, h0)]
        before = ssd_scan_kernel.launches
        outs = fn(*ins)
        grads.append(torch.autograd.grad(outs, [t for t in ins if t is not None],
                                         grad_outputs=(g_in, g_last)))
        if fn is ssd_scan:
            assert ssd_scan_kernel.launches == before + 2
    (ds, dd, *dh0), (rs, rd, *rh0) = grads
    assert torch.equal(ds, rs)
    assert all(torch.equal(a, b) for a, b in zip(dh0, rh0))
    assert float((dd - rd).abs().max()) <= 1e-5 * float(rd.abs().max())


def test_kernels_refuse_to_run_under_grad(dev):
    """A kernel has no backward: each refuses (ValueError, nothing launched)
    an input that requires grad while grad is enabled, and runs it under
    ``no_grad``; ``loss_fn`` under ``grouped`` on parameters that require
    grad refuses too, and ``scatter`` differentiates on the card."""
    from repro_torch.models import loss_fn
    from repro_torch.models.transformer import tree_leaves, tree_map
    x, wg, wu, wd = _inputs(dev, 2, 3, 64, 128, torch.float32)
    q, k, v, kpos, pos = _flash(dev, 2, 40, 2, 4, 64, torch.float32)
    xi, w_q, scale = _int8(dev, 4, 70, 33, torch.float32)
    s, decay, _ = _ssd(dev, 1, 3, 4, 8, 8, False)
    parts = _packed(dev, "int8", 2, 64, 128)
    slot = torch.zeros((3, 1), dtype=torch.int64, device=dev)
    gates = torch.ones((3, 1), device=dev)
    # (the input that may require grad, the call on it)
    calls = {
        "moe_ffn": (x, lambda t: moe_ffn(t, wg, wu, wd)),
        "grouped_topk_contrib": (x[0], lambda t: grouped_topk_contrib(t, wg, wu, wd, slot,
                                                                       gates)),
        "moe_ffn_packed": (x, lambda t: moe_ffn_packed(t, parts, scheme="int8")),
        "flash_decode": (q, lambda t: flash_decode(t, k, v, kpos, pos)),
        "int8_matmul": (xi, lambda t: int8_matmul(t, w_q, scale)),
        "ssd_scan_kernel": (s, lambda t: ssd_scan_kernel(t, decay)),
    }
    kernels = (moe_ffn_kernel, moe_ffn_packed_kernel, flash_decode_kernel, int8_matmul_kernel,
               ssd_scan_kernel)
    for name, (t, call) in calls.items():
        needs_grad = t.detach().clone().requires_grad_(True)
        before = [kern.launches for kern in kernels]
        with pytest.raises(ValueError, match="no backward"):
            call(needs_grad)
        assert [kern.launches for kern in kernels] == before, name
        with torch.no_grad():
            call(needs_grad)
        call(t)
    cfg = ModelConfig(name="t-moe", family="moe", num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=2, d_ff=0, d_expert=96, vocab_size=97, num_experts=8, top_k=2)
    params = tree_map(lambda p: p.requires_grad_(True), init_params(cfg, seed=2, device=dev))
    toks = {"tokens": torch.randint(0, 97, (2, 12), device=dev)}
    before = moe_ffn_kernel.launches
    with pytest.raises(ValueError, match="no backward"):
        loss_fn(cfg, params, toks, moe_method="grouped")
    assert moe_ffn_kernel.launches == before
    loss, _ = loss_fn(cfg, params, toks, moe_method="scatter")
    loss.backward()
    assert all(p.grad is not None for p in tree_leaves(params))


def test_adamw_step_on_the_card_equals_the_host(dev):
    """One AdamW update of fp32 and bf16 leaves (a stacked expert leaf
    updated in chunks of its leading axis) on the card against the same
    update on the host: within 1e-6 (fp32 elementwise arithmetic; the
    global norm sums in another order)."""
    from repro_torch.optim import AdamWConfig, adamw_update
    g = torch.Generator().manual_seed(6)
    shapes = {"w": (3, 48, 40), "norm": (3, 40), "b": (40,), "e": (2, 4, 40, 24)}
    params = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    params["e"] = params["e"].to(torch.bfloat16)
    grads = {k: torch.randn(s, generator=g) * 0.3 for k, s in shapes.items()}
    grads["e"] = grads["e"].to(torch.bfloat16)
    mu = {k: torch.randn(s, generator=g) * 0.01 for k, s in shapes.items()}
    nu = {k: torch.rand(s, generator=g) * 0.01 for k, s in shapes.items()}
    cfg = AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=50)
    out = []
    for d in ("cpu", dev):
        on = lambda t: {k: v.clone().to(d) for k, v in t.items()}
        state = {"mu": on(mu), "nu": on(nu), "step": torch.tensor(4, dtype=torch.int32,
                                                                   device=d)}
        out.append(adamw_update(on(params), on(grads), state, cfg))
    (hp, hs, hm), (cp, cs, cm) = out
    for k in shapes:
        for a, b in ((cp[k], hp[k]), (cs["mu"][k], hs["mu"][k]), (cs["nu"][k], hs["nu"][k])):
            assert a.dtype == b.dtype
            torch.testing.assert_close(a.cpu().float(), b.float(), rtol=1e-6, atol=1e-6)
    for k in ("grad_norm", "lr"):
        assert abs(float(cm[k]) - float(hm[k])) <= 1e-6 * abs(float(hm[k]))
    assert int(cs["step"]) == 5


def test_train_step_on_the_card_equals_the_host(dev):
    """One ``make_train_step`` (scatter, remat, 2 microbatches) of the
    fp32 hybrid on the card, its Mamba gradient through the kernel's
    reverse scan, against the same step on the host: loss and grad norm
    within 1e-5, every leaf of the first ``mu`` within 3e-5 of its largest
    (the hybrid's gradient is not resolved more finely in fp32; see
    ``tests/test_torch_train.py``); the kernel launched 3 times per Mamba
    layer per microbatch."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, init_opt_state
    host = init_params(HYBRID, seed=11, device="cpu")
    toks = torch.randint(0, 97, (4, 12), generator=torch.Generator().manual_seed(12))
    step = make_train_step(HYBRID, AdamWConfig(lr=1e-3, warmup_steps=0), n_microbatches=2)
    mamba_layers = sum(m == "mamba" for m, _ in HYBRID.layer_kinds())
    out = []
    for d in ("cpu", dev):
        p = tree_map(lambda t: t.clone().to(d), host)
        before = ssd_scan_kernel.launches
        out.append(step(p, init_opt_state(p), {"tokens": toks.to(d)}))
        launched = ssd_scan_kernel.launches - before
        assert launched == (0 if d == "cpu" else 3 * mamba_layers * 2)
    (_, hs, hm), (_, cs, cm) = out
    for k in ("loss", "grad_norm"):
        assert abs(float(cm[k]) - float(hm[k])) <= 1e-5 * abs(float(hm[k])), k
    for a, b in zip(tree_leaves(cs["mu"]), tree_leaves(hs["mu"])):
        assert float((a.cpu() - b).abs().max()) <= 3e-5 * float(b.abs().max()) + 1e-30
