"""Card-only tests of the port: the hand-written CUDA grouped FFN against
its plain PyTorch version, its refusals, and the engine on the card.

They skip on a host without CUDA.  This file imports neither JAX nor the
JAX package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.core import ODMoEEngine
from repro_torch.kernels.moe_gemm import (grouped_topk_contrib, moe_ffn,
                                          moe_ffn_kernel, moe_ffn_ref)
from repro_torch.models import ModelConfig, greedy_generate, init_params

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
