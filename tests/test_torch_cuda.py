"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: without a GPU every test skips (decided in the fixture, not
at import).  On the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Shapes are small and ragged (M/N/K off the tile sizes, odd channel counts,
stride 2); every output must equal the plain version bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, conv_pe, dwc_pe, low_channel

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _q(rng, shape, dev):
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)
                            ).to(dev)


def _f(rng, shape, dev, lo=0.005, hi=0.05):
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)
                            ).to(dev)


def _check(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


@pytest.mark.parametrize("m,k,n", [(50, 16, 24), (130, 320, 67),
                                   (4, 1280, 1000)])
@pytest.mark.parametrize("out_scale", [None, 0.0621])
def test_conv_pe_gemm(dev, m, k, n, out_scale):
    rng = np.random.default_rng(m + k + n)
    a, b = _q(rng, (m, k), dev), _q(rng, (k, n), dev)
    wsc, bias = _f(rng, (1, n), dev), _f(rng, (n,), dev, -1.0, 1.0)
    before = _build.COUNTS.get("conv_pe", 0)
    got = conv_pe.matmul_int8_fused(a, b, 0.0173, wsc, bias, "relu6",
                                    out_scale)
    assert _build.COUNTS["conv_pe"] == before + 1
    _check(got, conv_pe.matmul_int8_fused_plain(a, b, 0.0173, wsc, bias,
                                                "relu6", out_scale))


@pytest.mark.parametrize("m,k,n", [(49, 96, 24), (300, 144, 32)])
def test_conv_pe_residual(dev, m, k, n):
    rng = np.random.default_rng(m)
    a, b = _q(rng, (m, k), dev), _q(rng, (k, n), dev)
    wsc, bias = _f(rng, (1, n), dev), _f(rng, (n,), dev, -1.0, 1.0)
    r = _q(rng, (m, n), dev)
    kw = dict(out_scale=0.091, residual=r, res_scale=0.047, mid_scale=0.083)
    _check(conv_pe.matmul_int8_fused(a, b, 0.021, wsc, bias, "none", **kw),
           conv_pe.matmul_int8_fused_plain(a, b, 0.021, wsc, bias, "none",
                                           **kw))


@pytest.mark.parametrize("g,rows,k,n", [(4, 49, 320, 1280), (3, 16, 40, 70)])
def test_conv_pe_pool(dev, g, rows, k, n):
    rng = np.random.default_rng(g * rows)
    a, b = _q(rng, (g, rows, k), dev), _q(rng, (k, n), dev)
    wsc, bias = _f(rng, (1, n), dev), _f(rng, (n,), dev, -1.0, 1.0)
    kw = dict(mid_scale=0.0713, out_scale=0.0377)
    _check(conv_pe.matmul_int8_pool(a, b, 0.0191, wsc, bias, "relu", **kw),
           conv_pe.matmul_int8_pool_plain(a, b, 0.0191, wsc, bias, "relu",
                                          **kw))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("c", [40, 96])
def test_dwc(dev, stride, c):
    rng = np.random.default_rng(c + stride)
    x, w = _q(rng, (2, 11, 11, c), dev), _q(rng, (3, 3, c), dev)
    wsc, bias = _f(rng, (c,), dev), _f(rng, (c,), dev, -1.0, 1.0)
    kw = dict(a_scale=0.031, w_scale=wsc, out_scale=0.057)
    _check(dwc_pe.dwc2d(x, w, bias, stride, "relu6", **kw),
           dwc_pe.dwc2d_plain(x, w, bias, stride, "relu6", **kw))


def test_low_channel(dev):
    rng = np.random.default_rng(7)
    x, w = _q(rng, (2, 33, 33, 3), dev), _q(rng, (3, 3, 3, 32), dev)
    wsc, bias = _f(rng, (32,), dev), _f(rng, (32,), dev, -1.0, 1.0)
    kw = dict(a_scale=0.0117, w_scale=wsc, out_scale=0.043)
    _check(low_channel.low_channel_conv(x, w, bias, 2, "relu", **kw),
           low_channel.low_channel_conv_plain(x, w, bias, 2, "relu", **kw))


def test_wrapper_rejects_bad_operands(dev):
    rng = np.random.default_rng(0)
    a = _q(rng, (8, 16), dev)
    with pytest.raises(ValueError):
        conv_pe.matmul_int8_fused(a, _q(rng, (16, 8), dev).t(), 1.0,
                                  torch.ones(8, device=dev))
    with pytest.raises(ValueError):
        conv_pe.matmul_int8_fused(a.float(), _q(rng, (16, 8), dev), 1.0,
                                  torch.ones(8, device=dev))
