"""The dequantize prologue's host side (``ops/dequant_stream.py``): its plain
version turns the intN weight stream of int8 and int16 weights into the
bf16 stream of their dequantized weights bit for bit, writes the resident
parameters the bf16 build reads, and the wrapper hands the C entry point the
schedule and pointers it walks. The CUDA kernel (``csrc/dequant_stream.cu``)
runs only on the card; ``chip_smoke.py`` holds it against the plain
version there, bit for bit."""

import ctypes

import pytest
import torch

from nerf_tpu_torch.config import bmild_config, default_config
from nerf_tpu_torch.models.nerf import init_nerf_params
from nerf_tpu_torch.ops import _ext, dequant_stream, quant, ray_wgmma
from nerf_tpu_torch.ops.quant import quantize_model

VARIANTS = ["reference", "bmild"]
STREAMS = ["ray", "per_sample"]


def _quantized(variant, bits, seed=0):
    """A seeded network pruned and quantized as the compressed engine does."""
    cfg = (default_config() if variant == "reference" else bmild_config()).model
    params = init_nerf_params(torch.Generator().manual_seed(seed), cfg, "cpu")
    q = quantize_model({"fine": params}, cfg, bits=bits, prune_fraction=0.1)[0]["fine"]
    return q, cfg


def _pack(stream):
    return ray_wgmma.pack_sample_stream if stream == "per_sample" else ray_wgmma.pack_stream


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_dequant_stream_is_the_stream_of_the_dequantized_weights(variant, bits, stream):
    q, cfg = _quantized(variant, bits, seed=bits)
    assert quant.route_of(q) == (quant.ROUTE_INT8 if bits == 8 else quant.ROUTE_INT16)
    per_sample = stream == "per_sample"
    d = dequant_stream.dequant_stream(q, _pack(stream)(q, cfg), cfg, per_sample)
    deq = quant.dequantize(q, torch.bfloat16)
    want = _pack(stream)(deq, cfg)
    assert d.stream.dtype == want.dtype == torch.bfloat16 and d.stream.shape == want.shape
    assert torch.equal(d.stream.view(torch.int16), want.view(torch.int16))
    # the resident parameters: what the bf16 build reads of the dequantized
    # weights, bit for bit; the biases are the quantized weights' own
    read = dequant_stream.launch_weights(q, d)
    for name in ("wsig", "wc1", "wdir"):
        got, ref = getattr(read, name), getattr(deq, name)
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        assert torch.equal(got.view(torch.int16), ref.view(torch.int16)), name
    for name in ("b0", "bt", "bsig", "bbn", "bc0", "bc1"):
        assert getattr(read, name) is getattr(q, name)
    # the streamed matrices are read from the stream alone
    assert all(getattr(read, n) is d.stream for n in ("w0", "wt", "wskip", "wc0"))
    assert (read.wbn is d.stream) == (variant == "bmild")


class _Fn:
    def __init__(self, calls):
        self.calls, self.argtypes, self.restype = calls, None, None

    def __call__(self, *args):
        assert len(args) == len(self.argtypes)
        self.calls.append(args)
        return 0


class _Lib:
    def __init__(self, calls):
        self.dequant_stream = _Fn(calls)


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("bits", [8, 16])
def test_launch_passes_the_schedule_and_a_new_scratch(monkeypatch, bits, stream):
    # the entry point gets the stream, the bits, the chunks of 256 and of
    # 128 columns (wc0, and wdir on the per-sample stream), the resident
    # matrices with their scales, and scratch made for the call: two calls
    # get two scratches, and nothing is cached beside the weights
    calls = []
    monkeypatch.setattr(_ext, "load", lambda name: _Lib(calls))
    monkeypatch.setattr(_ext, "stream_ptr", lambda dev: ctypes.c_void_p(0))
    q, cfg = _quantized("bmild", bits, seed=3)
    per_sample = stream == "per_sample"
    s = ray_wgmma.sample_stream_for(q, cfg) if per_sample else ray_wgmma.stream_for(q, cfg)
    before = dequant_stream.launches
    a = dequant_stream._launch(q, s, cfg, per_sample)
    b = dequant_stream._launch(q, s, cfg, per_sample)
    assert dequant_stream.launches == before + 2
    assert a.stream.data_ptr() != b.stream.data_ptr()
    (src, got_bits, n_big, n_small, resident, out, res, _), _ = calls
    assert (src.value, got_bits) == (s.data_ptr(), bits)
    # bmild: w0, 7 x 4 trunk slabs, wskip, 4 bottleneck slabs; 4 of wc0 (+ wdir)
    assert (n_big, n_small) == (34, 4 + per_sample)
    assert a.stream.numel() == (n_big * 256 + n_small * 128) * 64
    assert (out.value, res.value) == (a.stream.data_ptr(), a.resident.data_ptr())
    want = [getattr(q, f"{n}_{x}").data_ptr() for n in ("wsig", "wc1", "wdir") for x in "qs"]
    assert list(resident) == want
    assert a.resident.numel() == dequant_stream.RESIDENT_VALUES == 256 + 128 * 3 + 32 * 128


def test_refuses_what_it_does_not_convert():
    q, cfg = _quantized("reference", 8)
    s = ray_wgmma.pack_stream(q, cfg)
    with pytest.raises(ValueError, match="at least"):
        dequant_stream.dequant_stream(q, s[:-1], cfg)
    with pytest.raises(ValueError, match="at least"):              # the per-sample stream is longer
        dequant_stream.dequant_stream(q, s, cfg, per_sample=True)
    q8c = quantize_model({"fine": init_nerf_params(torch.Generator().manual_seed(0), cfg, "cpu")},
                         cfg, act_bits=8)[0]["fine"]
    with pytest.raises(ValueError, match="QuantizedPackedWeights"):
        dequant_stream.dequant_stream(q8c, ray_wgmma.pack_stream(q8c, cfg), cfg)
