"""The Hopper ray kernels' host side (``ops/ray_wgmma.py``, the dispatch of
``render_kernel._launch``): the weight streams' layout against the weights
bit for bit on every route, the producer's chunk schedule and its
conversion of dequantize chunks, the int8-compute stream's row permutation
against the s8 A fragments the consumers build, which library a launch
reaches, the streamed weights rendering like the JAX Pallas kernel
(interpret mode), and the composited modes' schedule (whole rays per
consumer lane, 64-row steps, the carried state) against the plain
composited versions. The CUDA kernel itself (``csrc/ray_wgmma.cu``) runs only on
the card; ``chip_smoke.py`` holds it against the plain versions."""

import ctypes
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.config import ModelConfig as JModelConfig
from nerf_tpu.config import bmild_config as jbmild
from nerf_tpu.models.nerf import init_nerf_params as jinit
from nerf_tpu.ops import quant as jquant
from nerf_tpu.ops.render_kernel import fused_render_samples as jfrs
from nerf_tpu_torch.config import ModelConfig, default_config
from nerf_tpu_torch.models.nerf import params_from_numpy
from nerf_tpu_torch.ops import _ext, quant, ray_wgmma, render_kernel
from nerf_tpu_torch.ops.mlp_kernel import PackedWeights, pack_params, skip_position
from nerf_tpu_torch.ops.render_kernel import fused_render_samples_plain
from nerf_tpu_torch.train.checkpoint import restore_bare_params

VARIANTS = ["reference", "bmild"]
MATRICES = ("w0", "wt", "wskip", "wbn", "wc0")


def _cfgs(variant):
    jc = JModelConfig() if variant == "reference" else jbmild().model
    return jc, ModelConfig(**dataclasses.asdict(jc))


def _numpy_params(variant, seed):
    """Seeded weights as numpy, the JAX package's tree."""
    return jax.device_get(jinit(jax.random.PRNGKey(seed), _cfgs(variant)[0]))


def _packed(variant, seed=0, dtype=torch.bfloat16):
    _, tc = _cfgs(variant)
    return pack_params(params_from_numpy(_numpy_params(variant, seed), "cpu"), tc, dtype), tc


# -- the stream's layout -----------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_stream_unpacks_to_pack_params_bit_for_bit(variant):
    packed, tc = _packed(variant)
    stream = ray_wgmma.pack_stream(packed, tc)
    assert stream.dtype == torch.bfloat16 and stream.dim() == 1
    back = ray_wgmma.unpack_stream(stream, tc)
    want = {n for n in MATRICES if getattr(packed, n) is not None}
    assert set(back) == want
    for name in want:
        assert torch.equal(back[name], getattr(packed, name)), name


@pytest.mark.parametrize("variant", VARIANTS)
def test_stream_is_the_swizzled_k_major_image(variant):
    # element (k, n) of a chunk's slab W[k0 + k, n] sits where the kernel's
    # B descriptor reads it: column n's 64 weights in one 128-byte row of an
    # 8-row atom, the 16-byte piece k // 8 at position (k // 8) ^ (n % 8)
    packed, tc = _packed(variant, seed=1)
    stream = ray_wgmma.pack_stream(packed, tc)
    rng = np.random.default_rng(0)
    at = 0
    for c in ray_wgmma.chunk_schedule(tc):
        w = getattr(packed, c.name)
        w = w if c.layer is None else w[c.layer]
        for k, n in zip(rng.integers(0, 64, 40), rng.integers(0, c.n, 40)):
            off = (n // 8) * 512 + (n % 8) * 64 + ((k // 8) ^ (n % 8)) * 8 + k % 8
            assert stream[at + off] == w[c.k0 + k, n]
        at += 64 * c.n
    assert at == stream.numel()


def test_stream_refuses_unpadded_encodings():
    packed, tc = _packed("reference")
    with pytest.raises(ValueError, match="w0"):
        ray_wgmma.pack_stream(packed._replace(w0=packed.w0[:63]), tc)


# -- the producer's chunk schedule -------------------------------------------

def _producer(n_chunks):
    """The producer loop of csrc/ray_wgmma.cu over one tile: (offset, bytes)
    of every bulk copy. Every chunk is 32 KB but the last four (16 KB)."""
    n_big, src, out = n_chunks - 4, 0, []
    for j in range(n_chunks):
        nbytes = 32768 if j < n_big else 16384
        out.append((src, nbytes))
        src += nbytes
    return out


@pytest.mark.parametrize("variant", VARIANTS)
def test_schedule_covers_each_matrix_once_in_the_consumers_order(variant):
    packed, tc = _packed(variant)
    sched = ray_wgmma.chunk_schedule(tc)
    bmild = variant == "bmild"
    # stream_chunks(bmild) of csrc/ray_wgmma.cu
    assert len(sched) == 1 + 28 + 1 + 4 * bmild + 4
    # the consumers' order: layer 0, the trunk with the skip after the layer
    # at skip_pos, the bottleneck, the color layer
    order = [(c.name, c.layer) for c in sched]
    skip_pos = skip_position(tc)
    want = [("w0", None)]
    for i in range(1, 8):
        want += [("wt", i - 1)] * 4 + ([("wskip", None)] if i == skip_pos else [])
    want += [("wbn", None)] * (4 * bmild) + [("wc0", None)] * 4
    assert order == want
    # each matrix's rows exactly once, slab after slab
    rows = {}
    for c in sched:
        rows.setdefault((c.name, c.layer), []).append(c.k0)
    for (name, layer), k0s in rows.items():
        w = getattr(packed, name)
        w = w if layer is None else w[layer]
        assert k0s == list(range(0, w.shape[0], 64)) and all(c.n == w.shape[1] for c in sched
                                                             if (c.name, c.layer) == (name, layer))
    # the producer's byte offsets and sizes are the schedule's, and the bytes
    # sum to the network's matrices
    offsets = np.cumsum([0] + [c.nbytes for c in sched])[:-1].tolist()
    assert _producer(len(sched)) == list(zip(offsets, [c.nbytes for c in sched]))
    matrix_bytes = sum(getattr(packed, n).numel() * 2 for n in MATRICES
                       if getattr(packed, n) is not None)
    assert sum(c.nbytes for c in sched) == matrix_bytes == ray_wgmma.pack_stream(packed, tc).numel() * 2


def test_stream_is_made_once_per_packed_weights():
    packed, tc = _packed("reference")
    s1 = ray_wgmma.stream_for(packed, tc)
    assert ray_wgmma.stream_for(packed, tc) is s1
    # other matrices under the same w0: a new stream
    wt = packed.wt.clone()
    wt[0, 0, 0] += 1
    s2 = ray_wgmma.stream_for(packed._replace(wt=wt), tc)
    assert s2 is not s1 and not torch.equal(s1, s2)


# -- the dispatch rule of _launch --------------------------------------------

FORMS = ["raw_f32", "raw_bf16", "planar", "composited"]


ROUTES = [0, quant.ROUTE_INT8, quant.ROUTE_INT16, quant.ROUTE_INT8_COMPUTE]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("route", ROUTES)
def test_kernel_library_by_route_and_form(route, form):
    # every form and mode on every weight route goes to that route's build
    # of ray_wgmma.cu; the WMMA builds of render_samples.cu stay built
    lib = render_kernel.kernel_library(route, form == "composited")
    assert lib == ray_wgmma.LIBRARIES[route] and lib.startswith("ray_wgmma")
    assert lib in _ext.LIBRARIES and render_kernel._LIBRARY[route] in _ext.LIBRARIES
    assert ray_wgmma.LIBRARIES[0] == ray_wgmma.LIBRARY == "ray_wgmma"


class _Fn:
    """A C entry point that records its calls and returns cudaSuccess."""

    def __init__(self, name, calls):
        self.name, self.calls, self.argtypes, self.restype = name, calls, None, None

    def __call__(self, *args):
        assert len(args) == len(self.argtypes)
        self.calls.append(self.name)
        return 0


class _Lib:
    def __init__(self, name, calls):
        self.name = name
        self.ray_render = _Fn(f"{name}.ray_render", calls)
        self.ray_wgmma_render = _Fn(f"{name}.ray_wgmma_render", calls)
        self.ray_wgmma_render.argtypes = ray_wgmma.ARGTYPES     # what ray_wgmma.load sets


def _weights_of_route(route, variant="reference", seed=0):
    """Seeded weights on a route: bf16 ``PackedWeights``, or float32 ones
    quantized as the engines quantize them."""
    if route == 0:
        return _packed(variant, seed)
    packed, tc = _packed(variant, seed, torch.float32)
    if route == quant.ROUTE_INT8_COMPUTE:
        return quant.quantize_packed_int8(packed, pos_bound=8.0), tc
    return quant.quantize_packed(packed, 8 if route == quant.ROUTE_INT8 else 16), tc


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("depths", ["uniform", "per_ray"])
@pytest.mark.parametrize("form", FORMS)
def test_launch_reaches_the_library_of_the_rule(monkeypatch, form, depths, route):
    # _launch on each weight route, with the libraries replaced by
    # recorders: every form and mode calls the route's Hopper entry (and
    # counts wgmma_*); nothing else is called
    calls = []
    monkeypatch.setattr(_ext, "load", lambda name: _Lib(name, calls))
    monkeypatch.setattr(ray_wgmma, "load", lambda name=ray_wgmma.LIBRARY: _Lib(name, calls))
    monkeypatch.setattr(_ext, "stream_ptr", lambda dev: ctypes.c_void_p(0))
    weights, tc = _weights_of_route(route)
    R, S = 3, 8
    ro, rd = torch.zeros(R, 3), torch.ones(R, 3)
    z = torch.linspace(2.0, 6.0, S).expand(R, S).contiguous() if depths == "per_ray" else None
    kw = {"raw_f32": {}, "raw_bf16": {"raw_dtype": torch.bfloat16}, "planar": {"planar": True},
          "composited": {"composited": True}}[form]
    before = dict(render_kernel.launches)
    render_kernel._launch(weights, ro, rd, 2.0, 6.0, S, tc, z_vals=z, **kw)
    fn = "render_samples" if z is None else "render_zvals"
    assert calls == [f"{ray_wgmma.LIBRARIES[route]}.ray_wgmma_render"]
    counted = {f"{fn}_composited" if form == "composited" else fn,
               "wgmma_samples" if z is None else "wgmma_zvals"}
    counted |= {"raw_bf16"} if form == "raw_bf16" else {"planar"} if form == "planar" else set()
    counted |= {quant.ROUTE_INT8_COMPUTE: {"int8"}, 0: set()}.get(route, {"dequant"})
    moved = {k for k in before if render_kernel.launches[k] != before[k]}
    assert moved == counted and all(render_kernel.launches[k] == before[k] + 1 for k in moved)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("depths", ["uniform", "per_ray"])
def test_wmma_build_is_reached_only_when_named(monkeypatch, depths, route):
    # library= names the route's WMMA build of render_samples.cu (chip_smoke's
    # timings): its composited entry is called, the launch counts as the
    # composited function's and its route's, and not as a Hopper launch
    calls = []
    monkeypatch.setattr(_ext, "load", lambda name: _Lib(name, calls))
    monkeypatch.setattr(ray_wgmma, "load", lambda name=ray_wgmma.LIBRARY: _Lib(name, calls))
    monkeypatch.setattr(_ext, "stream_ptr", lambda dev: ctypes.c_void_p(0))
    weights, tc = _weights_of_route(route)
    R, S = 3, 8
    z = torch.linspace(2.0, 6.0, S).expand(R, S).contiguous() if depths == "per_ray" else None
    before = dict(render_kernel.launches)
    render_kernel._launch(weights, torch.zeros(R, 3), torch.ones(R, 3), 2.0, 6.0, S, tc,
                          z_vals=z, composited=True, library=render_kernel._LIBRARY[route])
    assert calls == [f"{render_kernel._LIBRARY[route]}.ray_render"]
    counted = {"render_samples_composited" if z is None else "render_zvals_composited"}
    counted |= {quant.ROUTE_INT8_COMPUTE: {"int8"}, 0: set()}.get(route, {"dequant"})
    moved = {k for k in before if render_kernel.launches[k] != before[k]}
    assert moved == counted and all(render_kernel.launches[k] == before[k] + 1 for k in moved)


def test_hopper_library_refuses_what_it_does_not_compute(monkeypatch):
    packed, tc = _packed("reference")
    ro, rd = torch.zeros(3, 3), torch.ones(3, 3)
    with pytest.raises(ValueError, match="planar"):
        render_kernel._launch(packed, ro, rd, 2.0, 6.0, 8, tc, composited=True, planar=True,
                              library=ray_wgmma.LIBRARY)
    q = quant.quantize_packed(packed, 8)
    with pytest.raises(ValueError, match="bf16 weights"):
        render_kernel._launch(q, ro, rd, 2.0, 6.0, 8, tc, library=ray_wgmma.LIBRARY)


# -- the streamed weights against the JAX kernel -----------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_streamed_weights_render_like_the_pallas_kernel(variant):
    # the matrices read back from the stream, in the plain version of K1 at
    # float32, against the JAX package's K1 in interpret mode (rtol/atol 1e-4
    # as tests/test_render_kernel.py)
    jc, tc = _cfgs(variant)
    p = _numpy_params(variant, 11)
    packed = pack_params(params_from_numpy(p, "cpu"), tc, torch.float32)
    as_bf16 = PackedWeights(*[None if t is None else t.to(torch.bfloat16)
                              if not n.startswith("b") else t
                              for n, t in packed._asdict().items()])
    back = ray_wgmma.unpack_stream(ray_wgmma.pack_stream(as_bf16, tc), tc)
    # the stream carries bf16 matrices: the float32 reference gets the same
    # rounded values, so both sides compute on identical weights
    rounded = packed._replace(**{n: m.float() for n, m in back.items()},
                              wsig=packed.wsig.bfloat16().float(),
                              wdir=packed.wdir.bfloat16().float(),
                              wc1=packed.wc1.bfloat16().float())
    jp = jax.tree_util.tree_map(lambda a: np.asarray(a), p)
    jp = jax.tree_util.tree_map(lambda a: a.astype(np.float32), jp)
    jp = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
        if a.ndim == 2 else a, jp)
    rng = np.random.default_rng(3)
    ro = np.zeros((21, 3), np.float32)
    ro[:, 2] = 4.0
    rd = (rng.normal(size=(21, 3)) * [0.2, 0.2, 1.0]).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) - 0.5
    raw_j, _ = jfrs(jp, jnp.asarray(ro), jnp.asarray(rd), 2.0, 6.0, 16, jc,
                    dtype=jnp.float32, interpret=True, raw=True)
    raw = fused_render_samples_plain(rounded, torch.tensor(ro), torch.tensor(rd), 2.0, 6.0, 16,
                                     tc)
    np.testing.assert_allclose(raw.numpy(), np.asarray(raw_j), rtol=1e-4, atol=1e-4)


# -- the quantized routes' streams -------------------------------------------

QROUTES = [quant.ROUTE_INT8, quant.ROUTE_INT16, quant.ROUTE_INT8_COMPUTE]


@pytest.mark.parametrize("route", QROUTES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_quantized_stream_unpacks_bit_for_bit(variant, route):
    q, tc = _weights_of_route(route, variant, seed=2)
    stream = ray_wgmma.pack_stream(q, tc)
    assert stream.dtype == torch.uint8 and stream.dim() == 1
    assert stream.numel() == sum(c.nbytes for c in ray_wgmma.chunk_schedule(tc, route))
    back = ray_wgmma.unpack_stream(stream, tc, route)
    mats = {f"{n}_q" for n in MATRICES if getattr(q, f"{n}_q") is not None}
    # the dequantize chunks carry their matrix's scales; the s8 chunks none
    dequant = {c.name for c in ray_wgmma.chunk_schedule(tc, route) if c.fmt != "s8"}
    assert set(back) == mats | {f"{n}_s" for n in dequant}
    for name in back:
        want = getattr(q, name)
        assert back[name].dtype == want.dtype and torch.equal(back[name], want), name


def _int_bits_to_f32(bits):
    return bits.to(torch.int32).view(torch.float32)


def _convert_plain(chunk, fmt, n):
    """The producer's conversion of one landed dequantize chunk
    (csrc/ray_wgmma.cu convert_chunk): f32(q) built from the bits of 2^23 +
    (q + 2^(b-1)), less 2^23 + 2^(b-1); times the image row's scale; rounded
    to bf16. The element order is the bf16 image's."""
    es = 1 if fmt == "int8" else 2
    img, scales = chunk[:64 * n * es], chunk[64 * n * es:].view(torch.float32)
    q = img.view(torch.int8 if es == 1 else torch.int16).to(torch.int32)
    offset = (q & (0xFF if es == 1 else 0xFFFF)) ^ (0x80 if es == 1 else 0x8000)
    f = _int_bits_to_f32(0x4B000000 | offset) - (8388736.0 if es == 1 else 8421376.0)
    return (f * scales.repeat_interleave(64)).to(torch.bfloat16)


@pytest.mark.parametrize("route", QROUTES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_producer_conversion_is_the_dequantized_image(variant, route):
    # each dequantize chunk, converted as the producer converts it, is the
    # bf16 route's chunk of dequantize(q) bit for bit: bf16(f32(q) * s[col])
    q, tc = _weights_of_route(route, variant, seed=3)
    stream = ray_wgmma.pack_stream(q, tc)
    deq = quant.dequantize(q, torch.bfloat16)
    at, seen = 0, 0
    for c in ray_wgmma.chunk_schedule(tc, route):
        if c.fmt != "s8":
            w = getattr(deq, c.name)
            w = w if c.layer is None else w[c.layer]
            got = _convert_plain(stream[at:at + c.nbytes], c.fmt, c.n)
            want = ray_wgmma._swizzled(w[c.k0:c.k0 + 64])
            assert got.view(torch.int16).equal(want.view(torch.int16)), (c.name, c.layer, c.k0)
            seen += 1
        at += c.nbytes
    assert seen == (4 * (variant == "bmild") + 4 if route == quant.ROUTE_INT8_COMPUTE
                    else len(ray_wgmma.chunk_schedule(tc, route)))


def _s8_fragments(h):
    """quantize_rows of csrc/ray_wgmma.cu for one consumer's 64 rows ``h``
    [64, 256] (bf16 values): each thread's accumulator columns (warp w, lane
    = 4 g + q: rows 16 w + g and + 8, columns 8 J + 2 q + e) quantized per
    row and packed as its s8 A fragments aq[kk][r] = bytes of (block 4 kk + 2
    (r >> 1), block + 1) x (e = 0, 1), then placed where the PTX fragment
    layout of m64nNk32 puts them: row g (r = 0, 2) or g + 8, K position 32 kk
    + 16 (r >> 1) + 4 q + byte. Returns the A operand [64, 256] (int64) and
    each row's absmax."""
    ax = h.abs().amax(1)
    inv = 127.0 / torch.clamp(ax, min=1e-20)
    a = torch.zeros(64, 256, dtype=torch.int64)
    for w in range(4):
        for lane in range(32):
            g, q = lane // 4, lane % 4
            for kk in range(8):
                for r in range(4):
                    row = 16 * w + g + 8 * (r & 1)
                    blocks = (4 * kk + 2 * (r >> 1), 4 * kk + 2 * (r >> 1) + 1)
                    cols = [8 * j + 2 * q + e for j in blocks for e in (0, 1)]
                    vals = torch.round(h[row, cols] * inv[row]).to(torch.int64)
                    a[row, 32 * kk + 16 * (r >> 1) + 4 * q + torch.arange(4)] = vals
    return a, ax


@pytest.mark.parametrize("variant", VARIANTS)
def test_s8_stream_permutation_gives_int8_mm_products(variant):
    # a trunk layer's two s8 chunks as the B operand (K positions in the
    # stream's order) times the A fragments the consumers build from a
    # layer's output: the integer sums of quant.int8_mm in the natural order,
    # exactly, and its float result too
    q, tc = _weights_of_route(quant.ROUTE_INT8_COMPUTE, variant, seed=4)
    stream = ray_wgmma.pack_stream(q, tc)
    rng = np.random.default_rng(5)
    h = torch.relu(torch.tensor(rng.normal(size=(64, 256)), dtype=torch.float32))
    h = h.bfloat16().float()
    h[7] = 0.0                                           # a row the ReLU left empty
    a, ax = _s8_fragments(h)
    at, slabs = 0, {}
    for c in ray_wgmma.chunk_schedule(tc, quant.ROUTE_INT8_COMPUTE):
        if c.fmt == "s8":
            img = stream[at:at + c.nbytes].view(torch.int8)
            slabs.setdefault((c.name, c.layer), []).append(ray_wgmma._unswizzled(img, c.n, c.k))
        at += c.nbytes
    for layer in range(7):
        b = torch.cat(slabs[("wt", layer)]).to(torch.int64)          # [256 K positions, 256]
        acc = a @ b
        aq = torch.round(h * (127.0 / torch.clamp(ax, min=1e-20))[:, None])
        assert torch.equal(acc, (aq.to(torch.int64) @ q.wt_q[layer].to(torch.int64)))
        got = (acc.float() * ax[:, None]) * (q.wt_s[layer] * (1.0 / 127.0))
        assert torch.equal(got, quant.int8_mm(h, q.wt_q[layer], q.wt_s[layer]))
    # w0 and wskip: the first 64 of their 128 rows, the rest zero
    for name in ("w0", "wskip"):
        (b,) = slabs[(name, None)]
        assert torch.equal(b[:64], getattr(q, f"{name}_q")) and not b[64:].any()


def test_k_perm_is_a_permutation_within_each_16():
    assert sorted(ray_wgmma.K_PERM.tolist()) == list(range(256))
    assert torch.equal(ray_wgmma.K_PERM // 16, torch.arange(256) // 16)
    assert torch.equal(ray_wgmma.K_PERM[ray_wgmma.K_UNPERM], torch.arange(256))


def _chunk_offset(j, n, route):
    """chunk_offset / conv_cols of csrc/ray_wgmma.cu on a quantized route."""
    es = 2 if route == quant.ROUTE_INT16 else 1
    conv = lambda cols: cols * (64 * es + 4)
    nd = 16 if route == quant.ROUTE_INT8_COMPUTE else 0
    if j <= nd:
        return j * 32768
    return nd * 32768 + (min(j, n - 4) - nd) * conv(256) + max(j - (n - 4), 0) * conv(128)


@pytest.mark.parametrize("route", QROUTES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_producer_offsets_match_the_schedule(variant, route):
    # the producer's arithmetic for each chunk (offset, whether it is copied
    # as it is, its columns) against the stream's layout; a landing slot
    # (LAND_BYTES) holds the largest dequantize chunk
    _, tc = _cfgs(variant)
    sched = ray_wgmma.chunk_schedule(tc, route)
    n, bmild = len(sched), variant == "bmild"
    # stream_chunks(bmild) of csrc/ray_wgmma.cu
    assert n == 1 + 7 * (2 if route == quant.ROUTE_INT8_COMPUTE else 4) + 1 + 4 * bmild + 4
    offsets = np.cumsum([0] + [c.nbytes for c in sched])[:-1].tolist()
    nd = 16 if route == quant.ROUTE_INT8_COMPUTE else 0
    for j, c in enumerate(sched):
        assert _chunk_offset(j, n, route) == offsets[j]
        assert (c.fmt == "s8") == (j < nd) and c.n == (128 if j >= n - 4 else 256)
        if c.fmt == "s8":
            assert c.nbytes == 32768 and c.k == 128
    land = 256 * (64 * (2 if route == quant.ROUTE_INT16 else 1) + 4)
    assert max(c.nbytes for c in sched if c.fmt != "s8") <= land and land % 1024 == 0


def test_quantized_stream_is_made_once_per_weights():
    q, tc = _weights_of_route(quant.ROUTE_INT8)
    s1 = ray_wgmma.stream_for(q, tc)
    assert ray_wgmma.stream_for(q, tc) is s1 and s1.dtype == torch.uint8
    # other scales under the same w0_q: a new stream
    s2 = ray_wgmma.stream_for(q._replace(wt_s=q.wt_s * 2), tc)
    assert s2 is not s1 and not torch.equal(s1, s2)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("bits,act_bits", [(8, None), (16, None), (8, 8)])
def test_quantized_stream_renders_like_the_pallas_kernel(variant, bits, act_bits):
    # the JAX package's quantized weights, carried into this package's
    # layout, through the stream and back, in the plain version of K1 and K3
    # at float32 against the JAX kernels in interpret mode (tolerances of
    # tests/test_torch_quant.py::test_ray_kernels_plain_match_pallas_interpret)
    jc, tc = _cfgs(variant)
    jq, _ = jquant.quantize_model({"fine": _numpy_params(variant, 6)}, jc, bits=bits,
                                  prune_fraction=0.0, act_bits=act_bits, pos_bound=8.0)
    jq = jq["fine"]
    tq = quant.quantized_from_numpy(
        {k: None if v is None else np.asarray(v) for k, v in jq._asdict().items()}, tc, "cpu")
    route = quant.route_of(tq)
    back = ray_wgmma.unpack_stream(ray_wgmma.pack_stream(tq, tc), tc, route)
    streamed = tq._replace(**back)
    rng = np.random.default_rng(4)
    ro = np.zeros((21, 3), np.float32)
    ro[:, 2] = 4.0
    rd = (rng.normal(size=(21, 3)) * [0.2, 0.2, 1.0]).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) - 0.5
    z = np.sort(np.random.default_rng(5).uniform(2.0, 6.0, (21, 16)), axis=1).astype(np.float32)
    kw = dict(dtype=jnp.float32, interpret=True)
    raw1_j, _ = jfrs(jq, jnp.asarray(ro), jnp.asarray(rd), 2.0, 6.0, 16, jc, raw=True, **kw)
    from nerf_tpu.ops.render_kernel import fused_render_zvals_raw as jfrz
    raw3_j = jfrz(jq, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z), jc, **kw)
    raw1 = fused_render_samples_plain(streamed, torch.tensor(ro), torch.tensor(rd), 2.0, 6.0, 16,
                                      tc, torch.float32)
    raw3 = render_kernel.fused_render_zvals_plain(streamed, torch.tensor(ro), torch.tensor(rd),
                                                  torch.tensor(z), tc, torch.float32)
    for got, want in ((raw1, raw1_j), (raw3, raw3_j)):
        got, want = got.numpy().reshape(-1, 4), np.asarray(want).reshape(-1, 4)
        if act_bits is None:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        else:
            scale = max(float(np.abs(want[:, 0]).max()), 1.0)
            assert np.abs(got[:, 1:] - want[:, 1:]).max() < 2e-3
            assert np.abs(got[:, 0] - want[:, 0]).max() < 1e-2 * scale


# -- the composited modes' schedule ------------------------------------------

# (rays, grid): ray counts that fill no lane evenly, grids smaller than the
# lanes the rays could fill (several rays a lane), and one of a ray a lane
SCHEDULES = [(37, 3), (29, 5), (11, 6)]


@pytest.mark.parametrize("S", [8, 64, 100, 192, 200])
@pytest.mark.parametrize("rays,grid", SCHEDULES)
def test_schedule_visits_every_row_once(rays, grid, S):
    # each row of every ray in exactly one consumer's step, each lane's rows
    # in order; a lane's rays differ from its block neighbour's by at most
    # one, so their step counts by at most ceil(S / 64)
    seen = np.zeros(rays * S, np.int64)
    lanes = ray_wgmma.lane_rays(rays, 2 * grid)
    assert lanes[0][0] == 0 and lanes[-1][1] == rays
    assert all(a[1] == b[0] for a, b in zip(lanes, lanes[1:]))
    for b, block in enumerate(ray_wgmma.composited_schedule(rays, S, grid)):
        pair = lanes[2 * b:2 * b + 2]
        steps = [ray_wgmma.lane_steps(r, S) for r in pair]
        assert len(block) == max(steps) and abs(steps[0] - steps[1]) <= -(-S // 64)
        for c, (begin, end) in enumerate(pair):
            rows = [block[k][c] for k in range(len(block))]
            at = begin * S
            for k, (n0, stop) in enumerate(rows):
                if k < steps[c]:
                    assert n0 == at and stop == min(at + 64, end * S)
                    seen[n0:stop] += 1
                    at = stop
                else:
                    assert stop == n0           # a lane past its rows composites nothing
            assert at == end * S
    assert (seen == 1).all()


def test_composited_grid_gives_two_lanes_a_block():
    # one block an SM, but no more blocks than half the rays, rounded up
    assert [ray_wgmma.composited_grid(r, 132) for r in (0, 1, 2, 3, 263, 264, 265, 16384)] == [
        1, 1, 1, 2, 132, 132, 132, 132]
    counts = [b - a for a, b in ray_wgmma.lane_rays(16384, 264)]
    assert set(counts) == {62, 63} and sum(counts) == 16384
    # the balance at the frames' chunk: 186 or 189 steps a lane at 192 depths
    assert {ray_wgmma.lane_steps(r, 192) for r in ray_wgmma.lane_rays(16384, 264)} == {186, 189}
    # the kernel's 32-bit form of a lane's first ray (csrc/ray_wgmma.cu
    # lane_first_ray): L R // lanes = L q + L m // lanes with R = q lanes + m
    for n_rays in (1, 7, 1001, 16384, 2 ** 31 - 1):
        for lanes in (2, 6, 264):
            q, m = divmod(n_rays, lanes)
            assert [lane * q + lane * m // lanes for lane in range(lanes + 1)] == [
                a for a, _ in ray_wgmma.lane_rays(n_rays, lanes)] + [n_rays]


def _trained_rays(n, seed):
    """Rays into the trained procedural scene: origins on a sphere of radius
    4 looking at the centre, jittered."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o / 4.0 + rng.normal(size=(n, 3)) * 0.15
    return torch.tensor(o, dtype=torch.float32), torch.tensor(d, dtype=torch.float32)


@pytest.fixture(scope="module")
def trained_packed():
    """The trained reference network (float32 packing): opaque and clear
    rays both, so the carries matter."""
    path = Path(__file__).resolve().parents[1] / "results" / "convergence" / "final_params.npz"
    cfg = default_config().model
    fine = params_from_numpy(restore_bare_params(str(path))["fine"], "cpu")
    return pack_params(fine, cfg, torch.float32), cfg


@pytest.mark.parametrize("S", [8, 64, 100, 192, 200])
@pytest.mark.parametrize("depths", ["uniform", "per_ray"])
@pytest.mark.parametrize("rays,grid", SCHEDULES[:2])
def test_scheduled_compositing_matches_the_plain_composited_modes(trained_packed, rays, grid,
                                                                  depths, S):
    # the plain compositing walked along the kernel's schedule (64-row steps
    # of whole-ray lanes, 32-row pieces, carries through the lane's state)
    # against fused_render_*_composited_plain on the same network: rgb,
    # depth, acc and every weight within 1e-6 (float32 sums in another order)
    packed, cfg = trained_packed
    ro, rd = _trained_rays(rays, seed=S)
    sent, eps = 1e10, 1e-10
    if depths == "uniform":
        raw = render_kernel.fused_render_samples_plain(packed, ro, rd, 2.0, 6.0, S, cfg)
        z = render_kernel._uniform_z(2.0, 6.0, S, "cpu").expand(rays, S)
        want = render_kernel.fused_render_samples_composited_plain(packed, ro, rd, 2.0, 6.0, S,
                                                                   cfg, sent, eps)
        got = ray_wgmma.composite_on_schedule_plain(raw, z, rd, grid, sent, eps,
                                                    dz=(6.0 - 2.0) / (S - 1))
    else:
        z = torch.tensor(np.sort(np.random.default_rng(S).uniform(2.0, 6.0, (rays, S)), axis=1),
                         dtype=torch.float32)
        raw = render_kernel.fused_render_zvals_plain(packed, ro, rd, z, cfg)
        want = render_kernel.fused_render_zvals_composited_plain(packed, ro, rd, z, cfg, sent, eps)
        got = ray_wgmma.composite_on_schedule_plain(raw, z, rd, grid, sent, eps)
    acc = want[0][:, 4]
    assert float(acc.max()) > 0.5 and float(acc.min()) < 0.5    # opaque rays and clear ones
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), atol=1e-6, rtol=0)
