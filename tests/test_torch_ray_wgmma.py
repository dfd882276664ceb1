"""The Hopper ray kernels' host side (``ops/ray_wgmma.py``, the dispatch of
``render_kernel._launch``): the weight stream's layout against
``pack_params`` bit for bit, the producer's chunk schedule, which library a
launch reaches, and the streamed weights rendering like the JAX Pallas
kernel (interpret mode). The CUDA kernel itself (``csrc/ray_wgmma.cu``) runs
only on the card; ``chip_smoke.py`` holds it against the plain versions."""

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.config import ModelConfig as JModelConfig
from nerf_tpu.config import bmild_config as jbmild
from nerf_tpu.models.nerf import init_nerf_params as jinit
from nerf_tpu.ops.render_kernel import fused_render_samples as jfrs
from nerf_tpu_torch.config import ModelConfig
from nerf_tpu_torch.models.nerf import params_from_numpy
from nerf_tpu_torch.ops import _ext, quant, ray_wgmma, render_kernel
from nerf_tpu_torch.ops.mlp_kernel import PackedWeights, pack_params, skip_position
from nerf_tpu_torch.ops.render_kernel import fused_render_samples_plain

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


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("route", [0, quant.ROUTE_INT8, quant.ROUTE_INT16,
                                   quant.ROUTE_INT8_COMPUTE])
def test_kernel_library_by_route_and_form(route, form):
    # the Hopper kernel serves exactly the bf16 route's raw forms; every
    # other launch keeps its build of render_samples.cu
    lib = render_kernel.kernel_library(route, form == "composited")
    if route == 0 and form != "composited":
        assert lib == ray_wgmma.LIBRARY == "ray_wgmma"
    else:
        assert lib == render_kernel._LIBRARY[route] and lib.startswith("render_samples")
    assert lib in _ext.LIBRARIES


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


@pytest.mark.parametrize("depths", ["uniform", "per_ray"])
@pytest.mark.parametrize("form", FORMS)
def test_launch_reaches_the_library_of_the_rule(monkeypatch, form, depths):
    # _launch on bf16 weights, with the libraries replaced by recorders: the
    # raw forms call the Hopper entry (and count wgmma_*), the composited
    # modes the WMMA build; nothing else is called
    calls = []
    monkeypatch.setattr(_ext, "load", lambda name: _Lib(name, calls))
    monkeypatch.setattr(ray_wgmma, "load", lambda: _Lib(ray_wgmma.LIBRARY, calls))
    monkeypatch.setattr(_ext, "stream_ptr", lambda dev: ctypes.c_void_p(0))
    packed, tc = _packed("reference")
    R, S = 3, 8
    ro, rd = torch.zeros(R, 3), torch.ones(R, 3)
    z = torch.linspace(2.0, 6.0, S).expand(R, S).contiguous() if depths == "per_ray" else None
    kw = {"raw_f32": {}, "raw_bf16": {"raw_dtype": torch.bfloat16}, "planar": {"planar": True},
          "composited": {"composited": True}}[form]
    before = dict(render_kernel.launches)
    render_kernel._launch(packed, ro, rd, 2.0, 6.0, S, tc, z_vals=z, **kw)
    fn = "render_samples" if z is None else "render_zvals"
    if form == "composited":
        assert calls == ["render_samples.ray_render"]
        counted = {f"{fn}_composited"}
    else:
        assert calls == ["ray_wgmma.ray_wgmma_render"]
        counted = {fn, "wgmma_samples" if z is None else "wgmma_zvals"}
        counted |= {"raw_bf16"} if form == "raw_bf16" else {"planar"} if form == "planar" else set()
    moved = {k for k in before if render_kernel.launches[k] != before[k]}
    assert moved == counted and all(render_kernel.launches[k] == before[k] + 1 for k in moved)


def test_hopper_library_refuses_what_it_does_not_compute(monkeypatch):
    packed, tc = _packed("reference")
    ro, rd = torch.zeros(3, 3), torch.ones(3, 3)
    with pytest.raises(ValueError, match="raw output"):
        render_kernel._launch(packed, ro, rd, 2.0, 6.0, 8, tc, composited=True,
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
