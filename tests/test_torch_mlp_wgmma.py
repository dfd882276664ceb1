"""The per-sample Hopper kernel's host side (K4, and K7 on quantized weights:
``mlp_wgmma_forward`` of ``csrc/ray_wgmma.cu``): its weight stream
(``ops/ray_wgmma.sample_chunk_schedule``, ``pack_sample_stream``,
``sample_stream_for``) against the weights bit for bit on every route, the
producer's offsets for its schedule, the stream as the prefix of K5's,
the plain versions on the unpacked matrices against the JAX Pallas kernels in
interpret mode, which library a launch reaches, and what a train step's
forward makes of the stream. The CUDA kernel itself runs only on the card;
``chip_smoke.py`` holds it against the plain versions there."""

import ctypes
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.config import ModelConfig as JModelConfig
from nerf_tpu.config import bmild_config as jbmild
from nerf_tpu.models.nerf import init_nerf_params as jinit
from nerf_tpu.ops import quant as jquant
from nerf_tpu.ops.mlp_kernel import fused_nerf_apply as jfused_nerf_apply
from nerf_tpu_torch.config import ModelConfig
from nerf_tpu_torch.models.nerf import init_nerf_params, params_from_numpy
from nerf_tpu_torch.ops import _ext, dequant_stream, mlp_kernel, quant, ray_wgmma, train_kernel
from nerf_tpu_torch.ops.mlp_kernel import fused_nerf_apply_plain, pack_params
from nerf_tpu_torch.ops.quant import quantized_from_numpy, quantized_nerf_apply_plain
from nerf_tpu_torch.utils.tree import tree_from_leaves, tree_leaves

VARIANTS = ["reference", "bmild"]
ROUTES = [0, quant.ROUTE_INT8, quant.ROUTE_INT16, quant.ROUTE_INT8_COMPUTE]
MATRICES = ("w0", "wt", "wskip", "wbn", "wc0", "wdir")


def _cfgs(variant):
    jc = JModelConfig() if variant == "reference" else jbmild().model
    return jc, ModelConfig(**dataclasses.asdict(jc))


def _numpy_params(variant, seed):
    return jax.device_get(jinit(jax.random.PRNGKey(seed), _cfgs(variant)[0]))


def _np(q):
    return {k: None if v is None else np.asarray(v) for k, v in q._asdict().items()}


def _carried(variant, route, seed=0):
    """The JAX package's weights of a seeded network on a route: numpy params
    (route 0) or its quantized weights; and the port's weights on the same
    route (bf16 ``PackedWeights``, or the JAX quantized tensors carried
    across)."""
    jc, tc = _cfgs(variant)
    p = _numpy_params(variant, seed)
    if route == 0:
        return jc, tc, p, pack_params(params_from_numpy(p, "cpu"), tc, torch.bfloat16)
    bits = 16 if route == quant.ROUTE_INT16 else 8
    act = 8 if route == quant.ROUTE_INT8_COMPUTE else None
    jq, _ = jquant.quantize_model({"fine": p}, jc, bits=bits, prune_fraction=0.0,
                                  act_bits=act, pos_bound=2.0)
    return jc, tc, jq["fine"], quantized_from_numpy(_np(jq["fine"]), tc, "cpu")


def _inputs(n, seed, lim=1.5):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-lim, lim, (n, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32))


def _from_stream(weights, back):
    """``weights`` with every matrix (and dequantize scale) the stream carries
    replaced by its unpacked copy, ``wdir``'s padding rows dropped."""
    rows = weights.wdir.shape[0] if not quant.is_quantized(weights) else weights.wdir_q.shape[0]
    fields = {k: (v[:rows] if k in ("wdir", "wdir_q") else v) for k, v in back.items()}
    return weights._replace(**fields)


# -- the per-sample stream's layout ------------------------------------------

@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_sample_stream_unpacks_to_the_weights_bit_for_bit(variant, route):
    _, tc, _, w = _carried(variant, route, seed=1)
    stream = ray_wgmma.pack_sample_stream(w, tc)
    sched = ray_wgmma.sample_chunk_schedule(tc, route)
    assert stream.dim() == 1 and stream.numel() * stream.element_size() == sum(
        c.nbytes for c in sched) == ray_wgmma.sample_stream_bytes(tc, route)
    back = ray_wgmma.unpack_sample_stream(stream, tc, route)
    suffix = "_q" if route else ""
    mats = {n + suffix for n in MATRICES if getattr(w, n + suffix) is not None}
    dequant = {c.name for c in sched if c.fmt in ("int8", "int16")}
    assert set(back) == mats | {f"{n}_s" for n in dequant}
    # wdir: its rows, then zero rows up to 64; everything else as it is
    wdir = back.pop("wdir" + suffix)
    want = getattr(w, "wdir" + suffix)
    assert wdir.shape == (64, 128) and wdir.dtype == want.dtype
    assert torch.equal(wdir[:want.shape[0]], want) and not wdir[want.shape[0]:].any()
    for name, got in back.items():
        want = getattr(w, name)
        assert got.dtype == want.dtype and torch.equal(got, want), name
    # the ray kernels' stream is its prefix: the per-sample one adds wdir
    ray = ray_wgmma.pack_stream(w, tc)
    assert torch.equal(stream[:ray.numel()], ray)


@pytest.mark.parametrize("variant", VARIANTS)
def test_sample_stream_is_made_once_per_packed_weights(variant):
    # the cache beside the weights: made once, apart from the ray kernels'
    # stream of the same weights, and made again for other matrices
    _, tc, _, w = _carried(variant, 0, seed=2)
    s1 = ray_wgmma.sample_stream_for(w, tc)
    assert ray_wgmma.sample_stream_for(w, tc) is s1 and s1.dtype == torch.bfloat16
    assert torch.equal(s1, ray_wgmma.pack_sample_stream(w, tc))
    assert ray_wgmma.stream_for(w, tc).numel() < s1.numel()
    wdir = w.wdir.clone()
    wdir[0, 0] += 1
    s2 = ray_wgmma.sample_stream_for(w._replace(wdir=wdir), tc)
    assert s2 is not s1 and not torch.equal(s1, s2)


def test_quantized_sample_stream_is_made_once_per_weights():
    _, tc, _, q = _carried("reference", quant.ROUTE_INT8, seed=3)
    s1 = ray_wgmma.sample_stream_for(q, tc)
    assert ray_wgmma.sample_stream_for(q, tc) is s1 and s1.dtype == torch.uint8
    s2 = ray_wgmma.sample_stream_for(q._replace(wdir_s=q.wdir_s * 2), tc)
    assert s2 is not s1 and not torch.equal(s1, s2)


def _producer_offset(j, n, route, ns):
    """chunk_offset of csrc/ray_wgmma.cu with ns 128-wide chunks at the end
    (the bf16 route: every chunk 32 KB but those, 16 KB)."""
    if route == 0:
        return j * 32768 - max(j - (n - ns), 0) * 16384
    es = 2 if route == quant.ROUTE_INT16 else 1
    conv = lambda cols: cols * (64 * es + 4)
    nd = 16 if route == quant.ROUTE_INT8_COMPUTE else 0
    if j <= nd:
        return j * 32768
    return nd * 32768 + (min(j, n - ns) - nd) * conv(256) + max(j - (n - ns), 0) * conv(128)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_producer_offsets_match_the_sample_schedule(variant, route):
    # the producer's arithmetic for every chunk of the per-sample stream
    # (n_small = 5: wc0's four slabs and wdir's) against the stream's layout;
    # a landing slot (LAND_BYTES) holds the largest dequantize chunk
    _, tc = _cfgs(variant)
    sched = ray_wgmma.sample_chunk_schedule(tc, route)
    n, bmild = len(sched), variant == "bmild"
    # mlp_wgmma_stream_chunks(bmild) of csrc/ray_wgmma.cu: stream_chunks + 1
    assert n == 1 + 7 * (2 if route == quant.ROUTE_INT8_COMPUTE else 4) + 1 + 4 * bmild + 4 + 1
    assert [(c.name, c.layer) for c in sched[-5:]] == [("wc0", None)] * 4 + [("wdir", None)]
    offsets = np.cumsum([0] + [c.nbytes for c in sched]).tolist()
    nd = 16 if route == quant.ROUTE_INT8_COMPUTE else 0
    for j, c in enumerate(sched):
        assert _producer_offset(j, n, route, 5) == offsets[j], (j, c)
        assert (c.fmt == "s8") == (j < nd) and c.n == (128 if j >= n - 5 else 256)
        assert c.k == (128 if c.fmt == "s8" else 64)
    assert _producer_offset(n, n, route, 5) == offsets[n]
    wdir = sched[-1]
    assert wdir.fmt == {0: "bf16", quant.ROUTE_INT16: "int16"}.get(route, "int8")
    if route:
        land = 256 * (64 * (2 if route == quant.ROUTE_INT16 else 1) + 4)
        assert max(c.nbytes for c in sched if c.fmt != "s8") <= land and land % 1024 == 0
        assert all(c.nbytes % 16 == 0 for c in sched)            # bulk copies: 16-byte units


@pytest.mark.parametrize("seed", [0, 4])
def test_forward_stream_is_the_prefix_of_bwd_stream(seed):
    # reference variant: the per-sample schedule heads K5's, so the stream a
    # train step gathers for K5 carries K4's stream as its first bytes
    _, tc, _, w = _carried("reference", 0, seed=seed)
    fwd = ray_wgmma.sample_chunk_schedule(tc)
    assert ray_wgmma.bwd_chunk_schedule(tc)[:len(fwd)] == fwd
    bwd = ray_wgmma.bwd_stream(w, tc)
    want = ray_wgmma.pack_sample_stream(w, tc)
    assert bwd.numel() > want.numel()
    assert torch.equal(bwd[:want.numel()].view(torch.int16), want.view(torch.int16))


# -- the plain versions on the unpacked matrices vs the Pallas kernels -------

@pytest.mark.parametrize("variant", VARIANTS)
def test_unpacked_stream_matches_pallas_interpret(variant):
    # float32 matrices through the stream's layout (the layout does not see
    # the dtype), the plain version on what comes back, against
    # fused_nerf_apply of the JAX package (interpret mode) at float32:
    # rtol/atol 1e-4 as tests/test_mlp_kernel.py; 333 rows, not a multiple of
    # the kernels' 128-row tile
    jc, tc = _cfgs(variant)
    p = _numpy_params(variant, 5)
    packed = pack_params(params_from_numpy(p, "cpu"), tc, torch.float32)
    back = ray_wgmma.unpack_sample_stream(ray_wgmma.pack_sample_stream(packed, tc), tc)
    streamed = _from_stream(packed, back)
    pos, dirs = _inputs(333, 6)
    out = fused_nerf_apply_plain(streamed, torch.tensor(pos), torch.tensor(dirs), tc)
    s_j, c_j = jfused_nerf_apply(p, jnp.asarray(pos), jnp.asarray(dirs), jc, 128, jnp.float32,
                                 True)
    assert out.shape == (333, 4)
    np.testing.assert_allclose(out[:, 0].numpy(), np.asarray(s_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out[:, 1:].numpy(), np.asarray(c_j), rtol=1e-4, atol=1e-4)


# tests/test_quant.py's tolerances for the port's plain K7 against the Pallas
# kernel at float32 (tests/test_torch_quant.py gives the reasons)
DEQUANT_TOL = 1e-4
INT8_RGB_TOL, INT8_SIGMA_TOL = 2e-3, 1e-2


@pytest.mark.parametrize("route", ROUTES[1:])
@pytest.mark.parametrize("variant", VARIANTS)
def test_unpacked_quantized_stream_matches_pallas_interpret(variant, route):
    jc, tc, jq, q = _carried(variant, route, seed=7)
    back = ray_wgmma.unpack_sample_stream(ray_wgmma.pack_sample_stream(q, tc), tc, route)
    streamed = _from_stream(q, back)
    pos, dirs = _inputs(300, 8)
    out = quantized_nerf_apply_plain(streamed, torch.tensor(pos), torch.tensor(dirs), tc,
                                     torch.float32)
    s_j, c_j = jquant.quantized_nerf_apply(jq, jnp.asarray(pos), jnp.asarray(dirs), jc,
                                           block=128, dtype=jnp.float32, interpret=True)
    s_t, c_t = out[:, 0].numpy(), out[:, 1:].numpy()
    if route != quant.ROUTE_INT8_COMPUTE:
        np.testing.assert_allclose(c_t, np.asarray(c_j), rtol=DEQUANT_TOL, atol=DEQUANT_TOL)
        np.testing.assert_allclose(s_t, np.asarray(s_j), rtol=DEQUANT_TOL, atol=DEQUANT_TOL)
    else:
        scale = float(np.abs(np.asarray(s_j)).max())
        assert np.abs(c_t - np.asarray(c_j)).max() < INT8_RGB_TOL
        assert np.abs(s_t - np.asarray(s_j)).max() < INT8_SIGMA_TOL * max(scale, 1.0)


# -- which library a launch reaches -------------------------------------------

class _Fn:
    def __init__(self, name, calls):
        self.name, self.calls = name, calls
        self.argtypes = self.restype = None

    def __call__(self, *args):
        self.calls.append((self.name, args))
        return 0


class _Lib:
    def __init__(self, name, calls):
        for fn in ("mlp_wgmma_forward", "dequant_stream"):
            setattr(self, fn, _Fn(f"{name}.{fn}", calls))


@pytest.fixture
def recorded(monkeypatch):
    calls = []
    monkeypatch.setattr(_ext, "load", lambda name: _Lib(name, calls))
    monkeypatch.setattr(ray_wgmma, "load", lambda name=ray_wgmma.LIBRARY: _Lib(name, calls))
    monkeypatch.setattr(_ext, "stream_ptr", lambda dev: ctypes.c_void_p(0))
    return calls


def _launch(weights, tc, *args):
    pos, dirs = torch.zeros(300, 3), torch.ones(300, 3)
    if quant.is_quantized(weights):
        return quant._launch(weights, pos, dirs, tc, torch.bfloat16, *args)
    return mlp_kernel._launch(weights, pos, dirs, tc, *args)


def _counts():
    return {"mlp_forward": mlp_kernel.launches, "dequant_stream": dequant_stream.launches,
            **quant.launches}


@pytest.mark.parametrize("route", ROUTES)
def test_launch_reaches_the_hopper_build_of_the_route(recorded, route):
    # every CUDA launch of K4 and K7 goes to the per-sample entry of the
    # route's build of ray_wgmma.cu, on the weights' cached per-sample stream
    # (on the dequantize routes: dequant_stream turns it into scratch, which
    # the bf16 build reads, without the scales), and counts under the
    # counter chip_smoke.py reads
    _, tc, _, w = _carried("reference", route, seed=9)
    before = _counts()
    _launch(w, tc)
    cached = ray_wgmma.sample_stream_for(w, tc).data_ptr()
    if route in (quant.ROUTE_INT8, quant.ROUTE_INT16):
        (prologue, dq_args), (name, args) = recorded
        assert prologue == "dequant_stream.dequant_stream" and dq_args[0].value == cached
        assert args[3].value == dq_args[5].value != cached and args[5] is None
    else:
        ((name, args),) = recorded
        assert args[3].value == cached
    assert name == f"{ray_wgmma.LIBRARIES[route]}.mlp_wgmma_forward" and args[2] == 300
    moved = {k: v - before[k] for k, v in _counts().items() if v != before[k]}
    if route == 0:
        assert moved == {"mlp_forward": 1}
    elif route == quant.ROUTE_INT8_COMPUTE:
        assert moved == {"mlp_quant": 1, "mlp_quant_int8": 1}
    else:
        assert moved == {"mlp_quant": 1, "dequant_stream": 1}


def test_hopper_entry_refuses_a_short_stream(recorded):
    _, tc, _, w = _carried("reference", 0, seed=9)
    short = ray_wgmma.pack_stream(w, tc)          # the ray kernels': no wdir chunk
    with pytest.raises(ValueError, match="weight stream"):
        _launch(w, tc, short)
    assert recorded == []


@pytest.mark.parametrize("route", ROUTES)
def test_cpu_tensors_launch_nothing(recorded, route):
    _, tc, _, w = _carried("bmild", route, seed=10)
    pos, dirs = _inputs(200, 11)
    before = _counts()
    if route:
        out = quant.quantized_nerf_apply(w, torch.tensor(pos), torch.tensor(dirs), tc)
    else:
        out = mlp_kernel.fused_nerf_apply(w, torch.tensor(pos), torch.tensor(dirs), tc)
    assert out[0].shape == (200,) and recorded == [] and _counts() == before


# -- a train step's forward and the stream ------------------------------------

def test_train_step_gathers_one_stream_per_network_and_shares_it(monkeypatch):
    # _TrainApply on tensors that are not on the CPU (meta tensors: shapes
    # only) with the launches recorded: the forward packs once and makes one
    # gather, K5's stream; K4 reads that very tensor (its prefix is K4's
    # stream); the backward packs nothing, gathers nothing and hands K5 the
    # same stream. Neither calls a per-chunk packing loop
    tc = _cfgs("reference")[1]
    params = init_nerf_params(torch.Generator().manual_seed(0), tc, "meta")
    for name in ("pack_stream", "pack_sample_stream"):
        monkeypatch.setattr(ray_wgmma, name,
                            lambda *a, _n=name, **k: pytest.fail(f"a train step called {_n}"))
    gathers = []
    real_gather = ray_wgmma.bwd_stream
    monkeypatch.setattr(ray_wgmma, "bwd_stream",
                        lambda w, cfg: gathers.append("bwd_stream") or real_gather(w, cfg))
    packs = []
    real_pack = train_kernel.pack_params
    monkeypatch.setattr(train_kernel, "pack_params",
                        lambda *a, **k: packs.append(1) or real_pack(*a, **k))
    launched = []

    def k4(packed, pos, dirs, cfg, stream=None):
        launched.append(("k4", stream))
        return torch.empty(pos.shape[0], 4, device=pos.device)

    def k5(packed, pos, dirs, dsig, drgb, cfg, stream=None):
        launched.append(("k5", stream))
        return {k: torch.zeros(s, device=pos.device) for k, s in train_kernel.GRAD_SHAPES.items()}

    monkeypatch.setattr(mlp_kernel, "_launch", k4)
    monkeypatch.setattr(train_kernel, "_launch", k5)
    n = 1000
    pos = torch.empty(n, 3, device="meta")
    paths, leaves = zip(*tree_leaves(params))
    ctx = SimpleNamespace(save_for_backward=lambda *t: setattr(ctx, "saved_tensors", t))
    spec = (tc, torch.bfloat16, paths)
    train_kernel._TrainApply.forward(ctx, pos, pos, spec, *leaves)
    assert packs == [1] and gathers == ["bwd_stream"]
    grads = train_kernel._TrainApply.backward(ctx, torch.empty(n, device="meta"),
                                              torch.empty(n, 3, device="meta"))
    assert len(grads) == 3 + len(leaves) and all(g is not None for g in grads[3:])
    assert packs == [1] and gathers == ["bwd_stream"]
    (k4_name, k4_stream), (k5_name, k5_stream) = launched
    assert (k4_name, k5_name) == ("k4", "k5") and k4_stream is k5_stream is ctx.stream
    assert k4_stream.numel() * 2 > ray_wgmma.sample_stream_bytes(tc)
    # the next step: new weights, one gather again
    train_kernel._TrainApply.forward(ctx, pos, pos, spec, *leaves)
    assert packs == [1, 1] and gathers == ["bwd_stream"] * 2


def test_cpu_train_step_runs_the_plain_versions(monkeypatch):
    # on CPU tensors the forward makes no stream, and the backward is
    # packed_grads' plain version on the forward's packed weights: the
    # gradients are unpack_grads of packed_grads_plain, bit for bit
    tc = _cfgs("reference")[1]
    params = init_nerf_params(torch.Generator().manual_seed(0), tc, "cpu")
    paths, leaves = zip(*tree_leaves(params))
    leaves = [leaf.detach().clone().requires_grad_() for leaf in leaves]
    monkeypatch.setattr(ray_wgmma, "bwd_stream",
                        lambda *a: pytest.fail("a CPU step gathered a weight stream"))
    pos, dirs = (torch.tensor(a) for a in _inputs(150, 12))
    tree = tree_from_leaves(paths, leaves)
    sigma, rgb = train_kernel.fused_train_apply(tree, pos, dirs, tc, torch.float32)
    packed = pack_params(tree, tc, torch.float32)
    want = fused_nerf_apply_plain(packed, pos, dirs, tc)
    torch.testing.assert_close(sigma, want[:, 0], rtol=0, atol=0)
    torch.testing.assert_close(rgb, want[:, 1:], rtol=0, atol=0)
    (sigma.sum() + rgb.sum()).backward()
    g = train_kernel.packed_grads_plain(packed, pos, dirs, torch.ones(150), torch.ones(150, 3), tc)
    by_path = dict(tree_leaves(train_kernel.unpack_grads(g, tc)))
    for path, leaf in zip(paths, leaves):
        assert torch.equal(leaf.grad, by_path[path]), path
