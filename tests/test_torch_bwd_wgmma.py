"""The Hopper backward K5 (``csrc/mlp_backward_wgmma.cu``) on its host side:
the pre-transposed weight images of its stream against the weights bit for
bit, the producer's chunk schedule, the scratch image both kernels share, the
weight-gradient jobs, the plain versions of the row pass (``bwd_rows_plain``)
and of the weight-gradient pass (``wgrad_split_plain``) composed over splits
and passes against ``packed_grads_plain``, the JAX Pallas kernel (interpret
mode) and ``jax.grad``, and which library ``train_kernel._launch`` reaches.
The CUDA kernels run only on the card; ``chip_smoke.py`` holds them against
these plain versions there."""

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.config import ModelConfig as JModelConfig
from nerf_tpu.models.nerf import apply_nerf as japply_nerf
from nerf_tpu.models.nerf import init_nerf_params as jinit
from nerf_tpu.ops.train_kernel import fused_train_apply as jfused_train_apply
from nerf_tpu_torch.config import ModelConfig
from nerf_tpu_torch.models.nerf import apply_nerf, params_from_numpy
from nerf_tpu_torch.ops import _ext, ray_wgmma, train_kernel
from nerf_tpu_torch.ops.mlp_kernel import pack_params, skip_position
from nerf_tpu_torch.ops.train_kernel import (
    BLOCK,
    GRAD_FLOATS,
    GRAD_OFFSETS,
    GRAD_SHAPES,
    SCRATCH,
    SCRATCH_FEATURES,
    SCRATCH_ROW,
    bwd_rows_plain,
    fused_train_apply,
    packed_grads_composed,
    packed_grads_plain,
    scratch_rows,
)
from nerf_tpu_torch.utils.tree import tree_from_leaves, tree_leaves


@pytest.fixture(scope="module")
def cfgs():
    jc = JModelConfig()
    return jc, ModelConfig(**dataclasses.asdict(jc))


@pytest.fixture(scope="module")
def weights(cfgs):
    jc, tc = cfgs
    jp = jax.device_get(jinit(jax.random.PRNGKey(0), jc))
    return jp, params_from_numpy(jp, "cpu")


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)),
            torch.tensor(rng.normal(size=(n, 3)).astype(np.float32)),
            torch.tensor(rng.normal(size=n).astype(np.float32)),
            torch.tensor(rng.normal(size=(n, 3)).astype(np.float32)))


def _rel(a, b):
    return float((a.float() - b.float()).norm() / (b.float().norm() + 1e-20))


# -- the weight stream ------------------------------------------------------------

def test_bwd_stream_unpacks_to_the_transposed_matrices_bit_for_bit(cfgs, weights):
    _, tc = cfgs
    packed = pack_params(weights[1], tc, torch.bfloat16)
    stream = ray_wgmma.bwd_stream(packed, tc)
    assert torch.equal(stream, ray_wgmma.pack_bwd_stream(packed, tc))   # the gather's index
    back = ray_wgmma.unpack_bwd_stream(stream, tc)
    for name in ("w0", "wt", "wskip", "wc0"):
        assert torch.equal(back[name], getattr(packed, name)), name
    assert torch.equal(back["wt_t"], packed.wt.transpose(1, 2))
    assert torch.equal(back["wc0_t"], packed.wc0.t())
    assert torch.equal(back["wdir"][:32], packed.wdir) and not back["wdir"][32:].any()
    # the forward part is the ray kernels' stream, as it is
    fwd = ray_wgmma.pack_stream(packed, tc)
    assert torch.equal(stream[:fwd.numel()], fwd)


def test_transposed_chunks_are_the_swizzled_k_major_image(cfgs, weights):
    # element (k, n) of a *_t chunk is W[n, k0 + k]: column n of the product
    # dy @ W^T holds row n of W, its 64 K values in one 128-byte image row,
    # the 16-byte piece k // 8 at position (k // 8) ^ (n % 8)
    _, tc = cfgs
    packed = pack_params(weights[1], tc, torch.bfloat16)
    stream = ray_wgmma.pack_bwd_stream(packed, tc)
    rng = np.random.default_rng(1)
    at, seen = 0, set()
    for c in ray_wgmma.bwd_chunk_schedule(tc):
        if c.name.endswith("_t"):
            w = packed.wc0 if c.name == "wc0_t" else packed.wt[c.layer]
            for k, n in zip(rng.integers(0, 64, 30), rng.integers(0, c.n, 30)):
                off = (n // 8) * 512 + (n % 8) * 64 + ((k // 8) ^ (n % 8)) * 8 + k % 8
                assert stream[at + off] == w[n, c.k0 + k]
            seen.add((c.name, c.layer))
        at += 64 * c.n
    assert at == stream.numel() and len(seen) == 8


def _producer_bytes(n_chunks):
    """csrc/mlp_backward_wgmma.cu chunk_bytes: the forward's 30 big chunks, 5
    small ones (wc0, wdir), then the 30 transposed big ones."""
    return [16384 if 30 <= j < 35 else 32768 for j in range(n_chunks)]


def test_bwd_schedule_is_the_producers_and_the_consumers_order(cfgs):
    _, tc = cfgs
    sched = ray_wgmma.bwd_chunk_schedule(tc)
    assert len(sched) == 65   # bwd_stream_chunks()
    assert [c.nbytes for c in sched] == _producer_bytes(len(sched))
    # the consumers' order: the forward, the direction rows, then the
    # input-gradient products from the color layer down to layer 1's
    order = [(c.name, c.layer) for c in sched]
    fwd = [(c.name, c.layer) for c in ray_wgmma.chunk_schedule(tc)]
    want = fwd + [("wdir", None)] + [("wc0_t", None)] * 2
    for i in range(7, 0, -1):
        want += [("wt_t", i - 1)] * 4
    assert order == want
    assert [c.k0 for c in sched if c.name == "wt_t"] == [0, 64, 128, 192] * 7
    assert sum(c.nbytes for c in sched) == 2 * ray_wgmma.pack_bwd_stream(
        pack_params(params_from_numpy(jax.device_get(jinit(jax.random.PRNGKey(2),
                                                           JModelConfig())), "cpu"), tc),
        tc).numel()
    with pytest.raises(ValueError, match="reference"):
        ray_wgmma.bwd_chunk_schedule(dataclasses.replace(tc, variant="bmild"))


# -- the scratch and the jobs -------------------------------------------------------

def test_scratch_layout_and_image():
    # the quantities in image order, each starting on an 8-row atom
    assert SCRATCH_FEATURES == 4488 and SCRATCH_ROW["dpre0"] == 128 + 8 * 256
    assert all(r % 8 == 0 for r in SCRATCH_ROW.values())
    # a thread's rows s0 = 16 w + g and s0 + 8 are neighbours in the image
    pos = train_kernel.SAMPLE_POS
    assert sorted(pos.tolist()) == list(range(BLOCK))
    for w in range(4):
        for g in range(8):
            assert pos[16 * w + g + 8] == pos[16 * w + g] + 1 == 16 * w + 2 * g + 1
    n = 150
    feats = torch.randn(n, SCRATCH_FEATURES).to(torch.bfloat16)
    img = train_kernel.scratch_image(feats)
    assert img.numel() == 3 * BLOCK * SCRATCH_FEATURES
    assert torch.equal(train_kernel.image_rows(img, n), feats)
    rng = np.random.default_rng(3)
    for s, f in zip(rng.integers(0, n, 60), rng.integers(0, SCRATCH_FEATURES, 60)):
        b, p = divmod(int(s), BLOCK)
        P = int(pos[p])
        off = b * SCRATCH_FEATURES * BLOCK + (f // 8) * 512 + (f % 8) * 64 + ((P // 8) ^ (f % 8)) * 8 + P % 8
        assert img[off] == feats[s, f]
    pad = train_kernel.image_rows(img, 3 * BLOCK)[n:]
    assert not pad.any()


def test_jobs_write_every_gradient_once_per_split(cfgs):
    _, tc = cfgs
    jobs = train_kernel.wgrad_jobs(tc)
    assert len(jobs) == 22 and train_kernel.jobs_tensor(tc).shape == (22, 18)
    hits = torch.zeros(GRAD_FLOATS, dtype=torch.int64)
    for n, b_row, *cons in jobs:
        assert n in (256, 128, 8) and b_row % 8 == 0
        assert cons[0] is not None
        for c in cons:
            if c is None:
                continue
            a_row, off, ld, valid, col0, ncols, bias = c
            assert a_row % 8 == 0 and a_row + 64 <= SCRATCH_FEATURES and col0 + ncols <= n
            for r in range(valid):
                hits[off + r * ld: off + r * ld + ncols] += 1
            if bias >= 0:
                hits[bias:bias + ncols] += 1
    assert bool((hits == 1).all())
    # 22 jobs x SPLITS blocks fill the H100's 132 SMs in one wave
    assert len(jobs) * train_kernel.SPLITS == 132


def test_split_and_pass_bounds():
    assert train_kernel.split_bounds(1) == [(0, 1)]
    assert train_kernel.split_bounds(129) == [(0, 64), (64, 128), (128, 129)]
    b = train_kernel.split_bounds(65536)
    assert len(b) == 6 and b[0][0] == 0 and b[-1][1] == 65536
    assert all(x[1] == y[0] and x[0] % BLOCK == 0 for x, y in zip(b, b[1:]))
    assert train_kernel.pass_bounds(393216) == [(i * 65536, (i + 1) * 65536) for i in range(6)]
    assert train_kernel.scratch_elems(1500) == 24 * BLOCK * SCRATCH_FEATURES   # 12 tiles of 2 blocks


# -- the plain versions composed ------------------------------------------------------

@pytest.mark.parametrize("n,pass_rows", [(1, 65536), (127, 65536), (129, 65536), (1500, 512)])
def test_composition_equals_packed_grads_plain_float32(cfgs, weights, n, pass_rows):
    # float32 compute: only the summation order differs (tiles, splits,
    # passes), 1e-6 relative per leaf
    _, tc = cfgs
    packed = pack_params(weights[1], tc, torch.float32)
    args = _inputs(n, n)
    a = packed_grads_plain(packed, *args, tc)
    b = packed_grads_composed(packed, *args, tc, pass_rows=pass_rows)
    assert set(b) == set(GRAD_SHAPES)
    for k in a:
        assert b[k].shape == a[k].shape and _rel(b[k], a[k]) < 1e-6, k


@pytest.mark.parametrize("n,pass_rows", [(1, 65536), (127, 65536), (129, 65536), (1500, 512)])
def test_composition_bf16_cotangents_bit_for_bit(cfgs, weights, n, pass_rows):
    # bf16 compute: the scratch holds packed_grads_plain's rounded cotangents
    # with no second rounding, zeros in its padding, and the gradients differ
    # by the summation order only
    _, tc = cfgs
    packed = pack_params(weights[1], tc, torch.bfloat16)
    args = _inputs(n, n + 1)
    keep = {}
    a = packed_grads_plain(packed, *args, tc, keep=keep)
    rows = bwd_rows_plain(packed, *args, tc)
    assert all(rows[q].shape == (n, w) and rows[q].dtype == torch.bfloat16 for q, w in SCRATCH)
    assert torch.equal(rows["dc_pre"].float(), keep["dc_pre"])
    assert torch.equal(rows["dy8"][:, :3].float(), keep["dz1"])
    assert torch.equal(rows["dy8"][:, 3].float(), keep["dsig_pre"])
    assert not rows["dy8"][:, 4:].any() and not rows["denc"][:, 32:].any()
    for i in range(8):
        assert torch.equal(rows[f"dpre{i}"].float(), keep["dpre"][i]), i
    b = packed_grads_composed(packed, *args, tc, pass_rows=pass_rows)
    for k in a:
        assert _rel(b[k], a[k]) < 1e-5, k


def test_split_partials_sum_to_the_leaves(cfgs, weights):
    # each split's partials are the leaves over its rows: they sum to the
    # whole, and a split over zero cotangents adds nothing
    _, tc = cfgs
    packed = pack_params(weights[1], tc, torch.float32)
    pos, dirs, ds, dr = _inputs(300, 9)
    ds[200:], dr[200:] = 0.0, 0.0
    feats = scratch_rows(bwd_rows_plain(packed, pos, dirs, ds, dr, tc))
    parts = train_kernel.wgrad_split_plain(feats, [(0, 128), (128, 192), (192, 256), (256, 300)], tc)
    assert parts.shape == (4, GRAD_FLOATS) and not torch.isnan(parts).any()
    assert not parts[3].any()                                     # rows 256.. have no cotangent
    whole = train_kernel.grads_from_flat(parts.sum(0))
    a = packed_grads_plain(packed, pos[:200], dirs[:200], ds[:200], dr[:200], tc)
    for k in a:
        assert _rel(whole[k], a[k]) < 1e-6, k
    assert GRAD_OFFSETS["d_bc1"] + 3 == GRAD_FLOATS


def _torch_grads(fn, tp, pos, dirs, tgt):
    paths, leaves = zip(*tree_leaves(tp))
    leaves = [leaf.clone().requires_grad_() for leaf in leaves]
    s, c = fn(tree_from_leaves(paths, leaves), torch.tensor(pos), torch.tensor(dirs))
    loss = ((c - 0.3) ** 2).mean() + 0.1 * ((s - torch.tensor(tgt)) ** 2).mean()
    return dict(zip(paths, torch.autograd.grad(loss, leaves)))


def _worst_rel(a, b):
    return max(_rel(a[k], b[k]) for k in b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_composition_matches_jax(monkeypatch, cfgs, weights, dtype):
    # the kernels' pipeline in plain PyTorch (three passes, ragged) as the
    # backward of fused_train_apply, against jax.grad through the Pallas
    # forward + backward kernels in interpret mode and through the JAX
    # apply_nerf, at test_k5_matches_jax_fused_train_apply's tolerances
    jc, tc = cfgs
    jp, tp = weights
    rng = np.random.default_rng(1)
    pos = rng.uniform(-1.0, 1.0, (1500, 3)).astype(np.float32)
    dirs = rng.normal(size=(1500, 3)).astype(np.float32)
    tgt = rng.uniform(size=1500).astype(np.float32)
    monkeypatch.setattr(train_kernel, "packed_grads",
                        lambda *a: packed_grads_composed(*a, pass_rows=512))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)

    def jgrads(fn):
        def loss(p):
            s, c = fn(p, jnp.asarray(pos), jnp.asarray(dirs))
            return jnp.mean((c - 0.3) ** 2) + 0.1 * jnp.mean((s - jnp.asarray(tgt)) ** 2)

        return {k: torch.tensor(np.asarray(v))
                for k, v in tree_leaves(jax.device_get(jax.grad(loss)(jp)))}

    g_j = jgrads(lambda p, x, d: jfused_train_apply(p, x, d, jc, 512, jdt, True))
    g_k = _torch_grads(lambda p, x, d: fused_train_apply(p, x, d, tc, tdt), tp, pos, dirs, tgt)
    assert set(g_j) == set(g_k)
    if dtype == "float32":
        g_x = jgrads(lambda p, x, d: japply_nerf(p, x, d, jc))
        assert _worst_rel(g_k, g_x) < 1e-5
        assert _worst_rel(g_k, g_j) < 1e-2
    else:
        g_f32 = _torch_grads(lambda p, x, d: apply_nerf(p, x, d, tc), tp, pos, dirs, tgt)
        g_bf16 = _torch_grads(lambda p, x, d: apply_nerf(p, x, d, tc, torch.bfloat16),
                              tp, pos, dirs, tgt)
        limit = max(2.0 * _worst_rel(g_bf16, g_f32), 0.02)
        assert _worst_rel(g_k, g_f32) < limit and _worst_rel(g_j, g_f32) < limit


# -- the dispatch of _launch --------------------------------------------------------------

class _Fn:
    """A C entry point that records its calls and the assignments of its
    signature, and returns cudaSuccess."""

    def __init__(self, name, calls):
        self.name, self.calls = name, calls
        self._argtypes, self.restype, self.set_count = None, None, 0

    @property
    def argtypes(self):
        return self._argtypes

    @argtypes.setter
    def argtypes(self, v):
        self.set_count += 1
        self._argtypes = v

    def __call__(self, *args):
        assert len(args) == len(self._argtypes)
        self.calls.append(self.name)
        return 0


class _Lib:
    def __init__(self, name, calls):
        self.name = name
        for fn in train_kernel._SIGNATURES:
            setattr(self, fn, _Fn(f"{name}.{fn}", calls))


@pytest.fixture
def recorded(monkeypatch):
    calls, libs = [], {}

    def load(name):
        return libs.setdefault(name, _Lib(name, calls))

    monkeypatch.setattr(_ext, "load", load)
    monkeypatch.setattr(_ext, "stream_ptr", lambda dev: ctypes.c_void_p(0))
    return calls, libs


@pytest.mark.parametrize("n,pass_rows", [(1, 65536), (1500, 65536), (700, 256)])
def test_launch_reaches_the_hopper_kernels_and_fills_nothing(monkeypatch, recorded, cfgs,
                                                             weights, n, pass_rows):
    calls, libs = recorded
    monkeypatch.setattr(train_kernel, "PASS_ROWS", pass_rows)
    _, tc = cfgs
    packed = pack_params(weights[1], tc, torch.bfloat16)
    args = [torch.zeros(n, 3), torch.zeros(n, 3), torch.zeros(n), torch.zeros(n, 3)]

    def refused(*a, **k):
        raise AssertionError("a kernel launch zero-filled a buffer")

    before = dict(train_kernel.launches)
    with monkeypatch.context() as m:
        m.setattr(torch, "zeros", refused)
        m.setattr(torch.Tensor, "zero_", refused)
        g = train_kernel._launch(packed, *args, tc)
        train_kernel._launch(packed, *args, tc)
    passes = len(train_kernel.pass_bounds(n, pass_rows))
    lib = f"{train_kernel.LIBRARY}"
    assert calls == [f"{lib}.bwd_rows_wgmma", f"{lib}.wgrad_wgmma"] * passes * 2
    assert {k: train_kernel.launches[k] - before[k] for k in before} == {
        "bwd_rows": 2 * passes, "wgrad": 2 * passes}
    assert {k: tuple(v.shape) for k, v in g.items()} == GRAD_SHAPES
    # the signatures were set once, when the library was first loaded
    assert all(fn.set_count == 1 for fn in vars(libs[lib]).values() if isinstance(fn, _Fn))
    assert train_kernel.LIBRARY in _ext.SOURCES
    # the CPU path of packed_grads is the plain version: no library at all
    calls.clear()
    train_kernel.packed_grads(packed, *args, tc)
    assert calls == []


def test_launch_wrappers_refuse_what_the_kernels_do_not_take(recorded, cfgs, weights):
    _, tc = cfgs
    packed = pack_params(weights[1], tc, torch.bfloat16)
    scratch = torch.empty(train_kernel.scratch_elems(128), dtype=torch.bfloat16)
    x = torch.zeros(train_kernel.PASS_ROWS + 1, 3)
    with pytest.raises(ValueError, match="pass"):
        train_kernel.launch_rows(packed, x, x, x[:, 0], x, tc, scratch)
    with pytest.raises(ValueError, match="pass"):
        train_kernel.launch_rows(packed, x[:200], x[:200], x[:200, 0], x[:200], tc, scratch)
    with pytest.raises(ValueError, match="slots"):
        train_kernel.launch_wgrad(scratch, 128, tc, torch.empty(1, GRAD_FLOATS), 0)
    assert skip_position(tc) == 4
