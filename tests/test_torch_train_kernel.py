"""The per-sample MLP kernel (K4) and the MLP backward kernel (K5) of the
port, by their plain versions (the wrappers on CPU tensors), vs the JAX
Pallas kernels in interpret mode and vs autograd of the port's own
``apply_nerf``. Inputs come from numpy seeds; weights cross over through
``params_from_numpy``. The CUDA kernels themselves are held against the same
plain versions on the card by ``chip_smoke.py``."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_tpu.config import ModelConfig as JModelConfig
from nerf_tpu.config import bmild_config as jbmild
from nerf_tpu.models.nerf import apply_nerf as japply_nerf
from nerf_tpu.models.nerf import init_nerf_params as jinit
from nerf_tpu.ops.mlp_kernel import fused_nerf_apply as jfused_nerf_apply
from nerf_tpu.ops.train_kernel import fused_train_apply as jfused_train_apply
from nerf_tpu_torch.config import ModelConfig
from nerf_tpu_torch.models.nerf import apply_nerf, params_from_numpy
from nerf_tpu_torch.ops import mlp_kernel, train_kernel
from nerf_tpu_torch.ops.mlp_kernel import (
    fused_nerf_apply,
    fused_nerf_apply_plain,
    make_cuda_apply_fn,
    pack_params,
)
from nerf_tpu_torch.ops.train_kernel import (
    GRAD_SHAPES,
    fused_train_apply,
    make_train_apply_fn,
    packed_grads,
    packed_grads_plain,
    unpack_grads,
)
from nerf_tpu_torch.utils.tree import tree_from_leaves, tree_leaves


def _cfgs(variant):
    jc = JModelConfig() if variant == "reference" else jbmild().model
    return jc, ModelConfig(**dataclasses.asdict(jc))


def _samples(n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    tgt = rng.uniform(size=n).astype(np.float32)
    return pos, dirs, tgt


# -- K4 ---------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["reference", "bmild"])
def test_k4_plain_matches_pallas_interpret_and_apply_nerf(variant):
    # f32 compute in all three, seeded random weights, rtol/atol 1e-4 as
    # tests/test_mlp_kernel.py; 333 samples: not a multiple of any tile
    jc, tc = _cfgs(variant)
    p = jax.device_get(jinit(jax.random.PRNGKey(3), jc))
    pos, dirs, _ = _samples(333, 0)
    s_j, c_j = jfused_nerf_apply(p, jnp.asarray(pos), jnp.asarray(dirs), jc, 128,
                                 jnp.float32, True)
    tp = params_from_numpy(p, "cpu")
    sigma, rgb = fused_nerf_apply(tp, torch.tensor(pos), torch.tensor(dirs), tc,
                                  dtype=torch.float32)
    assert sigma.shape == (333,) and rgb.shape == (333, 3)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(s_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(c_j), rtol=1e-4, atol=1e-4)
    s_ref, c_ref = apply_nerf(tp, torch.tensor(pos), torch.tensor(dirs), tc)
    np.testing.assert_allclose(sigma.numpy(), s_ref.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(rgb.numpy(), c_ref.numpy(), rtol=1e-4, atol=1e-4)


def test_k4_leading_dims_no_directions_and_packed_weights():
    jc, tc = _cfgs("reference")
    tp = params_from_numpy(jax.device_get(jinit(jax.random.PRNGKey(4), jc)), "cpu")
    pos, dirs, _ = _samples(5 * 7, 1)
    pos, dirs = torch.tensor(pos).reshape(5, 7, 3), torch.tensor(dirs[:5]).reshape(5, 1, 3)
    before = mlp_kernel.launches
    sigma, rgb = fused_nerf_apply(tp, pos, dirs, tc, dtype=torch.float32)
    assert sigma.shape == (5, 7) and rgb.shape == (5, 7, 3)
    s_ref, c_ref = apply_nerf(tp, pos, dirs.expand(5, 7, 3), tc)
    np.testing.assert_allclose(sigma.numpy(), s_ref.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(rgb.numpy(), c_ref.numpy(), rtol=1e-4, atol=1e-4)
    # directions=None is a zero direction, as in apply_nerf
    s0, c0 = fused_nerf_apply(tp, pos, None, tc, dtype=torch.float32)
    s0_ref, c0_ref = apply_nerf(tp, pos, None, tc)
    np.testing.assert_allclose(c0.numpy(), c0_ref.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s0.numpy(), s0_ref.numpy(), rtol=1e-4, atol=1e-4)
    # packed weights (the engines' form) and the apply_fn adapter give the same
    packed = pack_params(tp, tc, torch.float32)
    s_p, c_p = make_cuda_apply_fn(torch.float32)(packed, pos, dirs, tc, compute_dtype=None)
    torch.testing.assert_close(s_p, sigma, rtol=0, atol=0)
    torch.testing.assert_close(c_p, rgb, rtol=0, atol=0)
    assert mlp_kernel.launches == before        # the CPU path launches no kernel


def test_k4_bf16_close_to_f32_and_differentiable_through_apply_nerf():
    # bf16 against f32: the error the kernel's dtype costs (5e-2 on rgb, as
    # K1's test); the gradient is apply_nerf's, for either variant
    jc, tc = _cfgs("bmild")
    tp = params_from_numpy(jax.device_get(jinit(jax.random.PRNGKey(5), jc)), "cpu")
    pos, dirs, tgt = (torch.tensor(a) for a in _samples(200, 2))
    _, c32 = fused_nerf_apply(tp, pos, dirs, tc, dtype=torch.float32)
    _, c16 = fused_nerf_apply(tp, pos, dirs, tc)
    assert (c16 - c32).abs().max() < 5e-2

    def grads(fn):
        paths, leaves = zip(*tree_leaves(tp))
        leaves = [leaf.clone().requires_grad_() for leaf in leaves]
        s, c = fn(tree_from_leaves(paths, leaves))
        loss = ((c - 0.3) ** 2).mean() + 0.1 * ((s - tgt) ** 2).mean()
        return torch.autograd.grad(loss, leaves)

    g_k = grads(lambda p: fused_nerf_apply(p, pos, dirs, tc, dtype=torch.float32))
    g_a = grads(lambda p: apply_nerf(p, pos, dirs, tc))
    for a, b in zip(g_k, g_a):
        assert float((a - b).norm() / (b.norm() + 1e-20)) < 1e-4


# -- K5 ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    """Full width, N = 1,500 (not a multiple of the kernels' tiles), the
    loss of tests/test_train_kernel.py."""
    jc, tc = _cfgs("reference")
    jp = jax.device_get(jinit(jax.random.PRNGKey(0), jc))
    pos, dirs, tgt = _samples(1500, 1)
    return jc, tc, jp, params_from_numpy(jp, "cpu"), pos, dirs, tgt


def _loss(s, c, tgt):
    return ((c - 0.3) ** 2).mean() + 0.1 * ((s - tgt) ** 2).mean()


def _torch_grads(fn, tp, pos, dirs, tgt):
    """{path: gradient} of the test loss through ``fn(params, pos, dirs)``."""
    paths, leaves = zip(*tree_leaves(tp))
    leaves = [leaf.clone().requires_grad_() for leaf in leaves]
    s, c = fn(tree_from_leaves(paths, leaves), torch.tensor(pos), torch.tensor(dirs))
    return dict(zip(paths, torch.autograd.grad(_loss(s, c, torch.tensor(tgt)), leaves)))


def _worst_rel(a, b):
    return max(float((a[k] - b[k]).norm() / (b[k].norm() + 1e-20)) for k in b)


def _jax_paths(tree):
    """{path: numpy leaf} of a JAX params tree, paths as tree_leaves gives."""
    return {p: np.asarray(v) for p, v in tree_leaves(jax.device_get(tree))}


def test_k5_f32_plain_is_exact_backpropagation(setup):
    # float32 compute: packed_grads_plain + unpack_grads equal autograd of
    # apply_nerf to 1e-4 relative on every leaf, which proves unpack_grads'
    # row bookkeeping (skip split, head split, dropped padding rows)
    _, tc, _, tp, pos, dirs, tgt = setup
    g_k = _torch_grads(lambda p, x, d: fused_train_apply(p, x, d, tc, torch.float32),
                       tp, pos, dirs, tgt)
    g_a = _torch_grads(lambda p, x, d: apply_nerf(p, x, d, tc), tp, pos, dirs, tgt)
    assert set(g_k) == set(g_a)
    for k in g_a:
        assert g_k[k].shape == g_a[k].shape
        assert float((g_k[k] - g_a[k]).norm() / (g_a[k].norm() + 1e-20)) < 1e-4, k


def test_k5_bf16_in_autograd_noise_class(setup):
    # the acceptance bar of tests/test_train_kernel.py: against float32
    # autograd, the kernel's arithmetic may be at most twice as noisy as bf16
    # autograd itself (or 0.02)
    _, tc, _, tp, pos, dirs, tgt = setup
    g_f32 = _torch_grads(lambda p, x, d: apply_nerf(p, x, d, tc), tp, pos, dirs, tgt)
    g_bf16 = _torch_grads(lambda p, x, d: apply_nerf(p, x, d, tc, torch.bfloat16),
                          tp, pos, dirs, tgt)
    g_k = _torch_grads(lambda p, x, d: fused_train_apply(p, x, d, tc), tp, pos, dirs, tgt)
    noise, kernel_noise = _worst_rel(g_bf16, g_f32), _worst_rel(g_k, g_f32)
    assert kernel_noise < max(2.0 * noise, 0.02), f"kernel {kernel_noise} vs bf16 {noise}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_matches_jax_fused_train_apply(setup, dtype):
    # jax.grad through the Pallas forward + backward kernels in interpret
    # mode, and through the JAX apply_nerf, on the same weights and samples.
    # float32: the port's gradients equal jax.grad of apply_nerf to 1e-5
    # relative on every leaf. The Pallas kernel itself sits 4.3e-3 from that
    # on the first trunk layer (its encoding evaluates sin/cos by a
    # half-angle ladder, which the top band amplifies), so the port is held
    # to it at 1e-2. bf16: each rounds the forward at its own points (the
    # Pallas epilogue adds the bias at bf16 width), so both are held to the
    # noise class: worst leaf under twice bf16 autograd's distance from
    # float32
    jc, tc, jp, tp, pos, dirs, tgt = setup
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)

    def jgrads(fn):
        def loss(p):
            s, c = fn(p, jnp.asarray(pos), jnp.asarray(dirs))
            return jnp.mean((c - 0.3) ** 2) + 0.1 * jnp.mean((s - jnp.asarray(tgt)) ** 2)

        return {k: torch.tensor(v) for k, v in _jax_paths(jax.grad(loss)(jp)).items()}

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


def test_k5_packed_layout_padding_rows_and_launch_count(setup):
    _, tc, _, tp, pos, dirs, tgt = setup
    packed = pack_params(tp, tc, torch.float32)
    n = 300
    rng = np.random.default_rng(5)
    dsig = torch.tensor(rng.normal(size=n).astype(np.float32))
    drgb = torch.tensor(rng.normal(size=(n, 3)).astype(np.float32))
    before = dict(train_kernel.launches)
    g = packed_grads(packed, torch.tensor(pos[:n]), torch.tensor(dirs[:n]), dsig, drgb, tc)
    assert train_kernel.launches == before      # the CPU path launches no kernel
    assert {k: tuple(v.shape) for k, v in g.items()} == GRAD_SHAPES
    # the zero-padded encoding rows see a zero input, so their gradient is zero
    assert not g["d_w0"][63:].any() and not g["d_wskip"][63:].any()
    assert not g["d_wdir"][27:].any()
    g2 = packed_grads_plain(packed, torch.tensor(pos[:n]), torch.tensor(dirs[:n]), dsig,
                            drgb, tc)
    for k in g:
        torch.testing.assert_close(g[k], g2[k], rtol=0, atol=0)
    tree = unpack_grads(g, tc)
    assert tree["trunk"][4]["w"].shape == (256 + 63, 256)
    assert tree["color0"]["w"].shape == (256 + 27, 128)
    assert tree["density"]["w"].shape == (256, 1)
    # rows past a sample count with zero cotangents add nothing
    zeros = torch.zeros(50)
    g3 = packed_grads(packed, torch.tensor(pos[:n + 50]), torch.tensor(dirs[:n + 50]),
                      torch.cat([dsig, zeros]), torch.cat([drgb, zeros[:, None].expand(50, 3)]),
                      tc)
    for k in g:
        torch.testing.assert_close(g3[k], g[k], rtol=1e-5, atol=1e-6)


def test_k5_inputs_get_no_gradient_and_bmild_is_refused(setup):
    _, tc, _, tp, pos, dirs, _ = setup
    x = torch.tensor(pos[:64]).requires_grad_()
    d = torch.tensor(dirs[:64]).requires_grad_()
    # positions and directions are data: no gradient reaches them
    leaf = tp["color1"]["w"].clone().requires_grad_()
    p2 = {**tp, "color1": {"w": leaf, "b": tp["color1"]["b"]}}
    _, c = fused_train_apply(p2, x, d, tc, torch.float32)
    gx, gd, gw = torch.autograd.grad(c.mean(), (x, d, leaf), allow_unused=True)
    assert gx is None and gd is None and gw.abs().max() > 0
    _, bm = _cfgs("bmild")
    with pytest.raises(ValueError, match="reference"):
        fused_train_apply(tp, x, d, bm)


def test_k5_adam_steps_lower_the_loss(setup):
    # eight Adam steps on the toy target through the kernels' arithmetic
    # (bf16) lower the loss by 10%: the unpacked gradients point the right way
    _, tc, _, tp, pos, dirs, tgt = setup
    apply_fn = make_train_apply_fn()
    paths, leaves = zip(*tree_leaves(tp))
    leaves = [leaf.clone().requires_grad_() for leaf in leaves]
    opt = torch.optim.Adam(leaves, lr=1e-3)
    x, d, t = torch.tensor(pos), torch.tensor(dirs), torch.tensor(tgt)
    losses = []
    for _ in range(8):
        opt.zero_grad()
        s, c = apply_fn(tree_from_leaves(paths, leaves), x, d, tc, compute_dtype=torch.float32)
        loss = _loss(s, c, t)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] * 0.9, losses


# -- K5a's stores of the scratch (the mirror of csrc/mlp_backward_wgmma.cu) -----


def test_k5a_store_schedule_tiles_each_block_image_once_and_fits_shared_memory():
    sched = train_kernel.store_schedule()
    # a piece per quantity of at most STAGE_FEATS rows, in the consumers' order
    assert [name for name, _, _ in sched] == [
        name for name in train_kernel.STORE_ORDER
        for _ in range(-(-dict(train_kernel.SCRATCH)[name] // train_kernel.STAGE_FEATS))]
    assert sorted(train_kernel.STORE_ORDER) == sorted(name for name, _ in train_kernel.SCRATCH)
    hits = np.zeros(train_kernel.SCRATCH_FEATURES, dtype=np.int64)
    for name, row, rows in sched:
        offset, nbytes = 128 * row, 128 * rows
        assert offset % 16 == 0 and nbytes % 16 == 0 and 0 < nbytes <= train_kernel.STAGE_PIECE
        assert train_kernel.SCRATCH_ROW[name] <= row
        assert row + rows <= train_kernel.SCRATCH_ROW[name] + dict(train_kernel.SCRATCH)[name]
        hits[row:row + rows] += 1
    assert (hits == 1).all()   # every 128-byte image row of a 64-sample block once
    # the staging of both consumers beside the ring, in the H100's 232,448 bytes
    staging = 2 * train_kernel.STAGE_DEPTH * train_kernel.STAGE_PIECE
    assert train_kernel.ROW_STAGES >= 2 and train_kernel.STAGE_DEPTH >= 1
    assert train_kernel.ROWS_SMEM_BYTES == (1024 + train_kernel.ROWS_FIXED_BYTES + staging
                                            + train_kernel.ROW_STAGES * train_kernel.RING_STAGE_BYTES)
    assert train_kernel.ROWS_SMEM_BYTES <= train_kernel.ROWS_SMEM_MAX
    assert (train_kernel.ROWS_SMEM_BYTES + train_kernel.RING_STAGE_BYTES
            > train_kernel.ROWS_SMEM_MAX or train_kernel.ROW_STAGES == 6)


def _fm_off(f, p):
    """csrc/mlp_backward_wgmma.cu fm_off: byte (feature f, image position p)."""
    return f * 128 + ((((p >> 3) ^ f) & 7) << 4) + ((p & 7) << 1)


@pytest.mark.parametrize("name", ["h3", "c", "dpre0"])
def test_k5a_staged_fragments_are_the_bytes_of_the_image(name):
    # the consumers' writes emulated: thread (w, g, q) holds A fragment x as
    # bf16 pairs of rows s0 = 16 w + g and s0 + 8 at features 16 x + 2 q (+ 1)
    # (atom 2 x) and 16 x + 8 + 2 q (+ 1) (atom 2 x + 1), and writes each
    # feature's pair of rows as one word at fm_off into slot byte (2 x mod 2
    # PIECE_FRAGS) 1024; the storer's copy of each slot lands on the image
    width = dict(train_kernel.SCRATCH)[name]
    row0 = train_kernel.SCRATCH_ROW[name]
    feats = torch.zeros(train_kernel.BLOCK, train_kernel.SCRATCH_FEATURES, dtype=torch.bfloat16)
    vals = torch.randn(train_kernel.BLOCK, width, generator=torch.Generator().manual_seed(width))
    feats[:, row0:row0 + width] = vals.to(torch.bfloat16)
    bits = feats.view(torch.int16).numpy().view(np.uint16)
    want = train_kernel.scratch_image(feats).view(torch.int16).numpy().view(np.uint16)
    image = want.copy()
    pieces = [(r, n) for q, r, n in train_kernel.store_schedule() if q == name]
    image[row0 * 64:(row0 + width) * 64] = 0
    frags = train_kernel.STAGE_FEATS // 16
    for k, (row, rows) in enumerate(pieces):
        slot = np.zeros(train_kernel.STAGE_PIECE // 2, dtype=np.uint16)
        for x in range(k * frags, min((k + 1) * frags, width // 16)):
            for w in range(4):
                for g in range(8):
                    for q in range(4):
                        s0, p0 = 16 * w + g, 16 * w + 2 * g
                        atom = (2 * x) % (2 * frags) * 1024
                        for half in range(2):            # atoms 2 x, 2 x + 1
                            for e in range(2):           # features 2 q, 2 q + 1
                                f = 16 * x + 8 * half + 2 * q + e
                                at = (atom + half * 1024 + _fm_off(2 * q + e, p0)) // 2
                                slot[at] = bits[s0, row0 + f]
                                slot[at + 1] = bits[s0 + 8, row0 + f]
        image[row * 64:(row + rows) * 64] = slot[:rows * 64]
    assert np.array_equal(image, want)
