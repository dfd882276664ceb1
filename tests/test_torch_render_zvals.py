"""The last public names of the JAX package in the port: the differentiable
``fused_render_zvals`` (K3 in its plain output form), ``encoded_dim``,
``monitor.sync`` and ``__version__``, against the JAX package on the CPU.

``fused_render_zvals`` on CPU tensors runs K3's plain version forward and,
for the reference variant, K5's plain version backward (for bmild autograd
of ``apply_nerf``, the JAX backward itself). The JAX function runs its
Pallas kernel in interpret mode, as ``tests/test_render_kernel.py`` runs it.
Inputs come from numpy seeds; weights cross over through
``params_from_numpy``. The CUDA kernels behind it (K3 forward, K5 backward)
are held against the same plain versions on the card by ``chip_smoke.py``
(its ``render_zvals`` phase)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import nerf_tpu
import nerf_tpu_torch
from nerf_tpu.config import ModelConfig as JModelConfig
from nerf_tpu.config import bmild_config as jbmild
from nerf_tpu.models.encoding import encoded_dim as jencoded_dim
from nerf_tpu.models.nerf import init_nerf_params as jinit
from nerf_tpu.ops import quant as jquant
from nerf_tpu.ops import render_kernel as jrk
from nerf_tpu_torch.config import ModelConfig
from nerf_tpu_torch.models.encoding import encoded_dim, positional_encoding
from nerf_tpu_torch.models.nerf import apply_nerf, params_from_numpy
from nerf_tpu_torch.ops import quant, render_kernel, train_kernel
from nerf_tpu_torch.ops.quant import quantize_model, quantized_from_numpy, quantized_nerf_apply
from nerf_tpu_torch.ops.render_kernel import (
    fused_render_samples,
    fused_render_zvals,
    fused_render_zvals_planar,
    fused_render_zvals_raw,
)
from nerf_tpu_torch.utils import monitor
from nerf_tpu_torch.utils.rendering import RenderOutputs
from nerf_tpu_torch.utils.tree import tree_from_leaves, tree_leaves

VARIANTS = ["reference", "bmild"]


def _cfgs(variant):
    jc = JModelConfig() if variant == "reference" else jbmild().model
    return jc, ModelConfig(**dataclasses.asdict(jc))


def _inputs(n, s, seed):
    """Rays of tests/test_render_kernel.py's ``rays`` fixture (origin on the
    +z axis, directions toward the origin) and sorted depths in [2, 6]."""
    rng = np.random.default_rng(seed)
    ro = np.zeros((n, 3), np.float32)
    ro[:, 2] = 4.0
    rd = (rng.normal(size=(n, 3)) * [0.2, 0.2, 1.0]).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) - 0.5
    z = np.sort(rng.uniform(2.0, 6.0, (n, s)), axis=1).astype(np.float32)
    return ro, rd, z


def _cotangents(n, s, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, s)).astype(np.float32),
            rng.normal(size=(n, s, 3)).astype(np.float32))


def _setup(variant, seed, n=13, s=24):
    jc, tc = _cfgs(variant)
    jp = jax.device_get(jinit(jax.random.PRNGKey(seed), jc))
    return jc, tc, jp, params_from_numpy(jp, "cpu"), *_inputs(n, s, seed)


def _grads(fn, tp, ds, dr):
    """{path: gradient} of ``<fn(params), (ds, dr)>`` in the params."""
    paths, leaves = zip(*tree_leaves(tp))
    leaves = [leaf.clone().requires_grad_() for leaf in leaves]
    s, c = fn(tree_from_leaves(paths, leaves))
    return dict(zip(paths, torch.autograd.grad((s, c), leaves,
                                               (torch.tensor(ds), torch.tensor(dr)))))


def _jax_grads(fn, jp, ds, dr):
    def loss(p):
        s, c = fn(p)
        return jnp.sum(s * ds) + jnp.sum(c * dr)

    return {path: torch.tensor(np.asarray(v))
            for path, v in tree_leaves(jax.device_get(jax.grad(loss)(jp)))}


def _worst_rel(a, b):
    assert set(a) == set(b)
    return max(float((a[k] - b[k]).norm() / (b[k].norm() + 1e-20)) for k in b)


def _points(ro, rd, z):
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    return pts, rd[:, None, :].expand(pts.shape)


@pytest.mark.parametrize("variant", VARIANTS)
def test_values_match_jax_fused_render_zvals(variant):
    # float32 compute in both; 1e-4 as tests/test_render_kernel.py's K3
    # parity test. 13 rays: the Pallas kernel pads them to its ray block
    jc, tc, jp, tp, ro, rd, z = _setup(variant, 1)
    s_j, c_j = jrk.fused_render_zvals(jp, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z), jc,
                                      block_samples=256, dtype=jnp.float32, interpret=True)
    sigma, rgb = fused_render_zvals(tp, torch.tensor(ro), torch.tensor(rd), torch.tensor(z), tc,
                                    dtype=torch.float32)
    assert sigma.shape == (13, 24) and rgb.shape == (13, 24, 3)
    np.testing.assert_allclose(sigma.detach().numpy(), np.asarray(s_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(c_j), rtol=1e-4, atol=1e-4)
    # and apply_nerf at the same points (tests/test_render_kernel.py:89-107)
    pts, dirs = _points(*map(torch.tensor, (ro, rd, z)))
    s_ref, c_ref = apply_nerf(tp, pts, dirs, tc)
    np.testing.assert_allclose(sigma.detach().numpy(), s_ref.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(rgb.detach().numpy(), c_ref.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("variant", VARIANTS)
def test_gradients_match_autograd_and_jax(variant):
    # float32: the gradient in every leaf within 1e-5 (relative norm) of
    # autograd of the port's apply_nerf at the points o + d z, and within
    # 1e-4 of jax.grad of JAX's fused_render_zvals (its custom_vjp: the vjp
    # of JAX's apply_nerf); the rays and depths get exactly zero
    jc, tc, jp, tp, ro, rd, z = _setup(variant, 2)
    ds, dr = _cotangents(13, 24, 3)
    tro, trd, tz = (torch.tensor(a).requires_grad_() for a in (ro, rd, z))
    g = _grads(lambda p: fused_render_zvals(p, tro, trd, tz, tc, torch.float32), tp, ds, dr)
    pts, dirs = _points(*map(torch.tensor, (ro, rd, z)))
    g_auto = _grads(lambda p: apply_nerf(p, pts, dirs, tc), tp, ds, dr)
    g_jax = _jax_grads(lambda p: jrk.fused_render_zvals(
        p, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z), jc, 256, jnp.float32, True),
        jp, ds, dr)
    assert all(g[k].shape == g_auto[k].shape for k in g_auto)
    assert _worst_rel(g, g_auto) < 1e-5
    assert _worst_rel(g, g_jax) < 1e-4

    leaf = tp["color1"]["w"].clone().requires_grad_()
    p2 = {**tp, "color1": {"w": leaf, "b": tp["color1"]["b"]}}
    sigma, rgb = fused_render_zvals(p2, tro, trd, tz, tc, torch.float32)
    go, gd, gz, gw = torch.autograd.grad((sigma, rgb), (tro, trd, tz, leaf),
                                         (torch.tensor(ds), torch.tensor(dr)))
    for got, t in ((go, tro), (gd, trd), (gz, tz)):
        assert got.shape == t.shape and torch.equal(got, torch.zeros_like(t))
    assert gw.abs().max() > 0


@pytest.mark.parametrize("variant", VARIANTS)
def test_bf16_gradients(variant):
    # bf16 compute. bmild: the backward is autograd of apply_nerf at the
    # same points, bit for bit (tests/test_render_kernel.py:110-138 asks the
    # same of the TPU function). reference: K5's plain version, which rounds
    # each cotangent as the kernel does; held to the K5 tests' noise class:
    # against float32 autograd at most twice as far as bf16 autograd (or 0.02)
    _, tc, _, tp, ro, rd, z = _setup(variant, 4)
    ds, dr = _cotangents(13, 24, 5)
    tro, trd, tz = map(torch.tensor, (ro, rd, z))
    pts, dirs = _points(tro, trd, tz)
    g = _grads(lambda p: fused_render_zvals(p, tro, trd, tz, tc), tp, ds, dr)
    g_bf16 = _grads(lambda p: apply_nerf(p, pts, dirs, tc, torch.bfloat16), tp, ds, dr)
    if variant == "bmild":
        assert all(torch.equal(g[k], g_bf16[k]) for k in g_bf16)
    else:
        g_f32 = _grads(lambda p: apply_nerf(p, pts, dirs, tc), tp, ds, dr)
        assert _worst_rel(g, g_f32) < max(2.0 * _worst_rel(g_bf16, g_f32), 0.02)


@pytest.mark.parametrize("variant", VARIANTS)
def test_bit_equal_to_the_planar_and_raw_forms(variant):
    # tests/test_render_kernel.py:231-253: the plain output form and the
    # planar form of K3 are the same values; here both are the raw output
    _, tc, _, tp, ro, rd, z = _setup(variant, 6, s=16)
    args = (tp, *map(torch.tensor, (ro, rd, z)), tc)
    for dtype in (torch.float32, torch.bfloat16):
        sigma, rgb = fused_render_zvals(*args, dtype)
        s_p, planes = fused_render_zvals_planar(*args, dtype)
        raw = fused_render_zvals_raw(*args, dtype).reshape(13, 16, 4)
        assert torch.equal(sigma, s_p) and torch.equal(sigma, raw[..., 0])
        for c in range(3):
            assert torch.equal(rgb[..., c], planes[c])
        assert torch.equal(rgb, raw[..., 1:])


@pytest.mark.parametrize("variant", VARIANTS)
def test_one_depth_per_ray(variant):
    # S = 1, which K3 on the card runs through the per-sample kernel (C1):
    # values against JAX's function and apply_nerf, gradients against
    # autograd of apply_nerf
    jc, tc, jp, tp, ro, rd, z = _setup(variant, 7, n=11, s=1)
    ds, dr = _cotangents(11, 1, 8)
    s_j, c_j = jrk.fused_render_zvals(jp, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z), jc,
                                      block_samples=256, dtype=jnp.float32, interpret=True)
    tro, trd, tz = map(torch.tensor, (ro, rd, z))
    sigma, rgb = fused_render_zvals(tp, tro, trd, tz, tc, torch.float32)
    assert sigma.shape == (11, 1) and rgb.shape == (11, 1, 3)
    np.testing.assert_allclose(sigma.detach().numpy(), np.asarray(s_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(c_j), rtol=1e-4, atol=1e-4)
    pts, dirs = _points(tro, trd, tz)
    g = _grads(lambda p: fused_render_zvals(p, tro, trd, tz, tc, torch.float32), tp, ds, dr)
    assert _worst_rel(g, _grads(lambda p: apply_nerf(p, pts, dirs, tc), tp, ds, dr)) < 1e-5


def test_quantized_weights_forward_only():
    # tests/test_render_kernel.py:164-185: int8 weights, 10% pruned, bmild,
    # float32 compute, against the port's quantized_nerf_apply at the same
    # points (1e-4) and against JAX's fused_render_zvals on JAX's quantized
    # weights carried into the port's layout (the dequantize route's 1e-4 of
    # tests/test_torch_quant.py). Quantized weights are forward-only, as in
    # the JAX package: the outputs carry no gradient
    jc, tc, jp, tp, ro, rd, z = _setup("bmild", 9)
    q = quantize_model({"fine": tp}, tc, bits=8, prune_fraction=0.1)[0]["fine"]
    tro, trd, tz = map(torch.tensor, (ro, rd, z))
    sigma, rgb = fused_render_zvals(q, tro, trd, tz, tc, torch.float32)
    assert not sigma.requires_grad and not rgb.requires_grad
    pts, _ = _points(tro, trd, tz)
    s_ref, c_ref = quantized_nerf_apply(q, pts, trd[:, None, :], tc, torch.float32)
    np.testing.assert_allclose(sigma.numpy(), s_ref.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(rgb.numpy(), c_ref.numpy(), rtol=1e-4, atol=1e-4)

    jq = jquant.quantize_model({"fine": jp}, jc, bits=8, prune_fraction=0.1)[0]["fine"]
    carried = quantized_from_numpy({k: None if v is None else np.asarray(v)
                                    for k, v in jq._asdict().items()}, tc, "cpu")
    s_j, c_j = jrk.fused_render_zvals(jq, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z), jc,
                                      block_samples=256, dtype=jnp.float32, interpret=True)
    s_c, c_c = fused_render_zvals(carried, tro, trd, tz, tc, torch.float32)
    np.testing.assert_allclose(s_c.numpy(), np.asarray(s_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(c_c.numpy(), np.asarray(c_j), rtol=1e-4, atol=1e-4)


def test_int8_compute_weights():
    # tests/test_quant.py:139-176: int8-compute weights through K1 and K3 at
    # the same depths agree (2e-2), and sit within 0.3 x max(std, 1) (sigma)
    # and 0.15 (rgb) of float32 apply_nerf
    _, tc, _, tp, _, _, _ = _setup("reference", 10)
    qm, _ = quantize_model({"fine": tp}, tc, bits=8, prune_fraction=0.0, act_bits=8,
                           pos_bound=6.0)
    assert quant.route_of(qm["fine"]) == quant.ROUTE_INT8_COMPUTE
    rng = np.random.default_rng(3)
    ro, rd = torch.zeros(8, 3), torch.tensor(rng.normal(size=(8, 3)).astype(np.float32))
    sigma, rgb, z = fused_render_samples(qm["fine"], ro, rd, 2.0, 6.0, 8, tc)
    sigma2, rgb2 = fused_render_zvals(qm["fine"], ro, rd, z.contiguous(), tc)
    assert sigma2.shape == (8, 8) and rgb2.shape == (8, 8, 3)
    np.testing.assert_allclose(sigma2.numpy(), sigma.numpy(), rtol=2e-2, atol=2e-2)
    pts, dirs = _points(ro, rd, z)
    s_ref, c_ref = apply_nerf(tp, pts, dirs, tc)
    scale = max(float(s_ref.std()), 1.0)
    np.testing.assert_allclose(sigma.numpy(), s_ref.numpy(), atol=0.3 * scale)
    np.testing.assert_allclose(rgb.numpy(), c_ref.numpy(), atol=0.15)


def test_cpu_counts_no_launch_and_other_tensors_go_to_the_kernels(monkeypatch):
    # CPU tensors: the plain versions, no launch counted. Any other tensor
    # (here on the meta device) goes to K3's launcher forward and to K5's
    # (reference) backward, never to a plain version
    _, tc, _, tp, ro, rd, z = _setup("reference", 11, n=5, s=8)
    before = (dict(render_kernel.launches), dict(train_kernel.launches))
    leaves = dict(tree_leaves(tp))
    leaves = {k: v.clone().requires_grad_() for k, v in leaves.items()}
    s, c = fused_render_zvals(tree_from_leaves(list(leaves), list(leaves.values())),
                              *map(torch.tensor, (ro, rd, z)), tc)
    (s.sum() + c.sum()).backward()
    assert (dict(render_kernel.launches), dict(train_kernel.launches)) == before

    def plain(*a, **k):
        raise AssertionError("the plain version ran on a tensor that is not on the CPU")

    calls = []
    meta = torch.empty(5, 3, device="meta")
    zm = torch.empty(5, 8, device="meta")
    monkeypatch.setattr(render_kernel, "fused_render_zvals_plain", plain)
    monkeypatch.setattr(train_kernel, "packed_grads_plain", plain)
    monkeypatch.setattr(render_kernel, "_launch", lambda *a, **k: calls.append(
        ("K3", a[5], k.get("z_vals") is zm)) or torch.empty(5, 32, device="meta"))
    monkeypatch.setattr(train_kernel, "_launch", lambda *a, **k: calls.append(
        ("K5", a[1].shape[0])) or {n: torch.empty(sh, device="meta")
                                   for n, sh in train_kernel.GRAD_SHAPES.items()})
    p_meta = {k: v.detach().to("meta").requires_grad_() for k, v in leaves.items()}
    s, c = fused_render_zvals(tree_from_leaves(list(p_meta), list(p_meta.values())),
                              meta, meta, zm, tc)
    torch.autograd.grad((s, c), list(p_meta.values()), (torch.empty_like(s), torch.empty_like(c)))
    assert calls == [("K3", 8, True), ("K5", 40)]


@pytest.mark.parametrize("in_dim,num_freqs", [(3, 0), (3, 1), (3, 4), (3, 10), (2, 6)])
def test_encoded_dim(in_dim, num_freqs):
    # tests/test_encoding.py:12-19, against the JAX package's function
    assert encoded_dim(in_dim, num_freqs) == jencoded_dim(in_dim, num_freqs)
    out = positional_encoding(torch.ones(7, in_dim), num_freqs)
    assert out.shape == (7, encoded_dim(in_dim, num_freqs))
    assert (encoded_dim(3, 10), encoded_dim(3, 4)) == (63, 27)
    assert (ModelConfig().pos_dim, ModelConfig().dir_dim) == (63, 27)


def test_sync_on_a_cpu_result(monkeypatch):
    # nothing to fence on the CPU: no device is synchronized, nothing is
    # returned, the result is left as it was
    @dataclasses.dataclass
    class Box:
        a: torch.Tensor
        rest: list

    def refuse(*a, **k):
        raise AssertionError("synchronized a device for a CPU result")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    t = torch.arange(6.0).reshape(2, 3)
    out = RenderOutputs(t, t[:, 0], t[:, 1], None)
    result = {"x": (t, [out, 3.0]), "box": Box(t.clone(), [None, "s", {"y": t}])}
    before = [v.clone() for v in (t, result["box"].a)]
    assert monitor.sync(result) is None
    assert monitor.sync(t) is None and monitor.sync(None) is None
    assert torch.equal(t, before[0]) and torch.equal(result["box"].a, before[1])
    assert result["x"][1][0] is out and result["x"][1][1] == 3.0


def test_version_is_the_jax_package_version():
    assert nerf_tpu_torch.__version__ == nerf_tpu.__version__ == "0.1.0"
