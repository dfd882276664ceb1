"""The compressed and int8-compute slice vs the JAX package on the CPU:
pruning, quantization (bit-equal per logical row and column), the stats
report, and the plain versions of the dequantize-in-kernel MLP (K7), of the
int8-compute route (K8) and of the ray kernels on quantized weights, against
the Pallas kernels in interpret mode at float32 compute (as
``tests/test_quant.py`` runs them). The CUDA kernels are held against the
same plain versions on the card by ``chip_smoke.py``."""

import dataclasses
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_tpu.config import ModelConfig as JModelConfig
from nerf_tpu.config import bmild_config as jbmild
from nerf_tpu.models import apply_nerf as japply
from nerf_tpu.models.nerf import init_nerf_params as jinit
from nerf_tpu.ops import quant as jquant
from nerf_tpu.ops import render_kernel as jrk
from nerf_tpu.ops.mlp_kernel import _enc_perm as j_enc_perm
from nerf_tpu_torch.config import ModelConfig, RenderConfig
from nerf_tpu_torch.models.nerf import apply_nerf, params_from_numpy, params_to_numpy
from nerf_tpu_torch.ops import quant, render_kernel
from nerf_tpu_torch.ops.mlp_kernel import pack_params
from nerf_tpu_torch.ops.quant import (
    Int8PackedWeights,
    QuantizedPackedWeights,
    make_quantized_apply_fn,
    prune_params,
    quantize_model,
    quantized_from_numpy,
    quantized_nerf_apply,
)
from nerf_tpu_torch.render.pipeline import render_rays
from nerf_tpu_torch.train.checkpoint import restore_bare_params

PARAMS = Path(__file__).resolve().parents[1] / "results/convergence/final_params.npz"


def _cfgs(variant):
    jc = JModelConfig() if variant == "reference" else jbmild().model
    return jc, ModelConfig(**dataclasses.asdict(jc))


def _weights(source, variant):
    """JAX params (numpy leaves): seeded, or the trained fine network."""
    if source == "trained":
        if not PARAMS.exists():
            pytest.skip(f"{PARAMS} not present")
        return restore_bare_params(str(PARAMS))["fine"]
    return jax.device_get(jinit(jax.random.PRNGKey(0), _cfgs(variant)[0]))


def _np(q):
    return {k: None if v is None else np.asarray(v) for k, v in q._asdict().items()}


def _inputs(n, seed, lim=2.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-lim, lim, (n, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32))


CASES = [("seeded", "reference"), ("seeded", "bmild"), ("trained", "reference")]


@pytest.mark.parametrize("source,variant", CASES)
@pytest.mark.parametrize("bits,act_bits", [(8, None), (16, None), (8, 8)])
def test_quantized_tensors_bit_equal_to_jax(source, variant, bits, act_bits):
    # every q and s of quantize_model (prune 10%, pack in float32, quantize)
    # equals the JAX package's, bit for bit per logical row and column: the
    # JAX tensors are carried into the port's layout (encoding rows back in
    # the reference order, whead split by columns) and compared exactly.
    # The pruned masks are equal as they stand: the port's quantile repeats
    # jnp.quantile's float32 expression, no threshold needed an adjustment
    jc, tc = _cfgs(variant)
    p = _weights(source, variant)
    kw = dict(bits=bits, prune_fraction=0.1, act_bits=act_bits, pos_bound=6.0)
    jq, jstats = jquant.quantize_model({"fine": p}, jc, **kw)
    tq, tstats = quantize_model({"fine": params_from_numpy(p, "cpu")}, tc, **kw)
    want = quantized_from_numpy(_np(jq["fine"]), tc, "cpu")
    got = tq["fine"]
    assert type(got) is type(want) is (Int8PackedWeights if act_bits else QuantizedPackedWeights)
    for name, a in got._asdict().items():
        b = getattr(want, name)
        if a is None:
            assert b is None, name
            continue
        assert a.dtype == b.dtype, name
        if name.endswith("_q"):
            assert a.dtype == (torch.int8 if bits == 8 else torch.int16)
        np.testing.assert_array_equal(a.numpy().reshape(b.shape), b.numpy(), err_msg=name)
    # the stats: original size and sparsity are JAX's; the compressed size
    # counts the port's own tensors, which lack JAX's phase matrices (f_pos
    # [3, 33], f_dir [3, 15] in float32) and its wider encoding rows
    # (72 + 72 position rows and 40 direction rows for the half-angle ladder
    # against 64 + 64 and 32): the difference is exactly those bytes
    js, ts = jstats["networks"]["fine"], tstats["networks"]["fine"]
    assert {k: tstats[k] for k in ("bits", "prune_fraction", "act_bits")} == \
        {k: jstats[k] for k in ("bits", "prune_fraction", "act_bits")}
    assert ts["original_mb"] == js["original_mb"]
    assert ts["sparsity"] == pytest.approx(js["sparsity"], abs=1e-12)
    width = bits // 8
    extra = (3 * 33 + 3 * 15) * 4 + (2 * (72 - 64) * 256 + (40 - 32) * 128) * width
    if act_bits:
        extra += (72 - 64) * 4                       # enc_scale
    assert round((js["compressed_mb"] - ts["compressed_mb"]) * 1e6) == extra
    assert ts["compression_ratio"] == pytest.approx(
        ts["original_mb"] / ts["compressed_mb"], rel=1e-12)


@pytest.mark.parametrize("source,variant", CASES)
@pytest.mark.parametrize("fraction", [0.1, 0.3])
def test_pruned_masks_equal_jax(source, variant, fraction):
    p = _weights(source, variant)
    jp = jax.device_get(jquant.prune_params(jax.tree.map(jnp.asarray, p), fraction))
    tp = params_to_numpy(prune_params(params_from_numpy(p, "cpu"), fraction))
    jax.tree.map(np.testing.assert_array_equal, tp, jp)
    w = tp["trunk"][2]["w"]
    assert fraction - 0.02 < float((w == 0).mean()) < fraction + 0.03
    np.testing.assert_array_equal(tp["trunk"][2]["b"], p["trunk"][2]["b"])   # biases untouched
    assert prune_params(p, 0.0) is p


def test_enc_perm_is_the_jax_kernel_layout():
    for L in (4, 10):
        np.testing.assert_array_equal(quant._enc_perm(L), j_enc_perm(L))


def _carried(variant, bits, act_bits, pos_bound=2.0, source="seeded", prune=0.0):
    """JAX-quantized weights of a seeded network, and the same in the port's
    layout."""
    jc, tc = _cfgs(variant)
    p = _weights(source, variant)
    jq, _ = jquant.quantize_model({"fine": p}, jc, bits=bits, prune_fraction=prune,
                                  act_bits=act_bits, pos_bound=pos_bound)
    return jc, tc, p, jq["fine"], quantized_from_numpy(_np(jq["fine"]), tc, "cpu")


# Tolerances against the Pallas kernel at float32 compute. Dequantize route:
# the 1e-4 of the K1 parity test (same weights after dequantization; the
# residual is the encoding's cos taken directly against 1 - 2 sin^2;
# measured <= 6e-6 on rgb, 6e-6 of max|sigma|). Int8 route: an encoding
# column within an ulp of a rounding boundary of round(enc * 127) lands on
# the other side in the two packages (that same cos), a +-1 LSB flip that
# moves a trunk pre-activation by ~s/127 and passes through seven
# requantized layers. Measured on rgb: 7.9e-4 (trained network), 2.3e-5
# (seeded ones, which are mostly ReLU-dead); on sigma 1.7e-4 at
# max|sigma| = 0.04. Held to 2e-3 on rgb and 1e-2 x max(max|sigma|, 1).
DEQUANT_TOL = 1e-4
INT8_RGB_TOL, INT8_SIGMA_TOL = 2e-3, 1e-2


@pytest.mark.parametrize("source,variant", CASES)
@pytest.mark.parametrize("bits,act_bits", [(8, None), (16, None), (8, 8)])
def test_plain_matches_pallas_interpret(source, variant, bits, act_bits):
    jc, tc, _, jq, tq = _carried(variant, bits, act_bits, source=source,
                                 prune=0.1 if source == "trained" else 0.0)
    pos, dirs = _inputs(300, 1, lim=1.5)
    s_j, c_j = jquant.quantized_nerf_apply(jq, jnp.asarray(pos), jnp.asarray(dirs), jc,
                                           block=128, dtype=jnp.float32, interpret=True)
    s_t, c_t = quantized_nerf_apply(tq, torch.tensor(pos), torch.tensor(dirs), tc,
                                    dtype=torch.float32)
    assert s_t.shape == (300,) and c_t.shape == (300, 3)
    if act_bits is None:
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=DEQUANT_TOL,
                                   atol=DEQUANT_TOL)
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=DEQUANT_TOL,
                                   atol=DEQUANT_TOL)
    else:
        scale = float(np.abs(np.asarray(s_j)).max())
        assert np.abs(c_t.numpy() - np.asarray(c_j)).max() < INT8_RGB_TOL
        assert np.abs(s_t.numpy() - np.asarray(s_j)).max() < INT8_SIGMA_TOL * max(scale, 1.0)


@pytest.mark.parametrize("act_bits", [None, 8])
def test_both_packages_within_test_quant_bounds_of_float32(act_bits):
    # tests/test_quant.py's bounds against float32 apply_nerf: rgb atol 0.08,
    # sigma 0.1 x max(std, 1), on its setup (seed-0 network, positions in
    # [-2, 2]); held for the port's plain version and for the Pallas kernel
    jc, tc, p, jq, tq = _carried("reference", 8, act_bits, pos_bound=2.0)
    pos, dirs = _inputs(300, 2)
    s_ref, c_ref = japply(p, jnp.asarray(pos), jnp.asarray(dirs), jc)
    s_ref, c_ref = np.asarray(s_ref), np.asarray(c_ref)
    s_j, c_j = jquant.quantized_nerf_apply(jq, jnp.asarray(pos), jnp.asarray(dirs), jc,
                                           block=128, dtype=jnp.float32, interpret=True)
    s_t, c_t = quantized_nerf_apply(tq, torch.tensor(pos), torch.tensor(dirs), tc,
                                    dtype=torch.float32)
    scale = max(float(s_ref.std()), 1.0)
    for s, c in ((np.asarray(s_j), np.asarray(c_j)), (s_t.numpy(), c_t.numpy())):
        np.testing.assert_allclose(c, c_ref, atol=0.08)
        np.testing.assert_allclose(s, s_ref, atol=0.1 * scale)


def test_int16_tighter_than_int8():
    _, tc, p, _, _ = _carried("reference", 8, None)
    pt = params_from_numpy(p, "cpu")
    pos, dirs = (torch.tensor(a) for a in _inputs(300, 3))
    _, c_ref = apply_nerf(pt, pos, dirs, tc)
    err = {}
    for bits in (8, 16):
        qm, _ = quantize_model({"fine": pt}, tc, bits=bits, prune_fraction=0.0)
        _, c_q = quantized_nerf_apply(qm["fine"], pos, dirs, tc, dtype=torch.float32)
        err[bits] = float((c_q - c_ref).abs().max())
    assert err[16] < err[8]
    assert err[16] < 5e-3


def test_int8_compute_on_a_trained_model_and_beyond_the_bound():
    # on the trained network (seeded ones are mostly ReLU-dead): rgb rms
    # < 0.05 and sigma correlation > 0.99 against float32, the bars of
    # tests/test_quant.py's trained-model case. Positions beyond pos_bound
    # saturate at the int8 clip: finite, and equal to the Pallas kernel's
    # within the int8 tolerances
    if not PARAMS.exists():
        pytest.skip(f"{PARAMS} not present")
    jc, tc, p, jq, tq = _carried("reference", 8, 8, pos_bound=2.0, source="trained")
    pos, dirs = (torch.tensor(a) for a in _inputs(600, 5, lim=1.2))
    s_ref, c_ref = apply_nerf(params_from_numpy(p, "cpu"), pos, dirs, tc)
    s_q, c_q = quantized_nerf_apply(tq, pos, dirs, tc, dtype=torch.float32)
    assert float(((c_q - c_ref) ** 2).mean().sqrt()) < 0.05
    assert np.corrcoef(s_q.numpy().ravel(), s_ref.numpy().ravel())[0, 1] > 0.99

    jc, tc, _, jq, tq = _carried("reference", 8, 8, pos_bound=1.0)
    far = np.full((64, 3), 5.0, np.float32)
    dirs = _inputs(64, 6)[1]
    s_t, c_t = quantized_nerf_apply(tq, torch.tensor(far), torch.tensor(dirs), tc,
                                    dtype=torch.float32)
    s_j, c_j = jquant.quantized_nerf_apply(jq, jnp.asarray(far), jnp.asarray(dirs), jc,
                                           block=64, dtype=jnp.float32, interpret=True)
    assert torch.isfinite(s_t).all() and torch.isfinite(c_t).all()
    assert np.abs(c_t.numpy() - np.asarray(c_j)).max() < INT8_RGB_TOL
    # the clip itself: an encoding of 5 / 1 saturates at 127, where the
    # unclipped product would be 635
    big = torch.full((1, 64), 5.0)
    out = quant.int8_mm(big, torch.ones(64, 2, dtype=torch.int8), torch.ones(1, 2),
                        pre=torch.ones(64))
    torch.testing.assert_close(out, torch.full((1, 2), 64 * 127 / 127.0))
    # a row of zeros under the per-row scale gives zeros, not NaN
    zero = quant.int8_mm(torch.zeros(2, 8), torch.ones(8, 3, dtype=torch.int8), torch.ones(1, 3))
    assert (zero == 0).all()


def test_int8_compute_requires_8bit_weights():
    _, tc = _cfgs("reference")
    p = params_from_numpy(_weights("seeded", "reference"), "cpu")
    with pytest.raises(ValueError, match="int8 compute"):
        quantize_model({"fine": p}, tc, bits=16, act_bits=8)
    with pytest.raises(ValueError, match="int8 compute"):
        quantize_model({"fine": p}, tc, bits=8, act_bits=16)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    ro = np.zeros((n, 3), np.float32)
    ro[:, 2] = 4.0
    rd = (rng.normal(size=(n, 3)) * [0.2, 0.2, 1.0]).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) - 0.5
    return ro, rd


@pytest.mark.parametrize("variant", ["reference", "bmild"])
@pytest.mark.parametrize("bits,act_bits", [(8, None), (16, None), (8, 8)])
def test_ray_kernels_plain_match_pallas_interpret(variant, bits, act_bits):
    # quantized weights through K1 (uniform depths) and K3 (per-ray depths),
    # raw and composited, against the Pallas kernels given the same
    # quantized weights; tolerances as above (composited rgb: the weights sum
    # to at most 1, so the per-sample rgb tolerance holds for the pixel)
    jc, tc, _, jq, tq = _carried(variant, bits, act_bits, pos_bound=8.0)
    S = 16
    ro, rd = _rays(21, 4)
    z = np.sort(np.random.default_rng(5).uniform(2.0, 6.0, (21, S)), axis=1).astype(np.float32)
    jro, jrd, jz = jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z)
    tro, trd, tz = torch.tensor(ro), torch.tensor(rd), torch.tensor(z)
    kw = dict(dtype=jnp.float32, interpret=True)
    raw1_j, _ = jrk.fused_render_samples(jq, jro, jrd, 2.0, 6.0, S, jc, raw=True, **kw)
    raw3_j = jrk.fused_render_zvals_raw(jq, jro, jrd, jz, jc, **kw)
    out1_j, _ = jrk.fused_render_samples_composited(jq, jro, jrd, 2.0, 6.0, S, jc, **kw)
    out3_j = jrk.fused_render_zvals_composited(jq, jro, jrd, jz, jc, **kw)
    raw1, _ = render_kernel.fused_render_samples(tq, tro, trd, 2.0, 6.0, S, tc, raw=True,
                                                 dtype=torch.float32)
    raw3 = render_kernel.fused_render_zvals_raw(tq, tro, trd, tz, tc, dtype=torch.float32)
    out1, _ = render_kernel.fused_render_samples_composited(tq, tro, trd, 2.0, 6.0, S, tc,
                                                            dtype=torch.float32)
    out3 = render_kernel.fused_render_zvals_composited(tq, tro, trd, tz, tc,
                                                       dtype=torch.float32)
    for got, want in ((raw1, raw1_j), (raw3, raw3_j)):
        got, want = got.numpy().reshape(-1, 4), np.asarray(want).reshape(-1, 4)
        if act_bits is None:
            np.testing.assert_allclose(got, want, rtol=DEQUANT_TOL, atol=DEQUANT_TOL)
        else:
            scale = max(float(np.abs(want[:, 0]).max()), 1.0)
            assert np.abs(got[:, 1:] - want[:, 1:]).max() < INT8_RGB_TOL
            assert np.abs(got[:, 0] - want[:, 0]).max() < INT8_SIGMA_TOL * scale
    tol = DEQUANT_TOL if act_bits is None else INT8_RGB_TOL
    for got, want in ((out1, out1_j), (out3, out3_j)):
        np.testing.assert_allclose(got.numpy()[:, [0, 1, 2, 4]], np.asarray(want)[:, [0, 1, 2, 4]],
                                   atol=tol, rtol=0)


def test_ray_kernels_within_test_quant_bounds_of_float32():
    # tests/test_quant.py's int8-compute ray-kernel case: sigma within
    # 0.3 x max(std, 1) and rgb within 0.15 of float32 apply_nerf
    _, tc, p, _, tq = _carried("reference", 8, 8, pos_bound=6.0)
    rng = np.random.default_rng(3)
    ro, rd = torch.zeros(8, 3), torch.tensor(rng.normal(size=(8, 3)).astype(np.float32))
    sigma, rgb, z = render_kernel.fused_render_samples(tq, ro, rd, 2.0, 6.0, 8, tc,
                                                       dtype=torch.float32)
    assert sigma.shape == (8, 8) and rgb.shape == (8, 8, 3)
    pts = ro[:, None] + rd[:, None] * z[..., None]
    s_ref, c_ref = apply_nerf(params_from_numpy(p, "cpu"), pts, rd[:, None].expand(pts.shape), tc)
    scale = max(float(s_ref.std()), 1.0)
    np.testing.assert_allclose(sigma.numpy(), s_ref.numpy(), atol=0.3 * scale)
    np.testing.assert_allclose(rgb.numpy(), c_ref.numpy(), atol=0.15)


def test_pipeline_integration_and_cpu_counts_no_launch():
    # the quantized apply_fn slots into render_rays (the use_importance=False
    # path of the compressed engine); CPU tensors take the plain version and
    # count no launch
    _, tc = _cfgs("reference")
    p = params_from_numpy(_weights("seeded", "reference"), "cpu")
    qm, _ = quantize_model({"coarse": p, "fine": p}, tc, bits=8, prune_fraction=0.1)
    before = dict(quant.launches)
    rd = torch.tensor(np.random.default_rng(2).normal(size=(16, 3)).astype(np.float32))
    out = render_rays(qm["coarse"], qm["fine"], torch.zeros(16, 3), rd, tc,
                      RenderConfig(n_coarse=8, n_fine=8, use_importance=False),
                      apply_fn=make_quantized_apply_fn(torch.float32))
    assert out.fine.rgb.shape == (16, 3) and torch.isfinite(out.fine.rgb).all()
    assert quant.launches == before


def test_kernel_path_refuses_what_it_cannot_compute():
    # validated before any pointer reaches the CUDA library
    _, tc = _cfgs("reference")
    p = params_from_numpy(_weights("seeded", "reference"), "cpu")
    q = quantize_model({"fine": p}, tc, prune_fraction=0.0)[0]["fine"]
    pos = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="bfloat16"):
        quant._launch(q, pos, pos, tc, torch.float32)
    with pytest.raises(ValueError, match="directions"):
        quant._launch(q, pos, pos[:2], tc)
    with pytest.raises(ValueError, match="variant"):
        quant._launch(q, pos, pos, _cfgs("bmild")[1])
    with pytest.raises(ValueError, match="wt_q"):
        quant._launch(q._replace(wt_q=q.wt_q.to(torch.int16)), pos, pos, tc)
    with pytest.raises(ValueError, match="bfloat16"):
        render_kernel._launch(q, pos, pos, 2.0, 6.0, 8, tc, dtype=torch.float32)
    assert quant.route_of(q) == 1
    q16 = quantize_model({"fine": p}, tc, bits=16, prune_fraction=0.0)[0]["fine"]
    q8c = quantize_model({"fine": p}, tc, act_bits=8, prune_fraction=0.0)[0]["fine"]
    assert quant.route_of(q16) == 2 and quant.route_of(q8c) == 3
    assert pack_params(p, tc).w0.shape == q.w0_q.shape == (64, 256)
