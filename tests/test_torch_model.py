"""PyTorch port vs JAX package: encoding, MLP, params carry-across.

Inputs come from numpy with fixed seeds (JAX's seeded init for params) and
go through the JAX function and its port counterpart on the CPU.
"""

import dataclasses
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_tpu.config import ModelConfig as JModelConfig, bmild_config as jbmild
from nerf_tpu.models.encoding import positional_encoding as jpe
from nerf_tpu.models.nerf import (
    apply_nerf as japply,
    count_params as jcount,
    init_nerf_params as jinit,
    params_to_torch_state_dict,
)
from nerf_tpu_torch.models.nerf import params_to_torch_state_dict as port_to_state_dict
from nerf_tpu.train.checkpoint import restore_bare_params as jrestore
from nerf_tpu_torch.config import ModelConfig
from nerf_tpu_torch.models.encoding import positional_encoding
from nerf_tpu_torch.models.nerf import (
    apply_nerf,
    count_params,
    init_nerf_params,
    params_from_numpy,
    params_from_torch_state_dict,
    params_to_numpy,
)
from nerf_tpu_torch.train.checkpoint import parse_keystr, restore_bare_params

PARAMS = Path(__file__).resolve().parents[1] / "results/convergence/final_params.npz"


def _cfgs(variant, **narrow):
    jc = JModelConfig() if variant == "reference" else jbmild().model
    jc = dataclasses.replace(jc, **narrow)
    return jc, ModelConfig(**dataclasses.asdict(jc))


def _jax_params(jcfg, seed):
    return jax.device_get(jinit(jax.random.PRNGKey(seed), jcfg))


def _points(n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    return pos, dirs


@pytest.mark.parametrize("num_freqs,include_pi", [(10, True), (10, False), (4, True), (0, True)])
def test_positional_encoding_matches_jax(num_freqs, include_pi):
    # atol 1e-4: XLA's and ATen's sin/cos differ by ulps of the result at
    # phases up to 2^9 * pi * |x| (~5e3 rad here)
    x = np.random.default_rng(0).uniform(-3.0, 3.0, (257, 3)).astype(np.float32)
    ref = np.asarray(jpe(jnp.asarray(x), num_freqs, include_pi))
    got = positional_encoding(torch.tensor(x), num_freqs, include_pi).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("variant", ["reference", "bmild"])
def test_apply_nerf_narrow_f32(variant):
    # same formulas in float32: rtol/atol 1e-4 covers sin ulps and matmul
    # summation order
    jc, tc = _cfgs(variant, hidden_dim=64, n_layers=4, skip_layer=2, color_hidden_dim=32)
    p = _jax_params(jc, 3)
    pos, dirs = _points(300, 1)
    s_ref, c_ref = japply(p, jnp.asarray(pos), jnp.asarray(dirs), jc)
    s, c = apply_nerf(params_from_numpy(p, "cpu"), torch.tensor(pos), torch.tensor(dirs), tc)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", ["reference", "bmild"])
def test_apply_nerf_full_width_bf16(variant):
    # bf16 inputs, f32 accumulation in both packages; the 2e-2 tolerance
    # covers an activation that rounds to the neighbouring bf16 value after
    # a different float32 summation order
    jc, tc = _cfgs(variant)
    p = _jax_params(jc, 4)
    pos, dirs = _points(200, 2)
    s_ref, c_ref = japply(p, jnp.asarray(pos), jnp.asarray(dirs), jc,
                          compute_dtype=jnp.bfloat16)
    s, c = apply_nerf(params_from_numpy(p, "cpu"), torch.tensor(pos), torch.tensor(dirs),
                      tc, compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=2e-2, atol=2e-2)


def test_apply_nerf_trained_weights_f32():
    if not PARAMS.exists():
        pytest.skip(f"{PARAMS} not present")
    jc, tc = _cfgs("reference")
    with np.load(PARAMS) as data:
        flat = {k: data[k] for k in data.files}
    p = params_from_numpy(flat, "cpu")["fine"]
    # points along camera-like rays through the scene
    rng = np.random.default_rng(5)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    o = (-4.0 * d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    z = np.linspace(2.0, 6.0, 16, dtype=np.float32)
    pos = (o[:, None] + d[:, None] / np.linalg.norm(d, axis=1, keepdims=True)[:, None]
           * z[None, :, None]).reshape(-1, 3).astype(np.float32)
    dirs = np.repeat(d, 16, axis=0)
    jp = jax.tree.map(jnp.asarray, jrestore(str(PARAMS), {"fine": jinit(jax.random.PRNGKey(0), jc),
                                                         "coarse": jinit(jax.random.PRNGKey(1), jc)}))
    s_ref, c_ref = japply(jp["fine"], jnp.asarray(pos), jnp.asarray(dirs), jc)
    s, c = apply_nerf(p, torch.tensor(pos), torch.tensor(dirs), tc)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", ["reference", "bmild"])
def test_init_shapes_and_count_match_jax(variant):
    jc, tc = _cfgs(variant)
    jp = _jax_params(jc, 0)
    tp = init_nerf_params(torch.Generator().manual_seed(0), tc, "cpu")
    j_shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    t_shapes = jax.tree.map(lambda a: tuple(a.shape), params_to_numpy(tp))
    assert t_shapes == j_shapes
    assert count_params(tp) == jcount(jp)
    # torch.nn.Linear's rule: every layer inside U(-1/sqrt(fan_in), +)
    for layer in tp["trunk"] + [tp["density"], tp["color0"]]:
        bound = 1.0 / np.sqrt(layer["w"].shape[0])
        assert layer["w"].abs().max() <= bound and layer["b"].abs().max() <= bound


def test_init_is_seeded():
    tc = ModelConfig()
    a = init_nerf_params(torch.Generator().manual_seed(7), tc, "cpu")
    b = init_nerf_params(torch.Generator().manual_seed(7), tc, "cpu")
    assert torch.equal(a["trunk"][3]["w"], b["trunk"][3]["w"])


def test_params_from_numpy_round_trip():
    jc, _ = _cfgs("bmild")
    p = _jax_params(jc, 9)
    tp = params_from_numpy(p, "cpu")
    assert tp["trunk"][5]["w"].dtype == torch.float32
    back = params_to_numpy(tp)
    jax.tree.map(np.testing.assert_array_equal, back, jax.tree.map(np.asarray, p))


def test_keystr_archive_matches_jax_restore():
    if not PARAMS.exists():
        pytest.skip(f"{PARAMS} not present")
    jc, _ = _cfgs("reference")
    template = {"coarse": jinit(jax.random.PRNGKey(0), jc), "fine": jinit(jax.random.PRNGKey(1), jc)}
    ref = jax.tree.map(np.asarray, jrestore(str(PARAMS), template))
    got = restore_bare_params(str(PARAMS))
    jax.tree.map(np.testing.assert_array_equal, got, ref)
    assert parse_keystr("['fine']['trunk'][4]['w']") == ["fine", "trunk", 4, "w"]
    with pytest.raises(ValueError):
        parse_keystr("d:fine//s:0")


def test_torch_state_dict_import_matches_jax():
    jc, tc = _cfgs("reference")
    p = _jax_params(jc, 11)
    sd = {k: torch.tensor(v) for k, v in params_to_torch_state_dict(p).items()}
    tp = params_from_torch_state_dict(sd, tc, "cpu")
    jax.tree.map(np.testing.assert_array_equal, params_to_numpy(tp),
                 jax.tree.map(np.asarray, p))


@pytest.mark.parametrize("narrow", [{}, dict(hidden_dim=32, n_layers=4, skip_layer=2,
                                            color_hidden_dim=16)],
                         ids=["full_width", "narrow"])
def test_torch_state_dict_export_matches_jax_and_round_trips(narrow):
    jc, tc = _cfgs("reference", **narrow)
    p = _jax_params(jc, 12)
    got = port_to_state_dict(params_from_numpy(p, "cpu"))
    ref = params_to_torch_state_dict(p)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == np.float32 and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # the inverse of params_from_torch_state_dict, bit for bit both ways
    back = params_from_torch_state_dict(got, tc, "cpu")
    jax.tree.map(np.testing.assert_array_equal, params_to_numpy(back),
                 jax.tree.map(np.asarray, p))
    again = port_to_state_dict(back)
    assert all(np.array_equal(again[k], got[k]) for k in got)
