"""PyTorch port, JAX's environment switches in the model module.

The JAX model reads ``SWIN_MLP_IMPL``, ``SWIN_LNADD_IMPL``, ``SWIN_LN_IMPL``
and ``SWIN_CPB_UNIQUE`` at import into module globals, validates them and
reads the globals when a module runs (a config key wins over the first two;
``SWIN_CPB_UNIQUE``, when set, over the ``cpb_unique`` key). The port's
``models/swin.py`` mirrors them. Here each switch is set in both packages at
once (the module globals patched, as tests/test_torch_qkv_v45.py patches
``QKV_IMPL``), the port's route is checked and the micro model (or the
module) is held to JAX's on the same seeded weights; an invalid value of
each switch makes the port's import raise.

Tolerances: the model bounds of tests/test_torch_model.py (relative to the
output or gradient-leaf scale: fp32 forward 5e-3 max / 1e-4 mean, gradients
2e-2 / 1e-2 per leaf); the module bounds in bf16 ulps of the output scale
(tests/test_torch_kernels.py).
"""

import contextlib
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swin_v2_weather_tpu.models import swin as jax_swin
from swin_v2_weather_torch.models import swin
from swin_v2_weather_torch.models.wrappers import get_model
from swin_v2_weather_torch.ops import ln_kernels

from test_torch_cpb import cpb_grad_errors
from test_torch_kernels import assert_close_ulps
from test_torch_model import (assert_rel_close, leaf_rel_errors, micro_configs, micro_models,
                              noise_params)
from test_torch_multistep import jax_forward_and_grads, port_forward_and_grads, rollout_inputs

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32_FWD, FP32_GRAD = (5e-3, 1e-4), (2e-2, 1e-2)


@contextlib.contextmanager
def switches(**values):
    """Set module globals of both model modules (MLP_IMPL, LNADD_IMPL, LN_IMPL,
    CPB_UNIQUE, _CPB_UNIQUE_ENV) for the duration."""
    with contextlib.ExitStack() as stack:
        for name, value in values.items():
            stack.enter_context(mock.patch.object(jax_swin, name, value))
            stack.enter_context(mock.patch.object(swin, name, value))
        yield


def model_against_jax(over, seed=1):
    """The port's micro model after holding it to JAX's in fp32, no
    drop-path, under the switches already set: the forward and every
    gradient (with the CPB, meta_mlp/fc2/bias, exactly 0, in absolute terms
    as tests/test_torch_cpb.py holds it)."""
    jm, tree, tm = micro_models("float32", seed=seed, drop_path_rate=0.0, scan_blocks=False,
                                **over)
    jp, _ = micro_configs("float32", **over)
    x, _, ct = rollout_inputs(jp, 0)
    ref, ref_grads = jax_forward_and_grads(jm, tree, x, None, ct)
    out, grads = port_forward_and_grads(tm, x, None, ct)
    assert_rel_close(out, ref, *FP32_FWD)
    errs = (cpb_grad_errors(grads, ref_grads, zero_tol=1e-5) if over.get("rel_pos")
            else leaf_rel_errors(grads, ref_grads))
    assert max(e[0] for e in errs.values()) <= FP32_GRAD[0], errs
    assert max(e[1] for e in errs.values()) <= FP32_GRAD[1], errs
    return tm


def counting(module, name):
    """Patch module.name with a wrapper that counts its calls."""
    real = getattr(module, name)
    calls = []
    patch = mock.patch.object(module, name, side_effect=lambda *a, **k: calls.append(1)
                              or real(*a, **k))
    return patch, calls


# --------------------------------------------------------------------------
# SWIN_MLP_IMPL
# --------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["fused2", "plain"])
def test_mlp_switch_matches_jax(impl):
    """With no ``mlp_impl`` key the single-step micro model takes the route
    ``MLP_IMPL`` names in both packages: the port's blocks run the whole-MLP
    entry point (fused2) or neither kernel entry point (plain), and the model
    matches JAX's on the same switch, forward and every gradient."""
    fc1_patch, fc1_calls = counting(swin, "fused_fc1_gelu")
    mlp_patch, mlp_calls = counting(swin, "fused_mlp")
    with switches(MLP_IMPL=impl), fc1_patch, mlp_patch:
        tm = model_against_jax({})
        assert all(blk.mlp.impl is None and blk.mlp.route() == impl for blk in tm.model.blocks)
    depth = len(tm.model.blocks)
    assert (len(fc1_calls), len(mlp_calls)) == ((0, depth) if impl == "fused2" else (0, 0))


def test_mlp_switch_gating_follows_the_jax_factory():
    """A config key wins over the switch; multi-step and deeper-than-12
    configs still take 'fused2' whatever the switch, and a single-step
    config None (the switch decides when the module runs); 'fused2' with an
    fc1 dropout rate falls back to 'fused' for that module."""
    with switches(MLP_IMPL="plain"):
        _, tp = micro_configs()
        assert swin.build_swin_from_params(tp).blocks[0].mlp.route() == "plain"
        _, tp = micro_configs(mlp_impl="fused")
        assert swin.build_swin_from_params(tp).blocks[0].mlp.route() == "fused"
        _, tp = micro_configs(n_future=1)
        assert swin.build_swin_from_params(tp).blocks[0].mlp.impl == "fused2"
        _, tp = micro_configs(depth=13)
        assert swin.build_swin_from_params(tp).blocks[0].mlp.impl == "fused2"
    with switches(MLP_IMPL="fused2"):
        assert swin.Mlp(8, 32, 8, torch.float32, drop=(0.1, 0.1)).route() == "fused"
        assert swin.Mlp(8, 32, 8, torch.float32).route() == "fused2"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_mlp_matches_jax(dtype):
    """The 'plain' Mlp (fc1 as a Dense, exact GELU in fp32, fc2 as a Dense)
    against JAX's plain Mlp on [2, 6, 8, 64] tokens, hidden 256. fp32 within
    1e-5 of the output scale (the products' fp32 sums in another order). In
    bf16 JAX evaluates the GELU in the compute dtype, the port in fp32
    rounded once, so activations' last bits differ before fc2: measured 1
    ulp of the output scale at most, 0.075 ulp on average, against 0.16 ulp
    for either package from the fp32 MLP on the same bf16 input; bounds 2
    and 0.15 ulps, and the port no farther from the fp32 MLP than 1.5 times
    JAX."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jmlp = jax_swin.Mlp(64, 256, 64, dtype=jdt, impl="plain")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 8, 64)).astype(np.float32)
    shapes = jax.eval_shape(jmlp.init, jax.random.key(0), jnp.zeros(x.shape, jnp.float32))
    tree = noise_params(shapes["params"], rng)
    ref = np.asarray(jax.jit(jmlp.apply)({"params": tree}, jnp.asarray(x, jdt)), np.float32)
    mlp = swin.Mlp(64, 256, 64, tdt, impl="plain")
    with torch.no_grad():
        for name in ("fc1", "fc2"):
            layer = getattr(mlp, name)
            layer.weight.copy_(torch.from_numpy(np.asarray(tree[name]["kernel"]).T.copy()))
            layer.bias.copy_(torch.from_numpy(np.asarray(tree[name]["bias"])))
        out = mlp(torch.from_numpy(x).to(tdt)).float().numpy()
    if dtype == "float32":
        assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
        return
    assert_close_ulps(out, ref, 2, 0.15)
    mlp32 = swin.Mlp(64, 256, 64, torch.float32, impl="plain")
    mlp32.load_state_dict(mlp.state_dict())
    with torch.no_grad():
        out32 = mlp32(torch.from_numpy(x).to(tdt).float()).numpy()
    assert np.abs(out - out32).mean() <= 1.5 * np.abs(ref - out32).mean()


# --------------------------------------------------------------------------
# SWIN_LNADD_IMPL, SWIN_LN_IMPL, SWIN_CPB_UNIQUE
# --------------------------------------------------------------------------


def test_lnadd_switch_matches_jax():
    """``LNADD_IMPL = 'fused'`` with no ``lnadd_impl`` key: at embed 128 both
    post-norm branches of every block run the fused op and the model matches
    JAX's fused route; at embed 64 (``ln_kernels.supported`` says no) the
    blocks fall back to the unfused branch, as JAX's ``_ln_branch`` does."""
    patch, calls = counting(ln_kernels, "fused_ln_droppath_add")
    with switches(LNADD_IMPL="fused"), patch:
        tm = model_against_jax(dict(embed_dim=128))
        assert all(blk.lnadd_impl is None for blk in tm.model.blocks)
        assert len(calls) == 2 * len(tm.model.blocks)
        del calls[:]
        model_against_jax({})
        assert not calls


def test_ln_impl_switch_matches_jax():
    """``LN_IMPL = 'onepass'``: the LayerNorm statistics as var = max(E[x^2]
    - E[x]^2, 0) in both packages; the module against JAX's Fp32LayerNorm in
    fp32 (inputs with a mean far from 0, where the two forms part), and the
    micro model against JAX's."""
    rng = np.random.default_rng(4)
    x = (3.0 + rng.standard_normal((64, 96))).astype(np.float32)
    jln = jax_swin.Fp32LayerNorm()
    tree = noise_params(jax.eval_shape(jln.init, jax.random.key(0), jnp.zeros(x.shape))["params"],
                        rng)
    norm = swin.Fp32LayerNorm(96)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(np.asarray(tree["scale"])))
        norm.bias.copy_(torch.from_numpy(np.asarray(tree["bias"])))
    outs = {}
    for impl in ("twopass", "onepass"):
        with switches(LN_IMPL=impl):
            ref = np.asarray(jax.jit(jln.apply)({"params": tree}, jnp.asarray(x)))
            with torch.no_grad():
                outs[impl] = norm(torch.from_numpy(x)).numpy()
        assert np.abs(outs[impl] - ref).max() <= 1e-5 * np.abs(ref).max(), impl
    assert not np.array_equal(outs["twopass"], outs["onepass"])
    with switches(LN_IMPL="onepass"):
        model_against_jax({})


def test_cpb_unique_switch_matches_jax():
    """An explicitly set ``SWIN_CPB_UNIQUE=0`` wins over the config's
    ``cpb_unique: True``: the meta-MLP runs on every pair (64 rows at the
    micro window, not the 21 distinct deltas) in both packages, and the CPB
    micro model matches JAX's; unset, the config key decides."""
    over = dict(rel_pos=True, cpb_unique=True)
    with switches(_CPB_UNIQUE_ENV="0", CPB_UNIQUE=False):
        tm = model_against_jax(over)
        assert all(blk.attn.cpb_rows == 64 for blk in tm.model.blocks)
        assert tm.model.drop_noise(1, torch.Generator(), "cpu")["cpb"].shape[1] == 64
    assert all(blk.attn.cpb_rows == 21 for blk in tm.model.blocks)


# --------------------------------------------------------------------------
# invalid values
# --------------------------------------------------------------------------


@pytest.mark.parametrize("var", ["SWIN_MLP_IMPL", "SWIN_LNADD_IMPL", "SWIN_LN_IMPL"])
def test_invalid_switch_value_raises(var):
    """An invalid value makes the port's model module raise a ValueError at
    import, as the JAX module does (a typo must not pick a route)."""
    env = dict(os.environ, **{var: "bogus"}, PYTHONPATH=REPO)
    run = subprocess.run([sys.executable, "-c", "import swin_v2_weather_torch.models.swin"],
                         env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert run.returncode != 0
    assert "ValueError" in run.stderr and var in run.stderr
    ok = subprocess.run([sys.executable, "-c", "import swin_v2_weather_torch.models.swin"],
                        env=dict(env, **{var: {"SWIN_MLP_IMPL": "plain",
                                               "SWIN_LNADD_IMPL": "fused",
                                               "SWIN_LN_IMPL": "onepass"}[var]}),
                        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert ok.returncode == 0, ok.stderr


def test_plain_config_key_builds():
    """``mlp_impl: plain`` in the config builds (it raised before the route was
    ported) and every block takes the plain route whatever the switch."""
    _, tp = micro_configs(mlp_impl="plain")
    with switches(MLP_IMPL="fused2"):
        model = get_model(tp, device="cpu")
        assert all(blk.mlp.route() == "plain" for blk in model.model.blocks)
