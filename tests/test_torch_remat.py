"""PyTorch port, activation checkpointing under JAX's named-save remat
policies (``activation_ckpt``, ``remat_policy``), and the single-process
sharding keys.

* The keep-sets: :func:`swin.remat_names` and each block's ``remat_keep``
  against JAX's ``_remat_policy`` (probed name by name) for every policy
  and every combination of the fused MLP, the fused LayerNorm branch and
  ``rel_pos``.
* The port against itself: on the micro model with drop-path live, every
  policy gives the output and every parameter gradient bit-equal to the
  unrematted model (same generator, so the same uniforms and masks), on
  each MLP route, the fused LayerNorm route, the CPB and each attention
  route; the kernels' forwards (their plain versions here) run again in the
  backward exactly as the policy says.
* The port against JAX's ``checkpoint_stages=True`` model (its Pallas
  kernels in interpret mode) for each policy, at tests/test_torch_model.py's
  fp32 bounds; the 2-step wrapper with remat against JAX's; the nested
  checkpoints of the looped rollout bit-equal to the unrematted rollout.
* The e2048 config as written (``shard_params: True``, ``remat_policy:
  'full'``) builds a Trainer at one process, cut to depth 2 and a small
  image; more processes still raise.
"""

import logging
from unittest import mock

import numpy as np
import pytest
import torch
from jax._src.ad_checkpoint import name_p

from swin_v2_weather_tpu.models import swin as jax_swin
from swin_v2_weather_torch.config.yparams import YParams, default_config_path
from swin_v2_weather_torch.data.pipeline import cuda_prefetch
from swin_v2_weather_torch.data.preprocess import derived_channel_counts
from swin_v2_weather_torch.models import swin
from swin_v2_weather_torch.models.wrappers import get_model
from swin_v2_weather_torch.ops import ln_kernels
from swin_v2_weather_torch.ops import mlp_kernels as mk
from swin_v2_weather_torch.ops import window_attention as wa
from swin_v2_weather_torch.training.trainer import Trainer

from test_torch_model import leaf_rel_errors, micro_configs, micro_models
from test_torch_multistep import jax_forward_and_grads, port_forward_and_grads, rollout_inputs

torch.set_num_threads(1)

MICRO = "swin_micro_test"
E2048 = "swin_73var_geo_depth24_e2048_mlp2_chweight_invar"
POLICIES = ("full", "attn", "mlp", "mlp_fc1", "mlp3", "none_such")
NAMES = ("attn_kernel_out", "attn_out", "block_mid", "mlp_fc1", "mlp_out", "cpb_bias")


def jax_keep(policy, mlp_impl, lnadd_impl, rel_pos, embed_dim=128):
    """The names JAX's ``_remat_policy`` saves, or None (recompute all)."""
    model = jax_swin.SwinTransformerV2(embed_dim=embed_dim, remat_policy=policy,
                                       mlp_impl=mlp_impl, lnadd_impl=lnadd_impl, rel_pos=rel_pos)
    pol = model._remat_policy()
    if pol is None:
        return None
    return frozenset(n for n in NAMES if pol(name_p, name=n))


@pytest.mark.parametrize("rel_pos", [False, True])
@pytest.mark.parametrize("lnadd_impl", ["xla", "fused"])
@pytest.mark.parametrize("mlp_impl", ["fused", "fused2", "plain"])
@pytest.mark.parametrize("policy", POLICIES)
def test_keep_sets_match_jax(policy, mlp_impl, lnadd_impl, rel_pos):
    want = jax_keep(policy, mlp_impl, lnadd_impl, rel_pos)
    got = swin.remat_names(policy, mlp_impl != "plain", lnadd_impl == "fused", rel_pos)
    assert got == want
    # the block reads the same conditions (width 128: the fused branch applies)
    blk = swin.SwinBlock(128, 4, (4, 8), (2, 4), (1, 2), shifted=False, mlp_impl=mlp_impl,
                         lnadd_impl=lnadd_impl, rel_pos=rel_pos, remat_policy=policy)
    assert blk.remat_keep() == (want or frozenset())


def test_keep_sets_follow_the_switches_and_the_width():
    """mlp_impl/lnadd_impl None read JAX's switches (MLP_IMPL, LNADD_IMPL);
    the fused LayerNorm drop needs a width that is a multiple of 128."""
    for width, fused_ln in ((128, True), (64, False)):
        blk = swin.SwinBlock(width, 4, (4, 8), (2, 4), (1, 2), shifted=False,
                             remat_policy="mlp")
        with mock.patch.object(swin, "MLP_IMPL", "plain"), \
                mock.patch.object(swin, "LNADD_IMPL", "fused"):
            assert blk.remat_keep() == jax_keep("mlp", "plain", "fused", False, width)
            assert ("attn_out" in blk.remat_keep()) != fused_ln
        assert blk.remat_keep() == jax_keep("mlp", None, None, False, width)


# --------------------------------------------------------------------------
# the port against itself: bit-equal gradients, the kernels' recomputes
# --------------------------------------------------------------------------

# model variants: the three MLP routes, the fused LayerNorm branch (width
# 128), the CPB and the other attention routes
VARIANTS = {
    "fused": {},
    "fused2": {"mlp_impl": "fused2"},
    "plain": {"mlp_impl": "plain"},
    "lnadd": {"lnadd_impl": "fused", "embed_dim": 128},
    "cpb": {"rel_pos": True, "full_pos_embed": False},
    "grid": {"attn_impl": "pallas"},
    "v1": {"attn_impl": "pallas_v1"},
    "xla": {"attn_impl": "xla"},
}
# the forward functions whose calls stand for kernel launches on the CPU
COUNTED = {"k1": (wa, "window_attention_qkv_reference"),
           "k7": (wa, "window_attention_qkv_bias_reference"),
           "k3": (mk, "fc1_gelu_reference"), "k5": (mk, "mlp_fwd_reference"),
           "k8": (wa, "window_attention_grid_reference"),
           "k9": (wa, "window_attention_v1_reference"),
           "k11": (ln_kernels, "ln_dp_add_fwd_reference")}


def micro_port(policy=None, seed=1, **over):
    """The port's micro model (qkv-fused route unless ``over`` says, drop-path
    0.5 so that masks drop branches) with every parameter from numpy noise,
    and its params."""
    p = YParams(default_config_path(), MICRO)
    p["attn_impl"] = "pallas_qkv"
    p["drop_path_rate"] = 0.5
    p["activation_ckpt"] = policy is not None
    p["remat_policy"] = policy
    for k, v in over.items():
        p[k] = v
    p["n_in_channels"], p["n_out_channels"] = derived_channel_counts(p)
    model = get_model(p, device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, q in model.named_parameters():
            noise = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
            if name.endswith(("norm1.weight", "norm2.weight", "norm.weight")):
                q.copy_(1.0 + 0.1 * noise)
            elif q.dim() == 2:
                q.copy_(noise / np.sqrt(q.shape[1]))
            else:
                q.copy_(0.1 * noise)
    return model, p


def run_counted(model, p, n_future=0, seed=3, train=True):
    """(output, {param: grad}, {kernel: forward calls}) of one train-mode
    forward and backward of sum(out^2) on seeded inputs."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(
        (2, int(p["n_in_channels"]), *p.img_size)).astype(np.float32))
    zen = torch.from_numpy(rng.uniform(-1, 1, (2, n_future + 1, *p.img_size)).astype(np.float32))
    calls = {}
    patches = []
    for key, (module, name) in COUNTED.items():
        def counting(*a, _f=getattr(module, name), _k=key, **k):
            calls[_k] = calls.get(_k, 0) + 1
            return _f(*a, **k)
        patches.append(mock.patch.object(module, name, counting))
    for patch in patches:
        patch.start()
    try:
        out = model(x, zen, train=train, generator=torch.Generator().manual_seed(5))
        torch.sum(out * out).backward()
    finally:
        for patch in patches:
            patch.stop()
    return out.detach(), {n: q.grad for n, q in model.named_parameters()}, calls


_REFERENCE = {}


def unrematted(variant):
    if variant not in _REFERENCE:
        model, p = micro_port(None, **VARIANTS[variant])
        _REFERENCE[variant] = run_counted(model, p)
    return _REFERENCE[variant]


def expected_calls(variant, policy, base):
    """The forward calls the design gives: without remat one per block; a
    kept ``attn_kernel_out`` on a qkv-fused route spares the unshifted
    block's attention (one kernel call, outside the checkpoints), a kept
    ``mlp_out`` on fused2 spares K5, a kept ``block_mid`` with the fused
    LayerNorm spares K11's first branch; everything else runs twice."""
    model, _ = micro_port(policy, **VARIANTS[variant])
    blocks = model.model.blocks
    keep = blocks[0].remat_keep()
    want = {}
    for key, n in base.items():
        n_blocks = len(blocks)
        if key in ("k1", "k7"):
            spared = sum(not b.do_shift for b in blocks) if "attn_kernel_out" in keep else 0
        elif key == "k5":
            spared = n_blocks if "mlp_out" in keep else 0
        elif key == "k11":
            spared = n_blocks if "block_mid" in keep else 0  # n counts both branches
        else:
            spared = 0
        want[key] = 2 * n - spared
    return want


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_is_bit_equal_to_no_remat(policy, variant):
    """Output and every gradient bit-equal to the unrematted model's under
    each policy and route, drop-path live from the same uniforms; the
    kernels' forwards run again as the policy says."""
    out0, grads0, calls0 = unrematted(variant)
    model, p = micro_port(policy, **VARIANTS[variant])
    assert model.model.remat_policy == policy
    out, grads, calls = run_counted(model, p)
    assert torch.equal(out, out0)
    for name, g in grads0.items():
        assert torch.equal(grads[name], g), name
    assert calls == expected_calls(variant, policy, calls0)
    if variant in ("fused", "lnadd"):
        assert calls0["k1"] == 2  # one a block without remat


def test_masks_are_live_and_eval_is_not_checkpointed():
    """The drop-path masks of the test above drop branches (another
    generator seed changes the output); with grad mode off nothing is
    checkpointed: one forward call a block, the same output."""
    model, p = micro_port("full")
    noise = model.model.drop_noise(2, torch.Generator().manual_seed(5), "cpu")
    keep = 1.0 - np.float32(model.model.blocks[1].drop_path_rate)
    assert bool((noise["drop_path"][1] >= keep).any())
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, int(p["n_in_channels"]), *p.img_size)).astype(np.float32))
    with mock.patch.object(swin, "checkpoint", side_effect=AssertionError("checkpointed")):
        with torch.no_grad():
            out = model(x, None)
    ref_model, _ = micro_port(None)
    with torch.no_grad():
        assert torch.equal(out, ref_model(x, None))


@pytest.mark.parametrize("n_future, policy", [(1, "mlp3"), (1, "full"), (3, "mlp3"),
                                              (3, "full")])
def test_rollout_nests_the_block_remat(n_future, policy):
    """The 2-step (unrolled) and 4-step (looped, each step under its own
    checkpoint) wrappers with the block remat inside: output and gradients
    bit-equal to the wrapper without it; at 4 steps each step's backward
    recomputes the step and then each block's unkept stages again."""
    over = dict(n_future=n_future, mlp_impl="fused2")
    out0, grads0, calls0 = run_counted(*micro_port(None, **over), n_future=n_future)
    model, p = micro_port(policy, **over)
    assert model.looped == (n_future >= 2) and model.model.remat_policy == policy
    out, grads, calls = run_counted(model, p, n_future=n_future)
    assert torch.equal(out, out0)
    for name, g in grads0.items():
        assert torch.equal(grads[name], g), name
    steps, depth = n_future + 1, len(model.model.blocks)
    inner = {"mlp3": depth // 2, "full": depth}[policy]  # K1 recomputes a step
    assert calls["k1"] == calls0["k1"] + steps * inner
    assert calls["k5"] == calls0["k5"] + (steps * depth if policy == "full" else 0)


# --------------------------------------------------------------------------
# the port against JAX's checkpoint_stages model
# --------------------------------------------------------------------------


@pytest.mark.parametrize("policy, mlp_impl", [("full", None), ("attn", None), ("mlp", None),
                                              ("mlp_fc1", "plain"), ("mlp3", None)])
def test_remat_matches_jax(policy, mlp_impl):
    """The micro model (fp32 compute, unrolled blocks) with
    ``activation_ckpt: True`` under each policy (``mlp_fc1`` on the plain MLP,
    where its site exists) against JAX's ``checkpoint_stages=True`` model on
    the same weights: output and every parameter gradient of sum(out * ct)
    within tests/test_torch_model.py's fp32 bounds (forward max 5e-3 / mean
    1e-4 of the output scale; gradients 2e-2 / 1e-2 per leaf)."""
    over = dict(drop_path_rate=0.0, scan_blocks=False, activation_ckpt=True,
                remat_policy=policy)
    if mlp_impl:
        over["mlp_impl"] = mlp_impl
    jm, tree, tm = micro_models("float32", seed=1, **over)
    assert jm.model.checkpoint_stages and tm.model.remat_policy == policy
    jp, _ = micro_configs("float32", **over)
    x, _, ct = rollout_inputs(jp, 0)
    ref_out, ref_grads = jax_forward_and_grads(jm, tree, x, None, ct)
    out, grads = port_forward_and_grads(tm, x, None, ct)
    scale = np.abs(ref_out).max()
    assert np.abs(out - ref_out).max() <= 5e-3 * scale
    assert np.abs(out - ref_out).mean() <= 1e-4 * scale
    errs = leaf_rel_errors(grads, ref_grads)
    assert max(e[0] for e in errs.values()) <= 2e-2, errs
    assert max(e[1] for e in errs.values()) <= 1e-2, errs


def test_two_step_remat_matches_jax():
    """The 2-step fine-tune's wrapper (unrolled, whole-MLP route) with the
    blocks rematted under 'mlp3' against JAX's, fp32: output and gradients
    within the fp32 bounds above."""
    over = dict(n_future=1, drop_path_rate=0.0, scan_blocks=False, activation_ckpt=True,
                remat_policy="mlp3")
    jm, tree, tm = micro_models("float32", seed=1, **over)
    assert tm.model.remat_policy == "mlp3" and not tm.looped
    jp, _ = micro_configs("float32", **over)
    x, zen, ct = rollout_inputs(jp, 1)
    ref_out, ref_grads = jax_forward_and_grads(jm, tree, x, zen, ct)
    out, grads = port_forward_and_grads(tm, x, zen, ct)
    scale = np.abs(ref_out).max()
    assert np.abs(out - ref_out).max() <= 5e-3 * scale
    errs = leaf_rel_errors(grads, ref_grads)
    assert max(e[0] for e in errs.values()) <= 2e-2, errs
    assert max(e[1] for e in errs.values()) <= 1e-2, errs


# --------------------------------------------------------------------------
# the e2048 config and the sharding keys at one process
# --------------------------------------------------------------------------


def e2048_yparams(root):
    """The e2048 config as written, cut to depth 2 and the image [72, 144]
    (window 9 x 18 with window_ratio 8, so L = 162 as at full size), on
    synthetic data; ``mlp_impl: fused2`` is what the factory picks at the
    config's depth 24 (past 12), which the cut would lose."""
    p = YParams(default_config_path(), E2048)
    p["exp_dir"] = str(root)
    p.update_params(dict(depth=2, mlp_impl="fused2", img_size=[72, 144], window_ratio=8,
                         max_epochs=1,
                         n_synthetic_samples=1, batch_size=1, num_data_workers=1,
                         data_loader_config="synthetic", log_to_screen=True))
    return p


def test_e2048_trainer_builds_at_one_process(tmp_path, caplog):
    """``shard_params: True`` is a no-op at one process (logged), and the
    model takes the config's remat: 'full' over every block, the whole-MLP
    route at embed 2048; one train step runs."""
    p = e2048_yparams(tmp_path)
    assert p["shard_params"] and p["activation_ckpt"] and p["remat_policy"] == "full"
    t = Trainer(p, E2048, run_num="t", device="cpu")
    with caplog.at_level(logging.INFO, logger="swin_v2_weather_torch.training.trainer"):
        t.build()
    assert any("shard_params: a no-op at one process" in r.getMessage() for r in caplog.records)
    core = t.model.model
    assert core.remat_policy == "full" and len(core.blocks) == 2
    assert all(b.mlp.route() == "fused2" and b.remat_keep() == frozenset() for b in core.blocks)
    assert core.blocks[0].attn.qkv.weight.shape == (3 * 2048, 2048)
    metrics = t.train_step(next(cuda_prefetch(iter(t.train_loader), t.device)))
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    t.train_loader.close()
    t.valid_loader.close()


@pytest.mark.parametrize("over", [{}, {"shard_opt_state": True}])
def test_sharding_keys_past_one_process_raise(tmp_path, monkeypatch, over):
    """Past one process the sharding keys take effect (tests/test_torch_parallel.py);
    an environment that names two processes but no rendezvous raises before
    anything is built, rather than training as one process."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    p = e2048_yparams(tmp_path)
    for k, v in over.items():
        p[k] = v
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        Trainer(p, E2048, run_num="t", device="cpu").build()
    monkeypatch.delenv("WORLD_SIZE")
