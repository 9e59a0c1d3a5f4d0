"""PyTorch port, the LAMB optimizer (``optimizer_type: lamb`` / ``FusedLAMB``):
``training/optim.Lamb`` against optax's ``chain(clip_by_global_norm,
lamb)``, the JAX package's ``build_optimizer`` on the micro model's
parameter tree, and a resumed Trainer run bit-equal to an uninterrupted one.

Tolerance: both sides compute the same fp32 formulas; only the order of the
norms' sums and the bias corrections' rounding differ, so 5 steps agree to
a few fp32 ulps: |port - optax| <= 1e-6 max|param| per leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from swin_v2_weather_tpu.config.yparams import YParams as JaxYParams
from swin_v2_weather_tpu.training import optim as jax_optim
from swin_v2_weather_torch.config.yparams import YParams, default_config_path
from swin_v2_weather_torch.data.preprocess import derived_channel_counts
from swin_v2_weather_torch.models.convert import params_to_jax
from swin_v2_weather_torch.models.wrappers import get_model
from swin_v2_weather_torch.training.optim import Lamb, build_optimizer, set_learning_rate

from test_torch_trainer import TriggerAfter, logs, micro_yparams, run_trainer, state_equal
from test_torch_trainer import MICRO, Trainer, init_parameters

torch.set_num_threads(1)

RTOL = 1e-6


def leaves_close(port, ref):
    for got, want in zip(port, ref):
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-30)
        assert np.abs(got - want).max() <= RTOL * scale, (np.abs(got - want).max(), scale)


@pytest.mark.parametrize("max_norm", [1.0, 1e4], ids=["clipped", "unclipped"])
def test_lamb_matches_optax(max_norm):
    """5 steps on leaves of several shapes, one of them all zeros (the trust
    ratio's zero-norm branch: it must move by the Adam update alone) and one
    that gets an all-zero gradient; the learning rate set from the host
    between steps, as the Trainer does each epoch."""
    rng = np.random.default_rng(0)
    shapes = [(16, 8), (8,), (3, 5, 2), (7,)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    init[1][:] = 0.0
    grads = [[3.0 * rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(5)]
    for g in grads:
        g[3][:] = 0.0
    lrs = [1e-2, 1e-2, 5e-3, 5e-3, 1e-3]

    opt = optax.inject_hyperparams(lambda learning_rate: optax.chain(
        optax.clip_by_global_norm(max_norm), optax.lamb(learning_rate)))(learning_rate=lrs[0])
    jparams = [jnp.asarray(p) for p in init]
    state = opt.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    lamb = Lamb(tparams, lr=lrs[0], max_grad_norm=max_norm)
    norms = []
    for lr, gs in zip(lrs, grads):
        state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        updates, state = opt.update([jnp.asarray(g) for g in gs], state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        set_learning_rate(lamb, lr)
        for p, g in zip(tparams, gs):
            p.grad = torch.from_numpy(g)
        lamb.step()
        norms.append(float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in gs))))
    assert (max(norms) > max_norm) == (max_norm == 1.0)  # the clip really bites, or not
    leaves_close([p.detach().numpy() for p in tparams], jparams)
    assert np.abs(tparams[1].detach().numpy()).max() > 0  # the zero leaf moved
    for st, (mu, nu) in zip((lamb.state[p] for p in tparams),
                            zip(state.inner_state[1][0].mu, state.inner_state[1][0].nu)):
        assert st["step"] == 5
        leaves_close([st["exp_avg"].numpy(), st["exp_avg_sq"].numpy()], [mu, nu])


def micro_params_pair(**over):
    out = []
    for cls in (JaxYParams, YParams):
        p = cls(default_config_path(), MICRO)
        p["attn_impl"] = "pallas_qkv"
        for k, v in over.items():
            p[k] = v
        p["n_in_channels"], p["n_out_channels"] = derived_channel_counts(p)
        out.append(p)
    return out


@pytest.mark.parametrize("opt_type, max_grad_norm", [("lamb", None), ("FusedLAMB", 0.5)])
def test_build_optimizer_matches_jax_on_the_model(opt_type, max_grad_norm):
    """``build_optimizer`` of both packages on the micro model's freshly
    initialized parameters (the Trainer's initialization; LayerNorm scales
    0: zero-norm leaves) with
    seeded gradients, 3 steps: every leaf within the bound; each port
    parameter tensor is one JAX leaf, so the trust ratios are JAX's."""
    over = {"optimizer_type": opt_type}
    if max_grad_norm is not None:
        over["max_grad_norm"] = max_grad_norm
    jp, tp = micro_params_pair(**over)
    model = get_model(tp, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(0))
    # copies: a JAX array made from a numpy view could alias a torch parameter
    tree = jax.tree.map(np.array, params_to_jax({n: p.detach().clone() for n, p in
                                                 model.named_parameters()}))
    opt = build_optimizer(tp, model.parameters())
    assert isinstance(opt, Lamb) and opt.max_grad_norm == (max_grad_norm or 5.0)
    jopt = jax_optim.build_optimizer(jp)
    jparams = jax.tree.map(jnp.asarray, tree)
    state = jopt.init(jparams)
    names = [n for n, _ in model.named_parameters()]
    assert any(not np.abs(leaf).max() for leaf in jax.tree.leaves(tree))  # LayerNorm scales 0
    rng = np.random.default_rng(1)
    for _ in range(3):
        grads = {n: (0.05 * rng.standard_normal(p.shape)).astype(np.float32)
                 for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        opt.step()
        jgrads = jax.tree.map(jnp.asarray, params_to_jax({n: torch.from_numpy(g)
                                                          for n, g in grads.items()}))
        updates, state = jopt.update(jgrads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    got = params_to_jax({n: p.detach() for n, p in model.named_parameters()})
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    ref = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat) == len(ref) == len(names)
    leaves_close([np.asarray(flat[path]) for path, _ in ref], [leaf for _, leaf in ref])


def test_lamb_preempted_run_resumes_bit_exact(tmp_path):
    """The Trainer with LAMB and the blocks rematted ('mlp3'), preempted at
    step 2 of epoch 0, resumed and finished: every parameter and LAMB's
    state (step counts and both moments) bit-equal to an uninterrupted
    run's; the loss falls."""
    over = dict(max_epochs=2, n_synthetic_samples=6, drop_path_rate=0.3, optimizer_type="lamb",
                activation_ckpt=True, remat_policy="mlp3", attn_impl="pallas_qkv")
    ta = run_trainer(tmp_path / "a", run="full", **over)
    assert isinstance(ta.optimizer, Lamb) and ta.model.model.remat_policy == "mlp3"
    lines = logs(tmp_path / "a", run="full")
    assert lines[1]["loss"] < lines[0]["loss"]

    tb = Trainer(micro_yparams(tmp_path / "b", **over), MICRO, run_num="full", device="cpu")
    tb.preempt = TriggerAfter(2)
    tb.build_and_launch()
    assert tb._preempted_at == 2
    tc = Trainer(micro_yparams(tmp_path / "b", **over), MICRO, run_num="full", device="cpu")
    tc.build()
    assert tc.resume_step_in_epoch == 2 and tc.host_step == 2
    tc.train()
    assert tc.host_step == ta.host_step == 6
    state_equal(tc.model.state_dict(), ta.model.state_dict())
    state_equal(tc.optimizer.state_dict(), ta.optimizer.state_dict())
