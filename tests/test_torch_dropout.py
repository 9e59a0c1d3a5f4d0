"""PyTorch port, train-mode dropout at JAX's ``nn.Dropout`` sites (after the
output projection, after the GELU and after fc2 at ``proj_drop_rate``, on
the fp32 softmax at ``attn_drop_rate``).

* JAX parity: JAX's masks are read off its forward (``flax.linen.
  intercept_methods``: a site's mask is where its output is 0) and handed
  to the port as explicit keep masks; the forward and every parameter
  gradient are then held to JAX's in fp32 on each attention route, with
  and without the CPB (its meta-MLP dropout's mask too).
* JAX's route gate: under attention dropout in train mode no K1, K7, K8 or
  K9 entry point runs (their plain versions stand for the kernels on the
  CPU); eval mode calls them; ``fused2`` falls back to ``fused`` under an
  fc1 rate.
* The masks the port draws itself: the kept share, rate 0 and rate 1, the
  same seed bit-equal, every remat policy bit-equal to no remat, a data
  shard's masks the global batch's rows.

(The fp32 parity bar on the plain route is
tests/test_torch_model.py::test_tiny_xla_fp32_parity_bar.)
"""

import contextlib
import functools
from unittest import mock

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swin_v2_weather_tpu.models.wrappers import get_model as jax_get_model
from swin_v2_weather_torch.models import swin
from swin_v2_weather_torch.models.convert import params_from_jax, params_to_jax
from swin_v2_weather_torch.models.wrappers import get_model
from swin_v2_weather_torch.ops import mlp_kernels as mk
from swin_v2_weather_torch.ops import window_attention as wa

from test_torch_cpb import cpb_grad_errors
from test_torch_model import leaf_rel_errors, micro_configs, noise_params

torch.set_num_threads(1)

CPB = {"rel_pos": True, "full_pos_embed": False}
PROJ = 0.1  # the projection and MLP dropout rate where a test names no other


@contextlib.contextmanager
def rates(proj: float, attn: float):
    """``get_model`` builds the port's core with these dropout rates (only
    direct construction sets them, as in JAX)."""
    with mock.patch.object(swin, "SwinTransformerV2", functools.partial(
            swin.SwinTransformerV2, proj_drop_rate=proj, attn_drop_rate=attn)):
        yield


def jax_model(route, attn_rate, cpb):
    """(JAX params, port params, the JAX micro model with proj dropout 0.1
    and attention dropout ``attn_rate``): fp32, unrolled blocks, drop-path
    0."""
    over = dict(attn_impl=route, drop_path_rate=0.0, scan_blocks=False, **(CPB if cpb else {}))
    jp, tp = micro_configs("float32", **over)
    jm = jax_get_model(jp)
    return jp, tp, jm.clone(model=jm.model.clone(proj_drop_rate=PROJ, attn_drop_rate=attn_rate))


def jax_train_masks(jm, tree, x, ct, key):
    """JAX's train-mode output, every parameter gradient of sum(out * ct), and
    the zeros of every ``nn.Dropout`` output by module path in call order (a
    dropped element is an exact 0), read by an interceptor while the jitted
    gradient traces and returned as its auxiliary outputs."""
    paths = []

    def loss(params):
        zeros = []

        def interceptor(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
                paths.append(context.module.path)
                zeros.append(out == 0)
            return out

        with nn.intercept_methods(interceptor):
            out = jm.apply({"params": params}, jnp.asarray(x), train=True,
                           rngs={"dropout": key})
        return jnp.sum(out * ct), (out, zeros)

    grads, (out, zeros) = jax.jit(jax.grad(loss, has_aux=True))(tree)
    return np.asarray(out), grads, list(zip(paths, (np.asarray(z) for z in zeros)))


def port_noise(records, depth):
    """The port's noise dict from JAX's masks: per block a dict of keep masks
    by site, and the CPB's dropped units as uniforms (0 keeps, 0.99 drops;
    a ReLU zero counts as dropped, which changes nothing). A module's sites
    come in JAX's call order: the softmax before the projection, fc1 before
    fc2; with one site, the projection or fc2."""
    found = [{} for _ in range(depth)]
    cpb = [None] * depth
    for path, zero in records:
        i = int(path[1][len("block"):])
        if path[-2] == "meta_mlp":
            cpb[i] = torch.from_numpy(np.where(zero, 0.99, 0.0).astype(np.float32))
        else:
            found[i].setdefault(path[-2], []).append(torch.from_numpy(~zero))
    drop = []
    for sites in found:
        attn, mlp = sites["attn"], sites["mlp"]
        keep = dict(zip(("attn", "proj")[2 - len(attn):], attn))
        keep.update(zip(("fc1", "fc2")[2 - len(mlp):], mlp))
        drop.append(keep)
    noise = {"dropout": drop}
    if cpb[0] is not None:
        noise["cpb"] = torch.stack(cpb)
    return noise


# (route, CPB, attention rate): without the CPB the kernel routes keep their
# kernels (attention rate 0: the projection and MLP sites only); with it every
# route takes JAX's gate to the plain attention (rate 0.1, all four sites)
PARITY_CASES = [("xla", False, 0.1), ("xla", True, 0.1), ("pallas_qkv", False, 0.0),
                ("pallas_qkv", True, 0.1), ("pallas", False, 0.0), ("pallas", True, 0.1),
                ("pallas_v1", False, 0.0), ("pallas_v1", True, 0.1)]


@pytest.mark.parametrize("route, cpb, attn_rate", PARITY_CASES)
def test_dropout_matches_jax_with_its_masks(route, cpb, attn_rate):
    """JAX's masks in the port: forward and every parameter gradient in fp32.

    Bounds relative to the output (or gradient leaf) scale. With a kernel on
    the path (K1/K2, K8, K9's plain versions; bf16 inside them) those of the
    fp32 model tests (tests/test_torch_model.py): forward max 5e-3 / mean
    1e-4, gradients 2e-2 / 1e-2 per leaf (measured at most 1.1e-3 / 1.2e-5
    and 6.4e-3 / 5.1e-3). On the plain fp32 attention (``xla``, and every
    route under attention dropout): 2e-5 / 1e-6 and 2e-5 / 1e-5 (measured
    7.4e-7 / 8.8e-8 and 1.3e-6 / 8.4e-7); ``meta_mlp/fc2/bias``, whose exact
    gradient is 0, is held to 1e-5 of its kernel's (cpb_grad_errors)."""
    jp, tp, jm = jax_model(route, attn_rate, cpb)
    x0 = jnp.zeros((1, int(jp["n_in_channels"]), *jp.img_size), jnp.float32)
    tree = noise_params(jax.eval_shape(jm.init, jax.random.key(0), x0)["params"],
                        np.random.default_rng(0))
    with rates(PROJ, attn_rate):
        tm = get_model(tp, device="cpu")
    tm.load_state_dict(params_from_jax(tree))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, int(jp["n_in_channels"]), *jp.img_size)).astype(np.float32)
    ct = rng.standard_normal((2, int(jp["n_out_channels"]), *jp.img_size)).astype(np.float32)
    ref, ref_grads, records = jax_train_masks(jm, tree, x, ct, jax.random.key(7))
    sites = 4 if attn_rate else 3
    assert len(records) == len(tm.model.blocks) * (sites + cpb)
    noise = port_noise(records, len(tm.model.blocks))
    assert all(len(d) == sites for d in noise["dropout"])
    out = tm.model(torch.from_numpy(x), train=True, noise=noise)
    torch.sum(out * torch.from_numpy(ct)).backward()
    got = params_to_jax({n: p.grad for n, p in tm.named_parameters()})

    kernel = attn_rate == 0.0 and route != "xla"
    scale = np.abs(ref).max()
    diff = np.abs(out.detach().numpy() - ref)
    fwd, grad = ((5e-3, 1e-4), (2e-2, 1e-2)) if kernel else ((2e-5, 1e-6), (2e-5, 1e-5))
    assert diff.max() <= fwd[0] * scale and diff.mean() <= fwd[1] * scale, (diff.max(), scale)
    # the masks act: the eval output is far from the train output
    with torch.no_grad():
        assert np.abs(tm.model(torch.from_numpy(x)).numpy() - ref).max() > 0.1 * scale
    errs = cpb_grad_errors(got, ref_grads, 1e-5) if cpb else leaf_rel_errors(got, ref_grads)
    assert max(e[0] for e in errs.values()) <= grad[0], errs
    assert max(e[1] for e in errs.values()) <= grad[1], errs


# --------------------------------------------------------------------------
# JAX's route gate and the MLP fallback, counted on the plain versions
# --------------------------------------------------------------------------

# the forward functions whose calls stand for kernel launches on the CPU
# (K8's and K9's bias-free plain versions are their BIAS ones without a bias)
COUNTED = {"k1": (wa, "window_attention_qkv_reference"),
           "k7": (wa, "window_attention_qkv_bias_reference"),
           "k8": (wa, "window_attention_grid_bias_reference"),
           "k9": (wa, "window_attention_v1_bias_reference"),
           "k3": (mk, "fc1_gelu_reference"), "k5": (mk, "mlp_fwd_reference")}


def micro_port(proj=PROJ, attn=0.0, policy=None, seed=1, **over):
    """The port's micro model (fp32, drop-path 0.25) with these dropout rates
    and every parameter from numpy noise, and its params."""
    over = dict(dict(drop_path_rate=0.25), **over)
    _, p = micro_configs("float32", activation_ckpt=policy is not None, remat_policy=policy,
                         **over)
    with rates(proj, attn):
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


def inputs(p, n_future=0, batch=2, seed=3):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(
        (batch, int(p["n_in_channels"]), *p.img_size)).astype(np.float32))
    zen = torch.from_numpy(rng.uniform(-1, 1, (batch, n_future + 1, *p.img_size))
                           .astype(np.float32))
    return x, zen


def run_counted(model, p, train=True, n_future=0, gen_seed=5, batch=2):
    """(output, {param: grad}, {kernel: forward calls}) of one forward (and in
    train mode the backward of sum(out^2)) on seeded inputs."""
    x, zen = inputs(p, n_future, batch)
    calls = {}
    with contextlib.ExitStack() as stack:
        for key, (module, name) in COUNTED.items():
            def counting(*a, _f=getattr(module, name), _k=key, **k):
                calls[_k] = calls.get(_k, 0) + 1
                return _f(*a, **k)
            stack.enter_context(mock.patch.object(module, name, counting))
        if not train:
            with torch.no_grad():
                return model(x, zen), {}, calls
        out = model(x, zen, train=True, generator=torch.Generator().manual_seed(gen_seed))
        torch.sum(out * out).backward()
    return out.detach(), {n: q.grad for n, q in model.named_parameters()}, calls


KERNEL = {"pallas_qkv": "k1", "pallas": "k8", "pallas_v1": "k9"}


@pytest.mark.parametrize("cpb", [False, True])
@pytest.mark.parametrize("route", ["pallas_qkv", "pallas", "pallas_v1"])
def test_attention_dropout_leaves_the_kernels(route, cpb):
    """Train mode under attention dropout calls no K1, K7, K8 or K9 entry
    point (JAX's ``use_grid`` and ``pallas``/``pallas_v1`` gates) and gives
    the ``'xla'`` route's output and gradients bit for bit (the window
    partition, the qkv Dense and the plain attention on the raw CPB bias);
    eval mode, and train mode with the projection's dropout alone, run the
    route's kernel."""
    over = dict(attn_impl=route, **(CPB if cpb else {}))
    name = "k7" if cpb and route == "pallas_qkv" else KERNEL[route]
    attention = ("k1", "k7", "k8", "k9")
    model, p = micro_port(attn=0.1, **over)
    out, grads, calls = run_counted(model, p)
    assert not any(calls.get(k) for k in attention), calls
    assert calls["k3"] == len(model.model.blocks)
    ref_model, _ = micro_port(attn=0.1, **dict(over, attn_impl="xla"))
    ref, ref_grads, _ = run_counted(ref_model, p)
    assert torch.equal(out, ref)
    for n, g in ref_grads.items():
        assert torch.equal(grads[n], g), n
    _, _, calls = run_counted(model, p, train=False)
    assert calls[name] == len(model.model.blocks)
    _, _, calls = run_counted(micro_port(attn=0.0, **over)[0], p)
    assert calls[name] == len(model.model.blocks)


def test_fc1_dropout_falls_back_from_fused2():
    """``fused2`` with an fc1 rate takes ``fused`` (K3 and fc2, the fc1 mask
    between them), as JAX's ``Mlp`` does, in eval mode too (JAX's condition
    reads the rate, not the mode); an fc2 rate alone keeps the whole-MLP
    kernel, and so does rate 0."""
    mlp = swin.Mlp(8, 32, 8, torch.float32, impl="fused2", drop=(PROJ, PROJ))
    assert mlp.route() == "fused"
    assert swin.Mlp(8, 32, 8, torch.float32, impl="fused2", drop=(0.0, PROJ)).route() == "fused2"
    model, p = micro_port(mlp_impl="fused2")
    depth = len(model.model.blocks)
    _, _, calls = run_counted(model, p)
    assert calls.get("k5", 0) == 0 and calls["k3"] == depth
    _, _, calls = run_counted(model, p, train=False)
    assert calls.get("k5", 0) == 0 and calls["k3"] == depth
    _, _, calls = run_counted(micro_port(proj=0.0, mlp_impl="fused2")[0], p)
    assert calls["k5"] == depth and calls.get("k3", 0) == 0


# --------------------------------------------------------------------------
# the masks the port draws
# --------------------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_share_and_per_sample_seeds(rate):
    """keep_mask keeps each element with probability 1 - rate (within 5
    sigma over 2 x 300,000 elements); a sample's rows depend on its seed
    alone."""
    seeds = torch.tensor([11, 12])
    keep = swin.keep_mask((2 * 3, 100, 1000), rate, seeds, "cpu")
    assert keep.dtype == torch.bool and keep.shape == (6, 100, 1000)
    n = keep[:3].numel()
    sigma = np.sqrt(rate * (1 - rate) / n)
    for half in (keep[:3], keep[3:]):
        assert abs(half.float().mean().item() - (1 - rate)) <= 5 * sigma
    assert torch.equal(swin.keep_mask((3, 100, 1000), rate, seeds[1:], "cpu"), keep[3:])
    assert not torch.equal(keep[:3], keep[3:])


def test_dropout_function_has_flax_semantics():
    """Rate 0 and eval mode return x itself, rate 1 zeros, and otherwise
    where(keep, x / keep_prob, 0) with the division in x's dtype."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((64, 64), generator=gen)
    keep = torch.rand((64, 64), generator=gen) < 0.7
    assert swin.dropout(x, 0.0, keep) is x and swin.dropout(x, 0.3, None) is x
    assert torch.equal(swin.dropout(x, 1.0, keep), torch.zeros_like(x))
    assert torch.equal(swin.dropout(x, 0.3, keep), torch.where(keep, x / 0.7, 0.0))
    xb = x.bfloat16()
    got = swin.dropout(xb, 0.3, keep)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.where(keep, xb / torch.tensor(0.7).bfloat16(), 0.0))


def test_rates_zero_and_one_in_the_model():
    """Rates 0 draw no seeds and leave train mode equal to eval mode (drop-path
    0); rate 1 on the projection and the MLP zeroes both branches: each
    block is its post-norm LayerNorms' biases added twice."""
    model, p = micro_port(proj=0.0, drop_path_rate=0.0)
    assert model.model.drop_noise(2, torch.Generator(), "cpu") is None
    x, zen = inputs(p)
    with torch.no_grad():
        assert torch.equal(model(x, zen, train=True), model(x, zen))
    model, _ = micro_port(proj=1.0, drop_path_rate=0.0)
    core = model.model
    with torch.no_grad():
        out = model(x, zen, train=True, generator=torch.Generator().manual_seed(1))
        y = core.patch_embed(x.permute(0, 2, 3, 1))
        if core.pos_embed is not None:
            y = y + core.pos_embed
        for blk in core.blocks:
            y = y + blk.norm1.bias
            y = y + blk.norm2.bias
        b, h, w = y.shape[0], *p.img_size
        ph = int(p.patch_size)
        head = swin.dense(y, core.head, torch.float32).reshape(
            b, h // ph, w // ph, ph, ph, core.out_chans).permute(0, 5, 1, 3, 2, 4)
        ref = head.reshape(b, core.out_chans, h, w) + x[:, :core.out_chans]
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("attn", [0.0, 0.1])
def test_same_seed_is_bit_equal(attn):
    """Two train-mode steps from the same generator seed give the same output
    and gradients bit for bit; another seed another output."""
    model, p = micro_port(attn=attn)
    a, ga, _ = run_counted(model, p)
    model, p = micro_port(attn=attn)
    b, gb, _ = run_counted(model, p)
    c, _, _ = run_counted(micro_port(attn=attn)[0], p, gen_seed=6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    for n, g in ga.items():
        assert torch.equal(gb[n], g), n


REMAT_VARIANTS = {"fused": {}, "plain_gated": {"mlp_impl": "plain", "attn": 0.1}}


@pytest.mark.parametrize("variant", list(REMAT_VARIANTS))
@pytest.mark.parametrize("policy", ["full", "attn", "mlp", "mlp_fc1", "mlp3"])
def test_remat_is_bit_equal_with_dropout(policy, variant):
    """Under every remat policy the recomputed stages rebuild their masks from
    the same seeds: output and every gradient bit-equal to no remat, with
    drop-path and the proj/MLP dropout live (and the attention's on the
    gated route)."""
    over = dict(REMAT_VARIANTS[variant])
    attn = over.pop("attn", 0.0)
    out0, grads0, _ = run_counted(micro_port(attn=attn, **over)[0], micro_port(**over)[1])
    model, p = micro_port(attn=attn, policy=policy, **over)
    assert model.model.remat_policy == policy
    out, grads, _ = run_counted(model, p)
    assert torch.equal(out, out0)
    for n, g in grads0.items():
        assert torch.equal(grads[n], g), n


def test_looped_rollout_recomputes_the_masks():
    """The 4-step looped wrapper: each step's model call under its own
    checkpoint, its seeds drawn before the first step, gives the output and
    gradients of the wrapper without the checkpoints bit for bit, and each
    step draws its own masks."""
    over = dict(n_future=3, mlp_impl="fused2")
    model, p = micro_port(attn=0.1, **over)
    assert model.looped and model.remat
    out, grads, _ = run_counted(model, p, n_future=3)
    ref_model, _ = micro_port(attn=0.1, **over)
    ref_model.remat = False
    ref, ref_grads, _ = run_counted(ref_model, p, n_future=3)
    assert torch.equal(out, ref)
    for n, g in ref_grads.items():
        assert torch.equal(grads[n], g), n
    noise = model.model.drop_noise(2, torch.Generator().manual_seed(5), "cpu", n_steps=4)
    assert noise["dropout"].shape == (4, len(model.model.blocks), 4, 2)
    assert noise["dropout"].dtype == torch.int64 and noise["dropout"].device.type == "cpu"
    assert len({tuple(s.flatten().tolist()) for s in noise["dropout"]}) == 4


def test_data_shard_draws_its_rows_of_the_global_masks():
    """On data shard i of n the seeds are columns [i * b, (i + 1) * b) of the
    global batch's, so the shard's forward of its samples equals the rows of
    the single-process forward of the global batch."""
    model, p = micro_port(attn=0.1)
    glob = model.model.drop_noise(2, torch.Generator().manual_seed(5), "cpu")
    x, zen = inputs(p)
    with torch.no_grad():
        ref = model(x, zen, train=True, generator=torch.Generator().manual_seed(5))
        for i in range(2):
            model.model.data_shard = (i, 2)
            shard = model.model.drop_noise(1, torch.Generator().manual_seed(5), "cpu")
            for key in ("drop_path", "dropout"):
                assert torch.equal(shard[key], glob[key][..., i:i + 1]), key
            out = model(x[i:i + 1], zen[i:i + 1], train=True,
                        generator=torch.Generator().manual_seed(5))
            assert torch.equal(out, ref[i:i + 1])


def test_train_mode_dropout_needs_its_seeds():
    """A caller's noise without the dropout seeds raises, as a missing
    generator does."""
    model, p = micro_port(drop_path_rate=0.0)
    x, _ = inputs(p)
    with pytest.raises(ValueError, match="Generator"):
        model(x, train=True)
    with pytest.raises(ValueError, match="dropout"):
        model.model(x, train=True, noise={})
