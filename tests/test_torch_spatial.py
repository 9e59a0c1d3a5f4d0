"""PyTorch port, spatial (latitude) sharding, held to the JAX package.

Counterpart of tests/test_spatial.py: the port's ``roll_h_sharded`` and its
spatially sharded model run on gloo ranks spawned by
``tests/torch_dist_worker.py`` (torch and the port only); the JAX side runs
here on its 8-device CPU mesh, and the inputs, JAX's weights (converted) and
the outputs cross as ``.npz`` files.

Unlike JAX's own test, whose ``+ 0.3`` perturbation misses the stacked
LayerNorm scales of its scanned blocks (they stay 0, so every block is the
identity), every parameter here is drawn from noise (``noise_params``), so
the attention, the halo rolls and the boundary gate all reach the output.

Tolerances, on [4, 4, 24, 48] outputs (fp32 compute), each test on JAX's
own variables (``jax_own``) and on noise (``noise``):

  * ``xla``: 2e-5 against JAX's ``spatial_forward`` (JAX's bound; with noise
    the outputs reach 9 and fp32 sums in another order move an element by
    up to 1.3e-5 of itself: 2e-5 absolute or relative); the gradients
    5e-4 / 1e-4 (atol / rtol) against the unsharded model's;
  * ``pallas`` and ``pallas_qkv``: the kernels' plain versions (q/k and the
    exponentials rounded to bf16 where the TPU kernels round them) against
    JAX's kernels in interpret mode: 5e-2 on JAX's own variables, JAX's
    bound; with every parameter drawn (outputs up to m = 13) the bf16 sites'
    rounding flips carry through four blocks (JAX's own sharded and
    unsharded models differ by up to 0.031 there; measured 7.9e-3 m max,
    1.3e-4 m mean): max 1e-2 m, mean 2e-4 m; against the port's own
    unsharded model within 1e-5 (the bands take the same windows and the
    same plain versions; only the order of some fp32 sums can differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swin_v2_weather_tpu.models.swin import SwinTransformerV2 as JaxSwin
from swin_v2_weather_tpu.parallel.mesh import make_mesh as jax_make_mesh
from swin_v2_weather_tpu.parallel.spatial import spatial_forward as jax_spatial_forward
from swin_v2_weather_torch.models.convert import params_from_jax
from swin_v2_weather_torch.models.swin import SwinTransformerV2
from swin_v2_weather_torch.parallel.spatial import roll_h_sharded
from test_torch_model import noise_params
from torch_dist_worker import launch

torch.set_num_threads(1)

# tests/test_spatial.py's CFG: window (3, 6) on a 12 x 24 token grid
CFG = dict(
    img_size=(24, 48), patch_size=2, in_chans=5, out_chans=4, embed_dim=32,
    depth=4, num_heads=2, img_window_ratio=8,
    full_pos_embed=True, rel_pos=False, residual=True,
)
ROUTES = ("xla", "pallas", "pallas_qkv")
SHIFTS = (-3, -1, 1, 2)
TOL = {"xla": 2e-5, "pallas": 5e-2, "pallas_qkv": 5e-2}


def jax_side(n_sp, routes, batch, seed=0, jax_own_perturbation=False):
    """(x, the JAX variables' tree, {route: (unsharded out, spatial_forward
    out)}) on the 8-device mesh [8 / n_sp, n_sp]."""
    mesh = jax_make_mesh(devices=jax.devices()[:8], data_parallel=8 // n_sp,
                         model_parallel=n_sp)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 5, 24, 48)).astype(np.float32)
    outs, tree = {}, None
    for route in routes:
        common = dict(dtype=jnp.float32, attn_impl=route, scan_blocks=True)
        ref, sp = JaxSwin(**CFG, **common), JaxSwin(**CFG, **common, spatial_shards=n_sp)
        if tree is None:
            if jax_own_perturbation:  # tests/test_spatial.py's variables, as they are
                v = ref.init(jax.random.key(0), jnp.asarray(x))
                tree = jax.tree_util.tree_map(lambda a: a + 0.3 if a.ndim == 1 else a,
                                              v)["params"]
            else:
                shapes = jax.eval_shape(ref.init, jax.random.key(0), jnp.asarray(x))["params"]
                tree = noise_params(shapes, np.random.default_rng(seed + 1))
        v = {"params": jax.tree.map(jnp.asarray, tree)}
        y_ref = np.asarray(jax.jit(lambda v, x: ref.apply(v, x))(v, jnp.asarray(x)))
        y_sp = np.asarray(jax_spatial_forward(sp, v, jnp.asarray(x), mesh))
        outs[route] = (y_ref, y_sp)
    return x, tree, outs


def write_inputs(path, x, tree):
    state = params_from_jax(jax.tree.map(np.asarray, tree))
    np.savez(path, x=x, **{f"w/{k}": v.numpy() for k, v in state.items()})


def port_unsharded(route, x, tree):
    model = SwinTransformerV2(**CFG, dtype=torch.float32, attn_impl=route)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, tree)))
    return model(torch.from_numpy(x))


# --------------------------------------------------------------------------
# the halo roll
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rolled(tmp_path_factory):
    return launch("roll", 2, tmp_path_factory.mktemp("roll"), timeout=90, shifts=list(SHIFTS))


@pytest.mark.parametrize("shift", SHIFTS)
def test_roll_h_sharded_matches_global_roll(rolled, shift):
    """Bit-equal to torch.roll (and np.roll) of the gathered array; its
    gradient is the opposite roll of the cotangent, bit for bit."""
    x, w = rolled[0]["x"], rolled[0]["w"]
    want = torch.roll(torch.from_numpy(x), shift, dims=1).numpy()
    np.testing.assert_array_equal(want, np.roll(x, shift, axis=1))
    for r in rolled:
        np.testing.assert_array_equal(r[f"out{shift}"], want)
        np.testing.assert_array_equal(r[f"grad{shift}"], np.roll(w, -shift, axis=1))


def test_roll_h_sharded_rejects_oversized_halo(rolled):
    assert all(int(r["oversized_raised"]) == 1 for r in rolled)


def test_roll_h_sharded_on_one_rank_is_torch_roll():
    x = torch.randn(2, 6, 4, 3)
    for shift in SHIFTS:
        assert torch.equal(roll_h_sharded(x, shift, None), torch.roll(x, shift, dims=1))
    assert roll_h_sharded(x, 0, None) is x


# --------------------------------------------------------------------------
# the spatially sharded model against JAX's spatial_forward
# --------------------------------------------------------------------------


WEIGHTS = ("jax_own", "noise")


def run_both(tmp, n_sp, routes, batch, grads=False):
    """JAX's side and the port's ranks for both weight sets: tests/test_spatial.py's
    own variables (``jax_own``) and noise on every parameter (``noise``)."""
    jax_out, inputs = {}, {}
    for tag in WEIGHTS:
        x, tree, outs = jax_side(n_sp, routes, batch, jax_own_perturbation=tag == "jax_own")
        write_inputs(tmp / f"{tag}.npz", x, tree)
        jax_out[tag], inputs[tag] = (x, tree, outs), str(tmp / f"{tag}.npz")
    ranks = launch("spatial_forward", n_sp, tmp, timeout=180, inputs=inputs, cfg=CFG,
                   attn_impls=list(routes), grads=grads)
    return jax_out, ranks


@pytest.fixture(scope="module")
def two_way(tmp_path_factory):
    """2 bands, every route, with the xla gradients."""
    return run_both(tmp_path_factory.mktemp("sp2"), 2, ROUTES, batch=4, grads=True)


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("route", ROUTES)
def test_spatial_forward_matches_jax(two_way, route, weights):
    """2 bands: the port's gathered output against JAX's spatial_forward on
    its [4, 2] mesh, every rank's the same, and against the port's own
    unsharded model. On JAX's own variables at JAX's bounds; with every
    parameter drawn the outputs reach 9 and fp32 sums taken in another
    order move an element by up to 1.3e-5 of itself, so the xla bound there
    is 2e-5 absolute or relative."""
    jax_out, ranks = two_way
    x, tree, outs = jax_out[weights]
    y_ref, y_sp = outs[route]
    got = ranks[0][f"{weights}/y/{route}"]
    assert got.shape == y_sp.shape == (4, 4, 24, 48)
    if weights == "jax_own":
        np.testing.assert_allclose(got, y_sp, atol=TOL[route], rtol=0)
    elif route == "xla":
        np.testing.assert_allclose(got, y_sp, atol=2e-5, rtol=2e-5)
    else:
        m, diff = np.abs(y_sp).max(), np.abs(got - y_sp)
        assert diff.max() <= 1e-2 * m and diff.mean() <= 2e-4 * m, (diff.max() / m,
                                                                   diff.mean() / m)
    np.testing.assert_array_equal(ranks[1][f"{weights}/y/{route}"], got)
    np.testing.assert_allclose(got, port_unsharded(route, x, tree).detach().numpy(),
                               atol=1e-5, rtol=0)


def test_spatial_gradients_match_unsharded(two_way):
    """The gradients of sum(y^2) through the halo exchange and the gathered
    output, summed over the bands, against the unsharded model's, at JAX's
    test's bounds (5e-4 / 1e-4): on JAX's own variables against JAX's
    unsharded model, with every parameter drawn (gradients up to 1e4)
    against the port's."""
    jax_out, ranks = two_way
    x, tree, _ = jax_out["jax_own"]
    ref = JaxSwin(**CFG, dtype=jnp.float32, attn_impl="xla", scan_blocks=True)
    g = jax.grad(lambda p: jnp.sum(ref.apply({"params": p}, jnp.asarray(x)) ** 2))(
        jax.tree.map(jnp.asarray, tree))
    want = {"jax_own": params_from_jax(jax.tree.map(np.asarray, g))}
    x, tree, _ = jax_out["noise"]
    model = SwinTransformerV2(**CFG, dtype=torch.float32, attn_impl="xla")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, tree)))
    (model(torch.from_numpy(x)) ** 2).sum().backward()
    want["noise"] = {n: p.grad for n, p in model.named_parameters()}
    for tag, grads in want.items():
        assert len(grads) == sum(k.startswith(f"{tag}/g/xla/") for k in ranks[0])
        for name, w in grads.items():
            np.testing.assert_allclose(ranks[0][f"{tag}/g/xla/{name}"], w.numpy(), atol=5e-4,
                                       rtol=1e-4, err_msg=f"{tag} {name}")


@pytest.fixture(scope="module")
def four_way(tmp_path_factory):
    """4 bands of one window row each (every halo crosses bands), xla."""
    return run_both(tmp_path_factory.mktemp("sp4"), 4, ("xla",), batch=2)


def test_four_way_sharding_single_window_row_per_shard(four_way):
    """On JAX's own test variables (identity blocks) the port matches JAX's
    4-way spatial_forward at 2e-5. With every parameter drawn it matches
    JAX's unsharded model (2e-5, absolute or relative, as above), while
    JAX's own 4-way spatial_forward leaves that model: JAX clamps the shift
    to the band's one window row (calc_window_shift of (gh_local, gw),
    swin_v2_weather_tpu/models/swin.py:790 with :1188), so its bands never
    roll H (ROADMAP, reference-side faults)."""
    jax_out, ranks = four_way
    _, _, outs = jax_out["jax_own"]
    np.testing.assert_allclose(ranks[0]["jax_own/y/xla"], outs["xla"][1], atol=2e-5, rtol=0)
    _, _, outs = jax_out["noise"]
    y_ref, y_sp = outs["xla"]
    np.testing.assert_allclose(ranks[0]["noise/y/xla"], y_ref, atol=2e-5, rtol=2e-5)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["noise/y/xla"], ranks[0]["noise/y/xla"])
    assert np.abs(y_sp - y_ref).max() > 1e-2  # JAX's bands lost the H shift


# --------------------------------------------------------------------------
# the model's checks, as JAX's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("over, exc, match", [
    (dict(spatial_shards=5), ValueError, "not divisible by spatial_shards"),
    (dict(spatial_shards=3), ValueError, "whole number of window rows"),
    (dict(spatial_shards=2, attn_impl="pallas_v1"), NotImplementedError, "boundary gate"),
])
def test_spatial_checks_raise_as_jax(over, exc, match):
    """Patch rows not divisible by the shards, bands of a partial window row
    and the windowed kernel raise, with JAX's messages."""
    kw = dict(CFG, dtype=torch.float32, attn_impl="xla")
    kw.update(over)
    with pytest.raises(exc, match=match):
        SwinTransformerV2(**kw)
    jkw = dict(CFG, dtype=jnp.float32, attn_impl=kw["attn_impl"])
    n_sp = over["spatial_shards"]
    x = jnp.zeros((4, 5, 24, 48))
    with pytest.raises(exc, match=match):
        if exc is ValueError:  # JAX checks the geometry before anything runs
            JaxSwin(**jkw, spatial_shards=n_sp).init(jax.random.key(0), x)
        else:  # the block raises inside the shard_map
            v = JaxSwin(**jkw).init(jax.random.key(0), x)
            mesh = jax_make_mesh(devices=jax.devices()[:8], data_parallel=4, model_parallel=2)
            jax_spatial_forward(JaxSwin(**jkw, spatial_shards=n_sp), v, x, mesh)


def test_spatial_dropout_and_missing_group_raise():
    """Elementwise dropout under spatial sharding raises in train mode with
    JAX's message; a sharded model without its model group raises."""
    model = SwinTransformerV2(**CFG, dtype=torch.float32, attn_impl="xla", spatial_shards=2,
                              proj_drop_rate=0.1)
    with pytest.raises(NotImplementedError, match="correlate masks across latitude"):
        model(torch.zeros(1, 5, 12, 48), train=True)
    with pytest.raises(ValueError, match="model group"):
        model(torch.zeros(1, 5, 12, 48))
