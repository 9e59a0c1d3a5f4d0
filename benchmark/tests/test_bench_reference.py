"""The plain reference against the port at a micro size on the CPU: the
model's forward and a train step (preprocessing, drop-path, loss, backward,
Adam), the conditioning channels and the scores. In fp32 both sides do the
same arithmetic in another order, so they agree to fp32 rounding; in the
configuration's bf16 the port departs by its rounding, well below the fp8
control's."""

import datetime
import json
import os

import numpy as np
import pytest
import torch

from benchmark.harness import inputs, program
from benchmark.reference import conditioning, scores
from benchmark.reference import training as ref_train
from benchmark.reference.model import Geometry, Precision, forward, make_weights

FLAGSHIP = "swin_73var_geo_depth12_chweight_invar"


def micro(root, **over):
    fname = os.path.join(root, "benchmark", "configs", FLAGSHIP + ".json")
    with open(fname) as f:
        doc = json.load(f)
    doc[FLAGSHIP].update(over)
    with open(fname, "w") as f:
        json.dump(doc, f)
    return fname, doc[FLAGSHIP]


def port(root, tmp_path, seed=3, **over):
    fname, cfg = micro(root, **over)
    fields = inputs.Fields(cfg, seed, "cpu", str(tmp_path / "files"))
    p = program.params(fname, FLAGSHIP, fields.files)
    g = Geometry(cfg)
    net = program.model(p, make_weights(g, seed, "cpu"), "cpu")
    return p, cfg, g, fields, net


# fp32 on the plain routes (the kernels' plain versions round as the kernels
# do); the configuration's bf16 on its own routes
@pytest.mark.parametrize("over,tol", [
    (dict(compute_dtype="float32", attn_impl="xla", mlp_impl="plain"), 2e-5),
    (dict(), 3e-2)], ids=["fp32", "bf16"])
def test_forward_matches_the_port(micro_root, tmp_path, over, tol):
    p, cfg, g, fields, net = port(micro_root, tmp_path, **over)
    x = torch.randn((2, g.n_in, g.h, g.w), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = net(x).float()
        want = forward(x, make_weights(g, 3, "cpu"), g)
    inc = (want - x[:, :g.n_out]).pow(2).mean().sqrt()
    assert float((got - want).pow(2).mean().sqrt() / inc) < tol


def test_fp8_control_departs_more_than_bf16(micro_root, tmp_path):
    p, cfg, g, fields, net = port(micro_root, tmp_path)
    x = torch.randn((1, g.n_in, g.h, g.w), generator=torch.Generator().manual_seed(1))
    P = make_weights(g, 3, "cpu")
    with torch.no_grad():
        want = forward(x, P, g)
        inc = (want - x[:, :g.n_out]).pow(2).mean().sqrt()
        bf16 = float((net(x).float() - want).pow(2).mean().sqrt() / inc)
        fp8 = float((forward(x, P, g, Precision("fp8")) - want).pow(2).mean().sqrt() / inc)
    assert fp8 > 4 * bf16


def test_train_step_matches_the_port(micro_root, tmp_path):
    """Two fp32 steps: loss, every gradient and the Adam update."""
    p, cfg, g, fields, net = port(micro_root, tmp_path, compute_dtype="float32",
                                  attn_impl="xla", mlp_impl="plain")
    gen = torch.Generator().manual_seed(9)
    step, opt = program.train_step(p, net, gen)
    pool = inputs.train_pool(cfg, 2, 4, "cpu")
    losses = [float(step(b)["loss"]) for b in pool]
    P = make_weights(g, 3, "cpu")
    for t in P.values():
        t.requires_grad_(True)
    adam = ref_train.Adam(P, lr=float(cfg["lr"]))
    chw = ref_train.channel_weights(cfg["channel_names"], fields.global_stds, fields.diff_stds,
                                    float(cfg["dt"]))
    quad = ref_train.quadrature(g.h, g.w)
    rgen = torch.Generator().manual_seed(9)
    for b, got in zip(pool, losses):
        noise = torch.rand((g.depth, 2, 1), generator=rgen)
        inp = torch.cat([b["inp"], b["zen_inp"], fields.static[None]], dim=1)
        loss = ref_train.loss(forward(inp, P, g, noise=noise, blockwise=True), b["tar"], chw,
                              quad)
        assert float(loss) == pytest.approx(got, rel=1e-5)
        adam.step(dict(zip(P, torch.autograd.grad(loss, list(P.values())))))
    for name, t in net.model.named_parameters():
        ref = P[name].detach()
        assert float((t.detach() - ref).abs().max()) <= 1e-5 * float(ref.abs().max()) + 1e-7, name


def test_zenith_and_static_block_match_the_port(micro_root, tmp_path):
    from swin_v2_weather_torch.data.conditioning import static_features

    p, cfg, g, fields, net = port(micro_root, tmp_path)
    engine = program.engine(p, net, "cpu")
    when = datetime.datetime(2018, 7, 3, 18)
    np.testing.assert_allclose(engine.zenith_at(when)[0, 0],
                               conditioning.cos_zenith(when, g.h, g.w), atol=1e-6)
    np.testing.assert_allclose(static_features(p), fields.static.numpy(), atol=1e-6)


def test_scores_match_the_port():
    from swin_v2_weather_torch.ops import metrics

    gen = torch.Generator().manual_seed(2)
    f, y, clim = (torch.randn((9, 3, 16, 32), generator=gen, dtype=torch.float64)
                  for _ in range(3))
    y, clim = y[0], clim[0]
    det = scores.deterministic(f[0], y, clim)
    np.testing.assert_allclose(det["rmse"], metrics.weighted_rmse(f[:1], y[None]), rtol=1e-12)
    np.testing.assert_allclose(det["acc"], metrics.weighted_acc(f[:1] - clim, y[None] - clim),
                               rtol=1e-12)
    ens = scores.ensemble(f, y, clim)
    np.testing.assert_allclose(ens["crps"], metrics.weighted_crps(f[:, None], y[None]),
                               rtol=1e-10)
    np.testing.assert_allclose(ens["spread"], metrics.ensemble_spread(f[:, None]), rtol=1e-10)
