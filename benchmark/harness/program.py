"""The system under test: the PyTorch port, built through its own entry points.

The benchmark hands it a configuration file (read by the port's
``YParams``), seeded weights and seeded inputs; it takes back the train
step and the rollout engine, and nothing else.
"""

from __future__ import annotations

from typing import Dict

import torch


def params(config_file: str, name: str, files: Dict[str, str]):
    """The port's parameters of configuration ``name``, with the input files
    of this run and the derived channel counts and image shape."""
    from swin_v2_weather_torch.config.yparams import YParams
    from swin_v2_weather_torch.data.preprocess import derived_channel_counts

    p = YParams(config_file, name)
    for key, path in files.items():
        p[key] = path
    p["n_in_channels"], p["n_out_channels"] = derived_channel_counts(p)
    p["img_shape_x"], p["img_shape_y"] = (int(s) for s in p.img_size)
    return p


def model(p, weights: Dict[str, torch.Tensor], device):
    """``get_model`` built on ``device`` with the given weights."""
    from swin_v2_weather_torch.models.wrappers import get_model

    with torch.device(device):
        net = get_model(p, device=device)
    core = net.model
    own = dict(core.named_parameters())
    if set(own) != set(weights):
        raise RuntimeError(f"the port's parameters differ from the benchmark's: "
                           f"{sorted(set(own) ^ set(weights))[:6]}")
    with torch.no_grad():
        for name, t in weights.items():
            own[name].copy_(t)
    return net


def train_step(p, net, generator: torch.Generator):
    """``(step, optimizer)``: ``build_train_step`` over the config's loss,
    preprocessing and optimizer; ``generator`` draws the drop-path masks."""
    from swin_v2_weather_torch.data.preprocess import Preprocessor
    from swin_v2_weather_torch.ops.losses import LossHandler
    from swin_v2_weather_torch.training.optim import build_optimizer
    from swin_v2_weather_torch.training.step import build_train_step

    optimizer = build_optimizer(p, net.parameters())
    step = build_train_step(net, LossHandler(p), Preprocessor(p), optimizer, generator=generator)
    return step, optimizer


def engine(p, net, device):
    """The port's ``RolloutEngine`` over the model."""
    from swin_v2_weather_torch.inference.rollout import RolloutEngine

    return RolloutEngine(p, net, device)


def score_rollout(*args, **kwargs):
    from swin_v2_weather_torch.inference.scoring import score_rollout as fn

    return fn(*args, **kwargs)


def ensemble():
    """(breed_perturbations, make_members, score_ensemble)."""
    from swin_v2_weather_torch.inference import ensemble as ens

    return ens.breed_perturbations, ens.make_members, ens.score_ensemble
