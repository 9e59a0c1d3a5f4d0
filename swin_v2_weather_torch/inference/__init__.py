"""Serving: the model registry, the autoregressive rollout engine, forecast
scoring, ensembles, the ``torch.export`` serving artifact and the inference
CLI (counterpart of ``swin_v2_weather_tpu.inference``). Importing it builds
nothing and imports no model code."""

from swin_v2_weather_torch.inference.registry import (
    export_model,
    load_model,
    load_stats,
    swin_from_yaml,
)
from swin_v2_weather_torch.inference.export import export_stepper, load_stepper
from swin_v2_weather_torch.inference.rollout import RolloutEngine
from swin_v2_weather_torch.inference.scoring import (
    acc_against_climatology,
    score_rollout,
)
from swin_v2_weather_torch.inference.ensemble import (
    breed_perturbations,
    gaussian_perturbations,
    make_members,
    score_ensemble,
)

__all__ = [
    "breed_perturbations",
    "gaussian_perturbations",
    "make_members",
    "score_ensemble",
    "RolloutEngine",
    "export_stepper",
    "load_stepper",
    "export_model",
    "load_model",
    "load_stats",
    "swin_from_yaml",
    "acc_against_climatology",
    "score_rollout",
]
