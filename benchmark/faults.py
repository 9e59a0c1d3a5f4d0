"""Faults planted in the program's timed path, underneath the harness: each
must turn a run's ``correct`` false. Shared by the CPU tests (at a micro
size) and ``study.py --fault`` (the readings on the card at a cell's size).

  * ``unchanged``: a step that leaves its state unchanged (the optimizer not
    stepping; a forecast step returning its input);
  * ``altered``: every train step's loss altered by 10 % where it is produced;
  * ``half``: half of the batch left out, the mean of the rest in its place
    (the ensemble's members);
  * ``channel``: one predicted channel altered by one standard deviation;
  * ``score``: the RMSE or CRPS rows altered by 1 %;
  * ``noise``: breeding replaced by its seed noise (no cycles run).

No cell spans chips, so there is no exchange between chips to leave out.
"""

from __future__ import annotations

import torch

from benchmark.harness import program

FAULTS = ("unchanged", "altered", "half", "channel", "score", "noise")


def plant(fault: str, kind: str, setattr=setattr) -> None:
    """Break the program of a cell of ``kind`` ("train" or "forecast") with
    ``fault``; ``setattr`` may be a test's ``monkeypatch.setattr``."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if kind == "train":
        setattr(program, "train_step", _train_step(program.train_step, fault))
    elif fault == "score":
        _scores(setattr)
    elif fault == "noise":
        setattr(program, "ensemble", _seed_noise(program.ensemble))
    else:
        setattr(program, "engine", _engine(program.engine, fault))


def _train_step(build, fault):
    def train_step(p, net, gen):
        step, opt = build(p, net, gen)
        if fault == "unchanged":
            opt.step = lambda *a, **k: None
            return step, opt

        def altered(batch):
            out = step(batch)
            return dict(out, loss=out["loss"] * 1.1)

        return altered, opt

    return train_step


class Stepper:
    def __init__(self, inner, fault):
        self.inner, self.fault = inner, fault

    def __call__(self, state, zen=None):
        if self.fault == "unchanged":
            return state.clone()
        if self.fault == "half":
            h = (state.shape[0] + 1) // 2
            done = self.inner(state[:h], None if zen is None else zen[:h])
            rest = done.mean(0, keepdim=True).expand(state.shape[0] - h, -1, -1, -1)
            return torch.cat([done, rest])
        out = self.inner(state, zen)
        out[:, 5] += 1.0
        return out


def _engine(build, fault):
    def engine(p, net, device):
        e = build(p, net, device)
        e.stepper = Stepper(e.stepper, fault)
        return e

    return engine


def _scores(setattr):
    score_rollout, ensemble = program.score_rollout, program.ensemble

    def altered(rows):
        return {k: (v * 1.01 if k in ("rmse", "crps") else v) for k, v in rows.items()}

    def ens():
        breed, members, score = ensemble()
        return breed, members, lambda *a, **k: altered(score(*a, **k))

    setattr(program, "score_rollout", lambda *a, **k: altered(score_rollout(*a, **k)))
    setattr(program, "ensemble", ens)


def _seed_noise(ensemble):
    def ens():
        from swin_v2_weather_torch.inference.ensemble import gaussian_perturbations

        _, members, score = ensemble()

        def breed(engine, ic, start, n_pairs, amplitude, cycles=3, seed=0, zonal_truncation=20):
            gen = torch.Generator(device=engine.device).manual_seed(int(seed))
            return gaussian_perturbations(gen, n_pairs, tuple(ic.shape[-3:]), amplitude,
                                          zonal_truncation)

        return breed, members, score

    return ens
