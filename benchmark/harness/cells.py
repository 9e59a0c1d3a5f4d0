"""The traffic kinds: what set-up builds, what the window drives, and what the
check compares, for a closed loop of train steps and for scored forecasts
(deterministic or ensemble).

Each cell runs in the order set-up -> window -> (traced segment) -> free the
program -> check. The check reruns nothing of the program: it judges what
the program produced (losses, optimizer state, parameters, states and score
rows captured from the timed path) against the plain reference of
``benchmark/reference``, fed only the benchmark's own inputs.
"""

from __future__ import annotations

import datetime
import gc
import statistics
import time
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import inputs, program
from benchmark.reference import breeding, conditioning, scores
from benchmark.reference import training as ref_train
from benchmark.reference.model import Geometry, Precision, forward, fp32_mode, make_weights


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@dataclass
class Run:
    """One run of one cell."""

    cell: str
    config_name: str
    config_file: str
    cfg: dict
    traffic: dict
    seed: int
    device: str
    scratch: str

    @property
    def g(self) -> Geometry:
        return Geometry(self.cfg)


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().float()))


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float], keys: List[str]) -> float:
    """max over leaves of |prog - ref| / max(ref, the median leaf's ref); a
    leaf the program has no reading of (no optimizer state) reads 0."""
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med) for k in keys)


class TrainCell:
    """A closed loop of ``build_train_step`` over a pool of seeded batches.
    Set-up builds the step and drives it through the checked steps, whose
    losses, first gradient (from Adam's first moment) and parameter change
    the check holds to the reference's."""

    kind = "train"
    check_bytes = 0

    def __init__(self, run: Run):
        self.run = run
        self.s_weights, self.s_pool, self.s_gen, self.s_fields = inputs.seeds(run.seed, 4)
        self.n_check = int(run.traffic["check_steps"])

    def setup(self) -> None:
        r, dev = self.run, self.run.device
        self.fields = inputs.Fields(r.cfg, self.s_fields, dev, r.scratch)
        self.pool = inputs.train_pool(r.cfg, int(r.traffic["pool"]), self.s_pool, dev)
        self.params = program.params(r.config_file, r.config_name, self.fields.files)
        weights = make_weights(r.g, self.s_weights, dev)
        self.net = program.model(self.params, weights, dev)
        del weights
        gen = torch.Generator(device=dev).manual_seed(self.s_gen)
        self.step, self.opt = program.train_step(self.params, self.net, gen)
        leaves = dict(self.net.model.named_parameters())
        losses = []
        for i in range(self.n_check):
            losses.append(self.step(self.pool[i])["loss"])
            if i == 0:
                b1 = self.opt.param_groups[0]["betas"][0]
                self.grad1 = {n: _norm(self.opt.state[p]["exp_avg"]) / (1.0 - b1)
                              for n, p in leaves.items() if p in self.opt.state}
        start = make_weights(r.g, self.s_weights, dev)
        self.change = {n: _norm(p - start[n]) for n, p in leaves.items()}
        del start
        self.losses = [float(x) for x in losses]
        self.done = self.n_check

    def _next(self):
        batch = self.pool[self.done % len(self.pool)]
        self.done += 1
        return self.step(batch)["loss"]

    def window(self, seconds: float) -> dict:
        dev = self.run.device
        sync(dev)
        t0 = time.perf_counter()
        losses = []
        while True:
            losses.append(self._next())
            if time.perf_counter() - t0 >= seconds:
                break
        sync(dev)
        window_s = time.perf_counter() - t0
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        return {"window_s": window_s, "attempted": len(losses), "failed": failed,
                "train_samples": len(losses)}

    def segment(self) -> int:
        n = int(self.run.traffic["trace_steps"])
        for _ in range(n):
            self._next()
        return n

    def free(self) -> None:
        del self.step, self.opt, self.net

    def _reference(self, prec: Precision) -> dict:
        """The checked steps' losses, first gradient norms and parameter
        changes, by the reference at ``prec`` from the same weights, batches
        and drop-path draws."""
        r, g, dev = self.run, self.run.g, self.run.device
        cfg = r.cfg
        names = list(cfg["channel_names"])[:g.n_out]
        chw = ref_train.channel_weights(names, self.fields.global_stds, self.fields.diff_stds,
                                        float(cfg["dt"])).to(dev)
        quad = ref_train.quadrature(g.h, g.w).to(dev)
        static = self.fields.static.to(dev)
        with fp32_mode():
            P = make_weights(g, self.s_weights, dev)
            for t in P.values():
                t.requires_grad_(True)
            adam = ref_train.Adam(P, lr=float(cfg["lr"]))
            gen = torch.Generator(device=dev).manual_seed(self.s_gen)
            losses, grad1 = [], {}
            for i in range(self.n_check):
                noise = torch.rand((g.depth, 2, 1), generator=gen, device=dev)
                b = self.pool[i]
                inp = torch.cat([b["inp"], b["zen_inp"], static[None]], dim=1)
                out = forward(inp, P, g, prec, noise=noise, blockwise=True)
                loss = prec.round(ref_train.loss(out, b["tar"], chw, quad))
                grads = dict(zip(P, torch.autograd.grad(loss, list(P.values()))))
                losses.append(float(loss.detach()))
                if i == 0:
                    grad1 = {n: _norm(t) for n, t in grads.items()}
                adam.step(grads)
                del out, loss, grads
            start = make_weights(g, self.s_weights, dev)
            change = {n: _norm(P[n] - start[n]) for n in P}
        return {"losses": losses, "grad1": grad1, "change": change}

    def check(self, control: bool = False) -> Dict[str, float]:
        """The numbers compared: the program's (or with ``control`` the
        reference's at fp8) against the reference's at fp32. Leaves whose
        reference gradient is under a thousandth of the median leaf's are
        left out of the change."""
        ref = self._reference(Precision("fp32"))
        got = self._reference(Precision("fp8")) if control else {
            "losses": self.losses, "grad1": self.grad1, "change": self.change}
        med = statistics.median(ref["grad1"].values())
        moved = [n for n in ref["grad1"] if ref["grad1"][n] >= 1e-3 * med]
        return {
            "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])),
            "grad_gap": worst_leaf(got["grad1"], ref["grad1"], list(ref["grad1"])),
            "update_gap": worst_leaf(got["change"], ref["change"], moved),
        }


class Recorder:
    """Stands in for ``RolloutEngine.stepper``: counts the calls and their
    batch, and while ``plan`` asks for it copies a call's input or output
    rows into buffers allocated at set-up, keyed (forecast, scoring step,
    "in"/"out") or (forecast, "breed", cycle, "in"/"out"). ``nbytes``: what
    the buffers hold of the device's memory, which no deployment holds."""

    def __init__(self, stepper, plan: Dict[tuple, list], shape, device):
        self.stepper = stepper
        self.plan = plan
        cuda = torch.device(device).type == "cuda"
        before = torch.cuda.memory_allocated() if cuda else 0
        self.buffers = {key: torch.empty((len(rows),) + tuple(shape), device=device)
                        for key, rows in plan.items()}
        self.nbytes = torch.cuda.memory_allocated() - before if cuda else 0
        self.forecast, self.step, self.cycle, self.scoring = None, 0, 0, False
        self.batches: List[int] = []

    def __call__(self, state, zen=None):
        out = self.stepper(state, zen)
        self.batches.append(int(state.shape[0]))
        at = (self.forecast, self.step) if self.scoring else (self.forecast, "breed", self.cycle)
        for which, src in (("in", state), ("out", out)):
            for j, row in enumerate(self.plan.get(at + (which,), ())):
                self.buffers[at + (which,)][j].copy_(src[row])
        if self.scoring:
            self.step += 1
        else:
            self.cycle += 1
        return out


class ForecastCell:
    """Scored 14-day forecasts one after another through the port's CLI
    path: ``score_rollout(scanned=True)``, or for an ensemble
    ``breed_perturbations`` -> ``make_members`` -> ``score_ensemble``. The
    window runs whole forecasts until its deadline has passed (a forecast's
    own overheads, such as breeding, are then counted once a forecast in
    every run); the first forecast's sampled step a (and a + 1) is captured
    and checked."""

    kind = "forecast"

    def __init__(self, run: Run):
        self.run = run
        t = run.traffic
        self.members = int(t.get("members", 1))
        self.steps, self.chunk = int(t["steps"]), int(t["chunk"])
        (self.s_weights, self.s_fields, self.s_targets, self.s_clim, self.s_ic,
         self.s_sample) = inputs.seeds(run.seed, 6)

    # -- set-up ------------------------------------------------------------
    def _plan(self) -> None:
        rng = np.random.default_rng(self.s_sample)
        m = self.members
        self.a = int(rng.integers(1, int(self.run.traffic["check_last_step"])))
        if m == 1:
            self.rows, self.start_rows = [0], [0]
        else:
            half = (m - 1) // 2
            r1 = int(rng.integers(1, half + 1))
            r2 = int(rng.integers(half + 1, m))
            self.rows = [0, r1, r2]
            # the control member, r1 and its partner (a centred pair), r2
            self.start_rows = [0, r1, r1 + 1 if r1 % 2 else r1 - 1, r2]
        self.plan = {(0, 0, "in"): self.start_rows, (0, self.a, "in"): self.rows,
                     (0, self.a, "out"): list(range(m)), (0, self.a + 1, "in"): self.rows}
        if m > 1:
            self.plan[(0, 0, "out")] = self.rows
            # breeding: the control and r1's pair (j) into the first cycle,
            # the control into every later one and out of all but the last
            self.pair = (r1 - 1) // 2
            cycles = int(self.run.traffic["breed_cycles"])
            self.plan[(0, "breed", 0, "in")] = [0, 1 + self.pair]
            for c in range(1, cycles):
                self.plan[(0, "breed", c, "in")] = [0]
                self.plan[(0, "breed", c - 1, "out")] = [0]

    def setup(self) -> None:
        r, dev, cfg = self.run, self.run.device, self.run.cfg
        g = r.g
        self.fields = inputs.Fields(cfg, self.s_fields, dev, r.scratch)
        self.params = program.params(r.config_file, r.config_name, self.fields.files)
        self.targets = inputs.target_pool(cfg, int(r.traffic["targets"]), self.s_targets, dev)
        self.clim = inputs.climatology(self.fields, cfg, self.s_clim, dev)
        self.means = self.fields.means.astype(np.float32)
        self.stds = self.fields.stds.astype(np.float32)
        self.dates = inputs.start_dates(self.s_ic, 64)
        weights = make_weights(g, self.s_weights, dev)
        self.engine = program.engine(self.params, program.model(self.params, weights, dev), dev)
        del weights
        self._plan()
        self.rec = Recorder(self.engine.stepper, self.plan, (g.n_out, g.h, g.w), dev)
        self.engine.stepper = self.rec
        self.zenith_s, self.timing = 0.0, False
        zenith_stack = self.engine.zenith_stack

        def timed_zenith(*args, **kwargs):
            t0 = time.perf_counter()
            out = zenith_stack(*args, **kwargs)
            if self.timing:
                self.zenith_s += time.perf_counter() - t0
            return out

        self.engine.zenith_stack = timed_zenith
        self.forecast(-1, int(r.traffic["warmup_steps"]))  # every shape the window uses

    # -- the traffic -------------------------------------------------------
    def initial_state(self, k: int) -> torch.Tensor:
        return inputs.initial_state(self.run.cfg, self.s_ic + k + 1, self.run.device)

    def start(self, k: int) -> datetime.datetime:
        return self.dates[k % len(self.dates)]

    def forecast(self, k: int, n_steps: int) -> dict:
        """Forecast k: its initial state and start time from the seed, its
        targets the pool's frames in turn."""
        eng, t = self.engine, self.run.traffic
        ic, start = self.initial_state(k), self.start(k)
        tars = [self.targets[(k + s) % len(self.targets)] for s in range(n_steps)]
        self.rec.forecast, self.rec.step, self.rec.cycle = k, 0, 0
        kw = dict(means=self.means, stds=self.stds, climatology=self.clim, chunk=self.chunk)
        if self.members > 1:
            breed, make_members, score_ensemble = program.ensemble()
            pert = breed(eng, ic, start, self.members // 2, float(t["amplitude"]),
                         cycles=int(t["breed_cycles"]), seed=self.s_ic + k,
                         zonal_truncation=int(t["zonal_truncation"]))
            if k == 0:
                self.cycles_run = self.rec.cycle
            members = make_members(ic, pert, self.members)
            self.rec.scoring = True
            out = score_ensemble(eng, members, tars, start, **kw)
        else:
            self.rec.scoring = True
            out = program.score_rollout(eng, ic, tars, start, scanned=True, **kw)
        self.rec.scoring = False
        return out

    def window(self, seconds: float) -> dict:
        dev = self.run.device
        sync(dev)
        self.rec.batches.clear()
        self.timing = True
        t0 = time.perf_counter()
        k, steps, failed = 0, 0, 0
        while True:
            out = self.forecast(k, self.steps)
            if k == 0:
                self.first = out
            rows = out["crps" if self.members > 1 else "rmse"]
            steps += len(rows)
            failed += int((~np.isfinite(rows).all(axis=1)).sum())
            k += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(dev)
        window_s = time.perf_counter() - t0
        self.timing = False
        return {"window_s": window_s, "attempted": steps, "failed": failed,
                "forecast_steps": steps, "forward_samples": sum(self.rec.batches),
                "zenith_s": self.zenith_s}

    def segment(self) -> int:
        """One whole forecast, as the window runs them."""
        out = self.forecast(10_000, self.steps)
        return len(out["crps" if self.members > 1 else "rmse"])

    @property
    def check_bytes(self) -> int:
        return self.rec.nbytes

    def free(self) -> None:
        self.rec.stepper = None
        del self.engine

    # -- the check ---------------------------------------------------------
    def check(self, control: bool = False) -> Dict[str, float]:
        """The numbers compared: the start of the first forecast (its initial
        state, for an ensemble its control member and a centred pair), the
        state carried from step a to a + 1, step a's output from its input,
        and step a's score rows, each against the reference (fp32 steps,
        float64 scores); for an ensemble also the breeding (see
        ``_breeding``). With ``control`` the pair, the seed noise, step a and
        its scores come from the reference at a lower precision (bf16 members
        and noise, fp8 steps, scores of bf16 fields) in the program's
        place."""
        r, g, dev = self.run, self.run.g, self.run.device
        buf, a = self.rec.buffers, self.a
        ic = self.initial_state(0)[0]
        start_in = buf[(0, 0, "in")]
        start_gap = float((start_in[0] - ic).abs().max())  # the IC, or the control member
        pair = {}
        if self.members > 1:
            # a centred pair of the bred amplitude; the control forms the pair
            # of the same perturbation in bf16, the precision below fp32
            amp = float(r.traffic["amplitude"])
            plus, minus = start_in[1], start_in[2]
            if control:
                p = (plus - minus) / 2
                plus, minus = (Precision("fp8").round(ic + p), Precision("fp8").round(ic - p))
            w = scores.lat_weight(g.h, dev).float()
            rms = torch.sqrt(torch.mean(w * (plus - ic) ** 2, dim=(-2, -1)))
            pair["pair_gap"] = max(float(((plus + minus) / 2 - ic).abs().max()) / amp,
                                   float((rms - amp).abs().max()) / amp)
        out_a = buf[(0, a, "out")]
        carry_gap = float((buf[(0, a + 1, "in")] - out_a[self.rows]).abs().max())
        zen0 = conditioning.cos_zenith(self.start(0), g.h, g.w)
        zen = conditioning.cos_zenith(
            self.start(0) + datetime.timedelta(hours=6 * int(r.cfg["dt"]) * a), g.h, g.w)
        static = self.fields.static.to(dev)
        step_gap = 0.0
        with fp32_mode(), torch.no_grad():
            P = make_weights(g, self.s_weights, dev)
            for j, row in enumerate(self.rows):
                x = conditioning.model_input(buf[(0, a, "in")][j:j + 1], zen, static)
                y = forward(x, P, g)[0]
                got = forward(x, P, g, Precision("fp8"))[0] if control else out_a[row]
                inc = torch.sqrt(torch.mean((y - x[0, :g.n_out]) ** 2))
                err = torch.sqrt(torch.mean((got - y) ** 2, dim=(-2, -1)))
                step_gap = max(step_gap, float(err.max() / inc))
            if self.members > 1:
                pair["member_gap"] = self._member_gap(P, start_in, zen0, static, control)
                bred = self._breeding(ic, control)
                start_gap = max(start_gap, bred.pop("start_gap"))
                carry_gap = max(carry_gap, bred.pop("carry_gap"))
                pair.update(bred)
            del P
            score_gap = self._score_gap(out_a, control)
        return {"start_gap": start_gap, "carry_gap": carry_gap, "step_gap": step_gap,
                "score_gap": score_gap, **pair}

    def _member_gap(self, P, start_in, zen, static, control: bool) -> float:
        """The first step of two members (one of each half) about the control
        member's: worst member's RMS error of (member - control) against the
        reference's, over the reference's RMS of it. Members lie 0.05 apart,
        so a step that leaves some out and repeats a mean reads about 1."""
        g = self.run.g
        xs = [start_in[j:j + 1] for j in (0, 1, 3)]  # rows 0, r1, r2
        outs = self.rec.buffers[(0, 0, "out")]
        ys, got = [], []
        for j, x in enumerate(xs):
            inp = conditioning.model_input(x, zen, static)
            ys.append(forward(inp, P, g)[0])
            got.append(forward(inp, P, g, Precision("fp8"))[0] if control else outs[j])
        gap = 0.0
        for j in (1, 2):
            want = ys[j] - ys[0]
            err = (got[j] - got[0]) - want
            gap = max(gap, float(torch.sqrt(torch.mean(err**2)) / torch.sqrt(torch.mean(want**2))))
        return gap

    def _breeding(self, ic, control: bool) -> Dict[str, float]:
        """The first forecast's breeding: ``seed_gap``, pair j's perturbation
        into the first cycle against the reference's seed noise (the
        latitude-weighted RMS error over all channels, over the amplitude);
        the first cycle's control state against the initial state and each
        later one against the control's step (exact: into ``start_gap`` and
        ``carry_gap``). Breeding that ran another number of cycles through
        the stepper than configured (seed noise in its place: none) reads
        infinite."""
        t = self.run.traffic
        amp, cycles = float(t["amplitude"]), int(t["breed_cycles"])
        if self.cycles_run != cycles:
            inf = float("inf")
            return {"start_gap": inf, "carry_gap": inf, "seed_gap": inf}
        buf = self.rec.buffers
        ins = [buf[(0, "breed", c, "in")] for c in range(cycles)]
        carry = max((float((ins[c + 1][0] - buf[(0, "breed", c, "out")][0]).abs().max())
                     for c in range(cycles - 1)), default=0.0)
        noise = breeding.seed_noise(self.s_ic, self.members // 2, ic.shape, amp,
                                    int(t["zonal_truncation"]), self.run.device)[self.pair]
        got = Precision("fp8").round(ic + noise) - ic if control else ins[0][1] - ins[0][0]
        seed_gap = float(breeding.lat_rms(got - noise).pow(2).mean().sqrt()) / amp
        return {"start_gap": float((ins[0][0] - ic).abs().max()), "carry_gap": carry,
                "seed_gap": seed_gap}

    def _score_gap(self, out_a: torch.Tensor, control: bool) -> float:
        """Step a's score rows against float64 scores of the program's own
        output; ACC's gap absolute, the others' relative to the larger of
        the channel's value and the median channel's."""
        dev, a = self.run.device, self.a
        fn = scores.deterministic if self.members == 1 else (
            lambda f, y, c: scores.ensemble(f, y[0], c))

        def fields(dtype, rnd):
            std = torch.as_tensor(self.stds, dtype=dtype, device=dev)
            mean = torch.as_tensor(self.means, dtype=dtype, device=dev)
            tar = torch.as_tensor(self.targets[a % len(self.targets)], device=dev)
            f = rnd(out_a).to(dtype) * std + mean
            y = rnd(tar).to(dtype) * std + mean
            return (f[0] if self.members == 1 else f), (y[0] if self.members == 1 else y), \
                torch.as_tensor(self.clim, dtype=dtype, device=dev)

        ref = fn(*fields(torch.float64, lambda t: t))
        if control:
            bf16 = Precision("fp8").round
            got = {k: v.double().cpu().numpy() for k, v in fn(*fields(torch.float32, bf16)).items()}
        else:
            got = {k: np.asarray(self.first[k][a], np.float64) for k in ref}
        gap = 0.0
        for key, want in ref.items():
            want = want.cpu().numpy()
            scale = 1.0 if key.startswith("acc") else np.maximum(np.abs(want),
                                                                 np.median(np.abs(want)))
            gap = max(gap, float(np.max(np.abs(got[key] - want) / scale)))
        return gap


KINDS = {"train": TrainCell, "forecast": ForecastCell}


def collect() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
