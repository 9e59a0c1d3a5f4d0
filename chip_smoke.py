#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (swin_v2_weather_torch) on one NVIDIA GPU.

Run from a checkout of the repo:

    python3 chip_smoke.py

It needs one CUDA device and the CUDA toolkit (nvcc under $CUDA_HOME or
/usr/local/cuda), and no network. It imports nothing of JAX. Phases, each
printing its own lines:

  1. torch/CUDA versions, and the card's name and power limit as
     ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
     them; TF32 is switched off for matmuls and cuDNN.
  2. build the hand-written kernels from ``swin_v2_weather_torch/ops/csrc``
     with nvcc (first use builds into ``swin_v2_weather_torch/_build/``).
  3. the window-attention kernel against its plain version at the flagship
     shapes, unshifted and with the shifted-block mask.
  4. the fc1+GELU kernel against its plain version at [64800, 768] x [768, 3072].
  5. flagship serving: ``swin_73var_geo_depth12_chweight_invar`` at full width
     (77 -> 73 channels, 720x1440, embed 768, depth 12) built through
     ``get_model``, every parameter drawn from a seeded generator (LayerNorm
     scales non-zero, so no block is the identity), the weights round-tripped
     through the JAX layout, then ``RolloutEngine.rollout`` for 4 steps from
     2018-01-01T00:00. Each kernel must have launched 12 x 4 = 48 times, every
     output must be finite, and step 1 must match the plain path on the card.
  6. rollout ms/step on both paths (CUDA events, after one warm-up step) and
     the peak device memory.
  7. the window-attention backward kernel against its plain backward at the
     flagship shapes, unshifted and shifted: dx, dW, db and dscale.
  8. the fc1 backward (pre-activation cotangent) kernel against its plain
     version at [64800, 768] x [768, 3072].
  9. the flagship train step at full width, drop-path 0.1 live, built through
     ``get_model``, ``LossHandler`` (synthetic unit stats), ``Preprocessor``,
     ``build_optimizer`` and ``build_train_step``, on seeded parameters and a
     batch of 1 from ``SyntheticDataset``: 4 steps, each of the four kernels
     launched 12 x 4 = 48 times, finite metrics, every parameter moved; step
     1's loss and gradient norms against the plain path on the card (same
     weights, batch and generator seed, so the drop-path masks agree); one
     ``build_eval_step`` call.
 10. train ms/step on both paths (CUDA events, after one warm-up step),
     samples/s and the peak device memory.

Then one JSON line with the kernels' results, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises (exit code 1); without a
CUDA device the script exits with code 1 before printing any result.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import math
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

SEED = 2018
CONFIG = "swin_73var_geo_depth12_chweight_invar"
N_STEPS = 4
START = datetime.datetime(2018, 1, 1, 0, 0)

# Tolerances, in bf16 ulps of the output scale (the bf16 spacing at the
# largest reference magnitude). Kernel and plain version keep the same rounding
# sites; only the order of fp32 sums differs, which now and then flips one
# bf16 rounding of an intermediate or of the output.
ATTN_TOL = (2.0, 0.01)  # (max, mean) ulps
MLP_TOL = (2.0, 0.01)  # a flip of the pre-activation moves gelu by <= 1.13 ulp, + output rounding
# Whole model, 12 bf16 blocks: flips in one block propagate through the rest
MODEL_TOL = (8.0, 0.5)
# Backward, per output. A flipped bf16 rounding of dqkv moves dx by an ulp
# (mean about 0.01 ulp at this shape); dW and db sum 64800 token rows, so a
# few flips add up; dscale sums <qn16, dqn> over 64800 rows with cancellation.
BWD_TOL = {"dx": (2.0, 0.05), "dW": (4.0, 0.05), "db": (4.0, 0.05), "dscale": (2.0, 0.25)}
# Train step 1, kernel path vs plain path: relative bounds on the loss and on
# each gradient norm. Both are sums over millions of terms, so one-ulp flips
# of either sign average out (about 1e-5 relative on the H100).
STEP_RTOL = {"loss": 1e-4, "grad_norm": 1e-3}


def log(msg: str) -> None:
    print(msg, flush=True)


def bf16_ulp(ref: torch.Tensor) -> float:
    return 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)


def compare(name: str, out: torch.Tensor, ref: torch.Tensor, tol) -> float:
    """Print max/mean abs diff against the tolerance; raise if outside it."""
    diff = (out.float() - ref.float()).abs()
    ulp = bf16_ulp(ref.float())
    max_abs, mean_abs = diff.max().item(), diff.mean().item()
    log(
        f"  {name}: max_abs {max_abs:.6g} (tol {tol[0] * ulp:.6g}), "
        f"mean_abs {mean_abs:.6g} (tol {tol[1] * ulp:.6g}), max|ref| {ref.abs().max().item():.6g}"
    )
    if not (max_abs <= tol[0] * ulp and mean_abs <= tol[1] * ulp):
        raise RuntimeError(f"{name}: kernel and plain version disagree beyond tolerance")
    return max_abs


def time_ms(fn, n: int) -> float:
    """Mean device time of fn() over n launches, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def seeded_parameters(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Every parameter from seeded noise; LayerNorm scales 1 + 0.1 N(0, 1)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("logit_scale"):
                val = math.log(10.0) + 0.3 * torch.randn(p.shape, generator=gen)
            elif name.endswith("pos_embed") or name.endswith(".bias"):
                val = 0.02 * torch.randn(p.shape, generator=gen)
            elif p.dim() == 1:  # LayerNorm scale
                val = 1.0 + 0.1 * torch.randn(p.shape, generator=gen)
            else:  # Linear weight [out, in]: U(-1, 1) / sqrt(fan_in)
                val = (2.0 * torch.rand(p.shape, generator=gen) - 1.0) / math.sqrt(p.shape[1])
            p.copy_(val)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from swin_v2_weather_torch.config.yparams import YParams, default_config_path
    from swin_v2_weather_torch.data.preprocess import derived_channel_counts
    from swin_v2_weather_torch.inference.rollout import RolloutEngine
    from swin_v2_weather_torch.models import swin as swin_mod
    from swin_v2_weather_torch.models.convert import params_from_jax, params_to_jax
    from swin_v2_weather_torch.models.swin import make_shift_mask
    from swin_v2_weather_torch.models.wrappers import get_model
    from swin_v2_weather_torch.ops import _build
    from swin_v2_weather_torch.ops import mlp_kernels as mk
    from swin_v2_weather_torch.ops import window_attention as wa

    t_start = time.time()
    dev = torch.device("cuda", 0)

    # ---- 1. versions and card ------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1] python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0].strip()
    log(card)
    log(f"    device 0: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible; "
        "TF32 off (matmul, cudnn)")

    # ---- 2. build --------------------------------------------------------------
    t0 = time.time()
    lib_path = _build.build_library()
    _build.load_library()
    log(f"[2] kernels built and loaded in {time.time() - t0:.1f} s: {os.path.basename(lib_path)}")
    with open(lib_path[: -len(".so")] + ".log") as f:
        for line in f.read().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"    {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}

    # ---- 3. K1 window attention at flagship shapes ---------------------------
    b, gh, gw, c, heads, window = 1, 180, 360, 768, 8, (9, 18)
    shift = (window[0] // 2, window[1] // 2)
    x = torch.randn((b, gh, gw, c), generator=gen, device=dev).bfloat16()
    w_qkv = ((2 * torch.rand((c, 3 * c), generator=gen, device=dev) - 1) / math.sqrt(c))
    b_qkv = 0.02 * torch.randn((3 * c,), generator=gen, device=dev)
    scale = torch.exp(math.log(10.0) + 0.3 * torch.randn((heads,), generator=gen, device=dev))
    pattern = torch.from_numpy(make_shift_mask((gh, gw), window, shift)[-1].copy()).to(dev)
    w16 = w_qkv.bfloat16()
    log(f"[3] window_attention_qkv: x {tuple(x.shape)} bf16, W [{c}, {3 * c}], "
        f"{heads} heads, window {window}")
    errs, attn_ms, attn_plain_ms = [], None, None
    for label, mask in (("unshifted", None), ("shifted", pattern)):
        with torch.inference_mode():
            out = wa.window_attention_qkv(x, w16, b_qkv, scale, window, mask, 1.0)
            ref = wa.window_attention_qkv_reference(x, w_qkv, b_qkv, scale, window, mask)
        torch.cuda.synchronize()
        errs.append(compare(label, out, ref, ATTN_TOL))
        with torch.inference_mode():
            k_ms = time_ms(lambda: wa.window_attention_qkv(x, w16, b_qkv, scale, window, mask, 1.0), 20)
            p_ms = time_ms(lambda: wa.window_attention_qkv_reference(x, w_qkv, b_qkv, scale, window, mask), 5)
        log(f"  {label}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms ({card})")
        if attn_ms is None:
            attn_ms, attn_plain_ms = k_ms, p_ms
    results["window_attention_qkv"] = (max(errs), attn_ms, attn_plain_ms)
    del x, out, ref

    # ---- 4. K3 fc1 + GELU at flagship shapes ---------------------------------
    t_tok, hidden = b * gh * gw, 4 * c
    x2 = torch.randn((t_tok, c), generator=gen, device=dev).bfloat16()
    w1 = (2 * torch.rand((c, hidden), generator=gen, device=dev) - 1) / math.sqrt(c)
    b1 = 0.02 * torch.randn((hidden,), generator=gen, device=dev)
    w1_16 = w1.bfloat16()
    log(f"[4] fc1_gelu: x2 [{t_tok}, {c}] bf16, W1 [{c}, {hidden}]")
    with torch.inference_mode():
        out = mk.fc1_gelu(x2, w1_16, b1)
        ref = mk.fc1_gelu_reference(x2, w1, b1)
    torch.cuda.synchronize()
    err = compare("fc1_gelu", out, ref, MLP_TOL)
    with torch.inference_mode():
        k_ms = time_ms(lambda: mk.fc1_gelu(x2, w1_16, b1), 20)
        p_ms = time_ms(lambda: mk.fc1_gelu_reference(x2, w1, b1), 5)
    log(f"  kernel {k_ms:.4f} ms ({2 * t_tok * c * hidden / k_ms / 1e9:.1f} TFLOP/s), "
        f"plain {p_ms:.4f} ms ({card})")
    results["fc1_gelu"] = (err, k_ms, p_ms)
    del x2, out, ref

    # ---- 5. flagship serving through get_model + RolloutEngine ---------------
    params = YParams(default_config_path(), CONFIG)
    n_in, n_out = derived_channel_counts(params)
    params["n_in_channels"], params["n_out_channels"] = n_in, n_out
    model = get_model(params)
    cpu_gen = torch.Generator().manual_seed(SEED)
    seeded_parameters(model, cpu_gen)
    n_params = sum(p.numel() for p in model.parameters())
    state = model.state_dict()
    back = params_from_jax(params_to_jax(state))
    if set(back) != set(state) or not all(torch.equal(back[k], state[k]) for k in state):
        raise RuntimeError("state_dict -> JAX layout -> state_dict round trip is not exact")
    log(f"[5] {CONFIG}: {n_in} -> {n_out} channels, {tuple(params.img_size)}, embed "
        f"{params.embed_dim}, depth {params.depth}, {n_params} parameters; JAX-layout round trip exact")
    engine = RolloutEngine(params, model, dev)
    state0 = torch.randn((1, n_out, *params.img_size), generator=cpu_gen)

    wa.window_attention_qkv.launches = 0
    mk.fc1_gelu.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    preds = engine.rollout(state0, START, N_STEPS)
    rollout_s = time.time() - t0
    launches = {
        "window_attention_qkv": wa.window_attention_qkv.launches,
        "fc1_gelu": mk.fc1_gelu.launches,
    }
    log(f"  rollout {N_STEPS} steps in {rollout_s:.2f} s -> {preds.shape} {preds.dtype}; "
        f"launches {launches}")
    want = int(params.depth) * N_STEPS
    if any(n != want for n in launches.values()):
        raise RuntimeError(f"each kernel must launch {want} times on the main path, got {launches}")
    if preds.shape != (N_STEPS, 1, n_out, *params.img_size) or not np.isfinite(preds).all():
        raise RuntimeError("rollout output has the wrong shape or non-finite values")
    for s in range(N_STEPS):
        log(f"    step {s + 1}: mean {preds[s].mean():.5f}, std {preds[s].std():.5f}, "
            f"max|.| {np.abs(preds[s]).max():.5f}")

    plain = mock.patch.multiple(
        swin_mod,
        fused_window_attention_qkv=wa.window_attention_qkv_reference,
        fused_fc1_gelu=mk.fc1_gelu_reference,
    )
    with plain:
        plain1 = next(engine.steps(state0, START, 1))
    if wa.window_attention_qkv.launches != want or mk.fc1_gelu.launches != want:
        raise RuntimeError("the plain path launched a kernel")
    compare("step 1 kernel path vs plain path", torch.from_numpy(preds[0]), plain1.cpu(), MODEL_TOL)

    # ---- 6. rollout ms/step on both paths ------------------------------------
    def rollout_ms(n: int = 3) -> float:
        steps = engine.steps(state0, START, n + 1)
        next(steps)  # warm-up step
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in steps:
            pass
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    torch.cuda.reset_peak_memory_stats()
    kernel_step = rollout_ms()
    kernel_mem = torch.cuda.max_memory_allocated() / 2**30
    with plain:
        torch.cuda.reset_peak_memory_stats()
        plain_step = rollout_ms()
        plain_mem = torch.cuda.max_memory_allocated() / 2**30
    log(f"[6] rollout: kernel path {kernel_step:.2f} ms/step (peak {kernel_mem:.3f} GiB), "
        f"plain path {plain_step:.2f} ms/step (peak {plain_mem:.3f} GiB); {card}")
    serve_launches = launches
    del engine, model, preds, plain1, state, back

    # ---- 7. K2 window-attention backward at flagship shapes ------------------
    x = torch.randn((b, gh, gw, c), generator=gen, device=dev).bfloat16()
    g = torch.randn((b, gh, gw, c), generator=gen, device=dev).bfloat16()
    log(f"[7] window_attention_qkv_bwd: x, g {tuple(x.shape)} bf16, W [{c}, {3 * c}] bf16, "
        f"{heads} heads, window {window}")
    bwd_errs, bwd_ms, bwd_plain_ms = {}, None, None
    for label, mask in (("unshifted", None), ("shifted", pattern)):
        out = wa.window_attention_qkv_bwd(x, w16, b_qkv, scale, g, window, mask, 1.0)
        ref = wa.window_attention_qkv_backward_reference(x, w16, b_qkv, scale, g, window, mask)
        torch.cuda.synchronize()
        if out[0].dtype != torch.bfloat16 or any(t.dtype != torch.float32 for t in out[1:]):
            raise RuntimeError("window_attention_qkv_bwd: wrong output dtypes")
        for name, o, r in zip(("dx", "dW", "db", "dscale"), out, ref):
            err = compare(f"{label} {name}", o, r, BWD_TOL[name])
            bwd_errs[name] = max(err, bwd_errs.get(name, 0.0))
        again = wa.window_attention_qkv_bwd(x, w16, b_qkv, scale, g, window, mask, 1.0)
        if not all(torch.equal(a, o) for a, o in zip(again, out)):
            raise RuntimeError("window_attention_qkv_bwd: two calls differ (reduction order)")
        k_ms = time_ms(lambda: wa.window_attention_qkv_bwd(x, w16, b_qkv, scale, g, window, mask, 1.0), 10)
        p_ms = time_ms(lambda: wa.window_attention_qkv_backward_reference(
            x, w16, b_qkv, scale, g, window, mask), 3)
        log(f"  {label}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms ({card}); two calls bit-equal")
        if bwd_ms is None:
            bwd_ms, bwd_plain_ms = k_ms, p_ms
    results["window_attention_qkv_bwd"] = (bwd_errs["dx"], bwd_ms, bwd_plain_ms)
    del x, g, out, ref, again

    # ---- 8. K4 fc1 backward (pre-activation cotangent) at flagship shapes ----
    x2 = torch.randn((t_tok, c), generator=gen, device=dev).bfloat16()
    g2 = torch.randn((t_tok, hidden), generator=gen, device=dev).bfloat16()
    log(f"[8] fc1_dpre: x2 [{t_tok}, {c}] bf16, W1 [{c}, {hidden}], g [{t_tok}, {hidden}] bf16")
    out = mk.fc1_dpre(x2, w1_16, b1, g2)
    ref = mk.fc1_dpre_reference(x2, w1, b1, g2)
    torch.cuda.synchronize()
    err = compare("fc1_dpre", out, ref, MLP_TOL)
    k_ms = time_ms(lambda: mk.fc1_dpre(x2, w1_16, b1, g2), 20)
    p_ms = time_ms(lambda: mk.fc1_dpre_reference(x2, w1, b1, g2), 5)
    log(f"  kernel {k_ms:.4f} ms ({2 * t_tok * c * hidden / k_ms / 1e9:.1f} TFLOP/s), "
        f"plain {p_ms:.4f} ms ({card})")
    results["fc1_dpre"] = (err, k_ms, p_ms)
    del x2, g2, out, ref, w1, b1, w1_16, w_qkv, w16, b_qkv, scale
    torch.cuda.empty_cache()

    # ---- 9. the flagship train step ------------------------------------------
    from swin_v2_weather_torch.data.preprocess import Preprocessor
    from swin_v2_weather_torch.data.synthetic import SyntheticDataset, collate
    from swin_v2_weather_torch.ops.losses import LossHandler
    from swin_v2_weather_torch.training.optim import build_optimizer
    from swin_v2_weather_torch.training.step import build_eval_step, build_train_step

    params["img_shape_x"], params["img_shape_y"] = (int(s) for s in params.img_size)
    params["data_loader_config"] = "synthetic"  # temp-std takes unit stats
    model = get_model(params).to(dev)
    seeded_parameters(model, torch.Generator().manual_seed(SEED + 1))
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss_handler, preprocessor = LossHandler(params), Preprocessor(params)
    batch = collate([SyntheticDataset(params)[0]], device=dev)
    log(f"[9] train step: {CONFIG}, drop_path_rate {params.drop_path_rate}, loss "
        f"'{params.loss}', {params.optimizer_type} lr {float(params.lr)}, batch 1 "
        f"{ {k: tuple(v.shape) for k, v in batch.items()} }")

    def make_step():
        """A fresh optimizer and drop-path generator (same seed every time)."""
        optimizer = build_optimizer(params, model.parameters())
        dp_gen = torch.Generator(device=dev).manual_seed(SEED)
        return build_train_step(model, loss_handler, preprocessor, optimizer, generator=dp_gen)

    counted = (wa.window_attention_qkv, wa.window_attention_qkv_bwd, mk.fc1_gelu, mk.fc1_dpre)
    for fn in counted:
        fn.launches = 0
    train_step = make_step()
    metrics = [train_step(batch) for _ in range(N_STEPS)]
    torch.cuda.synchronize()
    train_launches = {fn.__name__: fn.launches for fn in counted}
    log(f"  {N_STEPS} steps; launches {train_launches}")
    if any(n != want for n in train_launches.values()):
        raise RuntimeError(f"each kernel must launch {want} times in {N_STEPS} train steps, "
                           f"got {train_launches}")
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    for i, m in enumerate(metrics):
        log(f"    step {i + 1}: loss {m['loss']:.6f}, grad_norm {m['grad_norm']:.6f}")
    if not all(math.isfinite(v) for m in metrics for v in m.values()):
        raise RuntimeError("non-finite loss or gradient norm")
    frozen = [n for n, p in model.named_parameters() if torch.equal(p, init[n])]
    if frozen:
        raise RuntimeError(f"parameters the steps did not change: {frozen}")
    log(f"  all {len(init)} parameter tensors changed")

    @contextlib.contextmanager
    def plain_train():
        """The autograd Functions look their wrappers up at call time: swap in
        the plain versions, forward and backward."""
        with mock.patch.multiple(
            wa, window_attention_qkv=wa.window_attention_qkv_reference,
            window_attention_qkv_bwd=wa.window_attention_qkv_backward_reference,
        ), mock.patch.multiple(mk, fc1_gelu=mk.fc1_gelu_reference, fc1_dpre=mk.fc1_dpre_reference):
            yield

    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(init[n])
    del init
    with plain_train():
        plain_step = make_step()
        plain_metrics = {k: float(v) for k, v in plain_step(batch).items()}
    if {fn.__name__: fn.launches for fn in counted} != train_launches:
        raise RuntimeError("the plain path launched a kernel")
    log("  step 1, kernel path vs plain path (relative difference):")
    for key, ref_val in plain_metrics.items():
        got = metrics[0][key]
        rel = abs(got - ref_val) / abs(ref_val)
        tol = STEP_RTOL["loss" if key == "loss" else "grad_norm"]
        log(f"    {key}: {got:.6g} vs {ref_val:.6g}, rel {rel:.3g} (tol {tol:g})")
        if not rel <= tol:
            raise RuntimeError(f"train step 1 {key}: kernel and plain path disagree")
    if set(plain_metrics) != set(metrics[0]):
        raise RuntimeError("the two paths report different metrics")

    eval_batch = collate([SyntheticDataset(params, train=False)[0]], device=dev)
    ev = build_eval_step(model, loss_handler, preprocessor, n_out)(eval_batch)
    ev = {k: v.cpu() for k, v in ev.items()}
    if ev["rmse"].shape != (n_out,) or ev["acc"].shape != (n_out,) or not all(
        bool(torch.isfinite(v).all()) for v in ev.values()
    ):
        raise RuntimeError("eval step: wrong shapes or non-finite values")
    log(f"  eval step: loss {float(ev['loss']):.6f}, mean rmse {float(ev['rmse'].mean()):.6f}, "
        f"mean acc {float(ev['acc'].mean()):.6f}")

    # ---- 10. train ms/step on both paths ------------------------------------
    def train_ms(step_fn, n: int = 3):
        step_fn(batch)  # warm-up step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            step_fn(batch)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n, torch.cuda.max_memory_allocated() / 2**30

    kernel_train, kernel_train_mem = train_ms(train_step)
    with plain_train():
        plain_train_ms, plain_train_mem = train_ms(plain_step)
    log(f"[10] train step, batch 1: kernel path {kernel_train:.2f} ms/step "
        f"({1000.0 / kernel_train:.3f} samples/s, peak {kernel_train_mem:.3f} GiB), plain path "
        f"{plain_train_ms:.2f} ms/step ({1000.0 / plain_train_ms:.3f} samples/s, peak "
        f"{plain_train_mem:.3f} GiB); {card}")

    kernels = [
        {
            "name": "window_attention_qkv",
            "route": "cuda",
            "source": "swin_v2_weather_torch/ops/csrc/window_attention_qkv.cu",
            "replaces": "swin_v2_weather_tpu/ops/window_attention.py:1142",
        },
        {
            "name": "fc1_gelu",
            "route": "cuda",
            "source": "swin_v2_weather_torch/ops/csrc/fc1_gelu.cu",
            "replaces": "swin_v2_weather_tpu/ops/mlp_kernels.py:110",
        },
        {
            "name": "window_attention_qkv_bwd",
            "route": "cuda",
            "source": "swin_v2_weather_torch/ops/csrc/window_attention_qkv_bwd.cu",
            "replaces": "swin_v2_weather_tpu/ops/window_attention.py:1397",
        },
        {
            "name": "fc1_dpre",
            "route": "cuda",
            "source": "swin_v2_weather_torch/ops/csrc/fc1_gelu.cu",
            "replaces": "swin_v2_weather_tpu/ops/mlp_kernels.py:140",
        },
    ]
    for k in kernels:
        err, k_ms, p_ms = results[k["name"]]
        # launches: the train step's run (phase 9); the serving run's beside it
        k.update(launches=train_launches[k["name"]], max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                 launches_by_path={"serve": serve_launches.get(k["name"], 0),
                                   "train": train_launches[k["name"]]})
    kernels[2]["max_abs_err_by_output"] = bwd_errs
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
