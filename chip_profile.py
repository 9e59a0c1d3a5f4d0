#!/usr/bin/env python3
"""Where the device time goes on the port's two main paths, on one NVIDIA GPU.

Run from a checkout of the repo:

    python3 chip_profile.py [SUBSTRING ...]

(with substrings, only the paths whose label contains one of them, e.g.
``"train e2048"``; the package and ``chip_smoke.py`` are imported from the
working directory, so this script also profiles another checkout's kernels
when run from that checkout's root). It needs one CUDA device and the CUDA
toolkit, as ``chip_smoke.py`` does, and builds the flagship
``swin_73var_geo_depth12_chweight_invar`` at full width on the seeded
weights ``chip_smoke.py`` draws, TF32 off. For each path, after
two warm-up steps:

  * rollout: ``RolloutEngine.steps``, batch 1, from 2018-01-01T00:00;
  * train: the ``build_train_step`` closure, batch 1, drop-path 0.1 live,
    under the config's remat policy ('mlp3'; every train path takes its
    config's); train no-remat: the same with ``activation_ckpt: false``;
  * train 2-step: the same closure on the 2-step fine-tune
    ``swin_73var_geo_depth12_chweight_invar_2step`` (the unrolled two-step
    rollout on the whole-MLP kernels K5/K6);
  * train cpb: the same closure on the flagship with ``rel_pos: True,
    full_pos_embed: False`` (the CPB family on K7, drop-path and the CPB
    dropout live), plus the time of the CPB bias assembly alone (the 12
    blocks' meta-MLP, gather and fold, forward and backward, CUDA events);
  * train lnadd: the same closure on the flagship with ``lnadd_impl:
    'fused'`` (the post-norm branches through K11);
  * train grid: the flagship on the grid route (``attn_impl: 'pallas'``: the
    qkv Dense, the per-head normalization in plain ops, K8), plus the time of
    that normalization alone (one block: ``normalize_heads`` of q and k, the
    channel slices of qkv [1, 180, 360, 2304] bf16, and ``normalize_vjp`` of
    both, CUDA events);
  * train v1: the flagship on the windowed route (``attn_impl:
    'pallas_v1'``: window partition, head split, K9, head merge, window
    reverse), plus the time of those layout moves alone (one block's
    forward: the partition of x, the head split of qkv into three contiguous
    [400, 8, 162, 96] tensors, the merge and the reverse, CUDA events);
  * train grid cpb: the grid route with the CPB (K8's BIAS instances);
  * train v1 cpb: the windowed route with the CPB (K9's BIAS instances);
  * train v6: the flagship with ``QKV_IMPL = 'v6'`` (K10 and the padded
    proj); train xla-bwd: the flagship with ``QKV_BWD_IMPL = 'xla'`` (K1,
    then K8's backward inside the plain qkv recompute and projection chain);
    train v5, train v4, train v4 padded: the flagship with ``QKV_IMPL`` 'v5'
    or 'v4' (K12; the padded v4 with ``QKV_PAD_HEADS``);
  * rollout e2048 and train e2048: ``swin_73var_geo_depth24_e2048_mlp2_chweight_invar``
    (embed 2048, 8 heads of 256, mlp_ratio 2, depth 24; K1's pass at head
    dim 256 and the large-head backward), serving at 720 x 1440 and
    training at the image [360, 720] with window 9 x 18; train e2048 grid and
    train e2048 v1: the same on the grid and windowed routes (K8/K9's
    streamed forward and large-head backward).

it prints the ms/step by CUDA events without the profiler; the host time of
one step's own work (train: the step's enqueue, with no sync in it; rollout:
one ``zenith_at`` field); then, under ``torch.profiler`` over 3 steps, the
wall ms/step, the device's busy time (the union of its kernel intervals) and
idle share, the kernel time by category and the top kernels; and the peak
device memory. Every line names the card and its power limit.
"""

from __future__ import annotations

import collections
import datetime
import math
import os
import re
import subprocess
import sys
import time

import torch

START = datetime.datetime(2018, 1, 1, 0, 0)
N_STEPS = 3  # profiled (and, before that, event-timed) steps per path

def qkv_args(name: str, kernel: str):
    """The template arguments (head dim, BIAS, head pitch, variant) of a K2
    template instance (``attention_bwd_kernel``), or None. Variant 0 is v3
    (K2, K7, K10), 1 K12 v5, 2 K12 v4."""
    m = re.search(kernel + r"<(\d+), (\w+), (\d+), (\d)>", name)
    return None if m is None else (int(m[1]), m[2], int(m[3]), int(m[4]))


def k12(name: str, kernel: str, var: int, padded: bool) -> bool:
    a = qkv_args(name, kernel)
    return a is not None and a[3] == var and (a[2] != a[0]) == padded


def fwd_pass(name: str, layout: int, bias: bool, padded: bool) -> bool:
    """Whether ``name`` is an instance of the forward template
    (``qkv_attention_fwd_kernel<HD, LAYOUT, BIAS, Z, HP>``) of the given
    layout (2: the qkv-fused forwards' one-sweep pass, K1/K7/K10/v5; 3: v4's),
    bias and head padding."""
    m = re.search(r"qkv_attention_fwd_kernel<(\d+), (\d), (\w+), (\w+), (\d+)>", name)
    return (m is not None and int(m[2]) == layout and (m[3] == "true") == bias
            and (m[5] != m[1]) == padded)


# (category, test on the kernel's name), first match wins
CATEGORIES = (
    # K8's backward on the streamed kernels (streamed_bwd.cuh; template
    # arguments <HD, FORM, BIAS, RAW, KEEP>, form 1 K8's softmax, form 0 the
    # K2 family's) or, in trees before them, the wmma kernels of namespace
    # swin_qkv_attn_large (<HD, LAYOUT, BIAS>, layout 0 the grid: the
    # large-head and the chunked ones)
    ("K8 streamed backward", lambda n: re.search(r"streamed_bwd_\w+_kernel<\d+, 1,", n) is not None
     or (re.search(r"swin_qkv_attn_large::(large|chunk)_bwd", n) is not None and ", 0, " in n)),
    # K9's backward at every head dim: the streamed kernels (form 2) or, in
    # trees before them, the wmma kernels of swin_qkv_attn_large (head dims
    # 128/256) and the one-block kernel (layout 1), and its q/k prepass
    ("K9 backward", lambda n: re.search(r"streamed_bwd_\w+_kernel<\d+, 2,", n) is not None
     or re.search(r"swin_qkv_attn_large::(large|chunk)_bwd", n) is not None
     or ("qkv_attention_bwd_kernel<" in n and ", 1, " in n)),
    ("K9 backward q/k prepass", lambda n: "swin_qkv_attn_large::normalize_kernel" in n),
    # the qkv-fused forwards' attention pass (the forward template's layouts 2
    # and 3; v5's pass is K1's instance, told apart only by the path)
    ("K1 (and v5) forward pass", lambda n: fwd_pass(n, 2, False, False)),
    ("K7 forward pass", lambda n: fwd_pass(n, 2, True, False)),
    ("K10 forward pass", lambda n: fwd_pass(n, 2, False, True)),
    ("K12 v4 forward pass", lambda n: fwd_pass(n, 3, False, False)),
    ("K12 padded v4 forward pass", lambda n: fwd_pass(n, 3, False, True)),
    # K12's backwards (K2's template with the variant argument 1 = v5, 2 = v4)
    ("K12 v5 attention pass", lambda n: k12(n, "attention_bwd_kernel", 1, False)),
    ("K12 v4 attention pass", lambda n: k12(n, "attention_bwd_kernel", 2, False)),
    ("K12 padded v4 attention pass", lambda n: k12(n, "attention_bwd_kernel", 2, True)),
    ("K13 consume", lambda n: "consume_kernel" in n),
    # K8/K9 first: K2/K7's name tests below also match their kernels' names;
    # the forward is the streamed kernel at every head dim
    ("K8 one-block backward", lambda n: "qkv_attention_bwd_kernel<" in n and ", 0, " in n),
    ("K8 forward", lambda n: "qkv_attention_fwd_kernel<" in n and ", 0, " in n),
    ("K9 forward", lambda n: "qkv_attention_fwd_kernel<" in n),
    ("K8/K9 reductions", lambda n: "attn_dscale_reduce" in n or "attn_dbias_reduce" in n),
    # the GEMM core's instances, by their epilogues: the qkv projection (the
    # K1 family's, normalizing, and the K2 family's recompute), K5's two
    # products, K6 (the core's pair kernel), and the K2 family's dx and
    # split-K dW
    # (the large-head K2's recompute keeps the norms: StoreNormBf16<.., true>)
    ("qkv projection + q/k normalization, large K2 recompute (GEMM core)",
     lambda n: "StoreNormBf16" in n and "true>" in n),
    ("qkv projection + q/k normalization, forward (GEMM core)", lambda n: "StoreNormBf16" in n),
    ("qkv projection, backward recompute (GEMM core)", lambda n: "StoreBiasBf16" in n),
    # fc1 + GELU: K3 on the single-step paths, K5's first product on the
    # others (one instance of the core)
    ("K3 / K5 fc1 (GEMM core)", lambda n: "Fc1Epilogue" in n),
    ("K5 fc2 (GEMM core)", lambda n: "Fc2Epilogue" in n),
    ("K6 (GEMM core pair kernel)", lambda n: "gemm_pair_kernel" in n),
    # the large-head backward of K2 (and K7, K12)
    ("large K2: normalization", lambda n: "normalize_qk_kernel" in n),
    ("large K2 attention", lambda n: "streamed_bwd_" in n or "large_bwd_rows_kernel" in n
     or "large_bwd_cols_kernel" in n),
    ("K10 attention pass", lambda n: k12(n, "attention_bwd_kernel", 0, True)),
    # template arguments <HD, BIAS, head pitch>: BIAS true is K7
    ("K7 attention pass", lambda n: "attention_bwd_kernel<" in n and ", true," in n),
    ("K7 dbias reduction", lambda n: "dbias_reduce_kernel" in n),
    ("K2 attention pass", lambda n: "attention_bwd_kernel" in n),
    ("K2 family dW (GEMM core)", lambda n: "StoreSplitF32" in n),
    ("K2 family dx (GEMM core)", lambda n: "StoreBf16" in n),
    ("K2/K7 reductions", lambda n: "column_sums_kernel" in n
     or "swin_qkv_proj::reduce_kernel" in n),
    ("K11 forward", lambda n: "ln_dp_add_fwd_kernel" in n),
    ("K11 backward", lambda n: "ln_dp_add_bwd_kernel" in n or "ln_dp_add_reduce_kernel" in n),
    ("K4 (GEMM core)", lambda n: "DpreEpilogue" in n),
    ("Adam (foreach)", lambda n: "multi_tensor_apply" in n or "adam" in n.lower()),
    ("cuBLAS GEMM", lambda n: any(s in n.lower() for s in ("gemm", "sm90", "nvjet", "cutlass", "xmma"))),
    ("memcpy/memset", lambda n: "Memcpy" in n or "Memset" in n),
    ("indexing (CPB gather)", lambda n: "index" in n.lower()),
    ("torch reductions", lambda n: "reduce" in n.lower()),
    # "roll" alone would also match unrolled_elementwise_kernel (copies)
    ("roll", lambda n: "roll_cuda_kernel" in n),
    ("copies and casts", lambda n: "copy_kernel" in n),
    ("torch elementwise", lambda n: "elementwise" in n.lower()),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def category(name: str) -> str:
    return next((c for c, test in CATEGORIES if test(name)), "other")


def events_ms(step, n: int) -> float:
    """Mean ms/step of n calls by CUDA events, without the profiler."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        step()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def profile_steps(label: str, step, n: int, card: str) -> None:
    """Profile n calls of step() and print the breakdown."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    kernels = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError(f"{label}: the profiler recorded no device time")
    import chip_smoke

    by_name, calls = collections.Counter(), collections.Counter()
    for ev in kernels:
        by_name[ev.name] += ev.time_range.elapsed_us()
        calls[ev.name] += 1
    busy = chip_smoke.device_busy_ms(prof) / n
    total = sum(by_name.values()) / 1e3 / n
    log(f"  profiled: wall {wall:.2f} ms/step, device busy {busy:.2f} ms/step, kernel sum "
        f"{total:.2f} ms/step, idle share {1.0 - busy / wall:.4f}; {len(kernels)} kernels "
        f"in {n} steps ({card})")
    cats = collections.Counter()
    for name, us in by_name.items():
        cats[category(name)] += us / 1e3 / n
    log("  by category (ms/step, share of the kernel sum):")
    for cat, ms in cats.most_common():
        log(f"    {cat:22s} {ms:9.2f}  {ms / total:6.3f}")
    log("  top kernels (ms/step, calls/step):")
    for name, us in by_name.most_common(20):
        log(f"    {us / 1e3 / n:9.2f}  {calls[name] / n:5.0f}  {name[:140]}")


def cpb_assembly_ms(core, dev, n: int) -> float:
    """Mean ms of one step's CPB bias assembly, forward and backward, for every
    block of ``core`` (the model's own cpb_bias with train-mode dropout), by
    CUDA events; it adds into the parameters' gradients, which the caller
    discards."""
    gen = torch.Generator(device=dev).manual_seed(0)
    u = core.drop_noise(1, gen, dev)["cpb"]
    blocks = list(core.blocks)

    def assembly():
        outs = [blk.attn.cpb_bias(torch.exp(torch.clamp(blk.attn.logit_scale, max=math.log(100.0))),
                                  u[i]) for i, blk in enumerate(blocks)]
        torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])

    assembly()
    return events_ms(assembly, n)


def grid_normalization_ms(dev, n: int) -> float:
    """Mean ms of the grid route's per-head L2 normalization of q and k and its
    VJP for one flagship block, by CUDA events (both run in plain ops around
    K8)."""
    from swin_v2_weather_torch.ops.window_attention import normalize_heads, normalize_vjp

    gen = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn((1, 180, 360, 2304), generator=gen, device=dev).bfloat16()
    dqn = torch.randn((1, 180, 360, 768), generator=gen, device=dev).bfloat16()

    def norm():
        for t in (qkv[..., :768], qkv[..., 768:1536]):
            tn, inv = normalize_heads(t, 8)
            normalize_vjp(tn, inv, dqn, 8, tn.dtype)

    norm()
    return events_ms(norm, n)


def layout_moves_ms(dev, n: int) -> float:
    """Mean ms of the windowed route's layout moves for one flagship block's
    forward, by CUDA events: window_partition of x [1, 180, 360, 768] bf16,
    the head split of qkv [400, 162, 2304] into three contiguous [400, 8, 162,
    96] tensors, then the head merge and window_reverse of the output."""
    from swin_v2_weather_torch.models.swin import window_partition, window_reverse

    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1, 180, 360, 768), generator=gen, device=dev).bfloat16()
    qkv = torch.randn((400, 162, 2304), generator=gen, device=dev).bfloat16()
    out = torch.randn((400, 8, 162, 96), generator=gen, device=dev).bfloat16()

    def moves():
        window_partition(x, (9, 18)).reshape(-1, 162, 768).contiguous()
        for t in qkv.reshape(400, 162, 3, 8, 96).permute(2, 0, 3, 1, 4):
            t.contiguous()
        window_reverse(out.transpose(1, 2).reshape(400, 9, 18, 768), (9, 18), (180, 360))

    moves()
    return events_ms(moves, n)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from swin_v2_weather_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0].strip()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.time()
    _build.load_library()
    log(f"kernels built and loaded in {time.time() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    n = N_STEPS
    only = sys.argv[1:]

    def wanted(label: str) -> bool:
        return not only or any(sub in label for sub in only)

    if wanted("rollout"):
        rollout(chip_smoke.train_params(chip_smoke.CONFIG), dev, n, card)
    if wanted("rollout e2048"):
        rollout(chip_smoke.train_params(chip_smoke.CONFIG_E2048), dev, n, card, e2048=True)
    train_paths(wanted, dev, n, card)


def rollout(params, dev, n: int, card: str, e2048: bool = False) -> None:
    """Profile the rollout of ``params`` (the flagship, or the e2048 family
    on weights drawn on the card)."""
    import chip_smoke
    from swin_v2_weather_torch.inference.rollout import RolloutEngine
    from swin_v2_weather_torch.models.wrappers import get_model

    model = get_model(params)
    label = "rollout e2048" if e2048 else "rollout"
    weights = torch.Generator(device=dev) if e2048 else torch.Generator()
    chip_smoke.seeded_parameters(model, weights.manual_seed(chip_smoke.SEED))
    engine = RolloutEngine(params, model, dev)
    state0 = torch.randn((1, int(params.n_out_channels), *params.img_size),
                         generator=torch.Generator().manual_seed(chip_smoke.SEED))
    steps = engine.steps(state0, START, 2 + 2 * n)
    log(f"[{label}] {chip_smoke.CONFIG_E2048 if e2048 else chip_smoke.CONFIG}, "
        f"{tuple(params.img_size)}, batch 1")
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        next(steps)
    log(f"  unprofiled: {events_ms(lambda: next(steps), n):.2f} ms/step ({card})")
    if not e2048:
        t0 = time.perf_counter()
        for _ in range(3):
            engine.zenith_at(START)
        log(f"  host zenith_at: {(time.perf_counter() - t0) * 1e3 / 3:.1f} ms per step")
    profile_steps(label, lambda: next(steps), n, card)
    log(f"  peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del engine, model, steps
    torch.cuda.empty_cache()


def train_paths(wanted, dev, n: int, card: str) -> None:
    """Profile each train path whose label ``wanted`` accepts."""
    import chip_smoke
    from swin_v2_weather_torch.data.preprocess import Preprocessor
    from swin_v2_weather_torch.data.synthetic import SyntheticDataset, collate
    from swin_v2_weather_torch.models.wrappers import get_model
    from swin_v2_weather_torch.ops.losses import LossHandler
    from swin_v2_weather_torch.training.optim import build_optimizer
    from swin_v2_weather_torch.training.step import build_train_step

    # ---- train steps: single-step, the 2-step fine-tune, the CPB family ------
    # (label, config, overrides, qkv switches (QKV_IMPL, QKV_BWD_IMPL, QKV_PAD_HEADS))
    from swin_v2_weather_torch.ops import window_attention as wa
    from swin_v2_weather_torch.ops.attic import window_attention_v45 as v45

    for label, config, over, switches in (
            ("train", chip_smoke.CONFIG, None, ("v3", "pallas", False)),
            ("train no-remat", chip_smoke.CONFIG, {"activation_ckpt": False},
             ("v3", "pallas", False)),
            ("train 2-step", chip_smoke.CONFIG_2STEP, None, ("v3", "pallas", False)),
            ("train cpb", chip_smoke.CONFIG, chip_smoke.CPB, ("v3", "pallas", False)),
            ("train lnadd", chip_smoke.CONFIG, chip_smoke.LNADD, ("v3", "pallas", False)),
            ("train grid", chip_smoke.CONFIG, chip_smoke.GRID_ROUTE, ("v3", "pallas", False)),
            ("train grid cpb", chip_smoke.CONFIG, {**chip_smoke.GRID_ROUTE, **chip_smoke.CPB},
             ("v3", "pallas", False)),
            ("train v1", chip_smoke.CONFIG, chip_smoke.V1_ROUTE, ("v3", "pallas", False)),
            ("train v1 cpb", chip_smoke.CONFIG, {**chip_smoke.V1_ROUTE, **chip_smoke.CPB},
             ("v3", "pallas", False)),
            ("train v6", chip_smoke.CONFIG, None, ("v6", "pallas", False)),
            ("train xla-bwd", chip_smoke.CONFIG, None, ("v3", "xla", False)),
            ("train v5", chip_smoke.CONFIG, None, ("v5", "pallas", False)),
            ("train v4", chip_smoke.CONFIG, None, ("v4", "pallas", False)),
            ("train v4 padded", chip_smoke.CONFIG, None, ("v4", "pallas", True)),
            ("train e2048", chip_smoke.CONFIG_E2048, chip_smoke.E2048_TRAIN,
             ("v3", "pallas", False)),
            ("train e2048 grid", chip_smoke.CONFIG_E2048,
             {**chip_smoke.E2048_TRAIN, **chip_smoke.GRID_ROUTE}, ("v3", "pallas", False)),
            ("train e2048 v1", chip_smoke.CONFIG_E2048,
             {**chip_smoke.E2048_TRAIN, **chip_smoke.V1_ROUTE}, ("v3", "pallas", False))):
        if not wanted(label):
            continue
        wa.QKV_IMPL, wa.QKV_BWD_IMPL, v45.QKV_PAD_HEADS = switches
        params = chip_smoke.train_params(config, over)
        model = get_model(params)
        # the e2048 weights (943.5 M) are drawn on the card, the others on the CPU as before
        gen = torch.Generator(device=dev if config == chip_smoke.CONFIG_E2048 else "cpu")
        chip_smoke.seeded_parameters(model, gen.manual_seed(chip_smoke.SEED + 1))
        train_step = build_train_step(
            model, LossHandler(params), Preprocessor(params),
            build_optimizer(params, model.parameters()),
            generator=torch.Generator(device=dev).manual_seed(chip_smoke.SEED),
        )
        batch = collate([SyntheticDataset(params)[0]], device=dev)
        log(f"[{label}] {config} {over or ''}, QKV_IMPL {switches[0]}, QKV_BWD_IMPL "
            f"{switches[1]}, QKV_PAD_HEADS {switches[2]}, batch 1, drop_path_rate "
            f"{params.drop_path_rate}")
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            train_step(batch)
        log(f"  unprofiled: {events_ms(lambda: train_step(batch), n):.2f} ms/step ({card})")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(batch)
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        log(f"  host enqueue of one step: {host:.1f} ms of "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms wall")
        profile_steps(label, lambda: train_step(batch), n, card)
        log(f"  peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        if over == chip_smoke.CPB:
            log(f"  CPB bias assembly alone (meta-MLP, gather, fold; {len(model.model.blocks)} "
                f"blocks, forward and backward): {cpb_assembly_ms(model.model, dev, n):.2f} "
                f"ms/step ({card})")
        if over == chip_smoke.GRID_ROUTE:
            log(f"  grid-route normalization alone (normalize_heads and normalize_vjp of q "
                f"and k, one block): {grid_normalization_ms(dev, 10):.3f} ms ({card})")
        if over == chip_smoke.V1_ROUTE:
            log(f"  windowed-route layout moves alone (partition, head split, merge, reverse of "
                f"one block's forward): {layout_moves_ms(dev, 10):.3f} ms ({card})")
        del model, train_step, batch
        torch.cuda.empty_cache()
    wa.QKV_IMPL, wa.QKV_BWD_IMPL, v45.QKV_PAD_HEADS = "v3", "pallas", False


if __name__ == "__main__":
    main()
