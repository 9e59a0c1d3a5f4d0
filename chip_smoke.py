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
     with nvcc (first use builds into ``swin_v2_weather_torch/_build/``);
     every instance of the GEMM core (its pair kernel, K6, and K3/K4's
     instances included), of K2's attention pass, of the qkv-fused
     forward's attention pass (K1, K7, K10, K12) and of the streamed
     backwards (``streamed_bwd.cuh``: the qkv-fused family's K2/K7/K10/K12,
     K8's and K9's, at head dims 32-256, rows kernels with and without z and
     dp kept in registers) must show 0 bytes spilled in the ``-Xptxas -v``
     log.
  3. the window-attention kernel (K1: the projection on the GEMM core, then
     the streamed attention pass) against its plain version at the flagship
     shapes, unshifted and with the shifted-block mask; its breakdown by
     torch.profiler (projection and pass, device ms a launch) and the pass's
     launch report (as phase 20's), with the host us of a call of the
     wrapper and of the same launch through its custom op
     (``swin::window_attention_qkv``, the serving forward's call).
  4. the fc1+GELU kernel (K3, one launch of the GEMM core) against its plain
     version at [64800, 768] x [768, 3072], timed beside its bound and
     ``torch.matmul`` of the same operands (the yardstick; the port never
     calls it); the host us of a call, direct and through ``swin::fc1_gelu``.
  5. flagship serving: ``swin_73var_geo_depth12_chweight_invar`` at full width
     (77 -> 73 channels, 720x1440, embed 768, depth 12) built through
     ``get_model``, every parameter drawn from a seeded generator (LayerNorm
     scales non-zero, so no block is the identity), the weights round-tripped
     through the JAX layout, then ``RolloutEngine.rollout`` for 4 steps from
     2018-01-01T00:00. Each kernel must have launched 12 x 4 = 48 times, the
     GEMM core as often as those launches imply (``check_core``: K1's
     projection and K3, 96; every path below is checked the same way),
     every output must be finite, and step 1 must match the plain path on
     the card.
  6. rollout ms/step on both paths (CUDA events, after one warm-up step) and
     the peak device memory.
  7. the window-attention backward kernel against its plain backward at the
     flagship shapes, unshifted and shifted: dx, dW, db and dscale; its
     breakdown by torch.profiler (the projection, attention pass, dx, dW, db
     column sums and reductions, device ms a launch).
  8. the fc1 backward (pre-activation cotangent) kernel (K4, one launch of
     the GEMM core) against its plain version at [64800, 768] x [768,
     3072]; two calls bit-equal; timed as phase 4.
  9. the flagship train step at full width, drop-path 0.1 live, built through
     ``get_model``, ``LossHandler`` (synthetic unit stats), ``Preprocessor``,
     ``build_optimizer`` and ``build_train_step``, on seeded parameters and a
     batch of 1 from ``SyntheticDataset``, under the config's remat policy
     ('mlp3', which keeps ``attn_kernel_out`` and ``mlp_out``): 4 steps, K1
     launched 18 times a step (the 6 shifted blocks' attention runs again in
     the backward), K3 24 (every block's), K2 and K4 12, K5/K6 never,
     finite metrics, every parameter moved; step
     1's loss and gradient norms against the plain path on the card (same
     weights, batch and generator seed, so the drop-path masks agree); one
     ``build_eval_step`` call.
 10. train ms/step on both paths (CUDA events, after one warm-up step),
     samples/s and the peak device memory.
 11. the whole-MLP kernels, forward (K5) and backward (K6), against their
     plain versions at [64800, 768] x [768, 3072] x [3072, 768], timed; K5's
     breakdown (its fc1 and fc2 products on the GEMM core) and K6's (one
     launch of the core's pair kernel: both products); two K6 calls
     bit-equal.
 12. the 2-step fine-tune ``swin_73var_geo_depth12_chweight_invar_2step``
     (unrolled rollout, whole-MLP route) as in phases 9-10: 3 steps, K1
     launched 36 times a step ('mlp3': the shifted blocks' again), K2, K5
     (one kernel call with a kept output) and K6 24, K3/K4 never; step 1
     against the plain path; one eval step; ms/step, samples/s and peak
     memory on both paths.
 13. the 4-step fine-tune ``..._4step`` (looped rollout, each step's model
     call under the checkpoint, the block remat nested inside) at depth 4
     (``ROUTE_DEPTH``; phase 49 runs the 8-step's loop at depth 12): 2
     steps, K1 launched 40 times a step (16 forward, 16 in the steps'
     recompute, 8 in the blocks' recompute inside it), K5 32, K2 and K6
     16; step 1 against the plain path; ms/step and peak memory of the
     kernel path.
 14. the depth-24 single-step train step, ``swin_73var_geo_depth24_chweight_invar``
     (whole-MLP route): 3 steps, K1 launched 36 times a step, K2, K5 and K6
     24;
     finite metrics, every parameter moved; ms/step and peak memory.
 15. K7, the CPB-bias instances of the window-attention kernels, forward and
     backward against their plain versions at the flagship shapes, unshifted
     and shifted, with a seeded bias folded as the model folds it: out, dx,
     dW, db, dscale and dbias; two backward calls bit-equal; timed.
 16. CPB serving: the flagship config with ``rel_pos: True, full_pos_embed:
     False`` (bench.py's ``cpb_rel_pos`` row), 4 rollout steps: K7 forward and
     K3 launched 48 times, K1 never; step 1 against the plain path; ms/step
     and peak memory.
 17. CPB training, the same config, 4 steps with drop-path 0.1 and the CPB
     meta-MLP's dropout live, at depth 4: K7 forward 6 times a step, K3 8,
     K7 backward and K4 4, K1, K2, K5 and K6 never; step 1 against the plain
     path; every
     parameter moved, ``meta_mlp`` included; ms/step, samples/s and peak on
     both paths.
 18. K11, the fused LayerNorm + drop-path + residual add, forward and backward
     against their plain versions at [64800, 768] with m mixed between 0 and
     1/keep; two backward calls bit-equal; timed, beside ``F.layer_norm`` at
     the same shape for context. Then the same at [64800, 3072], rows wider
     than 2048 channels (the backward staging z and g in shared memory,
     read once), two backward calls bit-equal.
 19. the flagship train step with ``lnadd_impl: 'fused'``: 3 steps, K11
     forward 48 times a step ('mlp3' keeps only ``attn_kernel_out`` beside
     the fused branches, so both run again) and backward 24, K1 18, K3 24,
     K2 and K4 12; step 1 against the plain
     path; ms/step and peak memory beside phase 10's unfused step.
 20. K8, the grid route's attention (bias-free and BIAS instances), forward
     and backward against their plain versions at the flagship shapes (qn, kn
     normalized per head and v a channel slice of one [1, 180, 360, 2304]
     qkv tensor, read in place; 8 heads of 96, window 9 x 18; a seeded raw
     bias), unshifted and shifted: out, dq, dk, dv, dscale and dbias; two
     backward calls bit-equal; timed, beside ``scaled_dot_product_attention``
     on the windowed tensors (its forward, and its backward alone: the graph
     recorded once, only ``torch.autograd.grad`` timed; null with the reason
     where no backend takes the shape). Each forward instance's launch is printed:
     threads a block, dynamic shared memory, registers, local (spill) bytes
     (``cudaFuncGetAttributes``), resident blocks per SM
     (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), blocks per (window,
     head), and the wrapper's host us per call beside the kernel's ms; every
     forward instance must show 0 bytes spilled in the ``-Xptxas -v`` log.
     The backward (the streamed kernels, form FORM_GRID) prints its launch
     report the same way (``grid_streamed_bwd_info``: each kernel's shared
     memory, registers, local bytes, which must be 0, and resident blocks
     per SM) and its breakdown by torch.profiler (the rows and columns
     kernels, the reductions) beside SDPA's backward.
 21. the grid route on the flagship (``attn_impl: 'pallas'``) at depth 4
     (phases 21-26, 31, 32, 36 and 42 c run the flagship's route variants
     at ``ROUTE_DEPTH``): 4 rollout steps (K8 forward and K3 16 times, K1
     never), step 1 against the plain path; then 3 train steps with
     drop-path 0.1 live: K8 forward and K3 8 times a step (run again in the
     backward), K8 backward and K4 4,
     K1/K2/K7/K9 never; step 1 against the plain
     path; every parameter moved; ms/step, samples/s and peak memory.
 22. the grid route with the CPB (``rel_pos: True, full_pos_embed: False``):
     2 train steps on K8's BIAS instances, ``meta_mlp`` moved.
 23. K9, the windowed route's attention, as phase 20 on q, k, v [400, 8, 162,
     96] (normalized inside the kernels), with the same launch report, the
     streamed backward's launch report (threads, blocks per (window, head),
     each kernel's shared memory, registers, local bytes and resident blocks
     per SM from the CUDA runtime) and its breakdown by torch.profiler (the
     q/k prepass, the rows and columns kernels, the reductions) beside SDPA's
     backward.
 24. the windowed route (``attn_impl: 'pallas_v1'``) as phase 21, on K9.
 25. the windowed route with the CPB, as phase 22, on K9's BIAS instances.
 26. the ``'xla'`` route: one rollout step at full width, no attention kernel
     launched, K3 4 times, the output finite.
 27. the e2048 widths against their plain versions, timed: K1/K2 at x [1,
     180, 360, 2048], W_qkv [2048, 6144], 8 heads of 256, window 9 x 18 (K1's
     pass at head dim 256 with its breakdown, K2's streamed variant),
     shifted, with its breakdown by torch.profiler (the recompute with the
     q/k normalization, the rows and columns kernels, dx, dW, the
     reductions), and one K7 case (forward and backward,
     shifted); K5/K6 at [64800, 2048] x [2048, 4096] x [4096, 2048]; two
     backward calls bit-equal; then K2, K5, K6 and the
     K8/K9 backwards at head dim 256 timed at the e2048 train steps' own shape
     (the image [360, 720]: x [1, 90, 180, 2048], T = 16200), K2's, K8's and
     K9's with their breakdown, beside SDPA's backward at that shape; and
     K2, K7 and v4 at head dim 128 (8 heads, L = 162: the streamed variant)
     against their plain versions, timed.
 28. e2048 serving, ``swin_73var_geo_depth24_e2048_mlp2_chweight_invar`` at
     full size (720 x 1440, embed 2048) cut to depth 6 (``E2048_DEPTH``,
     its whole-MLP route kept; phases 28, 29, 34 and 42 a): 2 rollout
     steps, K1 and K5 6 times a step, K3 never, output finite, step 1
     against the plain path.
 29. e2048 training at full width at the image [360, 720] (window ratio 40:
     window 9 x 18 on 90 x 180 tokens, L = 162), depth 6: 2 steps with
     drop-path 0.1; under 'full' K1 and K5 12 times a step, K2 and K6 6;
     step 1 against the
     plain path; every parameter moved; ms/step and peak memory.
 30. K10, the v6 padded-head kernels, forward and backward against their
     plain versions at the flagship shape (x [1, 180, 360, 768], 8 heads of
     96, padded to 128), shifted: out's pad lanes and dWp's / dbp's pad
     columns exactly zero (g's pad lanes random); two backward calls
     bit-equal; timed beside K1/K2 of phases 3 and 7.
 31. the flagship with ``QKV_IMPL = 'v6'`` at depth 4: 4 rollout steps, then
     3 train steps; K10 forward 4 times a rollout step and 6 a train step,
     backward 4, K1/K2 never; step 1
     against the plain path; ms/step, samples/s and peak memory.
 32. the flagship with ``QKV_BWD_IMPL = 'xla'`` at depth 4: 3 train steps,
     K1 6 and K8's backward 4 times a step, K2 never; then 2 CPB train
     steps: K7's forward 6 and K8's BIAS backward 4 times a step, K7's
     backward never;
     step 1 of
     each against the plain path.
 33. K8 and K9 (bias-free and BIAS) at head dims 128 (8 heads, C = 1024)
     and 256 (the e2048 tensors, [1, 180, 360, 2048]) with L = 162, shifted,
     forward (the streamed kernel) and backward (K8's streamed kernels,
     K9's streamed kernels) against their plain versions; two backward
     calls bit-equal; timed beside ``scaled_dot_product_attention`` on the
     same windowed tensors (forward and backward, as phase 20), with phase
     20's launch report (and phase 23's for K9's backward) and each
     backward's breakdown by torch.profiler (K9's q/k prepass, the rows and
     columns kernels, the d(scale) and d(bias) reductions).
 34. the e2048 family at [360, 720], depth 6, on ``attn_impl: 'pallas'`` and
     then ``'pallas_v1'``: 2 train steps each under 'full', K8 (or K9)
     forward and K5 12 times a step, their backwards 6; step 1 against the
     plain
     path; every
     parameter moved; ms/step and peak memory.
 35. K12 at the flagship shape (x [1, 180, 360, 768], W_qkv [768, 2304], 8
     heads of 96, window 9 x 18, shifted): v5, v4 (window-major rows) and the
     padded v4, forward and backward against their plain versions; v5 bit-
     equal to K1/K2 of the same inputs; dxw's pad rows and the padded v4's pad
     lanes and pad columns exactly zero; two backward calls bit-equal; timed
     beside K1/K2 of phases 3 and 7.
 36. the flagship with ``QKV_IMPL`` 'v5', 'v4', then 'v4' with
     ``QKV_PAD_HEADS``, at depth 4: 2 rollout steps and 3 train steps each,
     the selected K12 kernel's forward 4 times a rollout step and 6 a train
     step, its backward 4, K1/K2 never; step 1 against the plain path;
     ms/step, samples/s and peak memory; then two CPB train steps with
     ``QKV_IMPL = 'v4'``: K7 forward 6 and backward 4 times a step, K12
     never.
 37. K13: ``consume`` bit-exact to its plain version at [3, 1, 400, 8, 168,
     96], timed beside ``torch.sum(s, 0)``; then the prestage probe
     (``swin_v2_weather_torch.scripts.prestage_probe.probe``): the round trip
     and ``consume`` alone, each beside its byte bound.
 38. the Hopper GEMM core alone (``gemm_core.gemm``) against its plain
     version at K5's shapes (fc1 at e2048 [64800, 2048] x [2048, 4096], fc1
     and fc2 at the flagship), K1's projection ([64800, 768] x [768, 2304])
     and K2's (dx with W read K-major, dW split-K
     with x read MN-major), each timed beside ``torch.matmul`` at the same
     shape (the library yardstick; the port never calls it), with its share
     of the bf16 peak.
 39. the backwards past L = 256 (window 12 x 24, L = 288, on a [1, 24, 48]
     grid, 2 heads, shifted) at head dims 32-256, every one the streamed
     kernels of ``streamed_bwd.cuh``: the qkv-fused family's (K2, K7, v5,
     v4, and up to head dim 128 K10 and the padded v4) and K8's and K9's
     (bias-free and BIAS), each once against its plain version, two calls
     bit-equal, timed beside its bound (the padded variants' pad columns
     exactly zero); K8's and K9's beside SDPA's backward on the windowed
     tensors [4, 2, 288, hd] (``library_ms``). Then at L = 288 at full
     width: window 12 x 24 on [1, 180, 360, C] (225 windows), 8 heads of 96
     (C = 768) and of 256 (C = 2048), shifted: K8 and K9 (bias-free and
     BIAS; K9 on the windowed [225, 8, 288, hd]) beside SDPA's backward, and
     the qkv-fused family (at head dim 96 K2, K7, v5, v4, K10 and the padded
     v4; at 256 K2 and K7), each against its plain version, two calls
     bit-equal, timed beside the bound, with its breakdown by
     torch.profiler (the qkv family's: the projection, the rows and columns
     kernels, dx, dW, db and the reductions).
 40. the Trainer end to end (``swin_v2_weather_torch.training.trainer``), the
     way a user trains, in a temporary directory under the checkout's
     ``runs/`` (removed at the end): the flagship at full width cut to
     depth 4 (``TRAINER_DEPTH``, with phases 41 and 44, which use its run;
     the synthetic loader paces its steps), synthetic data (4 train and 4
     validation samples an epoch, batch 1), drop-path
     0.1, checkpoints on, through ``Trainer(...).build_and_launch()`` for 2
     epochs: 2 finite ``logs.jsonl`` lines with ``valid_rmse_u10m``,
     ``ckpt``, ``best_ckpt`` and ``hyperparams.yaml`` written, K1 6, K3
     8, K2 and K4 4 times a train step (the config's 'mlp3') and K1/K3 4
     times a validation step (nothing checkpointed with grad mode off; K5/K6
     never, the GEMM core as ``check_core`` implies), no plain version
     called, every parameter moved from the Trainer's seeded initialization,
     and every batch, train and validation, equal on the device to the host
     batch the loader handed over (exact checksums of the fp32 bits); the
     checkpoint's save-blocking and background-write ms. Then the resume
     (``max_epochs: 3``: the log names ``ckpt``, the run continues at epoch
     2), timed by CUDA events over the epoch's steps after the first (the
     Trainer's ms/step, loader waits included);
     a run preempted at step 2 of epoch 0 by an injected trigger, resumed,
     whose final parameters must be bit-equal to the first run's, with a
     torch.profiler window over 3 of its steps (the device's idle share, as
     chip_profile.py computes it, and its busy ms a step, which the loader's
     ms/batch is set beside); one epoch of the 2-step fine-tune from the
     first run's ``best_ckpt`` (``finetune: true``: the weights, and only
     the weights, loaded; K1 12, K2, K5 and K6 8 times a train step, K1/K5
     8 a validation step, K3/K4 never); the loader alone on the host (ms/batch
     over an epoch of 5, and one sample on one thread); one batch's H2D copy
     from the pinned ring and from pageable memory; and one epoch on a
     full-resolution ERA5-shaped archive (2 yearly files of 3 samples,
     [73, 721, 1440]) that ``data/hdf5.create_contiguous`` writes frame by
     frame (no h5py on the card's machine), through ``data_loader_config:
     threaded`` and the native reader (its file probe the pure-numpy HDF5
     reader): K1 6, K3 8, K2 and K4 4 launches a train step and K1/K3 4 a
     validation step, no plain version, finite logs; its ms/step (CUDA
     events), idle share (torch.profiler over 3 steps), peak memory and the
     ERA5 loader's ms/batch alone. Its numbers, with the card, in one
     ``{"trainer": {...}}`` JSON line.
 41. inference from phase 40's first run (its directory kept until this
     phase ends), the user journey of JAX's ``scripts/tpu_e2e_check.py``:
     ``export_model`` -> ``load_model(..., "cuda")`` (weights equal to
     ``best_ckpt``'s; seeded statistics and climatology written into the
     registry); ``score_rollout`` over 8 steps from 2018-01-01T00:00 on
     seeded targets, host-stepped and chunked (chunk 4): RMSE and ACC [8,
     73] finite and bit-equal, the chunked predictions bit-equal to the
     stepped ones, K1 and K3 4 x 8 times each (the GEMM core as
     ``check_core`` implies), step 1 against the plain path, and a scored
     step's parts (the host's zenith, the target's copy from pageable
     memory, the step and the scoring on the device); ``write_forecast``
     of 8 steps and 3 named channels (the fields equal
     to the stepped predictions denormalized on the host, JAX's metadata);
     an ensemble of M = 5 (two pairs), Gaussian and bred (one cycle at batch
     3), each through ``score_ensemble`` over 4 steps with chunk 2 (every
     key finite, spread positive, K1 and K3 4 a step at batch 5), the
     batch-5 step's members against batch-1 steps and the batch against the
     plain path, and the batch-5 step's parts (the step, CRPS and spread);
     ``export_stepper`` (the graph calls
     ``swin::window_attention_qkv`` and ``swin::fc1_gelu`` 4 times each and
     no plain attention or GELU), ``load_stepper`` in this process (K1/K3
     4 launches a call, output bit-equal to the engine's step; ms/step
     beside the engine's, CUDA events) and in a fresh process that imports
     no model module (bit-equal, launches, ms/step); the CLI's
     ``--export-stepper`` (``--device cuda`` by default) and its scoring leg
     with ``--ensemble 3`` on an ERA5-shaped archive written by
     ``hdf5.create_contiguous`` and read through the native reader (K1/K3
     4 a step at batch 3, finite scores). Its numbers, with the card, in
     one ``{"inference": {...}}`` JSON line.
 42. the training options the configs ask for, on one card, after a line
     with the memory the earlier phases still hold (allocated, and the
     largest CUDA tensors the garbage collector reaches). (a) The e2048
     family, ``swin_73var_geo_depth24_e2048_mlp2_chweight_invar``, as
     written but cut to depth 6 (``E2048_DEPTH``; 720 x 1440,
     ``shard_params: True``, a no-op on one process, ``remat_policy:
     'full'``, drop-path 0.1) through phase 9's calls: 3 steps, K1 and K5
     12 times a step, K2 and K6 6, finite
     metrics, every parameter moved, step 1 against the plain path, ms/step
     and peak memory; then two steps of the same config under its remat
     and with ``activation_ckpt: false``: the second step's peak memory at
     the end of its forward, backward and optimizer step, or the stage
     where it ran out of memory (a measurement, not a check). (b) The
     flagship at full width, cut to depth 4 (``REMAT_DEPTH``), from the
     same weights and batch without remat (twice), under
     'full', 'attn', 'mlp' and 'mlp3', and with ``mlp_impl: 'plain'``
     without remat and under 'mlp_fc1': 2 steps each, the gradients of both
     steps (copied to the host) bit-equal to the unrematted model's of the
     same MLP route, the
     launches a step (K1 8 and K3 8 under 'full' and 'attn', K1 6 and K3 8
     under 'mlp' and 'mlp3', K1 6 under 'mlp_fc1'), ms/step and peak
     memory (phases 35 and 39 free their operands, so the card holds
     nothing of theirs here). (c) LAMB (``optimizer_type: 'lamb'``) on the flagship at depth 4: 3
     steps, finite, every parameter moved, ms/step. (d) The H1 loss (the
     ``'h1'`` word) of the flagship's prediction for one batch on the card
     against the same tensors' loss on the CPU in fp64 (relative bound
     1e-4), timed, and its gradient finite. Its numbers, with the card, in
     one ``{"training_options": {...}}`` JSON line.
 43. the parallel layer (``swin_v2_weather_torch/parallel``, ``shard_state``)
     on the flagship at full width under its 'mlp3' remat, in ranks this
     script starts (``python -m swin_v2_weather_torch.scripts.parallel_check``
     each; the kernel library is built here first, so no rank builds it).
     Each rank first takes the plain single-process step on the whole
     sample (the reference), then the variant's 4 steps from the same
     weights and drop-path seed, its launch counts reset just before them.
     (a) One rank over NCCL (``init_process_group("nccl")``, world size 1):
     DDP, ZeRO-1 (``shard_opt_state``) and FSDP2 (``shard_params``): step
     1's loss and every gradient bit-equal to the reference (FSDP2: within
     the bound below where not bit-equal); K1 18, K3 24, K2 and K4 12
     launches a step, the GEMM core as ``check_core`` implies; ms/step and
     peak GiB beside phase 10's bare step; then the Trainer on that group
     (DDP with ZeRO-1) for one epoch of 2 steps: finite metrics, the
     checkpoint written. (b) Two ranks sharing the card
     over gloo (NCCL refuses two ranks on one device), ``spatial_shards:
     2``, ``mesh_shape: [1, 2]``: each rank a band of 90 token rows (10
     window rows), the halos through host copies; rank 0 launches K1/K2 on
     its shifted blocks with ``boundary_flag`` 0.0 and rank 1 with 1.0 (the
     flags recorded per call); step 1's loss within 1e-4 and each gradient
     within 2e-2 of its largest entry of the reference (``SPATIAL_TOL``);
     the same launches a step on each rank; ms/step, each rank's peak, the
     halo bytes a step and the ms of their exchanges alone, timed on a
     fifth step from a synchronized card and a barrier of the ranks before
     each exchange (the two ranks time-share one
     card: a proof of correctness and a measure of overhead, not of
     scaling). (c) K1/K2 with ``boundary_flag`` 0.0 at the band shape [1,
     90, 360, 768], shifted, against their plain versions (the kernels'
     outputs also bit-equal to the unmasked call's: a gate of 0 is no
     mask), timed beside the bound. Its numbers, with the card, in one
     ``{"parallel": {...}}`` JSON line.
 44. the JAX checkpoint interchange (``training/interchange.py``) at full
     width: phase 40's epoch-2 checkpoint (kept before its resume) exported
     by ``checkpoint_to_jax`` in JAX's scanned layout (the blocks stacked as
     2 pairs at depth 4) and imported back by ``checkpoint_from_jax``; the
     flagship Trainer resumes one epoch from the import (K1 6, K3 8, K2/K4
     4 a train step, K1/K3 4 a validation step, no plain version) and its
     epoch-3 checkpoint must be bit-equal, every tensor and counter, to the
     one phase 40's resume of its own checkpoint wrote; then
     ``registry_to_jax`` -> ``registry_from_jax`` -> ``load_model`` on a
     registry of phase 40's run: one served step (K1/K3 4 launches)
     bit-equal to the original registry's. Its numbers, with the card, in
     one ``{"interchange": {...}}`` JSON line. (The orbax files themselves
     are written and read by ``orbax_bridge.py`` where JAX is installed; the
     card's machine has neither.)
 45. the served artifact of every route (``SERVED_ROUTES``), at full width,
     batch 1, seeded weights, live zenith: the CPB flagship (K7, K3), the
     grid route with and without the CPB (K8), the windowed route likewise
     (K9), v6 (K10), v5, v4 and padded v4 (K12), ``lnadd_impl: 'fused'``
     (K11, K1, K3), each the flagship at depth 4, then the 2-step
     fine-tune's single-step model (K5, K1) and the e2048 flagship (K1 at
     head dim 256, K5 at 2048 -> 4096 -> 2048), each also at depth 4 (the
     artifacts in the run's directory under ``runs/``, each removed after
     its checks). For each: ``export_stepper``
     (no kernel launched while tracing) and ``load_stepper`` in this
     process, timed, and the artifact's bytes; the graph calls exactly the
     route's ``swin::`` ops, as many times as the route launches them, and
     no plain attention or GELU; one served call launches them so (the
     GEMM core as ``check_core`` implies) and is bit-equal to the engine's
     step; served and engine ms/step (CUDA events). The 2-step artifact
     again in a fresh process that imports no model module (bit-equal, its
     launches, ms/step); the CPB artifact refuses a CPU load. Then
     ``platforms=("cuda", "cpu")`` on the flagship at depth 2: the CUDA
     program bit-equal to the engine's step, the CPU program (no custom op:
     the plain versions) within ``MODEL_TOL`` of it, ``("tpu",)`` refused;
     and each new op's host us a call at the flagship shapes, direct and
     through the op (both bit-equal). Its numbers, with the card, in one
     ``{"served_routes": {...}}`` JSON line.
 46. train-mode dropout (JAX's ``nn.Dropout`` sites; ``SwinTransformerV2``
     built with ``proj_drop_rate`` 0.1 and ``attn_drop_rate`` 0, as only
     direct construction sets them) on the flagship at full width under
     its 'mlp3': 3 steps with the launches of phase 9 (K1 18, K2 12, K3 24,
     K4 12 a step), every dropout mask's kept share within ``KEEP_SIGMAS``
     standard deviations of 0.9 (each site's mask of each call, recomputed
     ones included), step 1 against the plain path (the same generator
     seed, so the same masks), the 3 steps again from the same weights and
     seed bit-equal (metrics and every parameter), one eval step (K1 and K3
     12), ms/step and peak memory; then phase 42 b's runs with the same
     dropout at depth 4: every policy's gradients bit-equal to no remat.
 47. attention dropout too (``attn_drop_rate`` 0.1): JAX's gate sends every
     block's attention to the window partition, the qkv Dense and the
     plain fp32 attention in train mode, so 3 steps launch no K1 or K2
     (K3 24, K4 12 a step); the masks' kept shares, step 1 against the plain
     path, the rerun bit-equal; the eval step after it launches K1 and K3
     12 times (eval mode keeps the kernels); ms/step and peak memory.
 48. the 2-step fine-tune with ``proj_drop_rate`` 0.1: the fc1 dropout moves
     the MLP from K5/K6 to K3/K4 (JAX's ``Mlp`` condition reads the rate,
     so its eval step too): 2 steps, K1 36, K2 24, K3 48, K4 24 a step, the
     eval step K1 and K3 24; the kept shares, step 1 against the plain
     path; ms/step and peak memory.
 49. the 8-step fine-tune ``..._8step`` (looped rollout, each step's model
     call under its checkpoint, the block remat nested inside): 2 steps,
     K1 240 a step (96 forward, 96 in the steps' recompute, 48 in the
     blocks' recompute inside it), K5 192, K2 and K6 96; step 1 against the
     plain path; ms/step and peak memory.
 50. the ``'xla'`` route's train step (the windowed route in plain ops, the
     route JAX's factory builds for a config without ``attn_impl``): 3
     steps, no attention kernel, K3 24 and K4 12 a step; step 1 against
     the plain path; one eval step (K3 12); ms/step and peak memory.
     Phases 46-50's numbers, with the card, in one
     ``{"dropout_and_owed_paths": {...}}`` JSON line.

Each phase's wall seconds print as it ends (``[n] ... s (phase clock)``)
and together in one ``{"phase_seconds": {...}}`` line before the kernels'.

Phases 18 and 27 also time K11's streamed-row instance (at [64800, 3072])
and K7's plain versions at e2048.

Then one JSON line with each kernel's results: ``launches`` on the main path
of the slice that brought it (K1, K2, K5, K6: the 2-step fine-tune; K3, K4:
the single-step train step; K7: the CPB train step; K11: the fused-LayerNorm
train step; K10: the v6 train step; ``gemm``, the GEMM core: the 2-step
fine-tune, its launches inside K1, K2, K5 and K6, timed alone at K5's
e2048 fc1 shape with its other phase-38 shapes under ``shapes``; the
``_e2048`` entries, the same
wrappers timed at the e2048 shapes of phase 27: the e2048 train step at
full size (phase 42), with
K7's e2048 case under its own entries' ``e2048`` key; K8/K9's ``_e2048``
entries: the e2048 grid and windowed train steps of phase 34, with head dim
128 under the flagship entries' ``hd128`` key and the BIAS instances at 256
under ``e2048``; K12: the v5, v4 and padded-v4 train steps; K13: the probe
run; the Trainer's paths of phase 40 under ``launches_by_path`` as
``trainer`` and ``trainer_2step``, per train step with the validation
steps' launches included; phase 42's as ``train_e2048_full``,
``train_lamb`` and ``remat_<policy>`` (each run of its part b); phase 41's
as ``inference`` (the scored rollout),
``ensemble`` (batch 5) and ``served_stepper`` (one call of the artifact);
phase 45's as ``served_<route>`` (one call of each route's artifact);
phases 46-50's as ``train_dropout``, ``remat_dropout_<policy>``,
``train_dropout_attn``, ``train_2step_dropout``, ``train_8step`` and
``train_xla``;
K11's streamed rows under its entries' ``streamed`` key; the e2048
train steps' kernels at those steps' shape under ``train_shape``), the launches on every
path and per step, the largest abs
difference from its plain version, its time and the plain version's (CUDA
events), the bound (the larger of its FLOPs at the bf16 peak and its bytes,
each input read and each output written once, at the memory rate of an H100
SXM) and ``library_ms``: for the K8 and K9 forwards the time of
``torch.nn.functional.scaled_dot_product_attention`` on the windowed [400, 8,
162, 96] bf16 tensors (at their head dim for the phase 33 entries) with the
bias as a float additive mask [8, 162, 162]
(the same function, but with one scalar scale where the kernels take one per
head, and without the q/k normalization: the timed call leaves both out; the
port never calls it), and for the K8/K9 backwards the backward alone of the
same call (null where no backend takes the shape); for K13 ``torch.sum(s, 0)`` (it rounds once, the
kernel twice, as the TPU kernel); null for the others (no single PyTorch call
computes them; K11's entries add ``F.layer_norm``'s time as context; K3's and
K4's add ``matmul_ms``, ``torch.matmul`` of their operands, as a yardstick;
K1's, K3's and every forward launcher's with a custom op add ``host_us``,
a call's host time direct and through the op).
The backward entries carry phase 39's results under ``l288`` (by head dim,
each with its bound and the variant that ran; the full-width cases under
``l288_full``), and the streamed backwards at head dim 256 their
breakdown under ``breakdown`` (and ``train_shape``'s). K8/K9's entries are named by their main paths (the grid, windowed
and CPB train steps). The last line is
``{"ok": true, "device": {...}}``. Any failure raises (exit code 1); without a
CUDA device the script exits with code 1 before printing any result.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import logging
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
CONFIG_2STEP = "swin_73var_geo_depth12_chweight_invar_2step"
EPOCH2_CKPT = "ckpt_epoch2"  # phase 40's first checkpoint, kept for phase 44
CONFIG_4STEP = "swin_73var_geo_depth12_chweight_invar_4step"
CONFIG_8STEP = "swin_73var_geo_depth12_chweight_invar_8step"
CONFIG_DEPTH24 = "swin_73var_geo_depth24_chweight_invar"
# bench.py's cpb_rel_pos row: the flagship with the CPB bias instead of the
# full position embedding (K7's path)
CPB = {"rel_pos": True, "full_pos_embed": False}
LNADD = {"lnadd_impl": "fused"}  # the fused post-norm branches (K11's path)
GRID_ROUTE = {"attn_impl": "pallas"}  # the grid route (K8's path)
V1_ROUTE = {"attn_impl": "pallas_v1"}  # the windowed route (K9's path)
XLA_ROUTE = {"attn_impl": "xla"}  # the windowed route in plain ops (no attention kernel)
# depths of the paths cut to fit the script's time limit: the e2048 family
# (24 as written; at depth <= 12 the factory would pick the fc1+GELU MLP, so
# the cut keeps the written config's whole-MLP route), phase 42 b's and 46's
# remat policies, and the flagship's route variants (ROUTE_DEPTH)
E2048_DEPTH = {"depth": 6, "mlp_impl": "fused2"}
REMAT_DEPTH = {"depth": 4}
ROUTE_DEPTH = {"depth": 4}
# phases 40, 41 and 44: the Trainer's flagship and everything built from its
# run (its synthetic loader, not the depth, paces its steps)
TRAINER_DEPTH = {"depth": 4}
CONFIG_E2048 = "swin_73var_geo_depth24_e2048_mlp2_chweight_invar"
# the e2048 train step at the image [360, 720]: window 9 x 18 on 90 x 180
# tokens, so L = 162 as at full size (where shared memory bites)
E2048_TRAIN = {"img_size": [360, 720], "window_ratio": 40}
N_STEPS = 4

# Published dense peaks of one H100 SXM (NVIDIA's data sheet), for the bounds
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
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
# K7's dbias sums fp32 ds / scale over 400 windows; flips of bf16 sites move
# a few entries.
BWD_TOL = {"dx": (2.0, 0.05), "dW": (4.0, 0.05), "db": (4.0, 0.05), "dscale": (2.0, 0.25),
           "dbias": (4.0, 0.05),
           # K8/K9: dq, dk, dv leave the kernels in bf16; a flipped rounding of
           # p16 or dsb moves an entry by about an ulp
           "dq": (2.0, 0.05), "dk": (2.0, 0.05), "dv": (2.0, 0.05)}
# Train step 1, kernel path vs plain path: relative bounds on the loss and on
# each gradient norm. Both are sums over millions of terms, so one-ulp flips
# of either sign average out (about 1e-5 relative on the H100).
STEP_RTOL = {"loss": 1e-4, "grad_norm": 1e-3}
# Whole MLP (K5 out; K6 a and dpre): the same rounding sites on both sides; a
# flipped bf16 rounding of pre or a moves an output by about one ulp, and the
# fc2 product's and the bias add's roundings flip with the sum order.
MLP2_TOL = (2.0, 0.02)
# The GEMM core against the fp32 product of the same bf16 values: only the
# order of the fp32 sums differs, which now and then flips the last bf16
# rounding of an output (fp32 outputs differ far below a bf16 ulp)
CORE_TOL = (1.0, 0.01)
# K11: the same rounding sites on both sides; the row statistics' fp32 sums
# differ in order, which now and then flips one bf16 rounding of out or dz;
# dgamma/dbeta sum 64800 rows in another order.
LN_TOL = {"out": (1.0, 0.01), "dz": (1.0, 0.01), "dgamma": (2.0, 0.05), "dbeta": (2.0, 0.05)}
# Phase 43, the two-band step against the unsharded one (relative: the loss,
# the gradient norm, and each gradient's largest difference over its largest
# entry): the bands' gradients are summed over the ranks in another order
# than one process sums the same terms, and a gradient that leaves a kernel
# in bf16 (the qkv weight's, K2's dW) flips an ulp, 2^-8 of an entry, where
# that order moves a rounding; cuBLAS may pick other kernels for the band's
# half-height products. FSDP2 at world size 1 is held to the same bounds
# where it is not bit-equal: its parameters are views into its all-gather
# buffer, another alignment of the same products.
SPATIAL_TOL = {"loss": 1e-4, "grad_norm": 1e-3, "grad": 2e-2}
# a dropout mask's kept share lies within this many binomial standard
# deviations of 1 - rate (each mask: one sample's elements at one site)
KEEP_SIGMAS = 5.0
DROPOUT_RATE = 0.1  # phases 46-48: proj (and attn) dropout


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


def host_us(fn, n: int = 20) -> float:
    """The host's us per call of fn() (its Python checks, ctypes call and
    launch), over n calls enqueued without a sync in between."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def build_spills(pattern: str) -> dict:
    """Mangled name -> (spill store, spill load) bytes of every kernel whose
    mangled name matches ``pattern``, from the build's ``-Xptxas -v`` log."""
    import re

    from swin_v2_weather_torch.ops import _build

    lines = open(_build.library_path()[: -len(".so")] + ".log").read().splitlines()
    spills = {}
    for i, line in enumerate(lines):
        m = re.search(r"Function properties for (\S+)", line)
        if m is not None and re.search(pattern, m[1]):
            st = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", lines[i + 1])
            spills[m[1]] = (int(st[1]), int(st[2]))
    return spills


def fwd_spills() -> dict:
    """(head dim, layout, bias, z path, head pitch) -> (spill store, spill
    load) bytes of each instance of the forward template (``build_spills``):
    K8/K9's and the qkv-fused forwards' pass."""
    import re

    pattern = r"qkv_attention_fwd_kernelILi(\d+)ELi(\d)ELb(\d)ELb(\d)ELi(\d+)E"
    return {(int(m[1]), int(m[2]), bool(int(m[3])), bool(int(m[4])), int(m[5])): sp
            for name, sp in build_spills(pattern).items()
            for m in [re.search(pattern, name)]}


# the GEMM core's instances (its pair kernel: K6), K2's attention pass and the
# qkv-fused forward's attention pass (layouts QKV and QKV4; all their variants)
CORE_KERNELS = r"7swin_wg11gemm_kernelI"
PAIR_KERNELS = r"7swin_wg16gemm_pair_kernelI"
# K3 (K5's fc1 instance) and K4 on the core
K34_KERNELS = r"7swin_wg11gemm_kernelI\w*?(11Fc1Epilogue|12DpreEpilogue)"
K2_PASS_KERNELS = r"_GLOBAL__N_\w*20attention_bwd_kernelI"
K1_PASS_KERNELS = r"qkv_attention_fwd_kernelILi\d+ELi[23]E"
# the streamed backward (streamed_bwd.cuh): the qkv-fused family (K2/K7/K10/K12)
# at head dims 32-256 (33 instances), K8 and K9 at 32-256 (30 each)
STREAMED_BWD_KERNELS = r"streamed_bwd_(rows|cols)_kernelI"


def kernel_pieces(fn, labels, n: int = 5, tries: int = 3) -> dict:
    """Device ms per launch of the kernels fn() launches, by torch.profiler
    over n calls after a warm-up, averaged under the label of the first
    (substring, label) pair of ``labels`` whose substring the kernel's name
    contains (each label's kernel runs once a call; the mean is over the
    launches the profiler recorded, which may be fewer than n). A window in
    which the profiler recorded no device event at all (it happens now and
    then late in a long process on the H100) is profiled again, up to
    ``tries`` windows."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    total, count = {}, {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            label = next((lab for sub, lab in labels if sub in ev.name), None)
            if label is not None:
                total[label] = total.get(label, 0.0) + ev.time_range.elapsed_us() / 1e3
                count[label] = count.get(label, 0) + 1
        if total:
            break
    if not total:  # a diagnostic, not a check: report it and go on
        log(f"  (torch.profiler recorded no device events for this breakdown in {tries} windows)")
    return {label: total[label] / count[label] for label in total}


K2_PIECES = (("StoreBiasBf16", "projection (core)"), ("attention_bwd_kernel<", "attention pass"),
             ("StoreBf16>", "dx (core)"),
             ("StoreSplitF32", "dW (core)"), ("column_sums_kernel", "db column sums"),
             ("reduce_kernel", "reductions"))
K5_PIECES = (("Fc1Epilogue", "fc1 (core)"), ("Fc2Epilogue", "fc2 (core)"))
K1_PIECES = (("StoreNormBf16", "projection + q/k normalization (core)"),
             ("qkv_attention_fwd_kernel", "attention pass"))
K6_PIECES = (("gemm_pair_kernel", "x @ W1 and g @ W2^T (core pair kernel)"),)


def pieces_line(pieces: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in pieces.items())


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


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    """(least ms on an H100 SXM, "operations" or "bytes"): the larger of the
    FLOPs at ``peak`` (the bf16 tensor-core peak unless given) and the bytes
    at the memory rate."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def train_params(config: str, overrides: dict = None):
    """The config's parameters (with ``overrides``) and the derived channel
    counts, set up for synthetic data (the temp-std loss then takes unit
    stats)."""
    from swin_v2_weather_torch.config.yparams import YParams, default_config_path
    from swin_v2_weather_torch.data.preprocess import derived_channel_counts

    params = YParams(default_config_path(), config)
    for key, val in (overrides or {}).items():
        params[key] = val
    params["n_in_channels"], params["n_out_channels"] = derived_channel_counts(params)
    params["img_shape_x"], params["img_shape_y"] = (int(s) for s in params.img_size)
    params["data_loader_config"] = "synthetic"
    return params


_SAMPLES, _WEIGHTS = {}, {}


@contextlib.contextmanager
def dropout_rates(rates):
    """While it is open, ``get_model`` builds its ``SwinTransformerV2`` with
    ``rates`` = (proj_drop_rate, attn_drop_rate) (None: the defaults, 0):
    only direct construction sets them, as in JAX, whose factory reads
    neither."""
    if rates is None:
        yield
        return
    import functools

    from swin_v2_weather_torch.models import swin

    with mock.patch.object(swin, "SwinTransformerV2", functools.partial(
            swin.SwinTransformerV2, proj_drop_rate=rates[0], attn_drop_rate=rates[1])):
        yield


def seeded_model(params, dev, seed: int, weights_on=None, dropout=None):
    """``get_model(params)`` on ``dev`` with every parameter drawn by
    ``seeded_parameters`` from a generator on ``weights_on`` (the CPU unless
    given) seeded ``seed``, and the dropout rates ``dropout`` (proj, attn) or
    none. The model is built under ``dev``: its default initialization,
    which the draws overwrite, runs on the card. The host's draws are kept
    per parameter layout and seed, so a model of the same layout gets the
    same bits without drawing them again."""
    from swin_v2_weather_torch.models.wrappers import get_model
    from swin_v2_weather_torch.training.trainer import seeded_parameters

    with torch.device(dev), dropout_rates(dropout):
        model = get_model(params, device=dev)
    gen_on = torch.device(weights_on or "cpu")
    if gen_on.type != "cpu":
        seeded_parameters(model, torch.Generator(device=gen_on).manual_seed(seed))
        return model
    key = (seed, tuple((n, tuple(p.shape)) for n, p in model.named_parameters()))
    if key not in _WEIGHTS:
        seeded_parameters(model, torch.Generator().manual_seed(seed))
        _WEIGHTS[key] = {n: p.detach().cpu() for n, p in model.named_parameters()}
    else:
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(_WEIGHTS[key][n])
    return model


def synthetic_batch(params, dev, train: bool = True):
    """``collate([SyntheticDataset(params, train=train)[0]], device=dev)``,
    the sample drawn once per data shape and kept on the host (a full-size
    draw takes seconds on one thread; the key holds every field the draw
    reads)."""
    from swin_v2_weather_torch.data.synthetic import SyntheticDataset, collate

    key = (train, int(params.dt), int(params.n_future), len(params.in_channels),
           len(params.out_channels), tuple(int(s) for s in params.img_size),
           bool(params.add_zenith), int(getattr(params, "seed", 333) or 333))
    if key not in _SAMPLES:
        _SAMPLES[key] = SyntheticDataset(params, train=train)[0]
    return collate([_SAMPLES[key]], device=dev)


def plain_version(fn):
    """The plain twin of a K8/K9 or K12 wrapper, from the wrapper's module:
    ``<name>_reference``, or for ``<name>_bwd`` ``<name>_backward_reference``
    (the same arguments)."""
    module = sys.modules[fn.__module__]
    name = fn.__name__
    if name.endswith("_bwd"):
        return getattr(module, name[: -len("_bwd")] + "_backward_reference")
    return getattr(module, name + "_reference")


# GEMM core launches a call of each counted wrapper makes (v5's projection is
# one product per (role, head) slab); K8, K9, K11 and K13 launch none
CORE_PER_CALL = {"window_attention_qkv": 1, "window_attention_qkv_bias": 1,
                 "window_attention_qkv_padded": 1, "window_attention_qkv4": 1,
                 "window_attention_qkv4_padded": 1, "window_attention_qkv_bwd": 3,
                 "window_attention_qkv_bias_bwd": 3, "window_attention_qkv_padded_bwd": 3,
                 "window_attention_qkv4_bwd": 3, "window_attention_qkv4_padded_bwd": 3,
                 "fc1_gelu": 1, "fc1_dpre": 1, "mlp_fwd": 2, "mlp_bwd": 1}


def check_core(tag: str, core: int, launches: dict, heads: int) -> None:
    """Raise unless the GEMM core's launch count is what the counted
    wrappers' launches imply (``CORE_PER_CALL``; v5: 3 heads slabs forward,
    3 heads + 2 backward)."""
    per = dict(CORE_PER_CALL, window_attention_qkv5=3 * heads,
               window_attention_qkv5_bwd=3 * heads + 2)
    want = sum(per.get(name, 0) * n for name, n in launches.items())
    if core != want:
        raise RuntimeError(f"{tag}: the GEMM core must launch {want} times, got {core}")


def live_cuda_tensors(n: int = 6):
    """(GiB, the n largest as (shape, dtype, GiB)) of the distinct CUDA
    storages that the garbage collector reaches through tensors."""
    import gc

    storages = {}
    for obj in gc.get_objects():
        # plain tensors and parameters only: fake ones (torch.export's) have no storage
        if type(obj) in (torch.Tensor, torch.nn.Parameter) and obj.is_cuda:
            st = obj.untyped_storage()
            storages[st.data_ptr()] = (tuple(obj.shape), str(obj.dtype), st.nbytes() / 2**30)
    top = sorted(storages.values(), key=lambda v: -v[2])[:n]
    return sum(v[2] for v in storages.values()), [(s, d, round(g, 3)) for s, d, g in top]


def device_busy_ms(prof) -> float:
    """The union of the device event intervals of a torch.profiler run, in ms
    (as chip_profile.py computes a step's busy time); raises where the
    profiler recorded no device event."""
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        raise RuntimeError("the profiler recorded no device time")
    busy, cur_s, cur_e = 0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            busy += 0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    return (busy + cur_e - cur_s) / 1e3


class TriggerAfter:
    """An injected preemption trigger that fires at the n-th poll (the
    Trainer polls once a step), in place of the signal handler."""

    def __init__(self, n: int):
        self.n, self.polls = n, 0

    @property
    def triggered(self) -> bool:
        self.polls += 1
        return self.polls >= self.n

    def install(self):
        return self

    def uninstall(self) -> None:
        pass


@contextlib.contextmanager
def plain_calls_counted(counted):
    """Count the calls of every counted wrapper's plain version (``<name>_reference``
    or ``<name minus _bwd>_backward_reference`` in the wrapper's module) while
    the block runs; yields the {name: calls} dict."""
    calls, stack = {}, contextlib.ExitStack()
    for fn in counted:
        module = sys.modules[fn.__module__]
        names = {fn.__name__ + "_reference", fn.__name__.removesuffix("_bwd") + "_backward_reference"}
        for name in names:
            orig = getattr(module, name, None)
            if orig is None:
                continue

            def wrapped(*args, _orig=orig, _name=name, **kwargs):
                calls[_name] = calls.get(_name, 0) + 1
                return _orig(*args, **kwargs)

            stack.enter_context(mock.patch.object(module, name, wrapped))
    with stack:
        yield calls


class LogCapture(logging.Handler):
    """Collects the messages of one logger at INFO while attached."""

    def __init__(self, name: str):
        super().__init__(logging.INFO)
        self.messages, self.logger = [], logging.getLogger(name)

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level)


class PhaseClock:
    """Each phase's wall seconds: ``mark(tag)`` ends the phase that the last
    mark began (a line ``[tag] ... s (phase clock)``) and begins ``tag``."""

    def __init__(self):
        self.seconds, self.tag, self.t = {}, None, time.time()

    def mark(self, tag) -> None:
        now = time.time()
        if self.tag is not None:
            self.seconds[self.tag] = round(self.seconds.get(self.tag, 0.0) + now - self.t, 1)
            log(f"[{self.tag}] {now - self.t:.1f} s (phase clock)")
        self.tag, self.t = tag, now


def trainer_and_inference_phases(dev, card: str, counted, gemm):
    """Phase 40, the flagship and its 2-step fine-tune through the port's
    ``Trainer`` at full width, then phase 41, the user journey from phase
    40's run to a scored forecast and a served artifact (module docstring).
    Both run under one temporary directory of the checkout's ``runs/`` (which
    .gitignore lists), removed when the script exits (phase 44 reads phase
    40's run from it). Returns ({path: (launches, steps)} for the kernel
    line, the directory, phase 40's experiment directory)."""
    import atexit
    import shutil
    import tempfile

    runs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs")
    os.makedirs(runs, exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_trainer_", dir=runs)
    atexit.register(shutil.rmtree, root, True)
    paths, exp_dir = _trainer_phase(root, dev, card, counted, gemm)
    paths.update(inference_phase(root, exp_dir, dev, card, counted, gemm))
    return paths, root, exp_dir


def _trainer_phase(root, dev, card, counted, gemm):
    import collections
    import shutil

    from swin_v2_weather_torch.config.yparams import YParams, default_config_path
    from swin_v2_weather_torch.data import pipeline
    from swin_v2_weather_torch.models.wrappers import get_model
    from swin_v2_weather_torch.training import checkpoint as ckpt
    from swin_v2_weather_torch.training import trainer as trainer_mod
    from swin_v2_weather_torch.training.trainer import Trainer, init_parameters

    n_samples, n_epochs = 4, 2  # batch 1: 4 train and 4 validation steps an epoch

    def params_for(config=CONFIG, **over):
        p = YParams(default_config_path(), config)
        base = dict(exp_dir=root, data_loader_config="synthetic", n_synthetic_samples=n_samples,
                    max_epochs=n_epochs, batch_size=1, save_checkpoint=True, **TRAINER_DEPTH)
        for key, val in {**base, **over}.items():
            p[key] = val
        return p

    def reset_counts():
        for fn in counted:
            fn.launches = 0
        gemm.launches = 0

    def read_counts():
        return {fn.__name__: fn.launches for fn in counted}, gemm.launches

    def check_launches(tag, launches, core, want, heads):
        want = {name: want.get(name, 0) for name in launches}
        if launches != want:
            raise RuntimeError(f"{tag}: launches must be {want}, got {launches}")
        check_core(tag, core, launches, heads)

    def logs_of(t):
        with open(os.path.join(t.params["experiment_dir"], "logs.jsonl")) as f:
            return [json.loads(line) for line in f]

    def check_logs(tag, lines, n):
        if len(lines) != n or not all("valid_rmse_u10m" in line and all(
                math.isfinite(v) for v in line.values() if isinstance(v, float)) for line in lines):
            raise RuntimeError(f"{tag}: logs.jsonl must hold {n} finite lines with "
                               f"valid_rmse_u10m: {lines}")
        for line in lines:
            log(f"    epoch {line['epoch']}: loss {line['loss']:.6f}, valid_loss "
                f"{line['valid_loss']:.6f}, valid_rmse_u10m {line['valid_rmse_u10m']:.6f}, "
                f"lr {line['lr']:.3g}, train {line['train_time']:.2f} s, valid "
                f"{line['valid_time']:.2f} s")

    out = {"card": card}
    probe = params_for()
    heads, depth = int(probe.num_heads), int(probe.depth)
    t_phase = time.time()
    log(f"[40] the Trainer end to end: {CONFIG} at full width ({tuple(probe.img_size)}, embed "
        f"{probe.embed_dim}, depth {depth}, {probe.compute_dtype}, batch 1, drop-path "
        f"{probe.drop_path_rate}), synthetic data, {n_samples} train and "
        f"{n_samples} validation samples an epoch, {n_epochs} epochs, checkpoints on, "
        f"through Trainer.build_and_launch on {dev}")

    # ---- the first run, every batch's prefetch checked ------------------------
    checks = []
    real_prefetch = pipeline.cuda_prefetch

    def checked_prefetch(iterator, device, depth=2):
        """cuda_prefetch with an exact checksum (the fp32 bits summed as
        integers) of each batch as the loader hands it over, on the host, and
        as it arrives on the device, on the consuming stream."""
        host = collections.deque()

        def tap(batches):
            for batch in batches:
                host.append({k: int(np.asarray(v).view(np.int32).sum(dtype=np.int64))
                             for k, v in batch.items()})
                yield batch

        for dev_batch in real_prefetch(tap(iterator), device, depth):
            checks.append((host.popleft(), {k: v.view(torch.int32).sum(dtype=torch.int64)
                                            for k, v in dev_batch.items()}))
            yield dev_batch

    reset_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    p1 = params_for()
    t0 = time.time()
    with mock.patch.object(trainer_mod, "cuda_prefetch", checked_prefetch), \
            plain_calls_counted(counted) as plain_calls:
        t1 = Trainer(p1, CONFIG, run_num="run", device=dev)
        t1.build_and_launch()
    torch.cuda.synchronize()
    out["first_run_s"] = time.time() - t0
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    launches, core = read_counts()
    n_train = n_epochs * n_samples
    log(f"  first run: {out['first_run_s']:.1f} s, peak {out['peak_gib']:.3f} GiB; launches "
        f"{launches}, GEMM core {core}; plain versions called: {plain_calls}")
    # a train step under 'mlp3' runs again the shifted blocks' attention and
    # every K3 (chip_smoke's phase 9); a validation step checkpoints nothing
    check_launches("[40] first run", launches, core, {
        "window_attention_qkv": (depth + depth // 2 + depth) * n_train,
        "window_attention_qkv_bwd": depth * n_train,
        "fc1_gelu": 3 * depth * n_train, "fc1_dpre": depth * n_train}, heads)
    if plain_calls:
        raise RuntimeError(f"[40] the Trainer called plain versions: {plain_calls}")
    paths = {"trainer": ({**launches, "gemm": core}, n_train)}
    check_logs("[40] first run", logs_of(t1), n_epochs)
    exp1 = t1.params["experiment_dir"]
    for name in ("training_checkpoints/ckpt", "training_checkpoints/best_ckpt"):
        if not ckpt.latest_checkpoint_exists(os.path.join(exp1, name)):
            raise RuntimeError(f"[40] {name} missing after the run")
    if not os.path.isfile(os.path.join(exp1, "hyperparams.yaml")):
        raise RuntimeError("[40] hyperparams.yaml missing")
    # every parameter moved from the Trainer's seeded initialization
    fresh = get_model(p1, device=dev)
    init_parameters(fresh, torch.Generator(device=dev).manual_seed(t1.seed))
    frozen = [n for n, p in t1.model.named_parameters()
              if torch.equal(p, fresh.get_parameter(n))]
    if frozen:
        raise RuntimeError(f"[40] parameters the run did not change: {frozen}")
    bad = [i for i, (h, d) in enumerate(checks)
           if set(h) != set(d) or any(h[k] != int(d[k]) for k in h)]
    if len(checks) != 2 * n_train or bad:
        raise RuntimeError(f"[40] prefetched batches differ from the host's: batches {bad} of "
                           f"{len(checks)}")
    log(f"  ckpt, best_ckpt, hyperparams.yaml written; all {len(list(fresh.parameters()))} "
        f"parameter tensors moved; the {len(checks)} prefetched batches (train and validation) "
        "equal the host's (exact checksums of the fp32 bits)")
    out["save_blocking_ms"] = t1.ckpt_writer.last_blocking_s * 1e3
    out["save_write_ms"] = t1.ckpt_writer.last_write_s * 1e3
    out["checkpoint_gb"] = os.path.getsize(os.path.join(
        exp1, "training_checkpoints", "ckpt", ckpt.CHECKPOINT_FILE)) / 1e9
    log(f"  checkpoint {out['checkpoint_gb']:.3f} GB: save blocks {out['save_blocking_ms']:.1f} ms "
        f"(device -> host copy), background write {out['save_write_ms']:.1f} ms ({card})")
    final1 = {k: v.detach().cpu().clone() for k, v in t1.model.state_dict().items()}
    # the epoch-2 checkpoint as the first run left it: phase 44 resumes it
    # through JAX's layout and holds that to the resume below
    shutil.copytree(os.path.join(exp1, "training_checkpoints", "ckpt"),
                    os.path.join(root, EPOCH2_CKPT))
    del t1, fresh
    torch.cuda.empty_cache()

    # ---- resume: one more epoch, timed by CUDA events ------------------------
    p2 = params_for(max_epochs=n_epochs + 1)
    with LogCapture(trainer_mod.__name__) as capture:
        t2 = Trainer(p2, CONFIG, run_num="run", device=dev)
        t2.build()
    want = f"Loading checkpoint {p2['checkpoint_path']}"
    if want not in capture.messages or t2.start_epoch != n_epochs or t2.host_step != n_train:
        raise RuntimeError(f"[40] resume: start epoch {t2.start_epoch}, step {t2.host_step}, "
                           f"log {capture.messages}")
    spans, step_fn = [], t2.train_step

    def timed_step(batch):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step_fn(batch)
        end.record()
        spans.append((start, end))
        return metrics

    t2.train_step = timed_step
    t2.train()
    torch.cuda.synchronize()
    lines = logs_of(t2)
    if [line["epoch"] for line in lines] != list(range(1, n_epochs + 2)):
        raise RuntimeError(f"[40] resume: logged epochs {[line['epoch'] for line in lines]}")
    out["trainer_ms"] = spans[1][0].elapsed_time(spans[-1][1]) / (len(spans) - 1)
    out["trainer_epoch_s"] = lines[-1]["train_time"]
    log(f"  resume: '{want}', continued at epoch {n_epochs} (step {n_train}), logged epoch "
        f"{lines[-1]['epoch']}; Trainer {out['trainer_ms']:.2f} ms/step (CUDA events over "
        f"the epoch's steps after the first; prefetch and loader waits included); the epoch's "
        f"{n_samples} steps {out['trainer_epoch_s']:.2f} s on the host clock ({card})")
    del t2, spans, step_fn
    torch.cuda.empty_cache()

    # ---- preempted at step 2 of epoch 0, resumed: bit-equal to the first run --
    p3 = params_for()
    t3 = Trainer(p3, CONFIG, run_num="preempted", device=dev)
    t3.preempt = TriggerAfter(2)
    t3.build_and_launch()
    torch.cuda.synchronize()
    if t3._preempted_at != 2 or logs_of(t3)[-1].get("preempted_at_step") != 2:
        raise RuntimeError(f"[40] preemption: stopped at {t3._preempted_at}")
    del t3
    torch.cuda.empty_cache()
    t4 = Trainer(params_for(), CONFIG, run_num="preempted", device=dev)
    t4.build()
    if (t4.start_epoch, t4.resume_step_in_epoch, t4.host_step) != (0, 2, 2):
        raise RuntimeError(f"[40] preemption resume: epoch {t4.start_epoch}, step in epoch "
                           f"{t4.resume_step_in_epoch}, step {t4.host_step}")
    # the device's idle share: a torch.profiler window over 3 steps of the
    # resumed run (epoch 1's steps 1-3), as chip_profile.py computes it
    from torch.profiler import ProfilerActivity, profile

    window, calls, step_fn4 = {}, [0], t4.train_step

    def profiled_step(batch):
        i = calls[0]
        calls[0] += 1
        if i == 3:
            window["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            window["prof"].start()
            window["t0"] = time.perf_counter()
        metrics = step_fn4(batch)
        if i == 5:
            torch.cuda.synchronize()
            window["wall_ms"] = (time.perf_counter() - window["t0"]) * 1e3
            window["prof"].stop()
        return metrics

    t4.train_step = profiled_step
    t4.train()
    torch.cuda.synchronize()
    differ = [k for k, v in t4.model.state_dict().items() if not torch.equal(v.cpu(), final1[k])]
    if differ:
        raise RuntimeError(f"[40] the preempted and resumed run's final parameters differ from "
                           f"the uninterrupted run's in {len(differ)} tensors: {differ[:8]}")
    log(f"  preempted at step 2 of epoch 0 (checkpoint with step_in_epoch 2), resumed at epoch "
        f"0 step 2, finished: all {len(final1)} final parameter tensors bit-equal to the "
        f"uninterrupted first run's (drop-path {probe.drop_path_rate} live)")
    busy = device_busy_ms(window["prof"])
    out["idle_share"] = 1.0 - busy / window["wall_ms"]
    out["device_step_ms"] = busy / 3
    log(f"  idle share over 3 Trainer steps: {out['idle_share']:.4f} (device busy {busy / 3:.2f} "
        f"of {window['wall_ms'] / 3:.2f} ms/step wall, torch.profiler, copies included; {card})")
    del t4, final1, window
    shutil.rmtree(os.path.join(root, CONFIG, "preempted"), ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- the 2-step fine-tune from the first run's best_ckpt ------------------
    best = os.path.join(exp1, "training_checkpoints", "best_ckpt")
    p5 = params_for(CONFIG_2STEP, max_epochs=1, finetune=True, pretrained_checkpoint_path=best,
                    save_checkpoint=False)
    reset_counts()
    with plain_calls_counted(counted) as plain_calls:
        t5 = Trainer(p5, CONFIG_2STEP, run_num="ft", device=dev)
        t5.build()
        disk = torch.load(os.path.join(best, ckpt.CHECKPOINT_FILE), map_location="cpu",
                          weights_only=True)
        live = t5.model.state_dict()
        if (t5.start_epoch, t5.host_step, t5.params["resuming"], len(t5.optimizer.state)) != (
                0, 0, False, 0) or set(live) != set(disk["model"]) or not all(
                torch.equal(v.cpu(), disk["model"][k]) for k, v in live.items()):
            raise RuntimeError("[40] fine-tune: the weights, and only the weights, must load "
                               "from best_ckpt")
        del disk, live
        t5.train()
    torch.cuda.synchronize()
    launches, core = read_counts()
    log(f"  2-step fine-tune from best_ckpt (weights only: step 0, epoch 0, a fresh Adam): "
        f"launches {launches}, GEMM core {core}; plain versions called: {plain_calls}")
    check_launches("[40] 2-step fine-tune", launches, core, {
        "window_attention_qkv": 2 * (depth + depth // 2 + depth) * n_samples,
        "window_attention_qkv_bwd": 2 * depth * n_samples,
        "mlp_fwd": 2 * depth * 2 * n_samples, "mlp_bwd": 2 * depth * n_samples}, heads)
    if plain_calls:
        raise RuntimeError(f"[40] the fine-tune called plain versions: {plain_calls}")
    check_logs("[40] 2-step fine-tune", logs_of(t5), 1)
    paths["trainer_2step"] = ({**launches, "gemm": core}, n_samples)
    del t5
    torch.cuda.empty_cache()  # the first run's directory stays for phase 41

    # ---- the loader alone on the host, and one batch's H2D copy ---------------
    lp = params_for(n_synthetic_samples=5)
    loader, ds = pipeline.get_data_loader(lp, "", train=True, pin_memory=dev.type == "cuda")
    t0 = time.perf_counter()
    arrivals = []
    for batch in loader:
        arrivals.append(time.perf_counter() - t0)
    out["loader_ms"] = (arrivals[-1] - arrivals[0]) / (len(arrivals) - 1) * 1e3
    t0 = time.perf_counter()
    ds[0]
    out["sample_ms"] = (time.perf_counter() - t0) * 1e3
    log(f"  loader alone ({lp.num_data_workers} workers, pinned ring): {out['loader_ms']:.1f} "
        f"ms/batch after the first ({arrivals[0] * 1e3:.1f} ms: ring allocation and look-ahead); "
        f"one synthetic sample on one thread {out['sample_ms']:.1f} ms")
    pinned = batch.tensors
    pageable = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    n_bytes = sum(t.numel() * t.element_size() for t in pinned.values())
    for label, src in (("pinned", pinned), ("pageable", pageable)):
        times = []
        for _ in range(4):
            t0 = time.perf_counter()
            copied = {k: t.to(dev, non_blocking=True) for k, t in src.items()}
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            del copied
        out[f"h2d_{label}_ms"] = sum(times[1:]) / 3 * 1e3
    loader.close()
    del loader, ds, batch, pinned, pageable
    log(f"  H2D of one batch ({n_bytes / 1e6:.1f} MB): pinned {out['h2d_pinned_ms']:.2f} ms "
        f"({n_bytes / out['h2d_pinned_ms'] / 1e6:.2f} GB/s), pageable {out['h2d_pageable_ms']:.2f} "
        f"ms ({n_bytes / out['h2d_pageable_ms'] / 1e6:.2f} GB/s); host clock around the copies "
        f"and a synchronize ({card})")
    bound_by = "the loader" if out["loader_ms"] > out["device_step_ms"] else "the device step"
    log(f"  where the Trainer's time goes: {out['trainer_ms']:.2f} ms/step against the "
        f"device's busy {out['device_step_ms']:.2f} ms a step (torch.profiler, above) and the "
        f"loader's {out['loader_ms']:.1f} ms/batch: bound by {bound_by} on synthetic data "
        f"({card})")
    out["bound_by"] = bound_by

    # ---- ERA5 on the card: a full-resolution archive, the native reader ------
    # written by the port's pure-numpy HDF5 writer (no h5py on this machine);
    # read by the native pread reader, whose file probe is the pure-numpy reader
    from swin_v2_weather_torch.data import hdf5

    arch = os.path.join(root, "era5")
    os.makedirs(arch)
    rng = np.random.default_rng(SEED)
    frame = rng.standard_normal((73, 721, 1440), dtype=np.float32)
    t0 = time.time()
    for year in (2017, 2018):
        fields = hdf5.create_contiguous(os.path.join(arch, f"{year}.h5"),
                                        {"fields": ((3, 73, 721, 1440), np.float32)})["fields"]
        for i in range(3):  # frame by frame: no second copy of a year in memory
            fields[i] = frame * (1.0 + 0.1 * i) + (year - 2017)
        fields.flush()
        del fields
    out["era5_write_s"] = time.time() - t0
    del frame
    stats = {"global_means": np.zeros((1, 73, 1, 1), np.float32),
             "global_stds": np.ones((1, 73, 1, 1), np.float32),
             "time_diff_stds": np.full((1, 73, 1, 1), 0.1, np.float32)}
    for name, arr in stats.items():
        np.save(os.path.join(arch, f"{name}.npy"), arr)
    p6 = params_for(data_loader_config="threaded", train_data_path=arch,
                    valid_data_path=arch, max_epochs=1, use_native_loader=True,
                    save_checkpoint=False,
                    **{f"{name}_path": os.path.join(arch, f"{name}.npy") for name in stats})
    reset_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with plain_calls_counted(counted) as plain_calls:
        t6 = Trainer(p6, CONFIG, run_num="era5", device=dev)
        t6.build()
        if t6.train_dataset._native is None or t6.valid_dataset._native is None:
            raise RuntimeError("[40] ERA5: the native reader is not in use")
        # every step timed by CUDA events; a torch.profiler window over steps
        # 2-4 for the device's idle share
        spans6, window6, step_fn6 = [], {}, t6.train_step

        def era5_step(batch):
            i = len(spans6)
            if i == 2:
                window6["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                      ProfilerActivity.CUDA])
                window6["prof"].start()
                window6["t0"] = time.perf_counter()
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            metrics = step_fn6(batch)
            end.record()
            spans6.append((start, end))
            if i == 4:
                torch.cuda.synchronize()
                window6["wall_ms"] = (time.perf_counter() - window6["t0"]) * 1e3
                window6["prof"].stop()
            return metrics

        t6.train_step = era5_step
        t6.train()
    torch.cuda.synchronize()
    out["era5_s"] = time.time() - t0
    out["era5_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    launches, core = read_counts()
    n_tr, n_va = len(t6.train_loader), len(t6.valid_loader)
    check_launches("[40] ERA5", launches, core, {
        "window_attention_qkv": (depth + depth // 2) * n_tr + depth * n_va,
        "window_attention_qkv_bwd": depth * n_tr,
        "fc1_gelu": 2 * depth * n_tr + depth * n_va, "fc1_dpre": depth * n_tr}, heads)
    if plain_calls:
        raise RuntimeError(f"[40] the ERA5 epoch called plain versions: {plain_calls}")
    check_logs("[40] ERA5", logs_of(t6), 1)
    paths["trainer_era5"] = ({**launches, "gemm": core}, n_tr)
    out["era5_ms_per_step"] = spans6[1][0].elapsed_time(spans6[-1][1]) / (len(spans6) - 1)
    busy6 = device_busy_ms(window6["prof"])
    out["era5_idle_share"] = 1.0 - busy6 / window6["wall_ms"]
    log(f"  ERA5: 2 yearly files of 3 samples [73, 721, 1440] written by hdf5.create_contiguous "
        f"in {out['era5_write_s']:.1f} s; data_loader_config 'threaded' with the native reader "
        f"(its file probe the pure-numpy HDF5 reader): one epoch of {n_tr} train and {n_va} "
        f"validation steps in {out['era5_s']:.1f} s with the build; launches {launches}, GEMM "
        f"core {core}; no plain version called")
    log(f"  ERA5 epoch: {out['era5_ms_per_step']:.2f} ms/step (CUDA events over the steps "
        f"after the first, loader waits included), idle share {out['era5_idle_share']:.4f} "
        f"over steps 2-4 (device busy {busy6 / 3:.2f} of {window6['wall_ms'] / 3:.2f} ms/step "
        f"wall, torch.profiler), peak {out['era5_peak_gib']:.3f} GiB ({card})")
    del t6, spans6, window6, step_fn6
    torch.cuda.empty_cache()
    loader, _ = pipeline.get_data_loader(p6, arch, train=True, pin_memory=True)
    t0 = time.perf_counter()
    arrivals = [time.perf_counter() - t0 for _ in loader]
    loader.close()
    del loader
    out["era5_loader_ms"] = (arrivals[-1] - arrivals[0]) / (len(arrivals) - 1) * 1e3
    log(f"  ERA5 loader alone ({p6.num_data_workers} workers, native reader, pinned ring): "
        f"{out['era5_loader_ms']:.1f} ms/batch after the first ({arrivals[0] * 1e3:.1f} ms), "
        f"{len(arrivals)} batches of one sample (two frames of 73 x 720 x 1440 fp32) ({card})")
    out["era5"] = "driven"
    out["phase_s"] = time.time() - t_phase
    log(f"  phase 40 took {out['phase_s']:.1f} s")
    print(json.dumps({"trainer": out}))
    return paths, exp1


def interchange_phase(root, exp_dir, dev, card, counted, gemm) -> dict:
    """Phase 44: the JAX checkpoint interchange at full width (module
    docstring). Returns {path: (launches, steps)} for the kernel line."""
    import shutil

    from swin_v2_weather_torch.config.yparams import YParams, default_config_path
    from swin_v2_weather_torch.inference.registry import export_model, load_model
    from swin_v2_weather_torch.training import checkpoint as ckpt
    from swin_v2_weather_torch.training import interchange
    from swin_v2_weather_torch.training.trainer import Trainer

    t_phase = time.time()
    out, paths = {"card": card}, {}
    n_samples, n_epochs = 4, 2  # phase 40's run

    def params_for(**over):
        p = YParams(default_config_path(), CONFIG)
        base = dict(exp_dir=root, data_loader_config="synthetic", n_synthetic_samples=n_samples,
                    max_epochs=n_epochs + 1, batch_size=1, save_checkpoint=True,
                    **TRAINER_DEPTH)
        for key, val in {**base, **over}.items():
            p[key] = val
        return p

    def reset_counts():
        for fn in counted:
            fn.launches = 0
        gemm.launches = 0

    def check_launches(tag, want, heads):
        launches = {fn.__name__: fn.launches for fn in counted}
        want = {name: want.get(name, 0) for name in launches}
        if launches != want:
            raise RuntimeError(f"{tag}: launches must be {want}, got {launches}")
        check_core(tag, gemm.launches, launches, heads)
        return {**launches, "gemm": gemm.launches}

    def tensors(tree, prefix=""):
        """Every tensor of a nested state by its path (the optimizer's
        group ``lr`` left out: the Trainer sets it from the scheduler)."""
        if isinstance(tree, torch.Tensor):
            return {prefix: tree}
        if isinstance(tree, dict):
            items = tree.items()
        elif isinstance(tree, (list, tuple)):
            items = enumerate(tree)
        else:
            return {prefix: tree} if not prefix.endswith("/lr") else {}
        found = {}
        for k, v in items:
            found.update(tensors(v, f"{prefix}/{k}"))
        return found

    # ---- the checkpoint: out in JAX's scanned layout, back, resumed one epoch --
    probe = params_for()
    heads, depth = int(probe.num_heads), int(probe.depth)
    scanned = params_for(scan_blocks=True)  # the flagship's own config is unrolled
    src = os.path.join(root, EPOCH2_CKPT)
    npz = os.path.join(root, "neutral_ckpt")
    t0 = time.time()
    interchange.checkpoint_to_jax(src, npz, scanned)
    out["export_s"] = time.time() - t0
    tree = interchange.read_tree(npz)
    pairs = tree["params"]["model"]["pairs"]["block0"]["attn"]["qkv"]["kernel"]
    if tuple(pairs.shape) != (depth // 2, int(probe.embed_dim), 3 * int(probe.embed_dim)):
        raise RuntimeError(f"[44] the export is not in the scanned layout: {pairs.shape}")
    n_leaves = len(interchange.leaves(tree))
    del tree, pairs
    imported = os.path.join(root, CONFIG, "imported", "training_checkpoints", "ckpt")
    t0 = time.time()
    interchange.checkpoint_from_jax(npz, imported, probe)
    out["import_s"] = time.time() - t0
    npz_gb = os.path.getsize(os.path.join(npz, interchange.TREE_NPZ)) / 1e9
    log(f"[44] the JAX checkpoint interchange: phase 40's epoch-2 checkpoint out in JAX's "
        f"scanned layout (checkpoint_to_jax {out['export_s']:.1f} s, {n_leaves} leaves, "
        f"{npz_gb:.3f} GB .npz; the blocks stacked as {depth // 2} pairs) and back "
        f"(checkpoint_from_jax {out['import_s']:.1f} s)")
    reset_counts()
    with plain_calls_counted(counted) as plain_calls:
        t = Trainer(params_for(), CONFIG, run_num="imported", device=dev)
        t.build()
        if (t.start_epoch, t.host_step, t.resume_step_in_epoch) != (n_epochs, n_epochs *
                                                                       n_samples, 0):
            raise RuntimeError(f"[44] resume from the import: epoch {t.start_epoch}, step "
                               f"{t.host_step}")
        t.train()
    torch.cuda.synchronize()
    if plain_calls:
        raise RuntimeError(f"[44] the resumed run called plain versions: {plain_calls}")
    launches = check_launches("[44] resume from the import", {
        "window_attention_qkv": (depth + depth // 2 + depth) * n_samples,
        "window_attention_qkv_bwd": depth * n_samples,
        "fc1_gelu": 3 * depth * n_samples, "fc1_dpre": depth * n_samples}, heads)
    paths["trainer_imported"] = (launches, n_samples)
    del t
    torch.cuda.empty_cache()
    # phase 40's resume of its own checkpoint wrote epoch 3 into its run's ckpt
    own = torch.load(os.path.join(exp_dir, "training_checkpoints", "ckpt", ckpt.CHECKPOINT_FILE),
                     map_location="cpu", weights_only=True)
    got = torch.load(os.path.join(imported, ckpt.CHECKPOINT_FILE), map_location="cpu",
                     weights_only=True)
    a, b = tensors(own), tensors(got)
    differ = sorted(k for k in set(a) | set(b) if k not in a or k not in b or (
        not torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor) else a[k] != b[k]))
    if differ or own["epoch"] != n_epochs + 1:
        raise RuntimeError(f"[44] the resume from the import differs from the resume from the "
                           f"port's own checkpoint in {len(differ)} entries: {differ[:8]}")
    n_tensors = sum(isinstance(v, torch.Tensor) for v in a.values())
    log(f"  resumed one epoch from the import ({n_samples} steps, launches {launches}): all "
        f"{n_tensors} tensors of the epoch-3 checkpoint (weights, Adam's moments and steps) "
        f"and its counters bit-equal to phase 40's resume of its own checkpoint")
    del own, got, a, b
    shutil.rmtree(npz, ignore_errors=True)

    # ---- the registry: out to JAX and back, one served step --------------------
    reg = os.path.join(root, "registry_44")
    export_model(exp_dir, reg)
    t0 = time.time()
    interchange.registry_to_jax(reg, os.path.join(root, "neutral_registry"),
                                os.path.join(root, "registry_jax"))
    interchange.registry_from_jax(os.path.join(root, "neutral_registry"),
                                  os.path.join(root, "registry_jax"),
                                  os.path.join(root, "registry_back"))
    out["registry_s"] = time.time() - t0
    served, x = {}, None
    for label, path in (("port", reg), ("round trip", os.path.join(root, "registry_back"))):
        model, rparams = load_model(path, dev)
        if x is None:
            x = torch.randn((1, int(rparams["n_in_channels"]),
                             *[int(n) for n in rparams["img_size"]]),
                            generator=torch.Generator().manual_seed(SEED)).to(dev)
        reset_counts()
        with torch.no_grad():
            served[label] = model(x)
        torch.cuda.synchronize()
        served_launches = check_launches(f"[44] served step ({label})", {
            "window_attention_qkv": depth, "fc1_gelu": depth}, heads)
        del model
    if not torch.equal(served["port"], served["round trip"]):
        raise RuntimeError("[44] the registry's round trip serves another step")
    paths["served_round_trip"] = (served_launches, 1)
    log(f"  registry_to_jax -> registry_from_jax -> load_model ({out['registry_s']:.1f} s): "
        f"one served step bit-equal to the registry's own, launches {served_launches}")
    del served, x
    torch.cuda.empty_cache()
    out["phase_s"] = time.time() - t_phase
    log(f"  phase 44 took {out['phase_s']:.1f} s")
    print(json.dumps({"interchange": out}))
    return paths


# a fresh process that loads an artifact (no model code), runs it on the
# saved inputs and counts the launches of the named forward launchers
SERVED_CHILD = """
import json, sys, torch
from swin_v2_weather_torch.inference.export import load_stepper
from swin_v2_weather_torch.ops import ln_kernels, mlp_kernels, window_attention
from swin_v2_weather_torch.ops.attic import window_attention_v45
served = load_stepper(sys.argv[1], device="cuda")
state, zen, ref = torch.load(sys.argv[2], map_location="cuda")
modules = (window_attention, mlp_kernels, ln_kernels, window_attention_v45)
fns = [next(getattr(m, n) for m in modules if hasattr(m, n)) for n in json.loads(sys.argv[3])]
served(state, zen)
torch.cuda.synchronize()
for fn in fns:
    fn.launches = 0
out = served(state, zen)
torch.cuda.synchronize()
launches = {fn.__name__: fn.launches for fn in fns}
start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
start.record()
for _ in range(5):
    served(state, zen)
end.record()
end.synchronize()
print(json.dumps({"bit_equal": torch.equal(out, ref), "max_abs": float((out - ref).abs().max()),
                  "launches": launches, "ms": start.elapsed_time(end) / 5,
                  "model_modules": sorted(m for m in sys.modules
                                          if m.startswith("swin_v2_weather_torch.models"))}))
"""


def inference_phase(root, exp_dir, dev, card, counted, gemm) -> dict:
    """Phase 41: the user journey of the inference side on the flagship at
    full width, from phase 40's trained run (module docstring). Returns
    {path: (launches, steps)} for the kernel line: the scored rollout
    (``inference``), the ensemble (``ensemble``) and the served artifact
    (``served_stepper``)."""
    import argparse

    from swin_v2_weather_torch.inference import cli
    from swin_v2_weather_torch.inference.ensemble import (
        breed_perturbations,
        gaussian_perturbations,
        make_members,
        score_ensemble,
    )
    from swin_v2_weather_torch.inference.export import export_stepper, load_stepper
    from swin_v2_weather_torch.inference.registry import export_model, load_model, load_stats
    from swin_v2_weather_torch.inference.rollout import RolloutEngine
    from swin_v2_weather_torch.inference.scoring import score_rollout
    from swin_v2_weather_torch.models import swin as swin_mod
    from swin_v2_weather_torch.ops import mlp_kernels as mk
    from swin_v2_weather_torch.ops import window_attention as wa
    from swin_v2_weather_torch.ops.metrics import (
        ensemble_spread_channels,
        weighted_acc,
        weighted_crps_channels,
        weighted_rmse,
    )
    from swin_v2_weather_torch.training.checkpoint import CHECKPOINT_FILE

    t_phase = time.time()
    out, paths = {"card": card}, {}
    n_steps, chunk, n_ens, ens_steps = 8, 4, 5, 4

    def reset_counts():
        for fn in counted:
            fn.launches = 0
        gemm.launches = 0

    def check_launches(tag, want, heads):
        launches = {fn.__name__: fn.launches for fn in counted}
        want = {name: want.get(name, 0) for name in launches}
        if launches != want:
            raise RuntimeError(f"{tag}: launches must be {want}, got {launches}")
        check_core(tag, gemm.launches, launches, heads)
        return {**launches, "gemm": gemm.launches}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def finite(tag, scores, keys, shape):
        for key in keys:
            arr = np.asarray(scores[key])
            if arr.shape != shape or not np.isfinite(arr).all():
                raise RuntimeError(f"{tag}: {key} must be finite of shape {shape}, got "
                                   f"{arr.shape}")

    plain = mock.patch.multiple(swin_mod,
                                fused_window_attention_qkv=wa.window_attention_qkv_reference,
                                fused_fc1_gelu=mk.fc1_gelu_reference)

    # ---- registry: export_model -> load_model on the card ---------------------
    reg = os.path.join(root, "registry")
    (_, export_s) = timed(lambda: export_model(exp_dir, reg))
    best = torch.load(os.path.join(exp_dir, "training_checkpoints", "best_ckpt", CHECKPOINT_FILE),
                      map_location="cpu", weights_only=True)["model"]
    rng = np.random.default_rng(SEED)
    model, params = load_model(reg, dev)
    heads, depth = int(params.num_heads), int(params.depth)
    n_out, (h, w) = len(params.out_channels), (int(s) for s in params.img_size)
    names = [str(c) for c in params.channel_names]
    live = model.state_dict()
    if set(live) != set(best) or not all(torch.equal(v.cpu(), best[k]) for k, v in live.items()):
        raise RuntimeError("[41] load_model's weights differ from the run's best_ckpt")
    del best, live
    # statistics (the synthetic run has none on disk): seeded, in the registry
    # under the names the config gives, where load_model points its paths
    np.save(os.path.join(reg, "global_means.npy"),
            rng.standard_normal((1, n_out, 1, 1)).astype(np.float32))
    np.save(os.path.join(reg, "global_stds.npy"),
            (0.5 + rng.random((1, n_out, 1, 1))).astype(np.float32))
    np.save(os.path.join(reg, "time_means.npy"),
            rng.standard_normal((1, n_out, h, w)).astype(np.float32))
    model, params = load_model(reg, dev)
    means, stds, clim = load_stats(params)
    engine = RolloutEngine(params, model, dev)
    log(f"[41] inference from phase 40's run: export_model {export_s:.1f} s, load_model on "
        f"{dev} (weights equal to best_ckpt's), {CONFIG} at {h} x {w}, {n_out} channels; "
        f"seeded statistics and climatology")

    # ---- scored rollout: stepped and chunked ------------------------------------
    state0 = torch.randn((1, n_out, h, w), generator=torch.Generator().manual_seed(SEED))
    targets = [rng.standard_normal((1, n_out, h, w), dtype=np.float32) for _ in range(n_steps)]
    kw = dict(means=means, stds=stds, climatology=clim, channel_names=names)
    scores = {}
    torch.cuda.reset_peak_memory_stats()
    for label, scanned in (("stepped", False), ("chunked", True)):
        reset_counts()
        scores[label], secs = timed(lambda: score_rollout(
            engine, state0, targets, START, scanned=scanned, chunk=chunk, **kw))
        launches = check_launches(f"[41] scored {label}", {
            "window_attention_qkv": depth * n_steps, "fc1_gelu": depth * n_steps}, heads)
        finite(f"[41] scored {label}", scores[label], ("rmse", "acc"), (n_steps, n_out))
        out[f"scored_{label}_ms"] = secs / n_steps * 1e3
        log(f"  score_rollout {label}{f' (chunk {chunk})' if scanned else ''}: {n_steps} steps "
            f"{out[f'scored_{label}_ms']:.2f} ms/step (host clock, targets copied from the "
            f"host, scores back; {card}); launches {launches}; RMSE [t+6h] mean "
            f"{scores[label]['rmse'][0].mean():.5f}, ACC {scores[label]['acc'][0].mean():.5f}")
    paths["inference"] = (launches, n_steps)
    for key in ("rmse", "acc"):
        if not np.array_equal(scores["stepped"][key], scores["chunked"][key]):
            raise RuntimeError(f"[41] chunked {key} differs from the stepped one")
    stepped = [p.clone() for p in engine.steps(state0, START, n_steps)]
    state, chunked = state0, []
    for _, zstack in engine.zenith_chunks(START, n_steps, chunk):
        state, preds = engine.rollout_chunk(state, zstack)
        chunked.extend(preds)
    if not all(torch.equal(a, b) for a, b in zip(stepped, chunked)):
        raise RuntimeError("[41] the chunked predictions differ from the stepped ones")
    with plain:
        plain1 = next(engine.steps(state0, START, 1))
    compare("step 1 kernel path vs plain path", stepped[0], plain1, MODEL_TOL)
    # where a scored step's time goes: the host's zenith, the target's copy
    # from pageable memory, the step on the device, the scoring on the device
    zen1 = torch.from_numpy(engine.zenith_at(START)).to(dev)
    state_d = state0.to(dev)
    tar_d = torch.as_tensor(targets[0], device=dev)
    means_d, stds_d = (torch.as_tensor(a.reshape(1, -1, 1, 1), device=dev) for a in (means, stds))
    clim_d = torch.as_tensor(clim[None], device=dev)

    def score_step():
        pred_phys, tar_phys = stepped[0] * stds_d + means_d, tar_d * stds_d + means_d
        return (weighted_rmse(pred_phys, tar_phys),
                weighted_acc(pred_phys - clim_d, tar_phys - clim_d))

    parts = {
        "zenith_host_ms": timed(lambda: [engine.zenith_at(START) for _ in range(3)])[1] / 3 * 1e3,
        "target_h2d_ms": timed(lambda: [torch.as_tensor(t, device=dev)
                                        for t in targets[:3]])[1] / 3 * 1e3,
        "step_device_ms": time_ms(lambda: engine._step(state_d, zen1), 5),
        "scoring_device_ms": time_ms(score_step, 5),
    }
    out["scored_breakdown"] = parts
    log("  a scored step's parts: " + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
        + f" ({card}; the step and the scoring by CUDA events back to back, the zenith and "
        "the copy on the host clock)")
    del chunked, preds, plain1, tar_d, clim_d
    log(f"  chunked predictions (chunks of {chunk}) bit-equal to the stepped ones, all "
        f"{n_steps} steps; RMSE and ACC [{n_steps}, {n_out}] finite and bit-equal")

    # ---- forecast writer ----------------------------------------------------------
    keep = [names[0], names[n_out // 2], names[-1]]
    fc_dir = os.path.join(root, "forecast")
    path, out["forecast_write_s"] = timed(lambda: engine.write_forecast(
        fc_dir, state0, START, n_steps, means, stds, names, keep_names=keep, ic_index=0,
        chunk=chunk))
    fields = np.load(path)
    idx = [names.index(k) for k in keep]
    want = np.stack([p[0, idx].cpu().numpy() for p in stepped]) * stds[idx].reshape(
        1, -1, 1, 1).astype(np.float32) + means[idx].reshape(1, -1, 1, 1).astype(np.float32)
    meta = json.load(open(path[:-4] + ".json"))
    if fields.shape != (n_steps, 3, h, w) or not np.array_equal(fields, want) or meta != {
            "ic_index": 0, "start_time": START.isoformat(),
            "lead_hours": [6 * (s + 1) for s in range(n_steps)], "channels": keep,
            "grid": [h, w], "units": "physical (denormalized)"}:
        raise RuntimeError(f"[41] write_forecast: shape {fields.shape}, metadata {meta}")
    log(f"  write_forecast {keep}: {fields.shape} in {out['forecast_write_s']:.2f} s, "
        "denormalized fields equal to the stepped predictions' on the host, metadata as "
        "JAX writes it")
    del fields, want, stepped

    # ---- ensembles: Gaussian and bred, M = 5 ------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    gauss = make_members(state0, gaussian_perturbations(gen, 2, (n_out, h, w), 0.05, 20), n_ens)
    reset_counts()
    bred = breed_perturbations(engine, state0, START, 2, 0.05, cycles=1, seed=SEED)
    check_launches("[41] breeding (1 cycle, batch 3)", {"window_attention_qkv": depth,
                                                         "fc1_gelu": depth}, heads)
    bred = make_members(state0, bred, n_ens)
    ens_keys = ("crps", "spread", "rmse_mean", "rmse_control", "acc_mean")
    for label, members in (("gaussian", gauss), ("bred", bred)):
        reset_counts()
        res, secs = timed(lambda: score_ensemble(engine, members, targets[:ens_steps], START,
                                                 chunk=2, **kw))
        launches = check_launches(f"[41] ensemble {label}", {
            "window_attention_qkv": depth * ens_steps, "fc1_gelu": depth * ens_steps}, heads)
        finite(f"[41] ensemble {label}", res, ens_keys, (ens_steps, n_out))
        if not (res["spread"] > 0).all():
            raise RuntimeError(f"[41] ensemble {label}: spread must be positive")
        out[f"ensemble_{label}_ms"] = secs / ens_steps * 1e3
        log(f"  score_ensemble {label} (M {n_ens}, {ens_steps} steps, chunk 2): "
            f"{out[f'ensemble_{label}_ms']:.2f} ms/step, "
            f"{out[f'ensemble_{label}_ms'] / n_ens:.2f} ms per member ({card}); launches "
            f"{launches}; CRPS [t+6h] mean {res['crps'][0].mean():.5f}, spread "
            f"{res['spread'][0].mean():.5f}, RMSE of the mean {res['rmse_mean'][0].mean():.5f}")
    paths["ensemble"] = (launches, ens_steps)
    out["ensemble_ms"] = out["ensemble_gaussian_ms"]
    out["ensemble_ms_per_member"] = out["ensemble_ms"] / n_ens
    # members at batch 5 against batch-1 steps and the plain path
    zen5 = zen1.expand(n_ens, 1, h, w)
    tar5 = torch.as_tensor(targets[0], device=dev) * stds_d + means_d
    ens_phys = engine._step(gauss, zen5) * stds_d + means_d
    out["ensemble_breakdown"] = {
        "step_device_ms": time_ms(lambda: engine._step(gauss, zen5), 3),
        "crps_spread_device_ms": time_ms(lambda: (
            weighted_crps_channels(ens_phys[:, None], tar5),
            ensemble_spread_channels(ens_phys[:, None])), 3)}
    log(f"  an ensemble step's parts (M {n_ens}): " + ", ".join(
        f"{k} {v:.2f}" for k, v in out["ensemble_breakdown"].items()) + f" ({card}, CUDA events)")
    del tar5, ens_phys
    batched, diffs = engine._step(gauss, zen5), []
    for i in range(n_ens):
        one = engine._step(gauss[i:i + 1], zen1)
        diffs.append(float((batched[i:i + 1] - one).abs().max()))
        compare(f"member {i}: batch {n_ens} vs batch 1", batched[i:i + 1], one, MODEL_TOL)
    with plain:
        compare(f"batch {n_ens} kernel path vs plain path", batched, engine._step(gauss, zen5),
                MODEL_TOL)
    out["batch_vs_batch1_max_abs"] = max(diffs)
    log(f"  members at batch {n_ens} against batch-1 steps: "
        + ("bit-equal" if max(diffs) == 0 else f"max abs {max(diffs):.6g} (the dense layers' "
           "cuBLAS GEMMs may block their sums by batch; K1 and K3 keep each row's sums)"))
    del gauss, bred, batched

    # ---- the serving artifact -------------------------------------------------------------
    art = os.path.join(root, "served")
    manifest, out["export_s"] = timed(lambda: export_stepper(engine, art, batch=1))
    out["artifact_bytes"] = manifest["artifact_bytes"]
    served = load_stepper(art, device=dev.type)
    calls = [str(n.target) for n in served.program.graph.nodes if n.op == "call_function"]
    n_k1, n_k3 = (calls.count("swin.window_attention_qkv.default"),
                  calls.count("swin.fc1_gelu.default"))
    if (n_k1, n_k3) != (depth, depth) or any("softmax" in c or "erf" in c for c in calls):
        raise RuntimeError(f"[41] the exported graph must call K1 and K3 {depth} times each "
                           f"and no plain attention or GELU: {n_k1}, {n_k3}")
    zen = zen1.expand(1, 1, h, w)
    ref = engine._step(state_d, zen)
    served(state_d, zen)
    reset_counts()
    got = served(state_d, zen)
    torch.cuda.synchronize()
    launches = check_launches("[41] served stepper", {"window_attention_qkv": depth,
                                                      "fc1_gelu": depth}, heads)
    paths["served_stepper"] = (launches, 1)
    if not torch.equal(got, ref):
        raise RuntimeError("[41] the served artifact differs from the engine's step")
    out["served_ms"] = time_ms(lambda: served(state_d, zen), 5)
    out["engine_ms"] = time_ms(lambda: engine._step(state_d, zen), 5)
    io = os.path.join(root, "served_io.pt")
    torch.save((state_d.cpu(), zen.cpu().contiguous(), ref.cpu()), io)
    child = subprocess.run([sys.executable, "-c", SERVED_CHILD, art, io,
                            json.dumps(["window_attention_qkv", "fc1_gelu"])],
                           cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                           text=True, timeout=600)
    if child.returncode != 0:
        raise RuntimeError(f"[41] load_stepper in a fresh process failed:\\n{child.stderr}")
    res = json.loads(child.stdout.strip().splitlines()[-1])
    if not res["bit_equal"] or res["model_modules"] or res["launches"] != {
            "window_attention_qkv": depth, "fc1_gelu": depth}:
        raise RuntimeError(f"[41] the served artifact in a fresh process: {res}")
    out["served_child_ms"] = res["ms"]
    log(f"  export_stepper {out['export_s']:.1f} s, stepper.cuda.pt2 "
        f"{out['artifact_bytes'] / 1e6:.1f} "
        f"MB: the graph calls swin::window_attention_qkv and swin::fc1_gelu {depth} times each "
        f"(no plain attention or GELU); served {out['served_ms']:.2f} ms/step against the "
        f"engine's {out['engine_ms']:.2f} (CUDA events, {card}); K1/K3 {depth} launches a "
        f"call, output bit-equal to the engine's step; in a fresh process (no model module "
        f"imported): bit-equal, {res['launches']}, {res['ms']:.2f} ms/step")
    del served, state_d, ref, got
    # ---- the CLI ----------------------------------------------------------------------------
    cli_art = os.path.join(root, "served_cli")
    cli.main(["--registry", reg, "--export-stepper", cli_art, "--batch", "1"])
    cli_manifest = json.load(open(os.path.join(cli_art, "manifest.json")))
    if cli_manifest["device"] != dev.type or cli_manifest["output"]["shape"] != [1, n_out, h, w]:
        raise RuntimeError(f"[41] CLI --export-stepper: {cli_manifest}")
    log(f"  CLI --export-stepper (--device cuda by default): {cli_manifest['artifact_bytes']} "
        "bytes, manifest as export_stepper's")
    # the scoring leg on an ERA5-shaped archive written by the pure-numpy
    # HDF5 writer and read through the native reader (no h5py here)
    from swin_v2_weather_torch.data import hdf5

    arch = os.path.join(root, "era5_cli")
    os.makedirs(arch)
    data = hdf5.create_contiguous(os.path.join(arch, "2018.h5"),
                                  {"fields": ((4, n_out, h + 1, w), np.float32)})["fields"]
    for i in range(4):
        data[i] = rng.standard_normal((n_out, h + 1, w), dtype=np.float32)
    data.flush()
    del data
    ns = argparse.Namespace(registry=reg, data=arch, ics=[1], steps=2, ensemble=3,
                            perturb="gaussian", amplitude=0.05, zonal_truncation=20, seed=0,
                            chunk_steps=2, output=os.path.join(root, "scores.json"),
                            device="cuda")
    reset_counts()
    with LogCapture("swin_v2_weather_torch.data.era5") as capture:
        res, secs = timed(lambda: cli.run(ns))
    if not any(m.startswith("using native pread reader") for m in capture.messages):
        raise RuntimeError(f"[41] the CLI's dataset did not use the native reader: "
                           f"{capture.messages}")
    launches = check_launches("[41] CLI scoring", {"window_attention_qkv": 2 * depth,
                                                   "fc1_gelu": 2 * depth}, heads)
    paths["cli_scoring"] = (launches, 2)
    finite("[41] CLI --ensemble 3", res, ("rmse", "acc", "crps", "spread"), (2, n_out))
    out["cli_scoring_s"] = secs
    log(f"  CLI scoring leg (--ensemble 3, 2 steps at batch 3) on an ERA5-shaped archive "
        f"[4, {n_out}, {h + 1}, {w}] written by hdf5.create_contiguous, read through the "
        f"native reader: finite, launches {launches}, {secs:.1f} s with the registry's load "
        f"({card})")
    out["cli_scoring"] = "driven"

    del engine, model
    torch.cuda.empty_cache()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["phase_s"] = time.time() - t_phase
    log(f"  peak {out['peak_gib']:.3f} GiB since the scored rollout; phase 41 took "
        f"{out['phase_s']:.1f} s")
    print(json.dumps({"inference": out}))
    return paths


# phase 45: the served artifact of every route. tag -> (config, overrides,
# (QKV_IMPL, QKV_PAD_HEADS) or None, {forward launcher: launches a call}),
# each at ROUTE_DEPTH (the script's time limit; the e2048 flagship keeps its
# whole-MLP route, as E2048_DEPTH does).
SERVED_ROUTES = {
    "cpb": (CONFIG, {**CPB, **ROUTE_DEPTH}, None, {"window_attention_qkv_bias": 4,
                                                   "fc1_gelu": 4}),
    "grid": (CONFIG, {**GRID_ROUTE, **ROUTE_DEPTH}, None, {"window_attention_grid": 4,
                                                           "fc1_gelu": 4}),
    "grid_cpb": (CONFIG, {**GRID_ROUTE, **CPB, **ROUTE_DEPTH}, None,
                 {"window_attention_grid_bias": 4, "fc1_gelu": 4}),
    "v1": (CONFIG, {**V1_ROUTE, **ROUTE_DEPTH}, None, {"window_attention_v1": 4,
                                                       "fc1_gelu": 4}),
    "v1_cpb": (CONFIG, {**V1_ROUTE, **CPB, **ROUTE_DEPTH}, None,
               {"window_attention_v1_bias": 4, "fc1_gelu": 4}),
    "v6": (CONFIG, ROUTE_DEPTH, ("v6", False), {"window_attention_qkv_padded": 4,
                                                "fc1_gelu": 4}),
    "v5": (CONFIG, ROUTE_DEPTH, ("v5", False), {"window_attention_qkv5": 4, "fc1_gelu": 4}),
    "v4": (CONFIG, ROUTE_DEPTH, ("v4", False), {"window_attention_qkv4": 4, "fc1_gelu": 4}),
    "v4_padded": (CONFIG, ROUTE_DEPTH, ("v4", True), {"window_attention_qkv4_padded": 4,
                                                      "fc1_gelu": 4}),
    "lnadd": (CONFIG, {**LNADD, **ROUTE_DEPTH}, None,
              {"ln_dp_add_fwd": 8, "window_attention_qkv": 4, "fc1_gelu": 4}),
    # the 2-step fine-tune's single-step model: the whole-MLP route (K5); and
    # the e2048 flagship (K1 at head dim 256, K5 at 2048 -> 4096 -> 2048)
    "2step": (CONFIG_2STEP, ROUTE_DEPTH, None, {"window_attention_qkv": 4, "mlp_fwd": 4}),
    "e2048": (CONFIG_E2048, {**ROUTE_DEPTH, "mlp_impl": "fused2"}, None,
              {"window_attention_qkv": 4, "mlp_fwd": 4}),
}


def served_routes_phase(root, dev, card, counted, gemm) -> tuple:
    """Phase 45: ``export_stepper`` / ``load_stepper`` on every route at full
    width (module docstring). Returns ({path: (launches, calls)} for the
    kernel line, {launcher: host us direct and through its op})."""
    import shutil

    from swin_v2_weather_torch.inference.export import export_stepper, load_stepper
    from swin_v2_weather_torch.inference.rollout import RolloutEngine
    from swin_v2_weather_torch.models.wrappers import SingleStepWrapper
    from swin_v2_weather_torch.ops import ln_kernels as lk
    from swin_v2_weather_torch.ops import mlp_kernels as mk
    from swin_v2_weather_torch.ops import window_attention as wa
    from swin_v2_weather_torch.ops.attic import window_attention_v45 as v45

    t_phase = time.time()
    out, paths = {"card": card, "routes": {}}, {}
    base = os.path.join(root, "served_routes")

    def reset_counts():
        for fn in counted:
            fn.launches = 0
        gemm.launches = 0

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def switched(qkv):
        if qkv is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(wa, "QKV_IMPL", qkv[0]))
        stack.enter_context(mock.patch.object(v45, "QKV_PAD_HEADS", qkv[1]))
        return stack

    def engine_of(config, overrides):
        params = train_params(config, overrides)
        model = seeded_model(params, dev, SEED + 1, dev)
        if int(params.n_future or 0):  # the fine-tune serves its single-step model
            model = SingleStepWrapper(model.model)
        engine = RolloutEngine(params, model, dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        state = torch.randn((1, engine.n_out, engine.h, engine.w), generator=gen, device=dev)
        zen = torch.from_numpy(engine.zenith_at(START)).to(dev)
        return engine, params, state, zen

    for tag, (config, overrides, qkv, want) in SERVED_ROUTES.items():
        art = os.path.join(base, tag)
        with switched(qkv):
            engine, params, state, zen = engine_of(config, overrides)
            heads = int(params.num_heads)
            reset_counts()
            manifest, export_s = timed(lambda: export_stepper(engine, art))
            if any(fn.launches for fn in counted):
                raise RuntimeError(f"[45] {tag}: the export launched a kernel")
            served, load_s = timed(lambda: load_stepper(art, device="cuda"))
            calls = [str(n.target) for n in served.program.graph.nodes
                     if n.op == "call_function"]
            ops = {c.split(".")[1]: calls.count(c) for c in set(calls)
                   if c.startswith("swin.")}
            plain = sorted({c for c in calls if "softmax" in c or "erf" in c})
            if ops != want or plain:
                raise RuntimeError(f"[45] {tag}: the graph must call {want} and no plain "
                                   f"attention or GELU; it calls {ops}, {plain}")
            ref = engine._step(state, zen)
            served(state, zen)
            reset_counts()
            got = served(state, zen)
            torch.cuda.synchronize()
            launches = {fn.__name__: fn.launches for fn in counted}
            if launches != {n: want.get(n, 0) for n in launches}:
                raise RuntimeError(f"[45] {tag}: a served call must launch {want}, got "
                                   f"{launches}")
            check_core(f"[45] {tag}", gemm.launches, launches, heads)
            paths[f"served_{tag}"] = ({**launches, "gemm": gemm.launches}, 1)
            if not torch.equal(got, ref):
                raise RuntimeError(f"[45] {tag}: the served step differs from the engine's "
                                   f"(max abs {float((got - ref).abs().max()):.6g})")
            served_ms = time_ms(lambda: served(state, zen), 3)
            engine_ms = time_ms(lambda: engine._step(state, zen), 3)
        row = {"config": config, "overrides": overrides, "qkv": qkv, "ops": ops,
               "export_s": export_s, "load_s": load_s, "bytes": manifest["artifact_bytes"],
               "served_ms": served_ms, "engine_ms": engine_ms}
        out["routes"][tag] = row
        log(f"[45] {tag} ({config} {overrides}{'' if qkv is None else f', QKV {qkv}'}): export "
            f"{export_s:.1f} s, load {load_s:.1f} s, {row['bytes'] / 1e9:.3f} GB; the graph "
            f"calls {ops}, no plain attention or GELU; a served call launches "
            f"{ {n: v for n, v in launches.items() if v} } (GEMM core {gemm.launches}), "
            f"bit-equal to the engine's step; served "
            f"{served_ms:.2f} ms/step, engine {engine_ms:.2f} ({card})")
        if tag == "2step":  # a fresh process with no model code runs the K5 artifact
            io = os.path.join(base, "served_io.pt")
            torch.save((state.cpu(), zen.cpu().contiguous(), ref.cpu()), io)
            child = subprocess.run([sys.executable, "-c", SERVED_CHILD, art, io,
                                    json.dumps(sorted(want))],
                                   cwd=os.path.dirname(os.path.abspath(__file__)),
                                   capture_output=True, text=True, timeout=600)
            if child.returncode != 0:
                raise RuntimeError(f"[45] load_stepper in a fresh process failed:\n"
                                   f"{child.stderr}")
            res = json.loads(child.stdout.strip().splitlines()[-1])
            if not res["bit_equal"] or res["model_modules"] or res["launches"] != want:
                raise RuntimeError(f"[45] the 2-step artifact in a fresh process: {res}")
            row["fresh_process_ms"] = res["ms"]
            log(f"  {tag} in a fresh process (no model module imported): bit-equal, "
                f"{res['launches']}, {res['ms']:.2f} ms/step")
        if tag == "cpb":  # an artifact without a CPU program refuses a CPU load
            try:
                load_stepper(art, device="cpu")
            except ValueError as e:
                log(f"  a CPU load of the CUDA artifact raises: {e}")
            else:
                raise RuntimeError("[45] load_stepper on a platform the artifact lacks")
        del engine, served, state, zen, ref, got
        shutil.rmtree(art)
        torch.cuda.empty_cache()

    # ---- platforms: the flagship at depth 2, one program for each ---------------
    engine, params, state, zen = engine_of(CONFIG, {"depth": 2})
    art = os.path.join(base, "platforms")
    manifest, export_s = timed(lambda: export_stepper(engine, art, platforms=("cuda", "cpu")))
    if manifest["platforms"] != ["cuda", "cpu"]:
        raise RuntimeError(f"[45] platforms: {manifest['platforms']}")
    on_cuda, on_cpu = load_stepper(art, "cuda"), load_stepper(art, "cpu")
    ref = engine._step(state, zen)
    got = on_cuda(state, zen)
    if not torch.equal(got, ref):
        raise RuntimeError("[45] the CUDA program differs from the engine's step")
    cpu_calls = [str(n.target) for n in on_cpu.program.graph.nodes if n.op == "call_function"]
    if any(c.startswith("swin.") for c in cpu_calls):
        raise RuntimeError("[45] the CPU program calls a custom op")
    got_cpu, cpu_s = timed(lambda: on_cpu(state.cpu(), zen.cpu()))
    cpu_err = compare("[45] the CPU program (plain versions) against the CUDA program", got_cpu,
                      got.cpu(), MODEL_TOL)
    try:
        export_stepper(engine, os.path.join(base, "tpu"), platforms=("tpu",))
    except ValueError as e:
        log(f"  platforms ('tpu',) raises: {e}")
    else:
        raise RuntimeError("[45] export_stepper must refuse the tpu platform")
    out["platforms"] = {"export_s": export_s, "bytes": manifest["artifacts"],
                        "cpu_max_abs": cpu_err, "cpu_step_s": cpu_s}
    log(f"[45] platforms ('cuda', 'cpu'), {CONFIG} at depth 2: export {export_s:.1f} s, "
        f"{manifest['artifacts']}; the CUDA program bit-equal to the engine's step, the CPU "
        f"program (no custom op) within MODEL_TOL of it ({cpu_s:.1f} s on the host)")
    del engine, on_cuda, on_cpu, state, zen, ref, got, got_cpu
    shutil.rmtree(base)
    torch.cuda.empty_cache()

    # ---- the host us of a call of each new op, direct and through the op --------
    g = torch.Generator(device=dev).manual_seed(SEED)

    def t(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    bf = torch.bfloat16
    x, s, m = t(1, 180, 360, 768, dtype=bf) / 4, t(8).abs() + 5.0, t(162, 162).clamp(max=0)
    w, b, wp, bp = t(768, 2304, dtype=bf) / 32, t(2304) / 10, t(768, 3072, dtype=bf) / 32, t(3072)
    q, bias, xw = t(400, 8, 162, 96, dtype=bf), t(8, 162, 162), t(1, 400, 168, 768, dtype=bf)
    x2 = t(64800, 768, dtype=bf)
    ops = {
        "mlp_fwd": (mk, (x2, t(768, 3072, dtype=bf) / 32, t(3072), t(3072, 768, dtype=bf) / 64,
                         t(768))),
        "window_attention_qkv_bias": (wa, (x, w, b, s, bias, (9, 18), m, 1.0)),
        "window_attention_grid": (wa, (x, x, x, s, (9, 18), m, 1.0)),
        "window_attention_grid_bias": (wa, (x, x, x, s, bias, (9, 18), m, 1.0)),
        "window_attention_v1": (wa, (q, q, q, s, (20, 20), m)),
        "window_attention_v1_bias": (wa, (q, q, q, s, bias, (20, 20), m)),
        "window_attention_qkv_padded": (wa, (x, wp, bp, s, 96, (9, 18), m, 1.0)),
        "ln_dp_add_fwd": (lk, (x2, x2, t(768), t(768), torch.ones((64800, 1), device=dev))),
        "window_attention_qkv5": (v45, (x, t(24, 768, 96, dtype=bf) / 32, b, s, (9, 18), m,
                                        1.0)),
        "window_attention_qkv4": (v45, (xw, w, b, s, (9, 18), (20, 20), m, 1.0)),
        "window_attention_qkv4_padded": (v45, (xw, wp, bp, s, 96, (9, 18), (20, 20), m, 1.0)),
    }
    host = {}
    for name, (module, args) in ops.items():
        op_args = [list(a) if isinstance(a, tuple) else a for a in args]
        fn, op = getattr(module, name), getattr(module, name + "_op")
        if not torch.equal(op(*op_args), fn(*args)):
            raise RuntimeError(f"[45] swin::{name} differs from its direct launch")
        host[name] = {"wrapper_us": host_us(lambda: fn(*args)),
                      "custom_op_us": host_us(lambda: op(*op_args))}
    del ops, x, q, xw, x2, w, wp, bias
    torch.cuda.empty_cache()
    log("[45] host us a call, direct / through the custom op (20 calls enqueued, flagship "
        "shapes): " + ", ".join(f"{n} {v['wrapper_us']:.1f} / {v['custom_op_us']:.1f}"
                                for n, v in host.items()) + f" ({card})")
    out["host_us"] = host
    out["phase_s"] = time.time() - t_phase
    log(f"  phase 45 took {out['phase_s']:.1f} s")
    print(json.dumps({"served_routes": out}))
    return paths, host


def parallel_ranks(tag: str, world: int, backend: str, variants: str, out_dir: str,
                   timeout: float = 600.0) -> list:
    """Run ``world`` ranks of ``scripts/parallel_check.py`` on the card
    (``cuda:0`` each; a ``file://`` rendezvous in ``out_dir``), every one
    stopped at ``timeout``, and return their results; raise with the ranks'
    output if one fails."""
    from swin_v2_weather_torch.parallel.launch import run_ranks

    res = os.path.join(out_dir, tag)
    run_ranks([sys.executable, "-m", "swin_v2_weather_torch.scripts.parallel_check",
               "--backend", backend, "--rendezvous", os.path.join(out_dir, f"{tag}.rdv"),
               "--variants", variants, "--device", "cuda:0", "--timeout", str(timeout),
               "--out", res], world, res, timeout, what=f"[43] {tag}")
    out = []
    for r in range(world):
        with open(os.path.join(res, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def parallel_phase(dev, card: str, train_step_ms: float, per_step: dict, heads: int,
                   results: dict) -> dict:
    """Phase 43 (module docstring): (a) DDP / ZeRO-1 / FSDP2 at world size 1
    over NCCL, (b) two spatially sharded ranks on the card over gloo, (c)
    K1/K2 gated off at the band shape. Returns {path: (launches, steps)} of
    the ranks' runs for the kernel line; (c)'s numbers go into ``results``
    as ``window_attention_qkv_band`` / ``window_attention_qkv_bwd_band``."""
    import shutil
    import tempfile

    from swin_v2_weather_torch.models.swin import make_shift_mask
    from swin_v2_weather_torch.ops import window_attention as wa

    t43 = time.time()
    runs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs")
    os.makedirs(runs, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_", dir=runs)
    steps, paths, out = 4, {}, {"card": card, "bare_step_ms": train_step_ms}
    want = {name: per_step.get(name, 0) for name in (
        "window_attention_qkv", "window_attention_qkv_bwd", "fc1_gelu", "fc1_dpre", "mlp_fwd",
        "mlp_bwd")}

    def check_run(tag, v):
        launches = {k: int(round(n * steps)) for k, n in v["launches_per_step"].items()}
        if launches != {k: n * steps for k, n in want.items()}:
            raise RuntimeError(f"[43] {tag}: launches in {steps} steps must be "
                               f"{ {k: n * steps for k, n in want.items()} }, got {launches}")
        check_core(f"[43] {tag}", int(round(v["gemm_per_step"] * steps)), launches, heads)
        if not all(math.isfinite(x) for m in v["metrics"] for x in m.values()):
            raise RuntimeError(f"[43] {tag}: non-finite metrics")
        paths[f"parallel_{tag}"] = ({**launches, "gemm": int(round(v["gemm_per_step"] * steps))},
                                    steps)

    def within(tag, v):
        rel = {"loss": abs(v["loss"] - v["loss_ref"]) / abs(v["loss_ref"]),
               "grad_norm": abs(v["grad_norm"] - v["grad_norm_ref"]) / abs(v["grad_norm_ref"]),
               "grad": v["worst_grad_rel"]}
        bad = {k: r for k, r in rel.items() if not r <= SPATIAL_TOL[k]}
        if bad:
            raise RuntimeError(f"[43] {tag}: step 1 against the unsharded step beyond "
                               f"{SPATIAL_TOL}: {bad}")
        return rel

    try:
        # (a) world size 1 over NCCL
        (res,) = parallel_ranks("world1", 1, "nccl", "ddp,zero1,fsdp2,trainer", tmp)
        tr = res["variants"].pop("trainer")
        for name, v in res["variants"].items():
            check_run(name, v)
            bit = v["grads_bit_equal"] and v["loss"] == v["loss_ref"]
            if not bit and name != "fsdp2":
                raise RuntimeError(f"[43a] {name}: step 1 is not bit-equal to the plain step "
                                   f"(loss {v['loss']} vs {v['loss_ref']}, worst gradient "
                                   f"{v['worst_grad_rel']:.3g})")
            rel = None if bit else within(name, v)
            log(f"[43a] {name} at world size 1 over NCCL: step 1 "
                + ("bit-equal to the plain step (loss and every gradient)" if bit else
                   f"within {SPATIAL_TOL} of the plain step: {rel}")
                + f"; {v['ms_per_step']:.2f} ms/step over steps 2-{steps}, peak "
                f"{v['peak_gib']:.3f} GiB, against the bare step's {train_step_ms:.2f} ms/step "
                f"of phase 10; launches a step {v['launches_per_step']} ({card})")
            out[name] = {k: v[k] for k in ("loss", "loss_ref", "grads_bit_equal",
                                           "worst_grad_rel", "ms_per_step", "peak_gib",
                                           "launches_per_step")}
        # the Trainer on the process group: one epoch, ZeRO-1 under DDP
        logs = tr["logs"]
        if not (tr["checkpoint"] and len(logs) == 1 and tr["forward"] ==
                "DistributedDataParallel" and tr["optimizer"] == "ZeroRedundancyOptimizer"
                and all(math.isfinite(logs[0][k]) for k in ("loss", "valid_loss",
                                                             "valid_rmse_u10m"))):
            raise RuntimeError(f"[43a] the Trainer on the process group: {tr}")
        log(f"[43a] the Trainer on the NCCL group (world size 1, DDP + ZeRO-1): one epoch of 2 "
            f"steps in {tr['wall_s']:.1f} s with the build, loss {logs[0]['loss']:.6f}, valid "
            f"loss {logs[0]['valid_loss']:.6f}, its step time mean "
            f"{1e3 * logs[0]['step_time_mean']:.1f} ms, checkpoint written by the chief ({card})")
        out["trainer"] = {"wall_s": tr["wall_s"], "log": logs[0]}

        # (b) two ranks on the one card, latitude bands over gloo
        ranks = parallel_ranks("spatial", 2, "gloo", "spatial", tmp)
        for r, res in enumerate(ranks):
            v = res["variants"]["spatial"]
            check_run(f"spatial_rank{r}", v)
            flag = 1.0 if r == 1 else 0.0
            if v["flags"] != {"fwd": [flag], "bwd": [flag]}:
                raise RuntimeError(f"[43b] rank {r}: K1/K2 on the shifted blocks must take "
                                   f"boundary_flag {flag}, took {v['flags']}")
            rel = within(f"spatial rank {r}", v)
            log(f"[43b] spatial_shards 2, mesh [1, 2], rank {r} (band of 90 token rows, gloo, "
                f"both ranks on one card): K1/K2 boundary_flag {v['flags']}; step 1 against "
                f"the unsharded step {rel} (bounds {SPATIAL_TOL}); {v['ms_per_step']:.2f} "
                f"ms/step, peak {v['peak_gib']:.3f} GiB; halo bytes a step "
                f"{v['halo_bytes_per_step']} sent, their exchanges alone "
                f"{v['halo_exchange_ms_per_step']:.2f} ms a step ({card}; the ranks time-share "
                f"the card: correctness and overhead, not scaling)")
            out[f"spatial_rank{r}"] = {k: v[k] for k in (
                "loss", "loss_ref", "worst_grad_rel", "flags", "ms_per_step", "peak_gib",
                "halo_bytes_per_step", "halo_exchange_ms_per_step", "launches_per_step")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (c) K1/K2 gated off (boundary_flag 0.0) at the band shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 43)
    b, gh, gw, c, window = 1, 90, 360, 768, (9, 18)
    x = torch.randn((b, gh, gw, c), generator=gen, device=dev).bfloat16()
    g = torch.randn((b, gh, gw, c), generator=gen, device=dev).bfloat16()
    w_qkv = (2 * torch.rand((c, 3 * c), generator=gen, device=dev) - 1) / math.sqrt(c)
    w16 = w_qkv.bfloat16()
    b_qkv = 0.02 * torch.randn((3 * c,), generator=gen, device=dev)
    scale = torch.exp(math.log(10.0) + 0.3 * torch.randn((heads,), generator=gen, device=dev))
    pattern = torch.from_numpy(make_shift_mask((gh, gw), window, (4, 9))[-1].copy()).to(dev)
    log(f"[43c] K1/K2 at the band shape: x, g {tuple(x.shape)} bf16, {heads} heads, window "
        f"{window}, shifted, boundary_flag 0.0")
    with torch.inference_mode():
        fwd = wa.window_attention_qkv(x, w16, b_qkv, scale, window, pattern, 0.0)
        ref = wa.window_attention_qkv_reference(x, w_qkv, b_qkv, scale, window, pattern, 0.0)
        err_f = compare("K1 out", fwd, ref, ATTN_TOL)
        if not torch.equal(fwd, wa.window_attention_qkv(x, w16, b_qkv, scale, window, None,
                                                        1.0)):
            raise RuntimeError("[43c] K1 with boundary_flag 0.0 differs from the unmasked call")
        if torch.equal(fwd, wa.window_attention_qkv(x, w16, b_qkv, scale, window, pattern, 1.0)):
            raise RuntimeError("[43c] K1's mask has no effect at boundary_flag 1.0")
    bwd = wa.window_attention_qkv_bwd(x, w16, b_qkv, scale, g, window, pattern, 0.0)
    ref_b = wa.window_attention_qkv_backward_reference(x, w16, b_qkv, scale, g, window,
                                                       pattern, 0.0)
    err_b = max(compare(f"K2 {n}", o, r_, BWD_TOL[n])
                for n, o, r_ in zip(("dx", "dW", "db", "dscale"), bwd, ref_b))
    if not all(torch.equal(a_, o) for a_, o in zip(
            bwd, wa.window_attention_qkv_bwd(x, w16, b_qkv, scale, g, window, None, 1.0))):
        raise RuntimeError("[43c] K2 with boundary_flag 0.0 differs from the unmasked call")
    with torch.inference_mode():
        f_ms = time_ms(lambda: wa.window_attention_qkv(x, w16, b_qkv, scale, window, pattern,
                                                       0.0), 20)
        fp_ms = time_ms(lambda: wa.window_attention_qkv_reference(
            x, w_qkv, b_qkv, scale, window, pattern, 0.0), 5)
    b_ms = time_ms(lambda: wa.window_attention_qkv_bwd(x, w16, b_qkv, scale, g, window,
                                                       pattern, 0.0), 10)
    bp_ms = time_ms(lambda: wa.window_attention_qkv_backward_reference(
        x, w16, b_qkv, scale, g, window, pattern, 0.0), 3)
    t_tok, l_win = b * gh * gw, window[0] * window[1]
    attn_flops = 2 * 2 * l_win * (c // heads) * l_win * heads * (t_tok // l_win)
    results["window_attention_qkv_band"] = (err_f, f_ms, fp_ms, bound(
        2 * t_tok * c * 3 * c + attn_flops, nbytes(x, w16, b_qkv, scale, fwd)))
    results["window_attention_qkv_bwd_band"] = (err_b, b_ms, bp_ms, bound(
        3 * 2 * t_tok * c * 3 * c + 5 * attn_flops / 2, nbytes(x, w16, b_qkv, scale, g, *bwd)))
    log(f"  K1 {f_ms:.4f} ms (plain {fp_ms:.4f}, bound "
        f"{results['window_attention_qkv_band'][3][0]:.4f}), K2 {b_ms:.4f} ms (plain "
        f"{bp_ms:.4f}, bound {results['window_attention_qkv_bwd_band'][3][0]:.4f}) ({card}); "
        "each bit-equal to its unmasked call")
    del x, g, fwd, ref, bwd, ref_b
    torch.cuda.empty_cache()
    log(f"[43] {time.time() - t43:.1f} s")
    print(json.dumps({"parallel": out}))
    return paths


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
    from swin_v2_weather_torch.ops import gemm_core as gc
    from swin_v2_weather_torch.ops import ln_kernels as lk
    from swin_v2_weather_torch.ops import mlp_kernels as mk
    from swin_v2_weather_torch.ops import prestage as ps
    from swin_v2_weather_torch.ops import window_attention as wa
    from swin_v2_weather_torch.ops.attic import window_attention_v45 as v45
    from swin_v2_weather_torch.scripts import bwd_breakdown as bb
    from swin_v2_weather_torch.scripts import prestage_probe
    from swin_v2_weather_torch.training.trainer import seeded_parameters

    t_start = time.time()
    clock = PhaseClock()  # each phase's seconds, printed as it ends
    dev = torch.device("cuda", 0)
    qkv_wrappers = (wa.window_attention_grid, wa.window_attention_grid_bwd,
                    wa.window_attention_grid_bias, wa.window_attention_grid_bias_bwd,
                    wa.window_attention_v1, wa.window_attention_v1_bwd,
                    wa.window_attention_v1_bias, wa.window_attention_v1_bias_bwd)
    k12_wrappers = (v45.window_attention_qkv5, v45.window_attention_qkv5_bwd,
                    v45.window_attention_qkv4, v45.window_attention_qkv4_bwd,
                    v45.window_attention_qkv4_padded, v45.window_attention_qkv4_padded_bwd)
    counted = (wa.window_attention_qkv, wa.window_attention_qkv_bwd, mk.fc1_gelu, mk.fc1_dpre,
               mk.mlp_fwd, mk.mlp_bwd, wa.window_attention_qkv_bias,
               wa.window_attention_qkv_bias_bwd, lk.ln_dp_add_fwd, lk.ln_dp_add_bwd,
               *qkv_wrappers, wa.window_attention_qkv_padded, wa.window_attention_qkv_padded_bwd,
               *k12_wrappers, ps.consume)

    clock.mark("1")
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

    clock.mark("2")
    # ---- 2. build --------------------------------------------------------------
    t0 = time.time()
    lib_path = _build.build_library()
    _build.load_library()
    log(f"[2] kernels built and loaded in {time.time() - t0:.1f} s: {os.path.basename(lib_path)}")
    with open(lib_path[: -len(".so")] + ".log") as f:
        for line in f.read().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"    {line.strip()}")
    # the GEMM core (with its pair kernel) and the qkv-fused attention passes
    # (every variant, both directions) must not spill
    for label, pattern, least in (("GEMM core", CORE_KERNELS, 16),
                                  ("GEMM core pair kernel (K6)", PAIR_KERNELS, 2),
                                  ("K3/K4 on the GEMM core", K34_KERNELS, 4),
                                  ("K2 attention pass", K2_PASS_KERNELS, 18),
                                  ("streamed backwards (K2/K7/K10/K12, K8, K9)",
                                   STREAMED_BWD_KERNELS, 93),
                                  ("K1 attention pass (K1, K7, K10, K12)", K1_PASS_KERNELS, 29)):
        spilled = build_spills(pattern)
        if len(spilled) < least or any(any(sp) for sp in spilled.values()):
            raise RuntimeError(f"{label}: {len(spilled)} instances (at least {least}), each "
                               f"must build without spills: {spilled}")
        log(f"    {label}: {len(spilled)} instances, 0 bytes spilled (-Xptxas -v)")
    with open(lib_path[: -len(".so")] + ".log") as f:
        serialized = [line for line in f.read().splitlines() if "C7515" in line]
    log(f"    ptxas wgmma serialization reports (C7515): {len(serialized)}"
        + "".join(f"\n      {line.strip()}" for line in serialized))

    gen = torch.Generator(device=dev).manual_seed(SEED)
    results, yardstick, host_calls = {}, {}, {}

    clock.mark("3")
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
            with torch.inference_mode():
                k1_pieces = kernel_pieces(lambda: wa.window_attention_qkv(
                    x, w16, b_qkv, scale, window, mask, 1.0), K1_PIECES)
                k1_host = host_us(lambda: wa.window_attention_qkv(
                    x, w16, b_qkv, scale, window, mask, 1.0))
                # the serving forward's call: the same launch through the custom op
                k1_op_host = host_us(lambda: wa.window_attention_qkv_op(
                    x, w16, b_qkv, scale, list(window), mask, 1.0))
            info = wa.qkv_fwd_info(c // heads, window[0] * window[1])
            log(f"  {label} breakdown (torch.profiler, device ms a launch): "
                + ", ".join(f"{k} {v:.4f}" for k, v in k1_pieces.items()) + f" ({card}); the "
                f"pass's launch: {info}; the wrapper's host {k1_host:.1f} us a call, through "
                f"swin::window_attention_qkv {k1_op_host:.1f} us")
            host_calls["window_attention_qkv"] = {"wrapper_us": k1_host,
                                                  "custom_op_us": k1_op_host}
            if info["local_bytes"]:
                raise RuntimeError(f"K1's attention pass spills: {info}")
    # K1's work: the qkv projection, then q k^T and p v per (window, head) at L = 162
    t_tok, l_win = b * gh * gw, window[0] * window[1]
    attn_flops = 2 * 2 * l_win * (c // heads) * l_win * heads * (t_tok // l_win)
    results["window_attention_qkv"] = (max(errs), attn_ms, attn_plain_ms, bound(
        2 * t_tok * c * 3 * c + attn_flops, nbytes(x, w16, b_qkv, scale, out)))
    del x, out, ref

    clock.mark("4")
    # ---- 4. K3 fc1 + GELU at flagship shapes ---------------------------------
    hidden = 4 * c
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
        # the yardstick: torch.matmul of the same operands (no bias, no GELU;
        # the port never calls it)
        yardstick["fc1_gelu"] = time_ms(lambda: torch.matmul(x2, w1_16), 20)
        host_calls["fc1_gelu"] = {"wrapper_us": host_us(lambda: mk.fc1_gelu(x2, w1_16, b1)),
                                  "custom_op_us": host_us(lambda: mk.fc1_gelu_op(x2, w1_16, b1))}
    results["fc1_gelu"] = (err, k_ms, p_ms, bound(2 * t_tok * c * hidden,
                                                   nbytes(x2, w1_16, b1, out)))
    log(f"  kernel {k_ms:.4f} ms ({2 * t_tok * c * hidden / k_ms / 1e9:.1f} TFLOP/s, "
        f"{100 * results['fc1_gelu'][3][0] / k_ms:.1f} % of its bound "
        f"{results['fc1_gelu'][3][0]:.4f} ms), plain {p_ms:.4f} ms, torch.matmul of the same "
        f"operands {yardstick['fc1_gelu']:.4f} ms ({card}); "
        f"{mk.fc1_plan(t_tok, c, hidden)['launches']} launch of the GEMM core; the wrapper's "
        f"host {host_calls['fc1_gelu']['wrapper_us']:.1f} us a call, through swin::fc1_gelu "
        f"{host_calls['fc1_gelu']['custom_op_us']:.1f} us")
    del x2, out, ref

    clock.mark("5")
    # ---- 5. flagship serving through get_model + RolloutEngine ---------------
    params = YParams(default_config_path(), CONFIG)
    n_in, n_out = derived_channel_counts(params)
    params["n_in_channels"], params["n_out_channels"] = n_in, n_out
    model = get_model(params)
    cpu_gen = torch.Generator().manual_seed(SEED)
    seeded_parameters(model, cpu_gen)
    n_params = sum(p.numel() for p in model.parameters())
    state = {k: v.cpu() for k, v in model.state_dict().items()}  # get_model built it on the GPU
    back = params_from_jax(params_to_jax(state))
    if set(back) != set(state) or not all(torch.equal(back[k], state[k]) for k in state):
        raise RuntimeError("state_dict -> JAX layout -> state_dict round trip is not exact")
    log(f"[5] {CONFIG}: {n_in} -> {n_out} channels, {tuple(params.img_size)}, embed "
        f"{params.embed_dim}, depth {params.depth}, {n_params} parameters; JAX-layout round trip exact")
    engine = RolloutEngine(params, model, dev)
    state0 = torch.randn((1, n_out, *params.img_size), generator=cpu_gen)

    for fn in counted:
        fn.launches = 0
    gc.gemm.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    preds = engine.rollout(state0, START, N_STEPS)
    rollout_s = time.time() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    serve_core = gc.gemm.launches  # K1's projection and K3
    log(f"  rollout {N_STEPS} steps in {rollout_s:.2f} s -> {preds.shape} {preds.dtype}; "
        f"launches {launches}, GEMM core {serve_core}")
    want = int(params.depth) * N_STEPS
    expected = {n: want if n in ("window_attention_qkv", "fc1_gelu") else 0 for n in launches}
    if launches != expected:
        raise RuntimeError(f"the rollout must launch {expected}, got {launches}")
    check_core("[5]", serve_core, launches, int(params.num_heads))  # K1's projection and K3
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

    clock.mark("6")
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
    serve_launches = {**launches, "gemm": serve_core}
    del engine, model, preds, plain1, state, back

    clock.mark("7")
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
            k2_pieces = kernel_pieces(lambda: wa.window_attention_qkv_bwd(
                x, w16, b_qkv, scale, g, window, mask, 1.0), K2_PIECES)
            log(f"  {label} breakdown (torch.profiler, device ms a launch): "
                + ", ".join(f"{k} {v:.4f}" for k, v in k2_pieces.items()) + f" ({card})")
    # K2's work: the projection recomputed, dx and dW (three T x C x 3C
    # products), and per (window, head) the scores, dp, dv, dq and dk
    results["window_attention_qkv_bwd"] = (bwd_errs["dx"], bwd_ms, bwd_plain_ms, bound(
        3 * 2 * t_tok * c * 3 * c + 5 * attn_flops / 2,
        nbytes(x, w16, b_qkv, scale, g, *out)))
    del x, g, out, ref, again

    clock.mark("8")
    # ---- 8. K4 fc1 backward (pre-activation cotangent) at flagship shapes ----
    x2 = torch.randn((t_tok, c), generator=gen, device=dev).bfloat16()
    g2 = torch.randn((t_tok, hidden), generator=gen, device=dev).bfloat16()
    log(f"[8] fc1_dpre: x2 [{t_tok}, {c}] bf16, W1 [{c}, {hidden}], g [{t_tok}, {hidden}] bf16")
    out = mk.fc1_dpre(x2, w1_16, b1, g2)
    ref = mk.fc1_dpre_reference(x2, w1, b1, g2)
    torch.cuda.synchronize()
    err = compare("fc1_dpre", out, ref, MLP_TOL)
    again = mk.fc1_dpre(x2, w1_16, b1, g2)
    if not torch.equal(again, out):
        raise RuntimeError("fc1_dpre: two calls differ")
    del again
    k_ms = time_ms(lambda: mk.fc1_dpre(x2, w1_16, b1, g2), 20)
    p_ms = time_ms(lambda: mk.fc1_dpre_reference(x2, w1, b1, g2), 5)
    yardstick["fc1_dpre"] = time_ms(lambda: torch.matmul(x2, w1_16), 20)
    results["fc1_dpre"] = (err, k_ms, p_ms, bound(2 * t_tok * c * hidden,
                                                  nbytes(x2, w1_16, b1, g2, out)))
    log(f"  kernel {k_ms:.4f} ms ({2 * t_tok * c * hidden / k_ms / 1e9:.1f} TFLOP/s, "
        f"{100 * results['fc1_dpre'][3][0] / k_ms:.1f} % of its bound "
        f"{results['fc1_dpre'][3][0]:.4f} ms), plain {p_ms:.4f} ms, torch.matmul of the same "
        f"operands {yardstick['fc1_dpre']:.4f} ms ({card}); two calls bit-equal")
    del x2, g2, out, ref, w1, b1, w1_16, w_qkv, w16, b_qkv, scale
    torch.cuda.empty_cache()

    clock.mark("9-10")
    # ---- 9-10, 12-14: train paths ---------------------------------------------
    from swin_v2_weather_torch.data.preprocess import Preprocessor
    from swin_v2_weather_torch.ops.losses import LossHandler
    from swin_v2_weather_torch.training.optim import build_optimizer
    from swin_v2_weather_torch.training.step import build_eval_step, build_train_step

    @contextlib.contextmanager
    def plain_train():
        """The autograd Functions look their wrappers up at call time: swap in
        the plain versions, forward and backward."""
        with mock.patch.multiple(
            wa, window_attention_qkv=wa.window_attention_qkv_reference,
            window_attention_qkv_bwd=wa.window_attention_qkv_backward_reference,
            window_attention_qkv_bias=wa.window_attention_qkv_bias_reference,
            window_attention_qkv_bias_bwd=wa.window_attention_qkv_bias_backward_reference,
            window_attention_qkv_padded=wa.window_attention_qkv_padded_reference,
            window_attention_qkv_padded_bwd=wa.window_attention_qkv_padded_backward_reference,
            **{f.__name__: plain_version(f) for f in qkv_wrappers},
        ), mock.patch.multiple(v45, **{f.__name__: plain_version(f) for f in k12_wrappers}
                               ), mock.patch.multiple(mk, fc1_gelu=mk.fc1_gelu_reference, fc1_dpre=mk.fc1_dpre_reference,
                               mlp_fwd=mk.mlp_fwd_reference, mlp_bwd=mk.mlp_bwd_reference,
                               ), mock.patch.multiple(lk, ln_dp_add_fwd=lk.ln_dp_add_fwd_reference,
                                                      ln_dp_add_bwd=lk.ln_dp_add_bwd_reference):
            yield

    def train_ms(step_fn, batch, n: int):
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

    train_peaks = {}  # the last train_path of each tag: peak GiB over its timed steps

    def train_path(tag: str, config: str, n_steps: int, per_step: dict, plain_step1: bool = True,
                   eval_step: bool = False, n_timed: int = 3, plain_timed: bool = False,
                   overrides: dict = None, weights_on=None, dropout=None, rerun: bool = False,
                   eval_want: dict = None):
        """Drive one train path: get_model -> LossHandler -> Preprocessor ->
        build_optimizer -> build_train_step, n_steps steps from seeded
        parameters (drawn on ``weights_on``, the CPU unless given), each
        kernel launched per_step[name] times a step (0 if absent), finite
        metrics, every parameter moved; then step 1 against the plain path,
        an eval step (its launches ``eval_want`` where given), and ms/step and
        peak memory. ``dropout`` (proj, attn) builds the model with those
        rates: every dropout mask's kept share is then checked (within
        ``KEEP_SIGMAS`` standard deviations of 1 - rate); with ``rerun`` the
        n_steps steps run again from the same weights and generator seed and
        must give the same metrics and parameters bit for bit. Returns the
        launches of the n_steps steps and the kernel path's ms/step."""
        params = train_params(config, overrides)
        model = seeded_model(params, dev, SEED + 1, weights_on, dropout)
        init = {n: p.detach().clone() for n, p in model.named_parameters()}
        loss_handler, preprocessor = LossHandler(params), Preprocessor(params)
        batch = synthetic_batch(params, dev)
        n_future = int(params.n_future)
        log(f"{tag} train step: {config} {overrides or ''}, depth {params.depth}, "
            f"{sum(p.numel() for p in model.parameters())} parameters, n_future {n_future} "
            f"({type(model).__name__}), drop_path_rate {params.drop_path_rate}, dropout "
            f"(proj, attn) {dropout or (0.0, 0.0)}, loss '{params.loss}', "
            f"{params.optimizer_type} lr {float(params.lr)}, batch 1 "
            f"{ {k: tuple(v.shape) for k, v in batch.items()} }")

        def make_step():
            """A fresh optimizer and drop-path generator (same seed every time)."""
            optimizer = build_optimizer(params, model.parameters())
            dp_gen = torch.Generator(device=dev).manual_seed(SEED)
            return build_train_step(model, loss_handler, preprocessor, optimizer, generator=dp_gen)

        for fn in counted:
            fn.launches = 0
        gc.gemm.launches = 0
        train_step = make_step()
        shares = []  # (kept, elements, rate) of every dropout mask the steps build

        def recorded_mask(shape, rate, seeds, device, _orig=swin_mod.keep_mask):
            keep = _orig(shape, rate, seeds, device)
            shares.append((keep.sum(), keep.numel(), rate))
            return keep

        with mock.patch.object(swin_mod, "keep_mask", recorded_mask):
            metrics = [train_step(batch) for _ in range(n_steps)]
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counted}
        core_launches = gc.gemm.launches  # inside K3-K6 and the K1 and K2 families
        log(f"  {n_steps} steps; launches {launches}, GEMM core {core_launches}")
        want = {name: per_step.get(name, 0) * n_steps for name in launches}
        if launches != want:
            raise RuntimeError(f"{tag}: launches in {n_steps} train steps must be {want}, "
                               f"got {launches}")
        check_core(tag, core_launches, launches, int(params.num_heads))
        metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
        for i, m in enumerate(metrics):
            log(f"    step {i + 1}: loss {m['loss']:.6f}, grad_norm {m['grad_norm']:.6f}")
        if not all(math.isfinite(v) for m in metrics for v in m.values()):
            raise RuntimeError(f"{tag}: non-finite loss or gradient norm")
        frozen = [n for n, p in model.named_parameters() if torch.equal(p, init[n])]
        if frozen:
            raise RuntimeError(f"{tag}: parameters the steps did not change: {frozen}")
        log(f"  all {len(init)} parameter tensors changed")
        if dropout is not None:
            # each mask is one sample's at one site: its kept share against
            # 1 - rate, within KEEP_SIGMAS binomial standard deviations
            worst, by_rate = 0.0, {}
            for kept, n, rate in shares:
                sigma = math.sqrt(rate * (1.0 - rate) / n)
                z = abs(int(kept) / n - (1.0 - rate)) / sigma
                worst = max(worst, z)
                by_rate.setdefault(rate, [0, 0, 0])
                by_rate[rate] = [by_rate[rate][0] + 1, by_rate[rate][1] + int(kept),
                                 by_rate[rate][2] + n]
            if not shares or worst > KEEP_SIGMAS:
                raise RuntimeError(f"{tag}: {len(shares)} dropout masks, the worst kept share "
                                   f"{worst:.2f} standard deviations from 1 - rate "
                                   f"(at most {KEEP_SIGMAS})")
            log(f"  {len(shares)} dropout masks built in the {n_steps} steps (each site's, "
                f"recomputed ones included); kept share by rate "
                + ", ".join(f"{r}: {k / n:.6f} of {n} over {c} masks"
                            for r, (c, k, n) in by_rate.items())
                + f"; the worst mask {worst:.2f} standard deviations from 1 - rate "
                f"(at most {KEEP_SIGMAS})")
        after = {n: p.detach().clone() for n, p in model.named_parameters()} if rerun else None

        if plain_step1:
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(init[n])
            # a step of its own (its optimizer's state is freed before the
            # kernel path is timed, so that path's peak holds none of it)
            with plain_train():
                plain_metrics = {k: float(v) for k, v in make_step()(batch).items()}
            if {fn.__name__: fn.launches for fn in counted} != launches:
                raise RuntimeError(f"{tag}: the plain path launched a kernel")
            log("  step 1, kernel path vs plain path (relative difference):")
            for key, ref_val in plain_metrics.items():
                got = metrics[0][key]
                rel = abs(got - ref_val) / abs(ref_val)
                tol = STEP_RTOL["loss" if key == "loss" else "grad_norm"]
                log(f"    {key}: {got:.6g} vs {ref_val:.6g}, rel {rel:.3g} (tol {tol:g})")
                if not rel <= tol:
                    raise RuntimeError(f"{tag} train step 1 {key}: kernel and plain path disagree")
            if set(plain_metrics) != set(metrics[0]):
                raise RuntimeError(f"{tag}: the two paths report different metrics")
        if rerun:
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(init[n])
            again = make_step()
            again = [{k: float(v) for k, v in again(batch).items()} for _ in range(n_steps)]
            differ = [n for n, p in model.named_parameters() if not torch.equal(p, after[n])]
            if again != metrics or differ:
                raise RuntimeError(f"{tag}: a rerun from the same weights and seed differs: "
                                   f"metrics {again} vs {metrics}, parameters {differ[:6]}")
            log(f"  a rerun of the {n_steps} steps from the same weights and generator seed: "
                "metrics and every parameter bit-equal")
            del after
        del init

        if eval_step:
            n_out = int(params.n_out_channels)
            eval_batch = synthetic_batch(params, dev, train=False)
            for fn in counted:
                fn.launches = 0
            ev = build_eval_step(model, loss_handler, preprocessor, n_out)(eval_batch)
            ev = {k: v.cpu() for k, v in ev.items()}
            ev_launches = {fn.__name__: fn.launches for fn in counted if fn.launches}
            if eval_want is not None and ev_launches != eval_want:
                raise RuntimeError(f"{tag} eval step: launches must be {eval_want}, got "
                                   f"{ev_launches}")
            log(f"  eval step launches {ev_launches}")
            if ev["rmse"].shape != (n_out,) or ev["acc"].shape != (n_out,) or not all(
                bool(torch.isfinite(v).all()) for v in ev.values()
            ):
                raise RuntimeError(f"{tag} eval step: wrong shapes or non-finite values")
            log(f"  eval step (RMSE/ACC of the last rollout step): loss {float(ev['loss']):.6f}, "
                f"mean rmse {float(ev['rmse'].mean()):.6f}, mean acc {float(ev['acc'].mean()):.6f}")
            del eval_batch

        k_ms, k_mem = train_ms(train_step, batch, n_timed)
        train_peaks[tag] = k_mem
        line = (f"{tag} train step {config}, batch 1: kernel path {k_ms:.2f} ms/step "
                f"({1000.0 / k_ms:.3f} samples/s, peak {k_mem:.3f} GiB)")
        if plain_timed:
            with plain_train():
                p_ms, p_mem = train_ms(make_step(), batch, n_timed)
            line += (f", plain path {p_ms:.2f} ms/step ({1000.0 / p_ms:.3f} samples/s, peak "
                     f"{p_mem:.3f} GiB)")
        log(f"{line}; {card}; GEMM core launches in the {n_steps} steps: {core_launches}")
        del model, train_step, batch
        torch.cuda.empty_cache()
        return {**launches, "gemm": core_launches}, k_ms

    depth = int(params.depth)
    # The configs train under their remat_policy (models/swin.py): 'mlp3' for
    # the flagship and its fine-tunes, 'full' for e2048. A step's backward
    # runs again the forward of every stage whose output it does not keep.
    # Under 'mlp3' that is the qkv-fused attention of the shifted blocks only
    # (an unshifted block's is one kernel call with a kept output, outside
    # the checkpoints), every K3 (fc2's weight gradient needs its output) and
    # every grid or windowed attention forward (their stage holds more than
    # the kernel); never K5 (kept output, one kernel call) nor a backward
    # kernel. Under 'full' every forward runs twice.
    qkv_mlp3 = depth + depth // 2  # qkv-fused attention forwards of a model call
    twice = 2 * depth
    # the same at ROUTE_DEPTH, the depth of the route variants' paths
    d4 = int(ROUTE_DEPTH["depth"])
    d4_mlp3 = d4 + d4 // 2
    train_launches, train_step_ms = train_path(
        "[9]", CONFIG, N_STEPS,
        {"window_attention_qkv": qkv_mlp3, "window_attention_qkv_bwd": depth,
         "fc1_gelu": twice, "fc1_dpre": depth},
        eval_step=True, plain_timed=True)

    clock.mark("11")
    # ---- 11. K5 and K6, the whole MLP, at flagship shapes ---------------------
    x2 = torch.randn((t_tok, c), generator=gen, device=dev).bfloat16()
    g2 = torch.randn((t_tok, c), generator=gen, device=dev).bfloat16()
    w1 = (2 * torch.rand((c, hidden), generator=gen, device=dev) - 1) / math.sqrt(c)
    b1 = 0.02 * torch.randn((hidden,), generator=gen, device=dev)
    w2 = (2 * torch.rand((hidden, c), generator=gen, device=dev) - 1) / math.sqrt(hidden)
    b2 = 0.02 * torch.randn((c,), generator=gen, device=dev)
    w1_16, w2_16 = w1.bfloat16(), w2.bfloat16()
    mlp_flops = 2 * t_tok * hidden * (c + c)
    log(f"[11] mlp_fwd / mlp_bwd: x2, g [{t_tok}, {c}] bf16, W1 [{c}, {hidden}], "
        f"W2 [{hidden}, {c}]")
    with torch.inference_mode():
        out = mk.mlp_fwd(x2, w1_16, b1, w2_16, b2)
        ref = mk.mlp_fwd_reference(x2, w1, b1, w2, b2)
    torch.cuda.synchronize()
    err = compare("mlp_fwd out", out, ref, MLP2_TOL)
    with torch.inference_mode():
        k_ms = time_ms(lambda: mk.mlp_fwd(x2, w1_16, b1, w2_16, b2), 20)
        p_ms = time_ms(lambda: mk.mlp_fwd_reference(x2, w1, b1, w2, b2), 5)
    log(f"  K5 kernel {k_ms:.4f} ms ({mlp_flops / k_ms / 1e9:.1f} TFLOP/s), plain {p_ms:.4f} ms "
        f"({card}); library call: none (no single PyTorch call computes fc1 + GELU + fc2)")
    with torch.inference_mode():
        k5_pieces = kernel_pieces(lambda: mk.mlp_fwd(x2, w1_16, b1, w2_16, b2), K5_PIECES)
    log(f"  K5 breakdown (torch.profiler, device ms a launch; {mk.mlp_fwd_plan(t_tok, c, hidden, c)['launches']} "
        f"launches of the GEMM core): " + ", ".join(f"{k} {v:.4f}" for k, v in k5_pieces.items())
        + f" ({card})")
    results["mlp_fwd"] = (err, k_ms, p_ms, bound(mlp_flops, nbytes(x2, w1_16, b1, w2_16, b2, out)))
    del out, ref
    with torch.inference_mode():
        out = mk.mlp_bwd(x2, w1_16, b1, w2_16, g2)
        ref = mk.mlp_bwd_reference(x2, w1, b1, w2, g2)
    torch.cuda.synchronize()
    err = max(compare("mlp_bwd a", out[0], ref[0], MLP_TOL),
              compare("mlp_bwd dpre", out[1], ref[1], MLP_TOL))
    with torch.inference_mode():
        k_ms = time_ms(lambda: mk.mlp_bwd(x2, w1_16, b1, w2_16, g2), 20)
        p_ms = time_ms(lambda: mk.mlp_bwd_reference(x2, w1, b1, w2, g2), 5)
    again = mk.mlp_bwd(x2, w1_16, b1, w2_16, g2)
    if not (torch.equal(again[0], out[0]) and torch.equal(again[1], out[1])):
        raise RuntimeError("mlp_bwd: two calls differ")
    del again
    log(f"  K6 kernel {k_ms:.4f} ms ({mlp_flops / k_ms / 1e9:.1f} TFLOP/s), plain {p_ms:.4f} ms "
        f"({card}); two calls bit-equal; library call: none (no single PyTorch call computes "
        f"(a, dpre))")
    with torch.inference_mode():
        k6_pieces = kernel_pieces(lambda: mk.mlp_bwd(x2, w1_16, b1, w2_16, g2), K6_PIECES)
    k6_plan = mk.mlp_bwd_plan(t_tok, c, hidden, c)
    log(f"  K6 breakdown (torch.profiler, device ms a launch; {k6_plan['launches']} launch of the "
        f"core's pair kernel, {k6_plan['bn']}-column tiles, {k6_plan['kept_words']} kept words a "
        f"thread): " + ", ".join(f"{k} {v:.4f}" for k, v in k6_pieces.items()) + f" ({card})")
    results["mlp_bwd"] = (err, k_ms, p_ms, bound(mlp_flops,
                                                 nbytes(x2, w1_16, b1, w2_16, g2, *out)))
    del x2, g2, w1, b1, w2, b2, w1_16, w2_16, out, ref
    torch.cuda.empty_cache()

    clock.mark("12-14")
    # ---- 12-14. the fine-tunes and depth 24 ------------------------------------
    whole_mlp = ("window_attention_qkv", "window_attention_qkv_bwd", "mlp_fwd", "mlp_bwd")
    launches_2step, _ = train_path(
        "[12]", CONFIG_2STEP, 3, {**{k: 2 * depth for k in whole_mlp},
                                  "window_attention_qkv": 2 * qkv_mlp3},
        eval_step=True, plain_timed=True)
    # the looped 4-step: each step's forward, its recompute in the backward
    # (the per-step checkpoint), then the block remat's recompute inside it
    # (at ROUTE_DEPTH: the 8-step of phase 49 runs the looped form at depth 12)
    launches_4step, _ = train_path(
        "[13]", CONFIG_4STEP, 2,
        {"window_attention_qkv": 4 * (d4 + d4_mlp3), "window_attention_qkv_bwd": 4 * d4,
         "mlp_fwd": 8 * d4, "mlp_bwd": 4 * d4},
        n_timed=2, overrides=ROUTE_DEPTH)
    # 3 steps: at batch 1 a branch of a deep block may be dropped in one or two
    # of them, and its parameters must still move
    launches_depth24, _ = train_path(
        "[14]", CONFIG_DEPTH24, 3, {**{k: 2 * depth for k in whole_mlp},
                                    "window_attention_qkv": 2 * qkv_mlp3},
        plain_step1=False, n_timed=2)

    clock.mark("15")
    # ---- 15. K7, the CPB-bias window attention, at flagship shapes -----------
    x = torch.randn((b, gh, gw, c), generator=gen, device=dev).bfloat16()
    g = torch.randn((b, gh, gw, c), generator=gen, device=dev).bfloat16()
    w_qkv = ((2 * torch.rand((c, 3 * c), generator=gen, device=dev) - 1) / math.sqrt(c))
    b_qkv = 0.02 * torch.randn((3 * c,), generator=gen, device=dev)
    scale = torch.exp(math.log(10.0) + 0.3 * torch.randn((heads,), generator=gen, device=dev))
    w16 = w_qkv.bfloat16()
    raw_bias = torch.randn((heads, l_win, l_win), generator=gen, device=dev)
    badd = wa.fold_cpb_bias(raw_bias, scale)
    log(f"[15] window_attention_qkv_bias (K7): x, g {tuple(x.shape)} bf16, W [{c}, {3 * c}] bf16, "
        f"badd {tuple(badd.shape)} fp32, window {window}")
    k7_errs, k7 = {}, {}
    for label, mask in (("unshifted", None), ("shifted", pattern)):
        with torch.inference_mode():
            out = wa.window_attention_qkv_bias(x, w16, b_qkv, scale, badd, window, mask, 1.0)
            ref = wa.window_attention_qkv_bias_reference(x, w_qkv, b_qkv, scale, badd, window,
                                                          mask)
        torch.cuda.synchronize()
        k7_errs["out"] = max(compare(f"{label} out", out, ref, ATTN_TOL), k7_errs.get("out", 0.0))
        grads = wa.window_attention_qkv_bias_bwd(x, w16, b_qkv, scale, badd, g, window, mask, 1.0)
        ref_g = wa.window_attention_qkv_bias_backward_reference(x, w16, b_qkv, scale, badd, g,
                                                                 window, mask)
        torch.cuda.synchronize()
        for name, o, r in zip(("dx", "dW", "db", "dscale", "dbias"), grads, ref_g):
            err = compare(f"{label} {name}", o, r, BWD_TOL[name])
            k7_errs[name] = max(err, k7_errs.get(name, 0.0))
        again = wa.window_attention_qkv_bias_bwd(x, w16, b_qkv, scale, badd, g, window, mask, 1.0)
        if not all(torch.equal(a, o) for a, o in zip(again, grads)):
            raise RuntimeError("window_attention_qkv_bias_bwd: two calls differ (reduction order)")
        with torch.inference_mode():
            f_ms = time_ms(lambda: wa.window_attention_qkv_bias(
                x, w16, b_qkv, scale, badd, window, mask, 1.0), 20)
            fp_ms = time_ms(lambda: wa.window_attention_qkv_bias_reference(
                x, w_qkv, b_qkv, scale, badd, window, mask), 5)
        b_ms = time_ms(lambda: wa.window_attention_qkv_bias_bwd(
            x, w16, b_qkv, scale, badd, g, window, mask, 1.0), 10)
        bp_ms = time_ms(lambda: wa.window_attention_qkv_bias_backward_reference(
            x, w16, b_qkv, scale, badd, g, window, mask), 3)
        log(f"  {label}: forward kernel {f_ms:.4f} ms, plain {fp_ms:.4f} ms; backward kernel "
            f"{b_ms:.4f} ms, plain {bp_ms:.4f} ms ({card}); two backward calls bit-equal")
        k7.setdefault("fwd", (f_ms, fp_ms))
        k7.setdefault("bwd", (b_ms, bp_ms))
    # K7's work: K1's and K2's plus the [L, L] bias term per (window, head)
    # (bias read once; the backward writes dbias once)
    results["window_attention_qkv_bias"] = (k7_errs["out"], *k7["fwd"], bound(
        2 * t_tok * c * 3 * c + attn_flops, nbytes(x, w16, b_qkv, scale, badd, out)))
    results["window_attention_qkv_bias_bwd"] = (k7_errs["dx"], *k7["bwd"], bound(
        3 * 2 * t_tok * c * 3 * c + 5 * attn_flops / 2,
        nbytes(x, w16, b_qkv, scale, badd, g, *grads)))
    del x, g, out, ref, grads, ref_g, again, w_qkv, w16, b_qkv, scale, raw_bias, badd
    torch.cuda.empty_cache()

    clock.mark("16")
    # ---- 16. CPB serving -------------------------------------------------------
    params = train_params(CONFIG, CPB)
    model = seeded_model(params, dev, SEED)
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    back = params_from_jax(params_to_jax(state))
    if set(back) != set(state) or not all(torch.equal(back[k], state[k]) for k in state):
        raise RuntimeError("CPB state_dict -> JAX layout -> state_dict round trip is not exact")
    n_meta = sum(1 for k in state if ".meta_mlp." in k)
    log(f"[16] CPB serving: {CONFIG} {CPB}, {sum(p.numel() for p in model.parameters())} "
        f"parameters ({n_meta} meta_mlp tensors); JAX-layout round trip exact")
    engine = RolloutEngine(params, model, dev)
    for fn in counted:
        fn.launches = 0
    gc.gemm.launches = 0
    torch.cuda.reset_peak_memory_stats()
    preds = engine.rollout(state0, START, N_STEPS)
    cpb_serve_launches = {fn.__name__: fn.launches for fn in counted}
    cpb_serve_core = gc.gemm.launches  # K7's projection and K3
    log(f"  rollout {N_STEPS} steps -> {preds.shape}; launches {cpb_serve_launches}, GEMM core "
        f"{cpb_serve_core}")
    expected = {n: want if n in ("window_attention_qkv_bias", "fc1_gelu") else 0
                for n in cpb_serve_launches}
    if cpb_serve_launches != expected:
        raise RuntimeError(f"the CPB rollout must launch {expected}, got {cpb_serve_launches}")
    check_core("[16]", cpb_serve_core, cpb_serve_launches, int(params.num_heads))
    if preds.shape != (N_STEPS, 1, n_out, *params.img_size) or not np.isfinite(preds).all():
        raise RuntimeError("CPB rollout output has the wrong shape or non-finite values")
    with plain_train():
        plain1 = next(engine.steps(state0, START, 1))
    if {fn.__name__: fn.launches for fn in counted} != cpb_serve_launches:
        raise RuntimeError("the CPB plain path launched a kernel")
    compare("step 1 kernel path vs plain path", torch.from_numpy(preds[0]), plain1.cpu(), MODEL_TOL)
    torch.cuda.reset_peak_memory_stats()
    cpb_step = rollout_ms()
    cpb_mem = torch.cuda.max_memory_allocated() / 2**30
    with plain_train():
        torch.cuda.reset_peak_memory_stats()
        cpb_plain_step = rollout_ms()
        cpb_plain_mem = torch.cuda.max_memory_allocated() / 2**30
    log(f"  CPB rollout: kernel path {cpb_step:.2f} ms/step (peak {cpb_mem:.3f} GiB), plain path "
        f"{cpb_plain_step:.2f} ms/step (peak {cpb_plain_mem:.3f} GiB); flagship kernel path "
        f"{kernel_step:.2f} ms/step in phase 6; {card}")
    del engine, model, preds, plain1, state, back
    torch.cuda.empty_cache()

    clock.mark("17")
    # ---- 17. CPB training ------------------------------------------------------
    launches_cpb, _ = train_path(
        "[17]", CONFIG, N_STEPS,
        {"window_attention_qkv_bias": d4_mlp3, "window_attention_qkv_bias_bwd": d4,
         "fc1_gelu": 2 * d4, "fc1_dpre": d4},
        eval_step=True, plain_timed=True, overrides={**CPB, **ROUTE_DEPTH})

    clock.mark("18")
    # ---- 18. K11, fused LayerNorm + drop-path + add, at flagship shapes -------
    keep = float(np.float32(1.0) - np.float32(0.1))
    z2 = (2.0 * torch.randn((t_tok, c), generator=gen, device=dev) + 0.5).bfloat16()
    x2 = torch.randn((t_tok, c), generator=gen, device=dev).bfloat16()
    g2 = torch.randn((t_tok, c), generator=gen, device=dev).bfloat16()
    gamma = 1.0 + 0.1 * torch.randn((c,), generator=gen, device=dev)
    beta = 0.1 * torch.randn((c,), generator=gen, device=dev)
    drop = torch.rand((t_tok, 1), generator=gen, device=dev) < 0.5
    m2 = torch.where(drop, 0.0, 1.0 / keep).float()
    log(f"[18] ln_dp_add (K11): z, x, g [{t_tok}, {c}] bf16, m mixed 0 / 1/keep "
        f"({float(drop.float().mean()):.3f} dropped)")
    with torch.inference_mode():
        out = lk.ln_dp_add_fwd(z2, x2, gamma, beta, m2)
        ref = lk.ln_dp_add_fwd_reference(z2, x2, gamma, beta, m2)
    torch.cuda.synchronize()
    ln_errs = {"out": compare("out", out, ref, LN_TOL["out"])}
    grads = lk.ln_dp_add_bwd(z2, g2, gamma, m2)
    ref_g = lk.ln_dp_add_bwd_reference(z2, g2, gamma, m2)
    torch.cuda.synchronize()
    for name, o, r in zip(("dz", "dgamma", "dbeta"), grads, ref_g):
        ln_errs[name] = compare(name, o, r, LN_TOL[name])
    again = lk.ln_dp_add_bwd(z2, g2, gamma, m2)
    if not all(torch.equal(a, o) for a, o in zip(again, grads)):
        raise RuntimeError("ln_dp_add_bwd: two calls differ (reduction order)")
    g16, b16 = gamma.bfloat16(), beta.bfloat16()
    with torch.inference_mode():
        lf_ms = time_ms(lambda: lk.ln_dp_add_fwd(z2, x2, gamma, beta, m2), 50)
        lfp_ms = time_ms(lambda: lk.ln_dp_add_fwd_reference(z2, x2, gamma, beta, m2), 10)
        lb_ms = time_ms(lambda: lk.ln_dp_add_bwd(z2, g2, gamma, m2), 50)
        lbp_ms = time_ms(lambda: lk.ln_dp_add_bwd_reference(z2, g2, gamma, m2), 10)
        ln_ms = time_ms(lambda: torch.nn.functional.layer_norm(z2, (c,), g16, b16, 1e-5), 50)
    log(f"  forward kernel {lf_ms:.4f} ms, plain {lfp_ms:.4f} ms; backward kernel {lb_ms:.4f} ms, "
        f"plain {lbp_ms:.4f} ms; two backward calls bit-equal; F.layer_norm alone (bf16, "
        f"context only) {ln_ms:.4f} ms ({card}); library call: none (no single PyTorch call "
        f"computes LayerNorm + drop-path + residual add)")
    # K11's work: about 10 (forward) and 14 (backward) fp32 FLOP an element
    # (at the fp32 peak), far below the bytes: z and x (or g) read, out (or dz)
    # written once, plus the [C] vectors, the [T, 1] multipliers and the [C]
    # gradients
    results["ln_dp_add_fwd"] = (ln_errs["out"], lf_ms, lfp_ms, bound(
        10 * t_tok * c, nbytes(z2, x2, gamma, beta, m2, out), PEAK_FP32_FLOPS))
    results["ln_dp_add_bwd"] = (ln_errs["dz"], lb_ms, lbp_ms, bound(
        14 * t_tok * c, nbytes(z2, g2, gamma, m2, *grads), PEAK_FP32_FLOPS))
    del z2, x2, g2, out, ref, grads, ref_g, again
    # the streamed-row instance (rows above 2048 channels), at [64800, 3072]
    cs_ = 3072
    z2 = (2.0 * torch.randn((t_tok, cs_), generator=gen, device=dev) + 0.5).bfloat16()
    x2 = torch.randn((t_tok, cs_), generator=gen, device=dev).bfloat16()
    g2 = torch.randn((t_tok, cs_), generator=gen, device=dev).bfloat16()
    gamma_s = 1.0 + 0.1 * torch.randn((cs_,), generator=gen, device=dev)
    beta_s = 0.1 * torch.randn((cs_,), generator=gen, device=dev)
    with torch.inference_mode():
        out = lk.ln_dp_add_fwd(z2, x2, gamma_s, beta_s, m2)
        ref = lk.ln_dp_add_fwd_reference(z2, x2, gamma_s, beta_s, m2)
    grads = lk.ln_dp_add_bwd(z2, g2, gamma_s, m2)
    ref_g = lk.ln_dp_add_bwd_reference(z2, g2, gamma_s, m2)
    torch.cuda.synchronize()
    ln_wide = {"out": compare("streamed out", out, ref, LN_TOL["out"])}
    for name, o, r in zip(("dz", "dgamma", "dbeta"), grads, ref_g):
        ln_wide[name] = compare(f"streamed {name}", o, r, LN_TOL[name])
    again = lk.ln_dp_add_bwd(z2, g2, gamma_s, m2)
    if not all(torch.equal(a, o) for a, o in zip(again, grads)):
        raise RuntimeError("ln_dp_add_bwd above 2048 channels: two calls differ (reduction order)")
    del again
    with torch.inference_mode():
        lwf_ms = time_ms(lambda: lk.ln_dp_add_fwd(z2, x2, gamma_s, beta_s, m2), 20)
        lwfp_ms = time_ms(lambda: lk.ln_dp_add_fwd_reference(z2, x2, gamma_s, beta_s, m2), 5)
        lwb_ms = time_ms(lambda: lk.ln_dp_add_bwd(z2, g2, gamma_s, m2), 20)
        lwbp_ms = time_ms(lambda: lk.ln_dp_add_bwd_reference(z2, g2, gamma_s, m2), 5)
    log(f"  streamed rows at [{t_tok}, {cs_}]: forward kernel {lwf_ms:.4f} ms, plain "
        f"{lwfp_ms:.4f} ms; backward kernel (z and g staged, read once) {lwb_ms:.4f} ms, plain "
        f"{lwbp_ms:.4f} ms; two backward calls bit-equal ({card})")
    ln_streamed = {
        "fwd": {"shape": [t_tok, cs_], "max_abs_err": ln_wide["out"], "ms": lwf_ms,
                "plain_ms": lwfp_ms, "bound_ms": bound(10 * t_tok * cs_, nbytes(
                    z2, x2, gamma_s, beta_s, m2, out), PEAK_FP32_FLOPS)[0]},
        "bwd": {"shape": [t_tok, cs_], "max_abs_err": ln_wide["dz"], "ms": lwb_ms,
                "plain_ms": lwbp_ms, "bound_ms": bound(14 * t_tok * cs_, nbytes(
                    z2, g2, gamma_s, m2, *grads), PEAK_FP32_FLOPS)[0]}}
    del z2, x2, g2, out, ref, grads, ref_g, gamma_s, beta_s
    torch.cuda.empty_cache()

    clock.mark("19")
    # ---- 19. the fused-LayerNorm flagship train step ---------------------------
    launches_lnadd, lnadd_ms = train_path(
        "[19]", CONFIG, 3,
        # 'mlp3' keeps attn_kernel_out only here, so both K11 branches run again
        {"window_attention_qkv": qkv_mlp3, "window_attention_qkv_bwd": depth, "fc1_gelu": twice,
         "fc1_dpre": depth, "ln_dp_add_fwd": 4 * depth, "ln_dp_add_bwd": 2 * depth},
        overrides=LNADD)
    log(f"[19] fused LayerNorm route {lnadd_ms:.2f} ms/step against the unfused flagship step "
        f"{train_step_ms:.2f} ms/step of phase 10 ({card})")

    clock.mark("20-26")
    # ---- 20-26: the grid (K8), windowed (K9) and 'xla' routes -------------------
    library = {}  # name -> library_ms (SDPA for the K8/K9 forwards and backwards)
    breakdowns = {}  # name -> device ms a launch by piece (the streamed backwards)
    launch = {}  # name -> the K8/K9 forward's launch report (threads, shared memory, ...)

    def sdpa_ms(bias, hd: int) -> float:
        """One scaled_dot_product_attention call on windowed tensors [400,
        heads, 162, hd] bf16 (the flagship's at hd 96) with ``bias`` [heads,
        162, 162] as a bf16 additive mask (one scalar scale; the per-head
        scale and the q/k normalization are left out)."""
        shape = (b * (gh // window[0]) * (gw // window[1]), bias.shape[0], l_win, hd)
        qw, kw, vw = (torch.randn(shape, generator=gen, device=dev).bfloat16() for _ in range(3))
        mask16 = bias.bfloat16()
        with torch.inference_mode():
            return time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qw, kw, vw, attn_mask=mask16), 20)

    def qkv_kernel_phase(tag: str, layout: str, ops, g, scale, raw_bias, window_arg,
                         suffix: str = "", shifted_only: bool = False):
        """K8 (layout "grid") or K9 ("v1"), bias-free and BIAS, forward and
        backward against their plain versions, unshifted and shifted (or
        shifted only); two backward calls bit-equal; timed; fills ``results``
        and ``library`` under the kernel's name plus ``suffix``."""
        heads_ = int(scale.shape[0])
        hd_ = ops[0].shape[-1] // (heads_ if layout == "grid" else 1)
        flops = attn_flops * hd_ * heads_ // c  # two [L, L, hd] products per (window, head)
        lib_ms = sdpa_ms(raw_bias, hd_)
        nwin = b * (gh // window[0]) * (gw // window[1])
        lib_bwd, why = bb.sdpa_bwd_ms((nwin, heads_, l_win, hd_), raw_bias, gen)
        log(f"  scaled_dot_product_attention on the windowed tensors [.., {heads_}, {l_win}, "
            f"{hd_}] with the bias as a float mask: forward {lib_ms:.4f} ms, backward "
            + (f"{lib_bwd:.4f} ms" if lib_bwd is not None else f"null ({why})")
            + f" ({card}; library yardstick, never called by the port); kernel variants: "
            f"forward {wa.attn_variant('', hd_, l_win, False, layout)}, backward "
            f"{wa.attn_variant('', hd_, l_win, True, layout)}")
        # K8/K9's: 5 head dims x 2 layouts x bias-free and BIAS x 2 paths
        spills = {k: v for k, v in fwd_spills().items() if k[1] in (0, 1)}
        if len(spills) != 40 or any(any(sp) for sp in spills.values()):
            raise RuntimeError(f"the K8/K9 forward instances must all build without spills: "
                               f"{spills}")
        masks = (("shifted", pattern),) if shifted_only else (("unshifted", None),
                                                              ("shifted", pattern))
        for bias in (None, raw_bias):
            kind = f"window_attention_{layout}" + ("" if bias is None else "_bias")
            fwd, bwd = getattr(wa, kind), getattr(wa, kind + "_bwd")
            extra = () if bias is None else (bias,)
            errs, times = {}, {}
            for label, mask in masks:
                tail = (window_arg, mask, 1.0) if layout == "grid" else (window_arg, mask)
                with torch.inference_mode():
                    out = fwd(*ops, scale, *extra, *tail)
                    ref = plain_version(fwd)(*ops, scale, *extra, *tail)
                torch.cuda.synchronize()
                errs["out"] = max(compare(f"{kind} {label} out", out, ref, ATTN_TOL),
                                  errs.get("out", 0.0))
                grads = bwd(*ops, scale, *extra, g, *tail)
                ref_g = plain_version(bwd)(*ops, scale, *extra, g, *tail)
                torch.cuda.synchronize()
                if [t.dtype for t in grads] != [torch.bfloat16] * 3 + [torch.float32] * (
                        1 + len(extra)):
                    raise RuntimeError(f"{kind}_bwd: wrong output dtypes")
                for name, o, r in zip(("dq", "dk", "dv", "dscale", "dbias"), grads, ref_g):
                    errs[name] = max(compare(f"{kind} {label} {name}", o, r, BWD_TOL[name]),
                                     errs.get(name, 0.0))
                again = bwd(*ops, scale, *extra, g, *tail)
                if not all(torch.equal(a_, o) for a_, o in zip(again, grads)):
                    raise RuntimeError(f"{kind}_bwd: two calls differ (reduction order)")
                with torch.inference_mode():
                    f_ms = time_ms(lambda: fwd(*ops, scale, *extra, *tail), 20)
                    f_us = host_us(lambda: fwd(*ops, scale, *extra, *tail))
                    fp_ms = time_ms(lambda: plain_version(fwd)(*ops, scale, *extra, *tail), 5)
                b_ms = time_ms(lambda: bwd(*ops, scale, *extra, g, *tail), 10)
                bp_ms = time_ms(lambda: plain_version(bwd)(*ops, scale, *extra, g, *tail), 3)
                if kind + "_bwd" + suffix not in breakdowns:  # the streamed backward's pieces
                    breakdowns[kind + "_bwd" + suffix] = kernel_pieces(
                        lambda: bwd(*ops, scale, *extra, g, *tail),
                        bb.K9_PIECES if layout == "v1" else bb.K8_LARGE_PIECES, n=3)
                    log(f"  {kind}_bwd {label} breakdown (torch.profiler, device ms a launch): "
                        + pieces_line(breakdowns[kind + "_bwd" + suffix]) + "; beside SDPA's "
                        "backward " + (f"{lib_bwd:.4f} ms" if lib_bwd is not None else "null")
                        + f" ({card})")
                if kind + "_bwd" + suffix not in launch:
                    info_b = (wa.streamed_bwd_info if layout == "v1" else wa.grid_streamed_bwd_info)(
                        hd_, l_win, bias is not None)
                    if info_b["rows_local_bytes"] or info_b["cols_local_bytes"]:
                        raise RuntimeError(f"{kind}_bwd at head dim {hd_}: local (spill) bytes "
                                           f"{info_b}")
                    log(f"  {kind}_bwd launch (the streamed kernels): {info_b['threads']} threads "
                        f"a block, {info_b['blocks_per_window']} blocks per (window, head); rows "
                        f"kernel {info_b['rows_smem']} B shared memory, {info_b['rows_registers']}"
                        f" registers, {info_b['rows_local_bytes']} B local, "
                        f"{info_b['rows_blocks_per_sm']} blocks an SM; columns kernel "
                        f"{info_b['cols_smem']} B, {info_b['cols_registers']} registers, "
                        f"{info_b['cols_local_bytes']} B local, {info_b['cols_blocks_per_sm']} "
                        f"blocks an SM")
                    launch[kind + "_bwd" + suffix] = info_b
                log(f"  {kind} {label}: forward kernel {f_ms:.4f} ms, plain {fp_ms:.4f} ms; "
                    f"backward kernel {b_ms:.4f} ms, plain {bp_ms:.4f} ms ({card}); two backward "
                    f"calls bit-equal")
                info = wa.attn_fwd_info("grid" if layout == "grid" else "v1", hd_, l_win,
                                        bias is not None)
                spilled = spills[hd_, 0 if layout == "grid" else 1, bias is not None,
                                 info["z_path"] == 1, hd_]
                log(f"  {kind} {label} forward launch: {info['threads']} threads a block, "
                    f"{info['smem']} B dynamic shared memory, {info['registers']} registers, "
                    f"{info['local_bytes']} B local (spill) a thread and {spilled} B spill "
                    f"stores/loads in the ptxas log, {info['blocks_per_sm']} resident blocks per "
                    f"SM, {info['blocks_per_window']} blocks per (window, head), "
                    f"{'z in registers' if info['z_path'] else 'streamed two sweeps'}; the "
                    f"wrapper's host {f_us:.1f} us per call against the kernel's "
                    f"{f_ms * 1e3:.1f} us: the {'kernel' if f_us < f_ms * 1e3 else 'host'} bounds "
                    f"the timed calls")
                launch.setdefault(kind + suffix, {**info, "host_us": f_us})
                times.setdefault("fwd", (f_ms, fp_ms))
                times.setdefault("bwd", (b_ms, bp_ms))
            # two [L, L, hd] products per (window, head) forward, five backward;
            # bytes: each input read once, each output written once
            results[kind + suffix] = (errs["out"], *times["fwd"], bound(
                flops, nbytes(*ops, scale, *extra, out)))
            results[kind + "_bwd" + suffix] = (errs["dq"], *times["bwd"], bound(
                5 * flops / 2, nbytes(*ops, scale, *extra, g, *grads)))
            results[kind + "_bwd" + suffix] += ({k: v for k, v in errs.items() if k != "out"},)
            library[kind + suffix] = lib_ms
            library[kind + "_bwd" + suffix] = lib_bwd
            del out, ref, grads, ref_g, again
        torch.cuda.empty_cache()

    def serve_path(tag: str, overrides: dict, n_steps: int, per_step: dict, config: str = CONFIG,
                   weights_on=None):
        """get_model -> RolloutEngine.rollout for n_steps on seeded weights
        (drawn on ``weights_on``, the CPU unless given): the launches
        (per_step[name] a step, 0 if absent), finite output of the right
        shape, step 1 against the plain path; ms/step and peak."""
        params = train_params(config, overrides)
        model = seeded_model(params, dev, SEED, weights_on)
        engine = RolloutEngine(params, model, dev)
        # the flagship's initial state of phase 5, or one of this config's shape
        init = state0 if config == CONFIG else torch.randn(
            (1, int(params.n_out_channels), *params.img_size),
            generator=torch.Generator().manual_seed(SEED))
        for fn in counted:
            fn.launches = 0
        gc.gemm.launches = 0
        torch.cuda.reset_peak_memory_stats()
        preds = engine.rollout(init, START, n_steps)
        got = {fn.__name__: fn.launches for fn in counted}
        core_launches = gc.gemm.launches
        log(f"{tag} serving {config} {overrides}: {tuple(params.img_size)}, embed "
            f"{params.embed_dim}, depth {params.depth}, "
            f"{sum(p.numel() for p in model.parameters())} parameters; rollout {n_steps} steps -> "
            f"{preds.shape}; launches {got}")
        expected = {name: per_step.get(name, 0) * n_steps for name in got}
        if got != expected:
            raise RuntimeError(f"{tag}: the rollout must launch {expected}, got {got}")
        check_core(tag, core_launches, got, int(params.num_heads))
        want_shape = (n_steps, 1, int(params.n_out_channels), *params.img_size)
        if preds.shape != want_shape or not np.isfinite(preds).all():
            raise RuntimeError(f"{tag}: rollout output has the wrong shape or non-finite values")
        with plain_train():
            plain1 = next(engine.steps(init, START, 1))
        if {fn.__name__: fn.launches for fn in counted} != got:
            raise RuntimeError(f"{tag}: the plain path launched a kernel")
        compare("step 1 kernel path vs plain path", torch.from_numpy(preds[0]), plain1.cpu(),
                MODEL_TOL)
        if n_steps > 1:
            steps = engine.steps(init, START, n_steps)
            next(steps)  # warm-up step
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in steps:
                pass
            end.record()
            end.synchronize()
            log(f"  rollout: kernel path {start.elapsed_time(end) / (n_steps - 1):.2f} ms/step "
                f"(peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB); {card}")
        del engine, model, preds, plain1
        torch.cuda.empty_cache()
        return {**got, "gemm": core_launches}

    qkv = torch.randn((b, gh, gw, 3 * c), generator=gen, device=dev).bfloat16()
    g = torch.randn((b, gh, gw, c), generator=gen, device=dev).bfloat16()
    scale = torch.exp(math.log(10.0) + 0.3 * torch.randn((heads,), generator=gen, device=dev))
    raw_bias = 2.0 * torch.randn((heads, l_win, l_win), generator=gen, device=dev)
    qn, _ = wa.normalize_heads(qkv[..., :c], heads)
    kn, _ = wa.normalize_heads(qkv[..., c:2 * c], heads)
    log(f"[20] K8 window_attention_grid(_bias)(_bwd): qn, kn {tuple(qn.shape)} bf16, v a channel "
        f"slice of qkv {tuple(qkv.shape)} (pixel stride {qkv[..., 2 * c:].stride(2)}), raw bias "
        f"{tuple(raw_bias.shape)} fp32, window {window}")
    qkv_kernel_phase("[20]", "grid", (qn, kn, qkv[..., 2 * c:]), g, scale, raw_bias, window)
    del qkv, qn, kn

    grid_kernels = ("window_attention_grid", "window_attention_grid_bwd", "fc1_gelu", "fc1_dpre")
    serve_grid = serve_path("[21]", {**GRID_ROUTE, **ROUTE_DEPTH}, N_STEPS,
                            {"window_attention_grid": d4, "fc1_gelu": d4})
    launches_grid, grid_ms = train_path(
        "[21]", CONFIG, 3, {**{k: d4 for k in grid_kernels}, "window_attention_grid": 2 * d4,
                            "fc1_gelu": 2 * d4}, overrides={**GRID_ROUTE, **ROUTE_DEPTH})
    log(f"[21] grid route at depth {d4}: {grid_ms:.2f} ms/step ({card})")
    launches_grid_cpb, _ = train_path(
        "[22]", CONFIG, 2,
        {"window_attention_grid_bias": 2 * d4, "window_attention_grid_bias_bwd": d4,
         "fc1_gelu": 2 * d4, "fc1_dpre": d4},
        n_timed=2, overrides={**GRID_ROUTE, **CPB, **ROUTE_DEPTH})

    nw = b * (gh // window[0]) * (gw // window[1])
    q, k, v = (torch.randn((nw, heads, l_win, c // heads), generator=gen, device=dev).bfloat16()
               for _ in range(3))
    g = torch.randn((nw, heads, l_win, c // heads), generator=gen, device=dev).bfloat16()
    log(f"[23] K9 window_attention_v1(_bias)(_bwd): q, k, v {tuple(q.shape)} bf16, raw bias "
        f"{tuple(raw_bias.shape)} fp32")
    qkv_kernel_phase("[23]", "v1", (q, k, v), g, scale, raw_bias,
                     (gh // window[0], gw // window[1]))
    del q, k, v, g, scale, raw_bias

    v1_kernels = ("window_attention_v1", "window_attention_v1_bwd", "fc1_gelu", "fc1_dpre")
    serve_v1 = serve_path("[24]", {**V1_ROUTE, **ROUTE_DEPTH}, N_STEPS,
                          {"window_attention_v1": d4, "fc1_gelu": d4})
    launches_v1, v1_ms = train_path(
        "[24]", CONFIG, 3, {**{k: d4 for k in v1_kernels}, "window_attention_v1": 2 * d4,
                            "fc1_gelu": 2 * d4}, overrides={**V1_ROUTE, **ROUTE_DEPTH})
    log(f"[24] windowed route {v1_ms:.2f} ms/step against the grid route's {grid_ms:.2f} ms/step "
        f"({card})")
    launches_v1_cpb, _ = train_path(
        "[25]", CONFIG, 2,
        {"window_attention_v1_bias": 2 * d4, "window_attention_v1_bias_bwd": d4,
         "fc1_gelu": 2 * d4, "fc1_dpre": d4},
        n_timed=2, overrides={**V1_ROUTE, **CPB, **ROUTE_DEPTH})
    serve_xla = serve_path("[26]", {**XLA_ROUTE, **ROUTE_DEPTH}, 1, {"fc1_gelu": d4})

    clock.mark("27")
    # ---- 27. the e2048 widths: K1 (the pass at head dim 256), K2 (streamed
    # variant), one K7 case, K5/K6 ----
    ce, he, hide = 2048, 8, 4096
    x = torch.randn((b, gh, gw, ce), generator=gen, device=dev).bfloat16()
    g = torch.randn((b, gh, gw, ce), generator=gen, device=dev).bfloat16()
    w_qkv = (2 * torch.rand((ce, 3 * ce), generator=gen, device=dev) - 1) / math.sqrt(ce)
    b_qkv = 0.02 * torch.randn((3 * ce,), generator=gen, device=dev)
    scale = torch.exp(math.log(10.0) + 0.3 * torch.randn((he,), generator=gen, device=dev))
    w16 = w_qkv.bfloat16()
    log(f"[27] e2048 attention: x, g {tuple(x.shape)} bf16, W [{ce}, {3 * ce}] bf16, {he} heads of "
        f"{ce // he}, window {window}, shifted; kernel variants: forward "
        f"{wa.qkv_variant('', ce // he, l_win, False)}, backward "
        f"{wa.qkv_variant('', ce // he, l_win, True)}")
    # the projection, then two [L, L, 256] products per (window, head)
    e_attn_flops = 4 * l_win * l_win * ce * (t_tok // l_win)
    e_fwd_flops, e_bwd_flops = 2 * t_tok * ce * 3 * ce + e_attn_flops, (
        3 * 2 * t_tok * ce * 3 * ce + 5 * e_attn_flops / 2)
    with torch.inference_mode():
        out = wa.window_attention_qkv(x, w16, b_qkv, scale, window, pattern, 1.0)
        ref = wa.window_attention_qkv_reference(x, w_qkv, b_qkv, scale, window, pattern)
    torch.cuda.synchronize()
    err = compare("K1 out", out, ref, ATTN_TOL)
    with torch.inference_mode():
        f_ms = time_ms(lambda: wa.window_attention_qkv(x, w16, b_qkv, scale, window, pattern, 1.0), 5)
        fp_ms = time_ms(lambda: wa.window_attention_qkv_reference(
            x, w_qkv, b_qkv, scale, window, pattern), 2)
    results["window_attention_qkv_e2048"] = (err, f_ms, fp_ms, bound(
        e_fwd_flops, nbytes(x, w16, b_qkv, scale, out)))
    del out, ref
    grads = wa.window_attention_qkv_bwd(x, w16, b_qkv, scale, g, window, pattern, 1.0)
    ref_g = wa.window_attention_qkv_backward_reference(x, w16, b_qkv, scale, g, window, pattern)
    torch.cuda.synchronize()
    e_errs = {name: compare(f"K2 {name}", o, r, BWD_TOL[name])
              for name, o, r in zip(("dx", "dW", "db", "dscale"), grads, ref_g)}
    again = wa.window_attention_qkv_bwd(x, w16, b_qkv, scale, g, window, pattern, 1.0)
    if not all(torch.equal(a_, o) for a_, o in zip(again, grads)):
        raise RuntimeError("window_attention_qkv_bwd (e2048): two calls differ")
    del ref_g, again
    b_ms = time_ms(lambda: wa.window_attention_qkv_bwd(x, w16, b_qkv, scale, g, window, pattern,
                                                        1.0), 3)
    bp_ms = time_ms(lambda: wa.window_attention_qkv_backward_reference(
        x, w16, b_qkv, scale, g, window, pattern), 1)
    with torch.inference_mode():
        k1e_pieces = kernel_pieces(lambda: wa.window_attention_qkv(
            x, w16, b_qkv, scale, window, pattern, 1.0), K1_PIECES, n=3)
    breakdowns["window_attention_qkv_bwd_e2048"] = kernel_pieces(
        lambda: wa.window_attention_qkv_bwd(x, w16, b_qkv, scale, g, window, pattern, 1.0),
        bb.K2_LARGE_PIECES, n=3)
    log(f"  K1 forward {f_ms:.4f} ms (breakdown: " + ", ".join(
        f"{k} {v:.4f}" for k, v in k1e_pieces.items()) + f"; pass launch "
        f"{wa.qkv_fwd_info(ce // he, l_win)}), plain {fp_ms:.4f} ms; K2 backward {b_ms:.4f} ms "
        f"(breakdown: " + pieces_line(breakdowns["window_attention_qkv_bwd_e2048"])
        + f"), plain {bp_ms:.4f} ms ({card}); two backward calls bit-equal")
    results["window_attention_qkv_bwd_e2048"] = (e_errs["dx"], b_ms, bp_ms, bound(
        e_bwd_flops, nbytes(x, w16, b_qkv, scale, g, *grads)), e_errs)
    del grads
    badd = wa.fold_cpb_bias(torch.randn((he, l_win, l_win), generator=gen, device=dev), scale)
    with torch.inference_mode():
        out = wa.window_attention_qkv_bias(x, w16, b_qkv, scale, badd, window, pattern, 1.0)
        ref = wa.window_attention_qkv_bias_reference(x, w_qkv, b_qkv, scale, badd, window, pattern)
    torch.cuda.synchronize()
    k7e = {"out": compare("K7 out", out, ref, ATTN_TOL)}
    del ref
    grads = wa.window_attention_qkv_bias_bwd(x, w16, b_qkv, scale, badd, g, window, pattern, 1.0)
    ref_g = wa.window_attention_qkv_bias_backward_reference(x, w16, b_qkv, scale, badd, g, window,
                                                             pattern)
    torch.cuda.synchronize()
    for name, o, r in zip(("dx", "dW", "db", "dscale", "dbias"), grads, ref_g):
        k7e[name] = compare(f"K7 {name}", o, r, BWD_TOL[name])
    again = wa.window_attention_qkv_bias_bwd(x, w16, b_qkv, scale, badd, g, window, pattern, 1.0)
    if not all(torch.equal(a_, o) for a_, o in zip(again, grads)):
        raise RuntimeError("window_attention_qkv_bias_bwd (e2048): two calls differ")
    del ref_g, again
    with torch.inference_mode():
        k7f_ms = time_ms(lambda: wa.window_attention_qkv_bias(
            x, w16, b_qkv, scale, badd, window, pattern, 1.0), 5)
    k7b_ms = time_ms(lambda: wa.window_attention_qkv_bias_bwd(
        x, w16, b_qkv, scale, badd, g, window, pattern, 1.0), 3)
    with torch.inference_mode():
        k7fp_ms = time_ms(lambda: wa.window_attention_qkv_bias_reference(
            x, w_qkv, b_qkv, scale, badd, window, pattern), 2)
    k7bp_ms = time_ms(lambda: wa.window_attention_qkv_bias_backward_reference(
        x, w16, b_qkv, scale, badd, g, window, pattern), 1)
    log(f"  K7 forward {k7f_ms:.4f} ms, plain {k7fp_ms:.4f} ms; backward {k7b_ms:.4f} ms, plain "
        f"{k7bp_ms:.4f} ms ({card}); two backward calls bit-equal")
    k7_e2048 = {
        "fwd": {"max_abs_err": k7e["out"], "ms": k7f_ms, "plain_ms": k7fp_ms, "bound_ms": bound(
            e_fwd_flops, nbytes(x, w16, b_qkv, scale, badd, out))[0]},
        "bwd": {"max_abs_err": k7e["dx"], "ms": k7b_ms, "plain_ms": k7bp_ms, "bound_ms": bound(
            e_bwd_flops, nbytes(x, w16, b_qkv, scale, badd, g, *grads))[0],
                "max_abs_err_by_output": {k: v for k, v in k7e.items() if k != "out"}}}
    del x, g, out, grads, w_qkv, w16, b_qkv, scale, badd
    torch.cuda.empty_cache()

    x2 = torch.randn((t_tok, ce), generator=gen, device=dev).bfloat16()
    g2 = torch.randn((t_tok, ce), generator=gen, device=dev).bfloat16()
    w1 = (2 * torch.rand((ce, hide), generator=gen, device=dev) - 1) / math.sqrt(ce)
    b1 = 0.02 * torch.randn((hide,), generator=gen, device=dev)
    w2 = (2 * torch.rand((hide, ce), generator=gen, device=dev) - 1) / math.sqrt(hide)
    b2 = 0.02 * torch.randn((ce,), generator=gen, device=dev)
    w1_16, w2_16 = w1.bfloat16(), w2.bfloat16()
    e_mlp_flops = 2 * t_tok * hide * (ce + ce)
    log(f"[27] e2048 MLP: x2, g [{t_tok}, {ce}] bf16, W1 [{ce}, {hide}], W2 [{hide}, {ce}]; K5 "
        f"schedule: {mk.mlp_fwd_plan(t_tok, ce, hide, ce)['launches']} launches of the GEMM core")
    with torch.inference_mode():
        out = mk.mlp_fwd(x2, w1_16, b1, w2_16, b2)
        ref = mk.mlp_fwd_reference(x2, w1, b1, w2, b2)
    torch.cuda.synchronize()
    err = compare("K5 out", out, ref, MLP2_TOL)
    del ref
    with torch.inference_mode():
        k_ms = time_ms(lambda: mk.mlp_fwd(x2, w1_16, b1, w2_16, b2), 5)
        p_ms = time_ms(lambda: mk.mlp_fwd_reference(x2, w1, b1, w2, b2), 2)
    results["mlp_fwd_e2048"] = (err, k_ms, p_ms, bound(e_mlp_flops,
                                                       nbytes(x2, w1_16, b1, w2_16, b2, out)))
    log(f"  K5 {k_ms:.4f} ms ({e_mlp_flops / k_ms / 1e9:.1f} TFLOP/s), plain {p_ms:.4f} ms ({card})")
    del out
    with torch.inference_mode():
        out = mk.mlp_bwd(x2, w1_16, b1, w2_16, g2)
        ref = mk.mlp_bwd_reference(x2, w1, b1, w2, g2)
    torch.cuda.synchronize()
    err = max(compare("K6 a", out[0], ref[0], MLP_TOL), compare("K6 dpre", out[1], ref[1], MLP_TOL))
    del ref
    with torch.inference_mode():
        k_ms = time_ms(lambda: mk.mlp_bwd(x2, w1_16, b1, w2_16, g2), 5)
        p_ms = time_ms(lambda: mk.mlp_bwd_reference(x2, w1, b1, w2, g2), 2)
    results["mlp_bwd_e2048"] = (err, k_ms, p_ms, bound(e_mlp_flops,
                                                       nbytes(x2, w1_16, b1, w2_16, g2, *out)))
    log(f"  K6 {k_ms:.4f} ms ({e_mlp_flops / k_ms / 1e9:.1f} TFLOP/s), plain {p_ms:.4f} ms ({card})")
    del x2, g2, w1, b1, w2, b2, w1_16, w2_16, out
    torch.cuda.empty_cache()

    # the e2048 train steps' kernels at the shape those steps give them (the
    # image [360, 720]: 90 x 180 tokens, 100 windows, T = 16200), timed
    th, tw = gh // 2, gw // 2
    t_tr = b * th * tw
    tr_pattern = torch.from_numpy(make_shift_mask((th, tw), window, shift)[-1].copy()).to(dev)
    tr_attn_flops = 4 * l_win * l_win * ce * (t_tr // l_win)
    train_shape = {}
    x = torch.randn((b, th, tw, ce), generator=gen, device=dev).bfloat16()
    g = torch.randn((b, th, tw, ce), generator=gen, device=dev).bfloat16()
    w16 = ((2 * torch.rand((ce, 3 * ce), generator=gen, device=dev) - 1) / math.sqrt(ce)).bfloat16()
    b_qkv = 0.02 * torch.randn((3 * ce,), generator=gen, device=dev)
    scale = torch.exp(math.log(10.0) + 0.3 * torch.randn((he,), generator=gen, device=dev))
    grads = wa.window_attention_qkv_bwd(x, w16, b_qkv, scale, g, window, tr_pattern, 1.0)
    k_ms = time_ms(lambda: wa.window_attention_qkv_bwd(x, w16, b_qkv, scale, g, window, tr_pattern,
                                                        1.0), 5)
    train_shape["window_attention_qkv_bwd_e2048"] = (k_ms, bound(
        3 * 2 * t_tr * ce * 3 * ce + 5 * tr_attn_flops / 2, nbytes(x, w16, b_qkv, scale, g, *grads)),
        None, kernel_pieces(lambda: wa.window_attention_qkv_bwd(
            x, w16, b_qkv, scale, g, window, tr_pattern, 1.0), bb.K2_LARGE_PIECES, n=3))
    del grads
    # SDPA's backward on windowed tensors of the train steps' shape, the
    # yardstick of the K8/K9 backwards there (with a seeded raw bias as mask)
    nw_tr = (th // window[0]) * (tw // window[1])
    tr_bias = 2.0 * torch.randn((he, l_win, l_win), generator=gen, device=dev)
    tr_lib, why = bb.sdpa_bwd_ms((nw_tr, he, l_win, ce // he), tr_bias, gen)
    log(f"[27] SDPA backward on [{nw_tr}, {he}, {l_win}, {ce // he}] bf16 with a float mask: "
        + (f"{tr_lib:.4f} ms" if tr_lib is not None else f"null ({why})") + f" ({card})")
    qkv = torch.randn((b, th, tw, 3 * ce), generator=gen, device=dev).bfloat16()
    qn, _ = wa.normalize_heads(qkv[..., :ce], he)
    kn, _ = wa.normalize_heads(qkv[..., ce:2 * ce], he)
    grads = wa.window_attention_grid_bwd(qn, kn, qkv[..., 2 * ce:], scale, g, window, tr_pattern)
    k_ms = time_ms(lambda: wa.window_attention_grid_bwd(qn, kn, qkv[..., 2 * ce:], scale, g, window,
                                                         tr_pattern), 5)
    train_shape["window_attention_grid_bwd_e2048"] = (k_ms, bound(
        5 * tr_attn_flops / 2, nbytes(qn, kn, qkv[..., 2 * ce:], scale, g, *grads)), tr_lib,
        kernel_pieces(lambda: wa.window_attention_grid_bwd(
            qn, kn, qkv[..., 2 * ce:], scale, g, window, tr_pattern), bb.K8_LARGE_PIECES, n=3))
    del qkv, qn, kn, grads
    q, k, v, gw_ = (torch.randn((nw_tr, he, l_win, ce // he), generator=gen, device=dev).bfloat16()
                    for _ in range(4))
    tr_grid = (th // window[0], tw // window[1])
    grads = wa.window_attention_v1_bwd(q, k, v, scale, gw_, tr_grid, tr_pattern)
    k_ms = time_ms(lambda: wa.window_attention_v1_bwd(q, k, v, scale, gw_, tr_grid, tr_pattern), 5)
    train_shape["window_attention_v1_bwd_e2048"] = (k_ms, bound(
        5 * tr_attn_flops / 2, nbytes(q, k, v, scale, gw_, *grads)), tr_lib,
        kernel_pieces(lambda: wa.window_attention_v1_bwd(q, k, v, scale, gw_, tr_grid, tr_pattern),
                      bb.K9_PIECES, n=3))
    del q, k, v, gw_, grads, x, g, w16, b_qkv, scale, tr_bias
    x2 = torch.randn((t_tr, ce), generator=gen, device=dev).bfloat16()
    g2 = torch.randn((t_tr, ce), generator=gen, device=dev).bfloat16()
    w1_16 = ((2 * torch.rand((ce, hide), generator=gen, device=dev) - 1) / math.sqrt(ce)).bfloat16()
    b1 = 0.02 * torch.randn((hide,), generator=gen, device=dev)
    w2_16 = ((2 * torch.rand((hide, ce), generator=gen, device=dev) - 1) / math.sqrt(hide)).bfloat16()
    b2 = 0.02 * torch.randn((ce,), generator=gen, device=dev)
    tr_mlp_flops = 2 * t_tr * hide * (ce + ce)
    with torch.inference_mode():
        out = mk.mlp_fwd(x2, w1_16, b1, w2_16, b2)
        k_ms = time_ms(lambda: mk.mlp_fwd(x2, w1_16, b1, w2_16, b2), 5)
    train_shape["mlp_fwd_e2048"] = (k_ms, bound(tr_mlp_flops, nbytes(x2, w1_16, b1, w2_16, b2, out)),
                                    None, None)
    with torch.inference_mode():
        out = mk.mlp_bwd(x2, w1_16, b1, w2_16, g2)
        k_ms = time_ms(lambda: mk.mlp_bwd(x2, w1_16, b1, w2_16, g2), 5)
    train_shape["mlp_bwd_e2048"] = (k_ms, bound(tr_mlp_flops, nbytes(x2, w1_16, b1, w2_16, g2, *out)),
                                    None, None)
    del x2, g2, w1_16, b1, w2_16, b2, out
    torch.cuda.empty_cache()
    log(f"[27] at the e2048 train steps' shape [1, {th}, {tw}, {ce}] (T = {t_tr}): " + ", ".join(
        f"{k} {v[0]:.4f} ms (bound {v[1][0]:.4f})" for k, v in train_shape.items()) + f" ({card})")
    for name, (_, _, _, pieces) in train_shape.items():
        if pieces is not None:
            log(f"  {name} at that shape, breakdown (torch.profiler, device ms a launch): "
                + pieces_line(pieces) + f" ({card})")

    # K2, K7 and v4's backward at head dim 128 (8 heads, L = 162): the
    # streamed variant takes it (the one-block kernel, which fits this shape
    # too, took 4.55 ms to its 4.42 and was removed at head dim 128), each
    # against its plain version
    c1 = 8 * 128
    x = torch.randn((b, gh, gw, c1), generator=gen, device=dev).bfloat16()
    g = torch.randn((b, gh, gw, c1), generator=gen, device=dev).bfloat16()
    w16 = ((2 * torch.rand((c1, 3 * c1), generator=gen, device=dev) - 1) / math.sqrt(c1)).bfloat16()
    b_qkv = 0.02 * torch.randn((3 * c1,), generator=gen, device=dev)
    scale = torch.exp(math.log(10.0) + 0.3 * torch.randn((8,), generator=gen, device=dev))
    badd = wa.fold_cpb_bias(torch.randn((8, l_win, l_win), generator=gen, device=dev), scale)
    xw, gw_ = v45.window_major(x, window), v45.window_major(g, window)
    grid_w = (gh // window[0], gw // window[1])
    hd128_cases = {
        "window_attention_qkv_bwd": (
            lambda: wa.window_attention_qkv_bwd(x, w16, b_qkv, scale, g, window, pattern, 1.0),
            lambda: wa.window_attention_qkv_backward_reference(x, w16, b_qkv, scale, g, window,
                                                               pattern), (x, g)),
        "window_attention_qkv_bias_bwd": (
            lambda: wa.window_attention_qkv_bias_bwd(x, w16, b_qkv, scale, badd, g, window, pattern,
                                                     1.0),
            lambda: wa.window_attention_qkv_bias_backward_reference(x, w16, b_qkv, scale, badd, g,
                                                                    window, pattern), (x, g, badd)),
        "window_attention_qkv4_bwd": (
            lambda: v45.window_attention_qkv4_bwd(xw, w16, b_qkv, scale, gw_, window, grid_w,
                                                  pattern, 1.0),
            lambda: v45.window_attention_qkv4_backward_reference(xw, w16, b_qkv, scale, gw_, window,
                                                                 grid_w, pattern), (xw, gw_))}
    variant128 = wa.qkv_variant("", 128, l_win, True)
    if variant128 != "streamed":
        raise RuntimeError(f"[27] head dim 128 at L = {l_win} takes {variant128!r}, not 'streamed'")
    log(f"[27] K2/K7/v4 backward at head dim 128: x {tuple(x.shape)}, 8 heads, window {window}, "
        f"shifted; variant {variant128}")
    for name, (fn, ref_fn, ins) in hd128_cases.items():
        ref = ref_fn()
        got = fn()
        torch.cuda.synchronize()
        errs = {nm: compare(f"{name} hd 128 {nm}", o, r, BWD_TOL[nm])
                for nm, o, r in zip(("dx", "dW", "db", "dscale", "dbias"), got, ref)}
        del got
        k_ms = time_ms(fn, 3)
        p_ms = time_ms(ref_fn, 1)
        results[name + "_hd128"] = (errs["dx"], k_ms, p_ms, bound(
            3 * 2 * t_tok * c1 * 3 * c1 + 5 * 4 * l_win * l_win * c1 * (t_tok // l_win) / 2,
            nbytes(w16, b_qkv, scale, *ins, *ref)))
        log(f"  {name} hd 128: streamed {k_ms:.4f} ms, plain {p_ms:.4f} ms ({card})")
        del ref
    # the cases hold their operands: drop them, or the later paths' peaks
    # count 0.5 GiB of them
    del hd128_cases, fn, ref_fn, ins, x, g, w16, b_qkv, scale, badd, xw, gw_
    torch.cuda.empty_cache()

    clock.mark("28-29")
    # ---- 28-29. the e2048 family: serving at full size, training at [360, 720] -
    e2048_kernels = ("window_attention_qkv", "window_attention_qkv_bwd", "mlp_fwd", "mlp_bwd")
    d6 = int(E2048_DEPTH["depth"])
    serve_e2048 = serve_path("[28]", E2048_DEPTH, 2, {"window_attention_qkv": d6, "mlp_fwd": d6},
                             config=CONFIG_E2048, weights_on=dev)
    # remat_policy 'full': every forward runs again in the backward
    launches_e2048, _ = train_path(
        "[29]", CONFIG_E2048, 2, {**{k: d6 for k in e2048_kernels},
                                  "window_attention_qkv": 2 * d6, "mlp_fwd": 2 * d6},
        n_timed=2, overrides={**E2048_TRAIN, **E2048_DEPTH}, weights_on=dev)

    clock.mark("30")
    # ---- 30. K10, the v6 padded-head kernels, at the flagship shape ------------
    hd = c // heads
    x = torch.randn((b, gh, gw, c), generator=gen, device=dev).bfloat16()
    w_qkv = (2 * torch.rand((c, 3 * c), generator=gen, device=dev) - 1) / math.sqrt(c)
    b_qkv = 0.02 * torch.randn((3 * c,), generator=gen, device=dev)
    scale = torch.exp(math.log(10.0) + 0.3 * torch.randn((heads,), generator=gen, device=dev))
    wp, bp = wa.pad_heads_w(w_qkv, heads), wa.pad_heads_vec(b_qkv, heads)
    wp16 = wp.bfloat16()
    g = torch.randn((b, gh, gw, heads * wa.HD_PAD), generator=gen, device=dev).bfloat16()
    log(f"[30] K10 window_attention_qkv_padded(_bwd): x {tuple(x.shape)} bf16, Wp {tuple(wp.shape)} "
        f"bf16, {heads} heads of {hd} padded to {wa.HD_PAD}, g {tuple(g.shape)} (pad lanes random), "
        f"shifted")
    with torch.inference_mode():
        out = wa.window_attention_qkv_padded(x, wp16, bp, scale, hd, window, pattern, 1.0)
        ref = wa.window_attention_qkv_padded_reference(x, wp, bp, scale, hd, window, pattern)
    torch.cuda.synchronize()
    if torch.count_nonzero(out.reshape(b, gh, gw, heads, wa.HD_PAD)[..., hd:]).item():
        raise RuntimeError("window_attention_qkv_padded: pad lanes are not zero")
    k10 = {"out": compare("out", out, ref, ATTN_TOL)}
    del ref
    grads = wa.window_attention_qkv_padded_bwd(x, wp16, bp, scale, hd, g, window, pattern, 1.0)
    ref_g = wa.window_attention_qkv_padded_backward_reference(x, wp16, bp, scale, hd, g, window,
                                                              pattern)
    torch.cuda.synchronize()
    if (torch.count_nonzero(grads[1].reshape(c, 3, heads, wa.HD_PAD)[..., hd:]).item()
            or torch.count_nonzero(grads[2].reshape(3, heads, wa.HD_PAD)[..., hd:]).item()):
        raise RuntimeError("window_attention_qkv_padded_bwd: pad columns of dWp / dbp not zero")
    for name, o, r in zip(("dx", "dW", "db", "dscale"), grads, ref_g):
        k10[name] = compare(name, o, r, BWD_TOL[name])
    again = wa.window_attention_qkv_padded_bwd(x, wp16, bp, scale, hd, g, window, pattern, 1.0)
    if not all(torch.equal(a_, o) for a_, o in zip(again, grads)):
        raise RuntimeError("window_attention_qkv_padded_bwd: two calls differ")
    del ref_g, again
    with torch.inference_mode():
        f_ms = time_ms(lambda: wa.window_attention_qkv_padded(
            x, wp16, bp, scale, hd, window, pattern, 1.0), 20)
        fp_ms = time_ms(lambda: wa.window_attention_qkv_padded_reference(
            x, wp, bp, scale, hd, window, pattern), 5)
    b_ms = time_ms(lambda: wa.window_attention_qkv_padded_bwd(
        x, wp16, bp, scale, hd, g, window, pattern, 1.0), 10)
    bp_ms = time_ms(lambda: wa.window_attention_qkv_padded_backward_reference(
        x, wp16, bp, scale, hd, g, window, pattern), 3)
    log(f"  forward kernel {f_ms:.4f} ms (K1 {attn_ms:.4f} ms in phase 3), plain {fp_ms:.4f} ms; "
        f"backward kernel {b_ms:.4f} ms (K2 {bwd_ms:.4f} ms in phase 7), plain {bp_ms:.4f} ms "
        f"({card}); pad lanes and pad columns exactly zero; two backward calls bit-equal")
    # K1's and K2's live arithmetic; out and g are read or written padded
    results["window_attention_qkv_padded"] = (k10["out"], f_ms, fp_ms, bound(
        2 * t_tok * c * 3 * c + attn_flops, nbytes(x, wp16, bp, scale, out)))
    results["window_attention_qkv_padded_bwd"] = (k10["dx"], b_ms, bp_ms, bound(
        3 * 2 * t_tok * c * 3 * c + 5 * attn_flops / 2, nbytes(x, wp16, bp, scale, g, *grads)),
        {k: v for k, v in k10.items() if k != "out"})
    del x, g, out, grads, w_qkv, b_qkv, scale, wp, bp, wp16
    torch.cuda.empty_cache()

    clock.mark("31")
    # ---- 31. the flagship on v6 (QKV_IMPL = 'v6') -------------------------------
    wa.QKV_IMPL = "v6"
    serve_v6 = serve_path("[31]", ROUTE_DEPTH, N_STEPS, {"window_attention_qkv_padded": d4,
                                                         "fc1_gelu": d4})
    launches_v6, v6_ms = train_path(
        "[31]", CONFIG, 3, {"window_attention_qkv_padded": d4_mlp3,
                            "window_attention_qkv_padded_bwd": d4, "fc1_gelu": 2 * d4,
                            "fc1_dpre": d4}, overrides=ROUTE_DEPTH)
    wa.QKV_IMPL = "v3"
    log(f"[31] v6 at depth {d4}: {v6_ms:.2f} ms/step ({card})")

    clock.mark("32")
    # ---- 32. the xla backward (QKV_BWD_IMPL = 'xla') ----------------------------
    wa.QKV_BWD_IMPL = "xla"
    launches_xla_bwd, xla_bwd_ms = train_path(
        "[32]", CONFIG, 3, {"window_attention_qkv": d4_mlp3, "window_attention_grid_bwd": d4,
                            "fc1_gelu": 2 * d4, "fc1_dpre": d4}, overrides=ROUTE_DEPTH)
    launches_xla_bwd_cpb, _ = train_path(
        "[32]", CONFIG, 2, {"window_attention_qkv_bias": d4_mlp3,
                            "window_attention_grid_bias_bwd": d4, "fc1_gelu": 2 * d4,
                            "fc1_dpre": d4},
        n_timed=2, overrides={**CPB, **ROUTE_DEPTH})
    wa.QKV_BWD_IMPL = "pallas"
    log(f"[32] xla backward {xla_bwd_ms:.2f} ms/step against the fused backward's "
        f"{train_step_ms:.2f} ms/step of phase 10 ({card})")

    clock.mark("33")
    # ---- 33. K8/K9 at head dims 128 and 256 (L = 162) ---------------------------
    for hd_w, heads_w, tag in ((128, 8, "_hd128"), (256, 8, "_e2048")):
        cw = hd_w * heads_w
        qkv = torch.randn((b, gh, gw, 3 * cw), generator=gen, device=dev).bfloat16()
        g = torch.randn((b, gh, gw, cw), generator=gen, device=dev).bfloat16()
        scale = torch.exp(math.log(10.0) + 0.3 * torch.randn((heads_w,), generator=gen,
                                                               device=dev))
        raw_bias = 2.0 * torch.randn((heads_w, l_win, l_win), generator=gen, device=dev)
        qn, _ = wa.normalize_heads(qkv[..., :cw], heads_w)
        kn, _ = wa.normalize_heads(qkv[..., cw:2 * cw], heads_w)
        log(f"[33] K8 at head dim {hd_w}: qn, kn {tuple(qn.shape)} bf16, v a channel slice of "
            f"qkv {tuple(qkv.shape)}, {heads_w} heads, window {window}, shifted")
        qkv_kernel_phase("[33]", "grid", (qn, kn, qkv[..., 2 * cw:]), g, scale, raw_bias, window,
                         suffix=tag, shifted_only=True)
        del qkv, qn, kn, g
        q, k, v, g = (torch.randn((nw, heads_w, l_win, hd_w), generator=gen, device=dev).bfloat16()
                      for _ in range(4))
        log(f"[33] K9 at head dim {hd_w}: q, k, v {tuple(q.shape)} bf16, shifted")
        qkv_kernel_phase("[33]", "v1", (q, k, v), g, scale, raw_bias,
                         (gh // window[0], gw // window[1]), suffix=tag, shifted_only=True)
        del q, k, v, g, scale, raw_bias
        torch.cuda.empty_cache()

    clock.mark("34")
    # ---- 34. the e2048 family on the grid and windowed routes, at [360, 720] ----
    launches_e2048_grid, _ = train_path(
        "[34]", CONFIG_E2048, 2, {"window_attention_grid": 2 * d6,
                                  "window_attention_grid_bwd": d6, "mlp_fwd": 2 * d6,
                                  "mlp_bwd": d6},
        n_timed=2, overrides={**E2048_TRAIN, **GRID_ROUTE, **E2048_DEPTH}, weights_on=dev)
    launches_e2048_v1, _ = train_path(
        "[34]", CONFIG_E2048, 2, {"window_attention_v1": 2 * d6, "window_attention_v1_bwd": d6,
                                  "mlp_fwd": 2 * d6, "mlp_bwd": d6},
        n_timed=2, overrides={**E2048_TRAIN, **V1_ROUTE, **E2048_DEPTH}, weights_on=dev)

    clock.mark("35")
    # ---- 35. K12: v5, v4 and the padded v4 at the flagship shape ----------------
    x = torch.randn((b, gh, gw, c), generator=gen, device=dev).bfloat16()
    g = torch.randn((b, gh, gw, c), generator=gen, device=dev).bfloat16()
    w_qkv = (2 * torch.rand((c, 3 * c), generator=gen, device=dev) - 1) / math.sqrt(c)
    b_qkv = 0.02 * torch.randn((3 * c,), generator=gen, device=dev)
    scale = torch.exp(math.log(10.0) + 0.3 * torch.randn((heads,), generator=gen, device=dev))
    w16 = w_qkv.bfloat16()
    w5 = v45.w5_reorder(w16, heads).contiguous()
    grid_w = (gh // window[0], gw // window[1])
    xw, gw_ = v45.window_major(x, window), v45.window_major(g, window)
    wp, bp = wa.pad_heads_w(w16, heads), wa.pad_heads_vec(b_qkv, heads)
    gwp = wa.pad_heads_x(gw_, heads, c // heads)
    log(f"[35] K12 at the flagship shape: x, g {tuple(x.shape)} bf16, W [{c}, {3 * c}], w5 "
        f"{tuple(w5.shape)}, window-major xw {tuple(xw.shape)}, {heads} heads of {c // heads}, "
        f"shifted")
    k12_cases = {
        "window_attention_qkv5": (v45.window_attention_qkv5, v45.window_attention_qkv5_bwd,
                                  (x, w5, b_qkv, scale), (x, w5, w16, b_qkv, scale), g,
                                  (window, pattern), 0),
        "window_attention_qkv4": (v45.window_attention_qkv4, v45.window_attention_qkv4_bwd,
                                  (xw, w16, b_qkv, scale), (xw, w16, b_qkv, scale), gw_,
                                  (window, grid_w, pattern), 0),
        "window_attention_qkv4_padded": (
            v45.window_attention_qkv4_padded, v45.window_attention_qkv4_padded_bwd,
            (xw, wp, bp, scale, c // heads), (xw, wp, bp, scale, c // heads), gwp,
            (window, grid_w, pattern), c // heads),
    }
    for name, (fwd, bwd, fargs, bargs, gk, tail, pad_hd) in k12_cases.items():
        with torch.inference_mode():
            out = fwd(*fargs, *tail, 1.0)
            ref = plain_version(fwd)(*fargs, *tail)
        torch.cuda.synchronize()
        errs = {"out": compare(f"{name} out", out, ref, ATTN_TOL)}
        grads = bwd(*bargs, gk, *tail, 1.0)
        ref_g = plain_version(bwd)(*bargs, gk, *tail)
        torch.cuda.synchronize()
        for gname, o, r in zip(("dx", "dW", "db", "dscale"), grads, ref_g):
            errs[gname] = compare(f"{name} {gname}", o, r, BWD_TOL[gname])
        again = bwd(*bargs, gk, *tail, 1.0)
        if not all(torch.equal(a_, o) for a_, o in zip(again, grads)):
            raise RuntimeError(f"{name}_bwd: two calls differ (reduction order)")
        if name != "window_attention_qkv5" and torch.count_nonzero(grads[0][:, :, l_win:]).item():
            raise RuntimeError(f"{name}_bwd: dxw's pad rows are not zero")
        if pad_hd and (
                torch.count_nonzero(out.reshape(*out.shape[:-1], heads, 128)[..., pad_hd:]).item()
                or torch.count_nonzero(grads[1].reshape(c, 3, heads, 128)[..., pad_hd:]).item()
                or torch.count_nonzero(grads[2].reshape(3, heads, 128)[..., pad_hd:]).item()):
            raise RuntimeError(f"{name}: pad lanes or pad columns are not zero")
        if name == "window_attention_qkv5":  # K1/K2's arithmetic, the same C_in order
            with torch.inference_mode():
                same_fwd = torch.equal(out, wa.window_attention_qkv(x, w16, b_qkv, scale, window,
                                                                    pattern, 1.0))
            k2 = wa.window_attention_qkv_bwd(x, w16, b_qkv, scale, g, window, pattern, 1.0)
            same_bwd = all(torch.equal(a_, o) for a_, o in zip(k2, grads))
            log(f"  v5 against K1 / K2 of the same inputs: forward bit-equal {same_fwd}, "
                f"backward bit-equal {same_bwd}")
            if not (same_fwd and same_bwd):
                raise RuntimeError("v5 and K1/K2 differ: the reordered weight changed the sums")
            del k2
        with torch.inference_mode():
            f_ms = time_ms(lambda: fwd(*fargs, *tail, 1.0), 20)
            fp_ms = time_ms(lambda: plain_version(fwd)(*fargs, *tail), 5)
        b_ms = time_ms(lambda: bwd(*bargs, gk, *tail, 1.0), 10)
        bp_ms = time_ms(lambda: plain_version(bwd)(*bargs, gk, *tail), 3)
        log(f"  {name}: forward kernel {f_ms:.4f} ms (K1 {attn_ms:.4f} ms in phase 3), plain "
            f"{fp_ms:.4f} ms; backward kernel {b_ms:.4f} ms (K2 {bwd_ms:.4f} ms in phase 7), plain "
            f"{bp_ms:.4f} ms ({card}); two backward calls bit-equal")
        # the same function as K1/K2: their bounds (operations, at the unpadded shapes)
        results[name] = (errs["out"], f_ms, fp_ms, bound(
            2 * t_tok * c * 3 * c + attn_flops, nbytes(x, w16, b_qkv, scale, x)))
        results[name + "_bwd"] = (errs["dx"], b_ms, bp_ms, bound(
            3 * 2 * t_tok * c * 3 * c + 5 * attn_flops / 2,
            nbytes(x, w16, b_qkv, scale, g, x, w16, b_qkv, scale)),
            {k: v for k, v in errs.items() if k != "out"})
        del out, ref, grads, ref_g, again
    # the last case's operands too, so that later phases' peaks are their own
    del x, g, w_qkv, b_qkv, scale, w16, w5, xw, gw_, wp, bp, gwp, fargs, bargs, gk, tail
    del k12_cases
    torch.cuda.empty_cache()

    clock.mark("36")
    # ---- 36. the flagship on v5, v4 and the padded v4 (QKV_IMPL) ------------------
    k12_paths = {}
    for impl, pad, kind in (("v5", False, "qkv5"), ("v4", False, "qkv4"),
                            ("v4", True, "qkv4_padded")):
        wa.QKV_IMPL, v45.QKV_PAD_HEADS = impl, pad
        label = f"QKV_IMPL {impl!r}" + (", QKV_PAD_HEADS" if pad else "")
        log(f"[36] the flagship with {label}")
        serve_k12 = serve_path("[36]", ROUTE_DEPTH, 2, {f"window_attention_{kind}": d4,
                                                        "fc1_gelu": d4})
        train_k12, k12_ms = train_path(
            "[36]", CONFIG, 3, {f"window_attention_{kind}": d4_mlp3,
                                f"window_attention_{kind}_bwd": d4, "fc1_gelu": 2 * d4,
                                "fc1_dpre": d4}, overrides=ROUTE_DEPTH)
        k12_paths[kind] = (serve_k12, train_k12)
        log(f"[36] {label} at depth {d4}: {k12_ms:.2f} ms/step ({card})")
    v45.QKV_PAD_HEADS = False
    wa.QKV_IMPL = "v4"  # with the CPB bias K7's route runs whatever QKV_IMPL says
    # 2 steps: at batch 1 a block's attention branch may be dropped in one of
    # them, and its parameters must still move
    launches_v4_cpb, _ = train_path(
        "[36]", CONFIG, 2, {"window_attention_qkv_bias": d4_mlp3,
                            "window_attention_qkv_bias_bwd": d4, "fc1_gelu": 2 * d4,
                            "fc1_dpre": d4}, plain_step1=False, n_timed=1,
        overrides={**CPB, **ROUTE_DEPTH})
    wa.QKV_IMPL = "v3"

    clock.mark("37")
    # ---- 37. K13: consume, and the prestage probe --------------------------------
    s = prestage_probe.prestage(
        torch.randn((b, gh, gw, 3 * c), generator=gen, device=dev).bfloat16(), heads, window,
        prestage_probe.LP)
    out = ps.consume(s)
    ref = ps.consume_reference(s)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise RuntimeError("consume: kernel and plain version differ (they must agree bit for bit)")
    c_ms = time_ms(lambda: ps.consume(s), 50)
    cp_ms = time_ms(lambda: ps.consume_reference(s), 20)
    sum_ms = time_ms(lambda: torch.sum(s, 0), 50)
    log(f"[37] consume (K13) on s {tuple(s.shape)} bf16: bit-equal to its plain version; kernel "
        f"{c_ms:.4f} ms, plain {cp_ms:.4f} ms, torch.sum(s, 0) {sum_ms:.4f} ms (one rounding; "
        f"library yardstick) ({card})")
    results["consume"] = (0.0, c_ms, cp_ms, bound(s[0].numel() * 2, nbytes(s, out)))
    library["consume"] = sum_ms
    del s, out, ref
    ps.consume.launches = 0
    pr = prestage_probe.probe(dev)
    probe_launches = {"consume": ps.consume.launches}
    log(f"[37] prestage probe: round trip {pr['roundtrip_ms']:.4f} ms/iter (bound "
        f"{pr['roundtrip_bound_ms']:.4f} ms), consume alone {pr['consume_ms']:.4f} ms (bound "
        f"{pr['consume_bound_ms']:.4f} ms), torch.sum {pr['sum_ms']:.4f} ms; checksum "
        f"{pr['checksum']:.6g}; consume launched {probe_launches['consume']} times ({card})")
    if not (math.isfinite(pr["checksum"]) and probe_launches["consume"] > 0):
        raise RuntimeError("prestage probe: non-finite checksum or consume never launched")

    clock.mark("38")
    # ---- 38. the GEMM core alone, beside torch.matmul ---------------------------
    # (shape tag, M, K, N, A MN-major, B MN-major, splits): K5's products at
    # e2048 and at the flagship, K1's projection, K2's dx (W read K-major) and
    # dW (x read MN-major, split-K into fp32 partials) at the flagship
    core_shapes = (("fc1_e2048", t_tok, 2048, 4096, False, True, 1),
                   ("fc1", t_tok, 768, 3072, False, True, 1),
                   ("fc2", t_tok, 3072, 768, False, True, 1),
                   ("projection", t_tok, c, 3 * c, False, True, 1),
                   ("dx", t_tok, 3 * c, c, False, False, 1),
                   ("dW", c, t_tok, 3 * c, True, True, gc.split_k(c, 3 * c, t_tok)))
    core = {}
    for tag, m_, k_, n_, a_mn, b_mn, splits in core_shapes:
        a = torch.randn((k_, m_) if a_mn else (m_, k_), generator=gen, device=dev).bfloat16()
        bm = torch.randn((k_, n_) if b_mn else (n_, k_), generator=gen, device=dev).bfloat16()
        a, bm = (a.t() if a_mn else a), (bm if b_mn else bm.t())
        odt = torch.bfloat16 if splits == 1 else torch.float32
        out = gc.gemm(a, bm, odt, splits)
        ref = gc.gemm_reference(a, bm, odt)
        torch.cuda.synchronize()
        err = compare(f"GEMM core {tag}", out, ref, CORE_TOL)
        del ref
        k_ms = time_ms(lambda: gc.gemm(a, bm, odt, splits), 10)
        p_ms = time_ms(lambda: gc.gemm_reference(a, bm, odt), 3)
        lib_ms = time_ms((lambda: torch.matmul(a, bm)) if splits == 1 else (
            lambda: torch.mm(a, bm, out_dtype=torch.float32)), 10)
        flops = 2 * m_ * k_ * n_
        bnd = bound(flops, nbytes(a, bm, out))
        log(f"[38] GEMM core {tag}: [{m_}, {k_}] x [{k_}, {n_}], A {'MN' if a_mn else 'K'}-major, "
            f"B {'MN' if b_mn else 'K'}-major, {splits} split(s), {odt}: {k_ms:.4f} ms "
            f"({flops / k_ms / 1e9:.1f} TFLOP/s, {100 * bnd[0] / k_ms:.1f} % of the bf16 peak), "
            f"torch.matmul {lib_ms:.4f} ms ({flops / lib_ms / 1e9:.1f} TFLOP/s), plain "
            f"{p_ms:.4f} ms ({card})")
        core[tag] = (err, k_ms, p_ms, bnd, lib_ms)
        del a, bm, out
        torch.cuda.empty_cache()
    results["gemm"] = core["fc1_e2048"][:4]
    library["gemm"] = core["fc1_e2048"][4]

    clock.mark("39")
    # ---- 39. the backwards past L = 256 ------------------------------------------
    win288, grid288 = (12, 24), (2, 2)
    l288 = win288[0] * win288[1]
    gh2, gw2, heads2, cin2 = 24, 48, 2, 64
    pat288 = torch.from_numpy(make_shift_mask((gh2, gw2), win288, (6, 12))[-1].copy()).to(dev)
    log(f"[39] the backwards at L = {l288} (window {win288}, x [1, {gh2}, {gw2}, {cin2}], "
        f"{heads2} heads), shifted, against their plain versions: the streamed kernels of the "
        f"qkv-fused family, K8 and K9")
    beyond = {}
    for hd in wa.ATTN_FWD_HEAD_DIMS:
        if (wa.qkv_variant("[39]", hd, l288, True), wa.attn_variant("[39]", hd, l288, True),
                wa.attn_variant("[39]", hd, l288, True, "v1")) != ("streamed",) * 3:
            raise RuntimeError(f"[39]: head dim {hd} at L = {l288} does not take the streamed "
                               f"qkv-fused, K8 and K9 backwards")
        c2 = heads2 * hd
        x = torch.randn((1, gh2, gw2, cin2), generator=gen, device=dev).bfloat16()
        w16 = ((2 * torch.rand((cin2, 3 * c2), generator=gen, device=dev) - 1)
               / math.sqrt(cin2)).bfloat16()
        b2q = 0.02 * torch.randn((3 * c2,), generator=gen, device=dev)
        sc2 = torch.exp(math.log(10.0) + 0.3 * torch.randn((heads2,), generator=gen, device=dev))
        g = torch.randn((1, gh2, gw2, c2), generator=gen, device=dev).bfloat16()
        raw = 2.0 * torch.randn((heads2, l288, l288), generator=gen, device=dev)
        badd = wa.fold_cpb_bias(raw, sc2)
        xw, gw_ = v45.window_major(x, win288), v45.window_major(g, win288)
        qkv2 = torch.randn((1, gh2, gw2, 3 * c2), generator=gen, device=dev).bfloat16()
        qn, _ = wa.normalize_heads(qkv2[..., :c2], heads2)
        kn, _ = wa.normalize_heads(qkv2[..., c2:2 * c2], heads2)
        qw, kw, vw, gwin = (torch.randn((4, heads2, l288, hd), generator=gen,
                                        device=dev).bfloat16() for _ in range(4))
        qkv_out, attn_out = ("dx", "dW", "db", "dscale", "dbias"), ("dq", "dk", "dv", "dscale",
                                                                     "dbias")
        # the library yardstick of K8's and K9's: SDPA's backward on the windowed
        # tensors of this shape, the raw bias as a float mask (none of the
        # qkv-fused family's: no call computes their projection with it)
        lib288, why288 = bb.sdpa_bwd_ms((4, heads2, l288, hd), raw, gen)
        log(f"  SDPA backward on [4, {heads2}, {l288}, {hd}] bf16 with a float mask: "
            + (f"{lib288:.4f} ms" if lib288 is not None else f"null ({why288})") + f" ({card})")
        cases = {
            "window_attention_qkv_bwd": (wa.window_attention_qkv_bwd,
                                         (x, w16, b2q, sc2, g, win288, pat288), qkv_out),
            "window_attention_qkv_bias_bwd": (wa.window_attention_qkv_bias_bwd,
                                              (x, w16, b2q, sc2, badd, g, win288, pat288),
                                              qkv_out),
            "window_attention_qkv5_bwd": (v45.window_attention_qkv5_bwd,
                                          (x, v45.w5_reorder(w16, heads2).contiguous(), w16, b2q,
                                           sc2, g, win288, pat288), qkv_out),
            "window_attention_qkv4_bwd": (v45.window_attention_qkv4_bwd,
                                          (xw, w16, b2q, sc2, gw_, win288, grid288, pat288),
                                          qkv_out),
            "window_attention_grid_bwd": (wa.window_attention_grid_bwd,
                                          (qn, kn, qkv2[..., 2 * c2:], sc2, g, win288, pat288),
                                          attn_out),
            "window_attention_grid_bias_bwd": (wa.window_attention_grid_bias_bwd,
                                               (qn, kn, qkv2[..., 2 * c2:], sc2, raw, g, win288,
                                                pat288), attn_out),
            "window_attention_v1_bwd": (wa.window_attention_v1_bwd,
                                        (qw, kw, vw, sc2, gwin, grid288, pat288), attn_out),
            "window_attention_v1_bias_bwd": (wa.window_attention_v1_bias_bwd,
                                             (qw, kw, vw, sc2, raw, gwin, grid288, pat288),
                                             attn_out),
        }
        if hd < 128:  # K10 and the padded v4 (head pitch 128)
            wp, bp = wa.pad_heads_w(w16, heads2), wa.pad_heads_vec(b2q, heads2)
            cases["window_attention_qkv_padded_bwd"] = (
                wa.window_attention_qkv_padded_bwd,
                (x, wp, bp, sc2, hd, wa.pad_heads_x(g, heads2, hd), win288, pat288), qkv_out)
            cases["window_attention_qkv4_padded_bwd"] = (
                v45.window_attention_qkv4_padded_bwd,
                (xw, wp, bp, sc2, hd, wa.pad_heads_x(gw_, heads2, hd), win288, grid288, pat288),
                qkv_out)
        for name, (fn, args, names) in cases.items():
            out = fn(*args)
            ref = plain_version(fn)(*args)
            torch.cuda.synchronize()
            err = max(compare(f"{name} hd {hd} {n}", o, r, BWD_TOL[n])
                      for n, o, r in zip(names, out, ref))
            again = fn(*args)
            if not all(torch.equal(a_, o) for a_, o in zip(again, out)):
                raise RuntimeError(f"[39] {name} at head dim {hd}: two calls differ")
            if "padded" in name and (
                    torch.count_nonzero(out[1].reshape(cin2, 3, heads2, 128)[..., hd:]).item()
                    or torch.count_nonzero(out[2].reshape(3, heads2, 128)[..., hd:]).item()):
                raise RuntimeError(f"[39] {name}: pad columns of dW or db are not zero")
            k_ms = time_ms(lambda: fn(*args), 3)
            p_ms = time_ms(lambda: plain_version(fn)(*args), 1)
            # the table's rule: five [L, L, hd] products per (window, head), and
            # for the qkv-fused family the recomputed projection, dx and dW;
            # each input read and each output written once
            flops = 5 * 2 * l288 * l288 * hd * (gh2 * gw2 // l288) * heads2
            if names == qkv_out:
                flops += 3 * 2 * gh2 * gw2 * cin2 * 3 * c2
            b_ms, b_by = bound(flops, nbytes(*(a for a in args if torch.is_tensor(a)), *out))
            beyond.setdefault(name, {})[hd] = {
                "variant": "streamed", "max_abs_err": err,
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib288 if names == attn_out else None}
            log(f"  {name} hd {hd}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}) ({card}); two calls bit-equal")
            del out, ref, again
        del x, w16, b2q, sc2, g, raw, badd, xw, gw_, qkv2, qn, kn, qw, kw, vw, gwin, cases, args
        torch.cuda.empty_cache()
    # K8 and K9 at L = 288 at full width: window 12 x 24 on [1, 180, 360, C],
    # 15 x 15 windows, 8 heads
    beyond_full = {}
    nw288, grid_full = (gh // win288[0]) * (gw // win288[1]), (gh // win288[0], gw // win288[1])
    pat_full = torch.from_numpy(make_shift_mask((gh, gw), win288, (6, 12))[-1].copy()).to(dev)
    for hd in (96, 256):
        cf = 8 * hd
        qkv_f = torch.randn((b, gh, gw, 3 * cf), generator=gen, device=dev).bfloat16()
        qn, _ = wa.normalize_heads(qkv_f[..., :cf], 8)
        kn, _ = wa.normalize_heads(qkv_f[..., cf:2 * cf], 8)
        g = torch.randn((b, gh, gw, cf), generator=gen, device=dev).bfloat16()
        sc8 = torch.exp(math.log(10.0) + 0.3 * torch.randn((8,), generator=gen, device=dev))
        raw = 2.0 * torch.randn((8, l288, l288), generator=gen, device=dev)
        qw, kw, vw, gwin = (torch.randn((nw288, 8, l288, hd), generator=gen,
                                        device=dev).bfloat16() for _ in range(4))
        lib_full, why_full = bb.sdpa_bwd_ms((nw288, 8, l288, hd), raw, gen)
        log(f"[39] K8/K9 at L = {l288}, full width: qn, kn, v {tuple(qn.shape)} (grid), q, k, v "
            f"{tuple(qw.shape)} (windowed), 8 heads of {hd}, shifted; SDPA backward "
            + (f"{lib_full:.4f} ms" if lib_full is not None else f"null ({why_full})")
            + f" ({card})")
        cases = {
            "window_attention_grid_bwd": (wa.window_attention_grid_bwd, (
                qn, kn, qkv_f[..., 2 * cf:], sc8, g, win288, pat_full), bb.K8_LARGE_PIECES),
            "window_attention_grid_bias_bwd": (wa.window_attention_grid_bias_bwd, (
                qn, kn, qkv_f[..., 2 * cf:], sc8, raw, g, win288, pat_full), bb.K8_LARGE_PIECES),
            "window_attention_v1_bwd": (wa.window_attention_v1_bwd, (
                qw, kw, vw, sc8, gwin, grid_full, pat_full), bb.K9_PIECES),
            "window_attention_v1_bias_bwd": (wa.window_attention_v1_bias_bwd, (
                qw, kw, vw, sc8, raw, gwin, grid_full, pat_full), bb.K9_PIECES)}
        for name, (fn, args, labels) in cases.items():
            out = fn(*args)
            ref = plain_version(fn)(*args)
            torch.cuda.synchronize()
            err = max(compare(f"{name} L {l288} hd {hd} {n}", o, r, BWD_TOL[n])
                      for n, o, r in zip(("dq", "dk", "dv", "dscale", "dbias"), out, ref))
            again = fn(*args)
            if not all(torch.equal(a_, o) for a_, o in zip(again, out)):
                raise RuntimeError(f"[39] {name} at L = {l288}, head dim {hd}: two calls differ")
            del ref, again
            k_ms = time_ms(lambda: fn(*args), 5)
            p_ms = time_ms(lambda: plain_version(fn)(*args), 1)
            pieces = kernel_pieces(lambda: fn(*args), labels, n=3)
            # five [L, L, hd] products per (window, head); each input read and
            # each output written once
            b_ms, b_by = bound(5 * 2 * l288 * l288 * hd * nw288 * 8,
                               nbytes(*(a for a in args if torch.is_tensor(a)), *out))
            beyond_full.setdefault(name, {})[hd] = {
                "variant": wa.attn_variant("", hd, l288, True), "max_abs_err": err, "ms": k_ms,
                "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_full,
                "breakdown": pieces}
            log(f"  {name} L {l288} hd {hd}: kernel {k_ms:.4f} ms ({pieces_line(pieces)}), plain "
                f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), SDPA backward "
                + (f"{lib_full:.4f}" if lib_full is not None else "null") + f" ms ({card}); two "
                "calls bit-equal")
            del out
        # args: the last case's operands ([225, 8, 288, hd] x 4: ~1 GiB at hd 256),
        # which phases 40-42 held before
        del qkv_f, qn, kn, g, sc8, raw, qw, kw, vw, gwin, cases, args
        torch.cuda.empty_cache()
    # the qkv-fused family's streamed backward at L = 288 at full width: x, g
    # [1, 180, 360, C], 8 heads of 96 (every variant) and of 256 (K2, K7)
    t288 = b * gh * gw
    for hd, variants in ((96, ("qkv", "qkv_bias", "qkv5", "qkv4", "qkv_padded", "qkv4_padded")),
                         (256, ("qkv", "qkv_bias"))):
        cf = 8 * hd
        x = torch.randn((b, gh, gw, cf), generator=gen, device=dev).bfloat16()
        g = torch.randn((b, gh, gw, cf), generator=gen, device=dev).bfloat16()
        w16 = ((2 * torch.rand((cf, 3 * cf), generator=gen, device=dev) - 1)
               / math.sqrt(cf)).bfloat16()
        b8 = 0.02 * torch.randn((3 * cf,), generator=gen, device=dev)
        sc8 = torch.exp(math.log(10.0) + 0.3 * torch.randn((8,), generator=gen, device=dev))
        badd = wa.fold_cpb_bias(2.0 * torch.randn((8, l288, l288), generator=gen, device=dev),
                                sc8)
        xw, gw_ = v45.window_major(x, win288), v45.window_major(g, win288)
        wp, bp = wa.pad_heads_w(w16, 8), wa.pad_heads_vec(b8, 8)
        operands = {
            "qkv": (wa.window_attention_qkv_bwd, (x, w16, b8, sc8, g, win288, pat_full)),
            "qkv_bias": (wa.window_attention_qkv_bias_bwd,
                         (x, w16, b8, sc8, badd, g, win288, pat_full)),
            "qkv5": (v45.window_attention_qkv5_bwd,
                     (x, v45.w5_reorder(w16, 8).contiguous(), w16, b8, sc8, g, win288, pat_full)),
            "qkv4": (v45.window_attention_qkv4_bwd,
                     (xw, w16, b8, sc8, gw_, win288, grid_full, pat_full)),
            "qkv_padded": (wa.window_attention_qkv_padded_bwd,
                           (x, wp, bp, sc8, hd, wa.pad_heads_x(g, 8, hd), win288, pat_full)),
            "qkv4_padded": (v45.window_attention_qkv4_padded_bwd,
                            (xw, wp, bp, sc8, hd, wa.pad_heads_x(gw_, 8, hd), win288, grid_full,
                             pat_full))}
        log(f"[39] the qkv-fused backward at L = {l288}, full width: x, g {tuple(x.shape)}, 8 "
            f"heads of {hd}, shifted; variant {wa.qkv_variant('[39]', hd, l288, True)}")
        for kind in variants:
            fn, args = operands[kind]
            name = f"window_attention_{kind}_bwd"
            out = fn(*args)
            ref = plain_version(fn)(*args)
            torch.cuda.synchronize()
            err = max(compare(f"{name} L {l288} hd {hd} {n}", o, r, BWD_TOL[n])
                      for n, o, r in zip(qkv_out, out, ref))
            del ref
            again = fn(*args)
            if not all(torch.equal(a_, o) for a_, o in zip(again, out)):
                raise RuntimeError(f"[39] {name} at L = {l288}, head dim {hd}: two calls differ")
            if "padded" in kind and (
                    torch.count_nonzero(out[1].reshape(cf, 3, 8, 128)[..., hd:]).item()
                    or torch.count_nonzero(out[2].reshape(3, 8, 128)[..., hd:]).item()):
                raise RuntimeError(f"[39] {name}: pad columns of dW or db are not zero")
            del again
            k_ms = time_ms(lambda: fn(*args), 5)
            p_ms = time_ms(lambda: plain_version(fn)(*args), 1)
            pieces = kernel_pieces(lambda: fn(*args), bb.K2_LARGE_PIECES, n=3)
            # five [L, L, hd] products per (window, head), the recomputed
            # projection, dx and dW; each input read and each output written once
            b_ms, b_by = bound(5 * 2 * l288 * l288 * hd * nw288 * 8 + 3 * 2 * t288 * cf * 3 * cf,
                               nbytes(*(a for a in args if torch.is_tensor(a)), *out))
            beyond_full.setdefault(name, {})[hd] = {
                "variant": wa.qkv_variant("", hd, l288, True), "max_abs_err": err, "ms": k_ms,
                "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "breakdown": pieces}
            log(f"  {name} L {l288} hd {hd}: kernel {k_ms:.4f} ms ({pieces_line(pieces)}), plain "
                f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) ({card}); two calls bit-equal")
            del out
        del x, g, w16, b8, sc8, badd, xw, gw_, wp, bp, operands, fn, args
        torch.cuda.empty_cache()

    clock.mark("40-41")
    # ---- 40. the Trainer end to end ---------------------------------------------
    # ---- 41. inference: registry, scored and chunked rollouts, forecast,
    # ensembles, the served artifact, the CLI (from phase 40's run) ------------
    trainer_paths, trainer_root, trainer_exp = trainer_and_inference_phases(
        dev, card, counted, gc.gemm)

    clock.mark("42")
    # ---- 42. the configs' training options on the card: the e2048 family at
    # full size, each remat policy on the flagship, LAMB, the H1 loss ---------
    t42 = time.time()
    import gc as gc_mod

    gc_mod.collect()
    torch.cuda.empty_cache()
    held_gib, largest = live_cuda_tensors()
    log(f"[42] held on the card before the phase: {torch.cuda.memory_allocated() / 2**30:.3f} "
        f"GiB allocated, {held_gib:.3f} GiB in the tensors the collector reaches; the "
        f"largest: {largest}")

    from swin_v2_weather_torch.ops.losses import GeometricH1Loss

    e2048_params = train_params(CONFIG_E2048, E2048_DEPTH)
    log(f"[42a] {CONFIG_E2048} as written but for its depth: image "
        f"{tuple(e2048_params.img_size)}, embed {e2048_params.embed_dim}, depth "
        f"{e2048_params.depth} (of 24), shard_params "
        f"{e2048_params['shard_params']} (a no-op on one process), activation_ckpt "
        f"{e2048_params.activation_ckpt}, remat_policy {e2048_params.remat_policy!r}, drop-path "
        f"{e2048_params.drop_path_rate}")
    # 'full': every forward runs again in the backward
    d42 = int(e2048_params.depth)
    launches_e2048_full, e2048_full_ms = train_path(
        "[42a]", CONFIG_E2048, 3, {"window_attention_qkv": 2 * d42,
                                   "window_attention_qkv_bwd": d42, "mlp_fwd": 2 * d42,
                                   "mlp_bwd": d42},
        n_timed=2, weights_on=dev, overrides=E2048_DEPTH)
    e2048_full_gib = train_peaks["[42a]"]

    def e2048_step_memory(activation_ckpt: bool) -> dict:
        """Two train steps of the e2048 config as written but for
        ``activation_ckpt`` (the first allocates Adam's moments): the second
        step's ms (synchronized between its stages) and its peak memory at
        the end of the forward, of the backward and of the optimizer step,
        or the stage where a step ran out of memory (a measurement, not a
        check)."""
        params = train_params(CONFIG_E2048, {**E2048_DEPTH, "activation_ckpt": activation_ckpt})
        stage, out = "the model's build", {}
        try:
            model = seeded_model(params, dev, SEED + 1, dev)
            loss_handler, preprocessor = LossHandler(params), Preprocessor(params)
            optimizer = build_optimizer(params, model.parameters())
            dp_gen = torch.Generator(device=dev).manual_seed(SEED)
            inp, tar, tzen = preprocessor(synthetic_batch(params, dev))
            for i in (1, 2):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                stage = f"step {i}'s forward"
                optimizer.zero_grad(set_to_none=True)
                loss = loss_handler(model(inp, coszen=tzen, train=True, generator=dp_gen).float(),
                                    tar, inp)
                torch.cuda.synchronize()
                out["forward_gib"] = torch.cuda.max_memory_allocated() / 2**30
                stage = f"step {i}'s backward"
                loss.backward()
                del loss
                torch.cuda.synchronize()
                out["backward_gib"] = torch.cuda.max_memory_allocated() / 2**30
                stage = f"step {i}'s optimizer step"
                optimizer.step()
                torch.cuda.synchronize()
                out["ms"] = (time.perf_counter() - t0) * 1e3
                out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            return {"ran": True, **out}
        except torch.cuda.OutOfMemoryError as exc:
            return {"ran": False, "stage": stage, "error": str(exc).splitlines()[0],
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30}

    e2048_memory = {}
    for ckpt_on in (True, False):
        got = e2048_step_memory(ckpt_on)
        e2048_memory["rematted" if ckpt_on else "unrematted"] = got
        gc_mod.collect()
        torch.cuda.empty_cache()
        label = "remat 'full'" if ckpt_on else "activation_ckpt false"
        if got["ran"]:
            log(f"  {label}: step 2 {got['ms']:.1f} ms (synchronized between stages), peak "
                f"{got['forward_gib']:.3f} GiB at the end of the forward, "
                f"{got['backward_gib']:.3f} of the backward, {got['peak_gib']:.3f} of the "
                f"optimizer step ({card})")
        else:
            log(f"  {label}: out of memory in {got['stage']} at {got['peak_gib']:.3f} GiB "
                f"allocated ({card}): {got['error']}")
    unrematted = e2048_memory["unrematted"]
    log(f"[42a] e2048 at 720 x 1440, depth {d42}, under 'full': {e2048_full_ms:.2f} ms/step, peak "
        f"{e2048_full_gib:.3f} GiB; without remat: "
        + (f"peak {unrematted['peak_gib']:.3f} GiB" if unrematted["ran"] else
           f"out of memory in {unrematted['stage']}") + f" ({card})")

    # (b) each policy on the flagship from the same weights and batch: the
    # gradients of 2 steps bit-equal to the unrematted model's (the forward
    # kernels recompute the same bits; the backward graph is the same)
    def remat_policies(tag: str, dropout=None) -> dict:
        """Phase 42 b's runs on the flagship at REMAT_DEPTH (with the dropout
        rates ``dropout``): 2 steps each, the gradients bit-equal to the
        unrematted model's of the same MLP route, the launches a step as
        each policy recomputes; {label: ms, peak and launches}."""
        batch = synthetic_batch(train_params(CONFIG), dev)
        d = int(REMAT_DEPTH["depth"])
        d_mlp3 = d + d // 2
        runs = [("none", None, None), ("none, again", None, None), ("full", "full", None),
                ("attn", "attn", None), ("mlp", "mlp", None), ("mlp3", "mlp3", None),
                ("none, plain MLP", None, "plain"), ("mlp_fc1, plain MLP", "mlp_fc1", "plain")]
        fused_twice = {"window_attention_qkv": 2 * d, "window_attention_qkv_bwd": d,
                       "fc1_gelu": 2 * d, "fc1_dpre": d}
        fused_mlp3 = {**fused_twice, "window_attention_qkv": d_mlp3}
        policy_want = {
            "none": {k: d for k in fused_twice}, "full": fused_twice, "attn": fused_twice,
            "mlp": fused_mlp3, "mlp3": fused_mlp3,
            "none, plain MLP": {"window_attention_qkv": d, "window_attention_qkv_bwd": d},
            "mlp_fc1, plain MLP": {"window_attention_qkv": d_mlp3,
                                   "window_attention_qkv_bwd": d}}
        policy_want["none, again"] = policy_want["none"]
        ref_grads, policy_out = {}, {}
        for label, policy, mlp_impl in runs:
            over = {**REMAT_DEPTH, "activation_ckpt": policy is not None,
                    "remat_policy": policy or "mlp3"}
            if mlp_impl:
                over["mlp_impl"] = mlp_impl
            params = train_params(CONFIG, over)
            model = seeded_model(params, dev, SEED + 1, dev, dropout)
            if model.model.remat_policy != policy:
                raise RuntimeError(f"{tag} {label}: the model's remat policy is "
                                   f"{model.model.remat_policy!r}")
            loss_handler, preprocessor = LossHandler(params), Preprocessor(params)
            step = build_train_step(model, loss_handler, preprocessor,
                                    build_optimizer(params, model.parameters()),
                                    generator=torch.Generator(device=dev).manual_seed(SEED))
            for fn in counted:
                fn.launches = 0
            gc.gemm.launches = 0
            grads = []  # on the host, so that the peaks below hold no copies
            for _ in range(2):
                step(batch)
                grads.append({n: p.grad.detach().cpu() for n, p in model.named_parameters()})
            torch.cuda.synchronize()
            launches = {fn.__name__: fn.launches for fn in counted}
            want = {name: 2 * policy_want[label].get(name, 0) for name in launches}
            if launches != want:
                raise RuntimeError(f"{tag} {label}: launches in 2 steps must be {want}, "
                                   f"got {launches}")
            check_core(f"{tag} {label}", gc.gemm.launches, launches, int(params.num_heads))
            group = mlp_impl or "fused"
            if group not in ref_grads:
                ref_grads[group] = grads
                same = "the reference"
            else:
                differ = [(i + 1, n) for i, (g, r) in enumerate(zip(grads, ref_grads[group]))
                          for n in r if not torch.equal(g[n], r[n])]
                if differ:
                    worst = max(float((grads[i - 1][n] - ref_grads[group][i - 1][n]).abs().max()
                                      / ref_grads[group][i - 1][n].abs().max())
                                for i, n in differ)
                    raise RuntimeError(f"{tag} {label}: {len(differ)} gradients of the 2 steps "
                                       f"differ from the unrematted model's (worst relative "
                                       f"{worst:.3g}): {differ[:6]}")
                same = "bit-equal to the unrematted model's"
            del grads
            k_ms, k_mem = train_ms(step, batch, 2)
            per_step = {k: v // 2 for k, v in launches.items() if v}
            policy_out[label] = {"ms": k_ms, "peak_gib": k_mem, "launches_per_step": per_step,
                                 "launches": {**launches, "gemm": gc.gemm.launches}}
            log(f"{tag} {CONFIG} at depth {d}, dropout (proj, attn) {dropout or (0.0, 0.0)}, "
                f"remat {label}: {k_ms:.2f} ms/step, peak {k_mem:.3f} GiB; launches a step "
                f"{per_step}; gradients of 2 steps {same} ({card})")
            del model, step
            torch.cuda.empty_cache()
        return policy_out

    policy_out = remat_policies("[42b]")
    batch = synthetic_batch(train_params(CONFIG), dev)

    # (c) LAMB on the flagship (the config's remat, 'mlp3')
    launches_lamb, lamb_ms = train_path(
        "[42c]", CONFIG, 3, {"window_attention_qkv": d4_mlp3, "window_attention_qkv_bwd": d4,
                             "fc1_gelu": 2 * d4, "fc1_dpre": d4},
        plain_step1=False, n_timed=2, overrides={"optimizer_type": "lamb", **ROUTE_DEPTH})
    log(f"[42c] LAMB at depth {d4}: {lamb_ms:.2f} ms/step ({card})")

    # (d) the H1 loss on one flagship batch: on the card (fp32 SHT) against
    # the same tensors' loss on the CPU in fp64
    params = train_params(CONFIG, {"loss": "h1"})
    model = seeded_model(params, dev, SEED + 1, dev)
    preprocessor = Preprocessor(params)
    inp, tar, tzen = preprocessor(batch)
    with torch.no_grad():
        prd = model(inp, coszen=tzen).float()
    del model
    t0 = time.time()
    handler = LossHandler(params)
    if not isinstance(handler.loss_obj, GeometricH1Loss):
        raise RuntimeError("[42d] the 'h1' loss word did not build the H1 loss")
    h1 = float(handler(prd, tar, inp, training=False))
    build_s = time.time() - t0
    with torch.no_grad():
        h1_ms = time_ms(lambda: handler(prd, tar, inp, training=False), 5)
    prd_g = prd.clone().requires_grad_()
    handler(prd_g, tar, inp).backward()
    if not bool(torch.isfinite(prd_g.grad).all()):
        raise RuntimeError("[42d] the H1 loss's gradient is not finite")
    del prd_g
    t0 = time.time()
    ref64 = float(GeometricH1Loss(tuple(params.img_size), dtype=torch.float64)(
        prd.double().cpu(), tar.double().cpu()))
    ref_s = time.time() - t0
    h1_rel = abs(h1 - ref64) / abs(ref64)
    h1_rtol = 1e-4  # fp32 FFT, products of 720 terms and sums of 37M against fp64: ~1e-6
    log(f"[42d] H1 loss (relative, 'h1') of the flagship's prediction for one batch "
        f"{tuple(prd.shape)}: card fp32 {h1:.9g}, CPU fp64 {ref64:.9g}, relative {h1_rel:.3g} "
        f"(tol {h1_rtol:g}); {h1_ms:.3f} ms a loss on the card ({card}), the fp32 transform's "
        f"host build {build_s:.1f} s, the fp64 CPU loss {ref_s:.1f} s; its Legendre matrix "
        f"{handler.loss_obj.sht.weighted_pct.numel() * 4 / 2**30:.3f} GiB on the card")
    if not (math.isfinite(h1) and h1_rel <= h1_rtol):
        raise RuntimeError("[42d] the H1 loss on the card disagrees with the fp64 CPU loss")
    del handler, prd, tar, inp, tzen, batch
    gc_mod.collect()
    torch.cuda.empty_cache()
    log(f"[42] {time.time() - t42:.1f} s")

    clock.mark("43")
    # ---- 43. the parallel layer: DDP / ZeRO-1 / FSDP2 over NCCL at world size 1,
    # two spatially sharded ranks on the card, K1/K2 gated off at the band shape
    gc_mod.collect()
    torch.cuda.empty_cache()
    parallel_paths = parallel_phase(
        dev, card, train_step_ms, {"window_attention_qkv": qkv_mlp3,
                                   "window_attention_qkv_bwd": depth, "fc1_gelu": twice,
                                   "fc1_dpre": depth}, heads, results)
    print(json.dumps({"training_options": {
        "card": card, "e2048_full_image": {"ms": e2048_full_ms, "peak_gib": e2048_full_gib,
                                           **e2048_memory},
        "policies": policy_out, "lamb_ms": lamb_ms, "adam_ms": train_step_ms,
        "h1": {"card_fp32": h1, "cpu_fp64": ref64, "rel": h1_rel, "ms": h1_ms}}}))

    clock.mark("44")
    # ---- 44. the JAX checkpoint interchange: phase 40's epoch-2 checkpoint out
    # to JAX's scanned layout and back, resumed; a registry out and back, served
    gc_mod.collect()
    torch.cuda.empty_cache()
    interchange_paths = interchange_phase(trainer_root, trainer_exp, dev, card, counted,
                                          gc.gemm)

    clock.mark("45")
    # ---- 45. the served artifact of every route: export, load, bit-equal to
    # the engine's step; platforms; each new custom op's host cost -----------
    gc_mod.collect()
    torch.cuda.empty_cache()
    served_paths, served_host = served_routes_phase(trainer_root, dev, card, counted, gc.gemm)
    host_calls.update(served_host)

    # ---- 46. train-mode dropout, proj only: the flagship's kernels ------------
    clock.mark("46")
    gc_mod.collect()
    torch.cuda.empty_cache()
    proj_only, with_attn = (DROPOUT_RATE, 0.0), (DROPOUT_RATE, DROPOUT_RATE)
    flagship_step = {"window_attention_qkv": qkv_mlp3, "window_attention_qkv_bwd": depth,
                     "fc1_gelu": twice, "fc1_dpre": depth}
    flagship_eval = {"window_attention_qkv": depth, "fc1_gelu": depth}
    launches_dropout, dropout_ms = train_path(
        "[46]", CONFIG, 3, flagship_step, eval_step=True, eval_want=flagship_eval,
        dropout=proj_only, rerun=True)
    remat_dropout = remat_policies("[46]", proj_only)

    # ---- 47. attention dropout too: JAX's gate leaves K1/K2 in train mode -----
    clock.mark("47")
    launches_dropout_attn, dropout_attn_ms = train_path(
        "[47]", CONFIG, 3, {"fc1_gelu": twice, "fc1_dpre": depth}, eval_step=True,
        eval_want=flagship_eval, dropout=with_attn, rerun=True)

    # ---- 48. the 2-step under proj dropout: its fc1 dropout moves the MLP ----
    # from K5/K6 to K3/K4, in eval mode too (JAX's Mlp reads the rate)
    clock.mark("48")
    launches_2step_dropout, dropout_2step_ms = train_path(
        "[48]", CONFIG_2STEP, 2, {k: 2 * v for k, v in flagship_step.items()},
        eval_step=True, eval_want={k: 2 * v for k, v in flagship_eval.items()},
        dropout=proj_only, n_timed=2)

    # ---- 49. the 8-step fine-tune: the looped rollout, each step's model call
    # under its checkpoint with the block remat nested inside -----------------
    clock.mark("49")
    launches_8step, ms_8step = train_path(
        "[49]", CONFIG_8STEP, 2,
        {"window_attention_qkv": 8 * (depth + qkv_mlp3), "window_attention_qkv_bwd": 8 * depth,
         "mlp_fwd": 16 * depth, "mlp_bwd": 8 * depth},
        n_timed=1)

    # ---- 50. the 'xla' route's train step: no attention kernel ----------------
    clock.mark("50")
    launches_xla_train, xla_train_ms = train_path(
        "[50]", CONFIG, 3, {"fc1_gelu": twice, "fc1_dpre": depth}, overrides=XLA_ROUTE,
        eval_step=True, eval_want={"fc1_gelu": depth})
    print(json.dumps({"dropout_and_owed_paths": {
        "card": card,
        "dropout_proj": {"rates": proj_only, "ms": dropout_ms, "peak_gib": train_peaks["[46]"]},
        "dropout_proj_remat": remat_dropout,
        "dropout_attn": {"rates": with_attn, "ms": dropout_attn_ms,
                         "peak_gib": train_peaks["[47]"]},
        "dropout_2step": {"rates": proj_only, "ms": dropout_2step_ms,
                          "peak_gib": train_peaks["[48]"]},
        "train_8step": {"ms": ms_8step, "peak_gib": train_peaks["[49]"]},
        "train_xla": {"ms": xla_train_ms, "peak_gib": train_peaks["[50]"]},
        "bare_step_ms": train_step_ms}}))
    clock.mark(None)
    print(json.dumps({"phase_seconds": clock.seconds}))

    by_path = {"serve": (serve_launches, N_STEPS), "train": (train_launches, N_STEPS),
               "train_2step": (launches_2step, 3), "train_4step": (launches_4step, 2),
               "train_depth24": (launches_depth24, 3), "serve_cpb": ({**cpb_serve_launches, "gemm": cpb_serve_core}, N_STEPS),
               "train_cpb": (launches_cpb, N_STEPS), "train_lnadd": (launches_lnadd, 3),
               "serve_grid": (serve_grid, N_STEPS), "train_grid": (launches_grid, 3),
               "train_grid_cpb": (launches_grid_cpb, 2), "serve_v1": (serve_v1, N_STEPS),
               "train_v1": (launches_v1, 3), "train_v1_cpb": (launches_v1_cpb, 2),
               "serve_xla": (serve_xla, 1), "serve_e2048": (serve_e2048, 2),
               "train_e2048": (launches_e2048, 2), "serve_v6": (serve_v6, N_STEPS),
               "train_v6": (launches_v6, 3), "train_xla_bwd": (launches_xla_bwd, 3),
               "train_xla_bwd_cpb": (launches_xla_bwd_cpb, 2),
               "train_e2048_grid": (launches_e2048_grid, 2),
               "train_e2048_v1": (launches_e2048_v1, 2),
               "serve_v5": (k12_paths["qkv5"][0], 2), "train_v5": (k12_paths["qkv5"][1], 3),
               "serve_v4": (k12_paths["qkv4"][0], 2), "train_v4": (k12_paths["qkv4"][1], 3),
               "serve_v4_padded": (k12_paths["qkv4_padded"][0], 2),
               "train_v4_padded": (k12_paths["qkv4_padded"][1], 3),
               "train_v4_cpb": (launches_v4_cpb, 2), "prestage_probe": (probe_launches, 1),
               "train_e2048_full": (launches_e2048_full, 3), "train_lamb": (launches_lamb, 3),
               **{f"remat_{label.replace(', ', '_').replace(' ', '_')}": (v["launches"], 2)
                  for label, v in policy_out.items()},
               "train_dropout": (launches_dropout, 3),
               "train_dropout_attn": (launches_dropout_attn, 3),
               "train_2step_dropout": (launches_2step_dropout, 2),
               "train_8step": (launches_8step, 2), "train_xla": (launches_xla_train, 3),
               **{f"remat_dropout_{label.replace(', ', '_').replace(' ', '_')}":
                  (v["launches"], 2) for label, v in remat_dropout.items()},
               **trainer_paths, **parallel_paths, **interchange_paths, **served_paths}
    sources = {
        "window_attention_qkv": ("window_attention_qkv.cu", "window_attention.py:1142",
                                 "train_2step"),
        "window_attention_qkv_bwd": ("window_attention_qkv_bwd.cu", "window_attention.py:1397",
                                     "train_2step"),
        "fc1_gelu": ("fc1_gelu.cu", "mlp_kernels.py:110", "train"),
        "fc1_dpre": ("fc1_gelu.cu", "mlp_kernels.py:140", "train"),
        "mlp_fwd": ("mlp.cu", "mlp_kernels.py:295", "train_2step"),
        "mlp_bwd": ("mlp.cu", "mlp_kernels.py:317", "train_2step"),
        "window_attention_qkv_bias": ("window_attention_qkv.cu", "window_attention.py:1836",
                                      "train_cpb"),
        "window_attention_qkv_bias_bwd": ("window_attention_qkv_bwd.cu",
                                          "window_attention.py:1836", "train_cpb"),
        "ln_dp_add_fwd": ("ln_dp_add.cu", "ln_kernels.py:85", "train_lnadd"),
        "ln_dp_add_bwd": ("ln_dp_add.cu", "ln_kernels.py:98", "train_lnadd"),
        "window_attention_grid": ("window_attention_grid.cu", "window_attention.py:556",
                                  "train_grid"),
        "window_attention_grid_bwd": ("window_attention_grid_large.cu",
                                      "window_attention.py:702", "train_grid"),
        "window_attention_grid_bias": ("window_attention_grid.cu", "window_attention.py:556",
                                       "train_grid_cpb"),
        "window_attention_grid_bias_bwd": ("window_attention_grid_large.cu",
                                           "window_attention.py:702", "train_grid_cpb"),
        "window_attention_v1": ("window_attention_v1.cu", "window_attention.py:172", "train_v1"),
        "window_attention_v1_bwd": ("window_attention_v1_large.cu", "window_attention.py:292",
                                    "train_v1"),
        "window_attention_v1_bias": ("window_attention_v1.cu", "window_attention.py:172",
                                     "train_v1_cpb"),
        "window_attention_v1_bias_bwd": ("window_attention_v1_large.cu",
                                         "window_attention.py:292", "train_v1_cpb"),
        "window_attention_qkv_padded": ("window_attention_qkv.cu", "window_attention.py:1999",
                                        "train_v6"),
        "window_attention_qkv_padded_bwd": ("window_attention_qkv_bwd.cu",
                                            "window_attention.py:2174", "train_v6"),
        # the same wrappers at the e2048 shapes (K1's pass at head dim 256, the
        # streamed backward), counted on the e2048 train step at full size
        "window_attention_qkv_e2048": ("window_attention_qkv.cu",
                                       "window_attention.py:1142", "train_e2048_full"),
        "window_attention_qkv_bwd_e2048": ("window_attention_qkv_large.cu",
                                           "window_attention.py:1397", "train_e2048_full"),
        "mlp_fwd_e2048": ("mlp.cu", "mlp_kernels.py:295", "train_e2048_full"),
        "mlp_bwd_e2048": ("mlp.cu", "mlp_kernels.py:317", "train_e2048_full"),
        # K8/K9 at head dim 256 (the streamed forward, the streamed backward),
        # counted on the e2048 grid and windowed train steps
        "window_attention_grid_e2048": ("window_attention_grid.cu",
                                        "window_attention.py:556", "train_e2048_grid"),
        "window_attention_grid_bwd_e2048": ("window_attention_grid_large.cu",
                                            "window_attention.py:702", "train_e2048_grid"),
        "window_attention_v1_e2048": ("window_attention_v1.cu", "window_attention.py:172",
                                      "train_e2048_v1"),
        "window_attention_v1_bwd_e2048": ("window_attention_v1_large.cu",
                                          "window_attention.py:292", "train_e2048_v1"),
        # K12 and K13
        "window_attention_qkv5": ("window_attention_qkv.cu", "attic/window_attention_v45.py:71",
                                  "train_v5"),
        "window_attention_qkv5_bwd": ("window_attention_qkv_bwd.cu",
                                      "attic/window_attention_v45.py:215", "train_v5"),
        "window_attention_qkv4": ("window_attention_qkv.cu", "attic/window_attention_v45.py:533",
                                  "train_v4"),
        "window_attention_qkv4_bwd": ("window_attention_qkv_bwd.cu",
                                      "attic/window_attention_v45.py:712", "train_v4"),
        "window_attention_qkv4_padded": ("window_attention_qkv.cu",
                                         "attic/window_attention_v45.py:533", "train_v4_padded"),
        "window_attention_qkv4_padded_bwd": ("window_attention_qkv_bwd.cu",
                                             "attic/window_attention_v45.py:712",
                                             "train_v4_padded"),
        "consume": ("prestage_consume.cu", "scripts/prestage_probe.py:58", "prestage_probe"),
        # the GEMM core (timed alone at K5's e2048 fc1 shape, phase 38): it
        # runs K5's and K6's products, the K1 and K2 families' projection and
        # K2's dx and dW
        "gemm": ("wgmma_gemm.cuh", "mlp_kernels.py:295", "train_2step"),
    }
    kernels = []
    for name, (src, replaces, main_path) in sources.items():
        err, k_ms, p_ms, (b_ms, b_by) = results[name][:4]
        # the _e2048 entries: the same wrappers, counted on the e2048 paths only
        counter = name.removesuffix("_e2048")
        paths = {p: v for p, v in by_path.items() if "e2048" in p or counter == name}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"swin_v2_weather_torch/ops/csrc/{src}",
            "replaces": (replaces if replaces.startswith("scripts/")
                         else f"swin_v2_weather_tpu/ops/{replaces}"),
            "launches": by_path[main_path][0][counter],
            "max_abs_err": err,
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": library.get(name),
            "main_path": main_path,
            "launches_by_path": {path: lc.get(counter, 0) for path, (lc, _) in paths.items()},
            "launches_per_step": {path: lc.get(counter, 0) / n for path, (lc, n) in paths.items()},
        })
    kernels[1]["max_abs_err_by_output"] = bwd_errs
    kernels[7]["max_abs_err_by_output"] = {k: v for k, v in k7_errs.items() if k != "out"}
    kernels[9]["max_abs_err_by_output"] = {k: v for k, v in ln_errs.items() if k != "out"}
    for entry in kernels[8:10]:
        entry["layer_norm_ms"] = ln_ms  # F.layer_norm alone at [64800, 768], context only
    for entry in kernels[10:]:
        if len(results[entry["name"]]) > 4:
            entry["max_abs_err_by_output"] = results[entry["name"]][4]
    for entry in kernels:
        if entry["name"] in yardstick:  # K3/K4: torch.matmul of the same operands (phases 4, 8)
            entry["matmul_ms"] = yardstick[entry["name"]]
        if entry["name"] in host_calls:  # host us a call, direct and custom op (3, 4, 45)
            entry["host_us"] = host_calls[entry["name"]]
        if entry["name"] in beyond:  # past L = 256: L = 288, by head dim (phase 39)
            entry["l288"] = beyond[entry["name"]]
        if entry["name"] in beyond_full:  # K8/K9 at L = 288 at full width (phase 39)
            entry["l288_full"] = beyond_full[entry["name"]]
    kernels[-1]["shapes"] = {
        tag: {"max_abs_err": e, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd[0],
              "bound_by": bnd[1], "library_ms": lib_ms}
        for tag, (e, k_ms, p_ms, bnd, lib_ms) in core.items()}
    if kernels[-1]["launches"] == 0:
        raise RuntimeError("the GEMM core was never launched on its main path")
    for entry in kernels:  # the e2048 train steps' kernels at those steps' shape (phase 27)
        if entry["name"] in train_shape:
            k_ms, (b_ms, b_by), lib_ms, pieces = train_shape[entry["name"]]
            entry["train_shape"] = {"ms": k_ms, "bound_ms": b_ms, "bound_by": b_by,
                                    "library_ms": lib_ms}
            if pieces is not None:
                entry["train_shape"]["breakdown"] = pieces
        if entry["name"] in breakdowns:  # the streamed backwards' pieces (phases 27, 33)
            entry["breakdown"] = breakdowns[entry["name"]]
    for entry in kernels[:2]:  # K1/K2 gated off at the band shape [1, 90, 360, 768] (phase 43)
        err, k_ms, p_ms, (b_ms, b_by) = results[entry["name"] + "_band"]
        entry["band"] = {"boundary_flag": 0.0, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    kernels[6]["e2048"] = k7_e2048["fwd"]  # K7's e2048 case (phase 27)
    kernels[7]["e2048"] = k7_e2048["bwd"]
    kernels[8]["streamed"] = ln_streamed["fwd"]  # K11 above 2048 channels (phase 18)
    kernels[9]["streamed"] = ln_streamed["bwd"]
    # K8/K9 at head dim 128, and their BIAS instances at 256 (phase 33): the
    # wrappers of the flagship entries at those shapes, on no train path
    for entry in kernels:
        for tag in ("_hd128", "_e2048"):
            sub = results.get(entry["name"] + tag)
            if sub is not None and entry["name"] + tag not in sources:
                err, k_ms, p_ms, (b_ms, b_by) = sub[:4]
                entry[tag[1:]] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                                  "bound_ms": b_ms, "bound_by": b_by,
                                  "library_ms": library.get(entry["name"] + tag),
                                  "launch": launch.get(entry["name"] + tag)}
                if entry["name"] + tag in breakdowns:
                    entry[tag[1:]]["breakdown"] = breakdowns[entry["name"] + tag]
        if entry["name"] in launch:  # the K8/K9 forwards' launch report (phases 20, 23, 33)
            entry["launch"] = launch[entry["name"]]
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
