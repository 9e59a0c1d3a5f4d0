"""Training runtime: experiment setup, epoch loop, validation, checkpoints
(PyTorch port).

Counterpart of ``swin_v2_weather_tpu/training/trainer.py`` with its structure,
one process per device (the GPU unless ``device="cpu"`` is asked for;
under torchrun, rank r drives ``cuda:LOCAL_RANK``):

  * the hot loop pulls a batch the prefetch already put on the device
    (``data/pipeline.cuda_prefetch``: a page-locked host ring, copies on a
    side stream), calls the train step and keeps its metrics as device
    tensors; they are read once per epoch, not once per step;
  * validation keeps the loss and the per-channel latitude-weighted RMSE and
    ACC on the device and denormalizes them once per epoch on the host;
  * a checkpoint every epoch and a best checkpoint on validation improvement,
    with the reference's finetune/resume gating, and graceful preemption at
    a step boundary with ``step_in_epoch``;
  * the experiment-dir layout, ``hyperparams.yaml`` and the log files of the
    JAX trainer.

Randomness: the initial weights come from a ``torch.Generator`` seeded with
``params.seed`` (torch's layer defaults, which the JAX model reproduces); the
drop-path masks (and the proj/attn dropout seeds of a model constructed
with those rates) of each step from a generator on the device seeded from
(seed, epoch, global step) by :func:`step_seed`, so a resumed run draws the
masks of an uninterrupted one; every rank draws them for the whole global
batch and keeps its shard's (``SwinTransformerV2.data_shard``).

Several processes (JAX ``trainer.py`` with a multi-process mesh):
``parallel.init_distributed`` starts the process group from the launcher's
environment; the (data, model) mesh comes from ``mesh_shape``; the state is
laid out by ``training/step.shard_state`` (DDP, ``shard_opt_state``:
ZeRO-1, ``shard_params``: FSDP2, ``spatial_shards``: latitude bands over the
``model`` axis); the loader shards the dataset by the rank's data index
(``data_num_shards`` = the data axis's size, each shard a
``local_batch_size`` = ``batch_size`` / data shards); every rank starts from
the same weights; validation reports the global batch's metrics; the chief
alone makes the experiment directory and writes ``hyperparams.yaml``,
``out.log``, the metrics, the profile and the checkpoints (which every
rank gathers); a sweep trial's config is the chief's, broadcast; and the
ranks agree on a preemption's stop step (``training/preempt.agreed``). One
process without a process group runs as before, ``shard_params`` and
``shard_opt_state`` doing nothing (one device holds the whole state, as
JAX's ``state_shardings`` shards nothing over a one-device mesh).
"""

from __future__ import annotations

import itertools
import logging
import math
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import yaml

from swin_v2_weather_torch.data.pipeline import cuda_prefetch, get_data_loader
from swin_v2_weather_torch.data.preprocess import Preprocessor, derived_channel_counts
from swin_v2_weather_torch.models.wrappers import get_model
from swin_v2_weather_torch.ops.losses import LossHandler
from swin_v2_weather_torch.parallel.mesh import (
    broadcast_config,
    init_distributed,
    make_mesh,
    mesh_coords,
    rank_device,
)
from swin_v2_weather_torch.training import checkpoint as ckpt
from swin_v2_weather_torch.training.optim import build_scheduler, set_learning_rate
from swin_v2_weather_torch.training.preempt import agreed
from swin_v2_weather_torch.training.step import build_eval_step, build_train_step, shard_state
from swin_v2_weather_torch.utils.logging_utils import log_to_file, log_versions
from swin_v2_weather_torch.utils.metrics_sink import MetricsSink
from swin_v2_weather_torch.utils.profiling import StepProfiler, StepTimer

logger = logging.getLogger(__name__)


def step_seed(seed: int, epoch: int, global_step: int) -> int:
    """The drop-path generator's seed for one train step: a fixed integer
    rule of (seed, epoch, global step), restart-invariant."""
    return ((int(seed) * 1_000_003 + int(epoch)) * 1_000_003 + int(global_step)) % (1 << 63)


def init_parameters(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Draw the initial weights from ``generator``, with torch's layer defaults
    (which the JAX model's initializers reproduce): every Linear's weight and
    bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the position embedding 0.02 N(0,
    1); LayerNorm and logit-scale constants keep their constructor values."""
    with torch.no_grad():
        for name, module in model.named_modules():
            if isinstance(module, torch.nn.Linear):
                bound = 1.0 / math.sqrt(module.in_features)
                module.weight.uniform_(-bound, bound, generator=generator)
                if module.bias is not None:
                    module.bias.uniform_(-bound, bound, generator=generator)
            pos = getattr(module, "pos_embed", None)
            if isinstance(pos, torch.nn.Parameter):
                pos.normal_(0.0, 0.02, generator=generator)


def seeded_parameters(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Every parameter from seeded noise (drawn on the generator's device), so
    that no block is the identity, for checks of a model with random weights:
    logit scales log(10) + 0.3 N(0, 1), position embeddings and biases
    0.02 N(0, 1), LayerNorm scales 1 + 0.1 N(0, 1), Linear weights [out, in]
    U(-1, 1) / sqrt(fan_in)."""
    kw = dict(generator=gen, device=gen.device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("logit_scale"):
                val = math.log(10.0) + 0.3 * torch.randn(p.shape, **kw)
            elif name.endswith("pos_embed") or name.endswith(".bias"):
                val = 0.02 * torch.randn(p.shape, **kw)
            elif p.dim() == 1:  # LayerNorm scale
                val = 1.0 + 0.1 * torch.randn(p.shape, **kw)
            else:
                val = (2.0 * torch.rand(p.shape, **kw) - 1.0) / math.sqrt(p.shape[1])
            p.copy_(val)


class Trainer:
    def __init__(self, params, config_name: str, run_num: str = "00", sweep_id=None,
                 device="cuda"):
        self.params = params
        self.config = config_name
        self.run_num = run_num
        self._base_run_num = run_num  # sweep trials derive per-trial run ids
        self.sweep_id = sweep_id
        self.root_dir = params["exp_dir"]

        # one process drives one device; several start their process group here
        self.process_index, self.process_count = init_distributed(device)
        self.device = rank_device(device) if self.process_count > 1 else torch.device(device)
        self.is_chief = self.process_index == 0
        self.log_to_screen = bool(params.log_to_screen) and self.is_chief
        # host-side agreement (preemption, sweep configs): CPU tensors, so a
        # gloo group beside an NCCL default group
        self._host_group = None
        if dist.is_initialized() and dist.get_backend() != "gloo":
            self._host_group = dist.new_group(backend="gloo")

        params["name"] = f"{config_name}_{run_num}"
        params["group"] = config_name

        # graceful-preemption hook (training/preempt.py); train() installs a
        # signal-backed handler unless one was injected beforehand
        self.preempt = None
        self._preempted_at = None
        self._log_file = None  # out.log's handler on the root logger

    def _close_log_file(self) -> None:
        if self._log_file is not None:
            logging.getLogger().removeHandler(self._log_file)
            self._log_file.close()
            self._log_file = None

    def count_parameters(self) -> int:
        return sum(p.numel() for p in self.model.parameters())

    # ------------------------------------------------------------------
    def build(self):
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device (torch.cuda.is_available() is False); "
                               "pass device='cpu' to train on the host")
        params = self.params
        if self.sweep_id is not None and self.is_chief:
            # a sweep-agent trial: merge the agent's params before anything
            # derived is computed (the native agent, else wandb's)
            from swin_v2_weather_torch.training import sweeps as _sweeps

            trial_cfg = _sweeps.active_config()
            if trial_cfg is not None:
                self.run_num = f"{self._base_run_num}-{_sweeps.active_trial_name()}"
                params.update_params(trial_cfg)
            else:
                import wandb

                if getattr(wandb, "run", None) is None:
                    wandb.init()
                params.update_params(dict(wandb.config))
        if self.sweep_id is not None and self.process_count > 1:
            # the agent mutated the chief's params only: every rank trains
            # the chief's trial config
            mutated = broadcast_config(_plain_dict(params) if self.is_chief else None,
                                       group=self._host_group)
            if not self.is_chief:
                params.update_params(mutated)
        params["in_channels"] = np.asarray(params["in_channels"])
        params["out_channels"] = np.asarray(params["out_channels"])
        n_in, n_out = derived_channel_counts(params)
        params["n_in_channels"] = n_in
        params["n_out_channels"] = n_out

        # experiment dirs; sweep trials get a sweep-scoped dir
        if self.sweep_id is not None:
            exp_dir = os.path.join(
                self.root_dir, "sweeps", str(self.sweep_id), self.config, str(self.run_num)
            )
        else:
            exp_dir = os.path.join(self.root_dir, self.config, str(self.run_num))
        if self.is_chief:
            os.makedirs(os.path.join(exp_dir, "training_checkpoints"), exist_ok=True)
        exp_dir = os.path.abspath(exp_dir)
        params["experiment_dir"] = exp_dir
        params["checkpoint_path"] = os.path.join(exp_dir, "training_checkpoints", "ckpt")
        params["best_checkpoint_path"] = os.path.join(exp_dir, "training_checkpoints", "best_ckpt")
        params["resuming"] = ckpt.latest_checkpoint_exists(params["checkpoint_path"])

        self._close_log_file()  # a sweep's next trial logs to its own directory
        if self.log_to_screen:
            self._log_file = log_to_file(
                logger_name=None, log_filename=os.path.join(exp_dir, "out.log"))
            log_versions()

        # the (data, model) mesh over the ranks; the loader's unit is one data
        # shard (ranks that differ only in their model index read the same
        # samples), so the data axis's size is JAX's process count here
        self.mesh = make_mesh(params) if dist.is_initialized() else None
        coords = mesh_coords(self.mesh)
        for key in ("shard_params", "shard_opt_state"):
            if self.mesh is None and bool(getattr(params, key, False)) and self.log_to_screen:
                logger.info("%s: a no-op at one process (one device holds the whole state, "
                            "as on JAX's one-device mesh)", key)
        params["global_batch_size"] = int(params.batch_size)
        if params["global_batch_size"] % coords.dp:
            raise ValueError(
                f"global batch {params.batch_size} not divisible by data shards {coords.dp}"
            )
        params["local_batch_size"] = int(params.batch_size) // coords.dp
        params["data_num_shards"] = coords.dp
        params["data_shard_id"] = coords.data_index

        # data: the ring is page-locked when the batches go to a GPU
        pin = self.device.type == "cuda"
        self.train_loader, self.train_dataset = get_data_loader(
            params, params.train_data_path, train=True, pin_memory=pin
        )
        self.valid_loader, self.valid_dataset = get_data_loader(
            params, params.valid_data_path, train=False, pin_memory=pin
        )
        params["img_shape_x"] = self.train_dataset.img_shape_x
        params["img_shape_y"] = self.train_dataset.img_shape_y

        if self.is_chief:
            with open(os.path.join(exp_dir, "hyperparams.yaml"), "w") as f:
                yaml.safe_dump(_plain_dict(params), f)

        # loss, model, preprocessing
        self.loss_obj = LossHandler(params)
        self.preprocessor = Preprocessor(params)
        self.model = get_model(params, device=self.device)
        self.seed = int(getattr(params, "seed", 333) or 333)
        init_parameters(self.model, torch.Generator(device=self.device).manual_seed(self.seed))
        # the parallel layout (DDP / ZeRO-1 / FSDP2 / latitude bands) and the
        # optimizer; at one process the model as it is
        self.layout, self.optimizer = shard_state(self.model, params, self.mesh)
        # re-seeded before every step (step_seed): the drop-path masks
        self.dp_gen = torch.Generator(device=self.device)
        self.train_step = build_train_step(
            self.model, self.loss_obj, self.preprocessor, self.optimizer,
            generator=self.dp_gen, layout=self.layout,
        )
        self.eval_step = build_eval_step(self.model, self.loss_obj, self.preprocessor, n_out,
                                         layout=self.layout)

        # restore (reference train.py:195-206)
        self.start_epoch = 0
        self.resume_step_in_epoch = 0
        self.host_step = 0
        restored = {}
        if params.finetune and not params["resuming"]:
            pretrained = getattr(params, "pretrained_checkpoint_path", None)
            if pretrained is None:
                raise ValueError("finetune needs a valid pretrained_checkpoint_path")
            if self.log_to_screen:
                logger.info("Loading checkpoint %s", pretrained)
            ckpt.restore_checkpoint(pretrained, self.model, resuming=False)
        if params["resuming"]:
            if self.log_to_screen:
                logger.info("Loading checkpoint %s", params["checkpoint_path"])
            restored = ckpt.restore_checkpoint(
                params["checkpoint_path"], self.model, self.optimizer, resuming=True,
                scheduler_template=build_scheduler(params).state_dict(),
            )
            self.start_epoch = restored["epoch"]
            self.host_step = restored["iters"]
            # nonzero after a graceful-preemption save: the first resumed
            # epoch skips the batches that were already applied
            self.resume_step_in_epoch = restored["step_in_epoch"]

        self.epoch = self.start_epoch
        self.scheduler = build_scheduler(params, last_epoch=self.start_epoch - 1)
        if "scheduler" in restored:
            # the plateau scheduler keeps its reduced LR / best / patience
            self.scheduler.load_state_dict(restored["scheduler"])

        # validation denormalization stds (reference train.py:306-308)
        if os.path.exists(str(params.global_stds_path)):
            self.valid_stds = np.load(params.global_stds_path)[0, params["out_channels"], 0, 0]
        elif str(getattr(params, "data_loader_config", "")) == "synthetic":
            self.valid_stds = np.ones(n_out, dtype=np.float32)  # unit-variance fields
        else:
            raise FileNotFoundError(
                f"global_stds_path {params.global_stds_path!r} missing — "
                "validation RMSE denormalization would be silently wrong"
            )

        self.sink = MetricsSink(
            exp_dir,
            enabled=self.is_chief,
            use_wandb=bool(params.log_to_wandb),
            wandb_kwargs=dict(
                config=_plain_dict(params),
                name=params["name"],
                group=params["group"],
                project=getattr(params, "project", "swin-weather-tpu"),
                entity=getattr(params, "entity", None),
                resume=params["resuming"],
            ),
        )
        self.profiler = StepProfiler(params, exp_dir, enabled=self.is_chief)
        self.step_timer = StepTimer(self.device)
        self.ckpt_writer = ckpt.CheckpointWriter() if params.save_checkpoint else None

        if self.log_to_screen:
            logger.info("Number of parameters = %d", self.count_parameters())
            logger.info("Device: %s", self.device)
        return self

    def build_and_launch(self):
        self.build()
        self.train()

    # ------------------------------------------------------------------
    def train(self):
        params = self.params
        if self.log_to_screen:
            logger.info("Starting Training Loop...")

        from swin_v2_weather_torch.training.preempt import PreemptionHandler

        if self.preempt is None:
            self.preempt = PreemptionHandler().install()
        best_valid_loss = 1.0e6
        try:
            self._train_loop(params, best_valid_loss)
        finally:
            self.preempt.uninstall()
            self._close_log_file()

    def _save(self, path: str, epoch: int, step_in_epoch: int = 0) -> None:
        self.ckpt_writer.save(
            path, self.model, self.optimizer, self.host_step, epoch,
            self.scheduler.state_dict(), step_in_epoch=step_in_epoch,
        )

    def _train_loop(self, params, best_valid_loss):
        for epoch in range(self.start_epoch, int(params.max_epochs)):
            start = time.time()
            set_learning_rate(self.optimizer, self.scheduler.lr)

            skip = self.resume_step_in_epoch if epoch == self.start_epoch else 0
            tr_time, train_logs = self.train_one_epoch(epoch, skip_steps=skip)

            if self._preempted_at is not None:
                # graceful preemption: persist the state at the step boundary
                # with the intra-epoch position; the scheduler was not stepped
                # for this incomplete epoch, so resume re-enters it with the
                # same LR and skips the consumed batches
                if self.ckpt_writer is not None:
                    self._save(params["checkpoint_path"], epoch, self._preempted_at)
                self.sink.log(
                    {**train_logs, "preempted_at_step": self._preempted_at}, step=self.epoch
                )
                if self.log_to_screen:
                    logger.warning(
                        "preempted at epoch %d step %d: checkpoint saved, exiting cleanly",
                        epoch, self._preempted_at,
                    )
                break
            valid_time, valid_logs = self.validate_one_epoch()

            self.scheduler.step(valid_logs["valid_loss"])

            if self.ckpt_writer is not None:
                # blocks only for the device->host copy; the disk write
                # overlaps the next epoch
                self._save(params["checkpoint_path"], self.epoch)
                if valid_logs["valid_loss"] <= best_valid_loss:
                    self._save(params["best_checkpoint_path"], self.epoch)
                    best_valid_loss = valid_logs["valid_loss"]

            self.sink.log(
                {**train_logs, **valid_logs, "lr": self.scheduler.lr,
                 "epoch_time": time.time() - start, "train_time": tr_time,
                 "valid_time": valid_time},
                step=self.epoch,
            )
            if self.log_to_screen:
                logger.info("Time taken for epoch %d is %.2f sec", epoch + 1, time.time() - start)
                logger.info("Training time = %.2f, Valid time = %.2f", tr_time, valid_time)
                logger.info(
                    "Train loss: %s. Valid loss: %s", train_logs["loss"], valid_logs["valid_loss"]
                )
        if self.ckpt_writer is not None:
            self.ckpt_writer.close()
        self.profiler.close()
        self.sink.close()
        self.train_loader.close()
        self.valid_loader.close()
        if dist.is_initialized():
            # no rank goes on (e.g. to resume) before the chief's checkpoint is on disk
            dist.barrier(group=self._host_group)

    def train_one_epoch(self, epoch: int, skip_steps: int = 0):
        self.epoch += 1
        self.train_loader.set_epoch(epoch)
        tr_start = time.time()
        metrics = []
        self._preempted_at = None
        batches = iter(self.train_loader)
        if skip_steps:
            # graceful-preemption resume: fast-forward the deterministic epoch
            # order past the steps the interrupted run already applied
            batches = itertools.islice(batches, skip_steps, None)
            if self.log_to_screen:
                logger.info("resuming epoch %d at step %d", epoch, skip_steps)
        n_done = skip_steps
        depth = int(getattr(self.params, "prefetch_depth", 2))
        for batch in cuda_prefetch(batches, self.device, depth=depth):
            self.step_timer.tick()
            self.profiler.step(self.host_step)
            self.dp_gen.manual_seed(step_seed(self.seed, epoch, self.host_step))
            metrics.append(self.train_step(batch))  # device tensors, read below
            self.host_step += 1
            n_done += 1
            # every rank stops at the same step (preempt.agreed)
            if self.preempt is not None and agreed(self.preempt.triggered, self._host_group):
                self._preempted_at = n_done
                break
        logs = {"loss": 0.0, "grad_norm": 0.0, "grad_norm_max": 0.0}
        if metrics:
            keys = list(metrics[0])
            # one host sync per epoch: every step's metrics in one copy
            fetched = torch.stack([torch.stack([m[k] for k in keys]) for m in metrics])
            fetched = fetched.cpu().double().numpy()
            col = {k: fetched[:, i] for i, k in enumerate(keys)}
            logs = {"loss": float(np.mean(col["loss"])),
                    "grad_norm": float(np.mean(col["grad_norm"])),
                    "grad_norm_max": float(np.max(col["grad_norm"]))}
            # per-module gradient norms (wandb.watch monitoring role)
            logs.update({k: float(np.mean(v)) for k, v in col.items()
                         if k.startswith("grad_norm/")})
        logs.update(self.step_timer.reset())
        return time.time() - tr_start, logs

    def validate_one_epoch(self):
        valid_start = time.time()
        outs = []
        last_batch = None
        for batch in cuda_prefetch(iter(self.valid_loader), self.device):
            # results stay on the device; one host sync at the end of the epoch
            outs.append(self.eval_step(batch))
            last_batch = batch
        steps = max(len(outs), 1)
        n_out = int(self.params["n_out_channels"])
        packed = torch.stack([torch.cat([o["loss"].reshape(1), o["rmse"], o["acc"]])
                              for o in outs]).cpu().double().numpy()
        loss_sum = float(np.sum(packed[:, 0]))
        rmse_sum = np.sum(packed[:, 1:1 + n_out], axis=0)
        valid_rmse = rmse_sum / steps * np.asarray(self.valid_stds, np.float64)
        logs = {"valid_loss": loss_sum / steps}
        acc_mean = np.mean(packed[:, 1 + n_out:], axis=0)

        track = list(getattr(self.params, "track_channels", ["u10m", "v10m"]))
        names = list(self.params.channel_names)
        for var in track:
            if var in names:
                logs[f"valid_rmse_{var}"] = float(valid_rmse[names.index(var)])
                logs[f"valid_acc_{var}"] = float(acc_mean[names.index(var)])

        # pred-vs-target panel (reference train.py:331-332, 365-369)
        if bool(getattr(self.params, "save_vis", False)) and last_batch:
            self._save_vis(last_batch)
        return time.time() - valid_start, logs

    @torch.no_grad()
    def _save_vis(self, batch) -> None:
        from swin_v2_weather_torch.utils.img_utils import vis

        inp, tar, tzen = self.preprocessor(batch)
        gen = self.layout.apply(inp, tzen, train=False)  # every band takes part
        if not self.is_chief:
            return
        fig = vis((gen[0, 0].float().cpu().numpy(), tar[0, 0].cpu().numpy()))
        out = os.path.join(self.params["experiment_dir"], f"vis_epoch{self.epoch}.png")
        fig.savefig(out, dpi=72)
        import matplotlib.pyplot as plt

        plt.close(fig)


def _plain_dict(params) -> dict:
    out = {}
    for key, value in params.params.items():
        if isinstance(value, np.ndarray):
            value = value.tolist()
        out[str(key)] = value
    return out
