"""Training: the optimizer, the LR schedules, the single-step train and eval
steps, the Trainer, checkpoints, preemption and sweeps (counterpart of the
matching modules of ``swin_v2_weather_tpu.training``)."""
