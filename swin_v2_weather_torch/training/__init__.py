"""Training: the optimizer, the LR schedules and the single-step train and eval
steps (counterpart of the matching modules of ``swin_v2_weather_tpu.training``)."""
