"""Input assembly: static conditioning channels, channel counts, the
preprocessor and the synthetic dataset (counterpart of the matching modules of
``swin_v2_weather_tpu.data``)."""
