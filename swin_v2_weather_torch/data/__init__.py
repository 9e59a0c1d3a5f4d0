"""Input assembly: static conditioning channels, channel counts, the
preprocessor, the synthetic and ERA5 datasets, the loader and its GPU prefetch,
archive statistics (counterpart of the matching modules of
``swin_v2_weather_tpu.data``)."""
