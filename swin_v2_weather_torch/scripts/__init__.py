"""GPU scripts of the port (run as ``python -m swin_v2_weather_torch.scripts.<name>``)."""
