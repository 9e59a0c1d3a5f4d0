"""Host milliseconds in RolloutEngine.zenith_stack per forecast step over the
window (a timer the benchmark wraps around the engine's method)."""


def read(ctx):
    if ctx["kind"] != "forecast" or not ctx.get("forecast_steps"):
        return None
    return 1e3 * ctx["zenith_s"] / ctx["forecast_steps"]
