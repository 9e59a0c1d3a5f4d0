"""Run one cell of the benchmark of ``swin_v2_weather_torch`` (see
``BENCHMARK.json``):

    python3 benchmark/run.py --workload flagship-train --seed 7 --seconds 30 --trace 0

from the root of a checkout. Exits non-zero without a result where the
cell's CUDA devices are missing.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(
    os.path.abspath(__file__))]
# no library the port imports may pull in JAX by itself
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
# kernel caches at fixed paths inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "_bench_cache", "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(ROOT, "_bench_cache", "inductor")

from benchmark.harness.main import run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run(t_start=T_START))
