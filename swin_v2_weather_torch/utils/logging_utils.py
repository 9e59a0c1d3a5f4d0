"""Logging configuration (PyTorch port).

Counterpart of ``swin_v2_weather_tpu/utils/logging_utils.py``: root-logger
setup, a per-experiment file handler and the environment stamp, which names
torch, CUDA and the card (its name and power limit, as ``nvidia-smi`` reports
them) where the JAX package names jax and its backend.
"""

from __future__ import annotations

import logging
import subprocess

_FORMAT = "%(asctime)s - %(levelname)s - %(message)s"


def config_logger(log_level: int = logging.INFO) -> None:
    # force: an interpreter hook may have attached a root handler at WARNING
    # already; replace it or INFO logs vanish
    logging.basicConfig(format=_FORMAT, level=log_level, force=True)


def log_to_file(
    logger_name: str | None = None,
    log_level: int = logging.INFO,
    log_filename: str = "tmp.log",
) -> logging.FileHandler:
    """Add a file handler to the logger; returns it, for the caller to remove
    and close when the run ends."""
    logger = logging.getLogger(logger_name)
    fh = logging.FileHandler(log_filename)
    fh.setLevel(log_level)
    fh.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(fh)
    return fh


def card_name_and_power_limit() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` for
    the first card, or None where nvidia-smi is absent or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        return None
    return out[0].strip() if out else None


def log_versions() -> None:
    import torch

    logging.info("--------------- Versions ---------------")
    try:
        branch = subprocess.check_output(
            ["git", "rev-parse", "--abbrev-ref", "HEAD"], stderr=subprocess.DEVNULL
        ).strip()
        commit = subprocess.check_output(
            ["git", "rev-parse", "HEAD"], stderr=subprocess.DEVNULL
        ).strip()
        logging.info("git branch: %s", str(branch))
        logging.info("git hash: %s", str(commit))
    except (subprocess.CalledProcessError, FileNotFoundError):
        pass
    logging.info("torch: %s", torch.__version__)
    logging.info("CUDA: %s", torch.version.cuda)
    if torch.cuda.is_available():
        logging.info("devices: %d x %s", torch.cuda.device_count(), torch.cuda.get_device_name(0))
        logging.info("card (name, power limit): %s", card_name_and_power_limit())
    else:
        logging.info("devices: no CUDA device")
    logging.info("----------------------------------------")
