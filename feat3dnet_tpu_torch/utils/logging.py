"""Logging setup (port of feat3dnet_tpu/utils/logging.py; reference:
logging.conf + train.py:74-82 file handler)."""
from __future__ import annotations

import logging
import os
import sys


def setup_logging(log_file: str | None = None, level: int = logging.DEBUG) -> logging.Logger:
    """The `feat3dnet_tpu_torch` logger with a stdout handler and, given
    `log_file`, a file handler (each added once)."""
    logger = logging.getLogger("feat3dnet_tpu_torch")
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s [%(levelname)s] %(name)s - %(message)s")
    if not any(isinstance(h, logging.StreamHandler) for h in logger.handlers):
        console = logging.StreamHandler(sys.stdout)
        console.setFormatter(fmt)
        logger.addHandler(console)
    if log_file is not None:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        if not any(isinstance(h, logging.FileHandler)
                   and getattr(h, "baseFilename", None) == os.path.abspath(log_file)
                   for h in logger.handlers):
            fh = logging.FileHandler(log_file)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger
