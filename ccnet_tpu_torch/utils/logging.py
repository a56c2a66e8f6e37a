"""Colored stdlib logger, the same factory as :mod:`ccnet_tpu.utils.logging`
(level from the ``CCNET_TPU_LOGGING_LEVEL`` env var, optional file handler)."""

from __future__ import annotations

import logging
import os
import sys

_COLORS = {"WARNING": 33, "INFO": 36, "DEBUG": 34, "ERROR": 31, "CRITICAL": 35}


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        if sys.stderr.isatty():
            color = _COLORS.get(record.levelname, 37)
            return f"\x1b[{color}m{msg}\x1b[0m"
        return msg


def get_logger(name: str = "ccnet_tpu_torch", log_file: str | None = None) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    level = os.environ.get("CCNET_TPU_LOGGING_LEVEL", "INFO").upper()
    logger.setLevel(getattr(logging, level, logging.INFO))
    fmt = "%(asctime)s %(levelname)s %(name)s: %(message)s"
    sh = logging.StreamHandler()
    sh.setFormatter(_ColorFormatter(fmt, datefmt="%H:%M:%S"))
    logger.addHandler(sh)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter(fmt))
        logger.addHandler(fh)
    logger.propagate = False
    return logger
