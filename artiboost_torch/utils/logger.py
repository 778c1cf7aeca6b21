"""Coloured singleton logger (counterpart of ``artiboost_tpu/utils/logger.py``;
reference ``anakin/utils/logger.py:63``): one stderr handler, coloured by
level when stderr is a TTY, its level from ``ARTIBOOST_LOGLEVEL`` (default
INFO); ``add_file_handler`` adds a log file.

One difference: the logger propagates, so handlers on the root logger (a
host application's, pytest's ``caplog``) see its records too. The port's
entry points configure no root handler, so a line is printed once."""
from __future__ import annotations

import logging
import os
import sys
from typing import Optional

FORMAT = "%(asctime)s | %(levelname)s | %(message)s"
_COLORS = {
    logging.DEBUG: "\033[36m",
    logging.INFO: "\033[32m",
    logging.WARNING: "\033[33m",
    logging.ERROR: "\033[31m",
    logging.CRITICAL: "\033[35m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        if sys.stderr.isatty():
            color = _COLORS.get(record.levelno, "")
            return f"{color}{msg}{_RESET}"
        return msg


def _make_logger() -> logging.Logger:
    lg = logging.getLogger("artiboost_torch")
    if lg.handlers:
        return lg
    lg.setLevel(os.environ.get("ARTIBOOST_LOGLEVEL", "INFO"))
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(_ColorFormatter(FORMAT, "%H:%M:%S"))
    lg.addHandler(handler)
    return lg


logger = _make_logger()


def add_file_handler(path: str, level: Optional[str] = None) -> logging.FileHandler:
    """Also log to ``path`` (its directory made); -> the handler, so that a
    caller can remove and close it."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fh = logging.FileHandler(path)
    fh.setFormatter(logging.Formatter(FORMAT))
    if level:
        fh.setLevel(level)
    logger.addHandler(fh)
    return fh
