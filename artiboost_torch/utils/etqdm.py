"""Progress bar with live metric postfix (counterpart of
``artiboost_tpu/utils/etqdm.py``; reference ``anakin/utils/etqdm.py``):
a tqdm bar carrying the evaluator's string during an epoch pass where tqdm
is installed and stderr is a TTY, else a logger line every
``log_interval`` seconds (per-line logs beat control characters in a
batch job's log)."""
from __future__ import annotations

import sys
import time
from typing import Iterable, Optional

from artiboost_torch.utils.logger import logger

try:
    from tqdm import tqdm as _tqdm
except ImportError:  # pragma: no cover
    _tqdm = None


class _LoggerBar:
    """tqdm-shaped shim that logs every ``log_interval`` seconds."""

    def __init__(self, iterable, total=None, desc="", log_interval=30.0):
        self.iterable = iterable
        self.total = total if total is not None else (
            len(iterable) if hasattr(iterable, "__len__") else None)
        self.desc = desc
        self.log_interval = log_interval
        self._postfix = ""
        self._count = 0
        self._t0 = time.time()
        self._last_log = self._t0

    def __iter__(self):
        for item in self.iterable:
            yield item
            self._count += 1
            now = time.time()
            if now - self._last_log >= self.log_interval:
                self._last_log = now
                rate = self._count / max(now - self._t0, 1e-6)
                tot = f"/{self.total}" if self.total else ""
                logger.info(f"{self.desc} [{self._count}{tot}] "
                            f"{rate:.2f} it/s {self._postfix}")

    def set_description(self, desc):
        self.desc = desc

    def set_postfix_str(self, s):
        self._postfix = s

    def update(self, n=1):
        self._count += n

    def close(self):
        pass


def etqdm(iterable: Iterable, total: Optional[int] = None, desc: str = "",
          use_tty: Optional[bool] = None):
    if use_tty is None:
        use_tty = sys.stderr.isatty()
    if _tqdm is not None and use_tty:
        return _tqdm(iterable, total=total, desc=desc, dynamic_ncols=True)
    return _LoggerBar(iterable, total=total, desc=desc)
