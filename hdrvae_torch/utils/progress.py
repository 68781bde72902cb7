"""Progress reporting, as ``hdrvae/utils/progress.py``.

The framework-owned counterpart of a host framework's progress bar (the
export node advances it a frame, the upscale node a tile).  A
:class:`ProgressBar` draws a carriage-return bar on a TTY and logs
quarter steps otherwise, so batch and CI logs stay readable.  Any object
with ``update(n)`` satisfies the protocol, so a host can pass its own.
"""

from __future__ import annotations

import logging
import sys
import time
from typing import Optional, TextIO

logger = logging.getLogger(__name__)


class ProgressBar:
    """Minimal, dependency-free progress bar (``update(n)`` protocol)."""

    def __init__(self, total: int, desc: str = "",
                 stream: Optional[TextIO] = None):
        self.total = max(int(total), 1)
        self.desc = desc
        self.n = 0
        self._stream = stream if stream is not None else sys.stderr
        self._t0 = time.perf_counter()
        self._last_quarter = 0
        self._tty = bool(getattr(self._stream, "isatty", lambda: False)())

    def update(self, n: int = 1) -> None:
        self.n = min(self.n + n, self.total)
        if self._tty:
            width = 30
            filled = int(width * self.n / self.total)
            bar = "#" * filled + "-" * (width - filled)
            self._stream.write(f"\r{self.desc}[{bar}] "
                               f"{self.n}/{self.total}")
            if self.n >= self.total:
                self._stream.write("\n")
            self._stream.flush()
        else:
            quarter = 4 * self.n // self.total
            if quarter > self._last_quarter or self.n >= self.total:
                self._last_quarter = quarter
                dt = time.perf_counter() - self._t0
                logger.info("%s%d/%d (%.1fs)", self.desc or "progress ",
                            self.n, self.total, dt)

    def close(self) -> None:
        if self._tty and self.n < self.total:
            self._stream.write("\n")
            self._stream.flush()
