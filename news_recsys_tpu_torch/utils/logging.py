"""Colored console logger: the port's own copy of
:mod:`news_recsys_tpu.utils.logging` (ANSI-colored level-based formatter,
idempotent handler attach, no propagation). Loggers are named
``news_recsys_tpu_torch.<name>``.
"""

from __future__ import annotations

import logging
import sys

_RESET = "\033[0m"
_COLORS = {
    logging.DEBUG: "\033[36m",     # cyan
    logging.INFO: "\033[32m",      # green
    logging.WARNING: "\033[33m",   # yellow
    logging.ERROR: "\033[31m",     # red
    logging.CRITICAL: "\033[35m",  # magenta
}


class ColoredFormatter(logging.Formatter):
    def __init__(self, use_color: bool = True):
        super().__init__(
            fmt="%(asctime)s [%(name)s] %(levelname)s: %(message)s",
            datefmt="%Y-%m-%d %H:%M:%S",
        )
        self.use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        if self.use_color:
            color = _COLORS.get(record.levelno, "")
            if color:
                return f"{color}{msg}{_RESET}"
        return msg


def get_logger(name: str, level: int = logging.INFO) -> logging.Logger:
    """Return a logger with a single colored stderr handler (idempotent)."""
    logger = logging.getLogger(f"news_recsys_tpu_torch.{name}")
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(ColoredFormatter(use_color=sys.stderr.isatty()))
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
    return logger
