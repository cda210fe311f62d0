"""Pipeline logging with the reference's UX: SKIP/HEADER levels, ANSI
console, clean file log.

Port of ``tpu_mslesseg/pipeline/logging_setup.py``. Parity notes
(reference ``utils/configurar_logging.py``):
* custom levels SKIP=23 and HEADER=35 with ``logger.skip(...)`` /
  ``logger.header(...)`` methods (:34-48);
* colored console formatter + ANSI-stripping file formatter (:58-84);
* ``pipeline.log`` overwritten per run.

The demo's log swap and the stage chain's fold-status helpers come with
those entry points.
"""

from __future__ import annotations

import logging
import os
import re
import sys
from pathlib import Path

SKIP_LEVEL = 23
HEADER_LEVEL = 35

_ANSI_RE = re.compile(r"\x1B\[[0-?]*[ -/]*[@-~]")


def _register_level(value: int, name: str) -> int:
    logging.addLevelName(value, name)

    def log_method(self, message, *args, **kwargs):
        if self.isEnabledFor(value):
            self._log(value, message, args, **kwargs)

    setattr(logging.Logger, name.lower(), log_method)
    return value


_register_level(SKIP_LEVEL, "SKIP")
_register_level(HEADER_LEVEL, "HEADER")


class ColorFormatter(logging.Formatter):
    COLORS = {
        logging.DEBUG: "\033[90m",
        logging.INFO: "\033[38;5;39m",
        logging.WARNING: "\033[1;93m",
        logging.ERROR: "\033[1;91m",
        logging.CRITICAL: "\033[1;97;41m",
        SKIP_LEVEL: "\033[38;5;33m",
        HEADER_LEVEL: "\033[1;97m",
    }
    RESET = "\033[0m"

    def format(self, record):
        color = self.COLORS.get(record.levelno, self.RESET)
        return f"{color}{super().format(record)}{self.RESET}"


class NoColorFormatter(logging.Formatter):
    def format(self, record):
        return _ANSI_RE.sub("", super().format(record))


def configure_logging(level=logging.INFO, log_file="pipeline.log"):
    """Install console + file handlers on the root logger (idempotent). The
    log file belongs to process 0 of a multi-process run, named by
    ``TPU_MSLESSEG_PROC_ID`` (absent = main)."""
    root = logging.getLogger()
    root.setLevel(level)
    root.handlers.clear()

    ch = logging.StreamHandler(sys.stdout)
    ch.setFormatter(ColorFormatter("%(message)s"))
    root.addHandler(ch)

    if log_file is not None and os.environ.get("TPU_MSLESSEG_PROC_ID", "0") in ("", "0"):
        fh = logging.FileHandler(log_file, mode="w", encoding="utf-8")
        fh.setFormatter(NoColorFormatter("%(message)s"))
        root.addHandler(fh)
    return root


_CONFIGURED = False


def get_logger(source_file) -> logging.Logger:
    """Per-script logger keyed by file stem (lazy global configuration)."""
    global _CONFIGURED
    if not _CONFIGURED:
        configure_logging(log_file=None)
        _CONFIGURED = True
    return logging.getLogger(Path(str(source_file)).stem)
