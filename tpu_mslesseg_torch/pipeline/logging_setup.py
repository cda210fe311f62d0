"""Pipeline logging with the reference's UX: SKIP/HEADER levels, ANSI
console, clean file log.

Port of ``tpu_mslesseg/pipeline/logging_setup.py``. Parity notes
(reference ``utils/configurar_logging.py``):
* custom levels SKIP=23 and HEADER=35 with ``logger.skip(...)`` /
  ``logger.header(...)`` methods (:34-48);
* colored console formatter + ANSI-stripping file formatter (:58-84);
* ``pipeline.log`` overwritten per run; demo swaps in ``demo.log`` (:133).
"""

from __future__ import annotations

import logging
import re
import sys
from pathlib import Path

from tpu_mslesseg_torch.core.distributed import env_rank

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
    log file belongs to rank 0 of a multi-process run, named by
    ``TPU_MSLESSEG_PROC_ID`` or torchrun's ``RANK`` (absent = main), read
    before any initialisation."""
    root = logging.getLogger()
    root.setLevel(level)
    root.handlers.clear()

    ch = logging.StreamHandler(sys.stdout)
    ch.setFormatter(ColorFormatter("%(message)s"))
    root.addHandler(ch)

    if log_file is not None and env_rank() == 0:
        fh = logging.FileHandler(log_file, mode="w", encoding="utf-8")
        fh.setFormatter(NoColorFormatter("%(message)s"))
        root.addHandler(fh)
    return root


def configure_logging_demo():
    """Swap the pipeline.log file handler for demo.log (cwd-relative)."""
    root = logging.getLogger()
    for h in list(root.handlers):
        if isinstance(h, logging.FileHandler) and "pipeline.log" in str(
            getattr(h, "baseFilename", "")
        ):
            root.removeHandler(h)
    demo_handler = logging.FileHandler(
        Path.cwd() / "demo.log", mode="w", encoding="utf-8"
    )
    demo_handler.setLevel(logging.INFO)
    demo_handler.setFormatter(NoColorFormatter("%(message)s"))
    root.addHandler(demo_handler)


_CONFIGURED = False


def get_logger(source_file) -> logging.Logger:
    """Per-script logger keyed by file stem (lazy global configuration)."""
    global _CONFIGURED
    if not _CONFIGURED:
        configure_logging(log_file=None)
        _CONFIGURED = True
    return logging.getLogger(Path(str(source_file)).stem)


def log_fold_status(logger, result, fold):
    """Tri-state fold status line (reference ``log_estado_fold``,
    ``utils/utils.py:503-515``)."""
    if result is None:
        logger.skip(f"⏩ Fold {fold} ya existente.")
    elif result is True or isinstance(result, (dict, list)):
        logger.info(f"🆗 Fold {fold} completado.")
    elif result == "parcial":
        logger.info(f"🔁 Fold {fold} parcialmente actualizado.")
    else:
        logger.warning(f"⚠️ Fold {fold}: estado desconocido.")


def evaluate_results(results):
    """None / True / 'parcial' aggregation (reference ``evaluar_resultados``,
    ``utils/utils.py:435-447``)."""
    if not results:
        return None
    if all(r is None for r in results):
        return None
    if all(r is True for r in results):
        return True
    return "parcial"
