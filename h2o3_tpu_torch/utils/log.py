"""Logging (counterpart of h2o3_tpu/utils/log.py): one leveled logger,
to stderr and to a file under the ice root, plus the progress switch
that `h2o.no_progress()` / `h2o.show_progress()` set.

`H2O_TPU_LOG_LEVEL` sets the level (INFO by default). The file is
`h2o3_tpu_torch.log` in `H2O_TPU_ICE_ROOT`, by default a folder of the
system's temporary directory. Warning-and-up records also count as the
``h2o3_log_messages_total`` series of ``/3/Metrics``, by level.
"""

from __future__ import annotations

import logging
import os
import sys
import tempfile

PROGRESS = True
_LOGGER = None


class _MetricsHandler(logging.Handler):
    """Counts warning-and-up records on ``h2o3_log_messages_total``."""

    def emit(self, record):
        try:
            from h2o3_tpu_torch.obs import metrics

            metrics.inc("h2o3_log_messages_total",
                        level=record.levelname.lower())
        except Exception:   # noqa: BLE001 — counting must never re-log
            pass


def get_logger() -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        lg = logging.getLogger("h2o3_tpu_torch")
        lg.setLevel(os.environ.get("H2O_TPU_LOG_LEVEL", "INFO"))
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname).1s h2o3_tpu_torch: %(message)s"))
        lg.addHandler(h)
        mh = _MetricsHandler()
        mh.setLevel(logging.WARNING)
        lg.addHandler(mh)
        try:
            ice = os.environ.get("H2O_TPU_ICE_ROOT") or os.path.join(
                tempfile.gettempdir(), "h2o3_tpu_torch")
            os.makedirs(ice, exist_ok=True)
            fh = logging.FileHandler(os.path.join(ice, "h2o3_tpu_torch.log"))
            fh.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname).1s %(message)s"))
            lg.addHandler(fh)
        except OSError:
            pass
        lg.propagate = False
        _LOGGER = lg
    return _LOGGER


def info(msg: str) -> None:
    get_logger().info(msg)


def warn(msg: str) -> None:
    get_logger().warning(msg)


def debug(msg: str) -> None:
    get_logger().debug(msg)
