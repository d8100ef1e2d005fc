"""Leveled logging (reference ``paddle_tpu/utils/log.py``): Python's
logging under the logger ``paddle_tpu_torch``, with env-controlled
verbosity:

* ``PADDLE_TPU_LOG_LEVEL`` — standard level name (default WARNING)
* ``PADDLE_TPU_VLOG``     — integer VLOG verbosity (default 0)

:func:`structured` writes the telemetry line format of the reference,
``<event> {json fields}``, on the child logger
``paddle_tpu_torch.telemetry``.
"""

import json
import logging
import os
import sys

__all__ = ["logger", "telemetry_logger", "vlog", "set_level",
           "structured"]

_NAME = "paddle_tpu_torch"
_LOGGER = None


class _StderrHandler(logging.StreamHandler):
    """StreamHandler that resolves sys.stderr at emit time, so the
    logger keeps working when the stream is swapped after setup (pytest
    capture, daemon redirection)."""

    def __init__(self):
        logging.Handler.__init__(self)

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, value):  # the base-class constructor assigns
        pass


def logger():
    global _LOGGER
    if _LOGGER is None:
        lg = logging.getLogger(_NAME)
        if not lg.handlers:
            h = _StderrHandler()
            h.setFormatter(logging.Formatter(
                "%(levelname).1s %(asctime)s %(name)s] %(message)s",
                "%m%d %H:%M:%S"))
            lg.addHandler(h)
            lg.propagate = False
        lg.setLevel(os.environ.get("PADDLE_TPU_LOG_LEVEL",
                                   "WARNING").upper())
        _LOGGER = lg
    return _LOGGER


def set_level(level):
    logger().setLevel(level.upper() if isinstance(level, str) else level)


def vlog(n, msg, *args):
    """VLOG(n): emitted at INFO when PADDLE_TPU_VLOG >= n."""
    if int(os.environ.get("PADDLE_TPU_VLOG", "0")) >= n:
        logger().info(msg, *args)


def telemetry_logger():
    """Child logger for machine-parseable telemetry lines, at INFO by
    default so requested telemetry emits without touching the package
    level (the parent's WARNING filters its own records, not propagated
    child records). Silence it with
    ``logging.getLogger("paddle_tpu_torch.telemetry").setLevel(...)``."""
    lg = logging.getLogger(_NAME + ".telemetry")
    if lg.level == logging.NOTSET:
        lg.setLevel(logging.INFO)
    logger()  # the parent's handler must exist to propagate into
    return lg


def structured(event, **fields):
    """One machine-parseable line: ``<event> {json fields}`` (grep the
    event name, json-parse the rest)."""
    telemetry_logger().info("%s %s", event,
                            json.dumps(fields, sort_keys=True,
                                       default=str))
