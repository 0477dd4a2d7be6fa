"""Logging configuration: the Reporter equivalent.

The reference routes FAST's global Reporter so INFO is silenced and
WARNING/ERROR go to the console (main_sequential.cpp:310-315,349-354,
main_parallel.cpp:394-399). This module reproduces that routing on Python
logging, plus a ``--verbose`` escape hatch the reference lacks.
"""

from __future__ import annotations

import logging
import sys

LOGGER_NAME = "nm03_torch"


def get_logger(child: str | None = None) -> logging.Logger:
    name = LOGGER_NAME if child is None else f"{LOGGER_NAME}.{child}"
    return logging.getLogger(name)


def configure_reporting(verbose: bool = False, stream=None) -> logging.Logger:
    """INFO silenced (unless verbose), WARNING/ERROR to console.

    Mirrors Reporter::setGlobalReportMethod(INFO, NONE) /(WARNING, COUT) /
    (ERROR, COUT).
    """
    logger = logging.getLogger(LOGGER_NAME)
    logger.handlers.clear()
    handler = logging.StreamHandler(stream or sys.stdout)
    handler.setFormatter(logging.Formatter("%(levelname)s %(name)s: %(message)s"))
    logger.addHandler(handler)
    logger.setLevel(logging.INFO if verbose else logging.WARNING)
    logger.propagate = False
    return logger
