"""Structured logging (the port's copy of chd_tpu/utils/log.py, under its
own logger name).

The reference logs with bare print() everywhere plus one unused
logging.basicConfig (kinematic_optimizer.py:294 — SURVEY §5). One leveled
logger for the whole framework; stage timers report wall-clock per pipeline
stage.
"""
from __future__ import annotations

import contextlib
import logging
import time

_LOGGER = logging.getLogger("chd_tpu_torch")
if not _LOGGER.handlers:
    h = logging.StreamHandler()
    h.setFormatter(logging.Formatter("[%(asctime)s %(name)s %(levelname)s] %(message)s", "%H:%M:%S"))
    _LOGGER.addHandler(h)
    _LOGGER.setLevel(logging.INFO)
    _LOGGER.propagate = False


def get_logger(name: str = "") -> logging.Logger:
    return _LOGGER.getChild(name) if name else _LOGGER


@contextlib.contextmanager
def stage_timer(name: str, logger: logging.Logger = _LOGGER):
    t0 = time.perf_counter()
    logger.info("%s ...", name)
    try:
        yield
    finally:
        logger.info("%s done in %.1fs", name, time.perf_counter() - t0)
