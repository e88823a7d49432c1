"""Structured logging (the port's copy of chd_tpu/utils/log.py, under its
own logger name).

The reference logs with bare print() everywhere plus one unused
logging.basicConfig (kinematic_optimizer.py:294 — SURVEY §5). One leveled
logger for the whole framework. The pipeline's stages are timed by the spans
of ``utils.profiling``, which ``pipeline.run`` logs.
"""
from __future__ import annotations

import logging

_LOGGER = logging.getLogger("chd_tpu_torch")
if not _LOGGER.handlers:
    h = logging.StreamHandler()
    h.setFormatter(logging.Formatter("[%(asctime)s %(name)s %(levelname)s] %(message)s", "%H:%M:%S"))
    _LOGGER.addHandler(h)
    _LOGGER.setLevel(logging.INFO)
    _LOGGER.propagate = False


def get_logger(name: str = "") -> logging.Logger:
    return _LOGGER.getChild(name) if name else _LOGGER

