"""Leveled logging with the reference's INFO:/WARN:/ERROR:/DBUG: prefixes
(the ad-hoc convention used throughout kspecanal.py, e.g. :303,:345,:542),
routed through the stdlib logging module so hosts can redirect it.

The port's own copy of ``kspecanal_tpu.utils.logging``, on the logger
``kspecanal_tpu_torch``.
"""
from __future__ import annotations

import logging

logger = logging.getLogger("kspecanal_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


def log_info(msg: str) -> None:
    logger.info("INFO:%s", msg)


def log_warn(msg: str) -> None:
    logger.warning("WARN:%s", msg)


def log_error(msg: str) -> None:
    logger.error("ERROR:%s", msg)


def log_dbug(msg: str) -> None:
    logger.debug("DBUG:%s", msg)


# The reference prints per-iteration wall times BARE and unconditionally
# (`ZeroSpan:{i}:{dt}` kspecanal.py:462, `ZeroSpanSave:` :519-522,
# `scanRange:` :722-724) — its primary headless observability signal.
# Default matches that always-print; ``tpuLogIter false`` silences it.
_iter_logging = True


def set_iter_logging(enabled: bool) -> None:
    global _iter_logging
    _iter_logging = bool(enabled)


def log_iter(fmt: str, *args) -> None:
    """Per-iteration timing line ``fmt % args``, bare (no level prefix)
    for output parity with the reference's prints; built only while
    iteration logging is on."""
    if _iter_logging:
        logger.info(fmt, *args)
