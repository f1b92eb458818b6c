"""Logging/observability.

The reference routes ALOGD/E/I/V/W to Android liblog or stderr gated by
a compile flag (libultrahdr lib/include/ultrahdr/ultrahdrcommon.h:
32-70, CMake UHDR_ENABLE_LOGS). Here: standard `logging` under the
"uhdr" namespace, enabled by the UHDR_LOG env var (e.g. UHDR_LOG=debug)
so production imports stay silent by default, like the reference's
no-op build. A copy of libultrahdr_dev_tpu/utils/log.py."""

from __future__ import annotations

import logging
import os

_LEVELS = {"verbose": logging.DEBUG, "debug": logging.DEBUG,
           "info": logging.INFO, "warn": logging.WARNING,
           "warning": logging.WARNING, "error": logging.ERROR}


def get_logger(name: str = "uhdr") -> logging.Logger:
    logger = logging.getLogger(name)
    if not getattr(logger, "_uhdr_configured", False):
        level = os.environ.get("UHDR_LOG", "").lower()
        if level in _LEVELS:
            handler = logging.StreamHandler()
            handler.setFormatter(logging.Formatter(
                "%(asctime)s %(name)s %(levelname).1s: %(message)s"))
            logger.addHandler(handler)
            logger.setLevel(_LEVELS[level])
        else:
            logger.addHandler(logging.NullHandler())
        logger._uhdr_configured = True
    return logger
