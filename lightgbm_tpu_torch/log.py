"""Logging for lightgbm_tpu_torch.

The port's own copy of ``lightgbm_tpu/log.py`` (the reference logger,
include/LightGBM/utils/log.h:22-99): leveled logging with a redirectable
callback, and ``Fatal`` raising instead of aborting.
"""
from __future__ import annotations

import sys
from typing import Callable, Optional


class LightGBMError(Exception):
    """Error raised by lightgbm_tpu_torch (LightGBMError of the C API)."""


class OverloadedError(LightGBMError):
    """The serving queue shed this request (bounded admission or open
    circuit breaker); ``retry_after_s`` hints when to come back."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


# Levels mirror LogLevel in the reference (log.h:14-20).
LEVEL_FATAL = -1
LEVEL_WARNING = 0
LEVEL_INFO = 1
LEVEL_DEBUG = 2

_NAMES = {LEVEL_WARNING: "Warning", LEVEL_INFO: "Info", LEVEL_DEBUG: "Debug"}


class Log:
    """Static logger with a thread-shared level and optional callback redirect."""

    _level: int = LEVEL_INFO
    _callback: Optional[Callable[[str], None]] = None

    @classmethod
    def reset_level(cls, level: int) -> None:
        cls._level = level

    @classmethod
    def reset_callback(cls, callback: Optional[Callable[[str], None]]) -> None:
        cls._callback = callback

    @classmethod
    def _write(cls, level: int, msg: str) -> None:
        if level > cls._level:
            return
        line = "[LightGBM-Torch] [%s] %s" % (_NAMES.get(level, "Info"), msg)
        if cls._callback is not None:
            cls._callback(line + "\n")
        else:
            print(line, file=sys.stderr, flush=True)

    @classmethod
    def debug(cls, msg: str, *args) -> None:
        cls._write(LEVEL_DEBUG, msg % args if args else msg)

    @classmethod
    def info(cls, msg: str, *args) -> None:
        cls._write(LEVEL_INFO, msg % args if args else msg)

    @classmethod
    def warning(cls, msg: str, *args) -> None:
        cls._write(LEVEL_WARNING, msg % args if args else msg)

    @classmethod
    def fatal(cls, msg: str, *args) -> None:
        raise LightGBMError(msg % args if args else msg)


def outside_slice(what: str, where: str = "") -> NotImplementedError:
    """The error for an option that the port does not cover yet; ``where``
    names the ROADMAP item that brings it."""
    return NotImplementedError("%s is outside what the PyTorch port covers "
                               "so far%s"
                               % (what, " (%s)" % where if where else ""))


def check(condition: bool, msg: str = "check failed") -> None:
    """CHECK macro analog (log.h:22-28)."""
    if not condition:
        raise LightGBMError(msg)
