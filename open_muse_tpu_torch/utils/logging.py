"""Library logging: one logger per library with env-var verbosity and
progress-bar gating.

Counterpart of ``open_muse_tpu/utils/logging.py`` (muse/logging.py's named
levels, ``set_verbosity*``, ``enable/disable_progress_bar``).  The library's
root logger is ``open_muse_tpu_torch``; its level comes from
``OPEN_MUSE_TPU_TORCH_VERBOSITY`` (else the reference's ``muse_VERBOSITY``),
WARNING by default.  It writes to stderr through a handler of its own and
still propagates, so handlers on Python's root logger (an application's,
pytest's) see its records too.  ``set_verbosity_for_process`` gives INFO to
rank 0 of the ``torch.distributed`` group and ERROR to the other ranks.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
from typing import Optional

__all__ = [
    "get_logger",
    "get_verbosity",
    "set_verbosity",
    "set_verbosity_debug",
    "set_verbosity_info",
    "set_verbosity_warning",
    "set_verbosity_error",
    "enable_progress_bar",
    "disable_progress_bar",
    "is_progress_bar_enabled",
    "set_verbosity_for_process",
]

ENV_VAR = "OPEN_MUSE_TPU_TORCH_VERBOSITY"

_lock = threading.Lock()
_default_handler: Optional[logging.Handler] = None
_progress_bar_enabled = True

log_levels = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}
_default_log_level = logging.WARNING


def _get_default_logging_level() -> int:
    env_level = os.getenv(ENV_VAR, os.getenv("muse_VERBOSITY"))
    if env_level:
        if env_level.lower() in log_levels:
            return log_levels[env_level.lower()]
        logging.getLogger().warning(
            f"Unknown {ENV_VAR}={env_level}, has to be one of: {', '.join(log_levels)}")
    return _default_log_level


def _get_library_name() -> str:
    return __name__.split(".")[0]


def _get_library_root_logger() -> logging.Logger:
    return logging.getLogger(_get_library_name())


def _configure_library_root_logger() -> None:
    global _default_handler
    with _lock:
        if _default_handler:
            return
        _default_handler = logging.StreamHandler(sys.stderr)
        _default_handler.flush = sys.stderr.flush
        root = _get_library_root_logger()
        root.addHandler(_default_handler)
        root.setLevel(_get_default_logging_level())


def get_logger(name: Optional[str] = None) -> logging.Logger:
    """The logger ``name`` (the library's root logger when None)."""
    if name is None:
        name = _get_library_name()
    _configure_library_root_logger()
    return logging.getLogger(name)


def get_verbosity() -> int:
    _configure_library_root_logger()
    return _get_library_root_logger().getEffectiveLevel()


def set_verbosity(verbosity: int) -> None:
    _configure_library_root_logger()
    _get_library_root_logger().setLevel(verbosity)


def set_verbosity_debug() -> None:
    set_verbosity(logging.DEBUG)


def set_verbosity_info() -> None:
    set_verbosity(logging.INFO)


def set_verbosity_warning() -> None:
    set_verbosity(logging.WARNING)


def set_verbosity_error() -> None:
    set_verbosity(logging.ERROR)


def set_verbosity_for_process(is_main_process: Optional[bool] = None) -> None:
    """INFO on rank 0, ERROR elsewhere; the rank is the ``torch.distributed``
    group's (rank 0 when no group is initialised)."""
    if is_main_process is None:
        import torch.distributed as dist

        is_main_process = not (dist.is_available() and dist.is_initialized()) \
            or dist.get_rank() == 0
    set_verbosity_info() if is_main_process else set_verbosity_error()


def enable_progress_bar() -> None:
    global _progress_bar_enabled
    _progress_bar_enabled = True


def disable_progress_bar() -> None:
    global _progress_bar_enabled
    _progress_bar_enabled = False


def is_progress_bar_enabled() -> bool:
    return _progress_bar_enabled
