"""NaN debugging — the framework's analog of the race-detection row in
SURVEY §5 (the reference is single-threaded NumPy and has neither; the
planned JAX substitute is ``jax_debug_nans`` wiring).

When enabled, every jitted decode stage re-runs op-by-op on the first NaN it
produces and raises with the offending primitive — the standard JAX
sanitizer.  Exposed three ways:

* env var ``FT8_DEBUG_NANS=1`` (checked at package import),
* :func:`enable_nan_debugging` / :func:`disable_nan_debugging`,
* the CLI flag ``--debug-nans``.
"""

from __future__ import annotations

import contextlib
import os

import jax

__all__ = ["enable_nan_debugging", "disable_nan_debugging", "nan_debugging",
           "init_from_env"]


def enable_nan_debugging() -> None:
    """Fail loudly at the first NaN inside any jitted computation."""
    jax.config.update("jax_debug_nans", True)


def disable_nan_debugging() -> None:
    jax.config.update("jax_debug_nans", False)


@contextlib.contextmanager
def nan_debugging():
    """Context manager: NaN checking on inside, restored state outside."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def init_from_env() -> bool:
    """Enable NaN debugging if FT8_DEBUG_NANS is set truthy; returns state."""
    if os.environ.get("FT8_DEBUG_NANS", "").strip() not in ("", "0", "false"):
        enable_nan_debugging()
        return True
    return False
