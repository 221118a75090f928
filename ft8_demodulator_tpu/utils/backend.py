"""The one module that knows the platform.

The decoder runs on two platforms: the CPU (tests, reference runs, the
comparison backend) and an NVIDIA GPU.  Each hot-path choice that
differs between them is a knob with a per-platform default in
``KNOBS``; an environment variable of the knob's name overrides the
default.  Callers ask :func:`knob` — no other module inspects the
platform.

The platform is probed lazily: ``jax.default_backend()`` initialises
the backend, which must never happen at library import time.  Inside
``jax.default_device(cpu_device)`` the platform is the CPU, so a
comparison decode on the host picks the CPU column of the table.
"""

from __future__ import annotations

import os

__all__ = ["KNOBS", "platform", "knob"]

# knob -> (per-platform default, allowed values)
KNOBS: dict[str, tuple[dict[str, str], tuple[str, ...]]] = {
    # sync score grid: shifted-slice stencil (exact f32) or the stencil
    # folded into per-residue matmuls (ops/sync.py sync_scores_tf_mxu)
    "FT8_SYNC_BACKEND": ({"cpu": "stencil", "gpu": "mxu"},
                         ("mxu", "stencil")),
    # MF-first front of decode_slots: matched-filter LLRs gathered from
    # the raw block spectra per candidate ("spectra") or read from the
    # boxcar power grid ("grid"); spectra measured faster on the H100
    # (PERF.md)
    "FT8_MF_FRONT": ({"cpu": "spectra", "gpu": "spectra"},
                     ("grid", "spectra")),
    # DFT matmul precision (ops/waterfall.py _PRECISIONS): DEFAULT is
    # exact f32 on the CPU; on the GPU it is TF32, which misses the
    # 0.1 dB grid tolerance in deep spectral nulls, so the GPU takes the
    # bf16x3 algorithm (PERF.md)
    "FT8_DFT_PRECISION": ({"cpu": "default", "gpu": "bf16x3"},
                          ("default", "high", "highest", "bf16x3")),
    # OSD only on BP-failed candidates ("on") or on every row ("off")
    "FT8_OSD_GATE": ({"cpu": "on", "gpu": "on"}, ("on", "off")),
    # OSD GF(2) elimination: vmapped lax.while_loop ("jnp") or the Pallas
    # kernel compiled through Triton (ops/osd_triton.py)
    "FT8_OSD_ELIM": ({"cpu": "jnp", "gpu": "triton"}, ("jnp", "triton")),
}


def platform() -> str:
    """"cpu" or "gpu" — the platform new computations run on.

    Raises on any other platform: an unknown device gets no default.
    """
    import jax

    dev = jax.config.jax_default_device
    if dev is None:
        plat = jax.default_backend()
    else:
        plat = dev if isinstance(dev, str) else dev.platform
    plat = {"cuda": "gpu"}.get(plat, plat)
    if plat not in ("cpu", "gpu"):
        raise RuntimeError(
            f"unsupported platform {plat!r}: this decoder runs on the CPU "
            "or an NVIDIA GPU")
    return plat


def knob(name: str) -> str:
    """Environment override of `name` if set, else its platform default.

    Overrides are validated: a typo like ``FT8_SYNC_BACKEND=mxuu`` would
    otherwise silently fall back to the other arm.  Whitespace and case
    are ignored; unknown values raise.
    """
    defaults, allowed = KNOBS[name]
    value = os.environ.get(name, "").strip().lower()
    if not value:
        return defaults[platform()]
    if value not in allowed:
        raise ValueError(f"unknown {name} value {value!r}: expected one of "
                         f"{sorted(allowed)}")
    return value
