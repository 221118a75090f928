"""GFSK modulator: tone ids -> phase-continuous complex baseband.

Vectorised formulation.  The reference builds the instantaneous-frequency
track with a per-sample double loop and accumulates phase with `math.fmod`
one sample at a time (src/ft8_tools/ft8_generator/modulator.py:27,56) — about
1.5e5 Python iterations per message.  Here the track is three outer products
(each output slot sees exactly three Gaussian pulse segments) and the phase
accumulation is a hierarchical cumsum that stays accurate in float32:

* within a symbol slot: cumsum over <= sps samples (values stay small),
* across slots: a cumulative product of 79 unit phasors, so the growing
  integer part of the phase never has to be represented.

The waveform convention matches the reference exactly
(``w[n] = sin(phi_n) - j cos(phi_n) = -j exp(j phi_n)``, raised-cosine
amplitude ramps over the first/last sps/8 samples) with ONE deliberate
fix: symbol k's Gaussian pulse is centred at sample (k + 0.5) * sps — the
WSJT-X alignment.  The reference integrates the first 79*sps samples of
its (79+2)*sps frequency track (modulator.py:49,68), dropping WSJT-X's
one-symbol read offset (ft8sim's ``dphi(j+nsps)``): every symbol lands
one symbol LATE and the final Costas symbol is truncated off the end —
reported decode times ran 0.16 s past the physical start (caught by
benchmarks/soak.py, 60/60 trials) and a strict receiver loses the last
sync cell.  ``reference_quirk=True`` reproduces the reference's shifted
waveform bit-for-bit (compat.py uses it; the goldens validate both
paths — the fixed track equals the same reference track read at the
WSJT-X offset).

Complex-at-the-boundary rule: every jitted entry point here returns
complex signals as a stacked ``(..., n, 2)`` float32 [real, imag] array
(complex *compute* inside jit is unaffected) — a convention from an
earlier backend that could not transfer complex arrays; ROADMAP §3.7
weighs dropping it.  ``ft8_baseband`` combines the
pair into numpy complex on the host for API convenience.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..protocol import constants as C
from ..protocol.encode import encode_tones

__all__ = [
    "gauss_window",
    "gfsk_frequency_track",
    "tones_to_baseband",
    "ft8_baseband",
    "ft8_passband",
]

_GFSK_BT = 2.0


def gauss_window(bt: float, t: jnp.ndarray) -> jnp.ndarray:
    """Gaussian frequency-smoothing pulse (integral of a Gaussian over 1 sym).

    Same closed form as the reference (modulator.py:20): 0.5*(erf(k*bt*(t+.5))
    - erf(k*bt*(t-.5))) with k = pi*sqrt(2/ln 2).
    """
    k = np.pi * np.sqrt(2.0 / np.log(2.0))
    return 0.5 * (
        jax.scipy.special.erf(k * bt * (t + 0.5))
        - jax.scipy.special.erf(k * bt * (t - 0.5))
    )


def _window_segments(sps: int, dtype) -> jnp.ndarray:
    """(3, sps) Gaussian pulse split into its three symbol-length segments."""
    t = (jnp.arange(3 * sps, dtype=dtype) - 1.5 * sps) / sps
    return gauss_window(_GFSK_BT, t).reshape(3, sps)


def gfsk_frequency_track(tones: jnp.ndarray, sps: int,
                         dtype=jnp.float32,
                         reference_quirk: bool = False) -> jnp.ndarray:
    """(..., 79) tone ids -> (..., 79, sps) tone-unit frequency track.

    Output slot s overlaps exactly three Gaussian pulses (symbols s-1, s,
    s+1, with the first/last tone extended past the frame edges), so the
    track is a 3-term blend: track[s] = te[s]*w2 + te[s+1]*w1 + te[s+2]*w0
    with te = [t0, t0..t78, t78] — symbol s's pulse centred at
    (s + 0.5)*sps, the WSJT-X alignment, equal to the reference's
    (79+2)*sps scatter-add track (modulator.py:38-49) read at offset sps
    (tested against the reference golden at exactly that offset).

    reference_quirk=True instead reads the reference track at offset 0
    (te = [0, t0, t0..t78, t78]): every symbol one symbol late, the last
    Costas symbol truncated — the reference's actual transmissions (see
    module docstring).
    """
    w0, w1, w2 = _window_segments(sps, dtype)
    t = tones.astype(dtype)
    first = t[..., :1]
    last = t[..., -1:]
    if reference_quirk:
        zero = jnp.zeros_like(first)
        te = jnp.concatenate([zero, first, t, last], axis=-1)  # (..., 82)
    else:
        te = jnp.concatenate([first, t, last], axis=-1)        # (..., 81)
    track = (
        te[..., 0:79, None] * w2
        + te[..., 1:80, None] * w1
        + te[..., 2:81, None] * w0
    )
    return track  # (..., 79, sps)


def _phase_fraction(track: jnp.ndarray, sps: int, fs: float, f0: float,
                    dtype) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Phase (in cycles mod 1) at every sample, split as (slot phasor, frac).

    Returns (E_slot[..., 79] complex unit phasors at slot starts,
             frac[..., 79, sps] fractional cycles within each slot).
    """
    df = C.TONE_SPACING_HZ / fs          # cycles per sample per tone unit
    c0 = f0 / fs                         # carrier cycles per sample

    # Within-slot cycles: exclusive cumsum of per-sample cycle increments.
    inc = track * df                                     # (..., 79, sps)
    cs = jnp.cumsum(inc, axis=-1) - inc                  # exclusive
    r = jnp.arange(sps, dtype=dtype)
    frac_carrier = jnp.mod(c0 * r, 1.0)
    frac = jnp.mod(cs + frac_carrier, 1.0)               # (..., 79, sps)

    # Slot-start phases: accumulate per-slot totals as unit phasors so the
    # integer cycle count is never represented (f32-exact for 79 products).
    slot_cycles = jnp.mod(jnp.sum(inc, axis=-1) + jnp.mod(c0 * sps, 1.0), 1.0)
    slot_phasor = jnp.exp(2j * jnp.pi * slot_cycles.astype(jnp.float32))
    e = jnp.cumprod(slot_phasor, axis=-1)
    e = jnp.roll(e, 1, axis=-1)
    ones = jnp.ones_like(e[..., :1])
    e = jnp.concatenate([ones, e[..., 1:]], axis=-1)     # exclusive cumprod
    return e, frac


def _baseband_complex(tones: jnp.ndarray, sps: int, fs: float,
                      f0: float,
                      reference_quirk: bool = False) -> jnp.ndarray:
    """(..., 79) tone ids -> (..., 79*sps) complex64 baseband (jit-internal)."""
    dtype = jnp.float32
    track = gfsk_frequency_track(tones, sps, dtype, reference_quirk)
    e_slot, frac = _phase_fraction(track, sps, fs, f0, dtype)
    w = e_slot[..., :, None] * jnp.exp(2j * jnp.pi * frac.astype(jnp.float32))
    # reference convention: sin(phi) - j cos(phi) = -j * exp(j phi)
    w = -1j * w
    w = w.reshape(*tones.shape[:-1], C.NUM_SYMBOLS * sps)

    # raised-cosine amplitude ramp over first/last sps//8 samples
    # (modulator.py:70-73)
    n = C.NUM_SYMBOLS * sps
    nramp = sps // 8
    i = jnp.arange(n, dtype=dtype)
    up = 0.5 * (1.0 - jnp.cos(8.0 * jnp.pi * i / sps))
    down = 0.5 * (1.0 + jnp.cos(8.0 * jnp.pi * (n - 1 - i) / sps))
    ramp = jnp.where(i < nramp, up, 1.0)
    ramp = jnp.where(i >= n - nramp, down, ramp)
    return (w * ramp).astype(jnp.complex64)


@functools.partial(jax.jit, static_argnames=("sps", "fs", "f0",
                                             "reference_quirk"))
def tones_to_baseband(tones: jnp.ndarray, sps: int, fs: float,
                      f0: float,
                      reference_quirk: bool = False) -> jnp.ndarray:
    """(..., 79) tone ids -> (..., 79*sps, 2) float32 [real, imag] baseband."""
    w = _baseband_complex(tones, sps, fs, f0, reference_quirk)
    return jnp.stack([jnp.real(w), jnp.imag(w)], axis=-1)


def ft8_baseband(payload, fs: float, f0: float,
                 reference_quirk: bool = False) -> np.ndarray:
    """(..., 10) payload bytes -> host numpy complex64 baseband transmission.

    Convenience wrapper; performance paths should keep the stacked real
    representation from tones_to_baseband on device.
    """
    sps = int(C.SYMBOL_PERIOD_S * fs)
    tones = encode_tones(jnp.asarray(payload))
    ri = np.asarray(tones_to_baseband(tones, sps, float(fs), float(f0),
                                      reference_quirk))
    return ri[..., 0] + 1j * ri[..., 1]


@functools.partial(jax.jit, static_argnames=("sps", "fs", "f0", "fc",
                                             "reference_quirk"))
def tones_to_passband(tones: jnp.ndarray, sps: int, fs: float, f0: float,
                      fc: float,
                      reference_quirk: bool = False) -> jnp.ndarray:
    """Real passband waveform: Re{baseband * exp(j 2 pi fc t)}.

    The carrier phase is linear in frequency, so mixing to fc is identical to
    generating the baseband at carrier f0 + fc — which keeps the whole phase
    inside the float32-safe hierarchical accumulator instead of forming the
    unbounded 2*pi*fc*n/fs product.  (reference: modulator.py:85-90)
    """
    return jnp.real(_baseband_complex(tones, sps, fs, f0 + fc,
                                      reference_quirk))


def ft8_passband(payload, fs: float, f0: float, fc: float,
                 reference_quirk: bool = False) -> np.ndarray:
    """(..., 10) payload bytes -> host numpy float32 passband transmission."""
    sps = int(C.SYMBOL_PERIOD_S * fs)
    tones = encode_tones(jnp.asarray(payload))
    return np.asarray(tones_to_passband(tones, sps, float(fs), float(f0),
                                        float(fc), reference_quirk))
