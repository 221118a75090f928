"""Drop-in compatibility layer for users of the reference package.

Mirrors the reference `ft8_tools` API names, signatures and return shapes
(src/ft8_tools/ft8_generator/__init__.py:7, ft8_demodulator/ft8_decode.py,
ldpc_decoder.py, spectrogram_analyse.py) on top of the JAX
implementation, so existing scripts can switch with an import change:

    from ft8_demodulator_tpu import compat as ft8_tools

Numpy in, numpy out; no device types leak through this layer.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from .beacon.drift import correct_frequency_drift, detect_signal_continuity
from .demod.decode import decode_ft8_message as _decode
from .demod.types import FT8Decode, FT8DecodeStatus, FT8Message
from .ops.gfsk import ft8_baseband as _baseband, ft8_passband as _passband, \
    gauss_window as _gauss_window
from .ops.ldpc_decode import bp_decode as _bp_decode, ldpc_check as _ldpc_check
from .ops.waterfall import calculate_spectrogram
from .protocol import constants as C
from .protocol.encode import check_crc, crc_generator, encode_tones, \
    frame_tones

__all__ = [
    # ft8_generator surface (ft8_generator/__init__.py:7)
    "calc_crc", "crc_generator", "get_crc_from_a91", "check_crc",
    "ldpc_generator", "symbolIdSequence_generator", "itones_generator",
    "ft8_encode", "gauss_window_generator",
    "gfsk_modulation_waveform_generator",
    "ft8_modulation_waveform_generator", "ft8_baseband_generator",
    "ft8_generator",
    # ft8_demodulator surface
    "calculate_spectrogram", "select_frequency_band", "decode_ft8_message",
    "bp_decode", "ldpc_check", "compute_crc", "extract_crc", "add_crc",
    "FT8Message", "FT8DecodeStatus",
    # ft8_beacon_receiver surface
    "correct_frequency_drift", "detect_signal_continuity",
]


def calc_crc(msg: np.ndarray, num_bits: int) -> np.uint16:
    """CRC-14 over num_bits of packed bytes, MSB first
    (reference: src/ft8_tools/ft8_generator/crc.py:9).

    Like the classic byte-feeding shift register (and the reference), a
    whole byte is absorbed every 8 steps — so bits of the final byte past
    num_bits do influence the checksum; callers zero them (as the
    reference's own call sites do) for the protocol CRC.
    """
    msg = np.asarray(msg, np.uint8)
    remainder = 0
    idx_byte = 0
    for idx_bit in range(num_bits):
        if idx_bit % 8 == 0:
            remainder ^= int(msg[idx_byte]) << (C.CRC_BITS - 8)
            idx_byte += 1
        if remainder & (1 << (C.CRC_BITS - 1)):
            remainder = (remainder << 1) ^ C.CRC_POLY
        else:
            remainder <<= 1
    return np.uint16(remainder & ((1 << C.CRC_BITS) - 1))


# demodulator-side alias (src/ft8_tools/ft8_demodulator/crc.py:11)
def compute_crc(msg, num_bits: int) -> int:
    """(reference: src/ft8_tools/ft8_demodulator/crc.py:11)"""
    return int(calc_crc(np.asarray(bytearray(msg) if isinstance(
        msg, (bytes, bytearray)) else msg, np.uint8), num_bits))


def get_crc_from_a91(a91_12bytes) -> np.uint16:
    """Extract the embedded CRC-14 from an a91 message
    (reference: src/ft8_tools/ft8_generator/crc.py:49)."""
    a = np.asarray(bytearray(a91_12bytes) if isinstance(a91_12bytes, (bytes, bytearray))
                   else a91_12bytes, np.uint8)
    return np.uint16(((int(a[9]) & 0x07) << 11) | (int(a[10]) << 3)
                     | (int(a[11]) >> 5))


def extract_crc(a91) -> int:
    """(reference: src/ft8_tools/ft8_demodulator/crc.py:41)"""
    return int(get_crc_from_a91(a91))


def add_crc(payload, a91) -> None:
    """Fill a91 (12-byte buffer) with payload + CRC-14, in place
    (reference: src/ft8_tools/ft8_demodulator/crc.py:56)."""
    out = crc_generator(np.asarray(bytearray(payload), np.uint8))
    for i in range(12):
        a91[i] = int(out[i])


def symbolIdSequence_generator(codeword: np.ndarray) -> np.ndarray:
    """174-bit codeword (22 packed bytes) -> 58 Gray-coded tone ids
    (reference: src/ft8_tools/ft8_generator/encoder.py:15)."""
    bits = C.bytes_to_bits(np.asarray(codeword, np.uint8), C.LDPC_N)
    vals = bits.reshape(C.NUM_DATA_SYMBOLS, 3) @ np.array([4, 2, 1])
    return C.GRAY_MAP[vals].astype(np.uint8)


def itones_generator(symbol_id_sequence: np.ndarray) -> np.ndarray:
    """58 data tone ids -> 79-symbol Costas-framed sequence
    (reference: src/ft8_tools/ft8_generator/encoder.py:41)."""
    return np.asarray(frame_tones(
        jnp.asarray(np.asarray(symbol_id_sequence, np.uint8)))).astype(np.uint8)


def gauss_window_generator(bt: float, t: np.ndarray) -> np.ndarray:
    """(reference: src/ft8_tools/ft8_generator/modulator.py:20)"""
    return np.asarray(_gauss_window(bt, jnp.asarray(np.asarray(t, np.float32))))


def gfsk_modulation_waveform_generator(itones: np.ndarray,
                                       fs: float) -> np.ndarray:
    """79 tone ids -> Gaussian-smoothed frequency track in Hz, laid out as
    the reference's (79+2)*sps array with one symbol of pulse spill on each
    side (reference: src/ft8_tools/ft8_generator/modulator.py:27).

    Built as a 3-segment blend of the Gaussian pulse over the tone
    sequence extended by its edge values (positions -1 and 79).
    """
    itones = np.asarray(itones, np.float64)
    sps = int(C.SYMBOL_PERIOD_S * fs)
    t = (np.arange(3 * sps, dtype=np.float64) - 1.5 * sps) / sps
    k = np.pi * np.sqrt(2.0 / np.log(2.0))
    from scipy.special import erf
    w = 0.5 * (erf(k * 2.0 * (t + 0.5)) - erf(k * 2.0 * (t - 0.5)))
    w0, w1, w2 = w.reshape(3, sps)
    n_sym = itones.shape[0]
    # tones at symbol positions -1..79 (edges extended), zero-padded
    tex = np.concatenate([[0.0, itones[0]], itones, [itones[-1], 0.0]])
    slots = (tex[2:, None] * w0 + tex[1:-1, None] * w1 + tex[:-2, None] * w2)
    return (C.TONE_SPACING_HZ * slots.reshape((n_sym + 2) * sps))


def ft8_modulation_waveform_generator(gfsk_waveform: np.ndarray, fs: float,
                                      f0: float) -> np.ndarray:
    """Frequency track (Hz) -> phase-continuous complex baseband with
    raised-cosine edge ramps (reference: modulator.py:56).  Integrates the
    first 79*sps track samples exactly as the reference does."""
    sps = int(C.SYMBOL_PERIOD_S * fs)
    n = C.NUM_SYMBOLS * sps
    dphi = 2.0 * np.pi * (np.asarray(gfsk_waveform[:n], np.float64) + f0) / fs
    phi = np.concatenate([[0.0], np.cumsum(dphi)[:-1]])
    wave = np.sin(phi) - 1j * np.cos(phi)
    nramp = sps // 8
    i = np.arange(nramp, dtype=np.float64)
    wave[:nramp] *= 0.5 * (1.0 - np.cos(8.0 * np.pi * i / sps))
    wave[n - nramp:] *= (0.5 * (1.0 + np.cos(8.0 * np.pi * i / sps)))[::-1]
    return wave


def ldpc_generator(a91_12bytes: np.ndarray) -> np.ndarray:
    """a91 (12 bytes) -> 174-bit codeword packed into 22 bytes.

    (reference: src/ft8_tools/ft8_generator/ldpc.py:104)
    """
    bits91 = C.bytes_to_bits(np.asarray(a91_12bytes, np.uint8), C.LDPC_K)
    parity = (C.LDPC_GENERATOR @ bits91) % 2
    bits = np.concatenate([bits91, parity]).astype(np.uint8)
    return C.bits_to_bytes(bits)


def ft8_encode(payload: np.ndarray) -> np.ndarray:
    """payload (10 bytes) -> 79 tone ids
    (reference: src/ft8_tools/ft8_generator/encoder.py:64)."""
    return np.asarray(encode_tones(jnp.asarray(np.asarray(payload, np.uint8))))


def ft8_baseband_generator(payload: np.ndarray, fs: float,
                           f0: float) -> np.ndarray:
    """Complex baseband FT8 transmission, bit-parity with the reference —
    INCLUDING its one-symbol GFSK delay / truncated final Costas symbol
    (ops/gfsk.py module docstring; the native API emits the corrected
    WSJT-X alignment instead).
    (reference: src/ft8_tools/ft8_generator/modulator.py:77)."""
    return _baseband(np.asarray(payload, np.uint8), fs, f0,
                     reference_quirk=True)


def ft8_generator(payload: np.ndarray, fs: float, f0: float,
                  fc: float) -> np.ndarray:
    """Real passband FT8 transmission, bit-parity with the reference
    (including its GFSK timing quirk; see ft8_baseband_generator)
    (reference: src/ft8_tools/ft8_generator/modulator.py:85)."""
    return _passband(np.asarray(payload, np.uint8), fs, f0, fc,
                     reference_quirk=True)


def select_frequency_band(spectrogram: np.ndarray, f: np.ndarray,
                          f_min: float, f_max: float):
    """(reference: src/ft8_tools/ft8_demodulator/spectrogram_analyse.py:68)"""
    mask = (f >= f_min) & (f <= f_max)
    return spectrogram[mask], f[mask]


def bp_decode(codeword_llrs: np.ndarray, max_iterations: int):
    """(174,) LLRs -> (plain bits ndarray, errors int)
    (reference: src/ft8_tools/ft8_demodulator/ldpc_decoder.py:54)."""
    plain, errors = _bp_decode(
        jnp.asarray(np.asarray(codeword_llrs, np.float32)), max_iterations)
    return np.asarray(plain).astype(np.uint8), int(errors)


def ldpc_check(codeword: np.ndarray) -> int:
    """(174,) hard bits -> failed-parity count
    (reference: src/ft8_tools/ft8_demodulator/ldpc_decoder.py:33)."""
    return int(_ldpc_check(jnp.asarray(np.asarray(codeword, np.int32))))


def decode_ft8_message(wave_data, sample_rate, bins_per_tone: int = 2,
                       steps_per_symbol: int = 2, max_candidates: int = 20,
                       min_score: float = 10, max_iterations: int = 20,
                       freq_min=None, freq_max=None, time_min=None,
                       time_max=None):
    """Reference-shaped results: list of (FT8Message, FT8DecodeStatus,
    time_sec, freq_hz, score) tuples, one row per surviving candidate
    (duplicates preserved, like ft8_decode.py:384-391).  Message payloads
    are mutable bytearrays as in the reference."""
    rows = _decode(wave_data, sample_rate, bins_per_tone=bins_per_tone,
                   steps_per_symbol=steps_per_symbol,
                   max_candidates=max_candidates, min_score=min_score,
                   max_iterations=max_iterations, freq_min=freq_min,
                   freq_max=freq_max, time_min=time_min, time_max=time_max,
                   deduplicate=False)
    out = []
    for r in rows:
        msg = FT8Message(payload=bytearray(r.message.payload),
                         hash=r.message.hash)
        out.append((msg, r.status, r.time_sec, r.freq_hz, r.score))
    return out
