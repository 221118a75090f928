"""FT8 encode path: payload bytes -> CRC -> LDPC codeword -> 79 tone ids.

Vectorised design: the whole bit pipeline is linear over GF(2), so encode is a
single f32 matmul against a (174, 77) constant matrix followed by a mod-2 and
a Gray-map gather.  Everything is batch-first and vmap/jit friendly; there are
no per-bit Python loops (contrast the reference's bit-serial chain,
src/ft8_tools/ft8_generator/crc.py:9 / ldpc.py:104 / encoder.py:15).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import constants as C

__all__ = [
    "payload_to_bits",
    "bits_to_payload",
    "crc14",
    "encode_codeword",
    "codeword_to_tones",
    "frame_tones",
    "encode_tones",
    "crc_generator",
    "check_crc",
]

_ENCODE_MATRIX_T = jnp.asarray(C.ENCODE_MATRIX.T, dtype=jnp.float32)  # (77, 174)
_CRC_MATRIX_77_T = jnp.asarray(C.CRC_MATRIX_77.T, dtype=jnp.float32)  # (77, 14)
_GRAY_MAP = jnp.asarray(C.GRAY_MAP)
_BIT_WEIGHTS_MSB = jnp.asarray(2 ** np.arange(7, -1, -1), dtype=jnp.int32)
_CRC_WEIGHTS = jnp.asarray(2 ** np.arange(C.CRC_BITS - 1, -1, -1), dtype=jnp.int32)


def payload_to_bits(payload: jnp.ndarray) -> jnp.ndarray:
    """(..., 10) uint8 payload bytes -> (..., 77) 0/1 bits, MSB first.

    The low 3 bits of byte 9 are outside the 77-bit payload and are ignored.
    """
    payload = payload.astype(jnp.int32)
    bits = (payload[..., :, None] >> jnp.arange(7, -1, -1)) & 1
    bits = bits.reshape(*payload.shape[:-1], 80)
    return bits[..., : C.PAYLOAD_BITS]


def bits_to_payload(bits77: jnp.ndarray) -> jnp.ndarray:
    """(..., 77) bits -> (..., 10) uint8 bytes, MSB first, 3 zero pad bits."""
    pad = jnp.zeros((*bits77.shape[:-1], 3), dtype=bits77.dtype)
    bits80 = jnp.concatenate([bits77, pad], axis=-1)
    groups = bits80.reshape(*bits77.shape[:-1], 10, 8).astype(jnp.int32)
    return jnp.sum(groups * _BIT_WEIGHTS_MSB, axis=-1).astype(jnp.uint8)


def crc14(bits77: jnp.ndarray) -> jnp.ndarray:
    """CRC-14 of the 77-bit payload (computed over 82 bits incl. 5 zeros).

    Returns the checksum as a scalar int32 (batched over leading dims).
    """
    crc_bits = jnp.mod(
        jnp.matmul(bits77.astype(jnp.float32), _CRC_MATRIX_77_T,
                   precision=jax.lax.Precision.HIGHEST), 2.0
    ).astype(jnp.int32)
    return jnp.sum(crc_bits * _CRC_WEIGHTS, axis=-1)


def encode_codeword(bits77: jnp.ndarray) -> jnp.ndarray:
    """(..., 77) payload bits -> (..., 174) codeword bits.

    codeword = [payload77 | crc14 | parity83], one GF(2) matmul.
    """
    # HIGHEST precision: GF(2) accumulation must be integer-exact; the
    # default lowering routes f32 matmuls through bf16.
    cw = jnp.matmul(bits77.astype(jnp.float32), _ENCODE_MATRIX_T,
                    precision=jax.lax.Precision.HIGHEST)
    return jnp.mod(cw, 2.0).astype(jnp.int32)


def codeword_to_tones(codeword: jnp.ndarray) -> jnp.ndarray:
    """(..., 174) codeword bits -> (..., 58) Gray-coded 8-FSK tone ids."""
    groups = codeword.reshape(*codeword.shape[:-1], C.NUM_DATA_SYMBOLS, 3)
    vals = groups[..., 0] * 4 + groups[..., 1] * 2 + groups[..., 2]
    return _GRAY_MAP[vals]


def frame_tones(data_tones: jnp.ndarray) -> jnp.ndarray:
    """(..., 58) data tones -> (..., 79) frame with 3 Costas blocks."""
    costas = jnp.asarray(C.FRAME_COSTAS_TONE)
    data_idx = jnp.asarray(np.maximum(C.FRAME_DATA_INDEX, 0))
    is_costas = jnp.asarray(C.FRAME_IS_COSTAS)
    gathered = jnp.take(data_tones, data_idx, axis=-1)
    return jnp.where(is_costas, costas, gathered)


def encode_tones(payload: jnp.ndarray) -> jnp.ndarray:
    """(..., 10) payload bytes -> (..., 79) tone ids (the full TX symbol map)."""
    return frame_tones(codeword_to_tones(encode_codeword(payload_to_bits(payload))))


# -- reference-API compatibility helpers (host friendly) ---------------------

def crc_generator(payload: np.ndarray) -> np.ndarray:
    """payload 10 bytes -> a91 12 bytes = payload77 | crc14 | 5 pad zeros.

    Mirrors the reference API (src/ft8_tools/ft8_generator/crc.py:25).
    """
    bits77 = C.bytes_to_bits(np.asarray(payload, dtype=np.uint8), C.PAYLOAD_BITS)
    crc = (C.CRC_MATRIX_77 @ bits77) % 2
    bits96 = np.zeros(96, dtype=np.uint8)
    bits96[: C.PAYLOAD_BITS] = bits77
    bits96[C.PAYLOAD_BITS: C.LDPC_K] = crc
    return C.bits_to_bytes(bits96)


def check_crc(a91: np.ndarray) -> bool:
    """True iff the CRC embedded in a91 matches the payload's CRC."""
    bits = C.bytes_to_bits(np.asarray(a91, dtype=np.uint8), C.LDPC_K)
    crc = (C.CRC_MATRIX_77 @ bits[: C.PAYLOAD_BITS]) % 2
    return bool((crc == bits[C.PAYLOAD_BITS: C.LDPC_K]).all())
