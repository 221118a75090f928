"""FT8 protocol constants and derived lookup tables.

Everything here is **host-side NumPy**, computed once at import time.  The
decode/encode kernels pull these tables in as constant device arrays, so the
GF(2) algebra (CRC, LDPC encode) becomes plain matrix multiplies
instead of the reference's bit-serial Python loops
(reference: src/ft8_tools/ft8_generator/crc.py:9, ldpc.py:104).

Conventions:
* Bit vectors are MSB-first within a byte, matching the over-the-air order.
* LDPC adjacency is 0-based here (the protocol tables are published 1-based).
"""

from __future__ import annotations

import numpy as np

from ._ldpc_data import LDPC_CHECK_ADJACENCY, LDPC_GENERATOR_HEX

# ---------------------------------------------------------------------------
# Scalar protocol constants ("The FT4 and FT8 Communication Protocols")
# ---------------------------------------------------------------------------

PAYLOAD_BITS = 77            # information bits per message
CRC_BITS = 14                # CRC-14 appended after the payload
CRC_POLY = 0x2757            # CRC-14 polynomial, leading 1 implicit
CRC_MESSAGE_BITS = 82        # CRC is computed over payload(77) + 5 zero bits
LDPC_N = 174                 # codeword length
LDPC_K = 91                  # message length (payload 77 + CRC 14)
LDPC_M = LDPC_N - LDPC_K     # 83 parity checks
PAYLOAD_BYTES = 10
A91_BYTES = 12               # 91 bits packed MSB-first (5 trailing pad bits)
CODEWORD_BYTES = 22          # 174 bits packed MSB-first

BITS_PER_TONE = 3            # 8-FSK
NUM_DATA_SYMBOLS = LDPC_N // BITS_PER_TONE   # 58
COSTAS_LEN = 7
NUM_COSTAS_SEQS = 3
NUM_SYMBOLS = NUM_DATA_SYMBOLS + NUM_COSTAS_SEQS * COSTAS_LEN  # 79
SYNC_SEQ_STRIDE = 36         # symbol offset between consecutive Costas blocks

SYMBOL_PERIOD_S = 0.16       # FT8 symbol duration
TONE_SPACING_HZ = 6.25       # FT8 tone spacing
SLOT_PERIOD_S = 15.0         # one FT8 transmit/receive slot

GRAY_MAP = np.array([0, 1, 3, 2, 5, 6, 4, 7], dtype=np.int32)
GRAY_INV = np.argsort(GRAY_MAP).astype(np.int32)  # tone -> 3-bit group value
COSTAS_PATTERN = np.array([3, 1, 4, 0, 6, 5, 2], dtype=np.int32)

# Symbol index of data symbol k inside the 79-symbol frame: the first 29 data
# symbols sit after Costas #1, the remaining 29 after Costas #2
# (reference: src/ft8_tools/ft8_demodulator/ft8_decode.py:173).
DATA_SYMBOL_POSITIONS = np.array(
    [k + (7 if k < 29 else 14) for k in range(NUM_DATA_SYMBOLS)], dtype=np.int32
)


# ---------------------------------------------------------------------------
# Packed-bit helpers (host side)
# ---------------------------------------------------------------------------

def bytes_to_bits(data: np.ndarray, num_bits: int) -> np.ndarray:
    """Unpack uint8 array (MSB first) into a 0/1 uint8 vector of num_bits."""
    data = np.asarray(data, dtype=np.uint8)
    return np.unpackbits(data)[:num_bits]


def bits_to_bytes(bits: np.ndarray) -> np.ndarray:
    """Pack a 0/1 vector MSB-first into bytes (zero-padded to a byte edge)."""
    bits = np.asarray(bits, dtype=np.uint8)
    return np.packbits(bits)


# ---------------------------------------------------------------------------
# LDPC tables
# ---------------------------------------------------------------------------

def _build_generator_bits() -> np.ndarray:
    """(83, 91) GF(2) generator: parity = G @ message91 mod 2."""
    rows = [bytes_to_bits(np.frombuffer(bytes.fromhex(h), dtype=np.uint8), LDPC_K)
            for h in LDPC_GENERATOR_HEX]
    return np.stack(rows).astype(np.uint8)


LDPC_GENERATOR = _build_generator_bits()

# Check-node adjacency, 0-based, padded to width 7 with -1.
CHECK_MAX_DEG = max(len(r) for r in LDPC_CHECK_ADJACENCY)  # 7
CHECK_DEG = np.array([len(r) for r in LDPC_CHECK_ADJACENCY], dtype=np.int32)
CHECK_ADJ = np.full((LDPC_M, CHECK_MAX_DEG), -1, dtype=np.int32)
for _m, _row in enumerate(LDPC_CHECK_ADJACENCY):
    CHECK_ADJ[_m, : len(_row)] = np.array(_row, dtype=np.int32) - 1
CHECK_MASK = CHECK_ADJ >= 0

# Variable-node adjacency (each bit participates in exactly 3 checks), derived
# by scanning checks in order — this reproduces the published Mn table exactly.
VAR_MAX_DEG = 3
VAR_ADJ = np.full((LDPC_N, VAR_MAX_DEG), -1, dtype=np.int32)
_var_fill = np.zeros(LDPC_N, dtype=np.int32)
for _m in range(LDPC_M):
    for _i in range(CHECK_DEG[_m]):
        _n = CHECK_ADJ[_m, _i]
        VAR_ADJ[_n, _var_fill[_n]] = _m
        _var_fill[_n] += 1
assert (_var_fill == VAR_MAX_DEG).all(), "every bit must belong to 3 checks"

# Cross-position tables used by the vectorised belief-propagation kernel:
#   CHECK_SLOT_IN_VAR[m, i] = j  such that VAR_ADJ[CHECK_ADJ[m, i], j] == m
#   VAR_SLOT_IN_CHECK[n, j] = i  such that CHECK_ADJ[VAR_ADJ[n, j], i] == n
CHECK_SLOT_IN_VAR = np.zeros((LDPC_M, CHECK_MAX_DEG), dtype=np.int32)
for _m in range(LDPC_M):
    for _i in range(CHECK_DEG[_m]):
        _n = CHECK_ADJ[_m, _i]
        CHECK_SLOT_IN_VAR[_m, _i] = int(np.where(VAR_ADJ[_n] == _m)[0][0])
VAR_SLOT_IN_CHECK = np.zeros((LDPC_N, VAR_MAX_DEG), dtype=np.int32)
for _n in range(LDPC_N):
    for _j in range(VAR_MAX_DEG):
        _m = VAR_ADJ[_n, _j]
        VAR_SLOT_IN_CHECK[_n, _j] = int(np.where(CHECK_ADJ[_m] == _n)[0][0])

# Dense parity-check matrix (83, 174) for one-matmul syndrome computation.
PARITY_CHECK = np.zeros((LDPC_M, LDPC_N), dtype=np.uint8)
for _m in range(LDPC_M):
    PARITY_CHECK[_m, CHECK_ADJ[_m, CHECK_MASK[_m]]] = 1


# ---------------------------------------------------------------------------
# CRC-14 as a GF(2) matrix
# ---------------------------------------------------------------------------

def _crc14_bitserial(bits: np.ndarray) -> int:
    """Bit-serial CRC-14 over an MSB-first bit vector (byte-block feed).

    The FT8 CRC shifts whole bytes into the remainder every 8 bits, exactly as
    the classic Barr Group table-less C routine does (and as the reference's
    compute_crc, src/ft8_tools/ft8_demodulator/crc.py:11).  Only used here to
    derive the linear-map matrix below.
    """
    num_bits = len(bits)
    padded = np.zeros(((num_bits + 7) // 8) * 8, dtype=np.uint8)
    padded[:num_bits] = bits
    remainder = 0
    for idx_bit in range(num_bits):
        if idx_bit % 8 == 0:
            byte = 0
            for b in padded[idx_bit: idx_bit + 8]:
                byte = (byte << 1) | int(b)
            remainder ^= byte << (CRC_BITS - 8)
        if remainder & (1 << (CRC_BITS - 1)):
            remainder = (remainder << 1) ^ CRC_POLY
        else:
            remainder <<= 1
    return remainder & ((1 << CRC_BITS) - 1)


def _build_crc_matrix() -> np.ndarray:
    """(14, 82) matrix M with crc_bits = M @ message_bits mod 2 (MSB first).

    CRC-14 with zero initial remainder is linear over GF(2), so the checksum
    of any 82-bit message is the XOR of the checksums of its unit vectors.
    """
    mat = np.zeros((CRC_BITS, CRC_MESSAGE_BITS), dtype=np.uint8)
    for i in range(CRC_MESSAGE_BITS):
        unit = np.zeros(CRC_MESSAGE_BITS, dtype=np.uint8)
        unit[i] = 1
        crc = _crc14_bitserial(unit)
        for b in range(CRC_BITS):
            mat[b, i] = (crc >> (CRC_BITS - 1 - b)) & 1
    return mat


CRC_MATRIX = _build_crc_matrix()           # (14, 82)
CRC_MATRIX_77 = CRC_MATRIX[:, :PAYLOAD_BITS]  # bits 77..81 are always zero


# ---------------------------------------------------------------------------
# Full linear encoder: payload77 -> codeword174 in one GF(2) matmul
# ---------------------------------------------------------------------------

def _build_encode_matrix() -> np.ndarray:
    """(174, 77) matrix E with codeword = E @ payload77 mod 2.

    codeword = [payload77 | crc14 | parity83]; crc is linear in the payload and
    the parity is linear in [payload | crc], so the whole encode composes into
    a single matrix.  This collapses the reference's three-stage bit-serial
    encode (crc.py:25 -> ldpc.py:104 -> encoder.py:15) into one matmul.
    """
    enc = np.zeros((LDPC_N, PAYLOAD_BITS), dtype=np.uint8)
    enc[:PAYLOAD_BITS] = np.eye(PAYLOAD_BITS, dtype=np.uint8)
    enc[PAYLOAD_BITS: LDPC_K] = CRC_MATRIX_77
    # message91 = [payload77 | crc14]  ->  parity = G @ message91
    g_payload = LDPC_GENERATOR[:, :PAYLOAD_BITS]
    g_crc = LDPC_GENERATOR[:, PAYLOAD_BITS:LDPC_K]
    enc[LDPC_K:] = (g_payload + g_crc @ CRC_MATRIX_77) % 2
    return enc


ENCODE_MATRIX = _build_encode_matrix()


# ---------------------------------------------------------------------------
# Tone framing tables
# ---------------------------------------------------------------------------

# itones[s] for s in 0..78: Costas / data interleave
# [C7 | D29 | C7 | D29 | C7] (reference: src/ft8_tools/ft8_generator/encoder.py:41)
FRAME_IS_COSTAS = np.zeros(NUM_SYMBOLS, dtype=bool)
FRAME_COSTAS_TONE = np.zeros(NUM_SYMBOLS, dtype=np.int32)
FRAME_DATA_INDEX = np.full(NUM_SYMBOLS, -1, dtype=np.int32)
for _s in range(NUM_SYMBOLS):
    if _s < 7:
        FRAME_IS_COSTAS[_s] = True
        FRAME_COSTAS_TONE[_s] = COSTAS_PATTERN[_s]
    elif _s < 36:
        FRAME_DATA_INDEX[_s] = _s - 7
    elif _s < 43:
        FRAME_IS_COSTAS[_s] = True
        FRAME_COSTAS_TONE[_s] = COSTAS_PATTERN[_s - 36]
    elif _s < 72:
        FRAME_DATA_INDEX[_s] = _s - 14
    else:
        FRAME_IS_COSTAS[_s] = True
        FRAME_COSTAS_TONE[_s] = COSTAS_PATTERN[_s - 72]
assert (FRAME_DATA_INDEX >= 0).sum() == NUM_DATA_SYMBOLS
