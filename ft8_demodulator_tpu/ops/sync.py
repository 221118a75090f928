"""Costas sync scoring and candidate search as a batched stencil.

The reference scores each (time, freq) grid point with a Python loop over the
21 Costas cells and up to 4 neighbour contrasts per cell — ~1.7e5 score
evaluations ~ 1.4e7 interpreted array reads per 15 s slot
(src/ft8_tools/ft8_demodulator/ft8_decode.py:47-149).  Here the same
arithmetic is one fused stencil: each of the <=84 (cell, comparison) terms is
a statically-offset 2-D slice of the padded waterfall, so the whole score
grid materialises in a handful of vector adds, and candidate selection is a
single jax.lax.top_k.  Semantics (boundary-dependent comparison counts, the
pre-roll search window of 10 symbols, the score = sum/num_comparisons
normalisation) match the reference exactly.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..protocol import constants as C
from ..utils.backend import knob

__all__ = ["SearchGrid", "search_grid", "sync_scores", "sync_scores_tf",
           "sync_scores_z", "find_candidates", "find_candidates_tf"]

# The reference scans start times from 10 symbols before the slot up to
# num_blocks - 59 symbols (ft8_decode.py:108).
PRE_ROLL_SYMBOLS = 10
_MIN_TAIL_SYMBOLS = C.NUM_DATA_SYMBOLS + 1  # 59


class SearchGrid(NamedTuple):
    """Static geometry of the candidate search over one waterfall."""

    time_osr: int
    freq_osr: int
    num_blocks: int
    t_start: int        # first abs_time scanned (negative: pre-roll)
    num_times: int      # abs_time values scanned
    num_freqs: int      # abs_freq values scanned


def search_grid(num_freq_bins: int, num_frames: int, time_osr: int,
                freq_osr: int) -> SearchGrid:
    num_blocks = num_frames // time_osr
    t_start = -PRE_ROLL_SYMBOLS * time_osr
    t_stop = num_blocks * time_osr - _MIN_TAIL_SYMBOLS * time_osr
    num_times = max(0, t_stop - t_start)
    num_freqs = max(0, num_freq_bins - 7 * freq_osr)
    return SearchGrid(time_osr, freq_osr, num_blocks, t_start,
                      num_times, num_freqs)


def _cell_masks(g: SearchGrid) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-(cell, t) validity masks, shape (21, num_times) each (host consts).

    The masks only depend on base = floor(abs_time / time_osr), never on
    frequency, so they are cheap constants.
    """
    t = g.t_start + np.arange(g.num_times)
    base = np.floor_divide(t, g.time_osr)
    cell = np.zeros((C.NUM_COSTAS_SEQS * C.COSTAS_LEN, g.num_times), bool)
    prev = np.zeros_like(cell)
    nxt = np.zeros_like(cell)
    for m in range(C.NUM_COSTAS_SEQS):
        for k in range(C.COSTAS_LEN):
            i = m * C.COSTAS_LEN + k
            b = m * C.SYNC_SEQ_STRIDE + k
            ba = base + b
            cell[i] = (ba >= 0) & (ba < g.num_blocks)
            if k > 0:
                prev[i] = cell[i] & (ba > 0)
            if k < C.COSTAS_LEN - 1:
                nxt[i] = cell[i] & (ba + 1 < g.num_blocks)
    return cell, prev, nxt


@functools.partial(jax.jit, static_argnames=("g",))
def sync_scores(mag: jnp.ndarray, g: SearchGrid) -> jnp.ndarray:
    """Waterfall (F, T) -> sync score grid (num_freqs, num_times).

    score(t, f) = mean over valid comparisons of
    [power(costas cell) - power(neighbour cell)]; -inf where no comparison
    is in bounds (reference ft8_sync_score, ft8_decode.py:47-100).

    Pre-roll grids (t_start < 0) whose t >= 0 columns need NO right
    padding (the streaming case: the extended view covers a full frame
    past the block) are computed as two pieces: the pre-roll columns on a
    small leading slice of the waterfall (whose left-pad copy is tiny)
    and the main columns against the completely unpadded waterfall —
    left-padding the FULL grid instead measured a 10-19 % throughput loss
    on the streaming bank (the pad copy materialises the whole grid and
    breaks the producer fusion).  When the main part would need a right
    pad anyway (the single-slot decoder's tail scan), the single padded
    grid measured faster than split + concat — keep it.  Scores are
    bit-identical either way.
    """
    main_cols = g.num_times + g.t_start
    main_right_pad = main_cols + (C.NUM_SYMBOLS - 1) * g.time_osr \
        - mag.shape[-1]
    if g.t_start < 0 and main_cols > 0 and main_right_pad <= 0:
        w_pre = min(mag.shape[-1], (C.NUM_SYMBOLS - 1) * g.time_osr)
        pre_g = SearchGrid(g.time_osr, g.freq_osr, g.num_blocks,
                           g.t_start, -g.t_start, g.num_freqs)
        main_g = SearchGrid(g.time_osr, g.freq_osr, g.num_blocks,
                            0, main_cols, g.num_freqs)
        pre = _sync_scores_impl(mag[..., :w_pre], pre_g)
        main = _sync_scores_impl(mag, main_g)
        return jnp.concatenate([pre, main], axis=-1)
    return _sync_scores_impl(mag, g)


# Stencil read dtype — float32.  A bfloat16 grid halves the stencil's
# memory traffic and left decode masks identical at -20/-21/-22 dB
# (512 slots each) on an earlier platform, where it was nevertheless
# slower (the cast materialises an extra copy).  Kept as a knob for
# re-testing on the GPU.
_SYNC_DTYPE = {
    "bfloat16": jnp.bfloat16,
    "float32": jnp.float32,
}[__import__("os").environ.get("FT8_SYNC_DTYPE", "float32").lower()]


def _sync_scores_impl(mag: jnp.ndarray, g: SearchGrid) -> jnp.ndarray:
    tau, phi = g.time_osr, g.freq_osr
    num_frames = mag.shape[-1]
    # pad exactly enough that every statically-offset slice is in bounds;
    # validity masks zero out the contributions that fall in the padding
    left = max(0, -g.t_start)
    right = max(0, g.t_start + g.num_times
                + (C.NUM_SYMBOLS - 1) * tau - num_frames)
    padded = jnp.pad(mag, ((0, 0), (left, right))).astype(_SYNC_DTYPE)

    def cell_power(b: int, tone: int) -> jnp.ndarray:
        start = left + g.t_start + b * tau
        return jax.lax.dynamic_slice(
            padded, (tone * phi, start), (g.num_freqs, g.num_times)
        ).astype(jnp.float32)

    cell_m, prev_m, next_m = _cell_masks(g)
    total = jnp.zeros((g.num_freqs, g.num_times), jnp.float32)
    count = jnp.zeros((g.num_times,), jnp.float32)

    for m in range(C.NUM_COSTAS_SEQS):
        for k in range(C.COSTAS_LEN):
            i = m * C.COSTAS_LEN + k
            b = m * C.SYNC_SEQ_STRIDE + k
            tone = int(C.COSTAS_PATTERN[k])
            cm = jnp.asarray(cell_m[i], jnp.float32)
            cur = cell_power(b, tone)

            freq_contrib = jnp.zeros_like(cur)
            n_freq = 0
            if tone > 0:
                freq_contrib += cur - cell_power(b, tone - 1)
                n_freq += 1
            if tone < 7:
                freq_contrib += cur - cell_power(b, tone + 1)
                n_freq += 1
            total += cm * freq_contrib
            count += cm * float(n_freq)

            if k > 0:
                pm = jnp.asarray(prev_m[i], jnp.float32)
                total += pm * (cur - cell_power(b - 1, tone))
                count += pm
            if k < C.COSTAS_LEN - 1:
                nm = jnp.asarray(next_m[i], jnp.float32)
                total += nm * (cur - cell_power(b + 1, tone))
                count += nm

    return jnp.where(count > 0, total / jnp.maximum(count, 1.0), -jnp.inf)


@functools.partial(jax.jit, static_argnames=("g",))
def sync_scores_tf(mag_tf: jnp.ndarray, g: SearchGrid) -> jnp.ndarray:
    """TIME-MAJOR waterfall (T, F) -> sync score grid (num_times, num_freqs).

    Bit-identical to ``sync_scores(mag_tf.T, g).T`` — the same 84 masked
    terms added in the same order per element — but laid out with FREQUENCY
    as the minor axis.  At the 12 kHz geometry that axis is 1906
    wide (stencil offsets are small shifts along it) where the (F, T)
    orientation's minor axis is only 88-206
    wide, so the (T, F) layout keeps the stencil's shifted slices long
    and contiguous.

    The pre-roll/main split follows sync_scores: left-padding only a small
    leading time slice keeps the main body reading the unpadded grid.

    On the GPU this routes to :func:`sync_scores_tf_mxu` by default
    (stencil folded into per-residue matmuls; same scores up to
    accumulation order — see the matmul-recast comment block below); on
    the CPU the exact stencil stays the default.  The FT8_SYNC_BACKEND
    knob (utils/backend.py) overrides either way.
    """
    if knob("FT8_SYNC_BACKEND") == "mxu" and g.num_times > 0:
        return sync_scores_tf_mxu(mag_tf, g)
    main_cols = g.num_times + g.t_start
    main_right_pad = main_cols + (C.NUM_SYMBOLS - 1) * g.time_osr \
        - mag_tf.shape[-2]
    if g.t_start < 0 and main_cols > 0 and main_right_pad <= 0:
        w_pre = min(mag_tf.shape[-2], (C.NUM_SYMBOLS - 1) * g.time_osr)
        pre_g = SearchGrid(g.time_osr, g.freq_osr, g.num_blocks,
                           g.t_start, -g.t_start, g.num_freqs)
        main_g = SearchGrid(g.time_osr, g.freq_osr, g.num_blocks,
                            0, main_cols, g.num_freqs)
        pre = _sync_scores_tf_impl(mag_tf[..., :w_pre, :], pre_g)
        main = _sync_scores_tf_impl(mag_tf, main_g)
        return jnp.concatenate([pre, main], axis=-2)
    return _sync_scores_tf_impl(mag_tf, g)


def _sync_scores_tf_impl(mag_tf: jnp.ndarray, g: SearchGrid) -> jnp.ndarray:
    tau, phi = g.time_osr, g.freq_osr
    num_frames = mag_tf.shape[-2]
    left = max(0, -g.t_start)
    right = max(0, g.t_start + g.num_times
                + (C.NUM_SYMBOLS - 1) * tau - num_frames)
    padded = jnp.pad(mag_tf, ((left, right), (0, 0))).astype(_SYNC_DTYPE)

    def cell_power(b: int, tone: int) -> jnp.ndarray:
        start = left + g.t_start + b * tau
        return jax.lax.dynamic_slice(
            padded, (start, tone * phi), (g.num_times, g.num_freqs)
        ).astype(jnp.float32)

    cell_m, prev_m, next_m = _cell_masks(g)
    total = jnp.zeros((g.num_times, g.num_freqs), jnp.float32)
    count = jnp.zeros((g.num_times, 1), jnp.float32)

    for m in range(C.NUM_COSTAS_SEQS):
        for k in range(C.COSTAS_LEN):
            i = m * C.COSTAS_LEN + k
            b = m * C.SYNC_SEQ_STRIDE + k
            tone = int(C.COSTAS_PATTERN[k])
            cm = jnp.asarray(cell_m[i], jnp.float32)[:, None]
            cur = cell_power(b, tone)

            freq_contrib = jnp.zeros_like(cur)
            n_freq = 0
            if tone > 0:
                freq_contrib += cur - cell_power(b, tone - 1)
                n_freq += 1
            if tone < 7:
                freq_contrib += cur - cell_power(b, tone + 1)
                n_freq += 1
            total += cm * freq_contrib
            count += cm * float(n_freq)

            if k > 0:
                pm = jnp.asarray(prev_m[i], jnp.float32)[:, None]
                total += pm * (cur - cell_power(b - 1, tone))
                count += pm
            if k < C.COSTAS_LEN - 1:
                nm = jnp.asarray(next_m[i], jnp.float32)[:, None]
                total += nm * (cur - cell_power(b + 1, tone))
                count += nm

    return jnp.where(count > 0, total / jnp.maximum(count, 1.0), -jnp.inf)


# ---------------------------------------------------------------------------
# Matmul recast of the sync stencil (time-major layout)
# ---------------------------------------------------------------------------
# The 84 masked stencil terms are all LINEAR in the grid, and every term's
# time offset (left + t_start + b*tau, b' in {b-1, b, b+1}) shares one
# residue mod tau — so the whole stencil folds into tau banded weight
# matrices per tone offset, stacked into ONE matmul per time residue:
#
#     M_s = W_s @ P_s        W_s: (8*n_out, n_in)   P_s: (n_in, kx)
#     S[s::tau, f] = sum_df M_s[df*n_out + o, f + df*phi]
#
# The dB grid is read ONCE per residue (vs ~84 shifted elementwise
# reads), the masks are baked into W on the host (exact), and the df
# combination is 8 shifted adds fused into the matmul epilogue: ~0.33
# GFLOP/slot of matmul replaces ~0.09 GFLOP/slot of shifted adds.
#
# NOT bit-identical to the stencil (matmul accumulation order and the
# operand rounding of DEFAULT precision — TF32 on the GPU); decode-mask
# equivalence at cliff SNRs is the acceptance evidence
# (benchmarks/precision_masks.py, sync_mxu arm).  The GPU default; the
# CPU default stays the stencil, which is exact f32 there and keeps the
# bit-identical (F, T)/(T, F) parity guarantee the CPU tests pin.  Its
# A/B on the GPU is still open.  Override with the FT8_SYNC_BACKEND knob
# (utils/backend.py); precision via FT8_SYNC_MXU_PRECISION.

_SYNC_MXU_PRECISION = getattr(
    jax.lax.Precision,
    __import__("os").environ.get("FT8_SYNC_MXU_PRECISION",
                                 "default").upper())


@functools.lru_cache(maxsize=None)
def _sync_mxu_weights(g: SearchGrid, num_frames: int):
    """Host-built stencil-as-matmul weights for one static geometry.

    Returns (per-residue list of (W_stack, in_residue, n_out), count,
    left, right).  W_stack[s] is the (8*n_out, n_in) float32 stack of the
    8 tone-offset banded matrices for output rows o = s, s+tau, ...;
    entries replicate the _sync_scores_tf_impl loop exactly (same masks,
    same per-term coefficients), so W @ grid equals the stencil sum in
    exact arithmetic."""
    tau, phi = g.time_osr, g.freq_osr
    left = max(0, -g.t_start)
    right = max(0, g.t_start + g.num_times
                + (C.NUM_SYMBOLS - 1) * tau - num_frames)
    t_pad = left + num_frames + right
    cell_m, prev_m, next_m = _cell_masks(g)

    w = np.zeros((8, g.num_times, t_pad), np.float32)
    count = np.zeros(g.num_times, np.float32)
    o = np.arange(g.num_times)

    def add(df_tone: int, b: int, coeff: np.ndarray) -> None:
        idx = left + g.t_start + b * tau + o
        ok = (idx >= 0) & (idx < t_pad) & (coeff != 0)
        w[df_tone, o[ok], idx[ok]] += coeff[ok]

    for m in range(C.NUM_COSTAS_SEQS):
        for k in range(C.COSTAS_LEN):
            i = m * C.COSTAS_LEN + k
            b = m * C.SYNC_SEQ_STRIDE + k
            tone = int(C.COSTAS_PATTERN[k])
            cm = cell_m[i].astype(np.float32)
            n_freq = 0
            if tone > 0:
                add(tone, b, cm)
                add(tone - 1, b, -cm)
                n_freq += 1
            if tone < 7:
                add(tone, b, cm)
                add(tone + 1, b, -cm)
                n_freq += 1
            count += cm * n_freq
            if k > 0:
                pm = prev_m[i].astype(np.float32)
                add(tone, b, pm)
                add(tone, b - 1, -pm)
                count += pm
            if k < C.COSTAS_LEN - 1:
                nm = next_m[i].astype(np.float32)
                add(tone, b, nm)
                add(tone, b + 1, -nm)
                count += nm

    # every tap shares residue c mod tau -> per-residue compaction is
    # lossless (asserted); output rows s::tau read input rows (s+c)::tau
    c = (left + g.t_start) % tau
    per_residue = []
    for s in range(tau):
        rs = (s + c) % tau
        rows = w[:, s::tau, :]                    # (8, n_out, t_pad)
        drop = np.delete(rows, np.arange(rs, t_pad, tau), axis=2)
        assert not drop.any(), "stencil tap off the expected residue"
        ws = rows[:, :, rs::tau]                  # (8, n_out, n_in)
        n_out = ws.shape[1]
        per_residue.append((ws.reshape(8 * n_out, ws.shape[2]), rs, n_out))
    return per_residue, count, left, right


@functools.partial(jax.jit, static_argnames=("g",))
def sync_scores_tf_mxu(mag_tf: jnp.ndarray, g: SearchGrid) -> jnp.ndarray:
    """TIME-MAJOR waterfall (T, F) -> sync score grid via matmuls.

    Same scores as :func:`sync_scores_tf` up to matmul accumulation order
    (and one bf16 operand pass at DEFAULT precision); see the module
    comment above for the recast and its acceptance evidence."""
    tau, phi = g.time_osr, g.freq_osr
    num_frames = mag_tf.shape[-2]
    per_residue, count, left, right = _sync_mxu_weights(g, num_frames)
    padded = jnp.pad(mag_tf, ((left, right), (0, 0)))

    scores = jnp.zeros((g.num_times, g.num_freqs), jnp.float32)
    for s, (ws, rs, n_out) in enumerate(per_residue):
        if n_out == 0:
            continue
        p_s = padded[rs::tau]                     # (n_in, kx)
        m_s = jnp.matmul(jnp.asarray(ws), p_s,
                         precision=_SYNC_MXU_PRECISION,
                         preferred_element_type=jnp.float32)
        s_s = jnp.zeros((n_out, g.num_freqs), jnp.float32)
        for df in range(8):
            s_s = s_s + jax.lax.dynamic_slice(
                m_s, (df * n_out, df * phi), (n_out, g.num_freqs))
        scores = scores.at[s::tau].set(s_s)

    cnt = jnp.asarray(count, jnp.float32)[:, None]
    return jnp.where(cnt > 0, scores / jnp.maximum(cnt, 1.0), -jnp.inf)


@functools.partial(jax.jit, static_argnames=("g",))
def sync_scores_z(linpow: jnp.ndarray, g: SearchGrid) -> jnp.ndarray:
    """LINEAR power grid (F, T) -> normalised Costas detection z (nF, nT).

    A detection-theoretic alternative to the reference's dB-contrast
    stencil (:func:`sync_scores`), for the repeat-stacked decoder: each of
    the 21 Costas cells contributes its linear on-tone power minus the
    exact 8-tone mean at that symbol, and the sum is normalised to unit
    noise variance (var(P) estimated from the whole grid; each contrast
    has variance (7/8)·var(P) under noise-only, so z ~ N(0, 1) there).
    Same statistic as the known-track detector (beacon/detect.py
    known_track_scores) restricted to the 21 Costas cells every FT8
    transmission shares — no payload knowledge needed.

    Linear-domain contrast preserves the noncoherent stacking gain that
    the dB compression of the classic stencil throws away at low SNR:
    measured exact-truth-cell presence in the top-20 at the stacked
    coherent cliff (fs 2 kHz, off-grid, 50 trials/point) roughly DOUBLES —
    R=4 −22 dB: 0.44 → 0.84, R=8 −25 dB: 0.24 → 0.56 (~+1 dB of search
    depth).  Thresholds on this grid are z-scores (the stacked decoder's
    ``min_z``, default 2.0 — NOT ``min_score``, which gates the R == 1
    dB stencil): z ≈ 2 keeps noise-only cells (z ~ N(0, 1)) out while
    candidate counts stay top-K-bound.

    The single-slot decoder keeps the reference-parity stencil: at its
    cliff a truth-cell oracle shows candidate search is already complete
    (docs/DESIGN_NOTES.md), so z-sync buys nothing there.
    """
    tau, phi = g.time_osr, g.freq_osr
    padded, s8, left = _pad_and_tone_sum(linpow, g)

    cell_m, _, _ = _cell_masks(g)
    total = jnp.zeros((g.num_freqs, g.num_times), jnp.float32)
    count = np.zeros(g.num_times, np.float32)
    for m in range(C.NUM_COSTAS_SEQS):
        for k in range(C.COSTAS_LEN):
            i = m * C.COSTAS_LEN + k
            b = m * C.SYNC_SEQ_STRIDE + k
            tone = int(C.COSTAS_PATTERN[k])
            start = left + g.t_start + b * tau
            on = jax.lax.dynamic_slice(
                padded, (tone * phi, start), (g.num_freqs, g.num_times))
            mean8 = jax.lax.dynamic_slice_in_dim(
                s8, start, g.num_times, axis=-1) * 0.125
            total = total + jnp.asarray(cell_m[i], jnp.float32) \
                * (on - mean8)
            count += cell_m[i]
    return _z_normalise(total, linpow, count)


def _pad_and_tone_sum(linpow: jnp.ndarray, g: SearchGrid):
    """Pad the linear grid for a track scan and build the 8-tone row sum
    S8(f, t) = sum_j P(f + j*phi, t) — one shifted add per tone over the
    frequency rows the grid scans.  Returns (padded, s8, left pad).
    Shared by sync_scores_z and beacon/detect.py known_track_scores so the
    two z statistics cannot drift apart."""
    left = max(0, -g.t_start)
    right = max(0, g.t_start + g.num_times
                + (C.NUM_SYMBOLS - 1) * g.time_osr - linpow.shape[-1])
    padded = jnp.pad(linpow, ((0, 0), (left, right)))
    s8 = jnp.zeros((g.num_freqs, padded.shape[-1]), jnp.float32)
    for j in range(8):
        s8 = s8 + jax.lax.dynamic_slice_in_dim(
            padded, j * g.freq_osr, g.num_freqs, axis=0)
    return padded, s8, left


def _z_normalise(total: jnp.ndarray, linpow: jnp.ndarray,
                 count: np.ndarray) -> jnp.ndarray:
    """Contrast sum -> unit-noise-variance z.

    Each (on-tone − 8-tone mean) contrast has variance (7/8)·var(P) under
    noise-only; var(P) is the grid's EMPIRICAL cell variance, so repeat
    averaging (var ∝ 1/R) and window correlation are tracked without
    modelling them.  count: valid contrasts per time column (host)."""
    cell_var = jnp.var(linpow)
    sigma = jnp.sqrt(cell_var * 0.875
                     * jnp.asarray(np.maximum(count, 1.0), jnp.float32))
    return jnp.where(jnp.asarray(count > 0), total / sigma, -jnp.inf)


@functools.partial(jax.jit, static_argnames=("g", "max_candidates"))
def find_candidates(scores: jnp.ndarray, g: SearchGrid, max_candidates: int,
                    min_score: float):
    """Top-K candidates over the masked score grid.

    Returns (abs_time (K,), abs_freq (K,), score (K,), valid (K,)) sorted by
    descending score, matching the reference's heap selection
    (ft8_decode.py:127-147) up to tie order.

    Exact row-max screening — at most K distinct frequency rows
    can contain the global top-K (each such row's maximum is itself one of
    the >= K-th-largest scores), so one cheap max-reduction over time picks
    the candidate rows, and the flat top-K runs over only those few rows.
    A small slack absorbs exact-value ties, and the flat top-K never
    scans the full grid.
    """
    masked = jnp.where(scores >= min_score, scores, -jnp.inf)
    num_freqs, num_times = masked.shape
    rows_needed = max_candidates + 12                  # tie slack
    if num_freqs <= rows_needed or num_freqs * num_times == 0 \
            or num_times == 0:
        vals, idx = jax.lax.top_k(masked.reshape(-1), max_candidates)
    else:
        row_max = jnp.max(masked, axis=-1)             # (F,)
        _, rows = jax.lax.top_k(row_max, rows_needed)  # candidate rows
        sub = masked[rows]                             # (rows_needed, T)
        vals, i2 = jax.lax.top_k(sub.reshape(-1), max_candidates)
        idx = rows[i2 // num_times] * num_times + i2 % num_times
    abs_freq = idx // g.num_times
    abs_time = g.t_start + idx % g.num_times
    valid = jnp.isfinite(vals)
    return abs_time, abs_freq, vals, valid


@functools.partial(jax.jit, static_argnames=("g", "max_candidates"))
def find_candidates_tf(scores_tf: jnp.ndarray, g: SearchGrid,
                       max_candidates: int, min_score: float):
    """find_candidates on a TIME-MAJOR (num_times, num_freqs) score grid.

    Returns what ``find_candidates(scores_tf.T, ...)`` returns, up to
    exact-value ties: the row screen reduces over the time (major)
    axis to the same per-frequency maxima, and the flat top-k runs over
    the small screened submatrix TRANSPOSED back to (rows, T) so flat
    indices (and therefore jax.lax.top_k's lowest-index tie-breaking)
    coincide with the (F, T) path for every screened row.  Degenerate
    grids can still diverge in tie ORDER: the +12 row slack admits at
    most 12 exactly-tied row maxima beyond max_candidates (13+ rows
    tied exactly at the cutoff may drop a tied cell the full scan would
    keep), and within the screen tied rows follow row-max rank rather
    than flat index — same VALUE set in every non-degenerate case
    (tests/test_tf_layout.py asserts set equality on random grids).
    """
    masked = jnp.where(scores_tf >= min_score, scores_tf, -jnp.inf)
    num_times, num_freqs = masked.shape
    rows_needed = max_candidates + 12                  # tie slack
    if num_freqs <= rows_needed or num_freqs * num_times == 0 \
            or num_times == 0:
        vals, idx = jax.lax.top_k(
            jnp.swapaxes(masked, -1, -2).reshape(-1), max_candidates)
    else:
        row_max = jnp.max(masked, axis=-2)             # (F,)
        _, rows = jax.lax.top_k(row_max, rows_needed)  # candidate freqs
        # screened (rows_needed, T) submatrix via an EXACT one-hot
        # routing matmul instead of a minor-axis gather.  HIGHEST keeps
        # full f32 operands and the one-hot dot sums exactly one
        # product: bit-exact selection (tests/test_gpu.py asserts it
        # equals a gather on the card).  -inf cells become -1e30 first (-inf * 0 = NaN
        # would poison the products) and are restored after the top-k;
        # no genuine score approaches -1e30 (bounded dB contrasts).
        hot = (rows[:, None] == jnp.arange(num_freqs)[None, :]) \
            .astype(jnp.float32)
        safe = jnp.where(jnp.isneginf(masked), -1e30, masked)
        sub = jnp.matmul(hot, safe.T,
                         precision=jax.lax.Precision.HIGHEST)
        vals, i2 = jax.lax.top_k(sub.reshape(-1), max_candidates)
        vals = jnp.where(vals <= -0.9e30, -jnp.inf, vals)
        idx = rows[i2 // num_times] * num_times + i2 % num_times
    abs_freq = idx // g.num_times
    abs_time = g.t_start + idx % g.num_times
    valid = jnp.isfinite(vals)
    return abs_time, abs_freq, vals, valid
