"""Soft-symbol log-likelihood extraction, vmapped over candidates.

Per candidate: gather the (58 data symbols x 8 tones) power window from the
waterfall, reorder through the Gray map and emit 174 max-of-4 LLRs, then
normalise the vector to variance 24 (reference ft8_extract_likelihood /
ftx_normalize_logl, src/ft8_tools/ft8_demodulator/ft8_decode.py:151-198).
Out-of-range symbols contribute zero LLRs, matching the reference's boundary
handling.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..protocol import constants as C

__all__ = ["extract_llrs", "extract_llrs_tf", "extract_llrs_matched",
           "extract_llrs_matched_blocks", "extract_llrs_matched_refined",
           "extract_llrs_matched_blocks_stacked",
           "extract_llrs_matched_stacked", "extract_llrs_coherent",
           "extract_llrs_coherent_stacked", "normalize_llrs"]

# Tone order after Gray reordering: s2[j] = powers[GRAY_MAP[j]].
_GRAY = jnp.asarray(C.GRAY_MAP)

# Precision of the two one-hot SELECTION matmuls in the decode hot path
# (extract_llrs / extract_llrs_tf).  The routing is exact at any
# precision (one nonzero per row); the precision only sets how the
# SELECTED dB values round through the operand format: DEFAULT is TF32
# on the GPU (~0.02 dB at waterfall magnitudes; one bf16 pass elsewhere,
# ~0.1 dB) — the same order as the BP routing matmuls' DEFAULT rounding
# of the very same LLRs one stage later, and the decode masks were
# identical at the cliff (benchmarks/precision_masks.py, llr_default
# arm).  What XLA:GPU does with HIGH is measured by tests/gpu_checks.py
# check_precision_high.
# Override with FT8_LLR_PRECISION={default,high,highest}.
_LLR_PRECISION = getattr(
    jax.lax.Precision,
    __import__("os").environ.get("FT8_LLR_PRECISION", "default").upper())
# Bit b of symbol value j (MSB first) — selects the max-of-4 groups.
_BIT_SET = np.array(
    [[(j >> (2 - b)) & 1 for j in range(8)] for b in range(3)], dtype=bool
)


def _llr_from_powers(s2: jnp.ndarray) -> jnp.ndarray:
    """(..., 8) Gray-ordered powers -> (..., 3) bit LLRs (max-of-4 contrast)."""
    out = []
    for b in range(3):
        set_mask = jnp.asarray(_BIT_SET[b])
        pos = jnp.max(jnp.where(set_mask, s2, -jnp.inf), axis=-1)
        neg = jnp.max(jnp.where(set_mask, -jnp.inf, s2), axis=-1)
        out.append(pos - neg)
    return jnp.stack(out, axis=-1)


@functools.partial(jax.jit, static_argnames=("time_osr", "freq_osr",
                                             "num_blocks"))
def extract_llrs(mag: jnp.ndarray, abs_time: jnp.ndarray,
                 abs_freq: jnp.ndarray, time_osr: int, freq_osr: int,
                 num_blocks: int) -> jnp.ndarray:
    """Waterfall (F, T) + candidates (K,) -> LLRs (K, 174), normalised.

    abs_time may be negative (pre-roll); symbols falling outside the
    waterfall get LLR 0.  The frequency reads collapse into ONE one-hot
    matmul with a merged (K*8) M-dimension (not per-candidate batched
    matmuls with M=8); the time reads are a K-batched one-hot matmul over
    the frame axis in place of a minor-axis take_along_axis or scattered
    (58, 8) index-pair gathers.  Their A/B against gathers on the GPU is
    open (ROADMAP §1.6).
    """
    tau, phi = time_osr, freq_osr
    num_freqs, num_frames = mag.shape
    k = abs_freq.shape[0]
    sym = jnp.asarray(C.DATA_SYMBOL_POSITIONS)            # (58,)

    # frequency select: one (K*8, F) one-hot matmul against the waterfall
    # (not per-candidate batched matmuls with M=8).  Precision: the
    # _LLR_PRECISION note above.
    f_idx = (abs_freq[:, None] + jnp.arange(8) * phi).reshape(k * 8)
    f_hot = (f_idx[:, None] == jnp.arange(num_freqs)).astype(jnp.float32)
    rows = jnp.matmul(f_hot, mag,
                      precision=_LLR_PRECISION)             # (K*8, T)
    rows = rows.reshape(k, 8, num_frames)

    # time select: K-batched one-hot matmul over frames.  Out-of-range
    # symbol times produce all-zero one-hot rows (power 0), which only
    # land in positions the validity mask zeroes anyway — identical LLRs
    # to a clamped gather.
    t_idx = abs_time[:, None] + sym[None, :] * tau        # (K, 58)
    t_hot = (t_idx[:, :, None]
             == jnp.arange(num_frames)[None, None, :]).astype(jnp.float32)
    powers = jax.lax.dot_general(
        rows, t_hot, (((2,), (2,)), ((0,), (0,))),
        precision=_LLR_PRECISION)                         # (K, 8, 58)
    powers = jnp.swapaxes(powers, -1, -2)                 # (K, 58, 8)

    base = jnp.floor_divide(abs_time, tau)                # (K,)
    block_idx = base[:, None] + sym[None, :]
    valid = (block_idx >= 0) & (block_idx < num_blocks)

    s2 = jnp.take(powers, _GRAY, axis=-1)                 # Gray reorder
    llr = _llr_from_powers(s2)                            # (K, 58, 3)
    llr = jnp.where(valid[:, :, None], llr, 0.0)
    return normalize_llrs(llr.reshape(llr.shape[0], C.LDPC_N))


@functools.partial(jax.jit, static_argnames=("time_osr", "freq_osr",
                                             "num_blocks"))
def extract_llrs_tf(mag_tf: jnp.ndarray, abs_time: jnp.ndarray,
                    abs_freq: jnp.ndarray, time_osr: int, freq_osr: int,
                    num_blocks: int) -> jnp.ndarray:
    """extract_llrs on a TIME-MAJOR (T, F) waterfall; values identical.

    Both selection matmuls contract one-hot 0/1 routing against the same
    dB cells as the (F, T) path at the same precision, so the gathered
    powers (and therefore the LLRs) are bit-identical — only the operand
    orientation changes, keeping the time-major fast path (waterfall ->
    sync -> candidates -> LLRs) free of any grid transpose.
    """
    tau, phi = time_osr, freq_osr
    num_frames, num_freqs = mag_tf.shape
    k = abs_freq.shape[0]
    sym = jnp.asarray(C.DATA_SYMBOL_POSITIONS)            # (58,)

    # frequency select: (T, F) @ (F, K*8) one-hot — same contraction as
    # the (F, T) path's f_hot @ mag, transposed
    f_idx = (abs_freq[:, None] + jnp.arange(8) * phi).reshape(k * 8)
    f_hot = (jnp.arange(num_freqs)[:, None] == f_idx[None, :]) \
        .astype(jnp.float32)
    sel = jnp.matmul(mag_tf, f_hot,
                     precision=_LLR_PRECISION)            # (T, K*8)
    rows = jnp.transpose(sel.reshape(num_frames, k, 8), (1, 0, 2))

    # time select: K-batched one-hot contraction over frames -> (K, 58, 8)
    t_idx = abs_time[:, None] + sym[None, :] * tau        # (K, 58)
    t_hot = (t_idx[:, :, None]
             == jnp.arange(num_frames)[None, None, :]).astype(jnp.float32)
    powers = jax.lax.dot_general(
        t_hot, rows, (((2,), (1,)), ((0,), (0,))),
        precision=_LLR_PRECISION)                         # (K, 58, 8)

    base = jnp.floor_divide(abs_time, tau)                # (K,)
    block_idx = base[:, None] + sym[None, :]
    valid = (block_idx >= 0) & (block_idx < num_blocks)

    s2 = jnp.take(powers, _GRAY, axis=-1)                 # Gray reorder
    llr = _llr_from_powers(s2)                            # (K, 58, 3)
    llr = jnp.where(valid[:, :, None], llr, 0.0)
    return normalize_llrs(llr.reshape(llr.shape[0], C.LDPC_N))


def normalize_llrs(llr: jnp.ndarray) -> jnp.ndarray:
    """Scale each 174-vector to variance 24 (reference ft8_decode.py:190)."""
    mean = jnp.mean(llr, axis=-1, keepdims=True)
    var = jnp.mean((llr - mean) ** 2, axis=-1, keepdims=True)
    return llr * jnp.sqrt(24.0 / jnp.maximum(var, 1e-30))


# ---------------------------------------------------------------------------
# matched-filter LLR re-extraction (beyond the reference)
# ---------------------------------------------------------------------------

def _powers_to_llrs(powers: jnp.ndarray) -> jnp.ndarray:
    """(K, 58, 8) linear symbol powers -> (K, 174) normalised LLRs."""
    s2 = jnp.take(10.0 * jnp.log10(1e-12 + powers), _GRAY, axis=-1)
    llr = _llr_from_powers(s2)
    return normalize_llrs(llr.reshape(powers.shape[0], C.LDPC_N))

@functools.lru_cache(maxsize=16)
def _mf_tone_matrices(sps: int) -> tuple[np.ndarray, np.ndarray]:
    """(sps, 8) cos/sin of the integer-tone boxcar DFT e^{-2pi i tone n/sps}."""
    n = np.arange(sps)[:, None]
    tone = np.arange(8)[None, :]
    ang = -2.0 * np.pi * ((n * tone) % sps) / sps
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _mf_mix_tables(sps: int, phi: int) -> tuple[np.ndarray, np.ndarray]:
    """(sps*phi,) cos/sin lookup for e^{-2pi i q n/(sps*phi)} mixes."""
    ang = -2.0 * np.pi * np.arange(sps * phi) / (sps * phi)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("time_osr", "freq_osr"))
def extract_llrs_matched_grid(box_tf: jnp.ndarray, abs_time: jnp.ndarray,
                              abs_freq: jnp.ndarray, time_osr: int,
                              freq_osr: int) -> jnp.ndarray:
    """Matched-filter LLRs gathered from a precomputed BOXCAR power grid.

    box_tf: (num_frames + 2*(tau-1), num_freq_bins) linear |X|^2 of the
    one-symbol boxcar DFT at every (start, bin) — row j is window start
    t0 = j - (tau - 1) (ops/waterfall.py _block_boxcar_tf, or the fused
    Pallas front's second output).  Value-equivalent to
    extract_llrs_matched_blocks up to f32 summation order and the
    selection matmuls' operand pass (the same one-hot routing idiom as
    extract_llrs_tf; out-of-range symbol rows contract against all-zero
    one-hots, reproducing the zero-padded-block edge semantics).

    Why this exists (round 5): the per-candidate spectra column gathers
    of extract_llrs_matched_blocks measured 130 us/slot at the DEEP
    geometry — XLA lane-axis gathers — while the grid is ~free inside
    the fused front (the Hann combine's `u` IS the boxcar value) and
    this extraction is two small routing matmuls.
    """
    tau, phi = time_osr, freq_osr
    nbrows, num_freqs = box_tf.shape
    k = abs_freq.shape[0]
    sym = jnp.asarray(C.DATA_SYMBOL_POSITIONS)            # (58,)

    f_idx = (abs_freq[:, None] + jnp.arange(8) * phi).reshape(k * 8)
    f_hot = (jnp.arange(num_freqs)[:, None] == f_idx[None, :]) \
        .astype(jnp.float32)
    sel = jnp.matmul(box_tf, f_hot,
                     precision=_LLR_PRECISION)            # (rows, K*8)
    rows = jnp.transpose(sel.reshape(nbrows, k, 8), (1, 0, 2))

    t_idx = abs_time[:, None] + sym[None, :] * tau + (tau - 1)  # (K, 58)
    t_hot = (t_idx[:, :, None]
             == jnp.arange(nbrows)[None, None, :]).astype(jnp.float32)
    powers = jax.lax.dot_general(
        t_hot, rows, (((2,), (1,)), ((0,), (0,))),
        precision=_LLR_PRECISION)                         # (K, 58, 8)
    return _powers_to_llrs(powers)


@functools.partial(jax.jit, static_argnames=("time_osr", "freq_osr"))
def extract_llrs_matched_blocks(spec_re: jnp.ndarray, spec_im: jnp.ndarray,
                                abs_time: jnp.ndarray,
                                abs_freq: jnp.ndarray, time_osr: int,
                                freq_osr: int) -> jnp.ndarray:
    """Matched-filter LLRs from the slot's BLOCK spectra: (K, 174).

    The boxcar one-symbol DFT decomposes EXACTLY over the waterfall's
    non-overlapping hop-block DFTs (ops/waterfall.py `_block_spectrum`):
    a symbol is time_osr contiguous hop blocks, and

        X_sym(bin) = sum_s  e^{-2pi i s (q + k*phi)/(phi*tau)}
                           * P_{b0+s}[bin]

    (hop = sps/tau, nfft = phi*sps make the per-block delay a pure phase
    with period phi*tau).  So the matched filter costs one tiny column
    gather + a (tau, 8) phase combine per candidate, reusing the DFT
    matmul the decoder already ran — no windows, no pads, no skinny
    matmuls (the direct form's (K*58, sps)x(sps, 8) tone matmuls are
    skinny and dominated an earlier deep-mode profile).

    spec_re/spec_im: (nb, Kx) block spectra with Kx = nfft//2 + 2*phi
    extended columns (col = bin + phi).  Bit-equivalent to the direct
    boxcar DFT up to f32 summation order.
    """
    return _powers_to_llrs(_mf_block_powers(
        spec_re, spec_im, abs_time, abs_freq, time_osr, freq_osr))


def _mf_block_powers(spec_re: jnp.ndarray, spec_im: jnp.ndarray,
                     abs_time: jnp.ndarray, abs_freq: jnp.ndarray,
                     time_osr: int, freq_osr: int) -> jnp.ndarray:
    """Block spectra (nb, Kx) -> per-candidate symbol powers (K, 58, 8)."""
    tau, phi = time_osr, freq_osr
    k = abs_freq.shape[0]
    m = phi * tau
    sym = np.asarray(C.DATA_SYMBOL_POSITIONS)

    # per-candidate tone columns (extended axis): q + k*phi + phi
    cols = (abs_freq[:, None] + jnp.arange(8) * phi + phi).reshape(-1)
    prc = jnp.take(spec_re, cols, axis=-1)                # (nb, K*8)
    pic = jnp.take(spec_im, cols, axis=-1)
    pad = C.NUM_SYMBOLS * tau
    prc = jnp.pad(prc, ((pad, pad), (0, 0))).reshape(-1, k, 8)
    pic = jnp.pad(pic, ((pad, pad), (0, 0))).reshape(-1, k, 8)
    prc = jnp.moveaxis(prc, 1, 0)                         # (K, rows, 8)
    pic = jnp.moveaxis(pic, 1, 0)

    def windows(ar, ai, t0):
        start = jnp.clip(t0 + pad, 0, ar.shape[0] - pad)
        wr = jax.lax.dynamic_slice_in_dim(ar, start, pad, axis=0)
        wi = jax.lax.dynamic_slice_in_dim(ai, start, pad, axis=0)
        shape = (C.NUM_SYMBOLS, tau, 8)
        return wr.reshape(shape)[sym], wi.reshape(shape)[sym]

    wr, wi = jax.vmap(windows)(prc, pic, abs_time)        # (K, 58, tau, 8)

    # combine phases e^{-2pi i s (q + k*phi)/m}
    s = jnp.arange(tau)
    bins = abs_freq[:, None, None] + jnp.arange(8)[None, None, :] * phi
    ang = (-2.0 * jnp.pi / m) * jnp.mod(bins * s[None, :, None], m)
    cc = jnp.cos(ang)[:, None]                            # (K, 1, tau, 8)
    ss = jnp.sin(ang)[:, None]
    xr = jnp.sum(wr * cc - wi * ss, axis=-2)              # (K, 58, 8)
    xi = jnp.sum(wr * ss + wi * cc, axis=-2)
    return xr * xr + xi * xi


@functools.partial(jax.jit, static_argnames=("time_osr", "freq_osr"))
def extract_llrs_matched_blocks_stacked(spec_re: jnp.ndarray,
                                        spec_im: jnp.ndarray,
                                        abs_time: jnp.ndarray,
                                        abs_freq: jnp.ndarray,
                                        time_osr: int,
                                        freq_osr: int) -> jnp.ndarray:
    """Repeat-stacked matched-filter LLRs from (R, nb, Kx) block spectra.

    Noncoherent cross-transmission combining (demod/stack.py, beyond the
    reference): spec_re/spec_im carry the hop-block spectra of R
    slot-aligned repeats of ONE transmission; the per-tone symbol powers
    are averaged across repeats in the LINEAR domain before LLR formation.
    For noncoherent FSK under independent noise the summed per-tone energy
    is the sufficient statistic, so this is the optimal combiner — phase
    is free to differ arbitrarily between repeats.
    """
    pw = jax.vmap(lambda r, i: _mf_block_powers(
        r, i, abs_time, abs_freq, time_osr, freq_osr))(spec_re, spec_im)
    return _powers_to_llrs(jnp.mean(pw, axis=0))


@functools.partial(jax.jit, static_argnames=("sps", "hop", "freq_osr",
                                             "is_complex", "nt", "nf"))
def extract_llrs_matched_refined(wave: jnp.ndarray, abs_time: jnp.ndarray,
                                 abs_freq: jnp.ndarray, sps: int, hop: int,
                                 freq_osr: int, is_complex: bool = False,
                                 nt: int = 5, nf: int = 3
                                 ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Matched-filter LLRs with per-candidate SUB-GRID (dt, df) refinement.

    The candidate grid quantises each transmission's start time to
    +-hop/2 samples (~1/4 symbol at time osr 2) and its frequency to
    +-1/(2*freq_osr) tone spacings.  For off-grid signals — every real
    transmission; the crowded-band benchmark draws both offsets uniformly
    — the one-symbol boxcar matched filter pays up to ~2.5 dB (time,
    adjacent-symbol spill) + ~0.9 dB (frequency, scalloping) of detection
    SNR at the grid-cell corner.  This variant evaluates the boxcar DFT
    powers of ALL 79 symbols on an nt x nf sub-grid of offsets spanning
    one grid cell, scores each offset by the linear-power contrast of the
    21 Costas sync cells (sum of on-tone power minus the 8-tone mean),
    and extracts each candidate's LLRs at its best-scoring offset.

    Returns (llrs_base, llrs_refined): base is the unrefined offset-(0,0)
    extraction (it is computed anyway as the first grid point), refined
    the best-offset one.  Callers decode base first and RETRY failures
    with refined — at the deep-cliff SNRs the 21-cell offset score is
    noisy enough to occasionally pick a wrong offset for an on-grid
    signal (measured -2/10 at -15.5 dB when refined replaces base), so
    decode-both keeps refinement a strict superset.  The offsets run
    sequentially (lax.map) to bound window memory at one offset's
    (K, 79, sps) slab.  Sub-bin frequency mixes split into the integer-
    row modular table (exact) times a small-angle fractional mix, so f32
    phase error stays at the on-grid path's level.

    Grid defaults (nt=5, nf=3) are measured: TIME is the binding axis
    (adjacent-symbol spill dominates scalloping), and refining it to
    1/10-hop worst residual beats the 3x3 grid's 1/6 at every cliff SNR
    (150 off-grid trials/point, fs 2 kHz: -16.0 dB 0.27->0.32, -15.5
    0.52->0.56, -15.0 0.76->0.85 over 100 fresh trials, consistent with
    the first 50); nf=5 added nothing over nf=3.  Cost is linear in nt
    (one sequential dt slab each).  The gain survives osr 4x4's halved
    cells (fs 4 kHz off-grid: -18.5 dB yield 0.50 -> 0.83).
    """
    if nt % 2 == 0 or nf % 2 == 0:
        raise ValueError("nt/nf must be odd so the (0, 0) base offset is "
                         "a grid point (it feeds llrs_base)")
    phi = freq_osr
    k = abs_freq.shape[0]
    n_sig = C.NUM_SYMBOLS * sps
    pad_spec = [(n_sig, n_sig)] + [(0, 0)] * (wave.ndim - 1)
    xp = jnp.pad(wave.astype(jnp.float32), pad_spec)

    # offset grid: the nt x nf BIN CENTERS of one quantisation cell — the
    # minimax cover of the uniform residual (worst residual 1/(2*nt) of a
    # hop, vs 1/4 for a {0, +-1/4} grid).  Odd nt/nf put (0, 0) at the
    # centre; its powers feed llrs_base.
    t_fr = [(i + 0.5) / nt - 0.5 for i in range(nt)]
    f_fr = [(i + 0.5) / nf - 0.5 for i in range(nf)]
    dts = jnp.asarray([int(round(f * hop)) for f in t_fr], dtype=jnp.int32)

    # integer-row candidate mix (shared by every offset)
    mixc_t, mixs_t = _mf_mix_tables(sps, phi)
    q = jnp.mod(abs_freq.astype(jnp.int32), sps * phi)
    tab = jnp.mod(q[:, None] * jnp.arange(sps)[None, :], sps * phi)
    mc0 = jnp.asarray(mixc_t)[tab]                        # (K, sps)
    ms0 = jnp.asarray(mixs_t)[tab]

    # per-df tone matrices, host f64: the fractional-row shift is
    # candidate-independent, so it folds into the (sps, 8) tone DFT matrix
    # instead of a per-window mix — windows and candidate mixes are shared
    # by all nf frequency offsets of one dt
    n_ = np.arange(sps)[:, None]
    tone = np.arange(8)[None, :]
    tone_mats = []
    for df in f_fr:
        ang = -2.0 * np.pi * n_ * (tone / sps + df / (sps * phi))
        tone_mats.append((jnp.asarray(np.cos(ang).astype(np.float32)),
                          jnp.asarray(np.sin(ang).astype(np.float32))))
    hp = jax.lax.Precision.HIGH

    def mm(a, b):
        return jnp.matmul(a, b, precision=hp,
                          preferred_element_type=jnp.float32)

    costas_pos = np.where(C.FRAME_IS_COSTAS)[0]           # (21,)
    costas_hot = jax.nn.one_hot(
        jnp.asarray(C.FRAME_COSTAS_TONE[costas_pos]), 8)  # (21, 8)
    dsym = np.asarray(C.DATA_SYMBOL_POSITIONS)            # (58,)

    def windows(s0, dt, rows):
        """One candidate's symbol rows at sample offset dt: (len(rows), sps, .)"""
        start = jnp.clip(s0 + dt + n_sig, 0, xp.shape[0] - n_sig)
        w = jax.lax.dynamic_slice_in_dim(xp, start, n_sig, axis=0)
        return w.reshape((C.NUM_SYMBOLS, sps) + wave.shape[1:])[rows]

    def mix(win):
        """Apply the per-candidate integer-row mix: win (K, rows, sps, .)."""
        if is_complex:
            wr, wi = win[..., 0], win[..., 1]
            xr = wr * mc0[:, None, :] - wi * ms0[:, None, :]
            xi = wr * ms0[:, None, :] + wi * mc0[:, None, :]
        else:
            xr = win * mc0[:, None, :]
            xi = win * ms0[:, None, :]
        return xr, xi

    # stage 1 — score every offset on the 21 Costas symbols ONLY (21/79
    # of the window work; the data symbols are extracted once, at the
    # winning offset, in stage 2).  Costas contrast in linear power:
    # on-tone minus 8-tone mean, summed over the 21 sync cells.
    def scores_at_dt(dt):
        win = jax.vmap(lambda s0: windows(s0, dt, costas_pos))(
            abs_time * hop)                               # (K, 21, sps, .)
        xr, xi = mix(win)
        out = []
        for tc, ts in tone_mats:
            re = mm(xr, tc) - mm(xi, ts)                  # (K, 21, 8)
            im = mm(xr, ts) + mm(xi, tc)
            pw = re * re + im * im
            on = jnp.einsum("ksj,sj->ks", pw, costas_hot)
            out.append(jnp.sum(on - jnp.mean(pw, axis=-1), axis=-1))
        return jnp.stack(out)                             # (nf, K)

    scores = jax.lax.map(scores_at_dt, dts)               # (nt, nf, K)
    best = jnp.argmax(scores.reshape(nt * nf, k), axis=0)   # (K,)
    dt_best = dts[best // nf]                             # (K,) samples
    df_hot = jax.nn.one_hot(best % nf, nf)                # (K, nf)

    to_llrs = _powers_to_llrs

    # base: offset (0, 0) — dt 0, centre (df = 0) tone matrix
    tc0, ts0 = tone_mats[nf // 2]
    win0 = jax.vmap(lambda s0: windows(s0, 0, dsym))(abs_time * hop)
    xr0, xi0 = mix(win0)                                  # (K, 58, sps)
    re0 = mm(xr0, tc0) - mm(xi0, ts0)
    im0 = mm(xr0, ts0) + mm(xi0, tc0)
    llrs_base = to_llrs(re0 * re0 + im0 * im0)

    # stage 2 — data-symbol extraction at each candidate's best offset:
    # per-candidate dt goes into the window slice, per-candidate df into
    # a one-hot-combined (K, sps, 8) tone matrix (batched matmul)
    tc_all = jnp.stack([tc for tc, _ in tone_mats])       # (nf, sps, 8)
    ts_all = jnp.stack([ts for _, ts in tone_mats])
    tck = jnp.einsum("kj,jst->kst", df_hot, tc_all)
    tsk = jnp.einsum("kj,jst->kst", df_hot, ts_all)
    winb = jax.vmap(lambda s0, dt: windows(s0, dt, dsym))(
        abs_time * hop, dt_best)                          # (K, 58, sps, .)
    xrb, xib = mix(winb)
    reb = mm(xrb, tck) - mm(xib, tsk)                     # (K, 58, 8)
    imb = mm(xrb, tsk) + mm(xib, tck)
    return llrs_base, to_llrs(reb * reb + imb * imb)


@functools.partial(jax.jit, static_argnames=("sps", "hop", "freq_osr",
                                             "is_complex"))
def extract_llrs_matched(wave: jnp.ndarray, abs_time: jnp.ndarray,
                         abs_freq: jnp.ndarray, sps: int, hop: int,
                         freq_osr: int,
                         is_complex: bool = False) -> jnp.ndarray:
    """Matched-filter LLRs straight from the audio: (K, 174), normalised.

    Beyond the reference: the waterfall's Hann window costs ~1.8 dB of
    detection SNR for on-bin FSK tones (ENBW 1.5 bins vs the boxcar's 1.0).
    For candidates the waterfall-LLR decode could not crack, this extracts
    each of the 58 data symbols with the true matched filter — a
    RECTANGULAR window of exactly one symbol (sps samples), aligned at the
    candidate's start — and evaluates the 8 tone bins by direct DFT.
    Measured at fs 2 kHz, truth-aligned candidates: 62 % vs 23 % decode at
    -14.5 dB, 18 % vs 1 % at -15.5 dB (100 trials, BP+OSD).

    Per candidate, tone k of base bin q = abs_freq sits at frequency
    (q/phi + k) * 6.25 Hz, i.e. DFT exponent e^{-2pi i(q n/(sps*phi) +
    k n/sps)} — one (sps*phi)-entry lookup mixes the candidate's
    fractional-bin offset, one static (sps, 8) matrix handles the tones.

    wave: (n,) real or (n, 2) [re, im] when is_complex.  abs_time may be
    negative (pre-roll); out-of-range samples read as zero and the affected
    symbols contribute ~zero LLRs, like extract_llrs.
    """
    return _powers_to_llrs(_mf_direct_powers(
        wave, abs_time, abs_freq, sps, hop, freq_osr, is_complex))


@functools.partial(jax.jit, static_argnames=("sps", "hop", "freq_osr",
                                             "is_complex"))
def extract_llrs_matched_stacked(waves: jnp.ndarray, abs_time: jnp.ndarray,
                                 abs_freq: jnp.ndarray, sps: int, hop: int,
                                 freq_osr: int,
                                 is_complex: bool = False) -> jnp.ndarray:
    """Repeat-stacked matched-filter LLRs straight from (R, n[, 2]) audio.

    Direct-form fallback of extract_llrs_matched_blocks_stacked for
    geometries the hop-block decomposition does not cover: per-tone symbol
    powers of R slot-aligned repeats averaged in the linear domain before
    LLR formation (noncoherent combining; see demod/stack.py).
    """
    pw = jax.vmap(lambda w: _mf_direct_powers(
        w, abs_time, abs_freq, sps, hop, freq_osr, is_complex))(waves)
    return _powers_to_llrs(jnp.mean(pw, axis=0))


def _mf_direct_powers(wave: jnp.ndarray, abs_time: jnp.ndarray,
                      abs_freq: jnp.ndarray, sps: int, hop: int,
                      freq_osr: int, is_complex: bool) -> jnp.ndarray:
    """Audio (n[, 2]) -> per-candidate boxcar symbol powers (K, 58, 8)."""
    phi = freq_osr
    sym = np.asarray(C.DATA_SYMBOL_POSITIONS)             # (58,)

    # window extraction: one contiguous 79-symbol dynamic_slice per
    # candidate + a STATIC take of the 58 data-symbol rows.  (A flat
    # (K, 58, sps) element gather lowers catastrophically at large sps —
    # measured 100x slower at fs 12 kHz osr 4x4.)  Zero padding on both
    # sides makes out-of-range samples read as zero, which is exactly the
    # desired pre-roll/tail semantics.
    n_sig = C.NUM_SYMBOLS * sps
    pad_spec = [(n_sig, n_sig)] + [(0, 0)] * (wave.ndim - 1)
    xp = jnp.pad(wave.astype(jnp.float32), pad_spec)

    def windows(s0):
        start = jnp.clip(s0 + n_sig, 0, xp.shape[0] - n_sig)
        w = jax.lax.dynamic_slice_in_dim(xp, start, n_sig, axis=0)
        w = w.reshape((C.NUM_SYMBOLS, sps) + wave.shape[1:])
        return w[sym]                                     # (58, sps, ...)

    win = jax.vmap(windows)(abs_time * hop)               # (K, 58, sps, .)
    if is_complex:
        wr, wi = win[..., 0], win[..., 1]
    else:
        wr, wi = win, None

    # candidate mix e^{-2pi i q n/(sps*phi)} via modular table lookup
    mixc_t, mixs_t = _mf_mix_tables(sps, phi)
    q = jnp.mod(abs_freq.astype(jnp.int32), sps * phi)
    tab = jnp.mod(q[:, None] * jnp.arange(sps)[None, :], sps * phi)
    mc = jnp.asarray(mixc_t)[tab][:, None, :]             # (K, 1, sps)
    ms = jnp.asarray(mixs_t)[tab][:, None, :]
    if wi is None:
        xr, xi = wr * mc, wr * ms
    else:
        xr = wr * mc - wi * ms
        xi = wr * ms + wi * mc

    tc, ts = _mf_tone_matrices(sps)
    tc = jnp.asarray(tc)
    ts = jnp.asarray(ts)
    hp = jax.lax.Precision.HIGH

    def mm(a, b):
        return jnp.matmul(a, b, precision=hp,
                          preferred_element_type=jnp.float32)

    re = mm(xr, tc) - mm(xi, ts)                          # (K, 58, 8)
    im = mm(xr, ts) + mm(xi, tc)
    return re * re + im * im


# ---------------------------------------------------------------------------
# coherent matched-filter extraction (beyond the reference)

def extract_llrs_coherent(wave: jnp.ndarray, abs_time: jnp.ndarray,
                          abs_freq: jnp.ndarray, sps: int, hop: int,
                          freq_osr: int, is_complex: bool = False,
                          num_branches: int = 5) -> jnp.ndarray:
    """Coherent matched-filter LLR variants: (B, K, 174).

    FT8's modulation index is exactly 1 (6.25 Hz x 0.16 s), so every tone
    returns to the SAME carrier phase at each symbol boundary: the
    complex one-symbol tone correlations C(s, k) of a whole transmission
    share one phase track theta + 2pi*df*T*s (+ a tone term 2pi*k*dt/sps
    for timing offset dt).  Projecting C onto that track keeps only the
    in-phase noise component — coherent FSK detection, worth ~2 dB over
    the noncoherent |C|^2 at the sensitivity cliff (docs/DESIGN_NOTES.md,
    measured).

    The track is estimated from the 21 known Costas cells.  Because the
    Costas blocks sit 36 symbols apart, |sum| as a function of df has
    near-equal sidelobes every 1/(36 T) Hz — at cliff SNR the argmax
    lands on the wrong branch often at ANY SNR, so this returns B =
    num_branches LLR variants (centre branch first) and the caller lets
    BP + CRC arbitrate, exactly like the AP hypothesis decode
    (demod.decode coherent_retry; measured 0 false accepts over noise
    controls).

    Estimation pipeline, all Costas-cells-only until the final extract:
    1. dt slice grid over +-hop/2 (9 steps): re-sliced Costas
       correlations, coarse-df coherence metric -> best dt per candidate.
    2. coarse df grid (dense: the coherence main lobe is 1/79 c/s wide)
       at dt* -> centre branch.
    3. per branch: fine (df x fractional-dt phase) grid -> (theta, df,
       dtf) track.
    4. one full 79-symbol extraction at dt*, projected per branch;
       LLRs formed in the LINEAR power domain (clamped projections are
       exactly 0 — the dB mapping would turn them into -120 dB outliers
       that dominate the variance normalisation).
    """
    return extract_llrs_coherent_stacked(
        wave[None], abs_time, abs_freq, sps, hop, freq_osr, is_complex,
        num_branches)


@functools.partial(jax.jit, static_argnames=("sps", "hop", "freq_osr",
                                             "is_complex", "num_branches"))
def extract_llrs_coherent_stacked(waves: jnp.ndarray, abs_time: jnp.ndarray,
                                  abs_freq: jnp.ndarray, sps: int, hop: int,
                                  freq_osr: int, is_complex: bool = False,
                                  num_branches: int = 5) -> jnp.ndarray:
    """Repeat-stacked coherent LLR variants from (R, n[, 2]) audio.

    Each repeat of a beacon has its OWN carrier phase (no cross-cycle
    coherence over 15-s gaps), but all repeats share the candidate's
    (dt, df): the track search combines the per-repeat coherence
    metrics |z_r|^2 noncoherently — 3x the branch-resolution evidence at
    R = 3 — then fits one theta_r per repeat at the winning point, and
    sums the PROJECTED powers across repeats before LLR formation.
    R = 1 reduces exactly to extract_llrs_coherent.
    """
    phi = freq_osr
    k = abs_freq.shape[0]
    costas_pos = np.where(C.FRAME_IS_COSTAS)[0]                  # (21,)
    costas_tone = C.FRAME_COSTAS_TONE[costas_pos]                # (21,)
    cpos = jnp.asarray(costas_pos)
    ctone = jnp.asarray(costas_tone)

    if not is_complex:
        # real input carries the negative-frequency image, and at FT8's
        # geometry the image term of every tone is COHERENT across
        # symbols (2 f0 T is an integer whenever f0 sits on the tone
        # grid): it forms a counter-rotating second phase track of equal
        # amplitude that bends/duplicates the coherence peaks.  One FFT
        # per repeat to the analytic signal removes it exactly.
        n = waves.shape[1]
        spec = jnp.fft.fft(waves.astype(jnp.complex64), axis=1)
        weight = jnp.zeros(n, jnp.float32).at[0].set(1.0)
        weight = weight.at[1:(n + 1) // 2].set(2.0)
        if n % 2 == 0:
            weight = weight.at[n // 2].set(1.0)
        analytic = jnp.fft.ifft(spec * weight[None, :], axis=1)
        waves = jnp.stack([jnp.real(analytic), jnp.imag(analytic)], -1)

    n_sig = C.NUM_SYMBOLS * sps
    pad_spec = [(0, 0), (n_sig, n_sig), (0, 0)]
    xp = jnp.pad(waves.astype(jnp.float32), pad_spec)    # (R, n+2p, 2)

    mixc_t, mixs_t = _mf_mix_tables(sps, phi)
    q = jnp.mod(abs_freq.astype(jnp.int32), sps * phi)
    tab = jnp.mod(q[:, None] * jnp.arange(sps)[None, :], sps * phi)
    mc_all = jnp.asarray(mixc_t)[tab]                    # (K, sps)
    ms_all = jnp.asarray(mixs_t)[tab]
    # the per-symbol mix restarts its phase at every window, so a
    # candidate's base frequency leaves a DETERMINISTIC residual phase
    # step of 2pi*(abs_freq mod phi)/phi per symbol (integer tone cycles
    # cancel; only the sub-tone row offset survives).  Without removing
    # it, odd half-bin rows (half of all real signals at phi=2) sit
    # 0.5 cycles/symbol outside every df search and the coherent gain
    # silently vanishes.
    q_frac = jnp.mod(abs_freq, phi).astype(jnp.float32) / phi   # (K,)
    tc, ts = _mf_tone_matrices(sps)
    tc, ts = jnp.asarray(tc), jnp.asarray(ts)
    hp = jax.lax.Precision.HIGH

    def complex_syms(xp_r, dt_samples, positions):
        """One repeat (n+2p, 2) -> (K, P, 8) complex tone correlations,
        base-row phase step removed."""
        def windows(s0, dt):
            start = jnp.clip(s0 + n_sig + dt, 0, xp_r.shape[0] - n_sig)
            w = jax.lax.dynamic_slice_in_dim(xp_r, start, n_sig, axis=0)
            w = w.reshape((C.NUM_SYMBOLS, sps, 2))
            return w[positions]

        dt_b = jnp.broadcast_to(jnp.asarray(dt_samples), abs_time.shape)
        win = jax.vmap(windows)(abs_time * hop, dt_b)   # (K, P, sps, 2)
        mc = mc_all[:, None, :]
        ms = ms_all[:, None, :]
        wr, wi = win[..., 0], win[..., 1]
        xr = wr * mc - wi * ms
        xi = wr * ms + wi * mc
        re = jnp.matmul(xr, tc, precision=hp) \
            - jnp.matmul(xi, ts, precision=hp)
        im = jnp.matmul(xr, ts, precision=hp) \
            + jnp.matmul(xi, tc, precision=hp)
        pos = jnp.asarray(np.asarray(positions), jnp.float32)
        ang0 = -2.0 * jnp.pi * q_frac[:, None] * pos[None, :]   # (K, P)
        c0 = jnp.cos(ang0)[..., None]
        s0 = jnp.sin(ang0)[..., None]
        return re * c0 - im * s0, re * s0 + im * c0     # (K, P, 8)

    def costas_z(re, im):
        """On-track Costas complex values (..., 21)."""
        sel = jax.nn.one_hot(ctone, 8, dtype=re.dtype)  # (21, 8)
        zr = jnp.sum(re * sel, axis=-1)
        zi = jnp.sum(im * sel, axis=-1)
        return zr, zi

    # -- stage 1: dt slice grid, coarse-df coherence metric ----------------
    dts = np.round(np.linspace(-hop // 2, hop // 2, 9)).astype(np.int32)
    # candidate frequency is quantised to +-half a waterfall row =
    # +-1/(2 phi) cycles/symbol; cover with margin.  The coherence main
    # lobe is only ~1/NUM_SYMBOLS wide, so sample it ~4x per lobe or
    # on-grid sidelobes beat an off-grid main peak (measured)
    half_row = 0.5 / phi + 0.02
    n_coarse = int(np.ceil(2 * half_row * 4 * C.NUM_SYMBOLS)) | 1
    deltas = jnp.linspace(-half_row, half_row, n_coarse)
    ramp = -2.0 * jnp.pi * deltas[:, None] * cpos[None, :].astype(
        jnp.float32)                                    # (D, 21)
    rc, rs = jnp.cos(ramp), jnp.sin(ramp)

    def rep_costas(dt):
        """All repeats' Costas values at slice dt: (R, K, 21) x2."""
        re, im = jax.vmap(lambda x: complex_syms(x, dt, costas_pos))(xp)
        return costas_z(re, im)

    def spectrum(zr, zi):
        """Summed-over-repeats coherence spectrum (K, D)."""
        sr = zr @ rc.T - zi @ rs.T                      # (R, K, D)
        si = zr @ rs.T + zi @ rc.T
        return jnp.sum(sr * sr + si * si, axis=0)

    mets = []
    for dt in dts:                                      # static unroll (9)
        zr, zi = rep_costas(int(dt))
        mets.append(jnp.max(spectrum(zr, zi), axis=-1))
    best_dt = jnp.argmax(jnp.stack(mets), axis=0)       # (K,)

    # -- full extraction per repeat at each candidate's best dt ------------
    dt_sel = jnp.asarray(dts)[best_dt]                  # (K,)
    re79, im79 = jax.vmap(
        lambda x: complex_syms(x, dt_sel, np.arange(C.NUM_SYMBOLS)))(xp)
    zr79, zi79 = costas_z(re79[:, :, costas_pos], im79[:, :, costas_pos])

    # -- stage 2: centre branch from the coarse grid ------------------------
    spec_c = spectrum(zr79, zi79)                       # (K, D)
    d_centre = deltas[jnp.argmax(spec_c, axis=-1)]      # (K,)

    # -- stage 3+4: per-branch fine track + projection ----------------------
    branch_step = 1.0 / 36.0                            # cycles/symbol
    order = [0, 1, -1, 2, -2, 3, -3][:num_branches]
    fine_d = jnp.linspace(-0.016, 0.016, 11)            # within-branch df
    fine_t = jnp.linspace(-0.06, 0.06, 5)               # frac dt, symbols
    s79 = jnp.arange(C.NUM_SYMBOLS).astype(jnp.float32)
    tone8 = jnp.arange(8).astype(jnp.float32)
    t2 = fine_t.shape[0]

    out = []
    for m in order:
        d_b = d_centre + m * branch_step                # (K,)
        d_all = d_b[:, None] + fine_d[None, :]          # (K, F)
        angf = -2.0 * jnp.pi * d_all[:, :, None, None] \
            * cpos[None, None, None, :].astype(jnp.float32) \
            - 2.0 * jnp.pi * fine_t[None, None, :, None] \
            * ctone[None, None, None, :].astype(jnp.float32)
        cf, sf = jnp.cos(angf), jnp.sin(angf)           # (K, F, T2, 21)
        zrr = jnp.einsum("rkc,kftc->rkft", zr79, cf) \
            - jnp.einsum("rkc,kftc->rkft", zi79, sf)
        zii = jnp.einsum("rkc,kftc->rkft", zr79, sf) \
            + jnp.einsum("rkc,kftc->rkft", zi79, cf)
        mag = jnp.sum(zrr * zrr + zii * zii, axis=0)    # (K, F, T2)
        flat = mag.reshape(k, -1)
        idx = jnp.argmax(flat, axis=-1)
        fi, ti = idx // t2, idx % t2
        d_fin = jnp.take_along_axis(d_all, fi[:, None], 1)[:, 0]
        t_fin = fine_t[ti]
        # one theta per REPEAT at the winning (df, dtf) point
        zrr_w = jnp.take_along_axis(
            zrr.reshape(zrr.shape[0], k, -1), idx[None, :, None], 2)[..., 0]
        zii_w = jnp.take_along_axis(
            zii.reshape(zii.shape[0], k, -1), idx[None, :, None], 2)[..., 0]
        th = jnp.arctan2(zii_w, zrr_w)                  # (R, K)
        track = th[:, :, None, None] \
            + 2.0 * jnp.pi * d_fin[None, :, None, None] \
            * s79[None, None, :, None] \
            + 2.0 * jnp.pi * t_fin[None, :, None, None] \
            * tone8[None, None, None, :]
        proj = re79 * jnp.cos(track) + im79 * jnp.sin(track)
        proj = jnp.maximum(proj, 0.0)                   # (R, K, 79, 8)
        powers = jnp.sum(proj * proj, axis=0)[
            :, jnp.asarray(C.DATA_SYMBOL_POSITIONS)]    # (K, 58, 8)
        s2 = jnp.take(powers, _GRAY, axis=-1)
        llr = _llr_from_powers(s2)
        out.append(normalize_llrs(llr.reshape(k, C.LDPC_N)))
    return jnp.stack(out)                               # (B, K, 174)
