"""Waterfall front-end: windowed STFT -> dB power grid.

Numerically equivalent to the reference's scipy spectrogram call
(src/ft8_tools/ft8_demodulator/spectrogram_analyse.py:19-64): periodic Hann
window of nperseg = 0.16*fs samples, hop = nperseg//steps_per_symbol,
nfft = fs/6.25 * bins_per_tone, 'spectrum' scaling (|X|^2 / sum(win)^2),
10*log10(1e-12 + .) dB, positive-frequency half.

Design: the transform is expressed as real matmuls against constant
cos/sin DFT matrices — they run on the matrix units, need no zero-padding
of frames to nfft (the DFT matrix already encodes the oversampled bin
spacing), and fold the Hann window in for free.  (Whether jnp.fft beats
them on the GPU is open, ROADMAP §1.6.)

For the standard FT8 geometry (hop = nperseg/time_osr exactly and
nfft = freq_osr * nperseg exactly — true whenever 0.16*fs and fs/6.25 are
integers, since 0.16 * 6.25 == 1) the ``block`` backend exploits the frame
overlap instead of recomputing it: the audio is cut into NON-overlapping
hop-length blocks, ONE (hop, nfft/2 + 2*freq_osr) DFT matmul transforms
each block once, and each frame's spectrum is recovered exactly as

    U_t[k] = sum_s  e^{-2pi i s k / (freq_osr*time_osr)} * P_{t+s}[k]

(the length-(s*hop) time offset of block s inside frame t is a pure phase)
followed by the periodic-Hann window applied as an exact 3-tap stencil in
frequency, X[k] = 0.5*U[k] - 0.25*U[k-freq_osr] - 0.25*U[k+freq_osr].
This is bit-for-bit the same arithmetic graph quality (float32, HIGHEST
precision matmuls) at 1/time_osr of the matmul FLOPs, and it removes the
overlapping-frame gather (blocks are a contiguous reshape).

For geometries where those divisibility conditions fail, ``backend=
"matmul"`` computes dense per-frame window-fused DFT matmuls, and for very
large configurations where DFT matrices stop paying off, ``backend="fft"``
switches to jnp.fft.  Complex input (drift-correction path) is carried as
stacked (..., n, 2) float32 [real, imag] (see ops/gfsk.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..protocol import constants as C

__all__ = [
    "WaterfallParams",
    "waterfall_params",
    "frame_signal",
    "waterfall_real",
    "waterfall_real_band",
    "waterfall_complex",
    "calculate_spectrogram",
]

_DB_FLOOR = 1e-12
# Above this nperseg the (nperseg x nfft/2) DFT matrices stop being the
# right trade (memory ~ nperseg*nfft*4 bytes); fall back to jnp.fft.
_MATMUL_MAX_NPERSEG = 4608


class WaterfallParams(NamedTuple):
    """Static STFT geometry for one (fs, osr) configuration."""

    fs: float
    nperseg: int
    hop: int
    nfft: int
    time_osr: int          # steps_per_symbol
    freq_osr: int          # bins_per_tone
    num_freq_bins: int     # positive-frequency bins = nfft // 2

    def num_frames(self, num_samples: int) -> int:
        return max(0, (num_samples - self.nperseg) // self.hop + 1)

    def num_blocks(self, num_samples: int) -> int:
        """Whole FT8 symbols in the waterfall (reference ftx_types.py:32)."""
        return self.num_frames(num_samples) // self.time_osr


def waterfall_params(fs: float, bins_per_tone: int = 2,
                     steps_per_symbol: int = 2) -> WaterfallParams:
    nperseg = int(C.SYMBOL_PERIOD_S * fs)
    hop = nperseg // steps_per_symbol
    nfft = int(fs / C.TONE_SPACING_HZ * bins_per_tone)
    return WaterfallParams(
        fs=float(fs), nperseg=nperseg, hop=hop, nfft=nfft,
        time_osr=steps_per_symbol, freq_osr=bins_per_tone,
        num_freq_bins=nfft // 2,
    )


def _hann_periodic(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


@functools.lru_cache(maxsize=16)
def _dft_matrices(nperseg: int, nfft: int) -> tuple[np.ndarray, np.ndarray]:
    """Window-fused (nperseg, nfft//2) cos/sin DFT matrices (host constants)."""
    win = _hann_periodic(nperseg)
    n = np.arange(nperseg)[:, None]
    k = np.arange(nfft // 2)[None, :]
    ang = -2.0 * np.pi * (n * k % nfft) / nfft
    cos_m = (np.cos(ang) * win[:, None]).astype(np.float32)
    sin_m = (np.sin(ang) * win[:, None]).astype(np.float32)
    return cos_m, sin_m


def frame_signal(wave: jnp.ndarray, nperseg: int, hop: int,
                 num_frames: int) -> jnp.ndarray:
    """(..., n) -> (..., num_frames, nperseg) overlapping frames (gather)."""
    idx = (jnp.arange(num_frames)[:, None] * hop
           + jnp.arange(nperseg)[None, :])
    return jnp.take(wave, idx, axis=-1)


def _block_geometry_ok(p: WaterfallParams) -> bool:
    """True iff the overlap-reusing block backend is exact for p."""
    return (p.hop * p.time_osr == p.nperseg
            and p.nfft == p.freq_osr * p.nperseg
            and p.hop > 0)


@functools.lru_cache(maxsize=16)
def _block_dft_matrices(hop: int, nfft: int,
                        num_freq_bins: int, freq_osr: int):
    """(hop, num_freq_bins + 2*freq_osr) cos/sin DFT matrices.

    Column c corresponds to DFT bin k = c - freq_osr (the extra columns on
    both sides feed the 3-tap Hann stencil).  No window is folded in.
    """
    n = np.arange(hop)[:, None]
    k = np.arange(-freq_osr, num_freq_bins + freq_osr)[None, :]
    ang = -2.0 * np.pi * ((n * k) % nfft) / nfft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _block_combine_phases(p: WaterfallParams):
    """Per-block phase vectors w[s, k] = e^{-2pi i s k/(freq_osr*time_osr)}.

    Shape (time_osr, num_freq_bins + 2*freq_osr, 2) [cos, -sin] as float32;
    k runs over the stencil-extended bin range starting at -freq_osr.
    """
    s = np.arange(p.time_osr)[:, None]
    k = np.arange(-p.freq_osr, p.num_freq_bins + p.freq_osr)[None, :]
    # s*hop sample delay of block s => phase -2pi*s*hop*k/nfft; with
    # hop*time_osr == nperseg and nfft == freq_osr*nperseg this reduces to
    # -2pi*s*k/(freq_osr*time_osr) exactly.
    period = p.freq_osr * p.time_osr
    ang = -2.0 * np.pi * ((s * k) % period) / period
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


# DFT matmul precision: the FT8_DFT_PRECISION knob (utils/backend.py).
# The CPU default is DEFAULT, which is exact float32 there.  The GPU
# default is the bf16x3 algorithm (three bf16 passes, f32 accumulation):
# at DEFAULT the GPU rounds the operands to TF32, and cells in deep
# spectral nulls then deviate from the CPU grid by up to ~0.5 dB
# (tests/gpu_checks.py check_waterfall_grids; PERF.md), while bf16x3
# holds every cell within 60 dB of the slot peak to ~0.01 dB for about
# twice the DFT time.  "high" is TF32 on the GPU too; "highest" is true
# float32.  A `precision=` argument overrides the knob.
_PRECISIONS = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
    "bf16x3": jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
}


def _resolve_precision(precision):
    if precision is None:
        from ..utils.backend import knob
        precision = knob("FT8_DFT_PRECISION")
    if isinstance(precision, str):
        return _PRECISIONS[precision.lower()]
    return precision


def _block_spectrum(wave: jnp.ndarray, p: WaterfallParams, num_frames: int,
                    precision=None):
    """Real (..., n) -> per-block DFT (..., nb, Kx) [re, im] via one matmul.

    Kx = num_freq_bins + 2*freq_osr (stencil halo), nb = num_frames +
    time_osr - 1 blocks.  Block-major layout keeps the matmul minor
    dimension large (Kx).
    """
    precision = _resolve_precision(precision)
    nb = num_frames + p.time_osr - 1
    blocks = wave[..., : nb * p.hop].reshape(*wave.shape[:-1], nb, p.hop)
    cos_m, sin_m = _block_dft_matrices(p.hop, p.nfft, p.num_freq_bins,
                                       p.freq_osr)

    def mm(a, b):
        return jnp.matmul(a, jnp.asarray(b), precision=precision,
                          preferred_element_type=jnp.float32)

    return mm(blocks, cos_m), mm(blocks, sin_m)


def _block_power(frames_re_im, p: WaterfallParams,
                 num_frames: int) -> jnp.ndarray:
    """Combine block-major spectra into windowed power (..., T, K)."""
    pr, pi = frames_re_im
    wc, ws = _block_combine_phases(p)
    ur = jnp.zeros(pr.shape[:-2] + (num_frames, pr.shape[-1]), jnp.float32)
    ui = ur
    for s in range(p.time_osr):
        prs = pr[..., s: s + num_frames, :]
        pis = pi[..., s: s + num_frames, :]
        c = jnp.asarray(wc[s])
        d = jnp.asarray(ws[s])   # phase = c + j*d with d = sin(ang)
        ur = ur + prs * c - pis * d
        ui = ui + prs * d + pis * c
    # periodic Hann as exact 3-tap stencil over the extended bin axis
    phi = p.freq_osr
    k0, k1 = phi, phi + p.num_freq_bins

    def hann(u):
        return (0.5 * u[..., k0:k1] - 0.25 * u[..., k0 - phi: k1 - phi]
                - 0.25 * u[..., k0 + phi: k1 + phi])

    xr = hann(ur)
    xi = hann(ui)
    return xr * xr + xi * xi


def _power_spectrum(frames_r: jnp.ndarray, frames_i, p: WaterfallParams,
                    backend: str, precision=None) -> jnp.ndarray:
    """frames (..., T, nperseg) -> positive-freq power (..., T, nfft//2).

    For complex input x = r + j*i:  X = (R_r - I_i) + j(R_i + I_r) where
    R_* / I_* are cos/sin DFT projections of the real and imaginary parts.
    """
    if backend == "matmul":
        cos_m, sin_m = _dft_matrices(p.nperseg, p.nfft)
        cos_m = jnp.asarray(cos_m)
        sin_m = jnp.asarray(sin_m)

        # precision: see the _PRECISIONS note
        prec = _resolve_precision(precision)

        def mm(a, b):
            return jnp.matmul(a, b, precision=prec,
                              preferred_element_type=jnp.float32)

        rr = mm(frames_r, cos_m)
        ri = mm(frames_r, sin_m)
        if frames_i is None:
            return rr * rr + ri * ri
        ir = mm(frames_i, cos_m)
        ii = mm(frames_i, sin_m)
        return (rr - ii) ** 2 + (ri + ir) ** 2
    # fft backend: complex compute inside jit
    win = jnp.asarray(_hann_periodic(p.nperseg).astype(np.float32))
    if frames_i is None:
        spec = jnp.fft.rfft(frames_r * win, n=p.nfft, axis=-1)
        spec = spec[..., : p.num_freq_bins]
    else:
        z = (frames_r + 1j * frames_i) * win
        spec = jnp.fft.fft(z, n=p.nfft, axis=-1)[..., : p.num_freq_bins]
    return jnp.real(spec) ** 2 + jnp.imag(spec) ** 2


def _waterfall(frames_r, frames_i, p: WaterfallParams, backend: str,
               precision=None):
    power = _power_spectrum(frames_r, frames_i, p, backend, precision)
    scale = 1.0 / float(np.sum(_hann_periodic(p.nperseg)) ** 2)
    mag_db = 10.0 * jnp.log10(_DB_FLOOR + power * scale)
    # waterfall layout is (freq, time) to match the reference indexing
    return jnp.swapaxes(mag_db, -1, -2)


# cap on DFT-matrix size (elements) before falling back to fft: the block
# matrices are (hop, nfft/2 + 2*freq_osr) x2; 16M elements = 128 MB of
# constants, far past the point where the fft backend wins anyway
_DFT_MATRIX_MAX_ELEMS = 16 * 1024 * 1024


def _pick_backend(p: WaterfallParams, backend: str | None) -> str:
    if backend is not None:
        if backend == "block" and not _block_geometry_ok(p):
            raise ValueError(
                "backend='block' requires hop*time_osr == nperseg and "
                f"nfft == freq_osr*nperseg; got {p} — use 'matmul' or 'fft'")
        return backend
    if _block_geometry_ok(p) and p.hop <= _MATMUL_MAX_NPERSEG \
            and p.hop * (p.num_freq_bins + 2 * p.freq_osr) \
            <= _DFT_MATRIX_MAX_ELEMS:
        return "block"
    if p.nperseg <= _MATMUL_MAX_NPERSEG \
            and p.nperseg * p.num_freq_bins <= _DFT_MATRIX_MAX_ELEMS:
        return "matmul"
    return "fft"


def _block_waterfall(frames_re_im, p: WaterfallParams,
                     num_frames: int) -> jnp.ndarray:
    # waterfall layout is (freq, time) to match the reference indexing
    return jnp.swapaxes(_block_waterfall_tf(frames_re_im, p, num_frames),
                        -1, -2)


def _block_boxcar_tf(frames_re_im, p: WaterfallParams,
                     num_frames: int) -> jnp.ndarray:
    """Boxcar (no-window) one-symbol DFT POWER grid, time-major.

    Row j holds |X|^2 of the boxcar symbol DFT whose window starts at
    hop block t0 = j - (time_osr - 1); columns are bins
    0..num_freq_bins-1.  The boxcar symbol DFT decomposes exactly over
    the hop-block DFTs with the SAME per-block phase combine as the
    Hann waterfall (ops/llr.py extract_llrs_matched_blocks:197-213) —
    this is that combine WITHOUT the 3-tap Hann stencil, evaluated over
    the extended start range [-(tau-1), nb) so partially-captured edge
    symbols carry their exact partial sums (zero-padded-block
    semantics, matching _mf_block_powers).  Rows:
    num_frames + 2*(time_osr - 1).

    With this grid, matched-filter LLR extraction is a tiny power
    gather (ops/llr.py extract_llrs_matched_grid) instead of the
    per-candidate spectra column gathers — and the grid costs little
    beside the Hann waterfall, since the Hann combine's `u` for frame t
    IS this grid's row t + tau - 1 (both derive from one block
    spectrum, demod/decode.py _front_slot_tf).
    """
    pr, pi = frames_re_im
    tau, phi = p.time_osr, p.freq_osr
    nb = num_frames + tau - 1
    nbrows = nb + tau - 1
    wc, ws = _block_combine_phases(p)
    pad = [(0, 0)] * (pr.ndim - 2) + [(tau - 1, tau - 1), (0, 0)]
    prx = jnp.pad(pr, pad)
    pix = jnp.pad(pi, pad)
    k0, k1 = phi, phi + p.num_freq_bins
    ub = jnp.zeros(pr.shape[:-2] + (nbrows, k1 - k0), jnp.float32)
    vb = ub
    for s in range(tau):
        prs = prx[..., s: s + nbrows, k0:k1]
        pis = pix[..., s: s + nbrows, k0:k1]
        c = jnp.asarray(wc[s, k0:k1])
        d = jnp.asarray(ws[s, k0:k1])
        ub = ub + prs * c - pis * d
        vb = vb + prs * d + pis * c
    return ub * ub + vb * vb


def _block_waterfall_tf(frames_re_im, p: WaterfallParams,
                        num_frames: int) -> jnp.ndarray:
    """Block spectra -> dB waterfall in NATIVE (time, freq) layout.

    (T, K) is the layout the epilogue produces anyway; keeping it makes
    frequency the minor (lane) axis — 15 full 128-lane tiles at the 12 kHz
    geometry vs a single ragged 88-wide tile for the (F, T) orientation —
    which is what the time-major sync stencil (ops/sync.py sync_scores_tf)
    wants.  Values are bit-identical to _block_waterfall transposed.
    """
    power = _block_power(frames_re_im, p, num_frames)   # (..., T, K)
    scale = 1.0 / float(np.sum(_hann_periodic(p.nperseg)) ** 2)
    return 10.0 * jnp.log10(_DB_FLOOR + power * scale)


@functools.partial(jax.jit, static_argnames=("p", "num_frames", "backend",
                                             "precision"))
def waterfall_real(wave: jnp.ndarray, p: WaterfallParams, num_frames: int,
                   backend: str | None = None,
                   precision: str | None = None) -> jnp.ndarray:
    """Real audio (..., n) -> dB waterfall (..., nfft//2, num_frames).

    precision: "default" | "high" | "highest" DFT-matmul precision; None
    uses the FT8_DFT_PRECISION knob (see the _PRECISIONS note)."""
    backend = _pick_backend(p, backend)
    if backend == "block":
        return _block_waterfall(
            _block_spectrum(wave, p, num_frames, precision), p, num_frames)
    frames = frame_signal(wave, p.nperseg, p.hop, num_frames)
    return _waterfall(frames, None, p, backend, precision)


def _pad_cols(m: np.ndarray, total: int) -> jnp.ndarray:
    """Zero-pad a host constant's last axis to `total` columns."""
    return jnp.asarray(np.pad(m, [(0, 0)] * (m.ndim - 1)
                              + [(0, max(0, total - m.shape[-1]))]))


@functools.partial(jax.jit,
                   static_argnames=("p", "num_frames", "band_rows", "backend"))
def waterfall_real_band(wave: jnp.ndarray, p: WaterfallParams,
                        num_frames: int, row_start: jnp.ndarray,
                        band_rows: int,
                        backend: str | None = None) -> jnp.ndarray:
    """dB waterfall rows [row_start, row_start + band_rows) only.

    The tensor-parallel front-end (SURVEY §2.3 TP row): each mesh shard
    materialises just its frequency band (plus the 7-tone sync/LLR stencil
    halo) by slicing the DFT-matrix COLUMNS at a traced offset — each output
    bin is an independent dot product, so the band is bit-identical to the
    same rows of :func:`waterfall_real`.  row_start may be a traced int32
    (e.g. ``axis_index * band``).  Rows at or past nfft//2 read zero-padded
    matrix columns and are MEANINGLESS (near the edge they still catch real
    stencil taps) — callers must mask them out, as decode_slot_tp does.
    """
    backend = _pick_backend(p, backend)
    phi = p.freq_osr
    row_start = jnp.asarray(row_start, jnp.int32)
    if backend == "block":
        nb = num_frames + p.time_osr - 1
        blocks = wave[..., : nb * p.hop].reshape(*wave.shape[:-1], nb, p.hop)
        cos_m, sin_m = _block_dft_matrices(p.hop, p.nfft, p.num_freq_bins,
                                           p.freq_osr)
        wc, ws = _block_combine_phases(p)
        # extended-axis column c maps to DFT bin k = c - phi; the band's
        # extended slice starts at global extended column = row_start
        width = band_rows + 2 * phi
        total = p.num_freq_bins + 2 * phi + band_rows   # slice always fits
        slc = functools.partial(jax.lax.dynamic_slice_in_dim,
                                start_index=row_start, slice_size=width,
                                axis=-1)

        def mm(a, b):
            return jnp.matmul(a, b, precision=_resolve_precision(None),
                              preferred_element_type=jnp.float32)

        pr = mm(blocks, slc(_pad_cols(cos_m, total)))
        pi = mm(blocks, slc(_pad_cols(sin_m, total)))
        wc_b = slc(_pad_cols(wc, total))
        ws_b = slc(_pad_cols(ws, total))
        ur = jnp.zeros(pr.shape[:-2] + (num_frames, width), jnp.float32)
        ui = ur
        for s in range(p.time_osr):
            prs = pr[..., s: s + num_frames, :]
            pis = pi[..., s: s + num_frames, :]
            ur = ur + prs * wc_b[s] - pis * ws_b[s]
            ui = ui + prs * ws_b[s] + pis * wc_b[s]
        k0, k1 = phi, phi + band_rows

        def hann(u):
            return (0.5 * u[..., k0:k1] - 0.25 * u[..., k0 - phi: k1 - phi]
                    - 0.25 * u[..., k0 + phi: k1 + phi])

        xr, xi = hann(ur), hann(ui)
        power = xr * xr + xi * xi
    elif backend == "matmul":
        frames = frame_signal(wave, p.nperseg, p.hop, num_frames)
        cos_m, sin_m = _dft_matrices(p.nperseg, p.nfft)
        total = p.num_freq_bins + band_rows
        slc = functools.partial(jax.lax.dynamic_slice_in_dim,
                                start_index=row_start, slice_size=band_rows,
                                axis=-1)

        def mm(a, b):
            return jnp.matmul(a, b, precision=_resolve_precision(None),
                              preferred_element_type=jnp.float32)

        rr = mm(frames, slc(_pad_cols(cos_m, total)))
        ri = mm(frames, slc(_pad_cols(sin_m, total)))
        power = rr * rr + ri * ri
    else:
        full = waterfall_real(wave, p, num_frames, backend=backend)
        padded = jnp.pad(full, [(0, 0)] * (full.ndim - 2)
                         + [(0, band_rows), (0, 0)],
                         constant_values=10.0 * np.log10(_DB_FLOOR))
        return jax.lax.dynamic_slice_in_dim(padded, row_start, band_rows,
                                            axis=-2)
    scale = 1.0 / float(np.sum(_hann_periodic(p.nperseg)) ** 2)
    mag_db = 10.0 * jnp.log10(_DB_FLOOR + power * scale)
    return jnp.swapaxes(mag_db, -1, -2)


@functools.partial(jax.jit, static_argnames=("p", "num_frames", "backend",
                                             "precision"))
def waterfall_complex(wave_ri: jnp.ndarray, p: WaterfallParams,
                      num_frames: int,
                      backend: str | None = None,
                      precision: str | None = None) -> jnp.ndarray:
    """Complex signal (..., n, 2) [re, im] -> dB waterfall (..., F, T)."""
    backend = _pick_backend(p, backend)
    if backend == "block":
        rr, ri = _block_spectrum(wave_ri[..., 0], p, num_frames, precision)
        ir, ii = _block_spectrum(wave_ri[..., 1], p, num_frames, precision)
        return _block_waterfall((rr - ii, ri + ir), p, num_frames)
    frames_r = frame_signal(wave_ri[..., 0], p.nperseg, p.hop, num_frames)
    frames_i = frame_signal(wave_ri[..., 1], p.nperseg, p.hop, num_frames)
    return _waterfall(frames_r, frames_i, p, backend, precision)


def calculate_spectrogram(wave_data: np.ndarray, sample_rate: float,
                          bins_per_tone: int = 2, steps_per_symbol: int = 2):
    """Reference-API-compatible host wrapper.

    Returns (mag_db, freqs, times) with the full two-sided fftshifted
    spectrum like the reference's calculate_spectrogram
    (spectrogram_analyse.py:19); too-short input yields empty arrays.
    """
    wave = np.asarray(wave_data)
    p = waterfall_params(sample_rate, bins_per_tone, steps_per_symbol)
    if wave.shape[-1] < p.nperseg:
        return np.array([[]]), np.array([]), np.array([])
    t_frames = p.num_frames(wave.shape[-1])
    if np.iscomplexobj(wave):
        ri = np.stack([wave.real, wave.imag], axis=-1).astype(np.float32)
        frames_r = frame_signal(jnp.asarray(ri[..., 0]), p.nperseg, p.hop, t_frames)
        frames_i = frame_signal(jnp.asarray(ri[..., 1]), p.nperseg, p.hop, t_frames)
    else:
        frames_r = frame_signal(jnp.asarray(wave.astype(np.float32)),
                                p.nperseg, p.hop, t_frames)
        frames_i = None

    @functools.partial(jax.jit, static_argnames=("backend",))
    def _full(fr, fi, backend="fft"):
        win = jnp.asarray(_hann_periodic(p.nperseg).astype(np.float32))
        z = fr * win if fi is None else (fr + 1j * fi) * win
        spec = jnp.fft.fft(z.astype(jnp.complex64), n=p.nfft, axis=-1)
        power = jnp.real(spec) ** 2 + jnp.imag(spec) ** 2
        scale = 1.0 / float(np.sum(_hann_periodic(p.nperseg)) ** 2)
        mag_db = 10.0 * jnp.log10(_DB_FLOOR + power * scale)
        return jnp.swapaxes(mag_db, -1, -2)

    mag = np.fft.fftshift(np.asarray(_full(frames_r, frames_i)), axes=0)
    freqs = np.fft.fftshift(np.fft.fftfreq(p.nfft, 1.0 / sample_rate))
    times = (np.arange(t_frames) * p.hop + p.nperseg / 2) / sample_rate
    return mag, freqs, times
