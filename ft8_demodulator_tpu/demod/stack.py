"""Cross-transmission (beacon) stacking decoder — beyond the reference.

The reference is an FT8 *beacon* receiver
(src/ft8_tools/ft8_beacon_receiver/frequency_correction.py): a beacon
transmits the SAME payload every 15-s FT8 cycle, so R received slots are R
independent noncoherent looks at one transmission.  For noncoherent FSK
under independent noise the summed per-tone energy is the sufficient
statistic, so the optimal combiner needs no carrier phase coherence across
repeats: this module averages LINEAR waterfall powers across repeats for
sync/candidate search (the Costas stencil contrast grows with the average)
and averages matched-filter symbol powers for LLR extraction, then decodes
once.  The reference has no cross-transmission combining of any kind; its
sensitivity is single-slot (docs/DESIGN_NOTES.md places the single-slot
wall at the code decoder, and stacking is the named next step past it).

Alignment contract: repeats must be slot-aligned (FT8 transmissions start
on the 15-s cycle boundary, so receivers naturally capture them at a fixed
slot offset) and frequency-stable to a fraction of a tone across repeats.
On satellite channels apply per-repeat drift correction
(beacon.correct_frequency_drift) first; the complex corrected waves stack
the same way ((R, n, 2) input).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.llr import (extract_llrs, extract_llrs_matched_blocks_stacked,
                       extract_llrs_matched_stacked)
from ..ops.sync import (find_candidates, search_grid, sync_scores,
                        sync_scores_z)
from ..ops.waterfall import WaterfallParams, waterfall_params
from ..protocol import constants as C
from .decode import _format_results, estimate_snr, finish_decode
from .types import FT8Decode, SlotDecodeResult

__all__ = ["decode_slot_stacked", "decode_ft8_stacked", "as_device_stack"]


def _stacked_power_and_spec(waves: jnp.ndarray, p: WaterfallParams,
                            num_frames: int, is_complex: bool,
                            equalize: bool = False):
    """(R, n[, 2]) repeats -> (MEAN linear power grid (F, T), per-repeat
    block spectra or None, per-repeat combining weights (R,) or None).

    For noncoherent FSK under independent noise AND EQUAL NOISE FLOORS the
    summed per-tone energy is the sufficient statistic, so the linear mean
    over repeats is the lossless combining point; sync/LLR consumers
    convert to dB themselves.  When the block backend applies, the
    per-repeat hop-block spectra are returned too so the matched-filter
    symbol DFTs reuse them (ops/llr.py
    extract_llrs_matched_blocks_stacked).

    equalize: normalise each repeat's NOISE FLOOR before combining.
    Receiver gain is not constant across 15-s cycles (AGC steps, satellite
    path-loss change), and a raw power mean weights repeat r by gain(r)^2:
    one 4x-gain cycle carries 16x the weight and the stack degrades toward
    single-slot sensitivity (measured: R=4 coherent at -20/-21 dB decodes
    6/6 with equal gains, 2/6 and 0/6 with gains [1, 2, 0.5, 4]; 6/6 at
    both SNRs equalized).  The per-repeat noise power is estimated as the MEDIAN
    of the repeat's linear power grid — the transmission occupies ~8 of
    the grid's ~200 frequency rows, so the median is blind to it at any
    SNR (a mean would be signal-inflated above ~0 dB).  Weights are
    normalised to mean 1 so the overall power scale (and the SNR
    estimator's floor) is preserved.  The weights are returned so callers
    can apply the SAME equalisation to raw-audio consumers (the coherent
    path scales waves by sqrt(w)).
    """
    from ..ops.waterfall import (_block_power, _block_spectrum,
                                 _hann_periodic, _pick_backend,
                                 _power_spectrum, frame_signal)

    backend = _pick_backend(p, None)
    if backend == "block":
        if is_complex:
            rr, ri = _block_spectrum(waves[..., 0], p, num_frames)
            ir, ii = _block_spectrum(waves[..., 1], p, num_frames)
            spec = (rr - ii, ri + ir)
        else:
            spec = _block_spectrum(waves, p, num_frames)
        power = _block_power(spec, p, num_frames)         # (R, T, K)
    else:
        spec = None
        if is_complex:
            fr = frame_signal(waves[..., 0], p.nperseg, p.hop, num_frames)
            fi = frame_signal(waves[..., 1], p.nperseg, p.hop, num_frames)
        else:
            fr = frame_signal(waves, p.nperseg, p.hop, num_frames)
            fi = None
        power = _power_spectrum(fr, fi, p, backend)       # (R, T, F)
    weights = None
    if equalize:
        r = power.shape[0]
        noise = jnp.median(power.reshape(r, -1), axis=-1)   # (R,)
        # a DEAD repeat (recorded silence: dropout, gap-filled zeros) has
        # noise ~ 0 and 1/noise would hand it essentially ALL the weight
        # (crushing the live repeats to ~0 after normalisation — measured
        # 0/3 decodes vs 3/3).  Real gain changes never drive the noise
        # floor toward float-zero, so repeats far below the loudest
        # repeat's floor are excluded (weight 0); with mean-1
        # normalisation the live weights then sum to R and the stacked
        # mean equals the mean over live repeats — a dropout costs
        # nothing beyond its missing look.
        dead = noise <= 1e-9 * jnp.max(noise)
        w = jnp.where(dead, 0.0, 1.0 / jnp.maximum(noise, 1e-30))
        weights = w / jnp.maximum(jnp.mean(w), 1e-30)       # mean-1 scale
        power = power * weights[:, None, None]
        if spec is not None:
            sq = jnp.sqrt(weights)[:, None, None]
            spec = (spec[0] * sq, spec[1] * sq)
    scale = 1.0 / float(np.sum(_hann_periodic(p.nperseg)) ** 2)
    return (jnp.swapaxes(jnp.mean(power, axis=0) * scale, -1, -2), spec,
            weights)


def _stacked_mag_and_spec(waves: jnp.ndarray, p: WaterfallParams,
                          num_frames: int, is_complex: bool):
    """(R, n[, 2]) repeats -> (dB waterfall of the MEAN linear power,
    per-repeat block spectra or None).  See _stacked_power_and_spec."""
    from ..ops.waterfall import _DB_FLOOR

    power, spec, _ = _stacked_power_and_spec(waves, p, num_frames,
                                             is_complex)
    return 10.0 * jnp.log10(_DB_FLOOR + power), spec


@functools.partial(jax.jit, static_argnames=(
    "p", "num_frames", "max_candidates", "max_iterations", "is_complex",
    "use_osd", "use_mf", "coherent"))
def _decode_slot_stacked_with_mag(waves: jnp.ndarray, p: WaterfallParams,
                                  num_frames: int, max_candidates: int,
                                  min_score: float, max_iterations: int,
                                  is_complex: bool, use_osd: bool,
                                  use_mf: bool,
                                  ap_values=None, ap_mask=None,
                                  coherent: bool = False,
                                  min_z=2.0):
    """decode_slot_stacked core; also returns the stacked dB grid so the
    host API can estimate SNRs without recomputing the waterfall.

    Candidate search: R > 1 stacks use the linear-power Costas z-statistic
    (ops/sync.py sync_scores_z — exact-truth-cell presence in the top-K
    roughly doubles at the stacked coherent cliff vs the dB stencil),
    thresholded by ``min_z`` (unit-variance z scale).  R == 1 keeps the
    reference-parity dB stencil and ``min_score``, preserving the
    decode_slot equivalence contract.

    ap_values/ap_mask (V, 77): optional a-priori hypotheses
    (protocol.message.ap_hypotheses) — a beacon's callsign is usually
    known, and clamping it stacks on top of the noncoherent combining
    gain (demod.decode.ap_retry has the algorithm notes).

    R > 1 repeats are noise-floor-EQUALISED before combining (see
    _stacked_power_and_spec: receiver gain varies across cycles, and raw
    power means weight repeats by gain^2); the same weights scale the
    audio fed to the coherent retry.
    """
    from ..ops.waterfall import _DB_FLOOR

    equalize = waves.shape[0] > 1
    g = search_grid(p.num_freq_bins, num_frames, p.time_osr, p.freq_osr)
    power, spec, weights = _stacked_power_and_spec(
        waves, p, num_frames, is_complex, equalize=equalize)
    if weights is not None:
        sq = jnp.sqrt(weights).reshape(
            (waves.shape[0],) + (1,) * (waves.ndim - 1))
        waves = waves * sq
    mag = 10.0 * jnp.log10(_DB_FLOOR + power)
    if waves.shape[0] > 1:
        scores = sync_scores_z(power, g)
        thresh = min_z
    else:
        scores = sync_scores(mag, g)
        thresh = min_score
    abs_time, abs_freq, score, cand_valid = find_candidates(
        scores, g, max_candidates, thresh)
    if use_mf:
        if spec is not None:
            llrs = extract_llrs_matched_blocks_stacked(
                spec[0], spec[1], abs_time, abs_freq, p.time_osr,
                p.freq_osr)
        else:
            llrs = extract_llrs_matched_stacked(
                waves, abs_time, abs_freq, p.nperseg, p.hop, p.freq_osr,
                is_complex)
    else:
        llrs = extract_llrs(mag, abs_time, abs_freq, p.time_osr,
                            p.freq_osr, g.num_blocks)
    res = finish_decode(llrs, abs_time, abs_freq, score, cand_valid,
                        max_iterations, use_osd)
    if coherent:
        from ..ops.llr import extract_llrs_coherent_stacked
        from .decode import _merge_results, variant_retry
        # per-repeat carrier phases, shared (dt, df) search across
        # repeats, projected powers summed noncoherently (ops/llr.py)
        cllrs = extract_llrs_coherent_stacked(
            waves, abs_time, abs_freq, p.nperseg, p.hop, p.freq_osr,
            is_complex)
        res = _merge_results(res, variant_retry(cllrs, res,
                                                max_iterations, use_osd))
    if ap_values is not None:
        from .decode import _merge_results, ap_retry_llrs
        res = _merge_results(res, ap_retry_llrs(
            llrs, res, ap_values, ap_mask, max_iterations, use_osd))
    return res, mag


def decode_slot_stacked(waves: jnp.ndarray, p: WaterfallParams,
                        num_frames: int, max_candidates: int = 20,
                        min_score: float = 10.0, max_iterations: int = 20,
                        is_complex: bool = False,
                        use_osd: bool = False,
                        use_mf: bool = True,
                        coherent: bool = False,
                        min_z: float = 2.0) -> SlotDecodeResult:
    """R slot-aligned repeats (R, n[, 2]) of ONE transmission -> decode.

    One jit: per-repeat STFT, linear-power averaging, candidate search on
    the stacked grid (R > 1: linear Costas z-statistic thresholded by
    ``min_z``; R == 1: reference dB stencil and ``min_score``),
    repeat-averaged matched-filter LLRs (use_mf, the default — the
    single-slot MF-first path's combiner) or Hann LLRs read from the
    stacked dB grid, BP(+OSD), CRC.

    With R == 1 and use_mf this is exactly decode_slot(mf_first=True):
    the mean over one repeat is the identity, so results match
    bit-for-bit (tested).
    """
    res, _ = _decode_slot_stacked_with_mag(
        waves, p, num_frames, max_candidates, min_score, max_iterations,
        is_complex, use_osd, use_mf, coherent=coherent,
        min_z=float(min_z))
    return res


def as_device_stack(waves) -> tuple[jnp.ndarray, bool]:
    """Host repeats -> (device (R, n[, 2]) float32 array, is_complex).

    Accepts (R, n) real, (R, n) complex, or (R, n, 2) [re, im] float (the
    repo's standard complex representation for arrays that must cross the
    host/device boundary).  (n,), (n, 2) and complex (n,) single captures
    gain a leading R=1 axis.  Shared by decode_ft8_stacked and
    beacon/detect.py so both entry points normalise identically.
    """
    waves = np.asarray(waves)
    is_complex = bool(np.iscomplexobj(waves))
    if waves.ndim == 1 or (waves.ndim == 2 and not is_complex
                           and waves.shape[-1] == 2):
        waves = waves[None]
    if is_complex:
        if waves.ndim != 2:
            raise ValueError("complex waves must be (R, n) or (n,)")
        return jnp.asarray(np.stack([waves.real, waves.imag],
                                    axis=-1).astype(np.float32)), True
    if waves.ndim == 3 and waves.shape[-1] == 2:
        return jnp.asarray(waves.astype(np.float32)), True
    if waves.ndim != 2:
        raise ValueError("waves must be (R, n) real, (R, n) complex, or "
                         "(R, n, 2) [re, im]: R slot-aligned repeats")
    return jnp.asarray(waves.astype(np.float32)), False


def decode_ft8_stacked(waves, sample_rate: float,
                       bins_per_tone: int = 2, steps_per_symbol: int = 2,
                       max_candidates: int = 20, min_score: float = 10.0,
                       max_iterations: int = 20,
                       use_osd: bool = False,
                       use_mf: bool = True,
                       deduplicate: bool = True,
                       ap: bool | str = False,
                       coherent: bool = False,
                       min_z: float = 2.0,
                       refine_fixes: bool = False) -> list[FT8Decode]:
    """Decode one repeated transmission from R stacked slots (host API).

    waves: (R, n) real, (R, n) complex, or (R, n, 2) [re, im] — R captures
    of the same transmission, slot-aligned.  Returns FT8Decode rows like
    decode_ft8_message; time/frequency are relative to the common slot.

    Measured gain over the best single-slot path (OSD + MF) at fs 2 kHz:
    see docs/DESIGN_NOTES.md ("Cross-transmission stacking") and
    benchmarks/stacking_sweep.py.

    ap: a-priori hypotheses exactly as in decode_ft8_message — a beacon's
    callsign is usually KNOWN, and clamping it stacks on top of the
    noncoherent combining gain (measured ~+1 dB at the R=4 stacked
    cliff, tests/test_ap.py).

    min_z: candidate threshold for R > 1 stacks, in units of the linear
    Costas z-statistic's noise standard deviation (sync_scores_z);
    min_score applies only to R == 1 input (reference dB stencil).

    refine_fixes=True replaces each decode's grid-quantised (time, freq)
    with a coherent known-payload fix (beacon.track_known_payload) run
    against the NEWEST non-silent repeat — sub-Hz frequency for Doppler
    tracking.  The tracker's single-repeat floor (~−29 dB) sits well
    under the stacked decode floor, so decoded rows essentially always
    refine.
    """
    wave_d, is_complex = as_device_stack(waves)
    p = waterfall_params(sample_rate, bins_per_tone, steps_per_symbol)
    if wave_d.shape[1] < p.nperseg:
        return []
    from .decode import ap_arrays
    ap_values, ap_mask = ap_arrays(ap) if ap else (None, None)
    num_frames = p.num_frames(wave_d.shape[1])
    res, mag = _decode_slot_stacked_with_mag(
        wave_d, p, num_frames, max_candidates, float(min_score),
        max_iterations, is_complex, use_osd, use_mf, ap_values, ap_mask,
        coherent, min_z=float(min_z))
    # LIVE repeat count: dead (all-zero) rows are weight-0 in the
    # combiner (BeaconSession rings zero-pad until full), so the SNR
    # estimator's median correction and the plausibility gate must scale
    # with the repeats actually contributing, not the array shape —
    # otherwise a 1-live/8-slot ring gates at -30.5 instead of -26
    r_stack = max(1, int(np.sum([np.any(np.asarray(w) != 0)
                                 for w in np.asarray(waves)])))
    snr = estimate_snr(mag, res.payload, res.abs_time, res.abs_freq,
                       p.time_osr, p.freq_osr, stack_r=r_stack)
    hop_seconds = C.SYMBOL_PERIOD_S / p.time_osr
    freq_step = C.TONE_SPACING_HZ / p.freq_osr
    # plausibility gate scales with the stack: the estimate is the
    # PER-REPEAT SNR and R repeats buy ~5 log10(R) dB of decode reach
    # (R=8 real decodes measure -24; the gate sits ~6 dB under that)
    rows = _format_results(res, hop_seconds, freq_step, 0.0, 0.0,
                           deduplicate, snr_db=snr,
                           min_snr_db=-26.0 - 5.0 * np.log10(r_stack))
    if refine_fixes and rows:
        from .decode import _refine_rows

        # newest non-silent repeat (BeaconSession rings zero-pad the
        # not-yet-received leading cycles)
        host = np.asarray(waves)
        live = [i for i in range(host.shape[0])
                if np.any(host[i] != 0)] or [host.shape[0] - 1]
        rows = _refine_rows(rows, host[live[-1]], sample_rate, freq_step)
    return rows
