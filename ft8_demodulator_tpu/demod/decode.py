"""End-to-end FT8 slot decoder.

One jitted, fixed-shape pipeline per (signal length, fs, osr, K) config:

    waterfall -> sync stencil -> top-K candidates -> vmapped LLR extraction
    -> vmapped LDPC BP -> GF(2) CRC check -> packed payloads + accept mask

Everything dynamic in the reference (heap top-N, BP early exit, per-candidate
accept/reject) is fixed-shape masked computation, so the whole decode batches
with vmap and shards with pjit.  The host wrapper `decode_ft8_message`
mirrors the reference API (src/ft8_tools/ft8_demodulator/ft8_decode.py:288)
minus its in-decoder matplotlib side effects, and adds optional hash dedup
(the reference can return the same message once per surviving candidate).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.ldpc_decode import bp_decode_batch
from ..ops.llr import (extract_llrs, extract_llrs_coherent,
                       extract_llrs_matched,
                       extract_llrs_matched_blocks,
                       extract_llrs_matched_refined, extract_llrs_tf)
from ..ops.osd import osd_decode_masked
from ..ops.sync import (SearchGrid, find_candidates, find_candidates_tf,
                        search_grid, sync_scores, sync_scores_tf)
from ..ops.waterfall import WaterfallParams, waterfall_params, waterfall_real, \
    waterfall_complex
from ..protocol import constants as C
from ..protocol.encode import encode_tones
from ..utils.backend import knob
from .types import FT8Decode, FT8DecodeStatus, FT8Message, SlotDecodeResult

__all__ = ["decode_waterfall", "decode_waterfall_mf", "decode_slot",
           "decode_slots", "decode_ft8_message", "finish_decode",
           "mf_retry", "ap_retry", "coherent_retry", "estimate_snr"]

_CRC_MATRIX_77_T = jnp.asarray(C.CRC_MATRIX_77.T, dtype=jnp.float32)
_CRC_WEIGHTS = jnp.asarray(2 ** np.arange(C.CRC_BITS - 1, -1, -1),
                           dtype=jnp.int32)
_BYTE_WEIGHTS = jnp.asarray(2 ** np.arange(7, -1, -1), dtype=jnp.int32)


def _crc_of_plain(plain: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(K, 174) hard bits -> (computed CRC-14, embedded CRC-14) per row.

    DEFAULT matmul precision is exact for this GF(2) product: 0/1 operands
    are exact in any reduced operand format (TF32, bf16) and the sum
    accumulates in float32 (integer dot products <= 77 carry no
    rounding) — same argument as ldpc_check; tests/test_gpu.py asserts
    it on the card.
    """
    bits77 = plain[:, : C.PAYLOAD_BITS].astype(jnp.float32)
    crc_bits = jnp.mod(
        jnp.matmul(bits77, _CRC_MATRIX_77_T,
                   precision=jax.lax.Precision.DEFAULT), 2.0
    ).astype(jnp.int32)
    crc_calc = jnp.sum(crc_bits * _CRC_WEIGHTS, axis=-1)
    crc_extracted = jnp.sum(
        plain[:, C.PAYLOAD_BITS: C.LDPC_K] * _CRC_WEIGHTS, axis=-1)
    return crc_calc, crc_extracted


@functools.partial(jax.jit, static_argnames=("g", "max_candidates",
                                             "max_iterations", "use_osd"))
def decode_waterfall(mag: jnp.ndarray, g: SearchGrid, max_candidates: int,
                     min_score: float, max_iterations: int = 20,
                     use_osd: bool = False,
                     min_abs_time=None) -> SlotDecodeResult:
    """Positive-frequency dB waterfall (F, T) -> SlotDecodeResult (K rows).

    use_osd layers ordered-statistics decoding (ops/osd.py, beyond the
    reference) over candidates whose BP decode did not yield a CRC-valid
    codeword.

    min_abs_time (traced int scalar, optional) masks out candidate start
    times below it — the sharded stream decoder uses this to keep the
    pre-roll region active only on the shard that owns the capture start.
    """
    scores = sync_scores(mag, g)
    if min_abs_time is not None:
        t_idx = g.t_start + jnp.arange(g.num_times)
        scores = jnp.where(t_idx[None, :] >= min_abs_time, scores, -jnp.inf)
    abs_time, abs_freq, score, cand_valid = find_candidates(
        scores, g, max_candidates, min_score)

    llrs = extract_llrs(mag, abs_time, abs_freq, g.time_osr, g.freq_osr,
                        g.num_blocks)
    return finish_decode(llrs, abs_time, abs_freq, score, cand_valid,
                         max_iterations, use_osd)


@functools.partial(jax.jit, static_argnames=("max_iterations", "use_osd"))
def finish_decode(llrs: jnp.ndarray, abs_time: jnp.ndarray,
                  abs_freq: jnp.ndarray, score: jnp.ndarray,
                  cand_valid: jnp.ndarray, max_iterations: int = 20,
                  use_osd: bool = False) -> SlotDecodeResult:
    """(K, 174) LLRs + candidate metadata -> SlotDecodeResult.

    The back half of decode_waterfall (BP -> CRC -> payload pack), split out
    so sharded front-ends (parallel/tensor.py) can run it on gathered LLRs.
    """
    plain, ldpc_errors = bp_decode_batch(llrs, max_iterations)

    if use_osd:
        bp_crc_calc, bp_crc_ext = _crc_of_plain(plain)
        bp_success = (ldpc_errors == 0) & (bp_crc_calc == bp_crc_ext)
        if knob("FT8_OSD_GATE") == "on":
            # OSD only the candidates BP could not crack (and only real
            # candidates): rows that already validated — at operating
            # SNRs that is most of the group — skip the GF(2)
            # elimination entirely (ops/osd.py osd_decode_masked; final
            # success masks are unchanged because success requires
            # cand_valid anyway)
            need = cand_valid & ~bp_success
            osd_plain, take = osd_decode_masked(llrs, need)
        else:
            # FT8_OSD_GATE=off: the pre-round-5 unconditional form,
            # kept for A/B and the gating mask certificate
            from ..ops.osd import osd_decode_batch
            osd_plain, osd_ok = osd_decode_batch(llrs)
            take = ~bp_success & osd_ok
        plain = jnp.where(take[:, None], osd_plain, plain)
        ldpc_errors = jnp.where(take, 0, ldpc_errors)

    crc_calc, crc_extracted = _crc_of_plain(plain)

    # payload bytes: 77 bits + 3 zero pad, packed MSB-first
    pad = jnp.zeros((plain.shape[0], 3), plain.dtype)
    bits80 = jnp.concatenate([plain[:, : C.PAYLOAD_BITS], pad], axis=-1)
    payload = jnp.sum(
        bits80.reshape(-1, C.PAYLOAD_BYTES, 8) * _BYTE_WEIGHTS, axis=-1
    ).astype(jnp.uint8)

    success = cand_valid & (ldpc_errors == 0) & (crc_calc == crc_extracted)
    return SlotDecodeResult(
        success=success, payload=payload, crc=crc_calc,
        crc_extracted=crc_extracted, ldpc_errors=ldpc_errors,
        abs_time=abs_time, abs_freq=abs_freq, score=score,
        candidate_valid=cand_valid,
    )


def _merge_results(res: SlotDecodeResult,
                   retry: SlotDecodeResult) -> SlotDecodeResult:
    """Rows that succeed in `retry` replace their failed originals in `res`
    (candidate coordinates are shared, so decodes are a strict superset)."""
    take = ~res.success & retry.success
    pick = lambda a, b: jnp.where(take, a, b)
    return SlotDecodeResult(
        success=res.success | retry.success,
        payload=jnp.where(take[:, None], retry.payload, res.payload),
        crc=pick(retry.crc, res.crc),
        crc_extracted=pick(retry.crc_extracted, res.crc_extracted),
        ldpc_errors=pick(retry.ldpc_errors, res.ldpc_errors),
        abs_time=res.abs_time, abs_freq=res.abs_freq, score=res.score,
        candidate_valid=res.candidate_valid,
    )


def _mf_llrs(wave: jnp.ndarray, p: WaterfallParams, abs_time: jnp.ndarray,
             abs_freq: jnp.ndarray, is_complex: bool,
             spec=None, refine: bool = False) -> jnp.ndarray:
    """Matched-filter LLRs for candidates at absolute audio coordinates.

    When the block-DFT backend applies (geometry holds AND the DFT-matrix
    size caps of _pick_backend allow it — e.g. 48 kHz exceeds them), the
    boxcar symbol DFTs are assembled from hop-block spectra
    (extract_llrs_matched_blocks — exact decomposition, no windows/pads/
    skinny matmuls; the direct form dominated the deep-mode profile);
    otherwise the direct form runs.  Pass precomputed (spec_re, spec_im)
    hop-block spectra via `spec` to skip recomputing them.

    refine=True routes to the sub-grid (dt, df) offset search
    (ops/llr.py extract_llrs_matched_refined) and returns ITS
    (llrs_base, llrs_refined) tuple — necessarily the direct form, since
    sub-hop/sub-bin offsets do not decompose over hop-block spectra.
    """
    from ..ops.waterfall import _block_spectrum, _pick_backend

    if refine:
        return extract_llrs_matched_refined(
            wave, abs_time, abs_freq, p.nperseg, p.hop, p.freq_osr,
            is_complex)
    if spec is not None:
        return extract_llrs_matched_blocks(
            spec[0], spec[1], abs_time, abs_freq, p.time_osr, p.freq_osr)
    if _pick_backend(p, None) == "block":
        num_frames = p.num_frames(wave.shape[0])
        if is_complex:
            rr, ri = _block_spectrum(wave[..., 0], p, num_frames)
            ir, ii = _block_spectrum(wave[..., 1], p, num_frames)
            spec_re, spec_im = rr - ii, ri + ir
        else:
            spec_re, spec_im = _block_spectrum(wave, p, num_frames)
        return extract_llrs_matched_blocks(
            spec_re, spec_im, abs_time, abs_freq, p.time_osr, p.freq_osr)
    return extract_llrs_matched(
        wave, abs_time, abs_freq, p.nperseg, p.hop, p.freq_osr,
        is_complex)


@functools.partial(jax.jit, static_argnames=(
    "g", "p", "max_candidates", "max_iterations", "use_osd", "is_complex",
    "mf_refine"))
def decode_waterfall_mf(mag: jnp.ndarray, wave: jnp.ndarray,
                        p: WaterfallParams, g: SearchGrid,
                        t0_hops, f0_rows, max_candidates: int,
                        min_score: float, max_iterations: int = 20,
                        use_osd: bool = False,
                        is_complex: bool = False,
                        spec=None,
                        mf_refine: bool = False) -> SlotDecodeResult:
    """MF-first decode: candidates from the (possibly cropped) waterfall,
    every candidate decoded straight from matched-filter LLRs in a single
    BP(+OSD) pass — no Hann-LLR decode (measured yield-identical at the
    sensitivity cliff and ~2x cheaper; crowded-band caveat in
    docs/DESIGN_NOTES.md).  `spec` optionally carries the already-computed
    (spec_re, spec_im) hop-block spectra of the UNCROPPED wave.
    mf_refine adds the sub-grid offset search (ops/llr.py): the base
    offset-(0,0) LLRs decode first and refined-offset LLRs retry the
    failures — a strict superset of the unrefined decode."""
    scores = sync_scores(mag, g)
    abs_time, abs_freq, score, cand_valid = find_candidates(
        scores, g, max_candidates, min_score)
    llrs = _mf_llrs(wave, p, abs_time + jnp.int32(t0_hops),
                    abs_freq + jnp.int32(f0_rows), is_complex, spec,
                    mf_refine)
    if mf_refine:
        base, refined = llrs
        res = finish_decode(base, abs_time, abs_freq, score, cand_valid,
                            max_iterations, use_osd)
        return _merge_results(res, finish_decode(
            refined, abs_time, abs_freq, score, cand_valid,
            max_iterations, use_osd))
    return finish_decode(llrs, abs_time, abs_freq, score, cand_valid,
                         max_iterations, use_osd)


@functools.partial(jax.jit, static_argnames=(
    "p", "max_iterations", "use_osd", "is_complex", "mf_refine"))
def mf_retry(wave: jnp.ndarray, p: WaterfallParams, res: SlotDecodeResult,
             t0_hops, f0_rows, max_iterations: int = 20,
             use_osd: bool = False,
             is_complex: bool = False,
             mf_refine: bool = False) -> SlotDecodeResult:
    """Matched-filter second chance for candidates BP(+OSD) could not crack.

    Re-extracts each candidate's LLRs straight from the audio with boxcar
    symbol-aligned DFTs (ops/llr.py extract_llrs_matched, ~+1.3 dB over the
    Hann waterfall reads) and re-runs the decode; rows that now succeed
    replace their failed originals.  Decodes are a strict superset of the
    first pass.  t0_hops/f0_rows translate crop-relative candidate indices
    back to absolute audio coordinates.  mf_refine chains a second retry
    with sub-grid-offset LLRs (strict superset again).
    """
    llrs = _mf_llrs(wave, p, res.abs_time + jnp.int32(t0_hops),
                    res.abs_freq + jnp.int32(f0_rows), is_complex,
                    refine=mf_refine)
    variants = llrs if mf_refine else (llrs,)
    for v in variants:
        res = _merge_results(res, finish_decode(
            v, res.abs_time, res.abs_freq, res.score,
            res.candidate_valid, max_iterations, use_osd))
    return res


@functools.partial(jax.jit, static_argnames=(
    "p", "num_frames", "max_candidates", "max_iterations", "is_complex",
    "use_osd", "use_mf", "mf_first", "mf_refine", "coherent"))
def decode_slot(wave: jnp.ndarray, p: WaterfallParams, num_frames: int,
                max_candidates: int = 20, min_score: float = 10.0,
                max_iterations: int = 20,
                is_complex: bool = False,
                use_osd: bool = False,
                use_mf: bool = False,
                mf_first: bool = False,
                mf_refine: bool = False,
                coherent: bool = False) -> SlotDecodeResult:
    """Audio (n,) real — or (n, 2) [re, im] — -> SlotDecodeResult.

    The single-chip flagship entry point: one jit containing STFT, search
    and decode.  Batch with vmap over a leading axis; shard with pjit.
    use_mf adds the matched-filter LLR retry (beyond the reference).

    mf_first (implies MF) decodes every candidate straight from
    matched-filter LLRs in a SINGLE BP(+OSD) pass instead of Hann-LLR
    decode + MF retry.  For real input on the block-DFT backend the
    hop-block spectra are computed once and feed both the dB waterfall
    (sync/search) and the matched-filter LLRs (_front_slot_tf); other
    inputs route through decode_waterfall_mf (same single-pass
    semantics).

    mf_refine layers the sub-grid (dt, df) offset search over whichever
    MF stage runs (ops/llr.py extract_llrs_matched_refined) — recovers
    the boxcar's off-grid quantisation loss (up to ~3 dB at grid-cell
    corners) on real-world signals.
    """
    from ..ops.waterfall import _pick_backend

    g = search_grid(p.num_freq_bins, num_frames, p.time_osr, p.freq_osr)
    res = None
    if not is_complex and _pick_backend(p, None) == "block" \
            and not (mf_first and mf_refine):
        # time-major fast path: the waterfall's native (T, F) layout is
        # kept through sync -> top-k -> LLRs (frequency = minor axis) —
        # every stage bit-identical to the (F, T) pipeline,
        # tests/test_tf_layout.py
        llrs, abs_time, abs_freq, score, cand_valid = _front_slot_tf(
            wave, p, num_frames, g, max_candidates, min_score, mf_first)
        res = finish_decode(llrs, abs_time, abs_freq, score, cand_valid,
                            max_iterations, use_osd)
        if not mf_first and use_mf:
            res = mf_retry(wave, p, res, 0, 0, max_iterations,
                           use_osd, is_complex, mf_refine)
    else:
        if is_complex:
            mag = waterfall_complex(wave, p, num_frames)
        else:
            mag = waterfall_real(wave, p, num_frames)
        if mf_first:
            res = decode_waterfall_mf(mag, wave, p, g, 0, 0,
                                      max_candidates, min_score,
                                      max_iterations, use_osd, is_complex,
                                      mf_refine=mf_refine)
        else:
            res = decode_waterfall(mag, g, max_candidates, min_score,
                                   max_iterations, use_osd)
            if use_mf:
                res = mf_retry(wave, p, res, 0, 0, max_iterations,
                               use_osd, is_complex, mf_refine)
    if coherent:
        res = coherent_retry(wave, p, res, 0, 0, max_iterations, use_osd,
                             is_complex)
    return res


def _front_slot_tf(wave: jnp.ndarray, p: WaterfallParams, num_frames: int,
                   g: SearchGrid, max_candidates: int, min_score: float,
                   mf_first: bool = False):
    """One slot's decode front half on the time-major fast path:
    spectra -> dB grid -> sync -> top-K -> LLRs (no BP).

    mf_first takes matched-filter LLRs instead of Hann-waterfall reads,
    from the boxcar power grid or the raw block spectra as the
    FT8_MF_FRONT knob says (utils/backend.py).  Both grids derive from
    the one block spectrum, so XLA can emit them from one fusion: the
    boxcar symbol DFT at window start t0 IS the Hann combine's value
    before the 3-tap stencil (ops/waterfall.py _block_boxcar_tf).
    """
    from ..ops.llr import extract_llrs_matched_grid
    from ..ops.waterfall import (_block_boxcar_tf, _block_spectrum,
                                 _block_waterfall_tf)

    spec = _block_spectrum(wave, p, num_frames)
    mag_tf = _block_waterfall_tf(spec, p, num_frames)
    scores = sync_scores_tf(mag_tf, g)
    abs_time, abs_freq, score, cand_valid = find_candidates_tf(
        scores, g, max_candidates, min_score)
    if not mf_first:
        llrs = extract_llrs_tf(mag_tf, abs_time, abs_freq, g.time_osr,
                               g.freq_osr, g.num_blocks)
    elif knob("FT8_MF_FRONT") == "grid":
        llrs = extract_llrs_matched_grid(
            _block_boxcar_tf(spec, p, num_frames), abs_time, abs_freq,
            g.time_osr, g.freq_osr)
    else:
        llrs = extract_llrs_matched_blocks(
            spec[0], spec[1], abs_time, abs_freq, g.time_osr, g.freq_osr)
    return llrs, abs_time, abs_freq, score, cand_valid


@functools.partial(jax.jit, static_argnames=(
    "p", "num_frames", "max_candidates", "max_iterations", "use_osd",
    "mf_first", "chunk", "bp_chunk"))
def decode_slots(waves: jnp.ndarray, p: WaterfallParams, num_frames: int,
                 max_candidates: int = 20, min_score: float = 10.0,
                 max_iterations: int = 20, use_osd: bool = False,
                 mf_first: bool = False,
                 chunk: int = 16, bp_chunk: int = 256) -> SlotDecodeResult:
    """Batched real audio (B, n) -> SlotDecodeResult with (B, K) rows.

    Decode-identical to ``vmap(decode_slot)`` over the batch, but
    structured for single-chip throughput (the bench.py shape):

    * the front half (STFT -> sync -> top-K -> LLRs) runs in vmap-CHUNK
      pieces under one ``lax.map`` — XLA's fusions for the stencil and
      selection stages are markedly better at small widths;
    * LDPC BP + CRC run over groups of `bp_chunk` slots (bp_chunk * K
      candidate rows at once).  BP's routing matmuls want many rows,
      but the while-loop's all-halted early exit waits for the SLOWEST
      row in the group, so a wider group also pays more iterations.
      The chunk sizes are inherited defaults, not yet tuned on the
      GPU.

    Falls back to chunked ``vmap(decode_slot)`` when the block fast
    path does not apply (non-block STFT geometry).  B must be a
    multiple of `chunk` (pick chunk=1 for odd batches); `bp_chunk`
    is clamped to B and rounded down to a divisor of B.
    """
    from ..ops.waterfall import _pick_backend

    b = waves.shape[0]
    if b % chunk:
        raise ValueError(f"batch {b} not a multiple of chunk {chunk}")
    chunked = waves.reshape(-1, chunk, waves.shape[-1])
    if _pick_backend(p, None) != "block":
        res = jax.lax.map(
            jax.vmap(lambda w: decode_slot(
                w, p, num_frames, max_candidates, min_score,
                max_iterations, use_osd=use_osd, mf_first=mf_first)),
            chunked)
        return jax.tree_util.tree_map(
            lambda x: x.reshape(b, *x.shape[2:]), res)

    g = search_grid(p.num_freq_bins, num_frames, p.time_osr, p.freq_osr)
    llrs, abs_time, abs_freq, score, cand_valid = jax.lax.map(
        jax.vmap(lambda w: _front_slot_tf(
            w, p, num_frames, g, max_candidates, min_score, mf_first)),
        chunked)

    bp_chunk = min(bp_chunk, b)
    while b % bp_chunk:
        bp_chunk -= 1
    rows = bp_chunk * max_candidates
    grp = lambda a: a.reshape(b // bp_chunk, rows, *a.shape[3:])
    res = jax.lax.map(
        lambda t: finish_decode(*t, max_iterations, use_osd),
        (llrs.reshape(b // bp_chunk, rows, C.LDPC_N), grp(abs_time),
         grp(abs_freq), grp(score), grp(cand_valid)))
    return jax.tree_util.tree_map(
        lambda x: x.reshape(b, max_candidates, *x.shape[2:]), res)


@functools.partial(jax.jit, static_argnames=(
    "p", "max_iterations", "use_osd", "is_complex", "num_branches"))
def coherent_retry(wave: jnp.ndarray, p: WaterfallParams,
                   res: SlotDecodeResult, t0_hops, f0_rows,
                   max_iterations: int = 20, use_osd: bool = False,
                   is_complex: bool = False,
                   num_branches: int = 5) -> SlotDecodeResult:
    """Coherent matched-filter retry (beyond the reference).

    FT8's integer modulation index makes the whole transmission's complex
    symbol correlations share one carrier phase track; projecting onto
    the track estimated from the 21 Costas cells halves the detection
    noise (ops/llr.py extract_llrs_coherent).  The track's frequency has
    a 1/(36 T) branch ambiguity, so B branch variants decode as one
    (B*K) batch and BP + CRC pick each candidate's first valid branch —
    the same arbitration pattern as ap_retry.  The built-in (dt, df)
    search covers the full candidate-grid quantisation cell, so this
    retry needs no mf_refine before it.  Measured (random off-grid
    placement, fs 2 kHz): 50 %-yield ~-17.2 dB vs -15.5 for the refined
    noncoherent path (docs/DESIGN_NOTES.md); 0 false accepts over noise.
    """
    llrs = extract_llrs_coherent(
        wave, res.abs_time + jnp.int32(t0_hops),
        res.abs_freq + jnp.int32(f0_rows), p.nperseg, p.hop, p.freq_osr,
        is_complex, num_branches)
    return _merge_results(res, variant_retry(llrs, res, max_iterations,
                                             use_osd))


def variant_retry(llrs: jnp.ndarray, res: SlotDecodeResult,
                  max_iterations: int, use_osd: bool) -> SlotDecodeResult:
    """(B, K, 174) LLR variants -> per-candidate first valid decode.

    Shared trace-level core of the CRC-arbitrated retries (coherent df
    branches, stacked coherent): all B*K rows run one BP(+OSD) batch and
    each candidate takes its FIRST validating variant.  Merge into an
    existing result with _merge_results.
    """
    b, k = llrs.shape[0], llrs.shape[1]
    rep = lambda a: jnp.tile(a, (b,) + (1,) * (a.ndim - 1)) \
        if a.ndim > 1 else jnp.tile(a, b)
    sub = finish_decode(llrs.reshape(b * k, C.LDPC_N),
                        rep(res.abs_time), rep(res.abs_freq),
                        rep(res.score), rep(res.candidate_valid),
                        max_iterations, use_osd)
    succ = sub.success.reshape(b, k)
    pick = jnp.argmax(succ, axis=0)
    idx = pick * k + jnp.arange(k)
    return SlotDecodeResult(
        success=jnp.any(succ, axis=0),
        payload=sub.payload[idx], crc=sub.crc[idx],
        crc_extracted=sub.crc_extracted[idx],
        ldpc_errors=sub.ldpc_errors[idx],
        abs_time=res.abs_time, abs_freq=res.abs_freq, score=res.score,
        candidate_valid=res.candidate_valid,
    )


@functools.partial(jax.jit, static_argnames=(
    "p", "max_iterations", "use_osd", "is_complex", "num_branches"))
def ap_coherent_retry(wave: jnp.ndarray, p: WaterfallParams,
                      res: SlotDecodeResult, t0_hops, f0_rows,
                      ap_values: jnp.ndarray, ap_mask: jnp.ndarray,
                      max_iterations: int = 20, use_osd: bool = False,
                      is_complex: bool = False,
                      num_branches: int = 5) -> SlotDecodeResult:
    """The two deepest decoders composed: a-priori bit clamping applied
    to every coherent phase-track branch variant.

    (B branches x V hypotheses x K candidates) decode as one batch;
    the CRC still covers every payload bit, so the composition keeps the
    zero-false-accept property of both parents.  Measured ~+1 dB past
    coherent alone at the off-grid cliff for CQ traffic
    (docs/DESIGN_NOTES.md).
    """
    cllrs = extract_llrs_coherent(
        wave, res.abs_time + jnp.int32(t0_hops),
        res.abs_freq + jnp.int32(f0_rows), p.nperseg, p.hop, p.freq_osr,
        is_complex, num_branches)                       # (B, K, 174)
    b, k = cllrs.shape[0], cllrs.shape[1]
    v = ap_values.shape[0]
    clamp = (2.0 * ap_values.astype(jnp.float32) - 1.0) * 100.0
    pad = ((0, 0), (0, C.LDPC_N - C.PAYLOAD_BITS))
    clamp = jnp.pad(clamp, pad)
    mask = jnp.pad(ap_mask.astype(bool), pad)
    clamped = jnp.where(mask[None, :, None, :], clamp[None, :, None, :],
                        cllrs[:, None, :, :])           # (B, V, K, 174)
    return _merge_results(res, variant_retry(
        clamped.reshape(b * v, k, C.LDPC_N), res, max_iterations, use_osd))


def ap_arrays(ap) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Host `ap` argument (True / "MYCALL" / "MYCALL DXCALL") -> device
    (values, mask) hypothesis arrays.  Shared by decode_ft8_message and
    decode_ft8_stacked so the string syntax cannot diverge."""
    from ..protocol.message import ap_hypotheses

    calls = [] if ap is True else str(ap).upper().split()
    if len(calls) > 2:
        raise ValueError("ap accepts at most 'MYCALL DXCALL'")
    vals, msk = ap_hypotheses(*calls)
    return jnp.asarray(vals), jnp.asarray(msk)


@functools.partial(jax.jit, static_argnames=(
    "p", "max_iterations", "use_osd", "is_complex"))
def ap_retry(wave: jnp.ndarray, p: WaterfallParams, res: SlotDecodeResult,
             t0_hops, f0_rows, ap_values: jnp.ndarray, ap_mask: jnp.ndarray,
             max_iterations: int = 20, use_osd: bool = False,
             is_complex: bool = False) -> SlotDecodeResult:
    """A-priori retry (beyond the reference, WSJT-X-style AP decoding).

    For candidates the normal decode could not crack, re-extract
    matched-filter LLRs and clamp the payload bits each hypothesis fixes
    (protocol.message.ap_hypotheses: CQ / MyCall / MyCall+DxCall /
    exchange variants) to +-AP_BIG, then re-run BP(+OSD) + CRC.  All V
    hypotheses decode as one (V*K) batch; each candidate takes its FIRST
    successful variant (most-general-first order).  Decodes are a strict
    superset of the input result; the CRC still covers all 77 bits, so a
    wrong hypothesis cannot validate (measured 0 false accepts over 1000
    noise slots, tests/test_ap.py).
    """
    llrs = _mf_llrs(wave, p, res.abs_time + jnp.int32(t0_hops),
                    res.abs_freq + jnp.int32(f0_rows), is_complex)
    return _merge_results(res, ap_retry_llrs(llrs, res, ap_values, ap_mask,
                                             max_iterations, use_osd))


def ap_retry_llrs(llrs: jnp.ndarray, res: SlotDecodeResult,
                  ap_values: jnp.ndarray, ap_mask: jnp.ndarray,
                  max_iterations: int, use_osd: bool) -> SlotDecodeResult:
    """(K, 174) LLRs + V hypotheses -> per-candidate best AP decode.

    Trace-level core shared by ap_retry and the stacked decoder: clamp
    each hypothesis's payload bits to +-100, decode all V*K rows in one
    BP(+OSD) batch, and take each candidate's FIRST validating variant.
    Merge into an existing result with _merge_results.
    """
    k = res.abs_time.shape[0]
    v = ap_values.shape[0]
    clamp = (2.0 * ap_values.astype(jnp.float32) - 1.0) * 100.0   # (V, 77)
    pad = ((0, 0), (0, C.LDPC_N - C.PAYLOAD_BITS))
    clamp = jnp.pad(clamp, pad)
    mask = jnp.pad(ap_mask.astype(bool), pad)
    clamped = jnp.where(mask[:, None, :], clamp[:, None, :], llrs[None])
    rep = lambda a: jnp.tile(a, (v,) + (1,) * (a.ndim - 1)) \
        if a.ndim > 1 else jnp.tile(a, v)
    sub = finish_decode(clamped.reshape(v * k, C.LDPC_N),
                        rep(res.abs_time), rep(res.abs_freq),
                        rep(res.score), rep(res.candidate_valid),
                        max_iterations, use_osd)
    succ = sub.success.reshape(v, k)
    pick = jnp.argmax(succ, axis=0)               # first successful variant
    idx = pick * k + jnp.arange(k)
    return SlotDecodeResult(
        success=jnp.any(succ, axis=0),
        payload=sub.payload[idx], crc=sub.crc[idx],
        crc_extracted=sub.crc_extracted[idx],
        ldpc_errors=sub.ldpc_errors[idx],
        abs_time=res.abs_time, abs_freq=res.abs_freq, score=res.score,
        candidate_valid=res.candidate_valid,
    )


@functools.partial(jax.jit, static_argnames=("time_osr", "freq_osr",
                                             "stack_r", "valid_frames"))
def estimate_snr(mag: jnp.ndarray, payload: jnp.ndarray,
                 abs_time: jnp.ndarray, abs_freq: jnp.ndarray,
                 time_osr: int, freq_osr: int,
                 stack_r: int = 1,
                 valid_frames: int | None = None) -> jnp.ndarray:
    """(K,) per-decode SNR estimates in dB re 2500 Hz noise bandwidth.

    Beyond the reference (which reports only the sync score): every FT8
    tool reports decode SNR in the WSJT-X 2500-Hz convention, so decodes
    are comparable across receivers.  The decoded payload is re-encoded to
    its 79-tone track on-device; the estimate is the on-track mean cell
    power against the GLOBAL waterfall noise floor:

        r = mean(P_on) / noise_hat          (on-cell holds signal + noise)
        SNR_2500 = (r - 1) * 6 * 6.25 / 1e4

    The constant is exact for a Hann window: signal-vs-noise-per-bin gain
    is (sum w)^2 / (4 sum w^2) = nperseg/6 for real input, and converting
    noise-per-bin to N0*2500 multiplies by fs/(2*2500) — the fs factors
    cancel, leaving 6/(0.16*1e4) = 3.75e-3.  The complex case (noise over
    fs, signal gain nperseg/1.5) lands on the SAME constant.

    noise_hat is NOT the off-tone mean near the signal: GFSK spectral
    spill raises every cell in the 8-tone block with the signal, capping
    a local contrast near 11 dB (measured — even the off-tone median
    reads 1.4-1.8x high).  Instead the noise floor comes from the WHOLE
    waterfall: the global median cell power /ln2 (exact mean estimator
    for exponential cell powers, sparse-signal robust — the same idea as
    WSJT-X's spectrum-baseline percentile), measured within 0.2 dB of
    the true sigma^2 across SNRs.  Accuracy: ~±1 dB against injected
    SNRs (tests/test_decode.py::test_snr_estimate_calibration); crowded
    bands raise the baseline slightly, reading every decode a little
    low.

    stack_r: when mag is the MEAN linear power over R stacked repeats
    (demod/stack.py), its cells follow Gamma(R)/R and the median-to-mean
    correction becomes the Wilson-Hilferty (1 - 1/(9R))^3 (R=1 gives
    0.702 ~= ln2); the reported SNR is then the PER-REPEAT SNR (linear
    averaging changes cell variance, not cell means).

    valid_frames: frames past this bound are zero padding, not capture
    (StreamSession's flush block) — they are excluded from both the
    noise-floor median and the on-track mean, else the padded zeros
    drag the floor down and the SNR reads several dB high (measured
    +8.7 dB on a 45 %-padded flush block).
    """
    num_freqs, num_frames = mag.shape
    if valid_frames is None:
        valid_frames = num_frames
    tones = encode_tones(payload).astype(jnp.int32)       # (K, 79)
    sym = jnp.arange(C.NUM_SYMBOLS)
    f_idx = abs_freq[:, None, None] + jnp.arange(8)[None, None, :] * freq_osr
    t_idx = abs_time[:, None, None] + sym[None, :, None] * time_osr
    valid = (t_idx[..., 0] >= 0) & (t_idx[..., 0] < valid_frames) \
        & (f_idx[:, 0, 7] < num_freqs)[:, None]           # (K, 79)
    fc = jnp.clip(f_idx, 0, num_freqs - 1)
    tc = jnp.clip(t_idx, 0, num_frames - 1)
    win = mag[fc, tc]                                     # (K, 79, 8) dB
    on_db = jnp.take_along_axis(win, tones[:, :, None], axis=2)[..., 0]
    on = 10.0 ** (on_db / 10.0)
    w = valid.astype(jnp.float32)
    n = jnp.maximum(jnp.sum(w, axis=-1), 1.0)
    s_hat = jnp.sum(on * w, axis=-1) / n                  # (K,)
    # global noise floor: median over the dB grid == dB of the median
    # cell power (monotone map); Wilson-Hilferty median->mean correction
    # for the mean-of-stack_r-exponentials cell distribution
    med_over_mean = (1.0 - 1.0 / (9.0 * stack_r)) ** 3
    noise_hat = 10.0 ** (jnp.median(mag[:, :valid_frames]) / 10.0) \
        / med_over_mean
    r = s_hat / jnp.maximum(noise_hat, 1e-30)
    return 10.0 * jnp.log10(jnp.maximum(r - 1.0, 1e-6) * 3.75e-3)


def _format_results(res: SlotDecodeResult, hop_seconds: float,
                    freq_step_hz: float, time_base: float, freq_base: float,
                    deduplicate: bool, snr_db=None,
                    min_snr_db: float | None = None) -> list[FT8Decode]:
    """Convert the fixed-shape device result into host FT8Decode rows.

    min_snr_db: physical-plausibility gate on the estimated SNR.  The
    deepest REAL single-transmission decode measures ≈ −18 dB (full-QSO
    AP at the coherent cliff), while the rare CRC-lucky false accepts
    the maximal retry stack produces on pure noise measure ≈ −29/−31 dB
    (2 in 200 noise slots × ~10^3 hypothesis decodes each) — an
    estimated SNR far below anything decodable flags a false accept,
    not a weak signal.

    Reported SNR is clamped to the WSJT-X plausible range [-30, +30] dB:
    the estimator is arithmetically unbounded (a clean loopback capture
    reads +88 dB), but no real FT8 report exceeds ~+30, and downstream
    consumers (logs, PSK Reporter-style aggregation) treat the field as a
    WSJT-X-convention report.  +30.0 therefore means ">= +30".
    """
    res = jax.tree_util.tree_map(np.asarray, res)
    if snr_db is not None:
        snr_db = np.asarray(snr_db)
    out: list[FT8Decode] = []
    seen: set[bytes] = set()
    for k in range(res.success.shape[0]):
        if not bool(res.success[k]):
            continue
        if snr_db is not None and min_snr_db is not None \
                and float(snr_db[k]) < min_snr_db:
            continue
        h = int(res.crc[k])
        payload = bytes(res.payload[k].tolist())
        if deduplicate:
            # key on the full 10-byte payload, not the 14-bit CRC: distinct
            # messages colliding on CRC-14 must both be reported
            if payload in seen:
                continue
            seen.add(payload)
        msg = FT8Message(payload=payload, hash=h)
        status = FT8DecodeStatus(
            ldpc_errors=int(res.ldpc_errors[k]),
            crc_extracted=int(res.crc_extracted[k]),
            crc_calculated=int(res.crc[k]),
        )
        out.append(FT8Decode(
            message=msg, status=status,
            time_sec=time_base + float(res.abs_time[k]) * hop_seconds,
            freq_hz=freq_base + float(res.abs_freq[k]) * freq_step_hz,
            score=float(res.score[k]),
            snr_db=None if snr_db is None else
            round(min(max(float(snr_db[k]), -30.0), 30.0), 1),
        ))
    return out


@functools.partial(jax.jit, static_argnames=("p", "num_frames"))
def _block_spec_and_mag(wave: jnp.ndarray, p: WaterfallParams,
                        num_frames: int):
    """Hop-block spectra + the dB waterfall derived from them, one jit."""
    from ..ops.waterfall import _block_spectrum, _block_waterfall

    spec = _block_spectrum(wave, p, num_frames)
    return spec, _block_waterfall(spec, p, num_frames)


def _refine_rows(rows: list[FT8Decode], wave, sample_rate: float,
                 freq_step: float) -> list[FT8Decode]:
    """Replace each decoded row's grid-quantised (time, freq) with a
    coherent known-payload fix (beacon.track_known_payload seeded by the
    decode itself): sub-Hz frequency and sample-level time instead of the
    candidate cell.

    The candidate frequency can sit up to ~2 cells off (the sync
    stencil's contrast peaks on the ±2-sub-bin sidelobes of a strong
    tone), but the tracker's df ramp models only FRACTIONAL-cycle/symbol
    offsets — a hint ≥ 1 cell off kills its within-symbol correlations,
    and simply widening the df box inflates the noise maximum past the
    detection threshold at junk offsets (measured: a +2-cell candidate
    "refined" to the sidelobe, 6.25 Hz off).  So each row tries the FIVE
    integer-cell hint shifts with a tight per-shift box (±half cell +
    0.6 Hz, inside the fractional-model validity) and keeps the
    strongest detected fix.  Rows where no shift clears the threshold
    keep their original (already CRC-valid) coordinates."""
    import dataclasses

    from ..beacon.detect import track_known_payload

    tol = 0.5 * freq_step + 0.6
    out = []
    for r in rows:
        payload = np.frombuffer(r.message.payload, np.uint8)
        best = None
        for shift in (0, -1, 1, -2, 2):
            fix = track_known_payload(
                wave, sample_rate, payload,
                time_hint_s=r.time_sec,
                freq_hint_hz=r.freq_hz + shift * freq_step,
                freq_tolerance_hz=tol)
            if fix.detected and (best is None or fix.stat > best.stat):
                best = fix
        if best is not None:
            r = dataclasses.replace(r, time_sec=best.time_sec,
                                    freq_hz=best.freq_hz)
        out.append(r)
    return out


def decode_ft8_message(wave_data, sample_rate: float,
                       bins_per_tone: int = 2, steps_per_symbol: int = 2,
                       max_candidates: int = 20, min_score: float = 10.0,
                       max_iterations: int = 20,
                       freq_min: float | None = None,
                       freq_max: float | None = None,
                       time_min: float | None = None,
                       time_max: float | None = None,
                       deduplicate: bool = True,
                       return_metrics: bool = False,
                       passes: int = 1,
                       use_osd: bool = False,
                       use_mf: bool = False,
                       mf_first: bool = False,
                       mf_refine: bool = False,
                       ap: bool | str = False,
                       coherent: bool = False,
                       min_plausible_snr_db: float | None = -26.0,
                       refine_fixes: bool = False):
    """Decode all FT8 messages in an audio capture (host API).

    Mirrors the reference decode_ft8_message (ft8_decode.py:288) with two
    deliberate fixes: reported time/frequency are true physical units even
    when a crop is applied (the reference reports crop-relative frequency
    and divides a waterfall index by the audio rate, ft8_decode.py:387-388),
    and duplicate decodes of one message are merged unless
    deduplicate=False.

    With return_metrics=True the SlotMetrics cover the FIRST pass only
    (they summarise one fixed-shape slot decode); rows include all passes.

    use_mf=True adds the matched-filter LLR retry (beyond the reference,
    ~+1.3 dB at the sensitivity cliff; see ops/llr.py
    extract_llrs_matched): candidates the Hann-waterfall LLRs cannot
    decode are re-extracted with boxcar symbol-aligned DFTs.  Decodes are
    a strict superset of the reference-parity first pass.

    mf_first=True (implies MF; use_mf need not be set) decodes every
    candidate straight from matched-filter LLRs in a single BP(+OSD) pass
    instead of Hann-LLR decode + retry — measured yield-identical at the
    sensitivity cliff and several times cheaper (see docs/DESIGN_NOTES.md
    for the crowded-band comparison).

    mf_refine=True layers a per-candidate sub-grid (dt, df) offset search
    over the matched-filter extraction (ops/llr.py
    extract_llrs_matched_refined): the candidate grid quantises time to
    ~1/4 symbol and frequency to half a bin, costing off-grid signals up
    to ~3 dB of boxcar detection SNR at the cell corners.

    coherent=True adds the coherent matched-filter retry (beyond the
    reference; the deepest single-transmission decoder in the package):
    failed candidates re-decode from complex symbol correlations
    projected onto the transmission's common carrier-phase track (FT8's
    modulation index is exactly 1), with BP+CRC arbitrating the track's
    frequency-branch ambiguity.  ~+1.7 dB over the refined noncoherent
    path at the off-grid 50 %-yield point; includes its own (dt, df)
    search, so it does not need mf_refine.

    ap enables a-priori decoding (beyond the reference, WSJT-X-style):
    candidates the normal decode cannot crack are retried with known
    payload bits clamped in the LDPC decoder.  ap=True tries the
    "CQ ? ?" hypothesis; ap="MYCALL" adds "MYCALL ? ?"; ap="MYCALL
    DXCALL" adds the full-QSO and RRR/RR73/73 exchange hypotheses
    (protocol.message.ap_hypotheses).  Decodes are a strict superset;
    the CRC still covers every payload bit, so a wrong hypothesis
    cannot validate.

    min_plausible_snr_db gates accepted rows on the estimated SNR: the
    deepest real decode measures ≈ −18 dB, so an estimate below −26
    flags a CRC-lucky false accept from the large retry hypothesis
    space (measured ≈ −29/−31 on the 2-in-200-noise-slots the maximal
    coherent+ap stack produces), not a weak signal.  None disables.

    passes > 1 enables subtraction decoding (beyond the reference): after
    each pass, every decoded transmission is re-synthesised, frequency-
    refined, amplitude/phase-fitted and subtracted from the audio, and the
    residual is decoded again — recovering weaker signals hidden under
    strong ones (real audio only).  Messages found by later passes are
    always deduplicated against earlier ones.

    refine_fixes=True replaces each decoded row's grid-quantised
    (time, freq) with a coherent known-payload position fix seeded by the
    decode itself (beacon.track_known_payload): ~0.05 Hz / sub-millisecond
    accuracy instead of the candidate cell (which can report frequency up
    to ~2 cells off).  One extra tracker evaluation per decoded message.
    """
    def _empty():
        if not return_metrics:
            return []
        from ..utils.metrics import SlotMetrics
        return [], SlotMetrics(0, 0, 0, float("-inf"), float("nan"), 0.0)

    wave = np.asarray(wave_data)
    p = waterfall_params(sample_rate, bins_per_tone, steps_per_symbol)
    if wave.shape[-1] < p.nperseg:
        return _empty()
    num_frames = p.num_frames(wave.shape[-1])
    is_complex = bool(np.iscomplexobj(wave))
    if is_complex:
        passes = 1
        wave_d = jnp.asarray(
            np.stack([wave.real, wave.imag], axis=-1).astype(np.float32))
    else:
        wave_d = jnp.asarray(wave.astype(np.float32))
    hop_seconds = C.SYMBOL_PERIOD_S / p.time_osr
    freq_step = C.TONE_SPACING_HZ / p.freq_osr

    ap_vm = ap_arrays(ap) if ap else None

    rows: list[FT8Decode] = []
    seen_payloads: set[bytes] = set()
    first_res = None
    from ..ops.waterfall import _pick_backend
    for pass_idx in range(max(1, passes)):
        spec = None
        if mf_first and not mf_refine and not is_complex \
                and _pick_backend(p, None) == "block":
            # compute the hop-block spectra once per pass: they feed both
            # the dB waterfall and the boxcar matched-filter DFTs
            spec, mag = _block_spec_and_mag(wave_d, p, num_frames)
        elif is_complex:
            mag = waterfall_complex(wave_d, p, num_frames)
        else:
            mag = waterfall_real(wave_d, p, num_frames)

        # frequency / time crops (host-side static slicing keeps the jitted
        # pipeline fixed-shape per crop config)
        freqs = np.arange(p.num_freq_bins) * freq_step
        times = (np.arange(num_frames) * p.hop + p.nperseg / 2) / p.fs
        f_lo = 0
        if freq_min is not None or freq_max is not None:
            fmask = (freqs >= (freq_min if freq_min is not None
                               else freqs[0])) \
                & (freqs <= (freq_max if freq_max is not None else freqs[-1]))
            f_lo = int(np.argmax(fmask))
            f_hi = int(len(fmask) - np.argmax(fmask[::-1]))
            mag = mag[f_lo:f_hi]
        t_lo = 0
        if time_min is not None or time_max is not None:
            tmask = (times >= (time_min if time_min is not None
                               else times[0])) \
                & (times <= (time_max if time_max is not None else times[-1]))
            t_lo = int(np.argmax(tmask))
            t_hi = int(len(tmask) - np.argmax(tmask[::-1]))
            mag = mag[:, t_lo:t_hi]

        g = search_grid(mag.shape[0], mag.shape[1], p.time_osr, p.freq_osr)
        if g.num_times <= 0 or g.num_freqs <= 0:
            if pass_idx == 0:
                return _empty()
            break
        if mf_first:
            res = decode_waterfall_mf(mag, wave_d, p, g, t_lo, f_lo,
                                      max_candidates, float(min_score),
                                      max_iterations, use_osd, is_complex,
                                      spec, mf_refine)
        else:
            res = decode_waterfall(mag, g, max_candidates, float(min_score),
                                   max_iterations, use_osd)
            if use_mf:
                res = mf_retry(wave_d, p, res, t_lo, f_lo, max_iterations,
                               use_osd, is_complex, mf_refine)
        if coherent and ap_vm is None:
            res = coherent_retry(wave_d, p, res, t_lo, f_lo,
                                 max_iterations, use_osd, is_complex)
        if ap_vm is not None:
            # NOTE: re-extracts MF LLRs the mf_first path already computed
            # for these candidates — accepted redundancy: threading llrs
            # out of decode_waterfall_mf would change three jit signatures,
            # and ap is a host-API sensitivity feature, not the hot path
            res = ap_retry(wave_d, p, res, t_lo, f_lo, ap_vm[0], ap_vm[1],
                           max_iterations, use_osd, is_complex)
            if coherent:
                # the two deepest decoders in ONE coherent extraction: a
                # null (unclamped) hypothesis first reproduces the plain
                # coherent retry, then each a-priori hypothesis clamps
                # inside every branch variant
                apv = jnp.concatenate(
                    [jnp.zeros((1, 77), ap_vm[0].dtype), ap_vm[0]])
                apm = jnp.concatenate(
                    [jnp.zeros((1, 77), bool), ap_vm[1].astype(bool)])
                res = ap_coherent_retry(wave_d, p, res, t_lo, f_lo,
                                        apv, apm, max_iterations, use_osd,
                                        is_complex)
        if first_res is None:
            first_res = res
        snr = estimate_snr(mag, res.payload, res.abs_time, res.abs_freq,
                           p.time_osr, p.freq_osr)
        new_rows = _format_results(
            res, hop_seconds, freq_step,
            time_base=t_lo * hop_seconds, freq_base=f_lo * freq_step,
            deduplicate=deduplicate, snr_db=snr,
            min_snr_db=min_plausible_snr_db,
        )
        # later passes always dedup against everything already reported
        for r in new_rows:
            if pass_idx > 0 and r.message.payload in seen_payloads:
                continue
            seen_payloads.add(r.message.payload)
            rows.append(r)

        if pass_idx + 1 < max(1, passes):
            if not bool(np.asarray(res.success).any()):
                break
            from ..ops.subtract import subtract_decoded
            wave_d = subtract_decoded(
                wave_d, p, res.payload,
                res.abs_time + jnp.int32(t_lo),
                res.abs_freq + jnp.int32(f_lo), res.success)

    if refine_fixes and rows:
        rows = _refine_rows(rows, wave, sample_rate, freq_step)
    if not return_metrics:
        return rows
    from ..utils.metrics import summarize_slot
    return rows, summarize_slot(first_res)
