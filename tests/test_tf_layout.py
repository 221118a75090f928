"""Time-major (T, F) fast-path parity: bit-identical to the (F, T) path.

Round 4's throughput work keeps the decode hot path in the waterfall's
native time-major layout (frequency = minor/lane axis) end to end:
_block_waterfall_tf -> sync_scores_tf -> find_candidates_tf ->
extract_llrs_tf.  Every stage must match its (F, T) counterpart
BIT-identically — same adds in the same order, selection matmuls on the
same cells, same top-k tie order — so the layout change can never move a
decode.  (tests run on CPU; tests/test_gpu.py checks the decodes on the
GPU, where DEFAULT matmuls are TF32.)
"""

import numpy as np
import pytest

import jax.numpy as jnp

from ft8_demodulator_tpu.ops.llr import extract_llrs, extract_llrs_tf
from ft8_demodulator_tpu.ops.sync import (find_candidates,
                                          find_candidates_tf, search_grid,
                                          sync_scores, sync_scores_tf)
from ft8_demodulator_tpu.ops.waterfall import (_block_spectrum,
                                               _block_waterfall,
                                               _block_waterfall_tf,
                                               waterfall_params)

FS = 2000.0


def _mag_pair(rng, seconds=15.0):
    p = waterfall_params(FS, 2, 2)
    n = int(FS * seconds)
    wave = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    num_frames = p.num_frames(n)
    spec = _block_spectrum(wave, p, num_frames)
    mag_ft = np.asarray(_block_waterfall(spec, p, num_frames))
    mag_tf = np.asarray(_block_waterfall_tf(spec, p, num_frames))
    g = search_grid(p.num_freq_bins, num_frames, p.time_osr, p.freq_osr)
    return mag_ft, mag_tf, g


def test_block_waterfall_tf_is_transpose(rng):
    mag_ft, mag_tf, _ = _mag_pair(rng)
    np.testing.assert_array_equal(mag_ft, mag_tf.T)


def test_sync_scores_tf_bit_identical(rng):
    mag_ft, mag_tf, g = _mag_pair(rng)
    s_ft = np.asarray(sync_scores(jnp.asarray(mag_ft), g))
    s_tf = np.asarray(sync_scores_tf(jnp.asarray(mag_tf), g))
    np.testing.assert_array_equal(s_ft, s_tf.T)


def test_sync_scores_tf_no_preroll_grid(rng):
    """The non-split branch (t_start == 0, the streaming interior case)."""
    from ft8_demodulator_tpu.ops.sync import SearchGrid

    mag_ft, mag_tf, g = _mag_pair(rng)
    g0 = SearchGrid(g.time_osr, g.freq_osr, g.num_blocks, 0,
                    g.num_times + g.t_start, g.num_freqs)
    s_ft = np.asarray(sync_scores(jnp.asarray(mag_ft), g0))
    s_tf = np.asarray(sync_scores_tf(jnp.asarray(mag_tf), g0))
    np.testing.assert_array_equal(s_ft, s_tf.T)


def test_find_candidates_tf_identical_including_ties(rng):
    mag_ft, mag_tf, g = _mag_pair(rng)
    scores = np.array(sync_scores(jnp.asarray(mag_ft), g))
    # force exact-value ties so tie ORDER is exercised, not just values
    scores[100:104, 10] = 7.25
    scores[200:230, 20:24] = 7.25
    for k, ms in ((20, 1.0), (40, 7.25), (8, -100.0)):
        out_ft = find_candidates(jnp.asarray(scores), g, k, ms)
        out_tf = find_candidates_tf(jnp.asarray(scores.T.copy()), g, k, ms)
        for a, b in zip(out_ft, out_tf):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_find_candidates_tf_small_grid_fallback(rng):
    from ft8_demodulator_tpu.ops.sync import SearchGrid

    g = SearchGrid(2, 2, 10, -4, 16, 24)     # num_freqs <= rows_needed
    scores = rng.standard_normal((24, 16)).astype(np.float32) * 5
    out_ft = find_candidates(jnp.asarray(scores), g, 6, 0.0)
    out_tf = find_candidates_tf(jnp.asarray(scores.T.copy()), g, 6, 0.0)
    for a, b in zip(out_ft, out_tf):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_extract_llrs_tf_bit_identical(rng):
    mag_ft, mag_tf, g = _mag_pair(rng)
    scores = sync_scores(jnp.asarray(mag_ft), g)
    t, f, v, ok = find_candidates(scores, g, 20, 1.0)
    llr_ft = np.asarray(extract_llrs(jnp.asarray(mag_ft), t, f,
                                     g.time_osr, g.freq_osr, g.num_blocks))
    llr_tf = np.asarray(extract_llrs_tf(jnp.asarray(mag_tf), t, f,
                                        g.time_osr, g.freq_osr,
                                        g.num_blocks))
    np.testing.assert_array_equal(llr_ft, llr_tf)


def test_decode_slot_unchanged_by_tf_path(rng):
    """End-to-end: decode_slot still decodes a planted signal and reports
    identical candidate/payload rows to the explicit (F, T) pipeline."""
    from ft8_demodulator_tpu.demod.decode import (decode_slot,
                                                  decode_waterfall)
    from ft8_demodulator_tpu.ops.gfsk import ft8_passband
    from ft8_demodulator_tpu.ops.waterfall import waterfall_real

    payload = np.array([0x1C, 0x3F, 0x8A, 0x6A, 0xE2, 0x07, 0xA1, 0xE3,
                        0x94, 0x50], np.uint8)
    p = waterfall_params(FS, 2, 2)
    n = int(FS * 15)
    w = np.zeros(n, np.float32)
    sig = np.asarray(ft8_passband(payload, FS, 400.0, 0.0))
    w[800: 800 + len(sig)] = sig
    w += 0.05 * rng.standard_normal(n).astype(np.float32)
    num_frames = p.num_frames(n)

    res = decode_slot(jnp.asarray(w), p, num_frames, max_candidates=10,
                      min_score=1.0)
    mag = waterfall_real(jnp.asarray(w), p, num_frames)
    g = search_grid(p.num_freq_bins, num_frames, p.time_osr, p.freq_osr)
    ref = decode_waterfall(mag, g, 10, 1.0)
    np.testing.assert_array_equal(np.asarray(res.success),
                                  np.asarray(ref.success))
    np.testing.assert_array_equal(np.asarray(res.payload),
                                  np.asarray(ref.payload))
    np.testing.assert_array_equal(np.asarray(res.abs_time),
                                  np.asarray(ref.abs_time))
    np.testing.assert_array_equal(np.asarray(res.score),
                                  np.asarray(ref.score))
    assert np.asarray(res.success).any()
    ok_rows = np.asarray(res.payload)[np.asarray(res.success)]
    assert any((row == payload).all() for row in ok_rows)


# ---------------------------------------------------------------------------
# MXU recast of the sync stencil (FT8_SYNC_BACKEND=mxu)
# ---------------------------------------------------------------------------

def test_sync_scores_tf_mxu_allclose(rng):
    """The stencil-as-matmul scores match the stencil to accumulation-order
    tolerance, with identical -inf (no-valid-comparison) masks."""
    from ft8_demodulator_tpu.ops.sync import sync_scores_tf_mxu

    _, mag_tf, g = _mag_pair(rng)
    a = np.asarray(sync_scores_tf(jnp.asarray(mag_tf), g))
    b = np.asarray(sync_scores_tf_mxu(jnp.asarray(mag_tf), g))
    np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b))
    fin = np.isfinite(a)
    np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=1e-4)


def test_sync_scores_tf_mxu_deep_geometry(rng):
    """osr 4x4 (the DEEP preset): 4 residue matmuls instead of 2."""
    from ft8_demodulator_tpu.ops.sync import sync_scores_tf_mxu

    p = waterfall_params(FS, 4, 4)
    n = int(FS * 15.0)
    wave = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    num_frames = p.num_frames(n)
    spec = _block_spectrum(wave, p, num_frames)
    mag_tf = jnp.asarray(_block_waterfall_tf(spec, p, num_frames))
    g = search_grid(p.num_freq_bins, num_frames, p.time_osr, p.freq_osr)
    a = np.asarray(sync_scores_tf(mag_tf, g))
    b = np.asarray(sync_scores_tf_mxu(mag_tf, g))
    np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b))
    fin = np.isfinite(a)
    np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=1e-4)


def test_sync_mxu_decode_set_identical(rng):
    """Planted-signal decode sets through the full front half are identical
    under either sync backend (CPU: both run exact f32, so only summation
    order differs; the chip-side bf16 evidence is the precision-mask
    harness, benchmarks/precision_masks.py --sync-arms)."""
    from ft8_demodulator_tpu.demod.decode import finish_decode
    from ft8_demodulator_tpu.ops.gfsk import ft8_passband
    from ft8_demodulator_tpu.ops.llr import extract_llrs_tf
    from ft8_demodulator_tpu.ops.sync import (find_candidates_tf,
                                              sync_scores_tf_mxu)

    p = waterfall_params(FS, 2, 2)
    n = int(FS * 15)
    num_frames = p.num_frames(n)
    g = search_grid(p.num_freq_bins, num_frames, p.time_osr, p.freq_osr)

    decoded = {"stencil": set(), "mxu": set()}
    for trial in range(4):
        payload = np.asarray(rng.integers(0, 256, 10), np.uint8)
        payload[9] &= 0xF8
        w = np.zeros(n, np.float32)
        sig = np.asarray(ft8_passband(payload, FS, 320.0 + 60.0 * trial,
                                      0.0))
        w[400: 400 + len(sig)] = sig
        w += 0.35 * rng.standard_normal(n).astype(np.float32)
        spec = _block_spectrum(jnp.asarray(w), p, num_frames)
        mag_tf = _block_waterfall_tf(spec, p, num_frames)
        for name, sync_fn in (("stencil", sync_scores_tf),
                              ("mxu", sync_scores_tf_mxu)):
            scores = sync_fn(mag_tf, g)
            t, f, v, ok = find_candidates_tf(scores, g, 10, 1.0)
            llrs = extract_llrs_tf(mag_tf, t, f, g.time_osr, g.freq_osr,
                                   g.num_blocks)
            res = finish_decode(llrs, t, f, v, ok, 20, False)
            succ = np.asarray(res.success)
            for row in np.asarray(res.payload)[succ]:
                decoded[name].add(bytes(row))
        assert bytes(payload) in decoded["stencil"], f"trial {trial}"
    assert decoded["stencil"] == decoded["mxu"]
