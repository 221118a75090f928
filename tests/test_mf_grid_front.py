"""The matched-filter grid front: the Hann dB grid and the boxcar power
grid from one block spectrum (ops/waterfall.py), matched-filter LLRs read
from the boxcar grid (ops/llr.py extract_llrs_matched_grid), and the
FT8_MF_FRONT arms of decode_slots."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ft8_demodulator_tpu.ops.waterfall import waterfall_params


def _boxcar_reference(wave, p, nf, rows):
    """|DFT|^2 of the one-symbol boxcar window starting at hop block
    row - (tau - 1), float64, samples past the block range read as 0."""
    nb = nf + p.time_osr - 1
    x = np.zeros(nb * p.hop + 2 * p.nperseg)
    off = p.nperseg
    x[off: off + nb * p.hop] = np.asarray(wave, np.float64)[: nb * p.hop]
    out = []
    for j in rows:
        start = off + (j - (p.time_osr - 1)) * p.hop
        seg = x[start: start + p.nperseg]
        out.append(np.abs(np.fft.fft(seg, n=p.nfft)[: p.num_freq_bins]) ** 2)
    return np.stack(out)


def test_mf_fused_kernel_grids_match_references(rng):
    """Both grids of the MF front, computed from one block spectrum: the
    dB grid equals the frame-matmul waterfall, and the boxcar grid
    equals a float64 FFT of each symbol window (edge rows included)."""
    from ft8_demodulator_tpu.ops.waterfall import (_block_boxcar_tf,
                                                   _block_spectrum,
                                                   _block_waterfall_tf,
                                                   waterfall_real)

    for fs, osr in ((12000.0, (4, 4)), (12000.0, (2, 2))):
        p = waterfall_params(fs, *osr)
        n = int(fs * 15)
        nf = p.num_frames(n)
        wave = (rng.standard_normal(n) * 0.3).astype(np.float32)

        @jax.jit
        def grids(w):
            spec = _block_spectrum(w, p, nf)
            return (_block_waterfall_tf(spec, p, nf),
                    _block_boxcar_tf(spec, p, nf))

        db, box = grids(jnp.asarray(wave))
        ref_db = waterfall_real(jnp.asarray(wave), p, nf, backend="matmul")
        np.testing.assert_allclose(np.asarray(db), np.asarray(ref_db).T,
                                   atol=1e-3, rtol=1e-4)

        nbrows = nf + 2 * (p.time_osr - 1)
        assert box.shape == (nbrows, p.num_freq_bins)
        rows = [0, 1, p.time_osr, nbrows // 2, nbrows - 2, nbrows - 1]
        ref_box = _boxcar_reference(wave, p, nf, rows)
        np.testing.assert_allclose(np.asarray(box)[rows], ref_box,
                                   rtol=1e-3, atol=1e-4 * ref_box.max())


def test_extract_llrs_matched_grid_matches_blocks(rng):
    """Grid-gathered MF LLRs == spectra-gathered MF LLRs (within the
    routing matmuls' operand tolerance), including pre-roll and
    end-clipped candidate times."""
    from ft8_demodulator_tpu.ops.llr import (extract_llrs_matched_blocks,
                                             extract_llrs_matched_grid)
    from ft8_demodulator_tpu.ops.waterfall import (_block_boxcar_tf,
                                                   _block_spectrum)

    fs = 2000.0
    p = waterfall_params(fs, 2, 2)
    n = int(fs * 15)
    nf = p.num_frames(n)
    tau, phi = p.time_osr, p.freq_osr
    wave = jnp.asarray((rng.standard_normal(n) * 0.3).astype(np.float32))
    spec = _block_spectrum(wave, p, nf)
    box = _block_boxcar_tf(spec, p, nf)

    nb = nf + tau - 1
    abs_time = jnp.asarray(
        np.concatenate([[-20, -1, 0, 1, nb - 79 * tau, nb - 40 * tau,
                         nb - 2],
                        rng.integers(0, nb - 79 * tau, 9)]).astype(np.int32))
    abs_freq = jnp.asarray(rng.integers(
        0, p.num_freq_bins - 7 * phi, len(abs_time)).astype(np.int32))

    a = extract_llrs_matched_blocks(spec[0], spec[1], abs_time, abs_freq,
                                    tau, phi)
    b = extract_llrs_matched_grid(box, abs_time, abs_freq, tau, phi)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=0.06,
                               rtol=0.02)
    # and the decode-relevant statistic: LLR signs agree on confident bits
    an, bn = np.asarray(a), np.asarray(b)
    strong = np.abs(an) > 1.0
    assert (np.sign(an[strong]) == np.sign(bn[strong])).mean() > 0.999


def test_mf_grid_front_decode_set_identical(rng, monkeypatch):
    """Planted signals decode to the same payload set through the grid MF
    front (boxcar grid + grid LLR gather) as through the spectra front
    (per-candidate spectra gathers)."""
    from ft8_demodulator_tpu.demod.decode import (_front_slot_tf,
                                                  finish_decode)
    from ft8_demodulator_tpu.ops.gfsk import ft8_passband
    from ft8_demodulator_tpu.ops.sync import search_grid

    fs = 12000.0
    p = waterfall_params(fs, 2, 2)
    n = int(fs * 15)
    nf = p.num_frames(n)
    g = search_grid(p.num_freq_bins, nf, p.time_osr, p.freq_osr)

    decoded = {"spectra": set(), "grid": set()}
    for trial in range(2):
        payload = np.asarray(rng.integers(0, 256, 10), np.uint8)
        payload[9] &= 0xF8
        w = np.zeros(n, np.float32)
        sig = np.asarray(ft8_passband(payload, fs, 900.0 + 400.0 * trial,
                                      0.0))
        w[3000: 3000 + len(sig)] = sig
        w += 0.3 * rng.standard_normal(n).astype(np.float32)
        for arm in decoded:
            monkeypatch.setenv("FT8_MF_FRONT", arm)
            outs = _front_slot_tf(jnp.asarray(w), p, nf, g, 10, 1.0,
                                  mf_first=True)
            res = finish_decode(*outs, 20, False)
            for row in np.asarray(res.payload)[np.asarray(res.success)]:
                decoded[arm].add(bytes(row))
        assert bytes(payload) in decoded["spectra"], f"trial {trial}"
    assert decoded["spectra"] == decoded["grid"]


@pytest.mark.parametrize("osr", [(2, 2), (4, 4)])
def test_deep_decode_slots_grid_matches_spectra(monkeypatch, osr):
    """DEEP decode_slots (K 40, min_score 1, OSD, MF-first) gives the same
    per-slot decode sets on the grid and spectra arms of FT8_MF_FRONT."""
    from ft8_demodulator_tpu.demod.decode import decode_slots
    from ft8_demodulator_tpu.ops.gfsk import ft8_passband

    fs = 4000.0
    p = waterfall_params(fs, *osr)
    n = int(fs * 15)
    nf = p.num_frames(n)
    rng = np.random.default_rng(31)
    waves, payloads = [], []
    for i in range(2):
        payload = rng.integers(0, 256, 10).astype(np.uint8)
        payload[9] &= 0xF8
        sig = np.asarray(ft8_passband(payload, fs, 600.0 + 500.0 * i, 0.0))
        w = rng.standard_normal(n).astype(np.float32) \
            * np.sqrt(np.mean(sig ** 2) / 10 ** (-10.0 / 10))
        w[2000: 2000 + len(sig)] += sig
        waves.append(w)
        payloads.append(bytes(payload))
    waves = jnp.asarray(np.stack(waves))

    sets = {}
    for arm in ("grid", "spectra"):
        monkeypatch.setenv("FT8_MF_FRONT", arm)
        jax.clear_caches()          # the knob is read when decode_slots traces
        res = decode_slots(waves, p, nf, max_candidates=40, min_score=1.0,
                           use_osd=True, mf_first=True, chunk=2)
        ok, pay = np.asarray(res.success), np.asarray(res.payload)
        sets[arm] = [{bytes(r) for r in pay[b][ok[b]]} for b in range(2)]
    assert sets["grid"] == sets["spectra"]
    assert all(payloads[b] in sets["grid"][b] for b in range(2))
