"""Checks of the decoder on an NVIDIA GPU.

Each check runs its computation on the default device (the GPU) and
compares it with the same computation on ``jax.devices("cpu")[0]`` or
with an exact reference.  A check returns its measured values as a dict
and raises AssertionError on failure.  tests/test_gpu.py wraps each
check as a ``gpu``-marked test; chip_smoke.py runs them in-process.

On the GPU a float32 matmul at DEFAULT precision runs in TF32 (10
mantissa bits); HIGHEST is true float32.  The tolerances below are
stated with their reasons.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

FS = 12000.0


def _cpu():
    return jax.devices("cpu")[0]


def on_cpu(fn, *args):
    """fn(*args) computed on the host CPU backend (CPU knob defaults)."""
    cpu = _cpu()
    with jax.default_device(cpu):
        return jax.tree_util.tree_map(
            np.asarray, fn(*jax.device_put(args, cpu)))


def on_gpu(fn, *args):
    return jax.tree_util.tree_map(np.asarray, fn(*args))


def _noisy_slot(rng, snr_db: float, fs: float = FS, f0: float = 1200.0):
    """One 15-s slot: noise plus one FT8 signal at snr_db (full band)."""
    from ft8_demodulator_tpu.ops.gfsk import ft8_passband

    payload = rng.integers(0, 256, 10).astype(np.uint8)
    payload[9] &= 0xF8
    n = int(fs * 15)
    sig = np.asarray(ft8_passband(payload, fs, f0, 0.0))
    wave = rng.standard_normal(n).astype(np.float32) \
        * np.sqrt(np.mean(sig ** 2) / 10 ** (snr_db / 10))
    wave[int(0.5 * fs): int(0.5 * fs) + len(sig)] += sig
    return wave, payload


def check_waterfall_grids(seed: int = 0) -> dict:
    """dB waterfall and boxcar grids, GPU vs CPU (float32 DFT).

    At the DEEP geometry (12 kHz, osr 4x4) on one noisy slot, the GPU
    DFT at the FT8_DFT_PRECISION knob's precision.  Limits: the
    dB grid within 0.1 dB on cells within 60 dB of the slot peak; the
    boxcar power within 1e-2 relative on cells within 60 dB of its peak.
    The deviation at DEFAULT (TF32 on the GPU) is reported beside it.
    """
    from ft8_demodulator_tpu.ops.waterfall import (_block_boxcar_tf,
                                                   _block_spectrum,
                                                   _block_waterfall_tf,
                                                   waterfall_params)

    p = waterfall_params(FS, 4, 4)
    wave, _ = _noisy_slot(np.random.default_rng(seed), -14.0)
    nf = p.num_frames(len(wave))

    def grids(w, precision):
        spec = _block_spectrum(w, p, nf, precision)
        return _block_waterfall_tf(spec, p, nf), _block_boxcar_tf(spec, p, nf)

    c_db, c_box = on_cpu(jax.jit(lambda w: grids(w, "highest")), wave)
    near = c_db >= c_db.max() - 60.0
    box_near = c_box >= c_box.max() * 1e-6

    def deviations(prec):
        g_db, g_box = on_gpu(jax.jit(lambda w: grids(w, prec)),
                             jnp.asarray(wave))
        dev = np.abs(g_db - c_db)[near]
        rel = (np.abs(g_box - c_box) / c_box)[box_near]
        return float(dev.max()), float(np.quantile(dev, 0.9999)), \
            float(rel.max())

    db_dev, db_p9999, box_rel = deviations(None)
    tf32_dev, tf32_p9999, tf32_rel = deviations("default")
    out = {"db_max_dev": db_dev, "db_dev_p9999": db_p9999,
           "box_max_rel": box_rel, "db_cells": int(near.sum()),
           "default_db_max_dev": tf32_dev,
           "default_db_dev_p9999": tf32_p9999,
           "default_box_max_rel": tf32_rel}
    assert db_dev < 0.1, out
    assert box_rel < 1e-2, out
    return out


def check_gf2_matmuls(n: int = 4096, seed: int = 1) -> dict:
    """The DEFAULT-precision GF(2) matmuls are bit-exact on the card.

    _permute_pack (0/1 basis times powers 2^0..2^15) on n random rank
    orders against the gather + bit-pack reference; the CRC and parity
    checks on n random bit rows against integer NumPy arithmetic.
    """
    from ft8_demodulator_tpu.demod.decode import _crc_of_plain
    from ft8_demodulator_tpu.ops import osd as O
    from ft8_demodulator_tpu.ops.ldpc_decode import ldpc_check
    from ft8_demodulator_tpu.protocol import constants as C

    rng = np.random.default_rng(seed)
    ranks = np.argsort(rng.random((n, 174)), axis=1).astype(np.int32)
    packed = on_gpu(jax.jit(O._permute_pack), jnp.asarray(ranks))
    order = np.argsort(ranks, axis=1)
    bits = np.concatenate(
        [O._basis()[:, order].transpose(1, 0, 2),
         np.broadcast_to(O._ROW_SYNDROMES_NP[None], (n, 91, 14))], axis=-1)
    ref = np.asarray(on_cpu(jax.jit(O._pack), bits))
    pack_diff = int(np.sum(packed != ref))

    plain = rng.integers(0, 2, (n, 174)).astype(np.int32)
    crc, crc_ext = on_gpu(jax.jit(_crc_of_plain), jnp.asarray(plain))
    want_crc = (plain[:, :77] @ C.CRC_MATRIX_77.T.astype(np.int64)) % 2
    want_crc = want_crc @ (1 << np.arange(13, -1, -1))
    want_ext = plain[:, 77:91] @ (1 << np.arange(13, -1, -1))
    crc_diff = int(np.sum(crc != want_crc) + np.sum(crc_ext != want_ext))

    checks = on_gpu(jax.jit(ldpc_check), jnp.asarray(plain))
    want_chk = np.sum((plain @ C.PARITY_CHECK.T.astype(np.int64)) % 2, -1)
    chk_diff = int(np.sum(checks != want_chk))
    out = {"rows": n, "permute_pack_diffs": pack_diff,
           "crc_diffs": crc_diff, "parity_diffs": chk_diff}
    assert pack_diff == crc_diff == chk_diff == 0, out
    return out


def check_osd_kernel(n: int = 4096, seed: int = 2) -> dict:
    """The Triton GF(2) elimination equals the jnp while-loop on the card:
    zero differences in the reduced basis and the pivot columns."""
    from ft8_demodulator_tpu.ops import osd as O
    from ft8_demodulator_tpu.ops.osd_triton import reduce_basis_triton

    rng = np.random.default_rng(seed)
    ranks = np.argsort(rng.random((n, 174)), axis=1).astype(np.int32)
    a = jax.jit(O._permute_pack)(jnp.asarray(ranks))
    r1, p1 = on_gpu(jax.jit(jax.vmap(O._reduce_basis_packed)), a)
    r2, p2 = on_gpu(reduce_basis_triton, a)
    out = {"rows": n, "basis_diffs": int(np.sum(r1 != r2)),
           "pcol_diffs": int(np.sum(p1 != p2))}
    assert out["basis_diffs"] == out["pcol_diffs"] == 0, out
    return out


def check_onehot_select(seed: int = 3) -> dict:
    """find_candidates_tf's HIGHEST one-hot selection equals a gather:
    the top-K values and cells on the card match NumPy on the same grid."""
    from ft8_demodulator_tpu.ops.sync import (find_candidates_tf,
                                              search_grid, sync_scores_tf)
    from ft8_demodulator_tpu.ops.waterfall import (_block_spectrum,
                                                   _block_waterfall_tf,
                                                   waterfall_params)

    p = waterfall_params(FS, 2, 2)
    wave, _ = _noisy_slot(np.random.default_rng(seed), -6.0)
    nf = p.num_frames(len(wave))
    g = search_grid(p.num_freq_bins, nf, p.time_osr, p.freq_osr)
    scores = jax.jit(lambda w: sync_scores_tf(_block_waterfall_tf(
        _block_spectrum(w, p, nf), p, nf), g))(jnp.asarray(wave))
    k = 40
    t, f, vals, _ = on_gpu(jax.jit(lambda s: find_candidates_tf(
        s, g, k, 1.0)), scores)
    s = np.asarray(scores)
    masked = np.where(s >= 1.0, s, -np.inf).T.reshape(-1)   # (F, T) order
    idx = np.argsort(-masked, kind="stable")[:k]
    want_vals = masked[idx]
    got = {(int(a), int(b)) for a, b in zip(t, f)}
    want = {(int(g.t_start + i % g.num_times), int(i // g.num_times))
            for i in idx}
    out = {"k": k, "value_diffs": int(np.sum(vals != want_vals)),
           "cell_diffs": len(got ^ want)}
    assert out["value_diffs"] == out["cell_diffs"] == 0, out
    return out


def check_precision_high(seed: int = 4) -> dict:
    """What XLA:GPU does with each float32 matmul precision: relative
    error of a (512, 2048) @ (2048, 512) product against float64."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((512, 2048)).astype(np.float32)
    b = rng.standard_normal((2048, 512)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    out = {}
    for name in ("DEFAULT", "HIGH", "HIGHEST"):
        prec = getattr(jax.lax.Precision, name)
        got = on_gpu(jax.jit(lambda x, y: jnp.matmul(x, y, precision=prec)),
                     jnp.asarray(a), jnp.asarray(b))
        out[name] = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
    assert out["HIGHEST"] < 1e-5, out
    return out


_PAYLOAD = np.array([0x1C, 0x3F, 0x8A, 0x6A, 0xE2, 0x07, 0xA1, 0xE3, 0x94,
                     0x50], np.uint8)


def _slot_2k(snr_db: float | None, start: int) -> np.ndarray:
    """The fs 2 kHz fixture slot: _PAYLOAD at 400 Hz from sample `start`,
    white noise from seed 0 (std 0.05 when snr_db is None)."""
    from ft8_demodulator_tpu.ops.gfsk import ft8_passband

    fs = 2000.0
    w = np.asarray(ft8_passband(_PAYLOAD, fs, 400.0, 0.0))
    sig = np.zeros(int(fs * 15), np.float32)
    sig[start: start + len(w)] = w
    scale = 0.05 if snr_db is None else \
        np.sqrt(float(np.mean(w ** 2)) / 10 ** (snr_db / 10))
    sig += np.random.default_rng(0).standard_normal(
        len(sig)).astype(np.float32) * scale
    return sig


def check_decode_slot() -> dict:
    """decode_slot on the card recovers a planted payload at fs 2 kHz."""
    from ft8_demodulator_tpu.demod.decode import decode_slot
    from ft8_demodulator_tpu.ops.waterfall import waterfall_params

    wave = _slot_2k(None, 800)
    p = waterfall_params(2000.0, 2, 2)
    res = decode_slot(jnp.asarray(wave), p, p.num_frames(len(wave)),
                      min_score=4.0)
    rows = np.asarray(res.payload)[np.asarray(res.success)]
    out = {"decoded": sum(bytes(r) == bytes(_PAYLOAD) for r in rows)}
    assert out["decoded"] >= 1, out
    return out


def check_decode_slots_vs_slot(seed: int = 6) -> dict:
    """The batched split-BP pipeline equals vmap(decode_slot) on the card."""
    from ft8_demodulator_tpu.demod.decode import decode_slot, decode_slots
    from ft8_demodulator_tpu.ops.waterfall import waterfall_params

    rng = np.random.default_rng(seed)
    waves = np.stack([_noisy_slot(rng, -12.0, FS, 500.0 + 300.0 * i)[0]
                      for i in range(8)])
    p = waterfall_params(FS, 2, 2)
    nf = p.num_frames(waves.shape[1])
    w = jnp.asarray(waves)
    ref = jax.vmap(lambda x: decode_slot(x, p, nf, max_candidates=20,
                                         min_score=10.0))(w)
    got = decode_slots(w, p, nf, max_candidates=20, min_score=10.0, chunk=4)
    out = {"mask_diffs": int(np.sum(np.asarray(ref.success)
                                    != np.asarray(got.success))),
           "payload_diffs": int(np.sum(np.asarray(ref.payload)
                                       != np.asarray(got.payload))),
           "decodes": int(np.asarray(got.success).sum())}
    assert out["mask_diffs"] == out["payload_diffs"] == 0, out
    return out


def check_deep_host_api() -> dict:
    """decode_ft8_message with OSD and MF (retry and MF-first) recovers a
    -15 dB signal at fs 2 kHz on the card."""
    from ft8_demodulator_tpu.demod import decode_ft8_message

    wave = _slot_2k(-15.0, 500)
    out = {}
    for name, kw in (("mf_retry", {"use_mf": True}),
                     ("mf_first", {"mf_first": True})):
        rows = decode_ft8_message(wave, 2000.0, min_score=1.0, use_osd=True,
                                  **kw)
        out[name] = any(r.message.payload == bytes(_PAYLOAD) for r in rows)
    assert all(out.values()), out
    return out


CHECKS = (check_waterfall_grids, check_gf2_matmuls, check_osd_kernel,
          check_onehot_select, check_precision_high, check_decode_slot,
          check_decode_slots_vs_slot, check_deep_host_api)
