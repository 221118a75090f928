"""Is the stacked cliff search-limited or decoder-limited?

For R-repeat stacks below the measured coherent cliff this probe decodes
each trial twice:

* **full** — the shipped pipeline (`decode_slot_stacked(coherent=True)`),
  sync + top-K candidate search on the stacked power grid;
* **oracle** — sync bypassed: the truth-aligned (nearest-grid) candidate is
  injected straight into the SAME repeat-averaged matched-filter LLR
  extraction + coherent retry + BP/OSD back end.

It also reports, per (R, SNR) point, how often the truth cell (+-1 hop,
+-1 bin) appeared anywhere in the full pipeline's top-K — separating
"search never found it" from "decoder could not crack it".

Usage: python benchmarks/stack_oracle_probe.py [--fs 2000] [--trials 12]
            [--repeats 4 8] [--snr ...]
Prints one JSON object; rows interleave full/oracle rates per R.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ft8_demodulator_tpu.utils.cache import enable_compilation_cache as _cache_setup  # noqa: E402

_cache_setup()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fs", type=float, default=2000.0)
    ap.add_argument("--trials", type=int, default=12)
    ap.add_argument("--repeats", type=int, nargs="+", default=[4, 8])
    ap.add_argument("--snr", type=float, nargs="+", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-candidates", type=int, default=20)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from ft8_demodulator_tpu.demod.decode import (_merge_results,
                                                  finish_decode,
                                                  variant_retry)
    from ft8_demodulator_tpu.demod.stack import (_stacked_power_and_spec,
                                                 decode_slot_stacked)
    from ft8_demodulator_tpu.ops.gfsk import _baseband_complex
    from ft8_demodulator_tpu.ops.llr import (
        extract_llrs_coherent_stacked, extract_llrs_matched_blocks_stacked)
    from ft8_demodulator_tpu.ops.sync import find_candidates, search_grid, \
        sync_scores_z
    from ft8_demodulator_tpu.ops.waterfall import waterfall_params
    from ft8_demodulator_tpu.protocol import constants as C
    from ft8_demodulator_tpu.protocol.encode import encode_tones

    fs = args.fs
    trials = args.trials
    K = args.max_candidates
    rng = np.random.default_rng(args.seed)
    sps = int(C.SYMBOL_PERIOD_S * fs)
    n = sps * C.NUM_SYMBOLS + int(fs)
    f0 = fs / 8.0
    p = waterfall_params(fs, 2, 2)
    num_frames = p.num_frames(n)
    g = search_grid(p.num_freq_bins, num_frames, p.time_osr, p.freq_osr)

    payloads = rng.integers(0, 256, size=(trials, 10), dtype=np.uint8)
    payloads[:, 9] &= 0xF8
    grid_step = C.TONE_SPACING_HZ / p.freq_osr
    f0s = f0 + rng.uniform(-1.0, 1.0, trials) * grid_step
    starts = (sps // 2
              + rng.integers(-(p.hop // 2), p.hop // 2 + 1, trials))
    # truth-aligned nearest grid cell: abs_freq counts
    # TONE_SPACING/freq_osr sub-bins, abs_time counts hops.  (The Costas
    # stencil's neighbour contrast peaks on the +-2-sub-bin sidelobes of
    # a clean tone, so the truth-in-top-K test also reports a +-2
    # frequency tolerance.)
    abs_f_true = np.rint(f0s * p.freq_osr / C.TONE_SPACING_HZ).astype(
        np.int32)
    abs_t_true = np.rint(starts / p.hop).astype(np.int32)

    f0s_d = jnp.asarray(f0s.astype(np.float32))
    starts_d = jnp.asarray(starts.astype(np.int32))
    payloads_d = jnp.asarray(payloads)

    @jax.jit
    def synth(noise, snr_db):
        tones = encode_tones(payloads_d)
        waves = jax.vmap(
            lambda t, f: jnp.real(_baseband_complex(t, sps, fs, f))
        )(tones, f0s_d)
        sig = jax.vmap(lambda w, st: jax.lax.dynamic_update_slice(
            jnp.zeros(n, jnp.float32), w, (st,)))(waves, starts_d)
        power = jnp.mean(waves ** 2, axis=1, keepdims=True)
        scale = jnp.sqrt(power / 10.0 ** (snr_db / 10.0))
        return sig[:, None, :] + noise * scale[:, None, :]

    # both paths mirror the SHIPPED R>1 pipeline (noise-floor
    # equalisation + z-statistic search) so full ~= presence x oracle
    # decomposes cleanly
    def oracle_one(stack, at_true, af_true):
        _, spec, w = _stacked_power_and_spec(stack, p, num_frames, False,
                                             equalize=True)
        stack = stack * jnp.sqrt(w)[:, None]
        abs_time = jnp.full((K,), at_true, jnp.int32)
        abs_freq = jnp.full((K,), af_true, jnp.int32)
        score = jnp.full((K,), 99.0, jnp.float32)
        cand_valid = jnp.arange(K) < 1
        llrs = extract_llrs_matched_blocks_stacked(
            spec[0], spec[1], abs_time, abs_freq, p.time_osr, p.freq_osr)
        res = finish_decode(llrs, abs_time, abs_freq, score, cand_valid,
                            20, True)
        cllrs = extract_llrs_coherent_stacked(
            stack, abs_time, abs_freq, p.nperseg, p.hop, p.freq_osr, False)
        return _merge_results(res, variant_retry(cllrs, res, 20, True))

    def cand_grid_one(stack):
        power, _, _ = _stacked_power_and_spec(stack, p, num_frames, False,
                                              equalize=True)
        return find_candidates(sync_scores_z(power, g), g, K, 2.0)

    @jax.jit
    def decode_all(stacks):
        full = jax.vmap(lambda s: decode_slot_stacked(
            s, p, num_frames, max_candidates=K, min_score=1.0,
            use_osd=True, coherent=True))(stacks)
        orac = jax.vmap(oracle_one)(stacks, jnp.asarray(abs_t_true),
                                    jnp.asarray(abs_f_true))
        at, af, sc, cv = jax.vmap(cand_grid_one)(stacks)
        return full, orac, at, af, cv

    if args.snr is None:
        snr_by_r = {4: [-21.0, -22.0, -23.0, -24.0],
                    8: [-23.0, -24.0, -25.0, -26.0]}
    else:
        snr_by_r = {r: list(args.snr) for r in args.repeats}

    rows = []
    for r in args.repeats:
        snrs = snr_by_r.get(r, [-21.0, -23.0])
        for snr in snrs:
            noise = jnp.asarray(
                rng.standard_normal((trials, r, n)).astype(np.float32))
            t0 = time.perf_counter()
            full, orac, at, af, cv = decode_all(synth(noise,
                                                      jnp.float32(snr)))
            wall = time.perf_counter() - t0

            def yield_of(res):
                pl = np.asarray(res.payload)
                su = np.asarray(res.success)
                return sum(
                    1 for t in range(trials)
                    if any((row == payloads[t]).all()
                           for row in pl[t][su[t]])) / trials

            at_h, af_h, cv_h = (np.asarray(at), np.asarray(af),
                                np.asarray(cv))

            def topk_within(df_tol, dt_tol):
                return sum(
                    1 for t in range(trials)
                    if np.any(cv_h[t]
                              & (np.abs(at_h[t] - abs_t_true[t]) <= dt_tol)
                              & (np.abs(af_h[t] - abs_f_true[t])
                                 <= df_tol))) / trials

            row = {"repeats": r, "snr_db": snr,
                   "full": yield_of(full), "oracle": yield_of(orac),
                   "topk_exact_cell": topk_within(0, 0),
                   "topk_exact_row": topk_within(0, 1),
                   "topk_pm2": topk_within(2, 1),
                   "wall_seconds": round(wall, 2)}
            rows.append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)
    print(json.dumps({"fs": fs, "osr": [2, 2], "trials": trials,
                      "max_candidates": K, "rows": rows}))


if __name__ == "__main__":
    main()
