"""Yield-vs-SNR curve: the reference's sensitivity benchmark, batched.

Equivalent of src/tests/demodulator/test_ft8_standard.py — which loops
20 random payloads per (fs, SNR) point through the Python decoder — but the
whole (SNR x trials) grid is one batched device program: TX synthesis,
noise injection and decode all vmapped.  Success criterion matches the
reference: a point passes if >= 50% of trials decode the exact payload
(test_ft8_standard.py:97-101); noise power is over the full fs/2 band.

Usage:  python benchmarks/snr_curve.py [--fs 2000] [--trials 20]
                 [--snr-start -21] [--snr-stop -10] [--snr-step 0.5]
Prints one JSON object with the curve and the minimum passing SNR.
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


def run_curve(fs: float, snrs, trials: int, f0: float = None,
              min_score: float = 1.0, max_candidates: int = 20,
              seed: int = 0, bins_per_tone: int = 2,
              steps_per_symbol: int = 2, use_osd: bool = False,
              use_mf: bool = False, mf_first: bool = False,
              mf_refine: bool = False, offgrid: bool = False,
              use_ap: bool = False, coherent: bool = False):
    """Returns (snr_list, success_rate_list, wall_seconds).

    offgrid places each trial's transmission at a RANDOM sub-grid offset —
    time uniform over one search-grid hop, frequency uniform over one grid
    row — like every real-world signal.  The default on-grid placement
    (f0 = fs/8 = 40 tone spacings, start on a hop boundary) is the
    best case for the quantised candidate grid; off-grid measures the
    realistic sensitivity (and what mf_refine recovers).

    use_ap: trials become random "CQ <CALL> <GRID>" messages and failed
    candidates retry with the CQ a-priori hypothesis clamped
    (demod.decode.ap_retry) — the monitoring scenario every FT8 receiver
    is in by default.
    """
    import jax
    import jax.numpy as jnp

    from ft8_demodulator_tpu.demod.decode import decode_slot
    from ft8_demodulator_tpu.ops.gfsk import _baseband_complex
    from ft8_demodulator_tpu.ops.waterfall import waterfall_params
    from ft8_demodulator_tpu.protocol import constants as C
    from ft8_demodulator_tpu.protocol.encode import encode_tones

    rng = np.random.default_rng(seed)
    sps = int(C.SYMBOL_PERIOD_S * fs)
    n = sps * C.NUM_SYMBOLS + int(fs)  # signal + 1 s pad
    f0 = f0 if f0 is not None else fs / 8.0
    p = waterfall_params(fs, bins_per_tone, steps_per_symbol)
    num_frames = p.num_frames(n)

    if use_ap:
        from ft8_demodulator_tpu.protocol import pack_message
        letters = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"))
        digits = np.array(list("0123456789"))
        grid_a = np.array(list("ABCDEFGHIJKLMNOPQR"))
        payloads = np.stack([pack_message(
            "CQ "
            + "".join(rng.choice(letters, 2)) + rng.choice(digits)
            + "".join(rng.choice(letters, 3))
            + " " + "".join(rng.choice(grid_a, 2))
            + "".join(rng.choice(digits, 2)))
            for _ in range(trials)])
    else:
        payloads = rng.integers(0, 256, size=(trials, 10), dtype=np.uint8)
        payloads[:, 9] &= 0xF8
    if offgrid:
        grid_step = C.TONE_SPACING_HZ / p.freq_osr
        # +-1 row: nearest-cell offsets stay uniform over +-half a row,
        # but the nearest row's PARITY randomises too (odd half-bin rows
        # carry a deterministic phase step the coherent path must remove)
        f0s = f0 + rng.uniform(-1.0, 1.0, trials) * grid_step
        starts = sps // 2 + rng.integers(-(p.hop // 2), p.hop // 2 + 1,
                                         trials)
    else:
        f0s = np.full(trials, f0)
        starts = np.full(trials, sps // 2)
    f0s_d = jnp.asarray(f0s.astype(np.float32))
    starts_d = jnp.asarray(starts.astype(np.int32))

    @jax.jit
    def synth(payloads_d, noise, snr_db):
        tones = encode_tones(payloads_d)
        waves = jax.vmap(
            lambda t, f: jnp.real(_baseband_complex(t, sps, fs, f))
        )(tones, f0s_d)
        sig = jax.vmap(lambda w, s: jax.lax.dynamic_update_slice(
            jnp.zeros(n, jnp.float32), w, (s,)))(waves, starts_d)
        power = jnp.mean(waves ** 2, axis=1, keepdims=True)
        scale = jnp.sqrt(power / 10.0 ** (snr_db / 10.0))
        return sig + noise * scale

    if use_ap:
        from ft8_demodulator_tpu.demod.decode import ap_retry
        from ft8_demodulator_tpu.protocol import ap_hypotheses
        vals, msk = ap_hypotheses()
        ap_v, ap_m = jnp.asarray(vals), jnp.asarray(msk)

    @jax.jit
    def decode_batch(waves):
        return jax.vmap(lambda w: decode_slot(
            w, p, num_frames, max_candidates=max_candidates,
            min_score=min_score, max_iterations=20, use_osd=use_osd,
            use_mf=use_mf, mf_first=mf_first, mf_refine=mf_refine,
            coherent=coherent))(waves)

    def ap_pass(waves, res):
        # per-trial jitted AP retry (compiled once, reused): vmapping the
        # retry's MF re-extraction blows up XLA:CPU compile times
        rows = []
        for i in range(trials):
            rows.append(ap_retry(
                waves[i], p,
                jax.tree_util.tree_map(lambda a: a[i], res),
                0, 0, ap_v, ap_m, 20, use_osd))
        return jax.tree_util.tree_map(lambda *a: jnp.stack(a), *rows)

    payloads_d = jnp.asarray(payloads)
    expected = payloads.copy()
    expected[:, 9] &= 0xF8

    rates = []
    t0 = time.perf_counter()
    for snr in snrs:
        noise = jnp.asarray(
            rng.standard_normal((trials, n)).astype(np.float32))
        waves = synth(payloads_d, noise, jnp.float32(snr))
        res = decode_batch(waves)
        if use_ap:
            res = ap_pass(waves, res)
        ok = 0
        pl = np.asarray(res.payload)
        su = np.asarray(res.success)
        for t in range(trials):
            if any((row == expected[t]).all() for row in pl[t][su[t]]):
                ok += 1
        rates.append(ok / trials)
    return list(snrs), rates, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fs", type=float, default=2000.0)
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--snr-start", type=float, default=-21.0)
    ap.add_argument("--snr-stop", type=float, default=-10.0)
    ap.add_argument("--snr-step", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bins-per-tone", type=int, default=2)
    ap.add_argument("--steps-per-symbol", type=int, default=2)
    ap.add_argument("--max-candidates", type=int, default=20)
    ap.add_argument("--osd", action="store_true",
                    help="layer ordered-statistics decoding over BP")
    ap.add_argument("--mf", action="store_true",
                    help="matched-filter LLR retry (beyond the reference)")
    ap.add_argument("--mf-first", action="store_true",
                    help="decode every candidate from matched-filter LLRs "
                         "in one pass (skips the Hann-LLR decode)")
    ap.add_argument("--mf-refine", action="store_true",
                    help="sub-grid (dt, df) offset search before MF "
                         "extraction (recovers off-grid quantisation loss)")
    ap.add_argument("--coherent", action="store_true",
                    help="coherent matched-filter retry (phase-track "
                         "projection; the deepest single-transmission "
                         "decoder)")
    ap.add_argument("--ap", action="store_true",
                    help="random CQ messages + a-priori CQ-hypothesis "
                         "retry for failed candidates (~+1 dB)")
    ap.add_argument("--offgrid", action="store_true",
                    help="place each trial at a random sub-grid time/"
                         "frequency offset (realistic signals) instead of "
                         "the grid-aligned best case")
    args = ap.parse_args()

    snrs = np.arange(args.snr_start, args.snr_stop + 1e-9, args.snr_step)
    snr_list, rates, wall = run_curve(args.fs, snrs.tolist(), args.trials,
                                      seed=args.seed,
                                      bins_per_tone=args.bins_per_tone,
                                      steps_per_symbol=args.steps_per_symbol,
                                      max_candidates=args.max_candidates,
                                      use_osd=args.osd, use_mf=args.mf,
                                      mf_first=args.mf_first,
                                      mf_refine=args.mf_refine,
                                      offgrid=args.offgrid,
                                      use_ap=args.ap,
                                      coherent=args.coherent)
    passing = [s for s, r in zip(snr_list, rates) if r >= 0.5]
    print(json.dumps({
        "fs": args.fs,
        "osr": [args.bins_per_tone, args.steps_per_symbol],
        "max_candidates": args.max_candidates,
        "osd": args.osd,
        "mf": args.mf,
        "mf_first": args.mf_first,
        "mf_refine": args.mf_refine,
        "offgrid": args.offgrid,
        "ap": args.ap,
        "coherent": args.coherent,
        "trials_per_point": args.trials,
        "snr_db": snr_list,
        "success_rate": rates,
        "min_snr_50pct": min(passing) if passing else None,
        "wall_seconds": round(wall, 2),
    }))


if __name__ == "__main__":
    main()
