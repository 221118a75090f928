"""Yield-vs-SNR for cross-transmission stacking (demod/stack.py).

A beacon repeats one payload every 15-s cycle; this sweep measures the
50%-yield SNR of the R-repeat stacked decoder against the best single-slot
path (R = 1 == decode_slot(mf_first=True)).  Whole (SNR x trials) grid per
R is batched on-device: TX synthesis, per-repeat independent noise, and the
stacked decode all vmapped over trials.

Usage: python benchmarks/stacking_sweep.py [--fs 2000] [--trials 25]
            [--repeats 1 2 4 8] [--snr-start -23] [--snr-stop -14]
            [--snr-step 0.5] [--osd]
Prints one JSON object with a row per R.
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


def run_stack_curve(fs: float, snrs, trials: int, repeats: int,
                    min_score: float = 1.0, max_candidates: int = 20,
                    seed: int = 0, use_osd: bool = True,
                    coherent: bool = False,
                    offgrid: bool = False):
    """Returns (snr_list, success_rate_list, wall_seconds)."""
    import jax
    import jax.numpy as jnp

    from ft8_demodulator_tpu.demod.stack import decode_slot_stacked
    from ft8_demodulator_tpu.ops.gfsk import _baseband_complex
    from ft8_demodulator_tpu.ops.waterfall import waterfall_params
    from ft8_demodulator_tpu.protocol import constants as C
    from ft8_demodulator_tpu.protocol.encode import encode_tones

    rng = np.random.default_rng(seed)
    sps = int(C.SYMBOL_PERIOD_S * fs)
    n = sps * C.NUM_SYMBOLS + int(fs)
    f0 = fs / 8.0
    p = waterfall_params(fs, 2, 2)
    num_frames = p.num_frames(n)

    payloads = rng.integers(0, 256, size=(trials, 10), dtype=np.uint8)
    payloads[:, 9] &= 0xF8
    start = sps // 2
    if offgrid:
        grid_step = C.TONE_SPACING_HZ / p.freq_osr
        # +-1 row randomises nearest-row parity (see snr_curve.py)
        f0s = f0 + rng.uniform(-1.0, 1.0, trials) * grid_step
        starts = start + rng.integers(-(p.hop // 2), p.hop // 2 + 1, trials)
    else:
        f0s = np.full(trials, f0)
        starts = np.full(trials, start)
    f0s_d = jnp.asarray(f0s.astype(np.float32))
    starts_d = jnp.asarray(starts.astype(np.int32))

    @jax.jit
    def synth(payloads_d, noise, snr_db):
        tones = encode_tones(payloads_d)
        waves = jax.vmap(
            lambda t, f: jnp.real(_baseband_complex(t, sps, fs, f))
        )(tones, f0s_d)
        sig = jax.vmap(lambda w, st: jax.lax.dynamic_update_slice(
            jnp.zeros(n, jnp.float32), w, (st,)))(waves, starts_d)
        power = jnp.mean(waves ** 2, axis=1, keepdims=True)
        scale = jnp.sqrt(power / 10.0 ** (snr_db / 10.0))
        # (trials, R, n): one transmission per trial, R independent looks
        return sig[:, None, :] + noise * scale[:, None, :]

    @jax.jit
    def decode_batch(stacks):
        return jax.vmap(lambda s: decode_slot_stacked(
            s, p, num_frames, max_candidates=max_candidates,
            min_score=min_score, use_osd=use_osd,
            coherent=coherent))(stacks)

    payloads_d = jnp.asarray(payloads)
    expected = payloads.copy()

    rates = []
    t0 = time.perf_counter()
    for snr in snrs:
        noise = jnp.asarray(
            rng.standard_normal((trials, repeats, n)).astype(np.float32))
        res = decode_batch(synth(payloads_d, noise, jnp.float32(snr)))
        pl = np.asarray(res.payload)
        su = np.asarray(res.success)
        ok = sum(
            1 for t in range(trials)
            if any((row == expected[t]).all() for row in pl[t][su[t]]))
        rates.append(ok / trials)
    return list(snrs), rates, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fs", type=float, default=2000.0)
    ap.add_argument("--trials", type=int, default=25)
    ap.add_argument("--repeats", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--snr-start", type=float, default=-23.0)
    ap.add_argument("--snr-stop", type=float, default=-14.0)
    ap.add_argument("--snr-step", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--min-score", type=float, default=1.0)
    ap.add_argument("--osd", action="store_true", default=True)
    ap.add_argument("--coherent", action="store_true",
                    help="per-repeat coherent phase-track projection")
    ap.add_argument("--offgrid", action="store_true",
                    help="random sub-grid (dt, df) placement per trial")
    args = ap.parse_args()

    snrs = np.arange(args.snr_start, args.snr_stop + 1e-9, args.snr_step)
    rows = []
    for r in args.repeats:
        snr_list, rates, wall = run_stack_curve(
            args.fs, snrs.tolist(), args.trials, r, seed=args.seed,
            min_score=args.min_score, use_osd=args.osd,
            coherent=args.coherent, offgrid=args.offgrid)
        passing = [s for s, rate in zip(snr_list, rates) if rate >= 0.5]
        rows.append({
            "repeats": r,
            "coherent": args.coherent,
            "offgrid": args.offgrid,
            "snr_db": snr_list,
            "success_rate": rates,
            "min_snr_50pct": min(passing) if passing else None,
            "wall_seconds": round(wall, 2),
        })
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    print(json.dumps({
        "fs": args.fs,
        "osr": [2, 2],
        "trials_per_point": args.trials,
        "osd": args.osd,
        "use_mf": True,
        "rows": rows,
    }))


if __name__ == "__main__":
    main()
