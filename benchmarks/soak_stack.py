"""Randomised soak of the STACKED decode path.

Fuzzes decode_ft8_stacked over random repeat counts, sample rates,
off-grid placements, per-repeat AGC gains, dead (silent) cycles, and
complex repeats, at an SNR where the stack must decode; asserts exact
payload, cell-accurate time/frequency, and a live-count-calibrated SNR
estimate.  Exercises the z-statistic search, noise-floor equalisation,
dead-repeat exclusion, and the coherent stacked retry end to end.

Usage: python benchmarks/soak_stack.py [--trials 60] [--seed 0]
            [--snr -15]
Prints one JSON summary line; exit code 1 if anything failed.
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
    ap.add_argument("--trials", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--snr", type=float, default=-15.0,
                    help="per-repeat full-band SNR (comfortably above "
                         "every stacked cliff)")
    args = ap.parse_args()

    from ft8_demodulator_tpu.demod import decode_ft8_stacked
    from ft8_demodulator_tpu.ops.gfsk import ft8_baseband, ft8_passband
    from ft8_demodulator_tpu.protocol import constants as C

    rng = np.random.default_rng(args.seed)
    failures = []
    t0 = time.perf_counter()
    for trial in range(args.trials):
        fs = float(rng.choice([2000.0, 4000.0]))
        r = int(rng.choice([2, 4, 8]))
        is_complex = trial % 4 == 1
        n = int(fs * 15)
        payload = rng.integers(0, 256, size=10, dtype=np.uint8)
        payload[9] &= 0xF8
        grid_step = C.TONE_SPACING_HZ / 2
        f0 = float(rng.uniform(12 * grid_step, fs / 2 - 100)
                   + rng.uniform(-0.5, 0.5) * grid_step)
        start = int(rng.integers(0, n - int(12.8 * fs)))
        if is_complex:
            w = np.asarray(ft8_baseband(payload, fs, f0))
            sig = np.zeros((r, n), np.complex64)
            sig[:, start: start + len(w)] = w
            sp = float(np.mean(np.abs(w) ** 2))
            nz = (rng.standard_normal((r, n))
                  + 1j * rng.standard_normal((r, n)))
            sig += (nz * np.sqrt(sp / 10 ** (args.snr / 10) / 2)
                    ).astype(np.complex64)
        else:
            w = np.asarray(ft8_passband(payload, fs, f0, 0.0))
            sig = np.zeros((r, n), np.float32)
            sig[:, start: start + len(w)] = w
            sp = float(np.mean(w ** 2))
            sig += rng.standard_normal((r, n)).astype(np.float32) \
                * np.sqrt(sp / 10 ** (args.snr / 10))
        # per-repeat AGC gains over +-20 dB
        gains = (10.0 ** rng.uniform(-1.0, 1.0, r)).astype(np.float32)
        sig = sig * gains[:, None]
        # occasionally kill one cycle outright (dropout)
        dead = r > 2 and trial % 3 == 0
        if dead:
            sig[int(rng.integers(0, r))] = 0

        rows = decode_ft8_stacked(sig, fs, use_osd=True, coherent=True)
        want = bytes(payload.tolist())
        hit = [x for x in rows if x.message.payload == want]
        why = None
        if not hit:
            why = "payload not decoded"
        else:
            x = hit[0]
            if abs(x.time_sec - start / fs) > C.SYMBOL_PERIOD_S / 2 + 1e-6:
                why = f"time off by {abs(x.time_sec - start / fs):.3f} s"
            elif abs(x.freq_hz - f0) > 2.5 * grid_step + 1e-6:
                why = f"freq off by {abs(x.freq_hz - f0):.2f} Hz"
            elif x.snr_db is not None:
                bw = fs if is_complex else fs / 2
                expect = args.snr + 10.0 * np.log10(bw / 2500.0)
                if abs(x.snr_db - expect) > 3.5:
                    why = (f"snr {x.snr_db:.1f} vs expected "
                           f"{expect:.1f} dB")
        if why:
            failures.append({
                "trial": trial, "fs": fs, "repeats": r, "dead": dead,
                "complex": is_complex, "payload": want.hex(),
                "f0": round(f0, 3), "start": start,
                "gains": [round(float(g), 3) for g in gains],
                "why": why,
            })
            print(json.dumps(failures[-1]), file=sys.stderr, flush=True)
    out = {
        "trials": args.trials, "snr_db": args.snr,
        "failures": len(failures),
        "wall_seconds": round(time.perf_counter() - t0, 1),
    }
    print(json.dumps(out))
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
