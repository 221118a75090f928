"""Drift-corrected decode sensitivity: the reference's own drift bench.

BASELINE.md row 3: the reference's corrector+decoder chain decodes a
568 Hz/s chirp at Es/N0 >= 25 dB and FAILS at <= 23 dB (fs 32768,
zero-padded, deg-2 fit — src/tests/plot/snr_decode.py:1-8,
test_correction.py:129-131).  This sweep measures OUR floor on the
identical workload: synthesise the same chirped signal, blind-correct
(beacon.correct_frequency_drift), decode, sweep Es/N0 downward — two
arms: the reference's decode parameters, and the mf_first+OSD
production preset.  Also records the drift-rate estimate error per
point (their plot_snr_vs_freq_error row).

Usage: python benchmarks/drift_snr.py [--trials 20] [--out f]
Prints one JSON object.
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

FS = 32768.0          # the reference bench's sample rate
F0 = 1000.0
DRIFT = 568.0         # Hz/s
PAD_S = 2.0
ESN0S = [35.0, 30.0, 28.0, 26.0, 25.0, 24.0, 23.0, 22.0, 21.0, 20.0,
         19.0, 18.0, 17.0, 16.0, 15.0, 14.0, 13.0, 12.0, 11.0, 10.0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()

    import jax.numpy as jnp

    from ft8_demodulator_tpu.beacon import correct_frequency_drift
    from ft8_demodulator_tpu.demod import decode_ft8_message
    from ft8_demodulator_tpu.ops.gfsk import ft8_baseband

    rng = np.random.default_rng(args.seed)
    pad = int(PAD_S * FS)

    arms = {
        "reference_params": dict(min_score=4.0),
        "mf_osd": dict(min_score=1.0, use_osd=True, mf_first=True),
    }
    rates = {a: [] for a in arms}
    rate_err = []
    t0 = time.perf_counter()
    for esn0 in ESN0S:
        ok = {a: 0 for a in arms}
        errs = []
        for t in range(args.trials):
            payload = rng.integers(0, 256, 10, np.uint8)
            payload[9] &= 0xF8
            bb = np.asarray(ft8_baseband(jnp.asarray(payload), FS, F0)) \
                .astype(np.complex128)
            sig = np.concatenate([np.zeros(pad, np.complex128), bb,
                                  np.zeros(pad, np.complex128)])
            n = len(sig)
            tt = np.arange(n) / FS
            sig = sig * np.exp(2j * np.pi * DRIFT * tt * tt / 2.0)
            es = np.mean(np.abs(bb) ** 2)
            n0 = es / 10 ** (esn0 / 10)
            sig = sig + (rng.standard_normal(n)
                         + 1j * rng.standard_normal(n)) * np.sqrt(n0 / 2)

            corrected, rate = correct_frequency_drift(sig, FS)
            errs.append(abs(abs(rate * FS) - DRIFT))
            want = payload.tobytes()
            for a, kw in arms.items():
                rows = decode_ft8_message(corrected, FS, **kw)
                if any(bytes(r.message.payload) == want for r in rows):
                    ok[a] += 1
        for a in arms:
            rates[a].append(ok[a] / args.trials)
        rate_err.append(float(np.median(errs)))
        print(json.dumps({"esn0_db": esn0,
                          **{a: rates[a][-1] for a in arms},
                          "median_rate_err_hz_per_s": rate_err[-1]}),
              file=sys.stderr, flush=True)

    def floor(rr):
        lo = None
        for s, r in zip(ESN0S, rr):      # ESN0S descends
            if r >= 0.5:
                lo = float(s)
            else:
                break
        return lo

    out = {
        "benchmark": "drift_corrected_decode_snr",
        "reference_anchor": ("decodes at Es/N0 >= 25 dB, fails <= 23 "
                             "(BASELINE.md row 3; src/tests/plot/"
                             "snr_decode.py:1-8)"),
        "workload": {"fs": FS, "f0": F0, "drift_hz_per_s": DRIFT,
                     "pad_s": PAD_S,
                     "esn0_convention": "per-quadrature sigma (the "
                     "reference's, test_correction.py)"},
        "trials_per_point": args.trials,
        "esn0_db": ESN0S,
        "arms": [{"arm": a, "decode_params": str(arms[a]),
                  "success_rate": rates[a],
                  "min_esn0_50pct": floor(rates[a])} for a in arms],
        "median_rate_err_hz_per_s": rate_err,
        "wall_seconds": round(time.perf_counter() - t0, 1),
    }
    text = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
