"""Drift-correction throughput: the reference's second-hottest entry point.

The reference has no wall-clock numbers for `correct_frequency_drift`
(src/ft8_tools/ft8_beacon_receiver/frequency_correction.py:118 — two full
STFTs plus O(T) per-window sklearn regressions).  This benchmark times the
JAX corrector (beacon/drift.py: argmax tracks from the block-DFT
waterfall, sliding-sum continuity variance, normal-equation polyfits,
split-precision chirp compensation) on the reference test bench's standard
workload — fs 32768, 568 Hz/s chirp, Es/N0 35 dB, 2 s zero-pad
(src/tests/test_correction/test_correction.py:129-131,199-219) — and, when
the reference tree is mounted, the reference implementation on the
identical signal.

Usage: python benchmarks/drift_bench.py [--reps 5] [--skip-reference]
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

FS = 32768.0
F0 = 1000.0
DRIFT = 568.0
ESN0_DB = 35.0
PAYLOAD = np.array([0x1C, 0x3F, 0x8A, 0x6A, 0xE2, 0x07, 0xA1, 0xE3, 0x94,
                    0x50], dtype=np.uint8)


def make_signal(seed=11, pad_s=2.0):
    from ft8_demodulator_tpu.ops.gfsk import ft8_baseband

    rng = np.random.default_rng(seed)
    bb = np.asarray(ft8_baseband(PAYLOAD, FS, F0)).astype(np.complex128)
    pad = int(pad_s * FS)
    sig = np.concatenate([np.zeros(pad, np.complex128), bb,
                          np.zeros(pad, np.complex128)])
    t = np.arange(len(sig)) / FS
    sig = sig * np.exp(2j * np.pi * DRIFT * t * t / 2.0)
    es = np.mean(np.abs(bb) ** 2)
    n0 = es / 10 ** (ESN0_DB / 10)
    noise = (rng.standard_normal(len(sig))
             + 1j * rng.standard_normal(len(sig))) * np.sqrt(n0 / 2)
    return sig + noise


def time_ours(sig, reps):
    from ft8_demodulator_tpu.beacon import correct_frequency_drift

    corrected, rate = correct_frequency_drift(sig, FS)      # warmup/compile
    t0 = time.perf_counter()
    for _ in range(reps):
        corrected, rate = correct_frequency_drift(sig, FS)
    dt = (time.perf_counter() - t0) / reps
    return dt, float(rate * FS), corrected


def time_reference(sig, reps):
    ref_src = "/root/reference/src"
    if not os.path.isdir(ref_src):
        return None
    sys.path.insert(0, ref_src)
    try:
        from ft8_tools.ft8_beacon_receiver.frequency_correction import \
            correct_frequency_drift as ref_correct
    except Exception as e:
        print(f"# reference import failed: {e}", file=sys.stderr)
        return None
    t0 = time.perf_counter()
    for _ in range(reps):
        # reference signature: (wave_complex, fs, sym_bin, sym_t, params)
        corrected, rate = ref_correct(sig, FS, 6.25, 0.16)
    dt = (time.perf_counter() - t0) / reps
    return dt, float(rate * FS)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--ref-reps", type=int, default=1)
    ap.add_argument("--skip-reference", action="store_true")
    args = ap.parse_args()

    import jax

    from ft8_demodulator_tpu.demod import decode_ft8_message

    sig = make_signal()
    ours_dt, ours_rate, corrected = time_ours(sig, args.reps)
    # the correction must actually work (guard against a fast no-op)
    rows = decode_ft8_message(corrected, FS, min_score=4.0)
    decoded = any(r.message.payload == bytes(PAYLOAD.tolist())
                  for r in rows)

    out = {
        "benchmark": "drift_correction_throughput",
        "workload": f"fs {FS:.0f}, {DRIFT} Hz/s chirp, Es/N0 {ESN0_DB} dB, "
                    f"{len(sig)} samples",
        "device": str(jax.devices()[0]),
        "seconds_per_correction": round(ours_dt, 4),
        "corrections_per_sec": round(1.0 / ours_dt, 2),
        "estimated_drift_hz_per_s": round(ours_rate, 2),
        "decode_after_correction": bool(decoded),
    }
    if not args.skip_reference:
        ref = time_reference(sig, args.ref_reps)
        if ref is not None:
            out["reference_seconds_per_correction"] = round(ref[0], 2)
            out["reference_drift_hz_per_s"] = round(ref[1], 2)
            out["vs_reference"] = round(ref[0] / ours_dt, 1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
