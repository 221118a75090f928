"""Satellite beacon end-to-end sensitivity: the composed system claim.

Chains EVERY subsystem in one measured sweep — TLE pass prediction ->
per-sample Doppler at 437 MHz -> AWGN -> receiver-side compensation ->
per-repeat residual drift correction (beacon.drift) -> per-repeat
frequency alignment -> R-cycle stacked coherent decode (demod.stack) —
and reports the 50%-yield Es/N0 floor of each receiver arm.  Until now
the -24 dB stacking number and the drift corrector were only measured
separately (VERDICT r2 "do this" #8); the composed number is the claim.

Arms (all share identical channel waveform + noise per trial):
  model_full   TLE-derived Doppler fully removed (demo path B): the
               upper bound — what a receiver with a good orbit model and
               time reference achieves.  Should approach the no-Doppler
               stacked coherent floor (stacking_snr_coherent_fs2k.json).
  drift_corr   Only the LINEAR Doppler estimate is removed (the
               reference's channel stage 3, test_signal_processing.py:
               45-46); each 15-s cycle is then blind drift-corrected
               (correct_frequency_drift) and aligned to a common
               frequency via the corrector's fitted f_center model
               before stacking.
  linear_only  Linear estimate removed, no per-repeat correction —
               the control showing the drift corrector's contribution.

The channel is the demo scenario (examples/satellite_beacon_demo.py):
STARLINK-1030 over Delft, 437 MHz, capture fs 10 kHz decimated x5 to
2 kHz, R cycles centred on the best pass (where the drift rate peaks).

Usage: python benchmarks/satellite_e2e.py [--trials 10] [--cycles 8]
           [--esn0-start -26] [--esn0-stop -10] [--esn0-step 1] [--out f]
Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "examples"))

from ft8_demodulator_tpu.utils.cache import enable_compilation_cache as _cache_setup  # noqa: E402

_cache_setup()


def run(trials: int, cycles: int, esn0s, seed: int = 0):
    import jax
    import jax.numpy as jnp

    import satellite_beacon_demo as demo
    from ft8_demodulator_tpu.beacon import correct_frequency_drift
    from ft8_demodulator_tpu.channel import (
        add_complex_awgn, apply_doppler_physical,
        compensate_linear_doppler_physical, decimate)
    from ft8_demodulator_tpu.demod import decode_ft8_stacked
    from ft8_demodulator_tpu.ops.gfsk import ft8_baseband

    fs_rf = demo.FS_RF
    decim = demo.DECIM
    fs = fs_rf / decim
    f0 = 500.0
    n_cycle = int(demo.CYCLE_S * fs_rf)
    m_cycle = int(demo.CYCLE_S * fs)
    n = cycles * n_cycle

    doppler, pass_info = demo.predict_pass_doppler(cycles, fs_rf)
    mean_rate = (doppler[-1] - doppler[0]) / (n / fs_rf)
    print(f"pass: {pass_info}", file=sys.stderr)
    print(f"doppler {doppler[0]:+.0f} -> {doppler[-1]:+.0f} Hz, mean "
          f"{mean_rate:+.1f} Hz/s", file=sys.stderr, flush=True)

    # receiver-side linear model: the regression the reference's channel
    # stage records (test_signal_processing.py:25-46)
    k = np.arange(n)
    slope, intercept = np.polyfit(k, doppler, 1)

    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 256, size=(trials, 10), dtype=np.uint8)
    payloads[:, 9] &= 0xF8

    def to_z(ri):
        a = np.asarray(ri)
        return a[..., 0].astype(np.complex128) + 1j * a[..., 1]

    def split_cycles(ri):
        a = np.asarray(ri)
        return np.stack([a[c * m_cycle:(c + 1) * m_cycle]
                         for c in range(cycles)])

    def stacked_ok(stack_z, expected) -> bool:
        ri = np.stack([stack_z.real, stack_z.imag], -1).astype(np.float32)
        rows = decode_ft8_stacked(ri, fs, min_score=1.0, use_osd=True,
                                  coherent=True)
        return any(bytes(r.message.payload) == expected for r in rows)

    arms = {"model_full": [], "drift_corr": [], "linear_only": []}
    align_fail = 0
    t_start = time.perf_counter()
    for ei, esn0 in enumerate(esn0s):
        ok = {a: 0 for a in arms}
        for t in range(trials):
            payload = payloads[t]
            bb = np.asarray(ft8_baseband(jnp.asarray(payload), fs_rf, f0))
            tx = np.zeros(n, np.complex128)
            for c in range(cycles):
                tx[c * n_cycle: c * n_cycle + len(bb)] = bb
            ri = jnp.asarray(
                np.stack([tx.real, tx.imag], -1).astype(np.float32))
            # PHYSICAL Doppler (phase = integral of f_d dt).  The
            # reference's f_d*t phase convention (apply_doppler,
            # test_signal_after_channel.py:55-58) has instantaneous
            # frequency f_d + t*f_d', which amplifies the residual left
            # by partial compensation by ABSOLUTE capture time — by
            # cycle 7 of this 2-minute pass the linear-residual arms
            # would be detuned by several kHz purely by convention, so a
            # composed multi-cycle benchmark is only physically
            # meaningful in the integrated form (channel/doppler.py
            # apply_doppler_physical).
            shifted = apply_doppler_physical(ri, doppler, fs_rf)
            # independent noise per sweep point (ei term), per trial
            key = jax.random.PRNGKey(seed * 100003 + t * 1009 + ei * 31)
            noisy = add_complex_awgn(shifted, key, float(esn0))

            # arm 1: full model compensation (upper bound)
            comp = apply_doppler_physical(noisy, -doppler, fs_rf)
            stack = split_cycles(decimate(comp, decim))
            if stacked_ok(to_z(stack), payload.tobytes()):
                ok["model_full"] += 1

            # arms 2+3: linear estimate removed, residual curvature stays
            lin = compensate_linear_doppler_physical(
                noisy, float(slope), float(intercept), fs_rf)
            cyc = split_cycles(decimate(lin, decim))
            if stacked_ok(to_z(cyc), payload.tobytes()):
                ok["linear_only"] += 1

            corrected, centers = [], []
            for c in range(cycles):
                z = to_z(cyc[c])
                # continuity threshold set for the 2-kHz band: the default
                # max_variance_factor (fraction of freq_bins^2, the
                # reference's convention at fs=32768) is stricter than FT8
                # tone hopping at 320 freq bins (tests/test_drift.py::
                # test_per_repeat_frequency_alignment_via_f_center)
                zc, _rate, model = correct_frequency_drift(
                    z, fs, return_model=True,
                    params={"max_variance_factor": 1e-3})
                corrected.append(zc)
                centers.append(model["f_center_hz"])
            # align every cycle's fitted carrier to the first resolved one
            ref_f = next((f for f in centers if f is not None), None)
            if ref_f is None:
                align_fail += 1
            else:
                tt = np.arange(m_cycle) / fs
                corrected = [
                    zc if f is None else
                    zc * np.exp(-2j * np.pi * (f - ref_f) * tt)
                    for zc, f in zip(corrected, centers)]
            if stacked_ok(np.stack(corrected), payload.tobytes()):
                ok["drift_corr"] += 1

        for a in arms:
            arms[a].append(ok[a] / trials)
        print(json.dumps({"esn0_db": float(esn0),
                          **{a: arms[a][-1] for a in arms}}),
              file=sys.stderr, flush=True)
    wall = time.perf_counter() - t_start

    def floor(rates):
        # scan from the high-SNR end down: the floor is the lowest Es/N0 of
        # the CONTIGUOUS passing region, so one lucky outlier deep below the
        # cliff cannot set the claimed sensitivity
        lo = None
        for s, r in sorted(zip(esn0s, rates), key=lambda p: -p[0]):
            if r >= 0.5:
                lo = float(s)
            else:
                break
        return lo

    return {
        "benchmark": "satellite_beacon_e2e",
        "scenario": {"tle": demo.TLE["name"], "station": "Delft",
                     "fc_hz": demo.FC_HZ, "fs_capture_hz": fs_rf,
                     "fs_decode_hz": fs, "cycles": cycles,
                     "pass": pass_info,
                     "doppler_span_hz": [float(doppler[0]),
                                         float(doppler[-1])],
                     "mean_drift_hz_per_s": float(mean_rate)},
        "convention_note": ("channel + compensations use the PHYSICAL "
                            "phase = integral of f_d dt "
                            "(apply_doppler_physical); the reference's "
                            "f_d*t phase (apply_doppler, kept for "
                            "parity tests) amplifies partial-"
                            "compensation residuals by absolute capture "
                            "time, detuning the late cycles of a "
                            "2-minute pass by several kHz purely by "
                            "convention"),
        "esn0_note": ("Es/N0 knob = signal power over the PER-QUADRATURE "
                      "noise variance at the 10 kHz capture rate "
                      "(add_complex_awgn draws noise with sigma^2 = "
                      "P_sig/10^(snr/10) on each of real/imag, the "
                      "reference's convention, test_signal_after_channel.py"
                      ":42-43); signal over TOTAL complex noise power is "
                      "3.01 dB below this number.  Stride decimation folds "
                      "all capture-band noise into the 2 kHz decode band, "
                      "so decode-band figures inherit the same convention"),
        "trials_per_point": trials,
        "decoder": {"stack": "decode_ft8_stacked", "coherent": True,
                    "use_osd": True, "ap": False},
        "esn0_db": [float(s) for s in esn0s],
        "arms": [{"arm": a, "success_rate": arms[a],
                  "min_esn0_50pct": floor(arms[a])} for a in arms],
        "align_failures": align_fail,
        "wall_seconds": round(wall, 1),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--cycles", type=int, default=8)
    ap.add_argument("--esn0-start", type=float, default=-26.0)
    ap.add_argument("--esn0-stop", type=float, default=-10.0)
    ap.add_argument("--esn0-step", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()
    esn0s = np.arange(args.esn0_start, args.esn0_stop + 1e-9,
                      args.esn0_step).tolist()
    result = run(args.trials, args.cycles, esn0s, args.seed)
    text = json.dumps(result, indent=1)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
