"""SNR-vs-bandwidth sweep: the reference's headline sensitivity benchmark.

Equivalent of src/tests/demodulator/test_ft8_standard.py:70-122 — for each
sample rate fs in [2000, 10500] step 500 (signal bandwidth fs/2), find the
minimum full-band SNR at which >= 50 % of `--trials` random payloads decode
(reference criterion, test_ft8_standard.py:97-101).  The reference runs the
whole sweep through its pure-Python decoder; here every (fs, SNR) point is
one batched device program.

Usage: python benchmarks/bandwidth_sweep.py [--trials 20] [--out results.json]
Prints one JSON object; optionally writes it (plus a matplotlib plot next to
it) with --out.
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

from benchmarks.snr_curve import run_curve  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--fs-start", type=float, default=2000.0)
    ap.add_argument("--fs-stop", type=float, default=10500.0)
    ap.add_argument("--fs-step", type=float, default=500.0)
    ap.add_argument("--snr-start", type=float, default=-22.0)
    ap.add_argument("--snr-stop", type=float, default=-10.0)
    ap.add_argument("--snr-step", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--osd", action="store_true")
    ap.add_argument("--mf", action="store_true",
                    help="matched-filter LLR retry (beyond the reference)")
    ap.add_argument("--mf-first", action="store_true",
                    help="single-pass matched-filter LLR decode")
    ap.add_argument("--mf-refine", action="store_true",
                    help="sub-grid (dt, df) offset search before MF "
                         "extraction")
    ap.add_argument("--offgrid", action="store_true",
                    help="random sub-grid signal placement (realistic) "
                         "instead of grid-aligned")
    ap.add_argument("--coherent", action="store_true",
                    help="coherent matched-filter retry")
    args = ap.parse_args()

    import jax

    snrs = np.arange(args.snr_start, args.snr_stop + 1e-9,
                     args.snr_step).tolist()
    fs_list = np.arange(args.fs_start, args.fs_stop + 1e-9,
                        args.fs_step).tolist()
    if not snrs or not fs_list:
        ap.error("empty SNR or sample-rate range")

    rows = []
    t_all = time.perf_counter()
    for fs in fs_list:
        snr_list, rates, wall = run_curve(fs, snrs, args.trials,
                                          seed=args.seed, use_osd=args.osd,
                                          use_mf=args.mf,
                                          mf_first=args.mf_first,
                                          mf_refine=args.mf_refine,
                                          offgrid=args.offgrid,
                                          coherent=args.coherent)
        passing = [s for s, r in zip(snr_list, rates) if r >= 0.5]
        rows.append({
            "fs": fs,
            "bandwidth_hz": fs / 2,
            "min_snr_50pct": min(passing) if passing else None,
            "success_rate": rates,
            "wall_seconds": round(wall, 2),
        })
        print(f"# fs={fs:.0f}: min SNR(50%)="
              f"{rows[-1]['min_snr_50pct']}  ({wall:.1f}s)",
              file=sys.stderr, flush=True)

    result = {
        "benchmark": "snr_vs_bandwidth",
        "reference": "src/tests/demodulator/test_ft8_standard.py",
        "criterion": ">=50% of trials decode exact payload",
        "trials_per_point": args.trials,
        "osd": args.osd,
        "mf": args.mf,
        "mf_first": args.mf_first,
        "mf_refine": args.mf_refine,
        "offgrid": args.offgrid,
        "snr_db": snr_list,
        "device": str(jax.devices()[0]),
        "rows": rows,
        "total_wall_seconds": round(time.perf_counter() - t_all, 2),
    }
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        try:
            from ft8_demodulator_tpu.plotting import plot_snr_vs_bandwidth
            plot_snr_vs_bandwidth(
                [r["bandwidth_hz"] for r in rows],
                [r["min_snr_50pct"] for r in rows],
                path=os.path.splitext(args.out)[0] + ".png")
        except Exception as e:  # plotting is best-effort
            print(f"# plot skipped: {e}", file=sys.stderr)


if __name__ == "__main__":
    main()
