"""Crowded-band yield: single-pass vs subtraction (multi-pass) decoding.

BASELINE config 2 stress: one 15 s slot carries many transmissions with a
wide amplitude spread and deliberate frequency overlaps; count how many
payloads each pass recovers.  The reference decoder is single-pass — its
yield equals the passes=1 column.

Usage: python benchmarks/multipass_yield.py [--slots 10] [--signals 12]
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

FS = 4000.0


def make_slot(rng, n_signals):
    import jax
    import jax.numpy as jnp

    from ft8_demodulator_tpu.ops.gfsk import _baseband_complex
    from ft8_demodulator_tpu.protocol import constants as C
    from ft8_demodulator_tpu.protocol.encode import encode_tones

    sps = int(C.SYMBOL_PERIOD_S * FS)
    n = int(FS * 15)
    payloads = rng.integers(0, 256, size=(n_signals, 10), dtype=np.uint8)
    payloads[:, 9] &= 0xF8
    # random frequencies with deliberate crowding (mean spacing ~ one
    # signal bandwidth) and 0..26 dB amplitude spread
    f0s = rng.uniform(300.0, 1500.0, n_signals).astype(np.float32)
    amps = (10 ** (-rng.uniform(0.0, 26.0, n_signals) / 20.0)
            ).astype(np.float32)
    starts = rng.integers(0, 2 * sps, n_signals)

    @jax.jit
    def synth(pls, f0_d):
        tones = encode_tones(pls)
        return jax.vmap(lambda t, f: jnp.real(
            _baseband_complex(t, sps, FS, f)))(tones, f0_d)

    waves = np.asarray(synth(jnp.asarray(payloads), jnp.asarray(f0s)))
    sig = np.zeros(n, np.float64)
    for w, a, s in zip(waves, amps, starts):
        sig[s: s + len(w)] += float(a) * w
    sig += 0.002 * rng.standard_normal(n)
    return sig.astype(np.float32), payloads


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=10)
    ap.add_argument("--signals", type=int, default=12)
    ap.add_argument("--max-passes", type=int, default=3)
    ap.add_argument("--osd", action="store_true")
    ap.add_argument("--mf", action="store_true",
                    help="matched-filter LLR retry (beyond the reference)")
    ap.add_argument("--mf-first", action="store_true",
                    help="single-pass matched-filter LLR decode")
    ap.add_argument("--mf-refine", action="store_true",
                    help="sub-grid (dt, df) offset search before MF "
                         "extraction — the crowded band places every "
                         "signal off-grid")
    ap.add_argument("--coherent", action="store_true",
                    help="coherent matched-filter retry (phase-projected "
                         "LLRs; co-channel interference is phase-random "
                         "relative to the track, so it halves too)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    from ft8_demodulator_tpu.demod.decode import decode_ft8_message

    rng = np.random.default_rng(args.seed)
    slots = [make_slot(rng, args.signals) for _ in range(args.slots)]
    total = args.slots * args.signals

    yields = {}
    t0 = time.perf_counter()
    for passes in range(1, args.max_passes + 1):
        found = 0
        for sig, payloads in slots:
            rows = decode_ft8_message(sig, FS, max_candidates=40,
                                      min_score=3.0, passes=passes,
                                      use_osd=args.osd, use_mf=args.mf,
                                      mf_first=args.mf_first,
                                      mf_refine=args.mf_refine,
                                      coherent=args.coherent)
            got = {r.message.payload.hex() for r in rows}
            found += sum(p.tobytes().hex() in got for p in payloads)
        yields[f"passes={passes}"] = round(found / total, 4)

    print(json.dumps({
        "benchmark": "crowded_band_multipass_yield",
        "fs": FS,
        "slots": args.slots,
        "signals_per_slot": args.signals,
        "amplitude_spread_db": 26,
        "osd": args.osd,
        "mf": args.mf,
        "mf_first": args.mf_first,
        "mf_refine": args.mf_refine,
        "coherent": args.coherent,
        "yield": yields,
        "device": str(jax.devices()[0]),
        "wall_seconds": round(time.perf_counter() - t0, 1),
    }))


if __name__ == "__main__":
    main()
