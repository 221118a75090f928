"""BASELINE config 4 run literally: ONE HOUR of continuous audio.

Feeds 60 minutes of continuous 12 kHz audio — one planted FT8
transmission per 15-s slot at a random in-band frequency, in noise —
through StreamSession in real-capture-sized chunks, on the GPU.
Reports audio-seconds/second, planted-message yield, and peak device
memory.

The audio is synthesised slot-by-slot on device and streamed into the
session in 1-s chunks, exactly how an SDR capture loop would drive it
(reference analog: the blocking buffer loop in pluto-sdr/receive.py).

Usage: python benchmarks/hour_stream.py [--minutes 60] [--snr -12]
           [--chunk-seconds 1.0] [--fs 12000]
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=60.0)
    ap.add_argument("--fs", type=float, default=12000.0)
    ap.add_argument("--snr", type=float, default=-12.0)
    ap.add_argument("--chunk-seconds", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pipeline-depth", type=int, default=8,
                    help="StreamSession pipeline_depth: blocks left in "
                         "flight so their result fetch hides behind "
                         "later dispatch work (0 = fetch every block "
                         "synchronously)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from ft8_demodulator_tpu.demod.stream_session import StreamSession
    from ft8_demodulator_tpu.ops.gfsk import _baseband_complex
    from ft8_demodulator_tpu.protocol import constants as C
    from ft8_demodulator_tpu.protocol.encode import encode_tones

    fs = args.fs
    sps = int(C.SYMBOL_PERIOD_S * fs)
    slot = int(C.SLOT_PERIOD_S * fs)
    n_slots = int(round(args.minutes * 60.0 / C.SLOT_PERIOD_S))
    rng = np.random.default_rng(args.seed)

    payloads = rng.integers(0, 256, size=(n_slots, 10), dtype=np.uint8)
    payloads[:, 9] &= 0xF8
    f0s = rng.uniform(300.0, fs / 2 - 800.0, n_slots).astype(np.float32)
    starts = rng.integers(0, int(0.5 * fs), n_slots)

    @jax.jit
    def synth_slot(payload, f0, start, key, snr_db):
        tones = encode_tones(payload[None])[0]
        wave = jnp.real(_baseband_complex(tones, sps, fs, f0))
        sig = jax.lax.dynamic_update_slice(
            jnp.zeros(slot, jnp.float32), wave, (start,))
        power = jnp.mean(wave ** 2)
        scale = jnp.sqrt(power / 10.0 ** (snr_db / 10.0))
        return sig + scale * jax.random.normal(key, (slot,), jnp.float32)

    dev = jax.devices()[0]
    platform = dev.platform

    sess = StreamSession(fs, pipeline_depth=args.pipeline_depth)
    chunk_len = int(args.chunk_seconds * fs)
    found: list = []
    t0 = time.perf_counter()
    t_steady = None          # set once the first 2 blocks compiled+decoded
    fed_at_steady = 0
    carry = np.zeros(0, np.float32)
    fed = 0
    for s in range(n_slots):
        audio = np.asarray(synth_slot(
            jnp.asarray(payloads[s]), jnp.float32(f0s[s]),
            jnp.int32(starts[s]), jax.random.PRNGKey(args.seed + s),
            jnp.float32(args.snr)))
        carry = np.concatenate([carry, audio])
        while len(carry) >= chunk_len:
            found.extend(sess.feed(carry[:chunk_len]))
            carry = carry[chunk_len:]
            fed += chunk_len
        if t_steady is None and s >= 2:
            t_steady = time.perf_counter()
            fed_at_steady = fed
    found.extend(sess.feed(carry))
    fed += len(carry)
    found.extend(sess.flush())
    t_end = time.perf_counter()
    wall = t_end - t0
    steady_wall = (t_end - t_steady) if t_steady is not None else wall
    steady_fed = fed - fed_at_steady

    expected = {p.tobytes() for p in payloads}
    got = {bytes(r.message.payload) for r in found}
    yield_ok = len(expected & got)

    # the CPU backend reports no allocator stats
    stats = dev.memory_stats() or {}
    mem = {k: int(stats[k]) for k in
           ("bytes_in_use", "peak_bytes_in_use", "largest_alloc_size")
           if k in stats}

    audio_seconds = fed / fs
    out = {
        "benchmark": "hour_continuous_stream (BASELINE config 4)",
        "device": f"{platform} ({dev.device_kind})",
        "minutes": args.minutes,
        "fs_hz": fs,
        "chunk_seconds": args.chunk_seconds,
        "pipeline_depth": args.pipeline_depth,
        "snr_db": args.snr,
        "slots": n_slots,
        "planted_decoded": yield_ok,
        "yield_pct": round(100.0 * yield_ok / n_slots, 1),
        "total_decodes": len(found),
        "audio_seconds": round(audio_seconds, 1),
        "wall_seconds": round(wall, 2),
        "audio_seconds_per_second": round(audio_seconds / wall, 1),
        "steady_state_audio_seconds_per_second": round(
            steady_fed / fs / steady_wall, 1) if steady_fed else None,
        "device_memory": mem,
    }
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
