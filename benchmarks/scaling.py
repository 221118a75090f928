"""Scaling benchmark: streaming decode throughput vs mesh size.

BASELINE configs 4-5: continuous audio chunked into overlapping blocks
sharded over the mesh's stream axis, and multi-channel banks sharded over
the channel axis.  On a machine with several GPUs it uses them all;
--devices N fakes an N-device CPU mesh instead (virtual devices;
measures sharding overhead, not speedup).

Usage: python benchmarks/scaling.py [--devices 8] [--minutes 2] [--channels 2]
Prints one JSON object per mesh configuration.
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
    ap.add_argument("--devices", type=int, default=0,
                    help="fake an N-device CPU mesh (0 = use real devices)")
    ap.add_argument("--minutes", type=float, default=2.0)
    ap.add_argument("--channels", type=int, default=2)
    ap.add_argument("--fs", type=float, default=12000.0)
    args = ap.parse_args()

    import jax
    if args.devices:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.devices)
    import jax.numpy as jnp

    from ft8_demodulator_tpu.ops.waterfall import waterfall_params
    from ft8_demodulator_tpu.parallel.mesh import make_mesh
    from ft8_demodulator_tpu.parallel.streaming import decode_stream_sharded

    n_dev = len(jax.devices())
    fs = args.fs
    p = waterfall_params(fs, 2, 2)
    rng = np.random.default_rng(0)

    audio_s = args.minutes * 60.0
    total = int(audio_s * fs)

    results = []
    shapes = []
    s = n_dev
    while s >= 1:
        c = n_dev // s
        if c <= args.channels and s * c == n_dev:
            shapes.append((c, s))
        s //= 2
    for channel, stream in shapes:
        mesh = make_mesh(stream=stream, channel=channel)
        block = (total // stream // p.hop) * p.hop
        n = block * stream
        audio = jnp.asarray(
            rng.standard_normal((channel, n)).astype(np.float32))

        fn = lambda a: decode_stream_sharded(a, p, mesh, 20, 10.0, 20)[0]

        jax.block_until_ready(fn(audio))
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            jax.block_until_ready(fn(audio))
        dt = time.perf_counter() - t0
        audio_seconds = channel * n / fs * reps
        results.append({
            "mesh": f"{channel}channel x {stream}stream",
            "devices": n_dev,
            "audio_seconds_per_second": round(audio_seconds / dt, 1),
            "realtime_factor_per_device": round(
                audio_seconds / dt / n_dev, 1),
        })
        print(json.dumps(results[-1]))


if __name__ == "__main__":
    main()
