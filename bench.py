"""Flagship benchmark: batched single-GPU FT8 slot decode throughput.

Config 1/3 of BASELINE.json: batches of 15 s @ 12 kHz slots, osr 2x2,
20 candidates, 20 BP iterations — the full pipeline (STFT -> sync ->
top-k -> LLR -> LDPC BP -> CRC) as one jitted program.  Needs an NVIDIA
GPU and fails without one.  Run:

    python bench.py

Prints the card's name and power limit, then ONE JSON line:

    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

vs_baseline is the speedup over the reference's pure-Python decoder on the
identical workload: 11.71 s per slot, measured on a CPU on 2026-08-16
(src/ft8_tools/ft8_demodulator/ft8_decode.py decode_ft8_message, fs=12 kHz,
15 s slot, osr 2x2, max_candidates=20, min_score=10, max_iterations=20 —
the reference has no published wall-clock numbers of its own).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REFERENCE_SECONDS_PER_SLOT = 11.71  # measured; see module docstring

FS = 12000.0
SLOT_S = 15.0
BATCH = int(os.environ.get("FT8_BENCH_BATCH", "1024"))
CHUNK = int(os.environ.get("FT8_BENCH_CHUNK", "16"))
BP_CHUNK = int(os.environ.get("FT8_BENCH_BP_CHUNK", "256"))
REPS = 10
MAX_CANDIDATES = 20


def make_batch(rng, batch: int, snr_db: float = 0.0):
    """Synthesise `batch` noisy 15-s slots at 12 kHz, each holding one FT8
    signal at `snr_db` (signal power over full-band noise power).

    Returns (device waves (batch, n), host payloads (batch, 10) uint8 with
    the 3 pad bits of byte 9 cleared)."""
    import jax
    import jax.numpy as jnp

    from ft8_demodulator_tpu.ops.gfsk import _baseband_complex
    from ft8_demodulator_tpu.protocol import constants as C
    from ft8_demodulator_tpu.protocol.encode import encode_tones

    n = int(FS * SLOT_S)
    sps = int(C.SYMBOL_PERIOD_S * FS)
    payloads = rng.integers(0, 256, size=(batch, 10), dtype=np.uint8)
    payloads[:, 9] &= 0xF8

    @jax.jit
    def synth(payloads, noise, f0s):
        tones = encode_tones(payloads)
        waves = jax.vmap(
            lambda t, f0: jnp.real(_baseband_complex(t, sps, FS, f0))
        )(tones, f0s)
        sig = jnp.zeros((batch, n), jnp.float32)
        sig = sig.at[:, : waves.shape[1]].set(waves)
        power = jnp.mean(waves ** 2, axis=1, keepdims=True)
        return sig + noise * jnp.sqrt(power / 10.0 ** (snr_db / 10.0))

    noise = jnp.asarray(rng.standard_normal((batch, n)).astype(np.float32))
    f0s = jnp.asarray(
        (500.0 + 100.0 * rng.integers(0, 40, batch)).astype(np.float32))
    return synth(jnp.asarray(payloads), noise, f0s), payloads


def count_planted(res, payloads) -> tuple[int, int]:
    """(slots whose planted payload decoded, decodes of any other payload)."""
    ok = np.asarray(res.success)
    decoded = np.asarray(res.payload)
    found = false = 0
    for b in range(payloads.shape[0]):
        rows = {bytes(r) for r in decoded[b][ok[b]]}
        want = bytes(payloads[b])
        found += want in rows
        false += len(rows - {want})
    return found, false


def flop_model(p, num_frames: int, k: int, bp_iters: int) -> dict:
    """Model FLOPs per slot by stage, from the shapes (2mnk per matmul,
    ~1 flop per elementwise op; BP counted at max iterations)."""
    from ft8_demodulator_tpu.ops.sync import search_grid

    phi, tau = p.freq_osr, p.time_osr
    kx = p.num_freq_bins + 2 * phi
    nb = num_frames + tau - 1
    g = search_grid(p.num_freq_bins, num_frames, tau, phi)
    stages = dict(
        dft=2 * (2 * nb * p.hop * kx),
        waterfall_epilogue=(tau * 6 + 12 + 3 + 10) * num_frames * kx,
        sync_stencil=84 * 4 * g.num_freqs * g.num_times,
        select=2 * g.num_freqs * g.num_times,
        llr_matmul=2 * (k * 8) * p.num_freq_bins * num_frames,
        bp_matmul=bp_iters * k * 2 * (2 * 522 * 581 + 174 * 83),
        bp_elementwise=bp_iters * k * (581 + 522) * 12,
    )
    return {"stages": stages, "total": sum(stages.values())}


def gpu_card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs an NVIDIA GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1
    if BATCH % CHUNK:
        print(f"FT8_BENCH_BATCH ({BATCH}) must be a multiple of "
              f"FT8_BENCH_CHUNK ({CHUNK})", file=sys.stderr)
        return 1

    from ft8_demodulator_tpu.demod.decode import decode_slots
    from ft8_demodulator_tpu.ops.waterfall import waterfall_params
    from ft8_demodulator_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    card = gpu_card()
    print(f"card: {card}")

    batch, payloads = make_batch(np.random.default_rng(42), BATCH)
    n = int(FS * SLOT_S)
    p = waterfall_params(FS, 2, 2)
    num_frames = p.num_frames(n)

    decode_batch = jax.jit(lambda w: decode_slots(
        w, p, num_frames, max_candidates=MAX_CANDIDATES, min_score=10.0,
        max_iterations=20, chunk=CHUNK, bp_chunk=BP_CHUNK))
    t0 = time.perf_counter()
    compiled = decode_batch.lower(batch).compile()
    compile_s = time.perf_counter() - t0
    res = jax.block_until_ready(compiled(batch))
    n_correct, n_false = count_planted(res, payloads)

    t0 = time.perf_counter()
    for _ in range(REPS):
        res = jax.block_until_ready(compiled(batch))
    dt = time.perf_counter() - t0

    slots_per_sec = BATCH * REPS / dt
    fm = flop_model(p, num_frames, MAX_CANDIDATES, 20)
    print(json.dumps({
        "metric": "candidate-decodes/sec/chip",
        "value": slots_per_sec * MAX_CANDIDATES,
        "unit": "candidates/s",
        "vs_baseline": slots_per_sec * REFERENCE_SECONDS_PER_SLOT,
        "slots_per_sec": slots_per_sec,
        "compile_seconds": compile_s,
        "decode_yield": f"{n_correct}/{BATCH}",
        "false_decodes": n_false,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "model_gflop_per_slot": fm["total"] / 1e9,
        "stage_gflop": {s: v / 1e9 for s, v in fm["stages"].items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
