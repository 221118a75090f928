"""DEEP-preset decode-mask certificate for the GPU knob arms.

The DEEP preset (osr 4x4, K=40, min_score=1, OSD, mf_first) has two
per-platform knobs in its path (utils/backend.py):

  * FT8_OSD_GATE: OSD only on BP-failed candidates via a compacted
    while_loop (ops/osd.py osd_decode_masked), or on every row;
  * FT8_MF_FRONT: matched-filter LLRs read from the boxcar power grid
    (ops/llr.py extract_llrs_matched_grid), or gathered per candidate
    from the raw block spectra.

This harness compares the arms on the 512-slot protocol
(benchmarks/precision_masks.py convention: identical synthesised slot
banks per arm, fixed seed, one child process per arm because the knobs
are read when the decode traces).  The parent stays off JAX and runs
one child at a time, so only one process uses the card:

    arms:  grid_gated      (the GPU defaults)
           spectra_gated   (spectra front, gated OSD)
           spectra_ungated (spectra front, OSD on every row)

Reported per (snr, arm): per-slot CORRECT-decode masks (the decode the
user gets) and per-candidate success cells.  The certificate statistic
is slot-mask identity vs spectra_ungated; candidate-cell diffs are
reported too (borderline duplicate candidates of already-decoded
signals can flip under the grid front's routing-matmul rounding).

Usage: python benchmarks/deep_masks.py [--slots 512] [--out f]
Writes the JSON to --out (default benchmarks/results/deep_masks.json).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

FS = 12000.0
SLOT_S = 15.0
CHUNK = 8   # front chunk width of the DEEP preset
K = 40
MIN_SCORE = 1.0
BP_ITERS = 20
SNRS = (-14.0, -20.0, -24.0)

ARMS = {
    "grid_gated": {"FT8_MF_FRONT": "grid"},
    "spectra_gated": {"FT8_MF_FRONT": "spectra"},
    "spectra_ungated": {"FT8_MF_FRONT": "spectra", "FT8_OSD_GATE": "off"},
}


def child(slots: int, out_path: str) -> None:
    from ft8_demodulator_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    import jax
    import jax.numpy as jnp

    from ft8_demodulator_tpu.demod.decode import decode_slots
    from ft8_demodulator_tpu.ops.gfsk import _baseband_complex
    from ft8_demodulator_tpu.ops.waterfall import waterfall_params
    from ft8_demodulator_tpu.protocol import constants as C
    from ft8_demodulator_tpu.protocol.encode import encode_tones

    n = int(FS * SLOT_S)
    sps = int(C.SYMBOL_PERIOD_S * FS)
    p = waterfall_params(FS, 4, 4)
    num_frames = p.num_frames(n)

    rng = np.random.default_rng(20260820)
    payloads = rng.integers(0, 256, size=(slots, 10), dtype=np.uint8)
    payloads[:, 9] &= 0xF8
    f0s = (500.0 + 100.0 * rng.integers(0, 40, slots)).astype(np.float32)
    noise = rng.standard_normal((slots, n)).astype(np.float32)

    @jax.jit
    def synth(payloads_d, noise_d, f0s_d, snr_db):
        tones = encode_tones(payloads_d)
        waves = jax.vmap(
            lambda t, f0: jnp.real(_baseband_complex(t, sps, FS, f0))
        )(tones, f0s_d)
        sig = jnp.zeros((slots, n), jnp.float32)
        sig = sig.at[:, : waves.shape[1]].set(waves)
        power = jnp.mean(waves ** 2, axis=1, keepdims=True)
        amp = jnp.sqrt(power / 10.0 ** (snr_db / 10.0))
        return sig + noise_d * amp

    @jax.jit
    def deep(waves):
        return decode_slots(waves, p, num_frames, max_candidates=K,
                            min_score=MIN_SCORE, max_iterations=BP_ITERS,
                            use_osd=True, mf_first=True, chunk=CHUNK,
                            bp_chunk=256)

    payloads_d = jnp.asarray(payloads)
    noise_d = jnp.asarray(noise)
    f0s_d = jnp.asarray(f0s)

    out = {}
    for snr in SNRS:
        res = deep(synth(payloads_d, noise_d, f0s_d, float(snr)))
        succ = np.asarray(res.success)
        pay = np.asarray(res.payload)
        ok = np.array([any((row == payloads[b]).all()
                           for row in pay[b][succ[b]])
                       for b in range(slots)])
        out[f"slot_{snr}"] = ok
        out[f"cells_{snr}"] = succ
    np.savez(out_path, **out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=512)
    ap.add_argument("--out", type=str, default=os.path.join(
        _ROOT, "benchmarks", "results", "deep_masks.json"))
    ap.add_argument("--child-out", type=str, default=None)
    args = ap.parse_args()

    if args.child_out:
        child(args.slots, args.child_out)
        return

    tmp = tempfile.mkdtemp(prefix="deep_masks_")
    masks = {}
    for arm, env in ARMS.items():
        out = os.path.join(tmp, arm + ".npz")
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, os.path.abspath(__file__),
             "--slots", str(args.slots), "--child-out", out],
            env={**os.environ, **env}, check=True, cwd=_ROOT)
        with np.load(out) as z:
            masks[arm] = {k: z[k] for k in z.files}
        print(f"arm {arm}: {time.perf_counter() - t0:.1f}s "
              + " ".join(f"{s}:{int(masks[arm][f'slot_{s}'].sum())}"
                         f"/{args.slots}" for s in SNRS),
              file=sys.stderr, flush=True)

    base = masks["spectra_ungated"]
    result = {
        "protocol": f"{args.slots} identical slots x {list(SNRS)} dB, "
                    "DEEP preset (osr 4x4, K=40, min_score=1, OSD, "
                    "mf_first), decode_slots chunk 8 / bp_chunk 256",
        "baseline_arm": "spectra_ungated (spectra front, OSD on every row)",
        "arms": {},
    }
    for arm, m in masks.items():
        entry = {}
        for s in SNRS:
            slot_diff = int((m[f"slot_{s}"] != base[f"slot_{s}"]).sum())
            cell_diff = int((m[f"cells_{s}"] != base[f"cells_{s}"]).sum())
            entry[str(s)] = {
                "decoded": int(m[f"slot_{s}"].sum()),
                "slot_mask_diffs_vs_baseline": slot_diff,
                "candidate_cell_diffs_vs_baseline": cell_diff,
            }
        result["arms"][arm] = entry
    result["slot_masks_identical_everywhere"] = all(
        v["slot_mask_diffs_vs_baseline"] == 0
        for arm in result["arms"].values() for v in arm.values())
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
