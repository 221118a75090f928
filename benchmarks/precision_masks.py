"""Decode-mask experiment for the reduced-precision matmul defaults.

The DFT matmuls (ops/waterfall.py _DFT_PRECISION), the BP routing
matmuls (ops/ldpc_decode.py _BP_PRECISION) and the LLR selection
matmuls (ops/llr.py _LLR_PRECISION) run at DEFAULT precision — TF32
operands on the GPU.  This harness checks that choice on the decode
masks:

    512 identical noisy slots at each of -20/-21/-22 dB (fs 12 kHz cliff
    geometry, osr 2x2, K=20, 20 BP iterations), decoded under
      a) DFT=high  BP=high      (reference-grade numerics)
      b) DFT=default BP=high    (isolates the DFT knob)
      c) DFT=high  BP=default   (isolates the BP knob)
      d) DFT=default BP=default (the shipping defaults)
      and the sync and LLR arms below,
    and the per-slot success masks compared bit-for-bit.

The precision knobs bind at import (they are module constants so jit
traces stay static), so each arm runs in a child process with the env
vars set.  The parent process stays off JAX and runs one child at a
time, so only one process uses the card.  Slots are bit-identical
across arms (fixed seed, synthesised on device by the same program).

Usage: python benchmarks/precision_masks.py [--slots 512] [--out f]
Prints one JSON object.
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
CHUNK = 16
K = 20
BP_ITERS = 20
SNRS = (-20.0, -21.0, -22.0)
# the sensitivity-sweep threshold: min_score=10 rejects every candidate at
# these cliff SNRs (first committed run was 0/512 everywhere — maximally
# uninformative); 1.0 is what benchmarks/snr_curve.py measures with
MIN_SCORE = 1.0

# every arm pins FT8_LLR_PRECISION explicitly: the LLR selection
# matmuls moved HIGH -> DEFAULT in round 4, and the historical arms
# keep their original meaning (LLR at high) so committed results stay
# comparable across code versions
ARMS = {
    "high_high": {"FT8_DFT_PRECISION": "high", "FT8_BP_PRECISION": "high",
                  "FT8_LLR_PRECISION": "high"},
    "dft_default": {"FT8_DFT_PRECISION": "default",
                    "FT8_BP_PRECISION": "high",
                    "FT8_LLR_PRECISION": "high"},
    "bp_default": {"FT8_DFT_PRECISION": "high",
                   "FT8_BP_PRECISION": "default",
                   "FT8_LLR_PRECISION": "high"},
    "default_default": {"FT8_DFT_PRECISION": "default",
                        "FT8_BP_PRECISION": "default",
                        "FT8_LLR_PRECISION": "high"},
    # the matmul recast of the sync stencil (ops/sync.py
    # sync_scores_tf_mxu) on top of the shipping precision defaults: same
    # 84 terms folded into matmuls, so this arm certifies both the
    # accumulation-order change and the operand rounding of the score
    # matmul
    "sync_mxu": {"FT8_DFT_PRECISION": "default",
                 "FT8_BP_PRECISION": "default",
                 "FT8_LLR_PRECISION": "high",
                 "FT8_SYNC_BACKEND": "mxu"},
    # the FULL shipping defaults incl. LLR selection at DEFAULT (the same
    # rounding BP's DEFAULT applies to the very same LLRs one stage later)
    "llr_default": {"FT8_DFT_PRECISION": "default",
                    "FT8_BP_PRECISION": "default",
                    "FT8_LLR_PRECISION": "default",
                    "FT8_SYNC_BACKEND": "mxu"},
}


def child(slots: int, out_path: str) -> None:
    """Decode the deterministic slot bank under the ambient precision env
    vars and write per-(snr, slot) success masks."""
    from ft8_demodulator_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    import jax
    import jax.numpy as jnp

    from ft8_demodulator_tpu.demod.decode import decode_slot
    from ft8_demodulator_tpu.ops.gfsk import _baseband_complex
    from ft8_demodulator_tpu.ops.waterfall import waterfall_params
    from ft8_demodulator_tpu.protocol import constants as C
    from ft8_demodulator_tpu.protocol.encode import encode_tones

    n = int(FS * SLOT_S)
    sps = int(C.SYMBOL_PERIOD_S * FS)
    p = waterfall_params(FS, 2, 2)
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
    def decode_batch(waves):
        one = lambda w: decode_slot(w, p, num_frames, max_candidates=K,
                                    min_score=MIN_SCORE,
                                    max_iterations=BP_ITERS)
        chunks = waves.reshape(-1, CHUNK, waves.shape[-1])
        res = jax.lax.map(jax.vmap(one), chunks)
        return jax.tree_util.tree_map(
            lambda x: x.reshape(-1, *x.shape[2:]), res)

    payloads_d = jnp.asarray(payloads)
    noise_d = jnp.asarray(noise)
    f0s_d = jnp.asarray(f0s)

    masks = {}
    for snr in SNRS:
        res = decode_batch(synth(payloads_d, noise_d, f0s_d, float(snr)))
        success = np.asarray(res.success)
        decoded = np.asarray(res.payload)
        ok = np.zeros(slots, bool)
        for b in range(slots):
            want = payloads[b]
            rows = decoded[b][success[b]]
            ok[b] = any((row == want).all() for row in rows)
        masks[f"{snr}"] = ok
    np.savez(out_path, **masks)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=512)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--child-out", type=str, default=None,
                    help="internal: run the decode arm, write masks npz")
    ap.add_argument("--arms", type=str, default=None,
                    help="comma list of arms to run (default: all); "
                         "baseline high_high always included")
    ap.add_argument("--merge-into", type=str, default=None,
                    help="existing result JSON to merge new arms into")
    args = ap.parse_args()

    if args.child_out:
        child(args.slots, args.child_out)
        return

    arms = dict(ARMS)
    if args.arms:
        keep = set(args.arms.split(",")) | {"high_high"}
        arms = {k: v for k, v in arms.items() if k in keep}

    tmp = tempfile.mkdtemp(prefix="precision_masks_")
    masks = {}
    t0 = time.perf_counter()
    for arm, env in arms.items():
        out = os.path.join(tmp, arm + ".npz")
        t_arm = time.perf_counter()
        subprocess.run(
            [sys.executable, os.path.abspath(__file__),
             "--slots", str(args.slots), "--child-out", out],
            env={**os.environ, **env}, check=True, cwd=_ROOT)
        with np.load(out) as z:
            masks[arm] = {k: z[k] for k in z.files}
        print(f"arm {arm}: {time.perf_counter() - t_arm:.1f}s "
              + " ".join(f"{k}:{int(v.sum())}/{len(v)}"
                         for k, v in masks[arm].items()),
              file=sys.stderr, flush=True)

    base = masks["high_high"]
    result = {
        "benchmark": "precision_decode_masks",
        "slots_per_snr": args.slots,
        "snr_db": list(SNRS),
        "geometry": {"fs": FS, "osr": [2, 2], "max_candidates": K,
                     "bp_iterations": BP_ITERS, "min_score": MIN_SCORE},
        "baseline_arm": "high_high (DFT=HIGH, BP=HIGH)",
        "arms": {},
        "wall_seconds": None,
    }
    for arm in arms:
        rows = {}
        for snr in base:
            a, b = base[snr], masks[arm][snr]
            diff = a != b
            rows[snr] = {
                "decodes": int(b.sum()),
                "baseline_decodes": int(a.sum()),
                "mask_identical": bool(not diff.any()),
                "n_slots_differing": int(diff.sum()),
                "net_decode_delta": int(b.sum()) - int(a.sum()),
            }
        result["arms"][arm] = {"env": arms[arm], "per_snr": rows}
    if args.merge_into and os.path.exists(args.merge_into):
        with open(args.merge_into) as fh:
            prior = json.load(fh)
        merged_arms = {**prior.get("arms", {}), **result["arms"]}
        prior.update(result)
        prior["arms"] = merged_arms
        result = prior
    result["wall_seconds"] = round(time.perf_counter() - t0, 1)
    # informativeness guard: the experiment proves nothing unless the
    # baseline arm actually decodes some (but not all) slots somewhere in
    # the sweep — refuse to emit an all-zero/all-one certificate
    totals = [int(base[s].sum()) for s in base]
    if not any(0 < t_ < args.slots for t_ in totals):
        print(f"UNINFORMATIVE: baseline decode counts {totals} — every "
              "SNR saturated; adjust SNRS/MIN_SCORE", file=sys.stderr)
        sys.exit(2)
    text = json.dumps(result, indent=1)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
