"""Command-line decoder: WAV in -> decoded FT8 messages out.

Equivalent of the reference's from_wave.py CLI
(src/tests/demodulator/from_wave.py:180-214), including optional
frequency-drift correction, without the in-decoder plotting.

    python -m ft8_demodulator_tpu.cli capture.wav --freq-min 300 --freq-max 900
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ft8_demodulator_tpu",
        description="Decode FT8 messages from a WAV capture",
    )
    p.add_argument("wave_file", help="input WAV path")
    p.add_argument("--freq-min", type=float, default=None,
                   help="minimum frequency (Hz)")
    p.add_argument("--freq-max", type=float, default=None,
                   help="maximum frequency (Hz)")
    p.add_argument("--time-min", type=float, default=None,
                   help="minimum time (s)")
    p.add_argument("--time-max", type=float, default=None,
                   help="maximum time (s)")
    p.add_argument("--bins-per-tone", type=int, default=2,
                   help="frequency bins per FT8 tone (freq oversampling)")
    p.add_argument("--steps-per-symbol", type=int, default=2,
                   help="time steps per FT8 symbol (time oversampling)")
    p.add_argument("--max-candidates", type=int, default=20)
    p.add_argument("--min-score", type=float, default=10.0)
    p.add_argument("--min-z", type=float, default=2.0,
                   help="(--stack R>=2) candidate threshold on the stacked "
                        "linear Costas z-statistic, in noise standard "
                        "deviations (the stacked search statistic; "
                        "--min-score applies to single-slot decoding)")
    p.add_argument("--max-iterations", type=int, default=20,
                   help="LDPC belief-propagation iterations")
    p.add_argument("--correction", action="store_true",
                   help="apply frequency-drift correction before decoding")
    p.add_argument("--no-dedup", action="store_true",
                   help="report one row per surviving candidate "
                        "(reference-compatible duplicates)")
    p.add_argument("--stream", action="store_true",
                   help="decode through the streaming session (fixed-shape "
                        "blocks: long captures never recompile; reported "
                        "times are absolute within the file)")
    p.add_argument("--block-seconds", type=float, default=15.0,
                   help="streaming block size in seconds (with --stream)")
    p.add_argument("--metrics", action="store_true",
                   help="print structured per-slot decode metrics as JSON")
    p.add_argument("--passes", type=int, default=1,
                   help="decode passes; >1 subtracts decoded signals and "
                        "re-decodes the residual (recovers transmissions "
                        "buried under stronger co-channel ones)")
    p.add_argument("--osd", action="store_true",
                   help="layer ordered-statistics decoding over BP "
                        "(deeper decodes, beyond the reference)")
    p.add_argument("--mf", action="store_true",
                   help="matched-filter LLR retry for candidates BP/OSD "
                        "could not decode (~+1.3 dB, beyond the reference)")
    p.add_argument("--mf-first", action="store_true",
                   help="decode every candidate straight from matched-"
                        "filter LLRs in one pass (with --mf; same "
                        "sensitivity, ~2x faster; slightly lower crowded-"
                        "band yield — see docs/DESIGN_NOTES.md)")
    p.add_argument("--mf-refine", action="store_true",
                   help="sub-grid time/frequency offset search before "
                        "matched-filter extraction (with --mf/--mf-first): "
                        "recovers up to ~3 dB of off-grid quantisation "
                        "loss on real-world signals")
    p.add_argument("--stack", type=int, default=1, metavar="R",
                   help="treat the capture as consecutive 15-s cycles of a "
                        "REPEATING transmission (beacon) and decode a "
                        "SLIDING ring of the newest R cycles after each "
                        "one completes (demod.BeaconSession: every cycle "
                        "in the file participates, results deduplicate "
                        "across the session, times are absolute) — "
                        "noncoherent combining, ~+3.5 dB at R=4 (with "
                        "--correction: each cycle is drift-corrected "
                        "independently first).  Stacked decoding always "
                        "uses matched-filter LLRs (--mf/--mf-first are "
                        "implied); combine with --coherent (~-24.5 dB at "
                        "R=8) and/or --ap; --mf-refine is not supported")
    p.add_argument("--deep", action="store_true",
                   help="high-sensitivity preset: osr 4x4, 40 candidates, "
                        "min-score 1, OSD (only fills in options you did "
                        "not set explicitly — e.g. --deep --max-candidates "
                        "100 keeps 100)")
    p.add_argument("--coherent", action="store_true",
                   help="coherent matched-filter retry: project complex "
                        "symbol correlations onto the transmission's "
                        "common carrier-phase track (FT8's modulation "
                        "index is exactly 1) — the deepest single-"
                        "transmission decoder here (~+1.5 dB past "
                        "--mf-refine at the off-grid cliff; includes its "
                        "own time/frequency offset search)")
    p.add_argument("--ap", action="store_true",
                   help="a-priori decoding: retry failed candidates with "
                        "known payload bits clamped in the LDPC decoder "
                        "(WSJT-X-style 'CQ ? ?' hypothesis, ~+1 dB, zero "
                        "false accepts measured)")
    p.add_argument("--ap-calls", metavar="'MYCALL [DXCALL]'", default=None,
                   help="implies --ap and adds the 'MYCALL ? ?' (and with "
                        "a second call the full-QSO and RRR/RR73/73) "
                        "hypotheses (~+2 dB with both calls known)")
    p.add_argument("--format", choices=("plain", "json", "alltxt"),
                   default="plain",
                   help="decode output format: plain (default, one block "
                        "per decode), json (one JSON object per line — "
                        "machine readable), alltxt (WSJT-X ALL.TXT-style "
                        "single-line rows)")
    p.add_argument("--refine-fixes", action="store_true",
                   help="refine each decoded message's reported time and "
                        "frequency with a coherent known-payload position "
                        "fix (beacon tracker seeded by the decode): "
                        "~0.05 Hz instead of the candidate grid cell — "
                        "for Doppler tracking and logging")
    p.add_argument("--debug-nans", action="store_true",
                   help="enable jax_debug_nans: fail loudly at the first "
                        "NaN produced inside any jitted decode stage")
    tx = p.add_argument_group("transmit (generate a WAV instead of decoding)")
    tx.add_argument("--tx", metavar="MESSAGE", default=None,
                    help='generate: pack MESSAGE ("CQ K1ABC FN42", free '
                         "text, ...) into an FT8 transmission and write a "
                         "15-s WAV to wave_file (which becomes the OUTPUT "
                         "path)")
    tx.add_argument("--fs", type=float, default=12000.0,
                    help="(--tx) sample rate in Hz")
    tx.add_argument("--f0", type=float, default=1000.0,
                    help="(--tx) base tone frequency in Hz")
    tx.add_argument("--tx-start", type=float, default=0.5,
                    help="(--tx) transmission start time within the slot (s)")
    tx.add_argument("--tx-snr", type=float, default=None, metavar="DB",
                    help="(--tx) add white noise at this full-band SNR; "
                         "omit for a clean waveform")
    tx.add_argument("--tx-seed", type=int, default=None,
                    help="(--tx) noise seed for reproducible files; "
                         "default: fresh entropy per invocation (so R "
                         "generated repeats carry independent noise, as "
                         "the --stack workflow requires)")
    return p


def _generate(args) -> int:
    import numpy as np

    from .io import write_wave_file
    from .ops.gfsk import ft8_passband
    from .protocol import pack_message, unpack_message

    try:
        payload = pack_message(args.tx)
    except ValueError as e:
        print(f"Error: cannot pack message: {e}", file=sys.stderr)
        return 1
    wave = np.asarray(ft8_passband(payload, args.fs, args.f0, 0.0))
    n = int(args.fs * 15)
    start = int(args.tx_start * args.fs)
    if start < 0 or start + len(wave) > n:
        print(f"Error: transmission ({len(wave) / args.fs:.2f} s at "
              f"{args.tx_start:.2f} s) does not fit a 15-s slot",
              file=sys.stderr)
        return 1
    sig = np.zeros(n, np.float32)
    sig[start: start + len(wave)] = wave
    if args.tx_snr is not None:
        sp = float(np.mean(wave ** 2))
        rng = np.random.default_rng(args.tx_seed)
        sig += rng.standard_normal(n).astype(np.float32) \
            * np.sqrt(sp / 10 ** (args.tx_snr / 10))
    sig *= 0.8 / np.max(np.abs(sig))
    write_wave_file(args.wave_file, sig, args.fs)
    print(f"Wrote {args.wave_file}: 15.00 s @ {args.fs:.0f} Hz, "
          f"f0 {args.f0:.1f} Hz"
          + ("" if args.tx_snr is None else f", SNR {args.tx_snr:+.1f} dB"))
    print(f"Message: {unpack_message(payload)}")
    print(f"Payload: {payload.tobytes().hex()}")
    return 0


def main(argv=None) -> int:
    # reuse compiled programs across invocations
    from .utils.cache import enable_compilation_cache
    enable_compilation_cache()
    parser = build_parser()
    argv_list = list(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(argv_list)
    # options the user actually typed (vs argparse defaults), so presets
    # like --deep never silently override an explicit flag
    explicit = {
        a.dest for a in parser._actions
        if any(tok == opt or tok.startswith(opt + "=")
               for tok in argv_list for opt in a.option_strings)
    }
    if args.tx is not None:
        if args.stream or args.stack > 1:
            parser.error("--tx generates a WAV; it does not combine with "
                         "--stream/--stack")
        return _generate(args)
    # --ap-calls implies --ap; the combined value feeds decode ap= directly
    args.ap = args.ap_calls if args.ap_calls else args.ap
    if args.stream:
        unsupported = [name for name, val in [
            ("--freq-min", args.freq_min), ("--freq-max", args.freq_max),
            ("--time-min", args.time_min), ("--time-max", args.time_max),
        ] if val is not None]
        if args.passes != 1:
            unsupported.append("--passes")
        if args.metrics:
            unsupported.append("--metrics")
        if args.no_dedup:
            unsupported.append("--no-dedup")
        if args.ap:
            unsupported.append("--ap")
        if args.refine_fixes:
            unsupported.append("--refine-fixes")
        if unsupported:
            parser.error("--stream does not support: "
                         + ", ".join(unsupported))
    if args.stack > 1:
        unsupported = [name for name, bad in [
            ("--stream", args.stream), ("--metrics", args.metrics),
            ("--mf-refine", args.mf_refine),
            ("--freq-min", args.freq_min is not None),
            ("--freq-max", args.freq_max is not None),
            ("--time-min", args.time_min is not None),
            ("--time-max", args.time_max is not None),
            ("--passes", args.passes != 1),
            # session-wide dedup is what makes the sliding ring's
            # re-decodes of the same beacon report once; it cannot be off
            ("--no-dedup", args.no_dedup),
        ] if bad]
        if unsupported:
            parser.error("--stack does not support: "
                         + ", ".join(unsupported))
    if not os.path.exists(args.wave_file):
        print(f"Error: File {args.wave_file} does not exist", file=sys.stderr)
        return 1

    # defer heavy imports until after arg parsing
    import numpy as np
    from .demod import decode_ft8_message
    from .io import read_wave_file

    if args.debug_nans:
        from .utils.debug import enable_nan_debugging
        enable_nan_debugging()

    if args.deep:
        # the preset only fills in options the user did not type, so
        # explicit flags (e.g. --deep --max-candidates 100) win
        from .config import DEEP_SEARCH as _D
        for name, preset in [("bins_per_tone", _D.bins_per_tone),
                             ("steps_per_symbol", _D.steps_per_symbol),
                             ("max_candidates", _D.max_candidates),
                             ("min_score", _D.min_score),
                             ("osd", True), ("mf", True)]:
            if name not in explicit:
                setattr(args, name, preset)

    wave_data, sample_rate = read_wave_file(args.wave_file)
    # machine-readable formats keep stdout for decode rows only
    info = sys.stdout if args.format == "plain" else sys.stderr
    print(f"Read {args.wave_file}: {len(wave_data)} samples @ {sample_rate} Hz "
          f"({len(wave_data) / sample_rate:.2f} s)", file=info)

    if args.stack > 1:
        from .demod import BeaconSession

        cycle = int(round(15.0 * sample_rate))
        n_cycles = len(wave_data) // cycle
        if n_cycles < 2:
            print("Error: --stack needs at least two full 15-s cycles of "
                  f"audio (got {len(wave_data) / sample_rate:.2f} s)",
                  file=sys.stderr)
            return 1
        # sliding ring over the WHOLE capture: every cycle participates
        # (a file with 8 cycles and --stack 4 decodes cycles 1-4, 2-5, ...
        # instead of discarding the second half); results deduplicate
        # across the session
        session = BeaconSession(
            sample_rate, max_repeats=args.stack,
            use_osd=args.osd, coherent=args.coherent, ap=args.ap,
            min_z=args.min_z, max_candidates=args.max_candidates,
            correction=args.correction,
            bins_per_tone=args.bins_per_tone,
            steps_per_symbol=args.steps_per_symbol,
            min_score=args.min_score,
            max_iterations=args.max_iterations,
            refine_fixes=args.refine_fixes)
        results = session.feed(np.asarray(wave_data))
        results += session.flush()      # partial tail, single-slot
        print(f"Stacked {n_cycles} cycles (ring of "
              f"{min(args.stack, n_cycles)})", file=info)

    if args.correction and args.stack <= 1:
        import scipy.signal
        from .beacon import correct_frequency_drift

        analytic = scipy.signal.hilbert(wave_data)
        corrected, drift_rate = correct_frequency_drift(
            analytic, sample_rate, params={
                "bins_per_tone": args.bins_per_tone,
                "steps_per_symbol": args.steps_per_symbol,
            })
        print(f"Estimated drift rate: {drift_rate * sample_rate:.2f} Hz/s",
              file=info)
        if args.stream:
            # the streaming session consumes real audio; the real part of
            # the corrected analytic signal carries the full positive band
            wave_data = np.real(corrected)
        else:
            wave_data = corrected

    if args.stack > 1:
        pass                        # results computed above
    elif args.stream:
        from .config import DecoderConfig
        from .demod.stream_session import StreamSession

        session = StreamSession(
            sample_rate,
            DecoderConfig(bins_per_tone=args.bins_per_tone,
                          steps_per_symbol=args.steps_per_symbol,
                          max_candidates=args.max_candidates,
                          min_score=args.min_score,
                          max_iterations=args.max_iterations,
                          use_osd=args.osd, use_mf=args.mf,
                          mf_first=args.mf_first,
                          mf_refine=args.mf_refine,
                          coherent=args.coherent),
            block_seconds=args.block_seconds)
        results = []
        chunk = max(session.block_len, int(sample_rate))
        for start in range(0, len(wave_data), chunk):
            results.extend(session.feed(
                np.asarray(wave_data[start: start + chunk], np.float32)))
        results.extend(session.flush())
    else:
        out = decode_ft8_message(
            wave_data, sample_rate,
            bins_per_tone=args.bins_per_tone,
            steps_per_symbol=args.steps_per_symbol,
            max_candidates=args.max_candidates,
            min_score=args.min_score,
            max_iterations=args.max_iterations,
            freq_min=args.freq_min, freq_max=args.freq_max,
            time_min=args.time_min, time_max=args.time_max,
            deduplicate=not args.no_dedup,
            return_metrics=args.metrics,
            passes=args.passes,
            use_osd=args.osd,
            use_mf=args.mf,
            mf_first=args.mf_first,
            mf_refine=args.mf_refine,
            ap=args.ap,
            coherent=args.coherent,
            refine_fixes=args.refine_fixes,
        )
        if args.metrics:
            import json
            results, metrics = out
            # info stream: machine formats keep stdout for decode rows only
            print("Metrics: " + json.dumps(metrics.asdict()), file=info)
        else:
            results = out

    if not results:
        if args.format == "plain":
            print("No FT8 messages decoded")
        return 0
    import json

    from .protocol.message import UnsupportedMessageError, unpack_message

    def text_of(r):
        try:
            return unpack_message(r.message.payload)
        except UnsupportedMessageError:
            return None

    if args.format == "json":
        for r in results:
            print(json.dumps({
                "time_sec": round(r.time_sec, 3),
                "freq_hz": round(r.freq_hz, 2),
                "score": round(r.score, 2),
                "snr_db": r.snr_db,
                "payload": r.message.payload.hex(),
                "message": text_of(r),
                "crc": r.status.crc_calculated,
                "ldpc_errors": r.status.ldpc_errors,
            }))
        return 0
    if args.format == "alltxt":
        # WSJT-X ALL.TXT-style: time snr dt freq ~ message (the leading
        # HHMMSS column becomes the in-capture offset — captures have no
        # wall-clock)
        for r in results:
            snr = 0 if r.snr_db is None else int(round(r.snr_db))
            msg = text_of(r) or r.message.payload.hex().upper()
            print(f"{r.time_sec:8.1f} {snr:3d} {r.time_sec % 15.0:4.1f} "
                  f"{r.freq_hz:7.1f} ~  {msg}")
        return 0

    print(f"\nDecoded {len(results)} FT8 message(s):")
    print("-" * 50)
    for r in results:
        print(f"Time: {r.time_sec:.2f} seconds")
        print(f"Frequency: {r.freq_hz:.1f} Hz")
        print(f"Score: {r.score:.1f}")
        if r.snr_db is not None:
            print(f"SNR: {r.snr_db:+.1f} dB")
        print(f"Payload: {r.message.payload.hex()}")
        msg = text_of(r)
        if msg is not None:
            print(f"Message: {msg}")
        print(f"CRC check: {r.status.crc_calculated}")
        print(f"LDPC errors: {r.status.ldpc_errors}")
        print("-" * 50)
    return 0


if __name__ == "__main__":
    sys.exit(main())
