"""Smoke test of the FT8 decode pipeline on NVIDIA GPUs.

Drives the decoder through the entry points users call, at the widths
users run, and checks every result against the CPU backend or an exact
reference.  Run from the repo root:

    python chip_smoke.py            # one card: phases 0-5
    python chip_smoke.py --four     # four cards: the sharded stream decode

Phases (all in this one process; nvidia-smi is its only child):

0. device: a GPU, its kind and count, the card's name and power limit,
   the compile-cache directory;
1. base decode: decode_slots at batch 1024 (15-s slots at 12 kHz, osr
   2x2, K 20), compile seconds, slots/s, the compiled program's device
   memory and the process's peak, yield, and the first 16 slots decoded
   again on the CPU;
2. DEEP decode: osr 4x4, K 40, min_score 1, OSD, MF-first, batch 128 at
   -14 and -20 dB, false decodes, the CPU comparison on 8 slots, and the
   A/B timings of the GPU knob arms (MF front, OSD elimination) and of
   the waterfall's DFT GEMM against its epilogue;
3. CLI: ``--tx`` writes a WAV, which the CLI then decodes;
4. streaming: StreamSession over 60 s of audio in 1-s chunks;
5. the on-card checks of tests/gpu_checks.py.

Any failed check raises, and the process exits non-zero.  The last line
of standard output, printed only when every phase passed, is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FS = 12000.0


def log(tag: str, **values) -> None:
    print(f"[{tag}] {json.dumps(values)}", flush=True)


def process_peak_bytes() -> int:
    """The allocator's peak since the process started (never reset, so
    after the first phase it bounds every phase so far, not one)."""
    import jax
    return int(jax.devices()[0].memory_stats()["peak_bytes_in_use"])


def program_bytes(compiled) -> int:
    """Device memory one compiled program needs: its arguments, outputs
    and temporaries, less the outputs that alias arguments."""
    m = compiled.memory_analysis()
    return int(m.argument_size_in_bytes + m.output_size_in_bytes
               + m.temp_size_in_bytes - m.alias_size_in_bytes)


def compile_timed(fn, *args):
    """(compiled executable, compile seconds) for jax.jit(fn) at args."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def run_timed(compiled, *args, reps: int):
    """(last result, seconds of each rep); each rep ends in
    block_until_ready, after one warm-up call."""
    import jax

    res = jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    return res, times


def decode_sets(res, slots: int) -> list[set[bytes]]:
    """Per-slot sets of decoded payloads."""
    ok, pay = np.asarray(res.success), np.asarray(res.payload)
    return [{bytes(r) for r in pay[b][ok[b]]} for b in range(slots)]


def cell_rows(res, slots: int) -> list[list[tuple]]:
    """Per-slot decoded rows as sorted (time, freq, payload) cells: the
    row order of top-K can swap between near-equal scores, the decoded
    cells cannot."""
    ok, pay = np.asarray(res.success), np.asarray(res.payload)
    t, f = np.asarray(res.abs_time), np.asarray(res.abs_freq)
    return [sorted((int(t[b, i]), int(f[b, i]), bytes(pay[b, i]))
                   for i in np.flatnonzero(ok[b])) for b in range(slots)]


def phase_base(batch: int = 1024, chunk: int = 16, bp_chunk: int = 256,
               reps: int = 10, cpu_slots: int = 16) -> None:
    from bench import count_planted, make_batch
    from ft8_demodulator_tpu.demod.decode import decode_slots
    from ft8_demodulator_tpu.ops.waterfall import waterfall_params
    from gpu_checks import on_cpu

    p = waterfall_params(FS, 2, 2)
    waves, payloads = make_batch(np.random.default_rng(0), batch)
    nf = p.num_frames(waves.shape[1])

    def decode(w, chunk=chunk, bp_chunk=bp_chunk):
        return decode_slots(w, p, nf, max_candidates=20, min_score=10.0,
                            max_iterations=20, chunk=chunk,
                            bp_chunk=bp_chunk)

    compiled, compile_s = compile_timed(decode, waves)
    res, times = run_timed(compiled, waves, reps=reps)
    found, false = count_planted(res, payloads)
    log("base", compile_s=compile_s, slots_per_s=batch / np.median(times),
        rep_s=times, program_bytes=program_bytes(compiled),
        process_peak_bytes=process_peak_bytes(),
        yield_=f"{found}/{batch}", false_decodes=false)
    assert found == batch, f"base yield {found}/{batch}"

    ref = on_cpu(lambda w: decode(w, cpu_slots, cpu_slots),
                 waves[:cpu_slots])
    gpu_rows, cpu_rows = cell_rows(res, cpu_slots), cell_rows(ref, cpu_slots)
    same_mask = bool((np.asarray(res.success)[:cpu_slots]
                      == np.asarray(ref.success)).all())
    log("base_vs_cpu", slots=cpu_slots, row_order_identical=same_mask,
        slots_differing=sum(a != b for a, b in zip(gpu_rows, cpu_rows)))
    assert gpu_rows == cpu_rows, "base decode differs from the CPU backend"


def _deep_decoder(p, nf, chunk):
    from ft8_demodulator_tpu.demod.decode import decode_slots

    return lambda w: decode_slots(w, p, nf, max_candidates=40, min_score=1.0,
                                  use_osd=True, mf_first=True, chunk=chunk)


def phase_deep(batch: int = 128, chunk: int = 8, reps: int = 5,
               cpu_slots: int = 8, ab: bool = True) -> None:
    from bench import count_planted, make_batch
    from ft8_demodulator_tpu.ops.waterfall import waterfall_params
    from gpu_checks import on_cpu

    p = waterfall_params(FS, 4, 4)
    nf = p.num_frames(int(FS * 15))
    decode = _deep_decoder(p, nf, chunk)
    compiled = None
    batches = {}
    for snr in (-14.0, -20.0):
        waves, payloads = make_batch(np.random.default_rng(int(-snr)), batch,
                                     snr)
        batches[snr] = waves
        if compiled is None:
            compiled, compile_s = compile_timed(decode, waves)
        res, times = run_timed(compiled, waves, reps=reps)
        found, false = count_planted(res, payloads)
        ref = on_cpu(_deep_decoder(p, nf, cpu_slots), waves[:cpu_slots])
        flips = sum(a != b for a, b in zip(decode_sets(res, cpu_slots),
                                           decode_sets(ref, cpu_slots)))
        log("deep", snr_db=snr, compile_s=compile_s,
            slots_per_s=batch / np.median(times), rep_s=times,
            program_bytes=program_bytes(compiled),
            process_peak_bytes=process_peak_bytes(), yield_=f"{found}/{batch}",
            false_decodes=false, cpu_slots=cpu_slots, cpu_set_flips=flips)
        assert false == 0, f"{false} false decodes at {snr} dB"
        if snr == -14.0:
            assert flips == 0, "DEEP decode sets differ from the CPU at -14 dB"
    if ab:
        ab_timings(batches[-14.0], p, nf, chunk, reps)


def ab_timings(waves, p, nf, chunk: int, reps: int) -> None:
    """The GPU knob arms end to end at the DEEP shape, and the kernels
    against their plain forms: OSD elimination on 512 rows, the MF front
    arms, the base waterfall's DFT GEMM against its epilogue."""
    import jax
    import jax.numpy as jnp

    from ft8_demodulator_tpu.ops import osd as O
    from ft8_demodulator_tpu.ops.osd_triton import reduce_basis_triton
    from ft8_demodulator_tpu.ops.waterfall import (_block_spectrum,
                                                   _block_waterfall_tf,
                                                   waterfall_params)

    batch = waves.shape[0]
    decode = _deep_decoder(p, nf, chunk)
    for name, arm in (("FT8_MF_FRONT", "spectra"), ("FT8_MF_FRONT", "grid"),
                      ("FT8_OSD_ELIM", "jnp"), ("FT8_OSD_ELIM", "triton")):
        os.environ[name] = arm
        jax.clear_caches()          # knobs are read when the decode traces
        compiled, compile_s = compile_timed(decode, waves)
        _, times = run_timed(compiled, waves, reps=reps)
        del os.environ[name]
        log("ab_deep", knob=name, arm=arm, compile_s=compile_s,
            slots_per_s=batch / np.median(times), rep_s=times)

    # the MF front alone (spectra -> grids -> sync -> top-K -> LLRs)
    from ft8_demodulator_tpu.demod.decode import _front_slot_tf
    from ft8_demodulator_tpu.ops.sync import search_grid

    g = search_grid(p.num_freq_bins, nf, p.time_osr, p.freq_osr)
    chunked = waves.reshape(-1, chunk, waves.shape[-1])
    for arm in ("spectra", "grid"):
        os.environ["FT8_MF_FRONT"] = arm
        front = jax.jit(lambda w: jax.lax.map(jax.vmap(
            lambda x: _front_slot_tf(x, p, nf, g, 40, 1.0, True)), w))
        _, times = run_timed(front, chunked, reps=reps)
        del os.environ["FT8_MF_FRONT"]
        log("ab_mf_front", arm=arm,
            us_per_slot=1e6 * np.median(times) / batch)

    # OSD elimination on 512 candidate rows (one OSD chunk)
    rng = np.random.default_rng(9)
    ranks = np.argsort(rng.random((512, 174)), axis=1).astype(np.int32)
    a = jax.jit(O._permute_pack)(jnp.asarray(ranks))
    elim = {"jnp": jax.jit(jax.vmap(O._reduce_basis_packed)),
            "triton": reduce_basis_triton}
    for name, fn in elim.items():
        _, times = run_timed(fn, a, reps=reps)
        log("ab_osd_elimination", arm=name, rows=512,
            us_per_call=1e6 * np.median(times))
    llrs = jnp.asarray(rng.standard_normal((512, 174)).astype(np.float32))
    for arm in ("jnp", "triton"):
        os.environ["FT8_OSD_ELIM"] = arm
        jax.clear_caches()
        _, times = run_timed(jax.jit(O.osd_decode_batch), llrs, reps=reps)
        del os.environ["FT8_OSD_ELIM"]
        log("ab_osd_decode", arm=arm, rows=512,
            us_per_call=1e6 * np.median(times))

    # base waterfall: the DFT GEMM alone (at TF32 and at the GPU's
    # bf16x3 default), the epilogue alone, both
    pb = waterfall_params(FS, 2, 2)
    nfb = pb.num_frames(int(FS * 15))
    wb = waves                      # 15-s slots at 12 kHz
    _, t_tf32 = run_timed(jax.jit(
        lambda w: _block_spectrum(w, pb, nfb, "default")), wb, reps=reps)
    gemm = jax.jit(lambda w: _block_spectrum(w, pb, nfb))
    spec, t_gemm = run_timed(gemm, wb, reps=reps)
    _, t_epi = run_timed(jax.jit(lambda s: _block_waterfall_tf(s, pb, nfb)),
                         spec, reps=reps)
    _, t_both = run_timed(jax.jit(lambda w: _block_waterfall_tf(
        _block_spectrum(w, pb, nfb), pb, nfb)), wb, reps=reps)
    nb, kx = nfb + pb.time_osr - 1, pb.num_freq_bins + 2 * pb.freq_osr
    gemm_flops = 2 * 2 * nb * pb.hop * kx
    epi_bytes = 4 * (2 * nb * kx + nfb * pb.num_freq_bins)
    n = wb.shape[0]
    log("ab_waterfall", slots=n,
        gemm_us_per_slot=1e6 * np.median(t_gemm) / n,
        gemm_tf32_us_per_slot=1e6 * np.median(t_tf32) / n,
        gemm_bound_us_tf32=1e6 * gemm_flops / 495e12,
        epilogue_us_per_slot=1e6 * np.median(t_epi) / n,
        epilogue_bound_us_hbm=1e6 * epi_bytes / 3.35e12,
        fused_us_per_slot=1e6 * np.median(t_both) / n)


def phase_cli() -> None:
    from ft8_demodulator_tpu import cli

    msg = "CQ K1ABC FN42"
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        wav = os.path.join(d, "cq.wav")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc_tx = cli.main(["--tx", msg, "--tx-snr", "0", "--tx-seed", "1",
                              wav])
        assert rc_tx == 0 and os.path.exists(wav), out.getvalue()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main([wav])
        wall = time.perf_counter() - t0
    lines = [ln for ln in out.getvalue().splitlines() if msg in ln]
    log("cli", rc=rc, wall_s=wall, lines=lines)
    assert rc == 0 and lines, out.getvalue()


def phase_stream(seconds: int = 60) -> None:
    """StreamSession over `seconds` of 12 kHz audio fed in 1-s chunks, with
    four planted transmissions (one straddling a block edge); each must
    decode exactly once.  Two sessions: the first pays the compiles."""
    from ft8_demodulator_tpu.demod.stream_session import StreamSession
    from ft8_demodulator_tpu.ops.gfsk import ft8_passband

    rng = np.random.default_rng(4)
    audio = rng.standard_normal(int(FS * seconds)).astype(np.float32)
    planted = {}
    for start, f0 in ((0.5, 600.0), (14.0, 1100.0), (31.0, 1600.0),
                      (46.5, 2100.0)):
        payload = rng.integers(0, 256, 10).astype(np.uint8)
        payload[9] &= 0xF8
        sig = np.asarray(ft8_passband(payload, FS, f0, 0.0))
        i = int(start * FS)
        audio[i: i + len(sig)] += sig * np.sqrt(10 ** (-8 / 10) / np.mean(
            sig ** 2))
        planted[bytes(payload)] = start
    for run in ("cold", "warm"):
        sess = StreamSession(FS)
        rows = []
        t0 = time.perf_counter()
        for i in range(seconds):
            rows += sess.feed(audio[int(i * FS): int((i + 1) * FS)])
        rows += sess.flush()
        wall = time.perf_counter() - t0
        counts = {}
        for r in rows:
            counts[r.message.payload] = counts.get(r.message.payload, 0) + 1
        log("stream", run=run, audio_s=seconds, wall_s=wall,
            audio_s_per_s=seconds / wall, decodes=len(rows),
            planted_once=sum(counts.get(k, 0) == 1 for k in planted))
        assert counts == {k: 1 for k in planted}, counts


def phase_checks() -> None:
    import gpu_checks

    for check in gpu_checks.CHECKS:
        t0 = time.perf_counter()
        out = check()
        log("check", name=check.__name__, wall_s=time.perf_counter() - t0,
            **out)


def planted_stream(channels: int = 2, seconds: int = 30):
    """(channels, seconds * FS) audio at -10 dB with three transmissions
    per channel, one straddling the 15-s block edge; and the planted
    (channel, payload) set."""
    from ft8_demodulator_tpu.ops.gfsk import ft8_passband

    rng = np.random.default_rng(11)
    audio = rng.standard_normal((channels, int(FS * seconds))) \
        .astype(np.float32)
    planted = set()
    for c in range(channels):
        for start, f0 in ((1.0, 700.0), (13.5, 1300.0), (16.5, 1900.0)):
            payload = rng.integers(0, 256, 10).astype(np.uint8)
            payload[9] &= 0xF8
            sig = np.asarray(ft8_passband(payload, FS, f0 + 150.0 * c, 0.0))
            i = int(start * FS)
            audio[c, i: i + len(sig)] += sig * np.sqrt(
                10 ** (-10 / 10) / np.mean(sig ** 2))
            planted.add((c, bytes(payload)))
    return audio, planted


def sharded_decode(audio, mesh, reps: int = 3):
    """decode_stream_sharded over `mesh`, the stream padded to whole hops
    per block as decode_stream pads it; returns (input, result, decoded
    (channel, payload) set, seconds per decode)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ft8_demodulator_tpu.ops.waterfall import waterfall_params
    from ft8_demodulator_tpu.parallel.streaming import decode_stream_sharded

    p = waterfall_params(FS, 2, 2)
    n_stream = mesh.shape["stream"]
    block = -(-audio.shape[1] // (n_stream * p.hop)) * p.hop
    x = np.pad(audio, ((0, 0), (0, block * n_stream - audio.shape[1])))
    x = jax.device_put(x, NamedSharding(mesh, P("channel", "stream")))
    (res, _), times = run_timed(
        lambda a: decode_stream_sharded(a, p, mesh), x, reps=reps)
    ok, pay = np.asarray(res.success), np.asarray(res.payload)
    found = {(c, bytes(pay[c, b, i])) for c, b, i in zip(*np.nonzero(ok))}
    return x, res, found, float(np.median(times))


def phase_four() -> None:
    import jax

    from ft8_demodulator_tpu.parallel.mesh import make_mesh

    devs = jax.devices()[:4]
    assert len(devs) == 4, f"--four needs 4 devices, found {len(devs)}"
    audio, planted = planted_stream()
    x4, res4, found4, t4 = sharded_decode(
        audio, make_mesh(stream=2, channel=2, devices=devs))
    _, _, found1, t1 = sharded_decode(
        audio, make_mesh(stream=1, channel=1, devices=devs[:1]))
    in_devs = {d.id for d in x4.sharding.device_set}
    out_devs = {d.id for d in res4.success.sharding.device_set}
    log("four", mesh="channel=2 x stream=2", planted=len(planted),
        found_4=len(found4), found_1=len(found1),
        identical=found4 == found1, decode_s_4=t4, decode_s_1=t1,
        input_devices=sorted(in_devs), output_devices=sorted(out_devs))
    assert found4 == found1 == planted, (found4, found1, planted)
    assert len(in_devs) == len(out_devs) == 4
    peaks = [int(d.memory_stats()["peak_bytes_in_use"]) for d in devs]
    log("four_memory", peak_bytes_per_device=peaks)
    assert all(b > 0 for b in peaks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded stream decode on 4 cards "
                         "against one card")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs an NVIDIA GPU; JAX found "
              f"{dev.platform!r}", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from bench import gpu_card
    from ft8_demodulator_tpu.utils.cache import enable_compilation_cache

    cache_dir = enable_compilation_cache()
    name = gpu_card()
    log("device", platform=dev.platform, kind=dev.device_kind,
        count=len(jax.devices()), jax=jax.__version__, card=name,
        compile_cache=cache_dir)
    t0 = time.perf_counter()
    if args.four:
        phase_four()
    else:
        for phase in (phase_base, phase_deep, phase_cli, phase_stream,
                      phase_checks):
            t = time.perf_counter()
            phase()
            log("phase_done", phase=phase.__name__,
                wall_s=time.perf_counter() - t)
    log("done", wall_s=time.perf_counter() - t0)
    print(f"card: {name}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
