"""Sharded continuous-stream decoding with overlap-save halo exchange.

The sequence-parallel path (SURVEY §2.3): a long audio stream is split into
equal blocks sharded over the mesh's ``stream`` axis; independent channels
shard over ``channel``.  Each block needs to see one full FT8 frame
(79 symbols) past its right edge so transmissions straddling a block
boundary decode exactly once — the halo travels left between devices with a
single ``jax.lax.ppermute`` per step, the sharded equivalent of the reference's
"read the neighbouring samples from the same numpy array" (it has no
streaming mode at all; nearest analog is the .npy stage chaining,
src/tests/channel/test_signal_processing.py:52).

Candidate start times are restricted to the local block, so each message is
owned by exactly one shard; a final cross-shard dedup handles the rare
double-decode of one transmission at slightly different offsets.

Multi-host safety: the compact per-shard result tuples (payload, time, freq,
success, score, ...) are ``all_gather``-ed along both mesh axes inside the
``shard_map``, and the yield counter is a ``psum`` — so the returned arrays
are fully replicated and every process of a multi-host pod can format
results from locally-addressable data (SURVEY §2.3 comm row).  On a pod,
initialise with ``jax.distributed.initialize()`` and pass the identical
host-local audio to :func:`decode_stream` on every process.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..demod.decode import decode_waterfall
from ..demod.types import FT8Decode, FT8DecodeStatus, FT8Message, \
    SlotDecodeResult
from ..ops.sync import SearchGrid
from ..ops.waterfall import WaterfallParams, waterfall_params, waterfall_real
from ..protocol import constants as C

__all__ = ["stream_halo_samples", "decode_stream_sharded", "decode_stream"]


def stream_halo_samples(p: WaterfallParams) -> int:
    """Samples of right-halo each block needs: one full frame + one symbol."""
    return (C.NUM_SYMBOLS + 1) * p.nperseg


def _local_grid(p: WaterfallParams, block_frames: int,
                ext_frames: int) -> SearchGrid:
    """Search grid owning start times [0, block) against the extended view.

    The capture-start pre-roll (the slot decoder's 10-symbol scan before
    t=0, reference ft8_decode.py:108) is deliberately NOT part of this
    grid: it would grow EVERY shard's uniform SPMD grid for columns only
    the first shard may own (measured 10-19 % of bank throughput).
    decode_stream covers it with one tiny separate program instead
    (:func:`_decode_preroll`), keeping ownership disjoint: shards own
    t >= 0, the pre-roll decode owns t < 0.
    """
    ext_blocks = ext_frames // p.time_osr
    return SearchGrid(
        time_osr=p.time_osr, freq_osr=p.freq_osr, num_blocks=ext_blocks,
        t_start=0, num_times=block_frames,
        num_freqs=max(0, p.num_freq_bins - 7 * p.freq_osr),
    )


def _decode_block(block: jnp.ndarray, halo: jnp.ndarray, p: WaterfallParams,
                  max_candidates: int, min_score: float,
                  max_iterations: int,
                  use_mf: bool = False,
                  use_osd: bool = False,
                  mf_first: bool = False,
                  mf_refine: bool = False) -> SlotDecodeResult:
    """One shard's work: extend with the right halo, decode locally-owned
    start times."""
    extended = jnp.concatenate([block, halo], axis=-1)
    ext_frames = p.num_frames(extended.shape[-1])
    block_frames = block.shape[-1] // p.hop
    mag = waterfall_real(extended, p, ext_frames)
    g = _local_grid(p, block_frames, ext_frames)
    if mf_first:
        from ..demod.decode import decode_waterfall_mf
        return decode_waterfall_mf(mag, extended, p, g, 0, 0,
                                   max_candidates, min_score,
                                   max_iterations, use_osd,
                                   mf_refine=mf_refine)
    res = decode_waterfall(mag, g, max_candidates, min_score,
                           max_iterations, use_osd)
    if use_mf:
        from ..demod.decode import mf_retry
        res = mf_retry(extended, p, res, 0, 0, max_iterations, use_osd,
                       mf_refine=mf_refine)
    return res


@functools.partial(jax.jit, static_argnames=("p", "max_candidates",
                                             "max_iterations", "use_mf",
                                             "use_osd", "mf_first",
                                             "mf_refine"))
def _decode_preroll(audio: jnp.ndarray, p: WaterfallParams,
                    max_candidates: int, min_score: float,
                    max_iterations: int,
                    use_mf: bool = False,
                    use_osd: bool = False,
                    mf_first: bool = False,
                    mf_refine: bool = False) -> SlotDecodeResult:
    """Decode ONLY the pre-roll start times (t < 0) of the capture start.

    audio: (channels, w) leading slice covering one frame past the scan;
    a transmission clipped at t=0 decodes here exactly like the slot
    decoder's pre-roll scan.  Runs once per stream, replicated (tiny).
    """
    from ..ops.sync import PRE_ROLL_SYMBOLS

    pre = PRE_ROLL_SYMBOLS * p.time_osr
    num_frames = p.num_frames(audio.shape[-1])
    g = SearchGrid(
        time_osr=p.time_osr, freq_osr=p.freq_osr,
        num_blocks=num_frames // p.time_osr,
        t_start=-pre, num_times=pre,
        num_freqs=max(0, p.num_freq_bins - 7 * p.freq_osr),
    )

    def one(wave):
        mag = waterfall_real(wave, p, num_frames)
        if mf_first:
            from ..demod.decode import decode_waterfall_mf
            return decode_waterfall_mf(mag, wave, p, g, 0, 0,
                                       max_candidates, min_score,
                                       max_iterations, use_osd,
                                       mf_refine=mf_refine)
        res = decode_waterfall(mag, g, max_candidates, min_score,
                               max_iterations, use_osd)
        if use_mf:
            from ..demod.decode import mf_retry
            res = mf_retry(wave, p, res, 0, 0, max_iterations, use_osd,
                           mf_refine=mf_refine)
        return res

    return jax.vmap(one)(audio)


@functools.partial(
    jax.jit,
    static_argnames=("p", "mesh", "max_candidates", "max_iterations",
                     "use_mf", "use_osd", "mf_first", "mf_refine"),
)
def decode_stream_sharded(audio: jnp.ndarray, p: WaterfallParams, mesh: Mesh,
                          max_candidates: int = 20, min_score: float = 10.0,
                          max_iterations: int = 20, use_mf: bool = False,
                          use_osd: bool = False, mf_first: bool = False,
                          mf_refine: bool = False
                          ) -> tuple[SlotDecodeResult, jnp.ndarray]:
    """(channels, n_samples) audio -> (stacked SlotDecodeResult, yield).

    n_samples must divide evenly into mesh.shape['stream'] blocks of whole
    hops; channels must divide by mesh.shape['channel'].  Result arrays have
    shape (channels, n_blocks, K, ...) and are FULLY REPLICATED over the
    mesh (gathered inside the shard_map), so any process may fetch them;
    the second output is the psum'd total success count (pre-dedup).
    """
    n_stream = mesh.shape["stream"]
    channels, n_samples = audio.shape
    block_len = n_samples // n_stream
    assert block_len * n_stream == n_samples
    assert block_len % p.hop == 0
    halo_len = min(stream_halo_samples(p), block_len)

    def shard_fn(local):
        """local: (channels / channel_shards, block_len) on one device."""
        head = local[:, :halo_len]
        # device i receives the head of device i+1 (zeros at the stream end)
        perm = [(i, i - 1) for i in range(1, n_stream)]
        halo = jax.lax.ppermute(head, "stream", perm)
        decode = jax.vmap(lambda b, h: _decode_block(
            b, h, p, max_candidates, min_score, max_iterations, use_mf,
            use_osd, mf_first, mf_refine))
        rows = local.shape[0]
        # XLA's decode fusions degrade at wide vmaps (see DESIGN_NOTES):
        # map narrow chunks when the channel count allows it
        chunk = next((c for c in (16, 8) if rows % c == 0 and rows > c),
                     None)
        if chunk:
            res = jax.lax.map(
                lambda args: decode(*args),
                (local.reshape(-1, chunk, local.shape[-1]),
                 halo.reshape(-1, chunk, halo.shape[-1])))
            res = jax.tree_util.tree_map(
                lambda x: x.reshape(rows, *x.shape[2:]), res)
        else:
            res = decode(local, halo)
        # (ch_local, 1, K, ...) with the stream axis restored, then gather
        # along both mesh axes so every device (hence every process of a
        # multi-host pod) holds the full result — host-side formatting
        # never touches non-addressable shards.  The gather is a disjoint
        # scatter + psum (not lax.all_gather) so shard_map's replication
        # checker can statically prove the P() out_specs.
        res = jax.tree_util.tree_map(lambda x: x[:, None], res)
        ch_idx = jax.lax.axis_index("channel")
        st_idx = jax.lax.axis_index("stream")
        n_channel = mesh.shape["channel"]

        def gather(x):
            dt = x.dtype
            xi = x if jnp.issubdtype(dt, jnp.floating) \
                else x.astype(jnp.int32)
            full = jnp.zeros((x.shape[0] * n_channel, n_stream) + x.shape[2:],
                             xi.dtype)
            start = (ch_idx * x.shape[0], st_idx) + (0,) * (x.ndim - 2)
            full = jax.lax.dynamic_update_slice(full, xi, start)
            return jax.lax.psum(full, ("channel", "stream")).astype(dt)

        gathered = jax.tree_util.tree_map(gather, res)
        n_success = jax.lax.psum(
            jnp.sum(res.success.astype(jnp.int32)), ("channel", "stream"))
        return gathered, n_success

    from jax import shard_map
    fn = shard_map(
        shard_fn, mesh=mesh,
        in_specs=P("channel", "stream"),
        out_specs=(jax.tree_util.tree_map(
            lambda _: P(), _result_spec_tree()), P()),
    )
    return fn(audio)


def _result_spec_tree() -> SlotDecodeResult:
    """A SlotDecodeResult-shaped tree usable as a tree_map template."""
    z = 0
    return SlotDecodeResult(z, z, z, z, z, z, z, z, z)


def decode_stream(audio: np.ndarray, sample_rate: float,
                  mesh: Mesh | None = None,
                  bins_per_tone: int = 2, steps_per_symbol: int = 2,
                  max_candidates: int = 20, min_score: float = 10.0,
                  max_iterations: int = 20,
                  use_mf: bool = False,
                  use_osd: bool = False,
                  mf_first: bool = False,
                  mf_refine: bool = False) -> list[FT8Decode]:
    """Host API: decode a long (or multi-channel) capture over the mesh.

    audio: (n,) or (channels, n) float samples.  The stream is padded to a
    whole number of equal blocks per stream shard.

    Multi-host: call jax.distributed.initialize() first, build the mesh
    over the global jax.devices(), and pass the SAME full audio array on
    every process; the returned list is then identical on all processes
    (results are gathered on-device before they reach the host).
    """
    from .mesh import make_mesh

    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    p = waterfall_params(sample_rate, bins_per_tone, steps_per_symbol)

    if mesh is None:
        mesh = make_mesh(stream=len(jax.devices()), channel=1)
    n_stream = mesh.shape["stream"]
    n_channel = mesh.shape["channel"]
    if audio.shape[0] % n_channel:
        reps = -(-audio.shape[0] // n_channel) * n_channel
        audio = np.pad(audio, ((0, reps - audio.shape[0]), (0, 0)))

    # pad the stream to n_stream equal blocks of whole hops
    block = -(-audio.shape[1] // (n_stream * p.hop)) * p.hop
    total = block * n_stream
    audio = np.pad(audio, ((0, 0), (0, total - audio.shape[1])))

    if jax.process_count() > 1:
        # every process holds the identical full stream; assemble the
        # process-spanning sharded jax.Array from each host's local copy
        sharding = NamedSharding(mesh, P("channel", "stream"))
        audio_in = jax.make_array_from_callback(
            audio.shape, sharding, lambda idx: audio[idx])
    else:
        audio_in = jnp.asarray(audio)
    res, n_success = decode_stream_sharded(audio_in, p, mesh,
                                           max_candidates, float(min_score),
                                           max_iterations, use_mf, use_osd,
                                           mf_first, mf_refine)
    # capture-start pre-roll: one tiny replicated program over the leading
    # slice (kept out of the sharded grids — see _local_grid)
    pre_w = min(audio.shape[1], (C.NUM_SYMBOLS + 1) * p.nperseg)
    pre_res = None
    if pre_w >= p.nperseg:
        pre_res = jax.tree_util.tree_map(np.asarray, _decode_preroll(
            jnp.asarray(audio[:, :pre_w]), p, max_candidates,
            float(min_score), max_iterations, use_mf, use_osd, mf_first,
            mf_refine))
    return _format_stream_results(
        jax.tree_util.tree_map(np.asarray, res), pre_res, int(n_success),
        p, block // p.hop)


def _format_stream_results(res, pre_res, n_success: int, p: WaterfallParams,
                           block_frames: int) -> list[FT8Decode]:
    """Stacked device results (+optional pre-roll) -> deduped FT8Decode rows.

    Shared by decode_stream and the composed-mesh decoder
    (parallel/composed.py) so their host-side semantics cannot drift."""
    if n_success == 0 and (pre_res is None or not pre_res.success.any()):
        return []

    hop_seconds = C.SYMBOL_PERIOD_S / p.time_osr
    freq_step = C.TONE_SPACING_HZ / p.freq_osr
    out: list[FT8Decode] = []
    seen: set[tuple[int, bytes, int]] = set()
    channels, blocks, k = res.success.shape
    if pre_res is not None:
        for c in range(pre_res.success.shape[0]):
            for i in range(pre_res.success.shape[1]):
                if not pre_res.success[c, i]:
                    continue
                t_abs = int(pre_res.abs_time[c, i])        # negative
                key = (c, bytes(pre_res.payload[c, i].tolist()),
                       int(round(t_abs * hop_seconds / C.SLOT_PERIOD_S)))
                if key in seen:
                    continue
                seen.add(key)
                h = int(pre_res.crc[c, i])
                out.append(FT8Decode(
                    message=FT8Message(
                        payload=bytes(pre_res.payload[c, i].tolist()),
                        hash=h),
                    status=FT8DecodeStatus(
                        ldpc_errors=int(pre_res.ldpc_errors[c, i]),
                        crc_extracted=int(pre_res.crc_extracted[c, i]),
                        crc_calculated=h),
                    time_sec=t_abs * hop_seconds,
                    freq_hz=float(pre_res.abs_freq[c, i]) * freq_step,
                    score=float(pre_res.score[c, i]),
                ))
    for c in range(channels):
        for b in range(blocks):
            for i in range(k):
                if not res.success[c, b, i]:
                    continue
                t_abs = int(res.abs_time[c, b, i]) + b * block_frames
                h = int(res.crc[c, b, i])
                # dedup key: payload within +-1 frame period per channel
                # (payload, not the 14-bit CRC — CRC collisions must not
                # drop a genuinely distinct message)
                key = (c, bytes(res.payload[c, b, i].tolist()),
                       int(round(t_abs * hop_seconds / C.SLOT_PERIOD_S)))
                if key in seen:
                    continue
                seen.add(key)
                out.append(FT8Decode(
                    message=FT8Message(
                        payload=bytes(res.payload[c, b, i].tolist()), hash=h),
                    status=FT8DecodeStatus(
                        ldpc_errors=int(res.ldpc_errors[c, b, i]),
                        crc_extracted=int(res.crc_extracted[c, b, i]),
                        crc_calculated=h),
                    time_sec=t_abs * hop_seconds,
                    freq_hz=float(res.abs_freq[c, b, i]) * freq_step,
                    score=float(res.score[c, b, i]),
                ))
    out.sort(key=lambda r: (r.time_sec, r.freq_hz))
    return out
