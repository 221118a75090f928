"""Online streaming decode session with checkpoint/resume.

SURVEY §5: the reference's only "resume" story is .npy stage artifacts.
Here a StreamSession consumes an unbounded audio stream in arbitrary-sized
feeds, decodes each completed block (with a one-frame lookahead so
transmissions straddling block edges decode exactly once), deduplicates
across blocks, and can snapshot its full state to disk and resume later —
per-slot decode state persistence for long-running receivers.

Dispatch architecture: the session crosses the host/device boundary as
rarely as possible.

* ONE fused jitted program per completed block — waterfall, sync,
  BP(+OSD), CRC, retries, SNR — returning one packed (K, 18) float32
  array; the host fetches that single array per block.
* Samples upload once per BLOCK, not per feed: the host buffer is
  sliced and shipped as one ~1.3 MB transfer when a block completes
  (the block/lookahead overlap is re-uploaded).  A per-feed device page
  ring lost to this on a high-latency link; it is to be tried again
  over the GPU's host link (ROADMAP §1.7).
* `pipeline_depth > 0` (opt-in) defers result fetching: up to that many
  blocks stay in flight and their rows are returned by a LATER feed()
  (or flush()), hiding fetch latency behind subsequent dispatch work.
  Undelivered raw results survive save()/load().

The per-block SNR estimate runs under a lax.cond so idle blocks (the
common monitoring case) skip its grid-median sort on device.  Reference
anchor for the feed cadence: the blocking SDR buffer loop
pluto-sdr/receive.py:34-37.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..config import DecoderConfig, STANDARD
from ..ops.sync import SearchGrid
from ..ops.waterfall import WaterfallParams, waterfall_real
from ..protocol import constants as C
from ..protocol.message import CallsignHashTable, unpack_message
from .types import FT8Decode, FT8DecodeStatus, FT8Message

__all__ = ["StreamSession"]

# packed result column layout (K rows, float32 — every field is exactly
# representable: success 0/1, CRC-14 <= 16383, payload bytes <= 255)
_COL_SUCCESS, _COL_CRC, _COL_CRC_EXT, _COL_ERRS = 0, 1, 2, 3
_COL_TIME, _COL_FREQ, _COL_SCORE, _COL_SNR = 4, 5, 6, 7
_COL_PAYLOAD = 8                      # 10 payload byte columns
_PACKED_COLS = _COL_PAYLOAD + C.PAYLOAD_BYTES


@functools.partial(jax.jit, static_argnames=("p", "g", "cfg", "num_frames",
                                             "valid_frames"))
def _decode_block_packed(chunk: jnp.ndarray, p: WaterfallParams,
                         g: SearchGrid, cfg: DecoderConfig,
                         num_frames: int, valid_frames: int) -> jnp.ndarray:
    """One streaming block, fully fused: audio -> packed (K, 18) results.

    Everything the session needs from the device crosses the boundary in
    this single array (one fetch per block); the SNR estimate runs only
    when something decoded (lax.cond keeps idle blocks cheap).
    """
    from .decode import (coherent_retry, decode_waterfall,
                         decode_waterfall_mf, estimate_snr, mf_retry)

    mag = waterfall_real(chunk, p, num_frames)
    refine = bool(getattr(cfg, "mf_refine", False))
    if getattr(cfg, "mf_first", False):
        res = decode_waterfall_mf(mag, chunk, p, g, 0, 0,
                                  cfg.max_candidates, cfg.min_score,
                                  cfg.max_iterations, cfg.use_osd,
                                  mf_refine=refine)
    else:
        res = decode_waterfall(mag, g, cfg.max_candidates, cfg.min_score,
                               cfg.max_iterations, cfg.use_osd)
        if getattr(cfg, "use_mf", False):
            res = mf_retry(chunk, p, res, 0, 0, cfg.max_iterations,
                           cfg.use_osd, mf_refine=refine)
    if getattr(cfg, "coherent", False):
        res = coherent_retry(chunk, p, res, 0, 0, cfg.max_iterations,
                             cfg.use_osd)

    snr = jax.lax.cond(
        jnp.any(res.success),
        lambda: estimate_snr(mag, res.payload, res.abs_time, res.abs_freq,
                             p.time_osr, p.freq_osr,
                             valid_frames=valid_frames),
        lambda: jnp.full(res.success.shape, -jnp.inf, jnp.float32))

    cols = [res.success, res.crc, res.crc_extracted, res.ldpc_errors,
            res.abs_time, res.abs_freq, res.score, snr]
    head = jnp.stack([c.astype(jnp.float32) for c in cols], axis=1)
    return jnp.concatenate([head, res.payload.astype(jnp.float32)], axis=1)


class StreamSession:
    """Incremental decoder over a continuous sample stream."""

    def __init__(self, fs: float, config: DecoderConfig = STANDARD,
                 block_seconds: float = float(C.SLOT_PERIOD_S),
                 pipeline_depth: int = 0):
        self.fs = float(fs)
        self.config = config
        self.p = config.waterfall(fs)
        # block is a whole number of hops; lookahead covers one full frame
        hops = max(1, int(round(block_seconds * fs / self.p.hop)))
        self.block_len = hops * self.p.hop
        self.lookahead = (C.NUM_SYMBOLS + 1) * self.p.nperseg
        self.pipeline_depth = int(pipeline_depth)
        self._buffer = np.zeros(0, np.float32)
        self._offset_samples = 0      # absolute sample index of buffer[0]
        self._seen: set[tuple[bytes, int]] = set()
        # dispatched-but-unfetched block results: (device_array,
        # frame_offset)
        self._pending: list[tuple[jnp.ndarray, int]] = []
        # fetched success rows not yet formatted/delivered:
        # (packed_row ndarray, frame_offset)
        self._undelivered: list[tuple[np.ndarray, int]] = []
        # session-owned callsign hash cache: <CALL> resolutions learnt on
        # this band stay with this session (not process-global) and
        # survive save/load (VERDICT r2 missing #3 / weak #6)
        self.hash_table = CallsignHashTable()

    def unpack(self, payload) -> str:
        """Message text for a decoded payload, resolving hashed calls
        against (and teaching) this session's own hash table."""
        return unpack_message(payload, hash_table=self.hash_table)

    # -- streaming -----------------------------------------------------------

    def feed(self, samples: np.ndarray) -> list[FT8Decode]:
        """Append samples; decode any newly-completed blocks.

        With the default ``pipeline_depth=0`` every completed block's
        rows return from this call.  With depth > 0 up to that many
        block results stay in flight on the device and their rows are
        returned by a later feed() or flush() — same rows, same order,
        lower host-sync overhead on high-latency links.
        """
        chunk = np.asarray(samples, np.float32)
        if chunk.size:
            self._buffer = np.concatenate([self._buffer, chunk])
        while len(self._buffer) >= self.block_len + self.lookahead:
            self._dispatch_block()
        self._fetch_pending(keep=self.pipeline_depth)
        return self._deliver()

    def flush(self) -> list[FT8Decode]:
        """Decode whatever remains (end of stream).

        The final partial block searches EVERY remaining start time — also
        the ones past the last full block boundary — so a transmission
        clipped at the end of the capture is still found.
        """
        while len(self._buffer) >= self.block_len + self.lookahead:
            self._dispatch_block()
        if len(self._buffer) >= self.p.nperseg:
            self._dispatch_block(final=True)
        self._fetch_pending(keep=0)
        return self._deliver()

    def _device_chunk(self, take: int) -> jnp.ndarray:
        """The next block's samples as one device transfer."""
        length = self.block_len + self.lookahead
        chunk = self._buffer[:take]
        if take < length:
            chunk = np.pad(chunk, (0, length - take))
        return jnp.asarray(chunk)

    def _dispatch_block(self, final: bool = False) -> None:
        """Launch the next block's fused decode; the un-fetched device
        result queues on self._pending."""
        from ..ops.sync import PRE_ROLL_SYMBOLS

        take = min(len(self._buffer), self.block_len + self.lookahead)
        chunk_d = self._device_chunk(take)
        num_frames = self.p.num_frames(self.block_len + self.lookahead)
        block_frames = self.block_len // self.p.hop
        # the very first block scans the slot decoder's 10-symbol pre-roll
        # (a transmission clipped at capture start still decodes); a final
        # flush block scans every start time backed by real samples
        t_start = -PRE_ROLL_SYMBOLS * self.p.time_osr \
            if self._offset_samples == 0 else 0
        t_stop = self.p.num_frames(take) if final else block_frames
        g = SearchGrid(
            time_osr=self.p.time_osr, freq_osr=self.p.freq_osr,
            num_blocks=num_frames // self.p.time_osr,
            t_start=t_start, num_times=t_stop - t_start,
            num_freqs=max(0, self.p.num_freq_bins - 7 * self.p.freq_osr),
        )
        packed = _decode_block_packed(chunk_d, self.p, g, self.config,
                                      num_frames,
                                      self.p.num_frames(take))
        self._pending.append((packed, self._offset_samples // self.p.hop))
        consumed = take if final else self.block_len
        self._buffer = self._buffer[consumed:]
        self._offset_samples += consumed

    def _fetch_pending(self, keep: int) -> None:
        """Fetch pending block results (one array fetch each) down to
        `keep` still in flight; success rows queue for delivery."""
        while len(self._pending) > keep:
            packed_d, frame_offset = self._pending.pop(0)
            packed = np.asarray(packed_d)
            for row in packed[packed[:, _COL_SUCCESS] > 0]:
                self._undelivered.append((row, frame_offset))

    def _deliver(self) -> list[FT8Decode]:
        """Format + dedup all fetched-but-undelivered rows."""
        out: list[FT8Decode] = []
        hop_seconds = C.SYMBOL_PERIOD_S / self.p.time_osr
        freq_step = C.TONE_SPACING_HZ / self.p.freq_osr
        for row, frame_offset in self._undelivered:
            snr = float(row[_COL_SNR])
            if snr < -26.0:
                continue    # implausibly weak: CRC-lucky false accept
            t_abs = int(row[_COL_TIME]) + frame_offset
            payload = bytes(int(v) for v in
                            row[_COL_PAYLOAD: _COL_PAYLOAD
                                + C.PAYLOAD_BYTES])
            # payload-keyed dedup: CRC-14 collisions must not drop messages
            key = (payload,
                   int(round(t_abs * hop_seconds / C.SLOT_PERIOD_S)))
            if key in self._seen:
                continue
            self._seen.add(key)
            h = int(row[_COL_CRC])
            out.append(FT8Decode(
                message=FT8Message(payload=payload, hash=h),
                status=FT8DecodeStatus(
                    ldpc_errors=int(row[_COL_ERRS]),
                    crc_extracted=int(row[_COL_CRC_EXT]),
                    crc_calculated=h),
                time_sec=t_abs * hop_seconds,
                freq_hz=float(row[_COL_FREQ]) * freq_step,
                score=float(row[_COL_SCORE]),
                # same WSJT-X-plausible clamp as decode_ft8_message's
                # _format_results (+30 means ">= +30")
                snr_db=round(min(max(snr, -30.0), 30.0), 1),
            ))
        self._undelivered.clear()
        return out

    # -- checkpoint / resume ---------------------------------------------------

    def save(self, path: str) -> None:
        """Snapshot the full session state to an .npz checkpoint.

        In-flight (pipeline_depth > 0) block results are fetched first
        and persisted as raw undelivered rows, so nothing is lost and
        nothing double-reports after resume.
        """
        self._fetch_pending(keep=0)
        undelivered = np.array(
            [np.concatenate([row, [off]]) for row, off in self._undelivered],
            np.float64).reshape(-1, _PACKED_COLS + 1)
        seen = np.array(
            [list(payload) + [slot] for payload, slot in sorted(self._seen)],
            dtype=np.int64).reshape(-1, C.PAYLOAD_BYTES + 1)
        np.savez(path, fs=self.fs, buffer=self._buffer,
                 offset=self._offset_samples, seen=seen,
                 config=np.array(list(self.config), dtype=np.float64),
                 block_seconds=self.block_len / self.fs,
                 hash_calls=np.asarray(self.hash_table.calls()),
                 undelivered=undelivered)

    @classmethod
    def load(cls, path: str) -> "StreamSession":
        data = np.load(path)
        cfgvals = data["config"]
        cfg = DecoderConfig(
            bins_per_tone=int(cfgvals[0]), steps_per_symbol=int(cfgvals[1]),
            max_candidates=int(cfgvals[2]), min_score=float(cfgvals[3]),
            max_iterations=int(cfgvals[4]),
            use_osd=bool(cfgvals[5]) if len(cfgvals) > 5 else False,
            use_mf=bool(cfgvals[6]) if len(cfgvals) > 6 else False,
            mf_first=bool(cfgvals[7]) if len(cfgvals) > 7 else False,
            mf_refine=bool(cfgvals[8]) if len(cfgvals) > 8 else False,
            coherent=bool(cfgvals[9]) if len(cfgvals) > 9 else False)
        sess = cls(float(data["fs"]), cfg,
                   block_seconds=float(data["block_seconds"]))
        sess._buffer = data["buffer"].astype(np.float32)
        sess._offset_samples = int(data["offset"])
        sess._seen = {(bytes(int(v) for v in row[:-1]), int(row[-1]))
                      for row in data["seen"]}
        if "undelivered" in data:     # pre-r5 checkpoints lack the queue
            sess._undelivered = [
                (row[:-1].astype(np.float32), int(row[-1]))
                for row in data["undelivered"]]
        if "hash_calls" in data:      # pre-r3 checkpoints lack the table
            sess.hash_table = CallsignHashTable(
                str(c) for c in data["hash_calls"])
        return sess
