"""Online beacon-receiving session: stream in, stacked decodes out.

The reference is at heart a BEACON receiver (its channel fixtures and the
ft8_beacon_receiver package track one repeating transmitter), but its
decode entry points are all one-shot over a finished capture.  A
BeaconSession is the live counterpart of :func:`demod.decode_ft8_stacked`:
it consumes an unbounded sample stream in arbitrary-sized feeds, slices it
into 15-s FT8 cycles, keeps a ring of the most recent ``max_repeats``
cycles, and after each completed cycle decodes the stack of everything in
the ring — so a beacon too weak for any single cycle surfaces as soon as
enough cycles have accumulated (50 %-yield deepens from −15.5 dB at R=1
to −24.5 dB at R=8 with the coherent default in an earlier round's
sweep, benchmarks/stacking_sweep.py; see demod/stack.py).

Alignment: FT8 transmissions start on the 15-s UTC cycle boundary, so a
receiver that starts its stream on (or records the offset to) a cycle
boundary gets slot-aligned repeats for free — pass ``t0_seconds`` when the
stream starts mid-cycle.  On drifting (satellite) channels enable
``correction`` to drift-correct each cycle independently before stacking
(the complex corrected cycles stack identically; demod/stack.py).

Like StreamSession, results deduplicate across the whole session (a
beacon decoded at cycle 3 is not re-reported at cycle 4), and the full
session state snapshots to disk with save()/load() for long-running
receivers.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..protocol import constants as C
from ..protocol.message import CallsignHashTable, unpack_message
from .stack import decode_ft8_stacked
from .types import FT8Decode

__all__ = ["BeaconSession"]


class BeaconSession:
    """Incremental stacked decoder over a continuous sample stream."""

    def __init__(self, fs: float, max_repeats: int = 8,
                 use_osd: bool = True, coherent: bool = True,
                 ap: bool | str = False, min_z: float = 2.0,
                 max_candidates: int = 20,
                 correction: bool = False,
                 cycle_seconds: float = float(C.SLOT_PERIOD_S),
                 t0_seconds: float = 0.0,
                 bins_per_tone: int = 2, steps_per_symbol: int = 2,
                 min_score: float = 10.0, max_iterations: int = 20,
                 refine_fixes: bool = False):
        """fs: sample rate.  max_repeats: ring depth R.  Each decode
        stacks a FIXED (R, cycle_len) array — cycles not yet received are
        zeros, which the combiner's dead-repeat exclusion weights to 0
        exactly (demod/stack.py) — so one XLA program serves every fill
        level.  correction: per-cycle blind drift correction
        (beacon.correct_frequency_drift, at this session's
        bins_per_tone/steps_per_symbol) before stacking — the satellite
        flow.  t0_seconds: how far into the current 15-s cycle the stream
        STARTS — the leading partial cycle is zero-padded so slicing
        stays aligned to true cycle boundaries, and reported times are
        relative to that boundary.  Remaining options are
        decode_ft8_stacked's (min_score gates only R == 1 decodes — a
        max_repeats=1 session and the flush tail)."""
        if max_repeats < 1:
            raise ValueError("max_repeats must be >= 1")
        self.fs = float(fs)
        self.max_repeats = int(max_repeats)
        self.use_osd = use_osd
        self.coherent = coherent
        self.ap = ap
        self.min_z = float(min_z)
        self.max_candidates = int(max_candidates)
        self.correction = correction
        self.cycle_len = int(round(cycle_seconds * self.fs))
        self.t0_seconds = float(t0_seconds)
        self.bins_per_tone = int(bins_per_tone)
        self.steps_per_symbol = int(steps_per_symbol)
        self.min_score = float(min_score)
        self.max_iterations = int(max_iterations)
        self.refine_fixes = bool(refine_fixes)
        # zero-pad the leading partial cycle so buffer index 0 IS the
        # cycle boundary: slicing stays aligned and reported times are
        # boundary-relative with no further correction
        pad = int(round(self.t0_seconds * self.fs)) % self.cycle_len
        self._buffer = np.zeros(pad, np.float32)
        self._cycles: list[np.ndarray] = []       # newest last; <= R kept
        self._cycles_done = 0                     # total completed cycles
        self._seen: set[bytes] = set()
        # session-owned callsign hash cache (persisted in checkpoints)
        self.hash_table = CallsignHashTable()
        self._fed = False
        self._finished = False

    # -- streaming -----------------------------------------------------------

    def feed(self, samples: np.ndarray) -> list[FT8Decode]:
        """Append samples; decode after each newly-completed cycle and
        return decodes not reported earlier in the session."""
        if self._finished:
            raise RuntimeError(
                "feed() after flush(): the flush consumed a partial cycle, "
                "so later samples would misalign every subsequent slice — "
                "start a new BeaconSession (with t0_seconds) instead")
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._fed = self._fed or samples.size > 0
        self._buffer = np.concatenate([self._buffer, samples])
        out: list[FT8Decode] = []
        while len(self._buffer) >= self.cycle_len:
            cycle, self._buffer = (self._buffer[: self.cycle_len],
                                   self._buffer[self.cycle_len:])
            self._push(cycle)
            out.extend(self._decode_stack(self._ring()))
        return out

    def flush(self) -> list[FT8Decode]:
        """Decode the final partial cycle (end of stream).

        The partial tail is decoded as its own single slot (not stacked:
        it cannot hold a repeat of the beacon's full transmission aligned
        with the ring), so a transmission clipped at the end of the
        capture is still found.  Ends the session: the tail is consumed,
        and a later feed() would silently misalign — it raises instead.
        """
        self._finished = True
        if len(self._buffer) == 0 or not self._fed:
            self._buffer = np.zeros(0, np.float32)
            return []
        tail, self._buffer = self._buffer, np.zeros(0, np.float32)
        offset = self._cycles_done * self.cycle_len
        return self._decode_stack(tail[None, :], offset_samples=offset)

    # -- internals -----------------------------------------------------------

    def _push(self, cycle: np.ndarray) -> None:
        if self.correction:
            import scipy.signal

            from ..beacon import correct_frequency_drift

            corrected, _ = correct_frequency_drift(
                scipy.signal.hilbert(cycle.astype(np.float64)), self.fs,
                params={"bins_per_tone": self.bins_per_tone,
                        "steps_per_symbol": self.steps_per_symbol})
            cycle = np.asarray(corrected)
        self._cycles.append(cycle)
        if len(self._cycles) > self.max_repeats:
            self._cycles.pop(0)
        self._cycles_done += 1

    def _ring(self) -> np.ndarray:
        """Fixed-shape (max_repeats, cycle_len[, ...]) ring: cycles not yet
        received are zeros, which the stacked combiner's dead-repeat
        exclusion weights to exactly 0 — one XLA program for every fill
        level, and the partial ring decodes as the mean over live cycles.
        (The reported per-repeat SNR uses the FULL ring depth in its
        noise-median correction, so it reads a few tenths of a dB off
        until the ring fills.)"""
        live = np.stack(self._cycles)
        if live.shape[0] < self.max_repeats:
            pad = np.zeros((self.max_repeats - live.shape[0],)
                           + live.shape[1:], live.dtype)
            live = np.concatenate([pad, live])
        return live

    def _decode_stack(self, waves: np.ndarray,
                      offset_samples: int | None = None
                      ) -> list[FT8Decode]:
        if waves.shape[-1] < 1:
            return []
        rows = decode_ft8_stacked(
            waves, self.fs, use_osd=self.use_osd, coherent=self.coherent,
            ap=self.ap, min_z=self.min_z,
            max_candidates=self.max_candidates,
            bins_per_tone=self.bins_per_tone,
            steps_per_symbol=self.steps_per_symbol,
            min_score=self.min_score,
            max_iterations=self.max_iterations,
            refine_fixes=self.refine_fixes)
        if offset_samples is None:
            # times are relative to the NEWEST cycle in the ring
            offset_samples = (self._cycles_done - 1) * self.cycle_len
        out = []
        for r in rows:
            if r.message.payload in self._seen:
                continue
            self._seen.add(r.message.payload)
            out.append(dataclasses.replace(
                r, time_sec=r.time_sec + offset_samples / self.fs))
        return out

    def unpack(self, payload) -> str:
        """Message text for a decoded payload, resolving hashed calls
        against (and teaching) this session's own hash table."""
        return unpack_message(payload, hash_table=self.hash_table)

    @property
    def repeats_buffered(self) -> int:
        return len(self._cycles)

    # -- persistence (SURVEY §5 checkpoint/resume) ----------------------------

    def save(self, path: str) -> None:
        """Snapshot the full session state to an .npz."""
        cyc = np.stack(self._cycles) if self._cycles else \
            np.zeros((0, self.cycle_len), np.float32)
        np.savez(
            path, fs=self.fs, max_repeats=self.max_repeats,
            use_osd=self.use_osd, coherent=self.coherent,
            ap=np.asarray(str(self.ap)), min_z=self.min_z,
            max_candidates=self.max_candidates,
            correction=self.correction, cycle_len=self.cycle_len,
            t0_seconds=self.t0_seconds,
            bins_per_tone=self.bins_per_tone,
            steps_per_symbol=self.steps_per_symbol,
            min_score=self.min_score,
            max_iterations=self.max_iterations,
            refine_fixes=self.refine_fixes, buffer=self._buffer,
            cycles=cyc, cycles_done=self._cycles_done,
            fed=self._fed, finished=self._finished,
            seen=np.asarray([p.hex() for p in sorted(self._seen)]),
            hash_calls=np.asarray(self.hash_table.calls()))

    @classmethod
    def load(cls, path: str) -> "BeaconSession":
        z = np.load(path, allow_pickle=False)
        ap_s = str(z["ap"])
        ap: bool | str = ap_s
        if ap_s in ("True", "False"):
            ap = ap_s == "True"
        s = cls(float(z["fs"]), max_repeats=int(z["max_repeats"]),
                use_osd=bool(z["use_osd"]), coherent=bool(z["coherent"]),
                ap=ap, min_z=float(z["min_z"]),
                max_candidates=int(z["max_candidates"]),
                correction=bool(z["correction"]),
                cycle_seconds=int(z["cycle_len"]) / float(z["fs"]),
                t0_seconds=float(z["t0_seconds"]),
                bins_per_tone=int(z["bins_per_tone"]),
                steps_per_symbol=int(z["steps_per_symbol"]),
                min_score=float(z["min_score"]),
                max_iterations=int(z["max_iterations"]),
                refine_fixes=bool(z["refine_fixes"]))
        s._buffer = np.asarray(z["buffer"], np.float32)
        s._cycles = [np.asarray(c) for c in z["cycles"]]
        s._cycles_done = int(z["cycles_done"])
        s._fed = bool(z["fed"])
        s._finished = bool(z["finished"])
        s._seen = {bytes.fromhex(str(h)) for h in z["seen"]}
        if "hash_calls" in z:         # pre-r3 checkpoints lack the table
            s.hash_table = CallsignHashTable(str(c) for c in z["hash_calls"])
        return s
