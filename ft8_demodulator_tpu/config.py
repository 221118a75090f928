"""Frozen, hashable configuration objects (SURVEY §5: config/flag system).

The reference scatters physical constants and default-dict merges across
modules (0.16 s / 6.25 Hz duplicated in modulator.py:9 and
spectrogram_analyse.py:6; kwargs merging in frequency_correction.py:146).
Here one frozen NamedTuple per concern, hashable so it can ride jit static
args; protocol physics lives only in protocol.constants.
"""

from __future__ import annotations

from typing import NamedTuple

from .ops.waterfall import WaterfallParams, waterfall_params

__all__ = ["DecoderConfig", "WaterfallParams", "waterfall_params"]


class DecoderConfig(NamedTuple):
    """Everything the slot decoder needs besides the signal itself."""

    bins_per_tone: int = 2       # frequency oversampling
    steps_per_symbol: int = 2    # time oversampling
    max_candidates: int = 20     # fixed K for top-k selection
    min_score: float = 10.0      # sync-score acceptance threshold
    max_iterations: int = 20     # LDPC BP iterations
    use_osd: bool = False        # ordered-statistics decode after BP
    use_mf: bool = False         # matched-filter LLR retry after BP(+OSD)
    mf_first: bool = False       # decode ALL candidates from MF LLRs in one
                                 # pass (same cliff sensitivity, ~2x faster;
                                 # slightly lower crowded-band yield)
    mf_refine: bool = False      # sub-grid (dt, df) offset search before MF
                                 # extraction: recovers up to ~3 dB of
                                 # off-grid quantisation loss (strict
                                 # superset; see ops/llr.py)
    coherent: bool = False       # coherent MF retry: phase-track projection
                                 # (~+1.5 dB past mf_refine off-grid; the
                                 # deepest single-transmission decoder)

    def waterfall(self, fs: float) -> WaterfallParams:
        return waterfall_params(fs, self.bins_per_tone,
                                self.steps_per_symbol)


# the reference's standard operating points, for convenience
STANDARD = DecoderConfig()
# high-sensitivity preset: ~1.5 dB deeper than STANDARD at the fs-2kHz
# cliff in an earlier round's sweep (record removed; to be measured
# again, ROADMAP §2.6)
DEEP_SEARCH = DecoderConfig(bins_per_tone=4, steps_per_symbol=4,
                            max_candidates=40, min_score=1.0, use_osd=True,
                            use_mf=True)
