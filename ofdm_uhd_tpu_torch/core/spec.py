"""Waveform numerology — the single source of truth for frame geometry.

A NumPy-only copy of `ofdm_uhd_tpu/core/spec.py`: the port cannot import
the JAX package (its `__init__` imports jax), so it carries its own copy,
held field-for-field equal to the original by tests/test_torch_tables.py.
Every field converts losslessly from a reference spec (convert.py).
`kernel_backend`, `viterbi_mode` and `viterbi_impl` choose the Viterbi
algorithm as in the reference (kernels/policy.py:viterbi_impl); no field
picks a kernel tier, which the tensor's device decides.

Conventions
-----------
* Subcarrier indexing is FFT order: bin 0 = DC, bins 1..N/2-1 positive
  frequencies, bins N/2..N-1 negative frequencies.
* Occupied bins exclude DC and a symmetric guard band at the spectrum edges.
* Pilots sit every `pilot_spacing` occupied bins (offset `pilot_offset`);
  remaining occupied bins carry data.
* IFFT/FFT use orthonormal scaling (norm='ortho') so subcarrier power equals
  sample power (Parseval).
* A frame = 2 preamble OFDM symbols (Schmidl-Cox sym A + channel-estimation
  sym B) followed by `n_data_syms` data symbols, each with a length-`cp`
  cyclic prefix.
* FEC is a rate-1/2, K=7 convolutional code (polys 0o133/0o171); payload is
  followed by a CRC-32 and 6 tail bits that flush the encoder to state 0.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace

import numpy as np

MOD_BITS = {"bpsk": 1, "qpsk": 2, "qam16": 4, "qam64": 6, "qam256": 8}

# Convolutional code (industry-standard K=7 rate-1/2, same family 802.11a uses).
CONV_K = 7
CONV_POLY_A = 0o133
CONV_POLY_B = 0o171
CRC_BITS = 32
TAIL_BITS = CONV_K - 1  # flush encoder to the zero state

# Puncturing patterns over the interleaved (a, b) output stream, per input
# period: 1 = transmit, 0 = puncture (receiver re-inserts a zero LLR).
PUNCTURE = {
    "1/2": (np.array([1, 1], dtype=np.uint8), 1, 2),
    "2/3": (np.array([1, 1, 1, 0], dtype=np.uint8), 2, 3),
    "3/4": (np.array([1, 1, 1, 0, 0, 1], dtype=np.uint8), 3, 4),
}


def _default_occupied(n_sc: int) -> int:
    """~81% occupancy, multiple of 4: 64→52, 256→208, 1024→832."""
    return 4 * int(round(n_sc * 0.8125 / 4.0))


@dataclass(frozen=True)
class WaveformSpec:
    """Static OFDM frame geometry. Frozen: hashable, usable as a cache key."""

    n_sc: int = 64                 # FFT size
    cp: int = 16                   # cyclic prefix length (samples)
    modulation: str = "qpsk"       # 'bpsk'|'qpsk'|'qam16'|'qam64'|'qam256'
    n_data_syms: int = 12          # data OFDM symbols per frame
    n_occupied: int = 0            # 0 → default (~81% of n_sc)
    pilot_spacing: int = 13        # pilots every k-th occupied bin
    pilot_offset: int = 6          # first pilot position among occupied bins
    resample_l: int = 1            # polyphase interpolation factor (TX → radio rate)
    resample_m: int = 1            # polyphase decimation factor (radio rate → RX)
    fec_rate: str = "1/2"          # '1/2' | '2/3' | '3/4' (punctured K=7)
    chanest_smooth: int = 0        # odd MA window over occupied bins (0/1 = off)
    sfo_track: bool = False        # pilot phase-SLOPE tracking (SFO/timing drift)
    eq_mode: str = "zf"            # 'zf' | 'mmse' (noise var from guard bins)
    tx_window: int = 0             # raised-cosine edge taper (samples, < cp/2)
    kernel_backend: str = "xla"    # 'xla' | 'pallas' | 'auto' (per-kernel
                                   # measured winner — kernels/policy.py)
    viterbi_mode: str = "scan"     # 'scan' (exact sequential) | 'windowed'
                                   # (sliding-window parallel, ~10x lower
                                   # latency; exact when survivors merge
                                   # within the 96-step overlap)
    viterbi_impl: str = "shuffle"  # Pallas kernel layout: 'shuffle' (states
                                   # on sublanes, bit-packed decisions) |
                                   # 'mm' (one-hot-matmul fallback); sets the
                                   # whole-sequence gate of the 'fused' decode
    filter_precision: str = "exact"  # MXU filter-tier accuracy gate:
                                   # 'exact' (HIGHEST, f32-exact — default,
                                   # required by bit-level gates) | 'bf16'
                                   # (1-pass, ~4e-3 rel, ~1.5x faster —
                                   # EVM-grade callers only; Mosaic has no
                                   # HIGH tier in-kernel)

    def __post_init__(self):
        if self.modulation not in MOD_BITS:
            raise ValueError(f"unknown modulation {self.modulation!r}")
        if self.fec_rate not in PUNCTURE:
            raise ValueError(f"unknown fec_rate {self.fec_rate!r}")
        if self.viterbi_mode not in ("scan", "windowed"):
            raise ValueError(f"unknown viterbi_mode {self.viterbi_mode!r}")
        if self.kernel_backend not in ("xla", "pallas", "auto"):
            raise ValueError(f"unknown kernel_backend {self.kernel_backend!r}")
        if self.filter_precision not in ("exact", "bf16"):
            raise ValueError(
                f"unknown filter_precision {self.filter_precision!r}")
        if self.viterbi_impl not in ("shuffle", "mm"):
            raise ValueError(f"unknown viterbi_impl {self.viterbi_impl!r}")
        if self.n_occupied == 0:
            object.__setattr__(self, "n_occupied", _default_occupied(self.n_sc))
        if self.n_occupied >= self.n_sc:
            raise ValueError("n_occupied must leave room for guards and DC")
        if self.n_occupied % 2:
            raise ValueError("n_occupied must be even (symmetric spectrum)")
        if not (self.n_sc > 0 and (self.n_sc & (self.n_sc - 1)) == 0):
            raise ValueError("n_sc must be a positive power of two")
        if not 0 <= self.cp < self.n_sc:
            raise ValueError("cp must satisfy 0 <= cp < n_sc")
        if self.n_data_syms <= 0:
            raise ValueError("n_data_syms must be positive")
        if not 0 <= 2 * self.tx_window <= self.cp:
            raise ValueError("tx_window must satisfy 0 <= 2*tx_window <= cp")

    # ---- derived geometry (cached; arrays are read-only numpy, host-side) ----

    @functools.cached_property
    def occupied_bins(self) -> np.ndarray:
        """FFT-order indices of occupied bins, ordered by logical subcarrier
        index -n_occ/2 .. -1, +1 .. +n_occ/2 (negative freqs first)."""
        half = self.n_occupied // 2
        neg = np.arange(self.n_sc - half, self.n_sc)   # -half .. -1
        pos = np.arange(1, half + 1)                    # +1 .. +half
        bins = np.concatenate([neg, pos])
        bins.setflags(write=False)
        return bins

    @functools.cached_property
    def guard_bins(self) -> np.ndarray:
        """Unoccupied bins excluding DC — noise-only observations used for
        the MMSE equalizer's noise-variance estimate (DC excluded: real
        radios park LO leakage there)."""
        mask = np.ones(self.n_sc, dtype=bool)
        mask[self.occupied_bins] = False
        mask[0] = False
        b = np.nonzero(mask)[0]
        b.setflags(write=False)
        return b

    @functools.cached_property
    def pilot_positions(self) -> np.ndarray:
        """Positions of pilots within the occupied-bin ordering (0..n_occ-1)."""
        pos = np.arange(self.pilot_offset, self.n_occupied, self.pilot_spacing)
        pos.setflags(write=False)
        return pos

    @functools.cached_property
    def data_positions(self) -> np.ndarray:
        """Positions of data bins within the occupied-bin ordering."""
        mask = np.ones(self.n_occupied, dtype=bool)
        mask[self.pilot_positions] = False
        pos = np.nonzero(mask)[0]
        pos.setflags(write=False)
        return pos

    @functools.cached_property
    def pilot_bins(self) -> np.ndarray:
        b = self.occupied_bins[self.pilot_positions]
        b.setflags(write=False)
        return b

    @functools.cached_property
    def data_bins(self) -> np.ndarray:
        b = self.occupied_bins[self.data_positions]
        b.setflags(write=False)
        return b

    # ---- bit accounting ----

    @property
    def bits_per_qam(self) -> int:
        return MOD_BITS[self.modulation]

    @property
    def n_pilots(self) -> int:
        return len(self.pilot_positions)

    @property
    def n_data_sc(self) -> int:
        return self.n_occupied - self.n_pilots

    @property
    def coded_bits_per_sym(self) -> int:
        """Coded bits carried by one data OFDM symbol (interleaver block)."""
        return self.n_data_sc * self.bits_per_qam

    @property
    def coded_bits_per_frame(self) -> int:
        return self.coded_bits_per_sym * self.n_data_syms

    @property
    def uncoded_bits_per_frame(self) -> int:
        """Input length of the (punctured) encoder (payload + CRC + tail)."""
        _, num, den = PUNCTURE[self.fec_rate]
        assert (self.coded_bits_per_frame * num) % den == 0, (
            "frame geometry incompatible with FEC rate")
        return self.coded_bits_per_frame * num // den

    @property
    def payload_bits_per_frame(self) -> int:
        n = self.uncoded_bits_per_frame - CRC_BITS - TAIL_BITS
        if n <= 0:
            raise ValueError("frame too small to carry payload + CRC + tail")
        return n

    # ---- time-domain geometry ----

    @property
    def sym_len(self) -> int:
        return self.n_sc + self.cp

    @property
    def n_preamble_syms(self) -> int:
        return 2  # Schmidl-Cox sym A + channel-estimation sym B

    @property
    def n_syms(self) -> int:
        return self.n_preamble_syms + self.n_data_syms

    @property
    def frame_len(self) -> int:
        """Frame length in baseband samples (before any resampling)."""
        return self.n_syms * self.sym_len

    @property
    def frame_len_radio(self) -> int:
        """Frame length at the radio rate (after L/M polyphase resampling)."""
        return self.frame_len * self.resample_l // self.resample_m

    def with_(self, **kw) -> "WaveformSpec":
        return replace(self, **kw)


@dataclass(frozen=True)
class ChannelSpec:
    """Impairment parameters for synthetic captures (BASELINE.json configs C1–C3)."""

    snr_db: float = 30.0            # per-sample SNR (signal power / noise power)
    cfo: float = 0.0                # carrier freq offset, in subcarrier spacings
    phase_noise_std: float = 0.0    # Wiener phase-noise increment std (rad/sample)
    multipath_taps: tuple = ()      # complex FIR taps (tap 0 implicit 1.0 if empty)
    timing_offset: int = 0          # integer sample delay before first frame


# The five acceptance configs (BASELINE.json:6-12 / SURVEY.md §0.1).
def config(name: str) -> WaveformSpec:
    table = {
        # C1: loopback AWGN, 64-SC, CP 16, QPSK
        "c1": WaveformSpec(n_sc=64, cp=16, modulation="qpsk"),
        # C2: 64-SC QAM-16, pilot chanest + one-tap EQ, static multipath
        "c2": WaveformSpec(n_sc=64, cp=16, modulation="qam16"),
        # C3: 256-SC QAM-64, Schmidl-Cox sync on recorded capture
        "c3": WaveformSpec(n_sc=256, cp=32, modulation="qam64"),
        # C4: wideband 1024-SC + 8x polyphase resample
        "c4": WaveformSpec(n_sc=1024, cp=128, modulation="qam16",
                           resample_l=8, resample_m=1),
        # C5: continuous multi-host stream (same waveform as C3)
        "c5": WaveformSpec(n_sc=256, cp=32, modulation="qam16"),
    }
    return table[name]
