"""Golden end-to-end TX / RX chain (the float64 NumPy oracle).

A copy of `ofdm_uhd_tpu/golden/chain.py`, the same operations in the same
order, so on the same inputs it gives the reference's outputs element for
element (tests/test_torch_golden.py). TX = scramble -> FEC -> interleave
-> QAM -> frame -> IFFT + CP -> resample; RX = sync -> CFO correct -> CP
strip + FFT -> chanest -> EQ -> phase track -> demap -> deinterleave ->
Viterbi -> descramble -> CRC. It runs on the host CPU, one frame at a
time: the yardstick a card's throughput is divided by.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.spec import CRC_BITS, TAIL_BITS, WaveformSpec
from . import bits as B
from . import modem as M
from . import resample as R
from . import sync as S


@dataclass
class RxFrameResult:
    payload: np.ndarray          # decoded payload bits [payload_bits_per_frame]
    crc_ok: bool
    evm_db: float                # EVM of the equalized data vs hard decisions
    data_syms: np.ndarray        # equalized, phase-tracked data constellation
    cpe: np.ndarray              # per-symbol common phase error


@dataclass
class GoldenModem:
    """Single-stream CPU reference chain."""

    spec: WaveformSpec
    _rs_filter: np.ndarray = field(default=None, repr=False)

    def __post_init__(self):
        l, m = self.spec.resample_l, self.spec.resample_m
        if l != 1 or m != 1:
            self._rs_filter = R.design_lowpass(l, m)

    # ------------------------------------------------------------------ TX

    def encode_frame_bits(self, payload: np.ndarray) -> np.ndarray:
        """payload -> interleaved coded bits [coded_bits_per_frame]."""
        spec = self.spec
        if len(payload) != spec.payload_bits_per_frame:
            raise ValueError(f"payload has {len(payload)} bits, the spec "
                             f"{spec.payload_bits_per_frame}")
        crc = B.crc32_bits(payload)
        body = B.scramble(np.concatenate([payload, crc]).astype(np.uint8))
        tail = np.zeros(TAIL_BITS, dtype=np.uint8)
        coded = B.conv_encode(np.concatenate([body, tail]))
        coded = B.puncture(coded, spec.fec_rate)
        return B.interleave(coded, spec.coded_bits_per_sym)

    def modulate_frame(self, payload: np.ndarray) -> np.ndarray:
        """payload bits -> baseband frame samples [frame_len] (complex128)."""
        spec = self.spec
        coded = self.encode_frame_bits(payload)
        syms = M.qam_map(coded, spec.modulation)
        data = syms.reshape(spec.n_data_syms, spec.n_data_sc)
        grid = M.build_grid(spec, data)
        return M.ofdm_modulate(spec, grid)

    def tx(self, payloads: np.ndarray) -> np.ndarray:
        """payloads [n_frames, payload_bits] -> frames [n_frames,
        frame_len_radio], interpolated to the radio rate when the spec
        resamples."""
        frames = np.stack([self.modulate_frame(p) for p in payloads])
        l, m = self.spec.resample_l, self.spec.resample_m
        if l != 1 or m != 1:
            frames = np.stack([R.resample(f, l, m, self._rs_filter)
                               for f in frames])
        return frames

    # ------------------------------------------------------------------ RX

    def decode_frame_bits(self, llr: np.ndarray) -> tuple[np.ndarray, bool]:
        """interleaved coded-bit LLRs -> (payload bits, crc_ok)."""
        spec = self.spec
        llr_d = B.deinterleave_soft(llr, spec.coded_bits_per_sym)
        llr_d = B.depuncture_llr(llr_d, spec.fec_rate,
                                 2 * spec.uncoded_bits_per_frame)
        decoded = B.viterbi_decode(llr_d)
        body = B.descramble(decoded[: len(decoded) - TAIL_BITS])
        payload = body[: len(body) - CRC_BITS]
        crc_rx = body[len(body) - CRC_BITS:]
        crc_ok = bool(np.array_equal(B.crc32_bits(payload), crc_rx))
        return payload, crc_ok

    def rx_frame(self, samples: np.ndarray, shift: int = 0) -> RxFrameResult:
        """Demodulate one frame whose first sample is samples[0] (baseband
        rate)."""
        spec = self.spec
        grid = M.ofdm_demodulate(spec, samples, shift=shift)
        h = M.estimate_channel(spec, grid)
        eq = M.equalize(spec, grid, h)
        data, cpe = M.track_phase(spec, eq)
        csi = np.broadcast_to(
            (np.abs(h) ** 2)[spec.data_positions][None, :], data.shape)
        llr = M.qam_demap_llr(data, spec.modulation, csi=csi)
        payload, crc_ok = self.decode_frame_bits(llr)
        hard = M.qam_map(M.qam_demap_hard(data.reshape(-1), spec.modulation),
                         spec.modulation)
        evm = M.evm_db(data.reshape(-1), hard)
        return RxFrameResult(payload=payload, crc_ok=crc_ok, evm_db=evm,
                             data_syms=data, cpe=cpe)

    def rx_aligned(self, frames: np.ndarray, shift: int = 0
                   ) -> list[RxFrameResult]:
        """Frame-aligned RX (known frame boundaries, at the radio rate)."""
        l, m = self.spec.resample_l, self.spec.resample_m
        out = []
        for f in frames:
            if l != 1 or m != 1:
                f = R.resample(f, m, l, self._rs_filter)  # radio -> baseband
            out.append(self.rx_frame(f, shift=shift))
        return out

    def rx_capture(self, capture: np.ndarray, max_frames: int = 1000,
                   threshold: float = 0.5
                   ) -> list[tuple[int, float, RxFrameResult]]:
        """Continuous-capture RX with Schmidl-Cox sync.

        Scans the capture, detects frames, estimates and corrects the CFO
        (fractional from P(d), integer from preamble B) and demodulates
        each. Returns [(d_hat, eps_total, result), ...].
        """
        spec = self.spec
        l, m = spec.resample_l, spec.resample_m
        if l != 1 or m != 1:
            capture = R.resample(capture, m, l, self._rs_filter)
        results = []
        pos = 0
        n = len(capture)
        while len(results) < max_frames and n - pos >= spec.frame_len:
            # search window: enough for one frame + margin
            win = capture[pos: pos + 2 * spec.frame_len + spec.n_sc]
            d, eps_f = S.coarse_sync(spec, win, threshold)
            if d < 0:
                pos += spec.frame_len  # slide on
                continue
            start = max(pos + d, 0)  # sync may report a few samples early
            if n - start < spec.frame_len:
                break
            fr = capture[start: start + spec.frame_len]
            fr_c = S.cfo_correct(fr, eps_f, spec.n_sc)
            k = S.integer_cfo(spec, fr_c)
            eps = eps_f + k
            if k != 0:
                fr_c = S.cfo_correct(fr, eps, spec.n_sc)
            res = self.rx_frame(fr_c, shift=min(4, spec.cp // 4))
            results.append((start, eps, res))
            pos = start + spec.frame_len
        return results
