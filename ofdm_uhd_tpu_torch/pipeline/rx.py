"""Batched RX pipeline: capture-mode and frame-aligned receive.

The counterpart of ofdm_uhd_tpu/pipeline/rx.py. Call stack: sc16 ->
complex64 -> [decimation to baseband] -> AGC -> S&C detection -> frame
extraction -> fractional + integer CFO -> CP strip + FFT -> chanest -> EQ
-> phase track -> LLR demap -> deinterleave -> Viterbi -> descramble ->
CRC.

The reference vmapped the chain over captures; here the capture axis C
is written out and every kernel takes it, so one call processes [C, n]
captures with C * max_frames frame slots. The spec picks each stage's
formulation as the reference does (kernels/policy.py): the decimation's
filter tier, exact float32 or, with filter_precision='bf16' where the
reference routes its MXU filter kernel (kernel_backend 'pallas'), bf16
products; the S&C front end (K6) or, under kernel_backend='pallas' when l
% 128 != 0, the boxcar correlator (K9) and the metric; the CP-fused FFT
(K5) under 'pallas', else the FFT (K3); the Viterbi algorithm from the
spec and the decode batch C * max_frames (K4 whole or K4w windowed).
Detection uses the fixed threshold or, with sync_threshold_mode='cfar',
each capture's noise-floor-adaptive one. The input's device picks the tier: on
CUDA the hand kernels run (with the decimation FIR, localize and extract),
on the CPU their plain versions.
"""

from __future__ import annotations

import torch

from ..core.spec import WaveformSpec, CRC_BITS, TAIL_BITS
from ..kernels import fir as KF
from ..kernels import policy
from ..kernels import viterbi as KV
from ..phy import agc as PA
from ..phy import bits as PB
from ..phy import frame as PF
from ..phy import qam as PQ
from ..phy import sync as PS
from ..phy import tables as T


class RxPipeline:
    """Receive chain for one waveform. Results are dicts of tensors on the
    input's device, as the reference's RxPipeline returns them. The
    reference's constructor arguments; sync_threshold_mode 'fixed' detects
    at sync_threshold, 'cfar' at clip(16 * median(M), 0.05,
    sync_threshold) per capture (phy/sync.py cfar_threshold)."""

    def __init__(self, spec: WaveformSpec, shift: int = 0,
                 sync_threshold: float = 0.5, diag: bool = True,
                 sync_threshold_mode: str = "fixed"):
        self.spec = spec
        self.shift = shift
        self.sync_threshold = sync_threshold
        self.sync_threshold_mode = sync_threshold_mode
        self.diag = diag

    def rx_aligned(self, frames: torch.Tensor) -> dict:
        """frames [B, frame_len_radio] complex64 -> result dict (all
        [B, ...]); resampled waveforms are brought to baseband first."""
        return _demod_frames(self.spec, _to_baseband(self.spec, frames),
                             self.shift, self.diag)

    def rx_capture(self, capture: torch.Tensor, max_frames: int) -> dict:
        """capture [n] or [C, n] complex64 -> result dict with
        [max_frames, ...] (or [C, max_frames, ...]) slots + 'valid'."""
        if capture.dim() == 1:
            out = _rx_capture(self.spec, self.sync_threshold, self.diag,
                              capture[None], max_frames,
                              self.sync_threshold_mode)
            return {k: v[0] for k, v in out.items()}
        return _rx_capture(self.spec, self.sync_threshold, self.diag,
                           capture, max_frames, self.sync_threshold_mode)

    def rx_capture_sc16(self, iq: torch.Tensor, max_frames: int) -> dict:
        """Capture RX from radio-native sc16 IQ: iq int16 [2, n] or
        [2, C, n] (real/imag planes, full scale 32767), converted to
        complex64 on the input's device."""
        return self.rx_capture(_sc16_to_complex(iq), max_frames)


def _to_baseband(spec: WaveformSpec, x: torch.Tensor) -> torch.Tensor:
    """Radio rate -> baseband along the last axis (inverse of the TX
    resampling): interpolate by M, then decimate by L."""
    l, m = spec.resample_l, spec.resample_m
    if l == 1 and m == 1:
        return x
    taps = T.resample_filter(l, m)
    if m > 1:
        x = KF.polyphase_interp(x, m, taps, precision=policy.filter_precision(
            spec, "interp", m, x.numel()))
    if l > 1:
        x = KF.polyphase_decim(x, l, taps, precision=policy.filter_precision(
            spec, "decim", l, x.numel()))
    return x


def _capture_to_baseband(spec: WaveformSpec, capture: torch.Tensor
                         ) -> torch.Tensor:
    """Radio-rate captures [C, n] -> baseband [C, ceil(n / L)]: zero-padded
    to a multiple of L first, so that n // L keeps the tail."""
    pad = (-capture.shape[-1]) % spec.resample_l
    if pad:
        capture = torch.cat(
            [capture, capture.new_zeros(capture.shape[:-1] + (pad,))], -1)
    return _to_baseband(spec, capture)


def _sc16_to_complex(iq: torch.Tensor) -> torch.Tensor:
    """int16 planes [2, ...] -> complex64 [...], times the float32
    constant 1/32767 (a multiply, not a divide, as the reference)."""
    scale = T.f32_scalar(1.0 / 32767.0, iq.device)
    return torch.complex(iq[0].float() * scale, iq[1].float() * scale)


def _grid_demod(spec: WaveformSpec, grid: torch.Tensor, h: torch.Tensor
                ) -> dict:
    """EQ / CPE / LLR demap / EVM from an FFT grid and channel estimate."""
    eq = PF.equalize(spec, grid, h)
    data, cpe = PF.track_phase(spec, eq)
    llr, evm_db = _demap(spec, data, h)
    return {"llr": llr, "evm_db": evm_db, "data_syms": data, "cpe": cpe,
            "h": h}


def _demap(spec: WaveformSpec, data: torch.Tensor, h: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Equalized data symbols [B, S, n_data_sc] -> (CSI-weighted LLRs
    [B, coded_bits_per_frame], EVM in dB [B] against hard decisions)."""
    csi = PF.data_csi(spec, h)[:, None, :].expand(data.shape)
    llr = PQ.qam_demap_llr(data, spec.modulation, csi=csi)
    llr = llr.reshape(-1, spec.coded_bits_per_frame)
    hard_bits = PQ.qam_demap_hard(data, spec.modulation)
    ideal = PQ.qam_map(hard_bits, spec.modulation)
    b = data.shape[0]
    err = ((data.reshape(b, -1) - ideal.reshape(b, -1)).abs() ** 2).mean(-1)
    ref = (ideal.reshape(b, -1).abs() ** 2).mean(-1)
    return llr, 10.0 * torch.log10(err / ref + 1e-30)


def _frontend(spec: WaveformSpec, frames: torch.Tensor, shift: int) -> dict:
    """Symbol-domain front end: FFT -> chanest/EQ/CPE -> LLR demap."""
    grid = PF.ofdm_demodulate(spec, frames, shift=shift)
    h = PF.estimate_channel(spec, grid)
    return _grid_demod(spec, grid, h)


def _decode(spec: WaveformSpec, llr: torch.Tensor,
            algo_batch: int | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Interleaved coded LLRs [B, coded] -> (payload [B, n], crc_ok [B]).

    algo_batch: the batch the spec's Viterbi algorithm is chosen at
    (default B), the reference's trace-time batch: the whole dispatch on
    the capture path (its batch_hint; here B), one shard's slots in the
    sharded stream, which decodes several shards' slots in one call where
    the reference decodes each shard's inside shard_map.
    """
    llr_d = PB.deinterleave_soft(llr, spec.coded_bits_per_sym)
    llr_d = PB.depuncture_llr(llr_d, spec.fec_rate,
                              2 * spec.uncoded_bits_per_frame)
    algorithm = policy.viterbi_impl(llr_d.shape[-1] // 2,
                                    algo_batch or llr_d.shape[0],
                                    requested=spec.kernel_backend,
                                    mode=spec.viterbi_mode)
    decoded = KV.decode(llr_d, algorithm, spec.viterbi_impl)
    body = PB.descramble(decoded[:, : decoded.shape[-1] - TAIL_BITS])
    payload = body[:, : body.shape[-1] - CRC_BITS]
    crc_rx = body[:, body.shape[-1] - CRC_BITS:]
    return payload, PB.crc32_check(payload, crc_rx)


def _demod_frames(spec: WaveformSpec, frames: torch.Tensor, shift: int,
                  diag: bool = True, algo_batch: int | None = None) -> dict:
    """Symbol/bit recovery for frame-aligned samples [B, frame_len]
    (algo_batch: as _decode's)."""
    out = _frontend(spec, frames, shift)
    payload, crc_ok = _decode(spec, out.pop("llr"), algo_batch=algo_batch)
    out.update({"payload": payload, "crc_ok": crc_ok})
    if not diag:
        for k in ("data_syms", "cpe", "h"):
            out.pop(k)
    return out


def _demod_frames_with_h(spec: WaveformSpec, frames: torch.Tensor,
                         shift: int, h: torch.Tensor,
                         algo_batch: int | None = None) -> dict:
    """_demod_frames with an external channel estimate h [B, n_occupied]
    in place of the frames' own preamble estimate (the stream's TRACK
    retry demodulates with its tracked estimate)."""
    grid = PF.ofdm_demodulate(spec, frames, shift=shift)
    out = _grid_demod(spec, grid, h)
    payload, crc_ok = _decode(spec, out.pop("llr"), algo_batch=algo_batch)
    out.update({"payload": payload, "crc_ok": crc_ok})
    return out


def _rx_capture(spec: WaveformSpec, threshold: float, diag: bool,
                capture: torch.Tensor, max_frames: int,
                threshold_mode: str = "fixed") -> dict:
    """capture [C, n] complex64 -> dict of [C, max_frames, ...] leaves
    (and det_sat [C] when diag)."""
    caps = capture.shape[0]
    capture, _ = PA.agc_normalize(_capture_to_baseband(spec, capture))
    ds, eps_f, valid, det_sat = PS.detect_frames(
        spec, capture, max_frames, threshold=threshold,
        threshold_mode=threshold_mode)
    frames = PS.extract_frames(spec, capture, ds)            # [C, mf, fl]
    # two full-frame ramps, as the reference applies them (a composed
    # ramp differs by ~1 ulp)
    frames = PS.cfo_correct(frames, eps_f, spec.n_sc)
    k = PS.integer_cfo(spec, frames)
    eps = eps_f + k
    frames = PS.cfo_correct(frames, k, spec.n_sc)
    out = _demod_frames(spec, frames.reshape(caps * max_frames, -1),
                        shift=min(4, spec.cp // 4), diag=diag)
    out = {key: v.reshape((caps, max_frames) + v.shape[1:])
           for key, v in out.items()}
    out.update({"d": ds, "eps": eps, "valid": valid,
                "crc_ok": out["crc_ok"] & valid})
    if diag:
        out["det_sat"] = det_sat
    return out
