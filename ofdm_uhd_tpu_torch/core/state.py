"""StreamState: the carried state of the continuous-stream receiver.

The counterpart of ofdm_uhd_tpu/core/state.py, as a dataclass of tensors
on one device (by default the CUDA card; pass device='cpu' for the CPU). Its checkpoint is an `.npz` with the reference's field
names, dtypes and shapes, so a state saved by either package loads in the
other.

Fields:
  tail       [H] complex64   last H baseband samples of the previous chunk
                             (overlap-save continuation), H = halo_len
  rtail      [nt-1] c64      radio-rate filter carry of the in-stream
                             decimation (empty without resampling)
  h_track    [n_occ] c64     EMA channel estimate of the tracked stream
  eps_track  scalar f32      EMA CFO estimate
  track_wt   scalar f32      steps folded into the EMA (0 until a frame)
  steps      scalar i32      chunks consumed; the global sample timebase
                             steps * chunk_len is composed on the host in
                             an unbounded Python int (StreamRx)
  frames     scalar i32      frames detected (owned detections)
  crc_ok     scalar i32      frames that passed their CRC
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .spec import WaveformSpec

_DTYPES = {"tail": np.complex64, "rtail": np.complex64,
           "h_track": np.complex64, "eps_track": np.float32,
           "track_wt": np.float32, "steps": np.int32, "frames": np.int32,
           "crc_ok": np.int32}


@dataclasses.dataclass
class StreamState:
    tail: torch.Tensor
    rtail: torch.Tensor
    h_track: torch.Tensor
    eps_track: torch.Tensor
    track_wt: torch.Tensor
    steps: torch.Tensor
    frames: torch.Tensor
    crc_ok: torch.Tensor

    @staticmethod
    def halo_len(spec: WaveformSpec) -> int:
        """A frame detected at the last owned sample must complete, and its
        S&C metric window (2L = n_sc) must be computable."""
        return spec.frame_len + spec.n_sc

    @staticmethod
    def rtail_len(spec: WaveformSpec) -> int:
        if (spec.resample_l, spec.resample_m) == (1, 1):
            return 0
        from ..phy.tables import resample_filter
        return len(resample_filter(spec.resample_l, spec.resample_m)) - 1

    @classmethod
    def init(cls, spec: WaveformSpec, device: str | torch.device = "cuda"
             ) -> "StreamState":
        shapes = {"tail": (cls.halo_len(spec),),
                  "rtail": (cls.rtail_len(spec),),
                  "h_track": (spec.n_occupied,)}
        return cls.from_numpy({
            f: np.zeros(shapes.get(f, ()), dtype=dt)
            for f, dt in _DTYPES.items()}, device)

    @classmethod
    def from_numpy(cls, arrays: dict, device: str | torch.device = "cuda"
                   ) -> "StreamState":
        """From numpy arrays by field name (each cast to its field's dtype)."""
        return cls(**{
            f: torch.from_numpy(np.array(arrays[f], dtype=dt)).to(device)
            for f, dt in _DTYPES.items()})

    def to_numpy(self) -> dict:
        return {f.name: getattr(self, f.name).cpu().numpy()
                for f in dataclasses.fields(self)}

    # ---- checkpoint / resume ----

    def save(self, path: str) -> None:
        np.savez(path, **self.to_numpy())

    @classmethod
    def load(cls, path: str, device: str | torch.device = "cuda"
             ) -> "StreamState":
        with np.load(path) as z:
            return cls.from_numpy({f: z[f] for f in _DTYPES}, device)
