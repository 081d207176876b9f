"""The continuous-stream step on one device: the single-time-shard part of
ofdm_uhd_tpu/shard/time_parallel.py (`make_stream_step`, `_shard_step`,
`_track_retry`).

Chunk protocol (overlap-save with a one-chunk delay): every step consumes
a chunk of C baseband samples plus the carried tail [H] of the previous
one; the processing window is tail ++ chunk. With one shard the window's
last H samples are both the halo of the block and the next step's tail
(taken before AGC: each window is scaled as a whole, so the tail re-enters
raw). A detection at window offset d is OWNED iff d < C, which gives
disjoint ownership [k*C - H, (k+1)*C - H) over steps: no frame is decoded
twice and none is lost (H >= frame_len + n_sc). The owned first-pass
successes feed an EMA of the channel and CFO (phase-aligned per frame),
and the TRACK retry re-demodulates failed slots with it.

The reference's sums over the mesh (psum) and gathers are the local values
here; the multi-GPU shards, the all_to_all reshard, the halo kernel and
the CFAR threshold come with the shard/ slice and raise here.

The TRACK retry is a `lax.cond` on a device predicate in the reference.
Here it is a host branch: one sync per step, on whether an owned slot
failed its CRC while the tracker has history. A K-step dispatch enqueues
step k+1's first pass (everything up to the first decode) before it reads
step k's predicate, so the card has work queued while the host waits.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.spec import WaveformSpec
from ..core.state import StreamState
from ..kernels import fir as KF
from ..phy import agc as PA
from ..phy import sync as PS
from ..phy import tables as T
from ..pipeline import rx as RXP

LATER_SLICE = "the multi-GPU shard/ slice (ROADMAP Queue 1, item 10)"


@dataclasses.dataclass
class _FirstPass:
    """One step up to its first decode, before the TRACK retry."""
    ds: torch.Tensor          # [mf] i32 frame starts in the window
    owned: torch.Tensor       # [mf] bool
    frames: torch.Tensor      # [mf, frame_len] c64, CFO-corrected
    eps: torch.Tensor         # [mf] f32 total CFO
    out: dict                 # _demod_frames result (diag leaves kept)
    tail: torch.Tensor        # the next step's carried tail
    rtail: torch.Tensor       # the next step's radio-rate carry


class StreamStep:
    """The stream step of one spec at one chunk length (C = chunk_len
    baseband samples; radio chunks of C * L / M samples)."""

    def __init__(self, spec: WaveformSpec, chunk_len: int,
                 max_frames: int | None, threshold: float, ema: float,
                 track_mode: bool, agc: bool, input_format: str):
        self.spec = spec
        self.cb = chunk_len
        self.h = StreamState.halo_len(spec)
        if self.cb < self.h:
            raise ValueError(f"chunk {self.cb} must be >= the halo {self.h}")
        # back-to-back frames: at most one start per frame_len, +1 boundary
        self.max_frames = (max_frames if max_frames is not None
                           else self.cb // spec.frame_len + 2)
        self.threshold = threshold
        self.ema = ema
        self.track_mode = track_mode
        self.agc = agc
        self.sc16 = input_format == "sc16"
        self.shift = min(4, spec.cp // 4)
        self.taps = None
        if (spec.resample_l, spec.resample_m) != (1, 1):
            self.taps = T.resample_filter(spec.resample_l, spec.resample_m)

    def first_pass(self, tail: torch.Tensor, rtail: torch.Tensor,
                   chunk: torch.Tensor) -> _FirstPass:
        spec = self.spec
        if self.sc16:
            chunk = RXP._sc16_to_complex(chunk)
        if self.taps is not None:
            # causal resampling over the carried nt-1 radio samples: radio
            # chunks are multiples of L, so the phase pattern restarts
            w = torch.cat([rtail, chunk])
            rtail = chunk[chunk.shape[-1] - rtail.shape[-1]:]
            chunk = KF.rational_decim_stream(w, spec.resample_l,
                                             spec.resample_m, self.taps)
        fresh_raw = chunk[self.cb - self.h:]
        window = torch.cat([tail, chunk])
        if self.agc:
            # one gain per window: no frame sees a gain step
            window, _ = PA.agc_normalize(window)
        ext = window[None]                      # block ++ halo, one shard
        ds, eps_f, valid, _ = PS.detect_frames(spec, ext, self.max_frames,
                                               threshold=self.threshold)
        frames = PS.extract_frames(spec, ext, ds)
        # two CFO ramps, as pipeline/rx.py applies them
        frames = PS.cfo_correct(frames, eps_f, spec.n_sc)
        k = PS.integer_cfo(spec, frames)
        frames = PS.cfo_correct(frames, k, spec.n_sc)[0]
        ds = ds[0]
        out = RXP._demod_frames(spec, frames, shift=self.shift)
        return _FirstPass(ds=ds, owned=valid[0] & (ds < self.cb),
                          frames=frames, eps=(eps_f + k)[0], out=out,
                          tail=fresh_raw, rtail=rtail)

    def _track_retry(self, fp: _FirstPass, state: StreamState):
        """Re-demodulate the slots that failed CRC with the tracked channel
        and CFO; a slot keeps its first-pass result whenever its CRC
        passed, so on clean streams the retry changes nothing."""
        out, eps = fp.out, fp.eps
        ok0 = out["crc_ok"]
        have = state.track_wt > 0.0
        if not bool(((fp.owned & ~ok0).any() & have).item()):   # host sync
            return out, eps, torch.zeros_like(ok0)
        # replace each frame's own CFO by the tracked one (the frames were
        # derotated by their own eps: apply the difference)
        fr2 = PS.cfo_correct(fp.frames, state.eps_track - eps, self.spec.n_sc)
        h_t = state.h_track[None, :].expand(fr2.shape[0], -1)
        o2 = RXP._demod_frames_with_h(self.spec, fr2, self.shift, h_t)
        use2 = ~ok0 & have & o2["crc_ok"]
        merged = dict(out)
        merged["payload"] = torch.where(use2[:, None], o2["payload"],
                                        out["payload"])
        merged["crc_ok"] = ok0 | use2
        merged["evm_db"] = torch.where(use2, o2["evm_db"], out["evm_db"])
        return merged, torch.where(use2, state.eps_track, eps), use2

    def finish(self, fp: _FirstPass, state: StreamState
               ) -> tuple[StreamState, dict]:
        """The TRACK retry, the tracker update and the step's outputs."""
        out, eps, owned = fp.out, fp.eps, fp.owned
        used = torch.zeros_like(owned)
        if self.track_mode:
            out, eps, used = self._track_retry(fp, state)
        n_rescued = (used & owned).sum(dtype=torch.int32)
        ok = out["crc_ok"] & owned

        # fold in first-pass successes only (a rescued slot's own preamble
        # estimate is the noise that made it fail), each estimate rotated
        # so the phase of its bin sum is zero (frames carry arbitrary
        # common phases; raw averaging would be incoherent)
        wt = (ok & ~used).float()
        h_est = out["h"]
        ref = h_est.sum(-1, keepdim=True)
        refa = ref.abs()
        align = torch.where(refa > 0,
                            torch.conj(ref) / torch.clamp_min(refa, 1e-30),
                            torch.ones_like(ref))
        h_sum = (h_est * align * wt[:, None].to(torch.complex64)).sum(0)
        eps_sum = (eps * wt).sum()
        n_sum = wt.sum()
        have = n_sum > 0
        h_new = torch.where(have, h_sum / torch.clamp_min(n_sum, 1.0),
                            state.h_track)
        eps_new = torch.where(have, eps_sum / torch.clamp_min(n_sum, 1.0),
                              state.eps_track)
        a = torch.where(state.track_wt == 0.0, 1.0, self.ema).to(
            torch.float32)
        new_state = StreamState(
            tail=fp.tail, rtail=fp.rtail,
            h_track=torch.where(have, (1 - a) * state.h_track + a * h_new,
                                state.h_track),
            eps_track=torch.where(have, (1 - a) * state.eps_track
                                  + a * eps_new, state.eps_track),
            track_wt=state.track_wt + have.float(),
            steps=state.steps + 1,
            frames=state.frames + owned.sum(dtype=torch.int32),
            crc_ok=state.crc_ok + ok.sum(dtype=torch.int32))

        # start of each detection relative to the chunk's first sample (may
        # be negative: a frame can begin in the carried tail)
        d_rel = fp.ds - self.h
        meta_i = torch.stack([ok.int(), owned.int(), d_rel,
                              n_rescued.expand(d_rel.shape)], dim=-1)
        meta_f = torch.stack([eps, out["evm_db"]], dim=-1)
        return new_state, {"payload": _pack_bits(out["payload"]),
                           "meta_i": meta_i, "meta_f": meta_f}

    def step(self, state: StreamState, chunk: torch.Tensor
             ) -> tuple[StreamState, dict]:
        """One chunk -> (state, outputs [mf, ...])."""
        return self.finish(self.first_pass(state.tail, state.rtail, chunk),
                           state)

    def multi(self, state: StreamState, chunks: torch.Tensor
              ) -> tuple[StreamState, dict]:
        """K chunks [K, ...] -> (state, outputs [K, mf, ...]), the state
        kept on the device; step k+1's first pass is enqueued before step
        k's retry predicate is read."""
        outs, pending = [], None
        tail, rtail = state.tail, state.rtail
        for chunk in chunks:
            fp = self.first_pass(tail, rtail, chunk)
            tail, rtail = fp.tail, fp.rtail
            if pending is not None:
                state, o = self.finish(pending, state)
                outs.append(o)
            pending = fp
        state, o = self.finish(pending, state)
        outs.append(o)
        return state, {k: torch.stack([o[k] for o in outs]) for k in o}


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[mf, nb] 0/1 -> [mf, ceil(nb / 8)] uint8, np.unpackbits order (the
    first bit in the most significant place), by shifts and sums."""
    nb = bits.shape[-1]
    pad = -nb % 8
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    groups = bits.reshape(bits.shape[0], -1, 8).to(torch.int32)
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=bits.device)
    return (groups << shifts).sum(-1).to(torch.uint8)


def make_stream_step(spec: WaveformSpec, chunk_len: int,
                     max_frames_per_shard: int | None = None,
                     threshold=0.5, ema: float = 0.25,
                     pallas_halo: bool = False, reshard: bool = False,
                     track_mode: bool = True, agc: bool = True,
                     input_format: str = "fc32"):
    """The stream step on one device -> (step, multi, cb, h), as the
    reference's make_stream_step returns them for a one-shard mesh:
      step(state, chunk [radio_chunk])       -> (state, outs)
      multi(state, chunks [K, radio_chunk])  -> (state, outs with [K])
    (sc16: chunk [2, radio_chunk], chunks [K, 2, radio_chunk] int16).
    threshold: a float, or (threshold, mode) with mode 'fixed'."""
    thr, mode = (threshold if isinstance(threshold, tuple)
                 else (threshold, "fixed"))
    for flag, what in ((pallas_halo, "pallas_halo=True"),
                       (reshard, "reshard=True"),
                       (mode != "fixed", f"threshold_mode={mode!r}")):
        if flag:
            raise NotImplementedError(f"{what} is not ported; it comes with "
                                      f"{LATER_SLICE}")
    if input_format not in ("fc32", "sc16"):
        raise ValueError(f"unknown input_format {input_format!r}")
    s = StreamStep(spec, chunk_len, max_frames_per_shard, thr, ema,
                   track_mode, agc, input_format)
    return s.step, s.multi, s.cb, s.h
