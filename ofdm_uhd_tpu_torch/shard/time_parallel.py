"""The continuous-stream step over the 'time' axis of a device mesh: the
counterpart of ofdm_uhd_tpu/shard/time_parallel.py (`make_stream_step`,
`_shard_step`, `_track_retry`, `_reshard_demod`).

Chunk protocol (overlap-save with a one-chunk delay): every step consumes
a chunk of C = T * Cb baseband samples plus the carried tail [H] of the
previous one; the processing window is tail ++ chunk. The sc16
conversion, the rational decimation and the AGC (one gain per window) run
on the whole chunk or window, on the mesh's first device, as the
reference runs them outside shard_map. Shard i then gets block i =
window[i*Cb : (i+1)*Cb] on its device and a halo of H samples after it:
the head of shard i + 1's block, moved by the halo exchange (the
reference's ppermute: `heads[i+1].to(dev_i)`, or the halo kernel K10
under pallas_halo=True). The last shard's halo is the window's last H
samples, which are also the next step's tail (taken before the AGC, so it
re-enters raw). A detection at offset d of a shard's [Cb + H] is OWNED iff
d < Cb, which gives disjoint ownership over shards and steps: no frame is
decoded twice and none is lost (H >= frame_len + n_sc).

Placement. The shards of one device form one batch of rows [T_d, Cb + H]
through detection, extraction, CFO and demod, so a device's launches do
not grow with its shard count; devices are issued one after another from
the host. A device's shards must be neighbours on the time axis. The
Viterbi algorithm is chosen at one shard's slot count all the same, as
the reference decodes each shard inside shard_map (`algo_batch`).

The reference's collectives: the sums over the mesh (psum) are per-shard
sums moved to the first device and added there; the outputs are
concatenated in shard order there (all_gather), [T * mf, ...] a step; the
carried StreamState stays there, and a shard on another device reads a
copy. reshard=True pads each shard's slots to f2 = ceil(mf / T) * T and
applies the slot transpose Y[j][i] = X[i][j] (the reference's all_to_all;
on one device a permutation of rows) before the demod, and again after it.
The owned first-pass successes feed an EMA of the channel and CFO (each
estimate phase-aligned), and the TRACK retry re-demodulates failed slots
with it.

Across processes (a mesh made under init_distributed: shard/mesh.py).
Each frame row of the mesh is a replica of the stream, as the reference
replicates it over 'frame': a process runs the time shards of the first
row that holds an entry of its own, and the collectives below run over
that row's processes (their group, mesh.py row_group; a row of one
process runs as a single controller does).
Every process holds the whole host chunk, as the reference's feed does,
and builds the window (sc16 conversion, decimation, AGC) on its first
device with the code above, so the window is bit-identical in every
process, and cuts its own shards' rows [Cb + H] from it. No halo crosses
a process boundary: the reference's ppermute carries a head every process
already holds, so a process's last shard takes its halo from the window.
Within a process the exchange is as above (K10 under pallas_halo). The
per-shard terms of the sums, the TRACK predicates and the outputs are
gathered from every process in shard order (shard/collectives.py), and
the sums are taken with the same .sum(0) over the same rows as on one
controller, never by all_reduce, whose order would round otherwise:
every process keeps an identical StreamState and returns every frame.
The reshard's slot transpose exchanges the chunks of other processes'
shards (the all_to_all) and stays a .to() permutation within a process.
Every process issues its collectives in one order.

The TRACK retry is a `lax.cond` on each shard's device predicate in the
reference. Here it is a host branch: one sync per step reads all T
predicates (an owned slot failed its CRC while the tracker has history);
a device whose shards all say no skips the retry, and a shard that says
no keeps its first pass. A K-step dispatch enqueues step k+1's first pass
(everything up to the first decode) before it reads step k's predicates,
so the card has work queued while the host waits.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..core.spec import WaveformSpec
from ..core.state import StreamState
from ..kernels import fir as KF
from ..kernels import halo as KH
from ..phy import agc as PA
from ..phy import sync as PS
from ..phy import tables as T
from ..pipeline import rx as RXP
from .collectives import ProcessComm
from .mesh import Mesh, single_mesh


@dataclasses.dataclass
class _Group:
    """Shards [lo, hi) of the time axis, all on `device` of process
    `rank`."""
    device: torch.device
    lo: int
    hi: int
    rank: int = 0

    @property
    def n(self) -> int:
        return self.hi - self.lo


def _groups(devices, ranks=None) -> list[_Group]:
    """The time axis's entries as runs of one device of one process."""
    groups: list[_Group] = []
    for i, d in enumerate(devices):
        r = 0 if ranks is None else int(ranks[i])
        if groups and (groups[-1].device, groups[-1].rank) == (d, r):
            groups[-1].hi = i + 1
        elif any((g.device, g.rank) == (d, r) for g in groups):
            raise ValueError(f"the shards on {d} must be neighbours on the "
                             "mesh's time axis")
        else:
            groups.append(_Group(d, i, i + 1, r))
    return groups


def _stream_row(mesh: Mesh, t: int) -> int:
    """The frame row this process runs the stream on, a mesh that spans
    processes being checked whole, alike on every process (so that every
    one raises, or none, before any of them makes a group): each process
    runs the first row holding an entry of its own (the reference
    replicates the stream over the frame axis, each row a replica); the
    processes that run a row own all of its entries, as many each, and
    every process runs a row. Else ValueError, naming the layout."""
    ranks = mesh.ranks.reshape(-1, t)
    layout = f"(ranks by entry {ranks.tolist()})"
    first: dict[int, int] = {}
    for f, row in enumerate(ranks):
        for r in row:
            first.setdefault(int(r), f)
    for f in sorted(set(first.values())):
        row = [int(r) for r in ranks[f]]
        runners = sorted(r for r in first if first[r] == f)
        if sorted(set(row)) != runners:
            raise ValueError(
                f"frame row {f} of the stream's mesh {layout} holds entries "
                "of a process that runs an earlier row")
        per = [row.count(r) for r in runners]
        if len(set(per)) != 1:
            raise ValueError(
                "every process of a frame row must own as many shards of "
                f"the stream's time axis; row {f} of the mesh {layout} "
                f"gives {per} to processes {runners}")
        _groups(list(mesh.devices.reshape(-1, t)[f]), row)
    idle = sorted(set(range(dist.get_world_size())) - set(first))
    if idle:
        raise ValueError(f"processes {idle} own no entry of the stream's "
                         f"mesh {layout}")
    return first[dist.get_rank()]


@dataclasses.dataclass
class _FirstPass:
    """One step up to its first decode, before the TRACK retry; one entry
    per device group, rows [T_d * mf] in shard order."""
    ds: list            # i32 frame starts in each shard's [Cb + H]
    owned: list         # bool
    frames: list        # [T_d * mf, frame_len] c64, CFO-corrected
    eps: list           # f32 total CFO
    out: list           # demod results: payload, crc_ok, evm_db, h
    tail: torch.Tensor  # the next step's carried tail
    rtail: torch.Tensor  # the next step's radio-rate carry


class StreamStep:
    """The stream step of one spec at one chunk length over the 'time'
    axis of `mesh` (row 0 of its 'frame' axis, or across processes the
    row this process runs: the reference replicates the stream over that
    axis): C = chunk_len baseband samples a step,
    radio chunks of C * L / M samples; threshold: a float, or (threshold,
    mode) as make_stream_step takes it."""

    def __init__(self, spec: WaveformSpec, mesh: Mesh, chunk_len: int,
                 max_frames: int | None, threshold, ema: float,
                 pallas_halo: bool, reshard: bool, track_mode: bool,
                 agc: bool, input_format: str):
        self.spec = spec
        self.t = mesh.shape["time"]
        row = _stream_row(mesh, self.t) if mesh.distributed else 0
        self.groups = _groups(
            list(mesh.devices.reshape(-1, self.t)[row]),
            None if mesh.ranks is None
            else mesh.ranks.reshape(-1, self.t)[row])
        self.comm = None
        if mesh.distributed:
            group = mesh.row_group(row)
            self.groups = [g for g in self.groups
                           if g.rank == dist.get_rank()]
            if group is not None:
                self.comm = ProcessComm(self.groups[0].device, group)
        self.device = self.groups[0].device
        # this process's shards [lo, hi) (all of them on a single controller)
        self.lo, self.hi = self.groups[0].lo, self.groups[-1].hi
        if chunk_len % self.t:
            raise ValueError(f"chunk {chunk_len} must divide over the "
                             f"{self.t} time shards")
        self.c = chunk_len
        self.cb = chunk_len // self.t
        self.h = StreamState.halo_len(spec)
        if self.cb < self.h:
            raise ValueError(f"block {self.cb} must be >= the halo {self.h}")
        # back-to-back frames: at most one start per frame_len, +1 boundary
        self.mf = (max_frames if max_frames is not None
                   else self.cb // spec.frame_len + 2)
        self.threshold, self.threshold_mode = (
            threshold if isinstance(threshold, tuple)
            else (threshold, "fixed"))
        self.ema = ema
        self.pallas_halo = pallas_halo
        self._exts = None         # the shards' rows, written every step
        self._exchange = None
        self.reshard = reshard
        self.track_mode = track_mode
        self.agc = agc
        self.sc16 = input_format == "sc16"
        self.shift = min(4, spec.cp // 4)
        self.taps = None
        if (spec.resample_l, spec.resample_m) != (1, 1):
            self.taps = T.resample_filter(spec.resample_l, spec.resample_m)
        # each shard's block offset in the chunk, less H: d_rel = ds + this
        self.offsets = [(torch.arange(g.lo, g.hi, dtype=torch.int32,
                                      device=g.device) * self.cb
                         - self.h)[:, None] for g in self.groups]

    # ---- the halo exchange ----

    def blocks(self, window: torch.Tensor) -> list[torch.Tensor]:
        """window [C + H] -> per device group [T_d, Cb + H], each row a
        shard's block, its halo not yet filled. The rows are the same
        buffers every step (each step's reads of them are queued before
        the next step's writes), so the halo exchange's setup is built
        once."""
        if self._exts is None:
            self._exts = [torch.empty((g.n, self.cb + self.h),
                                      dtype=window.dtype, device=g.device)
                          for g in self.groups]
            self._exchange = (
                KH.HaloExchange(self._exts, self.cb, self.h)
                if self.pallas_halo else
                lambda: KH.halo_plain(self._exts, self.cb, self.h))
        blocks = window[:self.c].view(self.t, self.cb)
        for g, e in zip(self.groups, self._exts):
            e[:, :self.cb].copy_(blocks[g.lo:g.hi])
        return self._exts

    def extend(self, window: torch.Tensor) -> list[torch.Tensor]:
        """Every shard's block ++ halo: the exchange for this process's
        shards but its last, whose halo is the window's H samples after
        its block (the last shard's: the window's last H)."""
        exts = self.blocks(window)
        self._exchange()
        end = self.hi * self.cb
        exts[-1][-1, self.cb:].copy_(window[end:end + self.h])
        return exts

    # ---- the step ----

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
        fresh_raw = chunk[self.c - self.h:]
        window = torch.cat([tail, chunk])
        if self.agc:
            # one gain per window: no frame sees a gain step
            window, _ = PA.agc_normalize(window)
        ds, owned, frames, eps = [], [], [], []
        for ext in self.extend(window):
            d, eps_f, valid, _ = PS.detect_frames(
                spec, ext, self.mf, threshold=self.threshold,
                threshold_mode=self.threshold_mode)
            fr = PS.extract_frames(spec, ext, d)
            # two CFO ramps, as pipeline/rx.py applies them
            fr = PS.cfo_correct(fr, eps_f, spec.n_sc)
            k = PS.integer_cfo(spec, fr)
            fr = PS.cfo_correct(fr, k, spec.n_sc)
            ds.append(d)
            owned.append((valid & (d < self.cb)).reshape(-1))
            frames.append(fr.reshape(-1, spec.frame_len))
            eps.append((eps_f + k).reshape(-1))
        return _FirstPass(ds=ds, owned=owned, frames=frames, eps=eps,
                          out=self._demod(frames), tail=fresh_raw,
                          rtail=rtail)

    def _demod(self, frames: list[torch.Tensor]) -> list[dict]:
        """Each device group's slots demodulated, the Viterbi algorithm
        chosen at one shard's batch; with reshard, across the slot
        transpose and back."""
        keep = ("payload", "crc_ok", "evm_db", "h")
        if not self.reshard:
            outs = [RXP._demod_frames(self.spec, f, self.shift,
                                      algo_batch=self.mf) for f in frames]
            return [{k: o[k] for k in keep} for o in outs]
        f2 = -(-self.mf // self.t) * self.t
        pad = [torch.nn.functional.pad(
            f.view(g.n, self.mf, -1), (0, 0, 0, f2 - self.mf))
            for g, f in zip(self.groups, frames)]
        outs = [RXP._demod_frames(self.spec, x.reshape(g.n * f2, -1),
                                  self.shift, algo_batch=f2)
                for g, x in zip(self.groups, self._slot_transpose(pad))]
        back = {k: self._slot_transpose(
            [o[k].view((g.n, f2) + o[k].shape[1:])
             for g, o in zip(self.groups, outs)]) for k in keep}
        return [{k: back[k][i][:, :self.mf].reshape(
            (g.n * self.mf,) + back[k][i].shape[2:]) for k in keep}
            for i, g in enumerate(self.groups)]

    def _slot_transpose(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """Per group [T_d, f2, ...] -> the same shapes with shard j's slot
        chunk i taken from shard i's chunk j (f2 = T chunks): an
        involution, moved across devices with .to() and, from the shards
        of other processes, by one exchange (the all_to_all)."""
        t = self.t
        q = xs[0].shape[1] // t
        rest = xs[0].shape[2:]
        n = self.hi - self.lo                  # this process's shards
        got = []
        if self.comm is not None:
            # to process r: my shards' chunks of r's shards [n, n, q, ...]
            mine = torch.cat([x.to(self.device) for x in xs]).view(
                (n, t, q) + rest)
            got = self.comm.exchange([
                None if r == self.comm.rank else mine[:, r * n:(r + 1) * n]
                for r in range(self.comm.world)])
        out = []
        for gd in self.groups:
            y = torch.empty((gd.n, t, q) + rest, dtype=xs[0].dtype,
                            device=gd.device)
            for gs, x in zip(self.groups, xs):
                part = x.view((gs.n, t, q) + rest)[:, gd.lo:gd.hi]
                y[:, gs.lo:gs.hi] = part.transpose(0, 1).to(gd.device)
            for r, blk in enumerate(got):
                if blk is not None:     # process r's shards' chunks of mine
                    part = blk[:, gd.lo - self.lo:gd.hi - self.lo]
                    y[:, r * n:(r + 1) * n] = part.transpose(0, 1).to(
                        gd.device)
            out.append(y.view((gd.n, t * q) + rest))
        return out

    def _track_retry(self, fp: _FirstPass, state: StreamState):
        """Re-demodulate the slots that failed CRC with the tracked channel
        and CFO, on the devices holding a shard whose predicate is true; a
        slot keeps its first-pass result whenever its CRC passed, so on
        clean streams the retry changes nothing."""
        mf = self.mf
        preds = [(own & ~o["crc_ok"]).view(-1, mf).any(-1)
                 for own, o in zip(fp.owned, fp.out)]
        have = state.track_wt > 0.0
        pred = self._gather_all([preds])[0]
        pred = (pred & have).tolist()                      # one host sync
        outs, epss, used = [], [], []
        for g, p, out, eps, frames in zip(self.groups, preds, fp.out,
                                          fp.eps, fp.frames):
            if not any(pred[g.lo:g.hi]):
                outs.append(out)
                epss.append(eps)
                used.append(torch.zeros_like(out["crc_ok"]))
                continue
            # replace each frame's own CFO by the tracked one (the frames
            # were derotated by their own eps: apply the difference)
            eps_t = state.eps_track.to(g.device)
            have_g = have.to(g.device)
            fr2 = PS.cfo_correct(frames, eps_t - eps, self.spec.n_sc)
            h_t = state.h_track.to(g.device)[None, :].expand(fr2.shape[0], -1)
            o2 = RXP._demod_frames_with_h(self.spec, fr2, self.shift, h_t,
                                          algo_batch=mf)
            ok0 = out["crc_ok"]
            # a shard whose predicate is false skips the retry: ok2 = 0
            retried = (p & have_g)[:, None].expand(g.n, mf).reshape(-1)
            use2 = ~ok0 & have_g & o2["crc_ok"] & retried
            merged = dict(out)
            merged["payload"] = torch.where(use2[:, None], o2["payload"],
                                            out["payload"])
            merged["crc_ok"] = ok0 | use2
            merged["evm_db"] = torch.where(use2, o2["evm_db"], out["evm_db"])
            outs.append(merged)
            epss.append(torch.where(use2, eps_t, eps))
            used.append(use2)
        return outs, epss, used

    def _gather_all(self, lists: list[list[torch.Tensor]]
                    ) -> list[torch.Tensor]:
        """Per-group tensors of each list -> one each, every shard's rows
        in shard order, on the first device: a concatenation, and across
        processes one gather for all the lists (every process gets all
        the rows)."""
        local = [parts[0] if len(parts) == 1
                 else torch.cat([p.to(self.device) for p in parts])
                 for parts in lists]
        return local if self.comm is None else self.comm.gather(local)

    def finish(self, fp: _FirstPass, state: StreamState
               ) -> tuple[StreamState, dict]:
        """The TRACK retry, the tracker update and the step's outputs."""
        outs, epss = fp.out, fp.eps
        used = [torch.zeros_like(o) for o in fp.owned]
        if self.track_mode:
            outs, epss, used = self._track_retry(fp, state)
        mf = self.mf
        h_parts, f_parts, i_parts, oks = [], [], [], []
        for g, out, eps, own, u in zip(self.groups, outs, epss, fp.owned,
                                       used):
            ok = out["crc_ok"] & own
            oks.append(ok)
            # fold in first-pass successes only (a rescued slot's own
            # preamble estimate is the noise that made it fail), each
            # estimate rotated so the phase of its bin sum is zero (frames
            # carry arbitrary common phases; raw averaging is incoherent)
            wt = (ok & ~u).float()
            h_est = out["h"]
            ref = h_est.sum(-1, keepdim=True)
            refa = ref.abs()
            align = torch.where(refa > 0,
                                torch.conj(ref) / torch.clamp_min(refa, 1e-30),
                                torch.ones_like(ref))
            h_al = h_est * align * wt[:, None].to(torch.complex64)
            # per-shard sums: the terms of the reference's psum
            h_parts.append(h_al.view(g.n, mf, -1).sum(1))
            f_parts.append(torch.stack([(eps * wt).view(g.n, mf).sum(1),
                                        wt.view(g.n, mf).sum(1)], -1))
            i_parts.append(torch.stack(
                [x.view(g.n, mf).sum(1, dtype=torch.int32)
                 for x in (own, ok, u & own)], -1))
        # start of each detection relative to the chunk's first sample (may
        # be negative: a frame can begin in the carried tail)
        (h_rows, f_rows, i_rows, d_rel, ok, owned, eps_all, evm,
         payload) = self._gather_all([
             h_parts, f_parts, i_parts,
             [(d + off).reshape(-1) for d, off in zip(fp.ds, self.offsets)],
             oks, fp.owned, epss, [o["evm_db"] for o in outs],
             [_pack_bits(o["payload"]) for o in outs]])
        # the sums over the shards (the reference's psum): the same rows
        # added in the same order in every process, never by all_reduce
        h_sum = h_rows.sum(0)
        eps_sum, n_sum = f_rows.sum(0).unbind()
        n_owned, n_ok, n_rescued = i_rows.sum(0, dtype=torch.int32).unbind()
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
            frames=state.frames + n_owned,
            crc_ok=state.crc_ok + n_ok)

        meta_i = torch.stack([ok.int(), owned.int(), d_rel,
                              n_rescued.expand(d_rel.shape)], dim=-1)
        meta_f = torch.stack([eps_all, evm], dim=-1)
        return new_state, {"payload": payload, "meta_i": meta_i,
                           "meta_f": meta_f}

    def step(self, state: StreamState, chunk: torch.Tensor
             ) -> tuple[StreamState, dict]:
        """One chunk -> (state, outputs [T * mf, ...])."""
        return self.finish(self.first_pass(state.tail, state.rtail, chunk),
                           state)

    def multi(self, state: StreamState, chunks: torch.Tensor
              ) -> tuple[StreamState, dict]:
        """K chunks [K, ...] -> (state, outputs [K, T * mf, ...]), the state
        kept on the device; step k+1's first pass is enqueued before step
        k's retry predicates are read."""
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


def make_stream_step(spec: WaveformSpec, mesh: Mesh | None, chunk_len: int,
                     max_frames_per_shard: int | None = None,
                     threshold=0.5, ema: float = 0.25,
                     pallas_halo: bool = False, reshard: bool = False,
                     track_mode: bool = True, agc: bool = True,
                     input_format: str = "fc32"):
    """The stream step over `mesh`'s time axis (None: one shard on the
    first CUDA card) -> (step, multi, cb, h), as the reference's:
      step(state, chunk [radio_chunk])       -> (state, outs [T * mf, ...])
      multi(state, chunks [K, radio_chunk])  -> (state, outs [K, T*mf, ...])
    (sc16: chunk [2, radio_chunk], chunks [K, 2, radio_chunk] int16), the
    chunk and the state on the mesh's first device. threshold: a float, or
    (threshold, mode) with mode 'fixed' or 'cfar' (each shard's threshold
    from the metric of its own window [Cb + H], as the reference's
    detect_frames takes it per shard)."""
    if input_format not in ("fc32", "sc16"):
        raise ValueError(f"unknown input_format {input_format!r}")
    s = StreamStep(spec, mesh if mesh is not None else single_mesh("cuda"),
                   chunk_len, max_frames_per_shard, threshold, ema,
                   pallas_halo, reshard, track_mode, agc, input_format)
    return s.step, s.multi, s.cb, s.h
