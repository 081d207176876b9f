"""Continuous-stream receiver: the host loop around the stream step.

The counterpart of ofdm_uhd_tpu/pipeline/stream.py. The host buffers radio
samples and feeds fixed-size chunks; K = steps_per_dispatch buffered
chunks run as one K-step dispatch (shard/time_parallel.py, over the time
axis of the mesh), the rest one at a time, with identical numerics;
`process_device` takes chunk stacks already on the device. The step
returns fixed-capacity frame slots, which the host filters to the owned
ones and orders by start.

Feed: the chunks go to the mesh's first device, where the step's
decimation and AGC run and the carried state lives. The decimation is the
reference's stream form (valid mode over a carried filter tail) in exact
float32 whatever the spec's filter_precision: the reference's stream never
reads it. Detection uses the fixed threshold, or with threshold_mode='cfar'
each shard's noise-floor-adaptive one over its own window [Cb + H], as the
reference's shards take it. On a CUDA device each
dispatch's chunks are staged in pinned host
memory and uploaded on a side stream while the card computes the previous
dispatch, and each dispatch is issued before the previous one's outputs
are read; those outputs are copied to
pinned host buffers as soon as they are enqueued, and read after their
event. Host <-> device syncs per dispatch: one per step (the TRACK
retry's predicate) and one on the outputs' event.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..core.spec import WaveformSpec
from ..core.state import StreamState
from ..shard.mesh import single_mesh
from ..shard.time_parallel import make_stream_step


@dataclasses.dataclass
class StreamFrame:
    start: int          # global sample offset of the frame
    payload: np.ndarray
    crc_ok: bool
    eps: float
    evm_db: float


class StreamRx:
    """Streaming OFDM receiver over the time axis of a ('frame', 'time')
    mesh (shard/mesh.py make_mesh; row 0 of its frame axis, or across
    processes the row each process runs, each row a replica), or, with
    mesh=None, one shard on `device` (default the first CUDA card; without
    one, torch raises: pass device='cpu' to run the plain versions on the
    CPU). The reference's mesh=None is every device; the two agree on a
    one-card machine.

    The reference's constructor arguments: chunk_len defaults to T blocks
    of the one-shard chunk; pallas_halo=True moves the halos with the halo
    kernel (K10) on CUDA meshes; reshard=True balances the demod over the
    shards (all_to_all); threshold_mode='cfar' detects at each shard
    window's clip(16 * median(M), 0.05, threshold).
    A spec with filter_precision='bf16' runs, in exact float32, as the
    reference's stream runs it.

    On a mesh that spans processes (shard/mesh.py init_distributed), every
    process feeds the whole stream, runs its own shards, and returns every
    frame; save_state writes from process 0, load_state reads in each.
    """

    def __init__(self, spec: WaveformSpec, mesh=None,
                 chunk_len: int | None = None,
                 max_frames_per_shard: int | None = None,
                 threshold: float = 0.5, threshold_mode: str = "fixed",
                 pallas_halo: bool = False,
                 reshard: bool = False, track_mode: bool = True,
                 agc: bool = True, steps_per_dispatch: int = 8,
                 input_format: str = "fc32",
                 device: str | torch.device = "cuda"):
        self.spec = spec
        self.mesh = mesh if mesh is not None else single_mesh(device)
        self.device = self.mesh.first_device
        t = self.mesh.shape["time"]
        h = StreamState.halo_len(spec)
        m = spec.resample_m
        if chunk_len is None:
            # per-shard block rounded up to a multiple of M so the radio
            # chunk (chunk_len * L / M) is integral and L-aligned
            chunk_len = t * (-(-max(2 * h, 4 * spec.frame_len) // m) * m)
        if (chunk_len * spec.resample_l) % m:
            raise ValueError("chunk_len*L must be divisible by M")
        if steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        self.chunk_len = chunk_len              # baseband samples per step
        self.radio_chunk = chunk_len * spec.resample_l // m
        self.steps_per_dispatch = steps_per_dispatch
        self.input_format = input_format
        _, self._multi, self.cb, self.h = make_stream_step(
            spec, self.mesh, chunk_len, max_frames_per_shard,
            (threshold, threshold_mode),
            pallas_halo=pallas_halo, reshard=reshard, track_mode=track_mode,
            agc=agc, input_format=input_format)
        self.state = StreamState.init(spec, self.device)
        self.rescued = 0       # frames recovered by the TRACK-mode retry
        # host remainder: complex64 samples, or int16 IQ planes [2, n]
        self._buf = (np.zeros(0, dtype=np.complex64)
                     if input_format == "fc32"
                     else np.zeros((2, 0), dtype=np.int16))
        # host mirror of state.steps (unbounded Python int): the global
        # timebase steps * chunk_len never wraps
        self._steps = 0
        self._upload = None    # the side stream of the uploads (CUDA)

    def tracking(self) -> dict:
        """The tracked channel and CFO state."""
        h_t = self.state.h_track.cpu().numpy()
        return {
            "eps_track": float(self.state.eps_track),
            "track_wt": float(self.state.track_wt),
            "h_track_rms": float(np.sqrt(np.mean(np.abs(h_t) ** 2))),
            "rescued": self.rescued,
        }

    def _put_chunk(self, chunk: np.ndarray) -> torch.Tensor:
        """Host chunk(s) -> the device: [radio_chunk] / [2, radio_chunk]
        for one step, with a leading [K] for a K-step dispatch."""
        t = torch.from_numpy(np.ascontiguousarray(chunk))
        if self.device.type != "cuda":
            return t.to(self.device, copy=True)
        # staged in pinned memory (a copy from pageable memory would be
        # synchronous) and uploaded on a side stream, so the copy runs
        # while the card computes the dispatch before it
        main = torch.cuda.current_stream(self.device)
        if self._upload is None:
            self._upload = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._upload):
            dev = t.pin_memory().to(self.device, non_blocking=True)
        main.wait_stream(self._upload)
        dev.record_stream(main)
        return dev

    def _start_fetch(self, outs: dict) -> tuple[dict, object]:
        """Start the outputs' device -> host copies; (host tensors, event
        to wait on before reading them, or None)."""
        if self.device.type != "cuda":
            return outs, None
        host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                for k, v in outs.items()}
        for k, v in outs.items():
            host[k].copy_(v, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return host, done

    def process(self, samples: np.ndarray) -> list[StreamFrame]:
        """Feed samples at the RADIO rate (any length): complex fc32, or
        int16 IQ planes [2, n] for input_format='sc16'. Returns the frames
        completed so far, decoded at baseband."""
        if self.input_format == "sc16":
            if samples.dtype != np.int16 or samples.ndim != 2:
                raise ValueError("sc16 stream expects int16 IQ planes [2, n]")
            self._buf = np.concatenate([self._buf, samples], axis=1)
        else:
            self._buf = np.concatenate(
                [self._buf, np.asarray(samples).astype(np.complex64)])
        rc = self.radio_chunk
        n_chunks = self._buf.shape[-1] // rc
        k = self.steps_per_dispatch
        stacks, i = [], 0
        while i < n_chunks:
            kk = k if n_chunks - i >= k else 1
            flat = self._buf[..., i * rc:(i + kk) * rc]
            # [K, rc], or [K, 2, rc] for sc16 planes
            stacks.append(np.moveaxis(flat.reshape(flat.shape[:-1] + (kk, rc)),
                                      -2, 0))
            i += kk
        self._buf = self._buf[..., n_chunks * rc:]
        return self._run((self._put_chunk(c) for c in stacks))

    def process_device(self, stacks) -> list[StreamFrame]:
        """Decode chunk stacks already on the device, in stream order after
        what was fed before: each [K, radio_chunk] complex64, or [K, 2,
        radio_chunk] int16 for sc16 (one K-step dispatch each). The host
        buffer must hold no partial chunk."""
        if self._buf.shape[-1]:
            raise ValueError("process_device: the host buffer holds "
                             f"{self._buf.shape[-1]} samples")
        return self._run(stacks)

    def _run(self, stacks) -> list[StreamFrame]:
        """One K-step dispatch per stack; each dispatch is issued before
        the previous one's outputs are read."""
        out: list[StreamFrame] = []
        pending = None
        for dev in stacks:
            self.state, outs = self._multi(self.state, dev)
            base = self._steps * self.chunk_len
            self._steps += dev.shape[0]
            if pending is not None:
                out.extend(self._collect(*pending))
            pending = (*self._start_fetch(outs), base)
        if pending is not None:
            out.extend(self._collect(*pending))
        return out

    def flush(self) -> list[StreamFrame]:
        """Zero-pad the remainder (plus one extra chunk so the delayed tail
        is fully processed) and drain."""
        if self.input_format == "sc16":
            pad = (-self._buf.shape[1]) % self.radio_chunk
            return self.process(
                np.zeros((2, pad + self.radio_chunk), dtype=np.int16))
        pad = (-len(self._buf)) % self.radio_chunk
        return self.process(np.zeros(pad + self.radio_chunk,
                                     dtype=np.complex64))

    def _collect(self, outs: dict, done, base: int) -> list[StreamFrame]:
        """The owned slots of one dispatch's outputs [K, mf, ...], ordered
        by start, as frames on the global timebase."""
        if done is not None:
            done.synchronize()
        meta_i, meta_f, payload = (outs[key].numpy() for key in
                                   ("meta_i", "meta_f", "payload"))
        # n_rescued is a per-step broadcast column; read one slot per step
        self.rescued += int(meta_i[:, 0, 3].sum())
        owned = meta_i[:, :, 1].astype(bool)
        if not owned.any():
            return []
        bits = np.unpackbits(payload, axis=-1)[
            ..., :self.spec.payload_bits_per_frame]
        res = []
        for kk in range(meta_i.shape[0]):
            idx = np.nonzero(owned[kk])[0]
            order = np.argsort(meta_i[kk, idx, 2])
            b = base + kk * self.chunk_len
            for i in idx[order]:
                res.append(StreamFrame(
                    start=b + int(meta_i[kk, i, 2]),
                    payload=bits[kk, i],
                    crc_ok=bool(meta_i[kk, i, 0]),
                    eps=float(meta_f[kk, i, 0]),
                    evm_db=float(meta_f[kk, i, 1]),
                ))
        return res

    # ---- checkpoint / resume (the reference's .npz layout) ----

    def save_state(self, path: str) -> None:
        """Checkpoint = StreamState fields + the host-side chunk buffer.
        On a mesh that spans processes (whose states are replicas) process
        0 writes it and the others wait for it at a barrier."""
        if not self.mesh.distributed or dist.get_rank() == 0:
            np.savez(path, __buf__=self._buf,
                     __steps__=np.int64(self._steps),
                     **self.state.to_numpy())
        if self.mesh.distributed:
            dist.barrier()

    def load_state(self, path: str) -> None:
        """Resume from a checkpoint of either package, the reference's older
        ones included: those carry `samples` (a sample count) in place of
        `steps` and no `__steps__`, and the step count is samples //
        chunk_len, as the reference converts them."""
        with np.load(path) as z:
            arrays, missing = {}, []
            for f in dataclasses.fields(StreamState):
                if f.name in z:
                    arrays[f.name] = z[f.name]
                elif f.name == "steps" and "samples" in z:
                    arrays[f.name] = int(z["samples"]) // self.chunk_len
                else:
                    missing.append(f.name)
            if missing:
                raise ValueError(f"incompatible checkpoint {path!r}: missing "
                                 f"StreamState fields {missing}")
            self.state = StreamState.from_numpy(arrays, self.device)
            self._buf = z["__buf__"]
            host = z["__steps__"] if "__steps__" in z else arrays["steps"]
            self._steps = int(host)
