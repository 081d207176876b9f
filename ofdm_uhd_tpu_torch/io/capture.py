"""IQ capture files and stream sources: the radio's stand-in.

The counterpart of `ofdm_uhd_tpu/io/capture.py`; the files it writes are
byte for byte the reference's for the same samples. Formats:

* `.npy`            complex64 NumPy array
* `.iq` / `.bin`    interleaved int16 I/Q (UHD's 'sc16', full scale
                    32767) or interleaved float32 ('fc32'), as the JSON
                    sidecar says
* `<file>.json`     the sidecar: {"format": "sc16"|"fc32", ...metadata}

sc16 reads convert through the native C++ deframer (io/native.py) where
g++ can build it, else through NumPy; both give the same complex64.
Everything here runs on the host: a caller moves the samples to its
device.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

SC16_SCALE = 32767.0


def _sidecar(path: str) -> str:
    return path + ".json"


def write_capture(path: str, samples: np.ndarray, fmt: str = "auto",
                  meta: dict | None = None) -> None:
    """Write samples; the format from the extension ('.npy') or `fmt`
    ('auto' = 'sc16', which clips at full scale)."""
    samples = np.asarray(samples)
    if path.endswith(".npy"):
        np.save(path, samples.astype(np.complex64))
        if meta:
            with open(_sidecar(path), "w") as f:
                json.dump(meta, f)
        return
    if fmt == "auto":
        fmt = "sc16"
    if fmt == "sc16":
        scaled = np.clip(samples * SC16_SCALE, -32768, 32767)
        inter = np.empty(2 * len(samples), dtype=np.int16)
        inter[0::2] = np.round(scaled.real).astype(np.int16)
        inter[1::2] = np.round(scaled.imag).astype(np.int16)
    elif fmt == "fc32":
        inter = np.empty(2 * len(samples), dtype=np.float32)
        inter[0::2] = samples.real.astype(np.float32)
        inter[1::2] = samples.imag.astype(np.float32)
    else:
        raise ValueError(f"unknown format {fmt!r}")
    inter.tofile(path)
    side = {"format": fmt, **(meta or {})}
    with open(_sidecar(path), "w") as f:
        json.dump(side, f)


def read_capture(path: str) -> tuple[np.ndarray, dict]:
    """Read a capture -> (complex64 samples, metadata dict)."""
    meta = {}
    if os.path.exists(_sidecar(path)):
        with open(_sidecar(path)) as f:
            meta = json.load(f)
    if path.endswith(".npy"):
        return np.load(path).astype(np.complex64), meta
    fmt = meta.get("format", "sc16")
    if fmt == "sc16":
        try:
            from .native import deframe_sc16
            with open(path, "rb") as f:
                return deframe_sc16(f.read()), meta
        except ImportError:
            raw = np.fromfile(path, dtype=np.int16).astype(np.float32)
            return ((raw[0::2] + 1j * raw[1::2]) / SC16_SCALE
                    ).astype(np.complex64), meta
    elif fmt == "fc32":
        raw = np.fromfile(path, dtype=np.float32)
        return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64), meta
    raise ValueError(f"unknown format {fmt!r}")


class _Blocks:
    """Fixed-size blocks over `self.samples`; the final partial block is
    zero-padded, with `exhausted` set (end-of-burst semantics)."""

    samples: np.ndarray
    block: int
    pos: int

    @property
    def exhausted(self) -> bool:
        return self.pos >= len(self.samples)

    def read_block(self) -> np.ndarray:
        out = np.zeros(self.block, dtype=np.complex64)
        take = min(self.block, len(self.samples) - self.pos)
        if take > 0:
            out[:take] = self.samples[self.pos: self.pos + take]
        self.pos += take if take > 0 else self.block
        return out


class CaptureReader(_Blocks):
    """Block-oriented reader: the RX stream source (UHD recv's analog)."""

    def __init__(self, path: str, block: int = 65536):
        self.samples, self.meta = read_capture(path)
        self.block = block
        self.pos = 0

    def __iter__(self):
        while not self.exhausted:
            yield self.read_block()


class CaptureWriter:
    """Block-oriented writer: the TX sink (UHD send's analog). Blocks are
    NumPy arrays or tensors on any device."""

    def __init__(self, path: str, fmt: str = "auto", meta: dict | None = None):
        self.path, self.fmt, self.meta = path, fmt, meta
        self._parts: list[np.ndarray] = []

    def write_block(self, samples: np.ndarray | torch.Tensor) -> None:
        if isinstance(samples, torch.Tensor):
            samples = samples.cpu().numpy()
        self._parts.append(np.asarray(samples).astype(np.complex64))

    def close(self) -> None:
        allsam = (np.concatenate(self._parts) if self._parts
                  else np.zeros(0, np.complex64))
        write_capture(self.path, allsam, self.fmt, self.meta)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SyntheticSource(_Blocks):
    """Deterministic fake radio: the golden chain's frames through the
    impairment stack, read in blocks (the test double for over-the-air
    input)."""

    def __init__(self, spec, channel, n_frames: int, gap: int = 300,
                 seed: int = 0, block: int = 65536):
        from ..channel import make_capture
        from ..golden import GoldenModem
        rng = np.random.default_rng(seed)
        gm = GoldenModem(spec)
        self.payloads = rng.integers(
            0, 2, (n_frames, spec.payload_bits_per_frame)).astype(np.uint8)
        frames = np.stack([gm.modulate_frame(p) for p in self.payloads])
        self.samples = make_capture(frames, channel, spec.n_sc, gap=gap,
                                    seed=seed).astype(np.complex64)
        self.block = block
        self.pos = 0
