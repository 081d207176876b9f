"""The port's io/ against the reference's: capture files byte for byte
equal to the reference's write_capture's, each package reading the
other's files to the same samples, the native deframer (built by g++
under the checkout's build/, never beside its source) equal to NumPy's
conversion and to the reference's, the block reader and writer, and
SyntheticSource equal to the reference's for the same seed."""

import json
import os

import numpy as np
import pytest
import torch

from ofdm_uhd_tpu import io as ref_io
from ofdm_uhd_tpu.core import spec as ref_spec
from ofdm_uhd_tpu.io import native as ref_native

from ofdm_uhd_tpu_torch.core.spec import ChannelSpec, config
from ofdm_uhd_tpu_torch.io import (CaptureReader, CaptureWriter,
                                   SyntheticSource, read_capture,
                                   write_capture)
from ofdm_uhd_tpu_torch.io import native
from ofdm_uhd_tpu_torch.kernels.build import build_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMATS = [("sc16", ".iq"), ("fc32", ".iq"), ("sc16", ".bin"),
           ("fc32", ".bin"), ("auto", ".iq"), ("auto", ".npy")]


def samples(seed, n=1000, scale=0.1):
    r = np.random.default_rng(seed)
    return ((r.standard_normal(n) + 1j * r.standard_normal(n)) * scale
            ).astype(np.complex64)


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def need_native():
    if not native.available():
        pytest.skip("no C++ toolchain (g++) to build the native deframer")


@pytest.mark.parametrize("fmt,ext", FORMATS)
def test_capture_roundtrip(tmp_path, fmt, ext):
    x = samples(0)
    path = str(tmp_path / f"cap{ext}")
    write_capture(path, x, fmt=fmt, meta={"sample_rate": 1e6})
    y, meta = read_capture(path)
    assert y.dtype == np.complex64
    atol = 1e-4 if fmt in ("sc16", "auto") and ext != ".npy" else 1e-7
    np.testing.assert_allclose(y, x, atol=atol)
    assert meta.get("sample_rate") == 1e6
    if ext != ".npy":
        assert meta["format"] == ("sc16" if fmt == "auto" else fmt)


@pytest.mark.parametrize("fmt,ext", FORMATS)
@pytest.mark.parametrize("scale", [0.1, 2.0])
def test_files_equal_the_reference_byte_for_byte(tmp_path, fmt, ext, scale):
    """Same samples, same bytes: data file and sidecar, clipping at full
    scale (scale 2.0) and complex128 input included; each package reads
    the other's file to the same samples."""
    x = samples(1, scale=scale).astype(np.complex128)
    meta = {"config": "c3", "frames": 3}
    ours, theirs = str(tmp_path / f"ours{ext}"), str(tmp_path / f"ref{ext}")
    write_capture(ours, x, fmt=fmt, meta=meta)
    ref_io.write_capture(theirs, x, fmt=fmt, meta=meta)
    assert read_bytes(ours) == read_bytes(theirs)
    assert read_bytes(ours + ".json") == read_bytes(theirs + ".json")
    for path in (ours, theirs):
        a, meta_a = read_capture(path)
        b, meta_b = ref_io.read_capture(path)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert meta_a == meta_b


def test_npy_without_meta_writes_no_sidecar(tmp_path):
    path = str(tmp_path / "cap.npy")
    write_capture(path, samples(2))
    assert not os.path.exists(path + ".json")
    assert read_capture(path)[1] == {}


def test_unknown_format_raises(tmp_path):
    with pytest.raises(ValueError):
        write_capture(str(tmp_path / "cap.iq"), samples(3), fmt="sc8")
    path = str(tmp_path / "raw.iq")
    samples(3).tofile(path)
    with open(path + ".json", "w") as f:
        json.dump({"format": "sc8"}, f)
    with pytest.raises(ValueError):
        read_capture(path)


def test_native_builds_under_build_not_beside_the_source():
    need_native()
    so = native.library_path()
    assert so.is_file() and so.parent == build_dir()
    assert str(so).startswith(os.path.join(REPO, "build", ""))
    src_dir = os.path.join(REPO, "ofdm_uhd_tpu_torch", "io", "native_src")
    assert sorted(os.listdir(src_dir)) == ["deframe.cpp"]


def test_native_source_is_the_references_code():
    """The C++ is a copy: the same code, line for line, past the header
    comment."""
    def code(path):
        with open(path) as f:
            text = f.read()
        return text[text.index("#include"):]
    assert code(native.SRC) == code(os.path.join(
        REPO, "ofdm_uhd_tpu", "io", "native_src", "deframe.cpp"))


@pytest.mark.parametrize("n", [0, 1, 4096, 100_003])
def test_native_deframe_matches_numpy_and_the_reference(n):
    need_native()
    r = np.random.default_rng(n)
    ints = r.integers(-32768, 32768, 2 * n).astype(np.int16)
    raw = ints.tobytes()
    got = native.deframe_sc16(raw)
    f = ints.astype(np.float32)
    ref = ((f[0::2] + 1j * f[1::2]) / 32767.0).astype(np.complex64)
    assert got.dtype == np.complex64
    assert np.array_equal(got.view(np.float32), ref.view(np.float32))
    assert np.array_equal(got.view(np.float32),
                          ref_native.deframe_sc16(raw).view(np.float32))


def test_native_frame_and_power_match_the_reference():
    need_native()
    x = samples(4, 4096, 0.15)
    x = (np.clip(x.real, -0.99, 0.99) + 1j * np.clip(x.imag, -0.99, 0.99)
         ).astype(np.complex64)
    raw = native.frame_sc16(x)
    assert raw == ref_native.frame_sc16(x)
    np.testing.assert_allclose(native.deframe_sc16(raw), x, atol=1e-4)
    assert native.block_power(x) == ref_native.block_power(x)
    assert abs(native.block_power(x) - np.mean(np.abs(x) ** 2)) < 1e-6


def test_read_capture_falls_back_to_numpy(tmp_path, monkeypatch):
    """Where g++ cannot build the deframer, read_capture converts with
    NumPy, to the same samples."""
    path = str(tmp_path / "cap.iq")
    write_capture(path, samples(5))
    want, _ = read_capture(path)

    def no_build():
        raise ImportError("no toolchain")
    monkeypatch.setattr(native, "_load", no_build)
    assert not native.available()
    got, meta = read_capture(path)
    assert np.array_equal(got.view(np.float32), want.view(np.float32))
    assert meta["format"] == "sc16"


@pytest.mark.parametrize("block", [256, 1000, 4096])
def test_reader_blocks(tmp_path, block):
    x = np.arange(1000, dtype=np.complex64)
    path = str(tmp_path / "cap.npy")
    write_capture(path, x)
    r = CaptureReader(path, block=block)
    blocks = list(r)
    assert len(blocks) == -(-1000 // block) and r.exhausted
    assert all(b.shape == (block,) for b in blocks)
    got = np.concatenate(blocks)
    assert np.array_equal(got[:1000], x) and not got[1000:].any()
    ref = ref_io.CaptureReader(path, block=block)
    assert all(np.array_equal(a, b) for a, b in zip(blocks, ref))


@pytest.mark.parametrize("fmt,ext", [("sc16", ".iq"), ("fc32", ".bin"),
                                     ("auto", ".npy")])
def test_writer_takes_tensors_and_arrays(tmp_path, fmt, ext):
    """CaptureWriter blocks from NumPy arrays and tensors (a CPU tensor
    here; any device's is copied to the host) give the reference writer's
    file for the same samples."""
    x = samples(6, 3000)
    ours, theirs = str(tmp_path / f"ours{ext}"), str(tmp_path / f"ref{ext}")
    meta = {"frames": 2}
    with CaptureWriter(ours, fmt, meta) as w:
        w.write_block(torch.from_numpy(x[:1000]))
        w.write_block(x[1000:2000])
        w.write_block(torch.from_numpy(x[2000:]).to(torch.complex128))
    with ref_io.CaptureWriter(theirs, fmt, meta) as w:
        for part in (x[:1000], x[1000:2000], x[2000:]):
            w.write_block(part)
    assert read_bytes(ours) == read_bytes(theirs)
    assert read_bytes(ours + ".json") == read_bytes(theirs + ".json")


def test_empty_writer(tmp_path):
    path = str(tmp_path / "empty.iq")
    CaptureWriter(path).close()
    assert read_capture(path)[0].shape == (0,)


@pytest.mark.parametrize("name,block", [("c1", 1024), ("c2", 4096)])
def test_synthetic_source_equals_the_reference(name, block):
    ch = ChannelSpec(snr_db=20.0, cfo=0.1, timing_offset=30)
    src = SyntheticSource(config(name), ch, n_frames=3, block=block, seed=4)
    ref = ref_io.SyntheticSource(ref_spec.config(name), ref_spec.ChannelSpec(
        snr_db=20.0, cfo=0.1, timing_offset=30), n_frames=3, block=block,
        seed=4)
    assert np.array_equal(src.payloads, ref.payloads)
    assert np.array_equal(src.samples, ref.samples)
    blocks = []
    while not src.exhausted:
        blocks.append(src.read_block())
        assert np.array_equal(blocks[-1], ref.read_block())
    assert ref.exhausted and len(blocks) == -(-len(src.samples) // block)
    assert all(b.shape == (block,) for b in blocks)
