"""chip_smoke.py's own pieces on the CPU: the library calls it times as
`library_ms` compute the functions of the kernels they stand beside (on
the same inputs, to float32 rounding: cuDNN-style convolutions sum in
another order than the plain versions; the bf16 tier's yardsticks to
half a bf16 step, 2^-8 of max|y|, since they round their outputs to
bf16), the bound it reports, the kernels its JSON line names, its
refusal to run without a card, a rehearsal of the distributed phase
(its own worker processes and cli.pod_rx, under gloo on the CPU), and a
rehearsal of the shift phase and the CFAR run at tiny sizes, with the kernel wrappers patched to their plain
versions and the card's events to host-clock stand-ins."""

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from ofdm_uhd_tpu_torch.kernels import (banded, extract, fft,  # noqa: E402
                                        fir, policy, sync)
from ofdm_uhd_tpu_torch.research import deframe, fir_ilv, shift  # noqa: E402
from ofdm_uhd_tpu_torch.phy.tables import resample_filter  # noqa: E402

torch.set_num_threads(2)


def _x(seed, *shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.normal(size=shape) + 1j * rng.normal(
        size=shape)).astype(np.complex64))


def _merge(planes, rows, n_out):
    y = planes[:, 0, :n_out]
    return torch.complex(y[:rows], y[rows:])


@pytest.mark.parametrize("stride", [1, 8])
def test_library_fir_is_the_strided_fir(stride):
    taps = resample_filter(8, 1)
    x = _x(stride, 3, 4096)
    got = _merge(chip_smoke.library_fir(torch, x, taps, stride)(), 3,
                 4096 // stride)
    want = fir.decim_plain(x, stride, taps)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("l", [2, 8])
def test_library_interp_is_the_polyphase_interpolation(l):
    taps = resample_filter(l, 1)
    x = _x(l, 2, 1001)
    planes = chip_smoke.library_interp(torch, x, l, taps)()
    assert planes.shape[-1] == 1001 * l
    got = _merge(planes, 2, 1001 * l)
    want = fir.interp_plain(x, l, taps)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("stride", [1, 8])
def test_library_fir_bf16_is_the_bf16_strided_fir(stride):
    taps = resample_filter(8, 1)
    x = _x(stride + 2, 3, 4096)
    planes = chip_smoke.library_fir(torch, x, taps, stride, torch.bfloat16)()
    assert planes.dtype == torch.bfloat16
    got = _merge(planes.float(), 3, 4096 // stride)
    want = fir.decim_plain_bf16(x, stride, taps)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 2.0 ** -8 * float(
        want.abs().max())


@pytest.mark.parametrize("l", [2, 8])
def test_library_interp_bf16_is_the_bf16_interpolation(l):
    taps = resample_filter(l, 1)
    x = _x(l + 2, 2, 1001)
    planes = chip_smoke.library_interp(torch, x, l, taps, torch.bfloat16)()
    got = _merge(planes.float(), 2, 1001 * l)
    want = fir.interp_plain_bf16(x, l, taps)
    assert float((got - want).abs().max()) <= 2.0 ** -8 * float(
        want.abs().max())


def test_kernels_line_names_every_kernel():
    """Every counted kernel has its entry in the kernels line, the bf16
    tier's two included, each naming its source and the TPU kernel it
    replaces by file and line."""
    assert set(chip_smoke.KERNEL_INFO) == set(policy.KERNELS)
    for name in ("fir_bf16", "interp_bf16"):
        src, rep = chip_smoke.KERNEL_INFO[name]
        assert os.path.isfile(os.path.join(REPO, src))
        path, line = rep.split(":")
        with open(os.path.join(REPO, path)) as f:
            text = f.read().splitlines()[int(line) - 1]
        assert text.startswith("def ") and "mxu_pallas" in text
        assert chip_smoke.held_kernel(name) == name
    assert chip_smoke.held_kernel("fir_stride1") == "fir"
    assert chip_smoke.C4_BF16_PATH[0] == "fir_bf16"
    for name, fn in (("shift_fir", "fir_shift_pallas"),
                     ("shift_decim", "polyphase_decim_shift_pallas"),
                     ("shift_interp", "polyphase_interp_shift_pallas"),
                     ("shift_sc", "sc_correlate_shift_pallas")):
        src, rep = chip_smoke.KERNEL_INFO[name]
        assert os.path.isfile(os.path.join(REPO, src))
        path, line = rep.split(":")
        with open(os.path.join(REPO, path)) as f:
            text = f.read().splitlines()[int(line) - 1]
        assert text.startswith(f"def {fn}(")
    assert chip_smoke.held_kernel("shift_decim_c4") == "shift_decim"
    assert chip_smoke.held_kernel("shift_sc") == "shift_sc"
    assert set(chip_smoke.SHIFT_PATH) == {
        k for k in policy.KERNELS if k.startswith("shift_")}
    for name, fn in (("banded_fir", "fir_pallas"),
                     ("banded_decim", "polyphase_decim_pallas"),
                     ("banded_interp", "polyphase_interp_pallas"),
                     ("banded_sc", "sc_correlate_pallas"),
                     ("ilv_fir", "fir_ilv_pallas"),
                     ("ilv_decim", "polyphase_decim_ilv_pallas"),
                     ("ilv_interp", "polyphase_interp_ilv_pallas"),
                     ("ilv_fir_bf16", "fir_ilv_pallas"),
                     ("ilv_decim_bf16", "polyphase_decim_ilv_pallas"),
                     ("ilv_interp_bf16", "polyphase_interp_ilv_pallas"),
                     ("deframe", "extract_frames_dma")):
        src, rep = chip_smoke.KERNEL_INFO[name]
        assert os.path.isfile(os.path.join(REPO, src))
        path, line = rep.split(":")
        with open(os.path.join(REPO, path)) as f:
            text = f.read().splitlines()[int(line) - 1]
        assert text.startswith(f"def {fn}(")
        assert name in chip_smoke.TIERS_PATH
    assert set(chip_smoke.TIERS_PATH) == {
        k for k in policy.KERNELS
        if k.startswith(("banded_", "ilv_")) or k == "deframe"}
    assert chip_smoke.held_kernel("banded_sc_c3") == "banded_sc"
    assert chip_smoke.held_kernel("deframe_offsets") == "deframe"
    assert chip_smoke.held_kernel("ilv_decim_bf16_c4") == "ilv_decim_bf16"
    assert chip_smoke.held_kernel("ilv_decim_c4") == "ilv_decim"
    # the files path's counted run launches kernels the line names, none
    # of them off the user paths
    assert set(chip_smoke.FILES_PATH) <= set(chip_smoke.KERNEL_INFO)
    assert not set(chip_smoke.FILES_PATH) & set(chip_smoke.OFF_PATH)


def test_bound_takes_the_larger_time():
    ms, by = chip_smoke.bound(3.35e9, 1.0)
    assert by == "bytes" and abs(ms - 1.0) < 1e-12
    ms, by = chip_smoke.bound(1.0, 67e9)
    assert by == "operations" and abs(ms - 1.0) < 1e-12
    # C3's K5 RX: 114,912 rows, 256 of each 288 read (the stripped CP is
    # never fetched), 256 written (0.1405 ms)
    ms, by = chip_smoke.bound(*chip_smoke.work_fft(114_912, 256, 256, 256))
    assert by == "bytes" and abs(ms - 0.1405) < 1e-4
    ms, by = chip_smoke.bound(1.0, 989e9, chip_smoke.BF16_OPS)
    assert by == "operations" and abs(ms - 1.0) < 1e-12
    # C4's bf16 decimation: 8 padded captures of 4,138,472 samples in,
    # 517,309 out a row, complex64; 193 taps (0.089 ms, bytes)
    n_in, n_out = 4_138_472, 517_309
    ms, by = chip_smoke.bound(8.0 * 8 * (n_in + n_out), 4.0 * 193 * 8 * n_out,
                              chip_smoke.BF16_OPS)
    assert by == "bytes" and abs(ms - 0.089) < 1e-3


def test_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run in full")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "no CUDA device" in res.stderr


def test_halo_bound_at_c5():
    """K10's work at c5_sharded: 3 halos of H = 4288 complex64 samples,
    each read once and written once (16 H bytes), 6.144e-5 ms."""
    ms, by = chip_smoke.bound(16.0 * 4288 * 3, 0.0)
    assert by == "bytes" and abs(ms - 6.144e-5) < 1e-9


def test_check_stream_finds_shard_boundary_duplicates():
    """A frame that starts a few samples before a shard's extended block
    (start = k * Cb - H) is returned again at the block's first sample;
    check_stream keeps every sent frame and returns that duplicate."""
    from ofdm_uhd_tpu_torch.core.spec import config
    from ofdm_uhd_tpu_torch.core.state import StreamState
    from ofdm_uhd_tpu_torch.pipeline import StreamFrame
    spec = config("c5")
    h = StreamState.halo_len(spec)
    rng = np.random.default_rng(0)
    pays = rng.integers(0, 2, (6, spec.payload_bits_per_frame)).astype(
        np.uint8)
    starts = chip_smoke.C5_OFFSET + np.arange(6) * (spec.frame_len
                                                    + chip_smoke.GAP)
    frames = [StreamFrame(int(s), p, True, 0.1, -30.0)
              for s, p in zip(starts, pays)]
    block = int(starts[3]) + 5 + h          # frame 3 starts 5 before
    dup = StreamFrame(block - h, pays[3], False, 0.1, -20.0)
    got = chip_smoke.check_stream("t", frames[:4] + [dup] + frames[4:], pays,
                                  spec, block)
    assert [d.start for d in got] == [block - h]
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_stream("t", frames[:4] + [dup] + frames[4:], pays,
                                spec, block + 1)


class _HostEvent:
    """torch.cuda.Event's stand-in on the host clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def _counted(name, fn):
    def run(*args, **kw):
        policy.count_launch(name)
        return fn(*args, **kw)
    return run


@pytest.fixture
def on_host(monkeypatch):
    """chip_smoke's card calls on the CPU: events and synchronize on the
    host, the spin kernel a short sleep, and the wrappers the shift phase
    calls patched to their plain versions with a launch count."""
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda c: time.sleep(0.05))
    for mod, name, count, fn in (
            (shift, "_fir_cuda", "shift_fir",
             lambda x, t: fir.decim_plain(x, 1, t)),
            (shift, "_decim_cuda", "shift_decim", fir.decim_plain),
            (shift, "_interp_cuda", "shift_interp", fir.interp_plain),
            (shift, "_sc_cuda", "shift_sc", sync.sc_correlate_plain),
            (fir, "_strided_cuda", "fir",
             lambda x, t, s, valid=False: fir.decim_plain(x, s, t)),
            (fir, "_interp_cuda", "interp", fir.interp_plain),
            (sync, "_sccorr_cuda", "sccorr",
             lambda r, l, counter="sccorr": sync.sc_correlate_plain(r, l)),
            (extract, "_extract_cuda", "extract", extract.extract_plain),
            (banded, "_fir_cuda", "banded_fir",
             lambda x, t: fir.decim_plain(x, 1, t)),
            (banded, "_decim_cuda", "banded_decim",
             banded.decim_banded_plain),
            (banded, "_interp_cuda", "banded_interp", fir.interp_plain),
            (banded, "_sc_cuda", "banded_sc",
             banded.sc_correlate_banded_plain),
            (banded, "_strided_planes", "banded_decim",
             lambda p, t, s, k: fir.decim_plain(p.to(torch.complex64), 1,
                                                t)[..., ::s].real),
            (fir_ilv, "_fir_cuda", "ilv_fir",
             lambda x, t: fir.decim_plain(x, 1, t)),
            (fir_ilv, "_decim_cuda", "ilv_decim", fir.decim_plain),
            (fir_ilv, "_interp_cuda", "ilv_interp", fir.interp_plain),
            (fir_ilv, "_fir_bf16_cuda", "ilv_fir_bf16",
             lambda x, t: fir.decim_plain_bf16(x, 1, t)),
            (fir_ilv, "_decim_bf16_cuda", "ilv_decim_bf16",
             fir.decim_plain_bf16),
            (fir_ilv, "_interp_bf16_cuda", "ilv_interp_bf16",
             fir.interp_plain_bf16),
            (deframe, "_deframe_cuda", "deframe", deframe.deframe_plain)):
        monkeypatch.setattr(mod, name, _counted(count, fn))
    policy.reset_launches()
    yield
    policy.reset_launches()


def test_shift_phase_rehearsal(on_host, monkeypatch):
    """run_shift at tiny sizes: every shift_* wrapper launched in its
    counted run and no other kernel, every check against the plain
    version passes, the C4 A/B times the exact K7 kernels in turns, and
    the kernels line gets an entry for each shift_* kernel with launches
    under the `shift` path."""
    monkeypatch.setattr(chip_smoke, "SHIFT_N", 4096)
    # CPU tensors routed to the (patched) wrappers
    monkeypatch.setattr(policy, "use_kernel",
                        lambda x: not policy._STATE.forced_plain)
    radio, base = _x(11, 2, 8 * 1031), _x(12, 3, 300)
    out = chip_smoke.run_shift(torch, torch.device("cpu"), (radio, base))
    launches = out["launches"]
    assert launches["shift_fir"] == 2 and launches["shift_sc"] == 1
    assert launches["shift_decim"] == 2 and launches["shift_interp"] == 2
    assert all(c == 0 for k, c in launches.items()
               if k not in chip_smoke.SHIFT_PATH)
    res = out["kernels"]
    assert list(res) == ["shift_fir_193", "shift_fir_3", "shift_decim_c4",
                         "shift_decim", "shift_interp_c4", "shift_interp",
                         "shift_sc"]
    assert res["shift_decim_c4"]["shape"] == [2, 8 * 1031]
    assert len(res["shift_decim_c4"]["k7_device_ms"]) == 2
    assert res["shift_sc"]["library_ms"] is None
    assert out["energy_form_max_rel"] <= chip_smoke.R_TOL
    by_path = chip_smoke.path_launches({"shift": out})
    for name in chip_smoke.SHIFT_PATH:
        entry = chip_smoke.kernel_entry(name, {"shift": out}, by_path)
        assert entry["launches"] > 0 and entry["bound_by"] in (
            "bytes", "operations")
        assert entry["max_abs_err"] == 0.0
    assert chip_smoke.kernel_entry(
        "shift_decim", {"shift": out}, by_path)["paths"]["shift_c4"][
            "shape"] == [2, 8 * 1031]


def test_cfar_phase_rehearsal(on_host):
    """phase_cfar on two small C3 captures: the CFAR run equals its
    plain-forced run, decodes every sent frame as the fixed run does, and
    gives a threshold per capture."""
    from ofdm_uhd_tpu_torch.bench_lib import build_capture, to_sc16
    from ofdm_uhd_tpu_torch.core.spec import config
    spec = config("c3")
    built = [build_capture(spec, 3, 300, seed=s, device="cpu")
             for s in range(2)]
    iq = torch.from_numpy(to_sc16(np.stack([c for c, _ in built])))
    pays = torch.from_numpy(np.stack([p for _, p in built]))
    m = torch.rand((2, 1000), generator=torch.Generator().manual_seed(0))
    out = chip_smoke.phase_cfar(torch, spec, "c3", iq, pays, 5, m)
    assert out["frames_ok"] == {"fixed": 6, "cfar": 6}
    assert out["slots_moved"] == 0 and len(out["thresholds"]) == 2
    assert all(0.05 <= t <= 0.5 for t in out["thresholds"])


def test_tiers_phase_rehearsal(on_host, monkeypatch):
    """run_tiers at tiny sizes: every tiers kernel launched in its counted
    run and no other kernel, every check against the plain version passes
    (deframe exactly, and equal to K2 on offsets >= 0), the C4 A/B times
    K7, K11, K8 and K13 in turns, and the kernels line gets an entry for
    each tiers kernel with launches under the `tiers` path."""
    from ofdm_uhd_tpu_torch.core.spec import config
    monkeypatch.setattr(chip_smoke, "SHIFT_N", 4096)
    monkeypatch.setattr(chip_smoke, "TIERS_SESSION", (2, 1024))
    monkeypatch.setattr(policy, "use_kernel",
                        lambda x: not policy._STATE.forced_plain)
    fl = config("c3").frame_len
    radio, base = _x(11, 2, 8 * 1031), _x(12, 3, 300)
    cap = _x(13, 2, 3 * fl)
    ds = torch.tensor([[0, 17, 2 * fl + 1], [5, fl, 3 * fl]],
                      dtype=torch.int32)
    out = chip_smoke.run_tiers(torch, torch.device("cpu"), (radio, base),
                               (cap, ds))
    launches = out["launches"]
    assert launches["banded_fir"] == 1 and launches["banded_sc"] == 2
    assert launches["banded_decim"] == 2 and launches["banded_interp"] == 2
    assert launches["ilv_fir"] == 1 and launches["ilv_decim"] == 2
    assert launches["ilv_interp"] == 2 and launches["deframe"] == 2
    assert launches["ilv_fir_bf16"] == 1 and launches["ilv_decim_bf16"] == 2
    assert launches["ilv_interp_bf16"] == 2
    assert all(c == 0 for k, c in launches.items()
               if k not in chip_smoke.TIERS_PATH)
    res = out["kernels"]
    assert list(res) == [
        "banded_fir", "banded_decim_c4", "banded_decim", "banded_interp_c4",
        "banded_interp", "banded_sc_c3", "banded_sc", "ilv_fir",
        "ilv_decim_c4", "ilv_decim", "ilv_interp_c4", "ilv_interp",
        "ilv_fir_bf16", "ilv_decim_bf16_c4", "ilv_decim_bf16",
        "ilv_interp_bf16_c4", "ilv_interp_bf16", "deframe_c3",
        "deframe_offsets"]
    assert res["ilv_decim_bf16_c4"]["bound_by"] == "bytes"
    assert res["banded_decim_c4"]["bound_by"] == "bytes"
    assert res["deframe_offsets"]["shape"] == [2 * 17, fl]
    assert set(out["ab"]["decim_c4"]) == {"K7", "K11", "K8", "K13",
                                          "K8_planes"}
    assert all(len(v) == 2 for v in out["ab"]["decim_c4"].values())
    by_path = chip_smoke.path_launches({"tiers": out})
    for name in chip_smoke.TIERS_PATH:
        entry = chip_smoke.kernel_entry(name, {"tiers": out}, by_path)
        assert entry["launches"] > 0 and entry["bound_by"] in (
            "bytes", "operations")
        assert entry["max_abs_err"] == 0.0
    entry = chip_smoke.kernel_entry("banded_decim", {"tiers": out}, by_path)
    assert entry["paths"]["tiers_c4"]["shape"] == [2, 8 * 1031]


def test_tiers_bounds():
    """The banded tier's bound at C4's decimation: 298 MB of complex64 in
    and out (0.089 ms, bytes) against 12 x 193 flops an output at the TF32
    peak (0.024 ms); K12 at C3 moves K2's bytes (0.158 ms)."""
    n_in, n_out = 4_138_472, 517_309
    ms, by = chip_smoke.bound(*chip_smoke.work_tf32(8, n_in, n_out, 193))
    assert by == "bytes" and abs(ms - 0.089) < 1e-3
    assert abs(12.0 * 193 * 8 * n_out / chip_smoke.TF32_OPS * 1e3
               - 0.0194) < 1e-3
    ds = torch.zeros((8, 1026), dtype=torch.int32)
    ms, by = chip_smoke.bound(*chip_smoke.work_extract(4_436_068, ds, 4032))
    assert by == "bytes" and abs(ms - 0.158) < 1e-3
    ds[0, 0] = -1                         # a zero frame reads nothing
    less, _ = chip_smoke.bound(*chip_smoke.work_extract(4_436_068, ds,
                                                        4032))
    assert less < ms


def test_fft_holds_rehearsal(on_host, monkeypatch):
    """The FFT checks of a C3-shaped path at a tiny size, the wrappers
    patched to their plain versions: K3 forward and inverse and K5 RX held
    against their plain versions, K5 on contiguous windows equal to K3,
    K5 TX against ifft + cat, each with its in-kernel time taken in turns
    with torch.fft's (ortho) and torch.fft's unscaled call beside it; the
    inverse check counts under the fft kernel."""
    from ofdm_uhd_tpu_torch.core.spec import config
    spec = config("c3")

    def fft_cp(kernel, x, n, start, cp, inverse):
        policy.count_launch(kernel)
        if inverse:
            return fft.ifft_cp_plain(x, cp)
        return fft.cp_strip_fft_plain(x, start, n)
    monkeypatch.setattr(fft, "_fft_cuda", _counted("fft", fft.fft_plain))
    monkeypatch.setattr(fft, "_fft_cp_cuda", fft_cp)
    syms = _x(21, 2, 3, spec.sym_len)
    ins = {"cap": _x(22, 2, 600), "llr": None, "syms": syms,
           "start": spec.cp - 4, "grid": _x(23, 2, 3, spec.n_sc)}
    res = chip_smoke.phase_kernels(torch, spec, "c3", ins, ("fft", "cpfft"))
    res.update(chip_smoke.phase_kernel_ifftcp(torch, spec, "c3", ins["grid"]))
    assert list(res) == ["fft", "fft_inverse", "cpfft", "ifftcp"]
    for v in res.values():
        assert v["max_abs_err"] <= 1e-5 and v["bound_by"] == "bytes"
        # None where the host took longer to enqueue than the spin lasted
        assert len(v["device_ms_turns"]) == 2
        assert len(v["library_device_ms_turns"]) == 2
        assert {"device_ms", "library_device_ms",
                "library_unscaled_ms"} <= set(v)
    assert res["fft"]["shape"] == [2, 3, spec.n_sc]
    assert res["ifftcp"]["library_ms"] is None
    assert res["fft_inverse"]["library_ms"] is not None
    assert chip_smoke.held_kernel("fft_inverse") == "fft"


@pytest.mark.parametrize("tier", ["exact", "bf16"])
def test_fir_holds_rehearsal(on_host, monkeypatch, tier):
    """phase_kernels_fir at a tiny C4 size, the wrappers patched to their
    plain versions: the decimation (and, in the exact tier, the stride-1
    FIR of the decimated rows) held with its in-kernel time taken in turns
    with its conv1d's, the interpolation with its in-kernel time."""
    from ofdm_uhd_tpu_torch.core.spec import config
    spec = config("c4")
    if tier == "bf16":
        spec = spec.with_(filter_precision="bf16", kernel_backend="pallas")
    monkeypatch.setattr(fir, "_strided_bf16_cuda", _counted(
        "fir_bf16", lambda x, t, s: fir.decim_plain_bf16(x, s, t)))
    monkeypatch.setattr(fir, "_interp_bf16_cuda",
                        _counted("interp_bf16", fir.interp_plain_bf16))
    ins = {"radio": _x(31, 2, 8 * 700 + 3), "dec": _x(32, 2, 700)}
    res = chip_smoke.phase_kernels_fir(torch, spec, "c4", ins, _x(33, 3, 200))
    held = (["fir", "fir_stride1"] if tier == "exact" else ["fir_bf16"])
    interp = "interp" if tier == "exact" else "interp_bf16"
    assert list(res) == held + [interp]
    for key in held:
        v = res[key]
        assert v["max_abs_err"] == 0.0 and v["library_ms"] is not None
        assert len(v["device_ms_turns"]) == 2
        assert len(v["library_device_ms_turns"]) == 2
        assert {"device_ms", "library_device_ms"} <= set(v)
    assert res[held[0]]["shape"] == [2, 8 * 700 + 3]
    assert "device_ms" in res[interp]
    assert "library_device_ms" not in res[interp]
    assert chip_smoke.held_kernel("fir_stride1") == "fir"


def test_kernel_registers_reads_ptxas_output():
    """phase_build's table of registers and spills from `-Xptxas -v`: each
    entry function by its short name, a template's int argument kept."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN38_GLOBAL__N__e59356"
        "06_6_fft_cu_ofdm_fft13fft_cp_kernelILi10EEEvPK6float2PS1_S3_iifiii'"
        " for 'sm_90a'",
        "ptxas info    : Function properties for _ZN38_GLOBAL__N__e5935606_"
        "6_fft_cu_ofdm_fft13fft_cp_kernelILi10EEEvPK6float2PS1_S3_iifiii",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 122 registers, used 1 barriers, 34816 bytes "
        "smem",
        "ptxas info    : Compiling entry function '_Z14viterbi_kernelPKfPjPh"
        "ii' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers"])
    assert chip_smoke.kernel_registers(log) == {
        "fft_cp_kernel<10>": [122, 12], "viterbi_kernel": [40, 0]}


def test_verbose_build_keeps_its_ptxas_report(tmp_path, monkeypatch):
    """The library's name leaves `-Xptxas -v` out, so a verbose call finds
    a plain build's library: it builds it again, verbose, once, and keeps
    the report beside it; a later process's verbose call reads that report
    back without building, and a plain call loads the library as it is."""
    from unittest import mock

    from ofdm_uhd_tpu_torch.kernels import build
    builds = []

    def compile_and_link(flags, so):
        builds.append("-v" in flags)
        build._LOADED.log += "ptxas info : Used 40 registers\n" \
            if "-v" in flags else ""
        so.write_bytes(b"")
    monkeypatch.setattr(build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(build, "_compile_and_link", compile_and_link)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: mock.MagicMock())
    monkeypatch.setattr(build, "_LOADED", build._Loaded())

    def new_process(verbose):
        build._LOADED = build._Loaded()
        build.library(verbose=verbose)
        return build.build_log()
    assert new_process(False) == "" and builds == [False]
    assert "Used 40 registers" in new_process(True)
    assert builds == [False, True]
    assert "Used 40 registers" in new_process(True)
    assert new_process(False) == "" and builds == [False, True]
    reports = list(tmp_path.glob("*.ptxas.log"))
    assert len(reports) == 1 and len(list(tmp_path.glob("*.so"))) == 1


def test_big_nsc_phase_rehearsal(on_host, monkeypatch):
    """run_big_nsc at tiny sizes, the routes' thresholds lowered so that
    n_sc = 64 takes one K3 launch and the S&C tile kernel and n_sc = 256
    K3's two-pass route and the S&C split route, the wrappers patched to
    their plain versions with a launch count: every frame decodes, the
    path's kernels launch (the TX's inverse FFT too) and the other
    route's never, each pass of both routes is held against its plain
    step and the split route against the tile kernel's bits, every split
    of K3's route is timed beside one launch, and the kernels line gets
    entries for them."""
    from ofdm_uhd_tpu_torch.kernels import build, localize, scfront, viterbi

    def tile(kernel, flat, nd, l, metric):
        policy.count_launch(kernel)
        return (scfront.sc_frontend_plain(flat, l) if metric
                else sync.sc_correlate_plain(flat, l))
    monkeypatch.setattr(policy, "use_kernel",
                        lambda x: not policy._STATE.forced_plain)
    monkeypatch.setattr(build, "check_inputs", lambda *a: None)
    for mod, name, count, fn in (
            (fft, "_fft_launch", "fft", fft.fft_plain),
            (fft, "_columns_cuda", "fft_columns", fft.columns_plain),
            (fft, "_rows_t_cuda", "fft_rows_t", fft.rows_t_plain),
            (sync, "_span_cuda", "sc_span", sync.span_plain),
            (sync, "_stride_cuda", "sc_stride", sync.stride_plain),
            (localize, "_localize_cuda", "localize",
             lambda m, p, c, s, cp, rel: localize.localize_plain(m, p, c, s,
                                                                 cp)),
            (viterbi, "_viterbi_cuda", "viterbi",
             lambda x, group=None, traceback=True: viterbi.viterbi_plain(x))):
        monkeypatch.setattr(mod, name, _counted(count, fn))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(sync, "_tile_cuda", tile)
    monkeypatch.setattr(fft, "ONE_LAUNCH_N", 128)
    monkeypatch.setattr(fft, "PASS_MAX_N", 64)
    monkeypatch.setattr(sync, "TILE_MAX_L", 32)
    monkeypatch.setattr(chip_smoke, "BIG_NSC", (64, 256))
    monkeypatch.setattr(chip_smoke, "BIG_CAPS", 2)
    monkeypatch.setattr(chip_smoke, "BIG_FRAMES", 2)
    monkeypatch.setattr(chip_smoke, "BIG_FFT_NS", (128, 256))
    monkeypatch.setattr(chip_smoke, "BIG_FFT_SAMPLES", 2048)
    monkeypatch.setattr(chip_smoke, "REPS", 1)
    monkeypatch.setattr(chip_smoke, "device_busy_share",
                        lambda torch, run: {"busy_share": None,
                                            "traced_wall_ms": 0.0})
    out = chip_smoke.run_big_nsc(torch, torch.device("cpu"))
    launches, tx = out["launches"], out["tx_launches"]
    for k in ("scfront", "sc_span", "sc_stride", "localize",
              "extract", "fft", "fft_columns", "fft_rows_t", "viterbi"):
        assert launches[k] > 0, k
    for k in ("fft", "fft_columns", "fft_rows_t"):
        assert tx[k] > 0, k
    for n, ran in ((64, ("fft",)), (256, ("fft_columns", "fft_rows_t"))):
        got = out["slices"][n]["launches"]
        assert {k for k in ("fft", "fft_columns", "fft_rows_t")
                if got[k]} == set(ran)
    # one counted run at l = 128: two launches, no tile
    assert launches["sc_span"] == launches["sc_stride"] == 1
    assert out["slices"][256]["launches"]["scfront"] == 0
    assert {f"{k}_256" for k in ("sc_span", "sc_stride", "sc_stride_route",
                                 "fft_columns_4x64", "fft_rows_t_4x64",
                                 "fft")} <= set(out["kernels"])
    route = out["kernels"]["sc_stride_route_256"]
    assert route["width"] == sync.split_width(128) and route["bits"]
    for k in ("sc_span", "sc_stride", "sc_stride_route"):
        assert out["kernels"][f"{k}_256"]["max_abs_err"] == 0.0
        assert "device_ms" in out["kernels"][f"{k}_256"]
    assert "scfront_64" in out["kernels"] and "fft_n256" in out["kernels"]
    for n in (64, 256):                 # K1's hold, timed in-kernel too
        loc = out["kernels"][f"localize_{n}"]
        assert "device_ms" in loc and loc["found"] >= 4
    entry = chip_smoke.kernel_entry("localize", {"big_nsc": out},
                                    chip_smoke.path_launches(
                                        {"big_nsc": out}))
    assert {"big_nsc_64", "big_nsc_256"} <= set(entry["paths"])
    assert all("device_ms" in v for v in entry["paths"].values())
    assert set(out["kernels"]["fft_n128"]["splits"]) == {
        "16x8", "8x16", "4x32", "2x64", "one_launch"}
    assert set(out["kernels"]["fft_n256"]["splits"]) == {
        "32x8", "16x16", "8x32", "4x64"}
    for n in (64, 256):
        assert out["slices"][n]["frames_ok"] == 4
    by_path = chip_smoke.path_launches({"big_nsc": out})
    for name in ("fft_columns", "fft_rows_t", "sc_span", "sc_stride"):
        entry = chip_smoke.kernel_entry(name, {"big_nsc": out}, by_path)
        assert entry["launches"] > 0 and entry["bound_ms"] > 0


def test_hold_k4_rehearsal(on_host, monkeypatch):
    """K4's hold: bit-exact against the plain version at k4_group's size
    and at every forced one, each size timed in turns with its ACS rate,
    the forward alone in turns with the decode for the traceback's share;
    the entry maps to K4 in the kernels line."""
    from ofdm_uhd_tpu_torch.kernels import viterbi
    groups = []

    def k4(x, group=None, traceback=True):
        policy.count_launch("viterbi")
        groups.append(group)
        return viterbi.viterbi_plain(x)
    monkeypatch.setattr(viterbi, "_viterbi_cuda", k4)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(chip_smoke, "device_ms",
                        lambda torch, fn, reps=20: (fn(), 0.5)[1])
    llr = torch.randn((3, 2 * 50), generator=torch.Generator().manual_seed(5))
    res = chip_smoke.hold_k4(torch, llr, "c3")
    assert res["max_abs_err"] == 0 and res["bound_by"] == "operations"
    assert res["group"] == viterbi.k4_group(3, 132)
    assert set(res["groups"]) == set(viterbi.K4_GROUPS)
    for r in res["groups"].values():
        assert len(r["device_ms_turns"]) == 2 and r["acs_per_s"] > 0
    assert res["device_ms"] == res["groups"][res["group"]]["device_ms"]
    assert len(res["forward_ms_turns"]) == 2
    assert res["traceback_share"] == 0.0
    assert set(viterbi.K4_GROUPS) <= set(groups)
    entry = chip_smoke.kernel_entry("viterbi", {"c3": {"kernels": {
        "viterbi": res}}}, {"c3": {"viterbi": 1}})
    assert entry["launches"] == 1 and entry["max_abs_err"] == 0


def test_hold_windowed_rehearsal(on_host, monkeypatch):
    """K4w's hold: bit-exact against the plain version, the warp body held
    against K4w's bits, both timed in turns with their ACS rates; the two
    entries map to their kernels in the kernels line, and the warp body's
    counted run launches it once."""
    from ofdm_uhd_tpu_torch.kernels import viterbi
    monkeypatch.setattr(viterbi, "_viterbi_windowed_cuda", _counted(
        "viterbi_windowed", viterbi.viterbi_windowed_plain))
    monkeypatch.setattr(viterbi, "_viterbi_windowed_warp_cuda", _counted(
        "viterbi_windowed_warp", viterbi.viterbi_windowed_plain))
    llr = torch.randn((3, 2 * 900), generator=torch.Generator().manual_seed(4))
    res = chip_smoke.hold_windowed(torch, llr, viterbi.FUSED_WINDOW, "c5")
    assert list(res) == ["viterbi_windowed", "viterbi_windowed_warp"]
    for v in res.values():
        assert v["max_abs_err"] == 0 and len(v["device_ms_turns"]) == 2
        assert v["bound_by"] == "operations"
    assert chip_smoke.held_kernel("viterbi_windowed_warp_512") == \
        "viterbi_windowed_warp"
    assert chip_smoke.held_kernel("viterbi_windowed_512") == \
        "viterbi_windowed"
    ab = chip_smoke.run_k4w_ab(torch, llr)
    assert ab["launches"]["viterbi_windowed_warp"] == 1
    by_path = chip_smoke.path_launches({"c5": {"kernels": res,
                                               "launches": ab["launches"]}})
    entry = chip_smoke.kernel_entry("viterbi_windowed_warp",
                                    {"c5": {"kernels": res}}, by_path)
    assert entry["launches"] == 1 and entry["max_abs_err"] == 0


def _patch_rx_path(monkeypatch):
    """The RX path's wrappers on CPU tensors as on the card (on top of
    on_host): each takes its 'kernel', patched to its plain version with
    a launch count, and chip_smoke times one rep."""
    from ofdm_uhd_tpu_torch.kernels import build, localize, scfront, viterbi

    def tile(kernel, flat, nd, l, metric):
        policy.count_launch(kernel)
        return (scfront.sc_frontend_plain(flat, l) if metric
                else sync.sc_correlate_plain(flat, l))
    monkeypatch.setattr(policy, "use_kernel",
                        lambda x: not policy._STATE.forced_plain)
    monkeypatch.setattr(build, "check_inputs", lambda *a: None)
    for mod, name, count, fn in (
            (fft, "_fft_launch", "fft", fft.fft_plain),
            (localize, "_localize_cuda", "localize",
             lambda m, p, c, s, cp, rel: localize.localize_plain(m, p, c, s,
                                                                 cp)),
            (viterbi, "_viterbi_windowed_cuda", "viterbi_windowed",
             viterbi.viterbi_windowed_plain),
            (viterbi, "_viterbi_windowed_warp_cuda", "viterbi_windowed_warp",
             viterbi.viterbi_windowed_plain),
            (sync, "_span_cuda", "sc_span", sync.span_plain),
            (sync, "_stride_cuda", "sc_stride", sync.stride_plain),
            (viterbi, "_viterbi_cuda", "viterbi",
             lambda x, group=None, traceback=True: viterbi.viterbi_plain(x))):
        monkeypatch.setattr(mod, name, _counted(count, fn))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(sync, "_tile_cuda", tile)
    monkeypatch.setattr(chip_smoke, "REPS", 1)


def test_files_phase_rehearsal(on_host, monkeypatch):
    """run_files at a tiny size on the CPU: the tools as subprocesses with
    --device cpu (C3 from an sc16 file bit-exact, C4 tx -> rx, C2
    loopback), cli.rx in process launching the C3 path's (patched)
    kernels and no other, the native deframer used, the golden chain on
    the slice equal to the first slots, the fixtures decoded to their
    pinned payloads and starts; the kernels line counts the launches
    under the `files` path."""
    from ofdm_uhd_tpu_torch.core.spec import config
    _patch_rx_path(monkeypatch)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")   # the tools' subprocesses
    # the in-process decode of 14 slots takes the windowed decoder, as
    # 1032 slots do on the card (the subprocesses keep the fused one)
    monkeypatch.setattr(policy, "_VITERBI_FUSED_MAX_BATCH", 8)
    monkeypatch.setattr(chip_smoke, "FILES_FRAMES", 6)
    monkeypatch.setattr(chip_smoke, "FILES_C4_FRAMES", 2)
    monkeypatch.setattr(chip_smoke, "FILES_C2_FRAMES", 4)
    out = chip_smoke.run_files(torch, config, torch.device("cpu"))
    launches = out["launches"]
    assert "viterbi (windowed)" in out["stages_ms"]
    for k in chip_smoke.FILES_PATH:
        assert launches[k] > 0, k
    assert launches["viterbi"] == 0
    assert all(launches[k] == 0 for k in chip_smoke.OFF_PATH)
    assert out["golden"]["frames"] == 4 and out["golden"]["s"] > 0
    assert out["golden"]["host_cpu"]
    # the path's kernels held on the file's row; their checks' launches
    # come after the counted run
    assert set(out["kernels"]) == {"scfront", "localize", "extract", "fft",
                                   "fft_inverse", "viterbi_windowed_512",
                                   "viterbi_windowed_warp_512"}
    assert out["kernels"]["scfront"]["shape"][0] == 1
    assert all(v["max_abs_err"] <= 1e-5 for v in out["kernels"].values())
    assert policy.launches()["scfront"] > launches["scfront"]
    assert out["startup"]["wall_s"] >= out["startup"]["imports_s"] > 0
    assert out["native"]["library"].startswith(
        os.path.join(REPO, "build", "ofdm_uhd_tpu_torch"))
    by_path = chip_smoke.path_launches({"c3": {"launches": dict(launches)},
                                        "files": out})
    entry = chip_smoke.kernel_entry("fft", {"c3": {"kernels": {
        "fft": {"max_abs_err": 0.0, "ms": 1.0, "plain_ms": 1.0,
                "bound_ms": 1.0, "bound_by": "bytes",
                "library_ms": None}}}, "files": out}, by_path)
    assert entry["launches_by_path"]["files"] == launches["fft"]
    assert entry["launches"] == 2 * launches["fft"]
    assert set(entry["paths"]) == {"c3", "files", "files_inverse"}
    assert entry["ms"] == 1.0                # the first path's check


def test_distributed_phase_rehearsal(on_host, monkeypatch):
    """run_distributed at a tiny size on the CPU: the path's (patched)
    kernels held against their plain versions at one worker's shapes
    (2 of the 4 shards' rows, 2 f2 slots, K10 over 2 shards), then
    chip_smoke.py's own workers (--worker, gloo, --device cpu, the plain
    versions: no launch) and cli.pod_rx as two processes, each giving the
    in-process (1, 4) run's frames; the phase's keys, and its launches
    and holds under the `distributed` path of the kernels line."""
    from ofdm_uhd_tpu_torch.kernels import halo
    from ofdm_uhd_tpu_torch.bench_lib import build_capture
    from ofdm_uhd_tpu_torch.core.spec import config
    from ofdm_uhd_tpu_torch.core.state import StreamState
    from ofdm_uhd_tpu_torch.pipeline import StreamRx
    from ofdm_uhd_tpu_torch.shard import make_mesh
    spec = config("c5").with_(kernel_backend="auto")
    cpu = torch.device("cpu")
    chunk = chip_smoke.C5_SHARDS * 2 * StreamState.halo_len(spec)
    monkeypatch.setattr(chip_smoke, "C5_RESIDENT", (chunk, 2))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cap, pays = build_capture(spec, 6, chip_smoke.GAP, seed=0, snr_db=28.0,
                              cfo=0.8, phase_noise_std=0.0,
                              timing_offset=chip_smoke.C5_OFFSET,
                              device=cpu)
    stacks = chip_smoke.resident_stacks(torch, cap, cpu)
    want = StreamRx(spec, mesh=make_mesh(1, chip_smoke.C5_SHARDS,
                                         ["cpu"] * chip_smoke.C5_SHARDS),
                    chunk_len=chunk, steps_per_dispatch=2,
                    reshard=True).process_device(stacks[0])
    chip_smoke.check_stream("rehearsal", want, pays, spec,
                            chunk // chip_smoke.C5_SHARDS)
    _patch_rx_path(monkeypatch)
    monkeypatch.setattr(halo.HaloExchange, "__call__", lambda self: (
        policy.count_launch("halo"),
        halo.halo_plain(self.ext, self.cb, self.h)))
    res = chip_smoke.run_distributed(torch, spec, cpu, cap, pays, stacks,
                                     want)
    assert set(res) == {"stages_ms", "kernels", "gloo", "launches",
                        "pod_rx", "nccl"}
    assert res["nccl"] == {}
    # one worker's shapes: 2 of the 4 rows, 2 f2 slots of the reshard,
    # K4w at the windows the algorithm takes at f2 (here: 256/64)
    h = StreamState.halo_len(spec)
    cb = chunk // chip_smoke.C5_SHARDS
    mf = cb // spec.frame_len + 2
    f2 = -(-mf // chip_smoke.C5_SHARDS) * chip_smoke.C5_SHARDS
    windowed = policy.viterbi_impl(0, f2, spec.kernel_backend,
                                   spec.viterbi_mode) == "windowed"
    w = 512 if windowed else 256
    held = res["kernels"]
    assert set(held) == {"scfront", "localize", "extract", "fft",
                         "fft_inverse", "halo", f"viterbi_windowed_{w}",
                         f"viterbi_windowed_warp_{w}"}
    assert all(v["max_abs_err"] <= 1e-5 for v in held.values())
    assert held["scfront"]["shape"] == [2, cb + h]
    assert held[f"viterbi_windowed_{w}"]["shape"][0] == 2 * f2
    assert held["halo"]["shape"] == [2, cb + h]
    assert [r["rank"] for r in res["gloo"]] == [0, 1]
    assert all(r["backend"] == "gloo" and r["device"] == "cpu"
               for r in res["gloo"])
    assert set(res["launches"]) == set(policy.KERNELS)
    assert not any(res["launches"].values())   # plain versions on the CPU
    assert res["pod_rx"]["frames"] == len(want)
    by_path = chip_smoke.path_launches({"distributed": res})
    assert by_path["distributed"] == res["launches"]
    entry = chip_smoke.kernel_entry("halo", {"distributed": res}, by_path)
    assert set(entry["paths"]) == {"distributed"}
    assert entry["max_abs_err"] == 0


def test_axes_distributed_phase_rehearsal(on_host, monkeypatch):
    """phase_axes and run_axes_distributed at a tiny size on the CPU:
    8 C3 frames, the (patched) kernels of the frame and stage axes held at
    one worker's shapes, the (2, 2) stream's at one worker's (one of a
    row's 2 shards) and the (2, 4) stream's (two of a row's 4 shards, K10
    between them), then chip_smoke.py's own workers (--worker --steps,
    four processes under gloo, --device cpu, the plain versions: no
    launch), every rank's frame axis, stage axis and both streams equal
    to the in-process runs; the phase's keys, and its launches and holds
    under the `axes_distributed` path of the kernels line. C3's plain
    Viterbi (6912 steps) takes most of a second a call here, so the timed
    runs are one call each and the in-kernel timings none (their
    rehearsals are test_hold_k4_rehearsal's and the other phases')."""
    from ofdm_uhd_tpu_torch.kernels import halo
    from ofdm_uhd_tpu_torch.bench_lib import build_capture
    from ofdm_uhd_tpu_torch.core.spec import config
    from ofdm_uhd_tpu_torch.core.state import StreamState
    from ofdm_uhd_tpu_torch.shard import make_mesh
    spec = config("c5").with_(kernel_backend="auto")
    cpu = torch.device("cpu")
    chunk = 4 * 2 * StreamState.halo_len(spec)
    monkeypatch.setattr(chip_smoke, "C5_RESIDENT", (chunk, 2))
    monkeypatch.setattr(chip_smoke, "AXES_FRAMES", 8)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cap, _ = build_capture(spec, 4, chip_smoke.GAP, seed=0, snr_db=28.0,
                           cfo=0.8, phase_noise_std=0.0,
                           timing_offset=chip_smoke.C5_OFFSET, device=cpu)
    stacks = chip_smoke.resident_stacks(torch, cap, cpu)
    _patch_rx_path(monkeypatch)
    monkeypatch.setattr(halo.HaloExchange, "__call__", lambda self: (
        policy.count_launch("halo"),
        halo.halo_plain(self.ext, self.cb, self.h)))
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda torch, fn, reps=1: (fn(), 0.0)[1])
    monkeypatch.setattr(chip_smoke, "device_ms",
                        lambda torch, fn, reps=20: None)
    axes, batch, outs = chip_smoke.phase_axes(torch, cpu)
    assert set(axes) == {"frames", "rx_aligned_ms", "frame", "stage"}
    assert set(outs) == {"frame", "stage"} and batch.shape[0] == 8
    res = chip_smoke.run_axes_distributed(torch, cpu, batch, outs, stacks)
    assert set(res) == {"kernels", "stream_stages_ms", "gloo", "launches",
                        "nccl"}
    assert res["nccl"] == {}
    held = res["kernels"]
    stream = {"scfront", "localize", "extract", "fft", "fft_inverse"}
    want = {"fft", "fft_inverse", "viterbi"}
    for mesh in ("2x2", "2x4"):
        step = chip_smoke.first_sharded_window(
            torch, spec, make_mesh(1, int(mesh[-1]),
                                   ["cpu"] * int(mesh[-1])),
            stacks[0][0][0])[0]
        f2 = -(-step.mf // step.t) * step.t     # one worker's decode batch
        w = chip_smoke.window_geometry(spec, f2)[0]
        want |= {f"{k}_stream{mesh}" for k in stream | {
            f"viterbi_windowed_{w}", f"viterbi_windowed_warp_{w}"}}
    want.add("halo_stream2x4")                 # two shards a worker
    assert set(held) == want
    assert all(v["max_abs_err"] <= 1e-5 for v in held.values())
    assert held["viterbi"]["shape"][0] == 2    # 8 frames over 4 workers
    assert held["halo_stream2x4"]["shape"][0] == 2
    assert [r["rank"] for r in res["gloo"]] == [0, 1, 2, 3]
    for rep in res["gloo"]:
        assert set(rep["steps"]) == {"frame:4x1", "stage", "stream:2x2",
                                     "stream:2x4"}
        assert rep["steps"]["frame:4x1"]["n_ok_global"] == 8
        assert all(v["max_evm_diff_db"] <= 0.01
                   for v in rep["steps"].values())
    assert not any(res["launches"].values())   # plain versions on the CPU
    by_path = chip_smoke.path_launches({"axes_distributed": res})
    assert by_path["axes_distributed"] == res["launches"]
    entry = chip_smoke.kernel_entry("fft", {"axes_distributed": res},
                                    by_path)
    assert set(entry["paths"]) == {
        "axes_distributed", "axes_distributed_inverse",
        *(f"axes_distributed{inv}_stream{m}" for inv in ("", "_inverse")
          for m in ("2x2", "2x4"))}
    assert chip_smoke.axes_path("stream:2x4", 4)[-1] == "halo"
    assert "halo" not in chip_smoke.axes_path("stream:2x2", 4)


def _trace_file(tmp_path, events):
    (tmp_path / "t.pt.trace.json").write_text(json.dumps(
        {"traceEvents": events}))


def test_check_trace_reads_the_cards_kernels(tmp_path):
    """check_trace on a Chrome trace in torch.profiler's layout: each
    kernel of the path found by its device symbol among the device
    kernels (CPU operators do not count), the busy share the union of
    the device events (kernels, copies, sets) over the span of all timed
    events; a path kernel missing from the trace fails the phase."""
    ev = [{"ph": "X", "cat": "cpu_op", "name": "aten::fft_fft",
           "ts": 0.0, "dur": 100.0},
          {"ph": "X", "cat": "kernel", "name": "void scfront_kernel<5, "
           "true>(float2 const*, float2*, float*, sct::Plan)",
           "ts": 10.0, "dur": 20.0},
          {"ph": "X", "cat": "kernel", "name": "void fft_cp_kernel<8>()",
           "ts": 20.0, "dur": 20.0},           # overlaps the first
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
           "ts": 60.0, "dur": 10.0},
          {"ph": "i", "cat": "cpu_op", "name": "marker", "ts": 500.0}]
    _trace_file(tmp_path, ev)
    res = chip_smoke.check_trace("t", str(tmp_path), ("scfront", "fft"))
    assert res["kernel_events"] == {"scfront": 1, "fft": 1}
    assert res["device_events"] == 3
    assert res["span_ms"] == pytest.approx(0.1)
    assert res["busy_share"] == pytest.approx(0.4)
    with pytest.raises(chip_smoke.SmokeFailure, match="no localize"):
        chip_smoke.check_trace("t", str(tmp_path), ("scfront", "localize"))
    _trace_file(tmp_path, ev[:1])
    with pytest.raises(chip_smoke.SmokeFailure, match="no scfront"):
        chip_smoke.check_trace("t", str(tmp_path), ("scfront",))


def test_check_trace_tells_k4_from_k4w(tmp_path):
    """K4 is found by its own bodies' symbols: a trace that holds only
    K4w's bodies names no viterbi kernel, and each Viterbi kernel counts
    only its own events."""
    def kernel(name, ts):
        return {"ph": "X", "cat": "kernel", "name": f"void {name}(float "
                "const*, uint2*)", "ts": ts, "dur": 1.0}
    windowed = [kernel("viterbi_k7_window_kernel", 0.0),
                kernel("viterbi_k7_windowed_warp_kernel", 2.0)]
    _trace_file(tmp_path, windowed)
    with pytest.raises(chip_smoke.SmokeFailure, match="no viterbi kernel"):
        chip_smoke.check_trace("t", str(tmp_path), ("viterbi",))
    _trace_file(tmp_path, windowed + [
        kernel("viterbi_k7_group_kernel<16>", 4.0),
        kernel("viterbi_k7_butterfly_kernel", 6.0)])
    res = chip_smoke.check_trace("t", str(tmp_path),
                                 ("viterbi", "viterbi_windowed"))
    assert res["kernel_events"] == {"viterbi": 2, "viterbi_windowed": 1}


def test_bench_record_checks_the_count():
    rec = {"mode": "capture", "frames_ok": 8, "frames": 8,
           "frames_per_s": 400.0, "msamples_per_s": 1.0}
    got = chip_smoke.bench_record("c1", "noise\n" + json.dumps(rec), 8)
    assert got["ms_per_dispatch"] == pytest.approx(20.0)
    stream = {"mode": "stream-resident", "frames_ok": 8, "chunk_len": 1000,
              "ksteps": 2, "frames_per_s": 4.0, "msamples_per_s": 0.004}
    got = chip_smoke.bench_record("c5", json.dumps(stream), 8)
    assert got["ms_per_dispatch"] == pytest.approx(500.0)   # 2 s, 4 of them
    with pytest.raises(chip_smoke.SmokeFailure, match="7 frames ok of 8"):
        chip_smoke.bench_record("c1", json.dumps({**rec, "frames_ok": 7}),
                                8)
    with pytest.raises(chip_smoke.SmokeFailure, match="no record"):
        chip_smoke.bench_record("c1", "", 8)


def test_bench_phase_rehearsal(on_host, monkeypatch):
    """run_bench at tiny sizes on the CPU: cli.bench as a subprocess with
    --device cpu, then in process at every other operating point, each
    run launching its path's (patched) kernels and no other and its
    record counting every frame; the traced run's trace read back (a CPU
    trace holds no device kernel: the card's are stood in for beside its
    own events); the path's kernels held at C1's and C2's capture shapes,
    and the aligned run's (fft, viterbi) on its own input;
    the kernels line counts the runs' launches and the holds under the
    `bench` path."""
    _patch_rx_path(monkeypatch)
    monkeypatch.setattr(chip_smoke, "device_ms",
                        lambda torch, fn, reps=20: (fn(), 0.5)[1])
    monkeypatch.setenv("OMP_NUM_THREADS", "2")   # the tool's subprocess
    monkeypatch.setattr(chip_smoke, "BENCH_ITERS", 2)
    monkeypatch.setattr(chip_smoke, "BENCH_FRAMES", 4)
    monkeypatch.setattr(chip_smoke, "BENCH_C3", (2, 3))
    monkeypatch.setattr(chip_smoke, "C5_FRAMES", 4)
    monkeypatch.setattr(chip_smoke, "C5_HOSTFED", (16384, 2))
    monkeypatch.setattr(chip_smoke, "C5_RESIDENT", (16384, 2))
    runs = chip_smoke.bench_runs()
    assert [r[0] for r in runs] == [
        "c1 capture sc16 auto", "c1 capture sc16 xla", "c1 aligned",
        "c2 capture", "c3 capture sc16", "c5 stream sc16",
        "c5 stream resident fc32"]

    # at a few slots 'auto' decodes by the reference's fused decoder:
    # whole sequences (K4) at C1's and C2's trellis lengths, windows (K4w)
    # at C3's
    def tiny():
        return [(label, argv, path if not label.startswith("c3") else tuple(
            "viterbi_windowed" if k == "viterbi" else k for k in path),
            frames) for label, argv, path, frames in runs]
    monkeypatch.setattr(chip_smoke, "bench_runs", tiny)
    real_read = chip_smoke.read_trace
    cpu_traces = []

    def read(trace_dir):
        dev, span = real_read(trace_dir)
        cpu_traces.append((dev, span))
        return dev + [("kernel", f"void {s}<1>()", 0.0, span / 4)
                      for syms in chip_smoke.TRACE_SYMBOLS.values()
                      for s in syms], span
    monkeypatch.setattr(chip_smoke, "read_trace", read)
    res = chip_smoke.run_bench(torch, torch.device("cpu"))

    assert cpu_traces[0][0] == [] and cpu_traces[0][1] > 0
    assert res["subprocess"]["c1 capture sc16 auto"]["record"][
        "frames_ok"] == 4
    assert list(res["runs"]) == [r[0] for r in runs[1:]]
    for label, argv, path, frames in tiny()[1:]:
        r = res["runs"][label]
        assert r["record"]["frames_ok"] == frames
        assert r["ms_per_dispatch"] > 0
        for k, n in r["launches"].items():
            assert (n > 0) == (k in path), (label, k)
    assert res["runs"]["c1 capture sc16 xla"]["record"]["backend"] == "xla"
    assert res["runs"]["c5 stream resident fc32"]["record"]["mode"] == \
        "stream-resident"
    assert res["traced"]["record"]["frames_ok"] == 4
    assert res["traced"]["trace"]["busy_share"] == pytest.approx(0.25)
    held = res["kernels"]
    for name in ("c1", "c2"):
        for k in ("scfront", "localize", "extract", "fft", "fft_inverse",
                  "viterbi"):
            assert held[f"{k}_{name}"]["max_abs_err"] <= 1e-5, (k, name)
    assert held["scfront_c1"]["shape"][0] == 1
    # the aligned run's kernels on its own input: 4 back-to-back frames
    for k in ("fft", "fft_inverse", "viterbi"):
        assert held[f"{k}_c1_aligned"]["max_abs_err"] <= 1e-5, k
    assert held["viterbi_c1_aligned"]["shape"][0] == 4
    assert not any(k.startswith(("scfront", "localize", "extract"))
                   and k.endswith("aligned") for k in held)
    want = {k: sum(r["launches"][k] for r in res["runs"].values())
            + res["traced"]["launches"][k] for k in policy.KERNELS}
    by_path = chip_smoke.path_launches({"bench": res})
    assert by_path["bench"] == res["launches"] == want
    entry = chip_smoke.kernel_entry("scfront", {"bench": res}, by_path)
    assert set(entry["paths"]) == {"bench_c1", "bench_c2"}
    assert entry["launches"] == want["scfront"] > 0
    for name in ("fft", "viterbi"):
        entry = chip_smoke.kernel_entry(name, {"bench": res}, by_path)
        assert "bench_c1_aligned" in entry["paths"], name


@pytest.mark.parametrize("point", ["resident", "hostfed"])
def test_stream_run_rehearsal(on_host, monkeypatch, point):
    """phase_stream_run at a tiny C5 point on the CPU (resident fc32
    stacks through process_device; host-fed sc16 through process +
    flush): the main run launching the path's (patched) kernels and no
    other, REPS_STREAM timed runs by fresh receivers, then REPS_STREAM by
    the last of them carried on, each counting every frame, and the
    plain-forced run's frames equal to the main run's."""
    from ofdm_uhd_tpu_torch.bench_lib import build_capture, to_sc16
    from ofdm_uhd_tpu_torch.core.spec import config
    from ofdm_uhd_tpu_torch.pipeline import StreamRx
    _patch_rx_path(monkeypatch)
    spec = config("c5").with_(kernel_backend="auto")
    cpu = torch.device("cpu")
    chunk, k = 16384, 2
    per = chunk * k
    monkeypatch.setattr(chip_smoke, "C5_RESIDENT", (chunk, k))
    cap, pays = build_capture(spec, 4, chip_smoke.GAP, seed=0, snr_db=28.0,
                              cfo=0.8, phase_noise_std=0.0,
                              timing_offset=chip_smoke.C5_OFFSET,
                              device=cpu)
    if point == "resident":
        feed = chip_smoke.resident_stacks(torch, cap, cpu)
        n_disp = len(feed[0])
        fmt, samples = "fc32", n_disp * per

        def run(rx, st):
            return rx.process_device(st)
    else:
        iq = to_sc16(cap[None])[:, 0]
        f = np.zeros((2, -(-iq.shape[1] // per) * per), np.int16)
        f[:, :iq.shape[1]] = iq
        feed = (f, f ^ 1)
        fmt, samples = "sc16", f.shape[1] + chunk
        n_disp = f.shape[1] // per + 1            # + the flush

        def run(rx, f):
            return rx.process(f) + rx.flush()
    res, frames = chip_smoke.phase_stream_run(
        torch, spec, "t", lambda: StreamRx(spec, chunk_len=chunk,
                                           steps_per_dispatch=k,
                                           input_format=fmt, device=cpu),
        feed, run, pays, samples, n_disp)
    assert res["frames_ok"] == 4 and len(frames) >= 4
    for key in ("run_s", "device_s", "carried_run_s"):
        assert len(res[key]) == chip_smoke.REPS_STREAM, key
    assert res["carried_msps"] > 0 and res["msps"] > 0
    for name, n in res["launches"].items():
        assert (n > 0) == (name in chip_smoke.C5_PATH), name


def test_harness_phase_rehearsal(on_host, monkeypatch):
    """run_harness at tiny sizes on the CPU: the CPU runs as `python -m`
    subprocesses, stages and roofline as subprocesses too, every harness
    in process on the (patched) kernels, launching its path's kernels and
    no other; the in-process records equal the subprocesses' (the card's
    against the CPU's); the kernels line counts the runs' launches under
    the `harness` path. Then same_records refuses a record that differs
    in a count, an FER, a pre-FEC count beyond its tolerance or an EVM
    beyond 0.01 dB."""
    _patch_rx_path(monkeypatch)

    def cp(kernel, x, n, start, cp, inverse):
        policy.count_launch(kernel)
        return (fft.ifft_cp_plain(x, cp) if inverse
                else fft.cp_strip_fft_plain(x, start, n))
    monkeypatch.setattr(fft, "_fft_cp_cuda", cp)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(chip_smoke, "C3_FRAMES", 3)
    monkeypatch.setattr(chip_smoke, "N_CAPS", 2)
    monkeypatch.setattr(chip_smoke, "HARNESS_STAGES_CONFIG", "c1")
    path = ("scfront", "localize", "extract", "fft", "viterbi")
    tiny = {
        "stages pallas": (("--config", "c2", "--backend", "pallas",
                           "--frames", "4", "--batch", "2", "--iters", "1"),
                          ("sccorr", "localize", "extract", "cpfft",
                           "ifftcp", "viterbi", "viterbi_windowed")),
        "sweeps": (("--config", "c1", "--snrs", "4,10", "--frames", "3"),
                   ("fft", "viterbi")),
        "sweeps multipath": (("--config", "c2", "--snrs", "10", "--frames",
                              "2", "--multipath", "c2"),
                             ("fft", "viterbi")),
        "detect_sweep": (("--config", "c1", "--snrs", "5", "--trials", "1",
                          "--frames", "2"), path),
        "evm_budget": (("--config", "c1", "--frames", "3"), path),
        "pod": (("--config", "c1", "--frames", "3", "--iters", "1"), path),
        "pp_ab": (("--batch", "8", "--iters", "1"), ("fft", "viterbi")),
    }
    monkeypatch.setattr(chip_smoke, "harness_runs", lambda: tiny)
    res = chip_smoke.run_harness(torch, torch.device("cpu"))

    rec = res["stages"]
    assert set(rec) == chip_smoke.STAGES_KEYS
    assert rec["frames_ok"] == {"full": 3, "full-x2": 6}
    assert "llr+evm" in rec["steps_ms"] and "scfront" in rec["steps_ms"]
    assert "cross-check" in res["roofline"]
    assert list(res["runs"]) == list(tiny)
    assert res["runs"]["stages pallas"]["records"][0]["frames_ok"] == {
        "full": 4, "full-x2": 8}
    for label, (_, want) in tiny.items():
        r = res["runs"][label]
        assert r["records"], label
        for k, n in r["launches"].items():
            assert (n > 0) == (k in want), (label, k)
    for label in ("sweeps", "sweeps multipath", "detect_sweep",
                  "evm_budget"):
        assert res["runs"][label]["worst"] == {"pre_fec_bits": 0,
                                               "evm_db": 0.0}, label
    assert [r["rescued"] for r in res["runs"]["detect_sweep"]["records"]
            ] == [None, 0]
    assert all(r["frames_ok"] == 3 for r in res["runs"]["pod"]["records"])
    assert all(r["bit_exact"] for r in res["runs"]["pp_ab"]["records"])
    by_path = chip_smoke.path_launches({"harness": res})
    want = {k: sum(r["launches"][k] for r in res["runs"].values())
            for k in policy.KERNELS}
    assert by_path["harness"] == res["launches"] == want
    entry = chip_smoke.kernel_entry("fft", {"harness": res, "bench": {
        "kernels": {"fft": {"max_abs_err": 0.0, "ms": 1.0, "plain_ms": 1.0,
                            "bound_ms": 1.0, "bound_by": "bytes",
                            "library_ms": None}},
        "launches": dict.fromkeys(policy.KERNELS, 0)}}, by_path)
    assert entry["launches_by_path"]["harness"] == want["fft"] > 0

    sweep = res["runs"]["sweeps"]["records"]
    chip_smoke.same_records("sweeps", sweep, sweep)
    for bad, what in (({"post_fec_fer": sweep[0]["post_fec_fer"] + 0.5},
                       "post_fec_fer"),
                      ({"frames": sweep[0]["frames"] + 1}, "frames"),
                      ({"evm_db": sweep[0]["evm_db"] + 0.02}, "EVM"),
                      ({"pre_fec_ber": sweep[0]["pre_fec_ber"]
                        + 5 / (3 * 1152)}, "pre-FEC")):
        with pytest.raises(chip_smoke.SmokeFailure, match=what):
            chip_smoke.same_records("sweeps", [{**sweep[0], **bad}],
                                    sweep[:1])
    det = res["runs"]["detect_sweep"]["records"]
    with pytest.raises(chip_smoke.SmokeFailure, match="rescued"):
        chip_smoke.same_records("detect_sweep", [{**det[1], "rescued": 1}],
                                det[1:])
    evm = res["runs"]["evm_budget"]["records"]
    with pytest.raises(chip_smoke.SmokeFailure, match="EVM"):
        chip_smoke.same_records("evm_budget", [{**evm[0], "evm_db": {
            **evm[0]["evm_db"], "est-H": evm[0]["evm_db"]["est-H"] + 0.05}}],
            evm)


def test_harness_phase_is_wired_into_main():
    """main() runs the harness phase on the card and counts its launches
    under the `harness` path of the kernels line."""
    import inspect
    src = inspect.getsource(chip_smoke.main)
    assert "harness = run_harness(torch, device)" in src
    assert '"harness": harness' in src
