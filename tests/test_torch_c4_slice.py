"""The C4 resampled capture chain, port against reference, at reduced depth:
2 captures x 3 frames through `rx_capture` on identical fc32 input.

C4 is 1024 subcarriers, CP 128, QAM-16, 8x polyphase resampling with the
193-tap prototype. Only the depth is cut (`n_data_syms=2`): every width
stays, and the reference builds its O(n^2) CRC matrix for 3034 payload
bits instead of 18,394. The reference runs `kernel_backend="auto"`, so its
TX interpolation, frame extraction, localization and (at C * max_frames =
10) Viterbi are Pallas kernels in interpret mode; its decimation and the
FFT-1024 are the XLA forms. The port decodes with the reference's
algorithm (windows of 256), so payloads match on every slot. The
captures carry the CFO at the radio rate, 0.8 / 8 subcarrier spacings,
as the reference bench builds them.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from bench_lib import build_capture as ref_build_capture  # noqa: E402
from ofdm_uhd_tpu.core.spec import config as ref_config  # noqa: E402
from ofdm_uhd_tpu.phy import sync as ref_sync  # noqa: E402
from ofdm_uhd_tpu.pipeline import RxPipeline as RefRx  # noqa: E402
from ofdm_uhd_tpu.pipeline import TxPipeline as RefTx  # noqa: E402
from ofdm_uhd_tpu_torch.bench_lib import build_capture, to_sc16  # noqa: E402
from ofdm_uhd_tpu_torch.convert import spec_from_reference  # noqa: E402
from ofdm_uhd_tpu_torch.core.spec import config  # noqa: E402
from ofdm_uhd_tpu_torch.kernels import policy  # noqa: E402
from ofdm_uhd_tpu_torch.phy import agc, sync  # noqa: E402
from ofdm_uhd_tpu_torch.pipeline import RxPipeline, TxPipeline  # noqa: E402
from ofdm_uhd_tpu_torch.pipeline import rx as port_rx  # noqa: E402

torch.set_num_threads(2)

N_CAPS, N_FRAMES, GAP, MAX_FRAMES = 2, 3, 300, 5
CFO = 0.8 / 8            # baseband CFO 0.8, carried at the radio rate


def _np(out: dict) -> dict:
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def ref():
    """The reference's captures and RX results (fc32 and sc16)."""
    rspec = ref_config("c4").with_(n_data_syms=2, kernel_backend="auto")
    built = [ref_build_capture(rspec, N_FRAMES, GAP, seed=s, cfo=CFO,
                               phase_noise_std=0.0) for s in range(N_CAPS)]
    caps = np.stack([c for c, _ in built])
    pays = np.stack([p for _, p in built])
    rx = RefRx(rspec, diag=True)
    return {"spec": rspec, "caps": caps, "pays": pays,
            "out": _np(rx.rx_capture(caps, max_frames=MAX_FRAMES)),
            "sc16": _np(rx.rx_capture_sc16(to_sc16(caps),
                                           max_frames=MAX_FRAMES))}


@pytest.fixture(scope="module")
def port(ref):
    spec = spec_from_reference(dataclasses.asdict(ref["spec"]))
    policy.reset_launches()
    out = RxPipeline(spec, diag=True).rx_capture(
        torch.from_numpy(ref["caps"]), max_frames=MAX_FRAMES)
    return {"spec": spec, "out": {k: v.numpy() for k, v in out.items()},
            "launches": policy.launches()}


def _same_result(got: dict, want: dict, pays: np.ndarray) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
    for k in ("d", "valid", "crc_ok", "det_sat"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["eps"], want["eps"], atol=1e-5)
    valid = want["valid"]
    assert valid.sum() == N_CAPS * N_FRAMES
    np.testing.assert_array_equal(got["payload"], want["payload"])
    np.testing.assert_array_equal(got["payload"][:, :N_FRAMES], pays)
    assert got["crc_ok"][:, :N_FRAMES].all()
    np.testing.assert_allclose(got["evm_db"][valid], want["evm_db"][valid],
                               atol=0.01)


def test_c4_slice_matches_reference(ref, port):
    _same_result(port["out"], ref["out"], ref["pays"])


def test_c4_sc16_entry_matches_reference(ref, port):
    got = RxPipeline(port["spec"], diag=True).rx_capture_sc16(
        torch.from_numpy(to_sc16(ref["caps"])), max_frames=MAX_FRAMES)
    _same_result({k: v.numpy() for k, v in got.items()}, ref["sc16"],
                 ref["pays"])


def test_c4_slice_on_cpu_launches_no_kernel(port):
    assert port["launches"] == dict.fromkeys(policy.KERNELS, 0)


def test_c4_build_capture_matches(ref):
    for seed in range(N_CAPS):
        cap, pay = build_capture(config("c4").with_(n_data_syms=2), N_FRAMES,
                                 GAP, seed=seed, cfo=CFO, phase_noise_std=0.0,
                                 device="cpu")
        np.testing.assert_array_equal(pay, ref["pays"][seed])
        r = ref["caps"][seed]
        assert cap.dtype == np.complex64 and cap.shape == r.shape
        assert np.max(np.abs(cap - r)) <= 1e-5 * np.max(np.abs(r))


def test_c4_detect_frames_exact(ref, port):
    """Detection at l = 512 on the decimated, AGC'd captures, capture by
    capture against the reference's detect_frames."""
    spec = port["spec"]
    cap = port_rx._capture_to_baseband(spec, torch.from_numpy(ref["caps"]))
    assert cap.shape[-1] == -(-ref["caps"].shape[-1] // 8)
    cap, _ = agc.agc_normalize(cap)
    ds, eps, valid, sat = sync.detect_frames(spec, cap, MAX_FRAMES)
    for c in range(N_CAPS):
        r = ref_sync.detect_frames(ref["spec"], jnp.asarray(cap[c].numpy()),
                                   MAX_FRAMES, with_sat=True)
        np.testing.assert_array_equal(ds[c].numpy(), np.asarray(r[0]))
        np.testing.assert_array_equal(valid[c].numpy(), np.asarray(r[2]))
        np.testing.assert_allclose(eps[c].numpy(), np.asarray(r[1]),
                                   atol=1e-5)
        assert bool(sat[c]) == bool(r[3])


def test_c4_capture_padded_to_multiple_of_l(ref, port):
    """A capture whose length is not a multiple of L is zero-padded before
    decimation, as the reference pads it."""
    caps = np.ascontiguousarray(ref["caps"][:, :-3])
    want = _np(RefRx(ref["spec"], diag=False).rx_capture(
        caps[1], max_frames=MAX_FRAMES))
    got = RxPipeline(port["spec"], diag=False).rx_capture(
        torch.from_numpy(caps[1]), max_frames=MAX_FRAMES)
    for k in ("d", "valid", "crc_ok", "payload"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_c4_tx_frames_close(ref, port):
    pays = torch.from_numpy(ref["pays"][0])
    got = TxPipeline(port["spec"])(pays).numpy()
    want = np.asarray(RefTx(ref["spec"])(ref["pays"][0]))
    assert got.shape == want.shape == (N_FRAMES,
                                       port["spec"].frame_len_radio)
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


def test_c4_rx_aligned_exact(ref, port):
    frames = np.asarray(RefTx(ref["spec"])(ref["pays"][1]))
    want = _np(RefRx(ref["spec"], diag=False).rx_aligned(frames))
    got = RxPipeline(port["spec"], diag=False).rx_aligned(
        torch.from_numpy(frames.copy()))
    for k in ("payload", "crc_ok"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    np.testing.assert_array_equal(got["payload"].numpy(), ref["pays"][1])
    np.testing.assert_allclose(got["evm_db"].numpy(), want["evm_db"],
                               atol=0.01)


def test_c4_sync_threshold_mode(ref, port):
    """The reference's sync_threshold_mode keyword: 'fixed' gives the
    default's results; 'cfar' on the C4 captures gives the reference's
    'cfar' results (d, valid, crc_ok and payloads exactly)."""
    got = RxPipeline(port["spec"], diag=True,
                     sync_threshold_mode="fixed").rx_capture(
        torch.from_numpy(ref["caps"]), max_frames=MAX_FRAMES)
    assert set(got) == set(port["out"])
    for k, v in port["out"].items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    want = _np(RefRx(ref["spec"], diag=True, sync_threshold_mode="cfar")
               .rx_capture(ref["caps"], max_frames=MAX_FRAMES))
    got = RxPipeline(port["spec"], diag=True,
                     sync_threshold_mode="cfar").rx_capture(
        torch.from_numpy(ref["caps"]), max_frames=MAX_FRAMES)
    _same_result({k: v.numpy() for k, v in got.items()}, want, ref["pays"])


def test_c4_integer_cfo_exact(ref, port):
    """The integer-CFO search at 1024 subcarriers finds the shifts the
    reference finds, on baseband C4 frames."""
    spec = port["spec"]
    frames = TxPipeline(spec).baseband(torch.from_numpy(ref["pays"][0]))
    shifts = np.array([0.0, 3.0, -2.0], np.float32)
    n = np.arange(spec.frame_len)
    rot = np.exp(2j * np.pi * shifts[:, None] * n / spec.n_sc)
    frames = (frames.numpy() * rot).astype(np.complex64)
    k = sync.integer_cfo(spec, torch.from_numpy(frames))
    k_ref = ref_sync.integer_cfo(ref["spec"], jnp.asarray(frames))
    np.testing.assert_array_equal(k.numpy(), np.asarray(k_ref))
    np.testing.assert_array_equal(k.numpy(), shifts)
