"""The kernel_backend='pallas' slice, port against reference, at a small
size: the route of the repository's bench.py variant `pallas-sc16` (C3)
and of the reference CLI's `--backend pallas` at C2.

Under 'pallas' the reference's frame layer takes its fused CP-strip FFT
and IFFT + CP kernels (K5), and its detection the boxcar correlator K9
where the fused front end does not apply (l = n_sc / 2 not a multiple of
128: C1 and C2); its Pallas kernels run here in interpret mode. The port
takes the same formulations (kernels/policy.choose), on the CPU through
their plain versions.

Exact: `d`, `valid`, `crc_ok`, `det_sat` and payloads on every slot (the
empty ones decode garbage, and only the reference's decoding algorithm
gives its bits there). Tolerances, float32 rounding of two summation
orders (the reference's matmul sums against torch.fft and pairwise
doubling): `eps` within 1e-5 subcarrier spacings, EVM within 0.01 dB,
samples within 1e-5 of the largest, equalized symbols within 1e-3.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from bench_lib import build_capture as ref_build_capture  # noqa: E402
from ofdm_uhd_tpu.channel import apply_channel  # noqa: E402
from ofdm_uhd_tpu.core.spec import ChannelSpec  # noqa: E402
from ofdm_uhd_tpu.core.spec import config as ref_config  # noqa: E402
from ofdm_uhd_tpu.kernels import policy as ref_policy  # noqa: E402
from ofdm_uhd_tpu.pipeline import RxPipeline as RefRx  # noqa: E402
from ofdm_uhd_tpu.pipeline import TxPipeline as RefTx  # noqa: E402
from ofdm_uhd_tpu_torch.bench_lib import to_sc16  # noqa: E402
from ofdm_uhd_tpu_torch.convert import spec_from_reference  # noqa: E402
from ofdm_uhd_tpu_torch.kernels import policy  # noqa: E402
from ofdm_uhd_tpu_torch.pipeline import RxPipeline, TxPipeline  # noqa: E402

torch.set_num_threads(2)

N_CAPS, N_FRAMES, GAP, MAX_FRAMES = 2, 3, 300, 5

KERNEL_NAMES = ("fft", "cpfft", "ifftcp", "fir", "interp", "decim",
                "sc_corr", "sc_front", "viterbi", "extract", "localize")
SIZES = (8, 32, 64, 128, 193, 256, 512, 1024, 1152, 6912)
BATCHES = (None, 10, 96, 97, 130, 2048, 2049, 4160)


def _port_spec(rspec):
    return spec_from_reference(dataclasses.asdict(rspec))


@pytest.mark.parametrize("requested", ["xla", "pallas", "auto"])
def test_choose_matches_reference(requested):
    for kernel in KERNEL_NAMES:
        for size in SIZES:
            for n in BATCHES:
                assert policy.choose(kernel, size, requested, n) == \
                    ref_policy.choose(kernel, size, requested, n), (
                        kernel, size, n)


@pytest.fixture(scope="module", params=["c2", "c3"])
def ref(request):
    """The reference under 'pallas': captures (seeds 0, 1) and its RX of
    their sc16 planes."""
    rspec = ref_config(request.param).with_(kernel_backend="pallas")
    built = [ref_build_capture(rspec, N_FRAMES, GAP, seed=s)
             for s in range(N_CAPS)]
    caps = np.stack([c for c, _ in built])
    pays = np.stack([p for _, p in built])
    iq = to_sc16(caps)
    out = RefRx(rspec, diag=True).rx_capture_sc16(iq, max_frames=MAX_FRAMES)
    return {"spec": rspec, "pays": pays, "iq": iq,
            "out": {k: np.asarray(v) for k, v in out.items()}}


@pytest.fixture(scope="module")
def port(ref):
    spec = _port_spec(ref["spec"])
    assert spec.kernel_backend == "pallas"
    policy.reset_launches()
    out = RxPipeline(spec, diag=True).rx_capture_sc16(
        torch.from_numpy(ref["iq"]), max_frames=MAX_FRAMES)
    return {"spec": spec, "out": {k: v.numpy() for k, v in out.items()},
            "launches": policy.launches()}


def test_pallas_tx_matches_reference(ref):
    """The port's TxPipeline under 'pallas' (K5's IFFT + CP) against the
    reference's (ifft_cp_pallas) on the sent payloads."""
    spec = _port_spec(ref["spec"])
    pays = ref["pays"][0]
    got = TxPipeline(spec)(torch.from_numpy(pays)).numpy()
    want = np.asarray(RefTx(ref["spec"])(pays))
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


def test_pallas_slice_keys_and_shapes(ref, port):
    assert set(port["out"]) == set(ref["out"])
    for k, v in ref["out"].items():
        assert port["out"][k].shape == v.shape, k
        assert port["out"][k].dtype == v.dtype, k


def test_pallas_slice_detection_exact(ref, port):
    for k in ("crc_ok", "valid", "d", "det_sat"):
        np.testing.assert_array_equal(port["out"][k], ref["out"][k], err_msg=k)
    np.testing.assert_allclose(port["out"]["eps"], ref["out"]["eps"],
                               atol=1e-5)


def test_pallas_slice_payload_and_evm(ref, port):
    valid = ref["out"]["valid"]
    assert valid.sum() == N_CAPS * N_FRAMES
    np.testing.assert_array_equal(port["out"]["payload"],
                                  ref["out"]["payload"])
    np.testing.assert_array_equal(port["out"]["payload"][:, :N_FRAMES],
                                  ref["pays"])
    assert port["out"]["crc_ok"][:, :N_FRAMES].all()
    np.testing.assert_allclose(port["out"]["evm_db"][valid],
                               ref["out"]["evm_db"][valid], atol=0.01)


def test_pallas_slice_on_cpu_launches_no_kernel(port):
    assert port["launches"] == dict.fromkeys(policy.KERNELS, 0)


@pytest.mark.parametrize("name", ["c1", "c2"])
def test_pallas_rx_aligned_matches_reference(name):
    """rx_aligned under 'pallas' on frames through a two-tap channel at
    22 dB, the reference's own backend-equality case
    (tests/kernels/test_backend_equality.py)."""
    rspec = ref_config(name).with_(kernel_backend="pallas")
    spec = _port_spec(rspec)
    rng = np.random.default_rng(11)
    pays = rng.integers(0, 2, (6, spec.payload_bits_per_frame)).astype(
        np.uint8)
    frames = np.asarray(RefTx(rspec)(pays))
    ch = ChannelSpec(snr_db=22.0, multipath_taps=(1.0, 0.35 - 0.15j))
    rx_in = np.stack([apply_channel(frames[i], ch, spec.n_sc, seed=i)
                      for i in range(len(pays))]).astype(np.complex64)
    want = RefRx(rspec, shift=4).rx_aligned(rx_in)
    got = RxPipeline(spec, shift=4).rx_aligned(torch.from_numpy(rx_in))
    for k in ("payload", "crc_ok"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert got["crc_ok"].all()
    np.testing.assert_array_equal(got["payload"].numpy(), pays)
    np.testing.assert_allclose(got["evm_db"].numpy(),
                               np.asarray(want["evm_db"]), atol=0.01)
    np.testing.assert_allclose(got["data_syms"].numpy(),
                               np.asarray(want["data_syms"]), atol=1e-3)
