"""The C3 capture-mode RX slice, port against reference, at a small size:
2 captures x 3 frames through `rx_capture_sc16` on identical sc16 input.

The reference runs `config("c3").with_(kernel_backend="auto")` (the
variant the repository's bench.py judges), so its localize, extract,
FFT-256 and Viterbi stages are the Pallas kernels in interpret mode. At
C * max_frames = 10 <= 96 its decoder is the fused Pallas Viterbi, which
decodes the 6912-step trellis in windows of 256; the port takes the same
algorithm, so payloads are compared on every slot, the empty ones (which
decode garbage) included.
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
from ofdm_uhd_tpu.phy import tables as ref_tables  # noqa: E402
from ofdm_uhd_tpu.pipeline import RxPipeline as RefRx  # noqa: E402
from ofdm_uhd_tpu_torch.bench_lib import build_capture, to_sc16  # noqa: E402
from ofdm_uhd_tpu_torch.convert import spec_from_reference  # noqa: E402
from ofdm_uhd_tpu_torch.core.spec import config  # noqa: E402
from ofdm_uhd_tpu_torch.kernels import policy  # noqa: E402
from ofdm_uhd_tpu_torch.phy import agc, sync  # noqa: E402
from ofdm_uhd_tpu_torch.phy import tables  # noqa: E402
from ofdm_uhd_tpu_torch.pipeline import RxPipeline, TxPipeline  # noqa: E402
from ofdm_uhd_tpu_torch.pipeline.rx import _sc16_to_complex  # noqa: E402

torch.set_num_threads(2)

N_CAPS, N_FRAMES, GAP, MAX_FRAMES = 2, 3, 300, 5


@pytest.fixture(scope="module")
def ref():
    """The reference's captures, sc16 planes and RX result (one run)."""
    rspec = ref_config("c3").with_(kernel_backend="auto")
    built = [ref_build_capture(rspec, N_FRAMES, GAP, seed=s)
             for s in range(N_CAPS)]
    caps = np.stack([c for c, _ in built])
    pays = np.stack([p for _, p in built])
    iq = to_sc16(caps)
    out = RefRx(rspec, diag=True).rx_capture_sc16(iq, max_frames=MAX_FRAMES)
    return {"spec": rspec, "caps": caps, "pays": pays, "iq": iq,
            "out": {k: np.asarray(v) for k, v in out.items()}}


@pytest.fixture(scope="module")
def port(ref):
    spec = spec_from_reference(dataclasses.asdict(ref["spec"]))
    policy.reset_launches()
    out = RxPipeline(spec, diag=True).rx_capture_sc16(
        torch.from_numpy(ref["iq"]), max_frames=MAX_FRAMES)
    return {"spec": spec, "out": {k: v.numpy() for k, v in out.items()},
            "launches": policy.launches()}


def test_build_capture_matches(ref):
    for seed in range(N_CAPS):
        cap, pay = build_capture(config("c3"), N_FRAMES, GAP, seed=seed,
                                 device="cpu")
        np.testing.assert_array_equal(pay, ref["pays"][seed])
        r = ref["caps"][seed]
        assert cap.dtype == np.complex64 and cap.shape == r.shape
        assert np.max(np.abs(cap - r)) <= 1e-5 * np.max(np.abs(r))


def test_slice_keys_and_shapes(ref, port):
    assert set(port["out"]) == set(ref["out"])
    for k, v in ref["out"].items():
        assert port["out"][k].shape == v.shape, k
        assert port["out"][k].dtype == v.dtype, k


def test_slice_detection_exact(ref, port):
    for k in ("crc_ok", "valid", "d", "det_sat"):
        np.testing.assert_array_equal(port["out"][k], ref["out"][k], err_msg=k)
    np.testing.assert_allclose(port["out"]["eps"], ref["out"]["eps"],
                               atol=1e-5)


def test_slice_payload_and_evm(ref, port):
    valid = ref["out"]["valid"]
    assert valid.sum() == N_CAPS * N_FRAMES
    np.testing.assert_array_equal(port["out"]["payload"],
                                  ref["out"]["payload"])
    np.testing.assert_array_equal(port["out"]["payload"][:, :N_FRAMES],
                                  ref["pays"])
    assert port["out"]["crc_ok"][:, :N_FRAMES].all()
    np.testing.assert_allclose(port["out"]["evm_db"][valid],
                               ref["out"]["evm_db"][valid], atol=0.01)


def test_slice_on_cpu_launches_no_kernel(port):
    assert port["launches"] == dict.fromkeys(policy.KERNELS, 0)


def test_detect_frames_exact(ref, port):
    spec = port["spec"]
    cap = _sc16_to_complex(torch.from_numpy(ref["iq"]))
    cap, _ = agc.agc_normalize(cap)
    ds, eps, valid, sat = sync.detect_frames(spec, cap, MAX_FRAMES)
    for c in range(N_CAPS):
        r = ref_sync.detect_frames(ref["spec"], jnp.asarray(cap[c].numpy()),
                                   MAX_FRAMES, with_sat=True)
        np.testing.assert_array_equal(ds[c].numpy(), np.asarray(r[0]))
        np.testing.assert_array_equal(valid[c].numpy(), np.asarray(r[2]))
        assert bool(sat[c]) == bool(r[3])


def test_crc_matrix_c3_equal(ref):
    # the reference built this 6874-bit matrix for the run above
    n = ref["spec"].payload_bits_per_frame
    m_ref, c_ref = ref_tables.crc_matrix(n)
    m, c = tables.crc_matrix(n)
    np.testing.assert_array_equal(m, m_ref)
    np.testing.assert_array_equal(c, c_ref)


def test_rx_capture_single_and_aligned(ref, port):
    spec = port["spec"]
    rx = RxPipeline(spec, diag=False)
    one = rx.rx_capture(_sc16_to_complex(torch.from_numpy(ref["iq"][:, 1])),
                        MAX_FRAMES)
    np.testing.assert_array_equal(one["payload"].numpy(),
                                  port["out"]["payload"][1])
    np.testing.assert_array_equal(one["d"].numpy(), port["out"]["d"][1])
    assert "det_sat" not in one
    frames = TxPipeline(spec)(torch.from_numpy(ref["pays"][0]))
    out = rx.rx_aligned(frames)
    assert out["crc_ok"].all()
    np.testing.assert_array_equal(out["payload"].numpy(), ref["pays"][0])
