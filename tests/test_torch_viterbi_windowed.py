"""The port decodes with the reference's Viterbi algorithm, and its windowed
decoder equals the reference's windowed decoders bit for bit.

The reference chooses among three algorithms from the spec and the decode
batch (ofdm_uhd_tpu/kernels/policy.py:viterbi_impl): the whole-sequence
scan, the XLA windowed decoder (windows of 512, overlap 96) and the fused
Pallas decoder (whole sequence below a gate, else windows of 256, overlap
64). On inputs whose survivor paths do not merge, here pure noise and
codewords at -3 dB, the windowed decoders differ from the scan, so only
the same algorithm gives the same bits. Every bit of every row is
compared; the Pallas kernels run in interpret mode. Last, the CUDA
kernel's per-window body (one thread a window), compiled for the host,
against the plain windowed decoder.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_uhd_tpu.core.spec import config as ref_config
from ofdm_uhd_tpu.kernels import pallas_viterbi as ref_pv
from ofdm_uhd_tpu.phy import bits as ref_bits
from ofdm_uhd_tpu.pipeline import rx as ref_rx
from ofdm_uhd_tpu_torch.convert import spec_from_reference
from ofdm_uhd_tpu_torch.kernels import policy
from ofdm_uhd_tpu_torch.kernels import viterbi as KV
from ofdm_uhd_tpu_torch.phy import bits
from ofdm_uhd_tpu_torch.pipeline import rx as port_rx

torch.set_num_threads(2)

ROWS = 10


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _llrs(n: int, rows: int, seed: int) -> np.ndarray:
    """[rows, 2n] float32: the first half pure noise, the second half
    tail-terminated codewords through BPSK + AWGN at -3 dB."""
    rng = np.random.default_rng(seed)
    noise = rng.normal(scale=4.0, size=(rows - rows // 2, 2 * n))
    info = rng.integers(0, 2, (rows // 2, n)).astype(np.uint8)
    info[:, -6:] = 0
    coded = bits.conv_encode(_t(info)).numpy()
    sigma = 10 ** (3.0 / 20)
    y = (1.0 - 2.0 * coded) + sigma * rng.normal(size=coded.shape)
    return np.concatenate([noise, 2 * y / sigma**2]).astype(np.float32)


def _different_rows(a, b) -> int:
    return int(np.any(np.asarray(a) != np.asarray(b), axis=-1).sum())


# (kernel_backend, viterbi_mode, viterbi_impl, batch_hint) -> the
# reference's algorithm at ROWS rows
REGIMES = {
    "xla-scan": ("xla", "scan", "shuffle", None),               # scan
    "xla-windowed": ("xla", "windowed", "shuffle", None),       # windowed
    "pallas-shuffle": ("pallas", "scan", "shuffle", None),      # fused
    "pallas-mm": ("pallas", "scan", "mm", None),                # fused
    "auto-10": ("auto", "scan", "shuffle", None),               # fused
    "auto-200": ("auto", "scan", "shuffle", 200),               # windowed
    "auto-2100": ("auto", "scan", "shuffle", 2100),             # scan
}
# C5 at 7 data symbols: a 2688-step trellis, above the fused gate of both
# layouts (windows of 256); C2: 1152 steps, under the shuffle gate (whole
# sequence) and above the mm gate
SPECS = {"c5-7sym": ("c5", {"n_data_syms": 7}), "c2": ("c2", {})}


@pytest.fixture(scope="module")
def coded_inputs():
    """Interleaved coded LLRs per spec: [ROWS, coded_bits_per_frame]."""
    out = {}
    for i, (key, (name, kw)) in enumerate(SPECS.items()):
        spec = ref_config(name).with_(**kw)
        llr_d = _llrs(spec.uncoded_bits_per_frame, ROWS, seed=11 + i)
        out[key] = bits.interleave(_t(llr_d), spec.coded_bits_per_sym).numpy()
    return out


@pytest.mark.parametrize("spec_key", list(SPECS))
@pytest.mark.parametrize("regime", list(REGIMES))
def test_decode_matches_reference(coded_inputs, spec_key, regime):
    backend, mode, impl, hint = REGIMES[regime]
    name, kw = SPECS[spec_key]
    rspec = ref_config(name).with_(kernel_backend=backend, viterbi_mode=mode,
                                   viterbi_impl=impl, **kw)
    spec = spec_from_reference(dataclasses.asdict(rspec))
    llr = coded_inputs[spec_key]
    want_pay, want_ok = ref_rx._decode(rspec, jnp.asarray(llr), hint)
    policy.reset_launches()
    got_pay, got_ok = port_rx._decode(spec, _t(llr), hint)
    np.testing.assert_array_equal(got_pay.numpy(), np.asarray(want_pay))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    assert sum(policy.launches().values()) == 0      # plain on the CPU


def test_windowed_decoders_differ_from_scan_on_these_inputs():
    """The inputs above tell the algorithms apart: each windowed decoder
    differs from the whole-sequence scan in some rows."""
    llr = jnp.asarray(_llrs(2688, ROWS, seed=11))
    scan = ref_bits.viterbi_decode(llr)
    assert _different_rows(ref_bits.viterbi_decode_windowed(llr), scan) > 0
    assert _different_rows(ref_pv.viterbi_pallas(llr), scan) > 0


@pytest.mark.parametrize("n", [2500, 2688, 320])
@pytest.mark.parametrize("impl", ["shuffle", "mm"])
def test_windowed_plain_matches_pallas_windowed(n, impl):
    """256/64: a ragged trellis (2500 = 9 windows + 196), C5 at 7 symbols,
    and n <= e = 384, where both decode the whole sequence."""
    llr = _llrs(n, 8, seed=n)
    want = np.asarray(ref_pv.viterbi_pallas_windowed(jnp.asarray(llr),
                                                     impl=impl))
    got = KV.viterbi_windowed_plain(_t(llr), *KV.FUSED_WINDOW)
    assert got.dtype == torch.uint8 and got.shape == (8, n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [2500, 4608, 700])
def test_windowed_plain_matches_xla_windowed(n):
    """512/96: ragged, C5's 4608-step trellis, and n <= e = 704."""
    llr = _llrs(n, 8, seed=n + 1)
    want = np.asarray(ref_bits.viterbi_decode_windowed(jnp.asarray(llr)))
    got = KV.viterbi_windowed(_t(llr), *KV.XLA_WINDOW)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,impl", [(301, "shuffle"), (1001, "shuffle"),
                                    (1001, "mm"), (2500, "shuffle")])
def test_fused_matches_viterbi_pallas(n, impl):
    """viterbi_pallas's gate: 301 and 1001 (shuffle) decode whole, padded
    to 304 and 1008 steps with certainty LLRs; 1001 (mm) and 2500 are
    above the gate and decode in windows of 256."""
    llr = _llrs(n, 6, seed=3 * n)
    want = np.asarray(ref_pv.viterbi_pallas(jnp.asarray(llr), impl=impl))
    got = KV.viterbi_fused(_t(llr), impl)
    np.testing.assert_array_equal(got.numpy(), want)


def test_windowed_decodes_clean_codewords():
    """At 4 dB the windowed decodes give the sent bits, as the scan does."""
    rng = np.random.default_rng(5)
    info = rng.integers(0, 2, (3, 3000)).astype(np.uint8)
    info[:, -6:] = 0
    coded = bits.conv_encode(_t(info)).numpy()
    sigma = 10 ** (-4.0 / 20)
    y = (1.0 - 2.0 * coded) + sigma * rng.normal(size=coded.shape)
    llr = _t((2 * y / sigma**2).astype(np.float32))
    for geometry in (KV.FUSED_WINDOW, KV.XLA_WINDOW):
        np.testing.assert_array_equal(
            KV.viterbi_windowed(llr, *geometry).numpy(), info)


def test_viterbi_impl_matches_reference():
    from ofdm_uhd_tpu.kernels import policy as ref_policy
    for requested in ("xla", "pallas", "auto"):
        for mode in ("scan", "windowed"):
            for batch in (None, 1, 96, 97, 2048, 2049):
                assert policy.viterbi_impl(4608, batch, requested, mode) == \
                    ref_policy.viterbi_impl(4608, batch, requested, mode)


# K4w's per-window body (kernels/csrc/viterbi_window.cuh), compiled for
# the host: one call decodes every window of a batch in turn, with the
# window's decisions in a host buffer
_HOST_HARNESS = r"""
#include <cstddef>
#include <vector>
#include "viterbi_window.cuh"

extern "C" void vit_windowed_host(const float* llr, uint8_t* bits, int batch,
                                  int n, int windows, int l, int ov, int e) {
    std::vector<uint2> dec(e);
    for (int b = 0; b < batch; ++b) {
        for (int wi = 0; wi < windows; ++wi) {
            const vit::Window w(wi, n, l, ov, e);
            const float2* ab = reinterpret_cast<const float2*>(llr)
                               + static_cast<size_t>(b) * n + w.start;
            uint8_t* brow = bits + static_cast<size_t>(b) * n + w.start;
            vit::decode_window(
                w, e,
                [&](int t, float& la0, float& lb0, float& la1, float& lb1) {
                    la0 = ab[t].x; lb0 = ab[t].y;
                    la1 = ab[t + 1].x; lb1 = ab[t + 1].y;
                },
                [&](int t, float& la, float& lb) {
                    la = ab[t].x; lb = ab[t].y;
                },
                [&](int t, const uint2& v) { dec[t] = v; },
                [&](int t) { return dec[t]; },
                [&](int t, uint8_t bit) { brow[t] = bit; });
        }
    }
}
"""


@pytest.fixture(scope="module")
def k4w_host(tmp_path_factory):
    """The K4w body built with g++ (plain float operations, no contraction:
    -ffp-contract=off) into a temporary directory, loaded with ctypes."""
    import ctypes
    import shutil
    import subprocess
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the K4w body cannot be built for the "
                    "host")
    out = tmp_path_factory.mktemp("k4w_host")
    src = out / "harness.cpp"
    src.write_text(_HOST_HARNESS)
    csrc = os.path.join(os.path.dirname(KV.__file__), "csrc")
    lib = out / "libk4w_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-fPIC",
                    "-shared", "-I", csrc, "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.vit_windowed_host.argtypes = [p, p, i, i, i, i, i, i]
    dll.vit_windowed_host.restype = None
    return dll


@pytest.mark.parametrize("geometry", [KV.FUSED_WINDOW, KV.XLA_WINDOW])
def test_k4w_body_on_host_matches_plain(k4w_host, geometry):
    """The one-thread-a-window body, bit for bit against
    viterbi_windowed_plain over every window of a seeded [8, 6912] batch
    (the first and tail windows included): noise, codewords at -3 dB and
    integer LLRs, whose ties test the strict '>'."""
    n = 6912
    llr = _llrs(n, 8, seed=17)
    llr[:2] = np.random.default_rng(18).integers(-2, 3, (2, 2 * n))
    llr = np.ascontiguousarray(llr, dtype=np.float32)
    l, e, starts = KV.window_geometry(n, *geometry)
    got = np.full((8, n), 7, np.uint8)
    k4w_host.vit_windowed_host(llr.ctypes.data, got.ctypes.data, 8, n,
                               len(starts), l, geometry[1], e)
    want = KV.viterbi_windowed_plain(_t(llr), *geometry).numpy()
    np.testing.assert_array_equal(got, want)
