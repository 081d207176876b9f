"""FFT sizes and S&C lags above the chain's own: every power-of-two n_sc
the reference's WaveformSpec accepts runs through the port's kernels.

K3 transforms up to 8192 points in one launch and larger ones by the
two-pass route (kernels/fft.py route: a column pass that applies the
twiddles, then a row pass that stores in natural order); the S&C kernels
K6 and K9 sum up to lag 1024 in one tile launch and above it by the
split route (kernels/sync.py route: a span pass to S_W, a stride pass
over the residue chains mod W, the epilogue). Here on the CPU: the route
plans for every power of two from 2 to 2^20; each route's arithmetic
through the plain versions of its steps against torch.fft and the plain
S&C; and the RX chain against the JAX package at n_sc = 4096 and 16384,
once through the plain versions and once with the routes' plain
emulations in place of the FFT and S&C calls."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from bench_lib import build_capture as ref_build_capture  # noqa: E402
from ofdm_uhd_tpu.core.spec import WaveformSpec as RefSpec  # noqa: E402
from ofdm_uhd_tpu.pipeline import RxPipeline as RefRx  # noqa: E402
from ofdm_uhd_tpu_torch.bench_lib import to_sc16  # noqa: E402
from ofdm_uhd_tpu_torch.convert import spec_from_reference  # noqa: E402
from ofdm_uhd_tpu_torch.kernels import fft, policy, scfront  # noqa: E402
from ofdm_uhd_tpu_torch.kernels import sync as ksync  # noqa: E402
from ofdm_uhd_tpu_torch.phy import sync as psync  # noqa: E402
from ofdm_uhd_tpu_torch.pipeline import RxPipeline  # noqa: E402

torch.set_num_threads(2)

POWERS = [1 << k for k in range(1, 21)]


@pytest.mark.parametrize("n", POWERS)
def test_fft_route_plans_every_power_of_two(n):
    """One K3 launch up to 8192 points; above, two passes, no transpose:
    the column pass and the row pass over one split n1 x n2 = n, both
    powers of two of at most 4096 points, n2 = 512 while that leaves n1
    <= 4096 (above, n1 = 4096), and n1 a multiple of the rows a row-pass
    block holds."""
    plan = fft.route(n)
    assert fft.ONE_LAUNCH_N == 8192
    if n <= 8192:
        assert plan == [("fft", n)]
        return
    assert [s[0] for s in plan] == ["columns", "rows_t"]
    (_, n1, n2), (_, m1, m2) = plan
    assert (n1, n2) == (m1, m2) and n1 * n2 == n
    assert n1 <= fft.PASS_MAX_N == 4096 and n2 <= fft.PASS_MAX_N
    assert n2 == (512 if n <= 512 * 4096 else n // 4096)
    assert n1 % fft.rows_per_block(n2) == 0


@pytest.mark.parametrize("n", [3, 48, 1 << 25, 0])
def test_fft_route_refuses_what_it_cannot_take(n):
    with pytest.raises(ValueError):
        fft.route(n)


@pytest.mark.parametrize("l", POWERS)
def test_sc_route_plans_every_power_of_two(l):
    """One tile launch up to lag 1024; above, two launches, the span pass
    and the stride pass at one width W, a power of two: l / 8 up to 1024,
    then 1024 while the stride pass's D = l / W stays within 64, then l /
    64 (at most 16384)."""
    plan = ksync.route(l)
    assert ksync.TILE_MAX_L == 1024
    if l <= ksync.TILE_MAX_L:
        assert plan == [("tile",)]
        return
    (span, w), (stride, w2) = plan
    assert (span, stride) == ("span", "stride") and w == w2
    assert w & (w - 1) == 0 and l % w == 0
    assert w == (l // 8 if l <= 8192 else
                 1024 if l <= 65536 else l // 64)
    assert l // w <= 64 and w <= 16384


@pytest.mark.parametrize("l", [3, 6000, 1 << 24])
def test_sc_route_refuses_other_lags(l):
    with pytest.raises(ValueError):
        ksync.route(l)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [8192, 16384, 65536])
def test_four_step_route_equals_torch_fft(n, inverse):
    """The route through fft_plain, columns_plain and rows_t_plain, and
    the two passes at the split n / 512 x 512 (8192 takes one launch, the
    passes 16 x 512): within 1e-5 of max|y| of torch.fft (norm='ortho'),
    seeded rows."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy((rng.normal(size=(3, n))
                          + 1j * rng.normal(size=(3, n))).astype(np.complex64))
    n1, n2 = n // 512, 512
    tw = fft._route_twiddles(n1, n2, x.device)
    passes = fft.rows_t_plain(fft.columns_plain(x, n1, n2, tw, inverse),
                              n1, n2, inverse)
    f = torch.fft.ifft if inverse else torch.fft.fft
    want = f(x, norm="ortho")
    for got in (fft.two_pass_plain(x, inverse), passes):
        assert got.shape == want.shape and got.dtype == torch.complex64
        assert (float((got - want).abs().max())
                <= 1e-5 * float(want.abs().max()))


def test_four_step_twiddles_are_the_route_factors():
    """The column pass's table holds W_n^(j k1) at [k1 * n2 + j], k1 < n1,
    j < n2: the layout the pass reads and writes."""
    n = 16384
    (_, n1, n2), _ = fft.route(n)
    tw = fft.route_twiddle_table(n1, n2)
    assert tw.dtype == np.complex64 and tw.shape == (n,)
    tw = tw.reshape(n1, n2)
    for k1, j in ((0, 0), (5, 101), (n1 - 1, n2 - 1)):
        assert abs(tw[k1, j] - np.exp(-2j * np.pi * k1 * j / n)) <= 1e-7
    dev = fft._route_twiddles(n1, n2, torch.device("cpu"))
    assert np.array_equal(dev.numpy(), tw.ravel())


@pytest.mark.parametrize("metric", [False, True])
@pytest.mark.parametrize("l,w", [(16384, None), (8192, None), (8192, 256),
                                 (8192, 8192), (4096, 16), (2048, None),
                                 (64, 1), (64, 8), (64, 64), (1, None)])
def test_split_route_equals_plain_sc(l, w, metric):
    """The split route's plain emulation (span_plain, then stride_plain on
    the residue chains mod W) gives sc_correlate_plain's (P, R) and
    sc_frontend_plain's (P, M) bit for bit at the route's width (None)
    and at others, W = 1 and W = l included: the same adds in the same
    order, an idle stretch (M = 0) included."""
    rng = np.random.default_rng(l)
    n = 2 * l + 5001
    r = torch.from_numpy((rng.normal(size=(2, n))
                          + 1j * rng.normal(size=(2, n))).astype(np.complex64))
    r[1, 1000:4000] = 0
    got = ksync.split_plain(r, l, metric, w)
    want = (scfront.sc_frontend_plain(r, l) if metric
            else ksync.sc_correlate_plain(r, l))
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


# the RX chain against the reference: QPSK, CP n/8, 2 data symbols, 2
# captures of 2 frames. At 16384 the occupancy is cut to 2080 subcarriers
# (3802 payload bits; the default 13312 gives 24538, and the reference's
# CRC matrix is O(n^2) in them); the FFT and the S&C lag stay 16384 and
# 8192.
N_CAPS, N_FRAMES, GAP, MAX_FRAMES = 2, 2, 300, 4
SIZES = {4096: 0, 16384: 2080}


@pytest.fixture(scope="module", params=sorted(SIZES))
def ref(request):
    n = request.param
    rspec = RefSpec(n_sc=n, cp=n // 8, modulation="qpsk", n_data_syms=2,
                    n_occupied=SIZES[n])
    built = [ref_build_capture(rspec, N_FRAMES, GAP, seed=s)
             for s in range(N_CAPS)]
    iq = to_sc16(np.stack([c for c, _ in built]))
    out = RefRx(rspec, diag=True).rx_capture_sc16(iq, max_frames=MAX_FRAMES)
    return {"spec": rspec, "iq": iq,
            "pays": np.stack([p for _, p in built]),
            "out": {k: np.asarray(v) for k, v in out.items()}}


def _route_emulations(monkeypatch):
    """The FFT and S&C calls of the chain through the kernels' routes,
    each step by its plain version."""
    from ofdm_uhd_tpu_torch.phy import frame
    monkeypatch.setattr(frame.K1, "fft", lambda x: fft.two_pass_plain(x))
    monkeypatch.setattr(frame.K1, "ifft",
                        lambda x: fft.two_pass_plain(x, True))
    monkeypatch.setattr(psync, "sc_frontend",
                        lambda r, l: ksync.split_plain(r, l, True))


@pytest.mark.parametrize("routes", ["plain", "route_emulation"])
def test_rx_chain_matches_reference(ref, routes, monkeypatch):
    """d, valid and crc_ok exact, the valid slots' payloads exact and
    equal to the sent ones, EVM within 1e-4 dB."""
    if routes == "route_emulation":
        _route_emulations(monkeypatch)
    spec = spec_from_reference(dataclasses.asdict(ref["spec"]))
    policy.reset_launches()
    out = RxPipeline(spec, diag=True).rx_capture_sc16(
        torch.from_numpy(ref["iq"]), max_frames=MAX_FRAMES)
    out = {k: v.numpy() for k, v in out.items()}
    assert policy.launches() == dict.fromkeys(policy.KERNELS, 0)
    want = ref["out"]
    for k in ("d", "valid", "crc_ok"):
        np.testing.assert_array_equal(out[k], want[k], err_msg=k)
    valid = want["valid"]
    assert valid.sum() == N_CAPS * N_FRAMES and want["crc_ok"][valid].all()
    np.testing.assert_array_equal(out["payload"][valid],
                                  want["payload"][valid])
    np.testing.assert_array_equal(out["payload"][:, :N_FRAMES], ref["pays"])
    np.testing.assert_allclose(out["evm_db"][valid], want["evm_db"][valid],
                               atol=1e-4)


def test_pallas_at_2048_points_decodes_where_the_reference_asserts(
        monkeypatch):
    """n_sc = 2048 under kernel_backend='pallas' (a 2-frame QPSK capture,
    CP 256, 2 data symbols): the reference's fused S&C front end asserts
    that its halo block divides its main block (h = 24 does not divide tr
    = 512 at l = 1024); the port's K6 takes the lag by its tile route
    (one launch on the card) and decodes both frames."""
    rspec = RefSpec(n_sc=2048, cp=256, modulation="qpsk", n_data_syms=2,
                    kernel_backend="pallas")
    cap, pays = ref_build_capture(rspec, 2, GAP, seed=0)
    iq = to_sc16(cap[None])
    with pytest.raises(AssertionError, match="halo"):
        RefRx(rspec).rx_capture_sc16(iq, max_frames=MAX_FRAMES)
    assert ksync.route(1024) == [("tile",)]
    lags = []

    def front(r, l):
        lags.append(l)
        return scfront.sc_frontend(r, l)
    monkeypatch.setattr(psync, "sc_frontend", front)
    spec = spec_from_reference(dataclasses.asdict(rspec))
    out = RxPipeline(spec).rx_capture_sc16(torch.from_numpy(iq),
                                           max_frames=MAX_FRAMES)
    assert lags == [1024]
    valid = out["valid"][0].numpy()
    assert valid.sum() == 2 and out["crc_ok"][0].numpy()[valid].all()
    np.testing.assert_array_equal(out["payload"][0, :2].numpy(), pays)
