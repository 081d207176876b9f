"""The hand-written CUDA kernels against their plain PyTorch versions, on
an NVIDIA GPU (sm_90a). Every test here needs the card and skips without
one. On a machine with a card and without JAX, run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(--noconftest: the repository's tests/conftest.py imports JAX)."""

import numpy as np
import pytest
import torch

from ofdm_uhd_tpu_torch.core.spec import config
from ofdm_uhd_tpu_torch.kernels import (banded, extract, fft, fir, localize,
                                        policy, scfront, sync, viterbi)
from ofdm_uhd_tpu_torch.phy.tables import resample_filter
from ofdm_uhd_tpu_torch.research import deframe, fir_ilv, shift

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


C3_PATH = ("scfront", "localize", "extract", "fft", "viterbi")


def _coded_llrs(bsz, n, snr_db, dev, seed):
    from ofdm_uhd_tpu_torch.phy import bits
    g = torch.Generator().manual_seed(seed)
    info = torch.randint(0, 2, (bsz, n), generator=g, dtype=torch.uint8)
    info[:, -6:] = 0
    coded = bits.conv_encode(info).float()
    sigma = 10 ** (-snr_db / 20)
    y = 1.0 - 2.0 * coded + sigma * torch.randn(coded.shape, generator=g)
    return (2 * y / sigma**2).to(dev), info


@pytest.mark.parametrize("bsz,n", [(1, 7), (5, 100), (37, 6912),
                                   (4, 18432), (3, 36864)])
def test_viterbi_kernel_exact(dev, bsz, n):
    """K4 against its plain version on codewords at 5 dB, noise and integer
    LLRs (ties), at k4_group's group size and at each one forced, one
    launch a call; (3, 36864) is C4's trellis length."""
    llr, info = _coded_llrs(bsz, n, 5.0, dev, seed=n)
    policy.reset_launches()
    got = viterbi.viterbi(llr)
    assert policy.launches()["viterbi"] == 1
    assert torch.equal(got, viterbi.viterbi_plain(llr))
    rnd = torch.randn((bsz, 2 * n), generator=_gen(n), device=dev) * 3
    ties = torch.randint(-2, 3, (bsz, 2 * n), generator=_gen(n + 1),
                         device=dev).float()
    for x in (llr, rnd, ties):
        want = viterbi.viterbi_plain(x)
        assert torch.equal(viterbi.viterbi(x), want)
        for g in viterbi.K4_GROUPS:
            policy.reset_launches()
            assert torch.equal(viterbi._viterbi_cuda(x, g), want), g
            assert policy.launches()["viterbi"] == 1


@pytest.mark.parametrize("geometry", [(256, 64), (512, 96)])
@pytest.mark.parametrize("bsz,n", [(3, 4608), (5, 2500), (2, 300),
                                   (4, 704), (34, 4608)])
def test_viterbi_windowed_kernel_exact(dev, geometry, bsz, n):
    """K4w against its plain version: C5's trellis, a ragged one, and
    n <= window + 2*overlap (one whole-sequence window)."""
    llr, info = _coded_llrs(bsz, n, 5.0, dev, seed=n + bsz)
    policy.reset_launches()
    got = viterbi.viterbi_windowed(llr, *geometry)
    assert policy.launches()["viterbi_windowed"] == 1
    assert torch.equal(got, viterbi.viterbi_windowed_plain(llr, *geometry))
    assert torch.equal(got.cpu(), info)
    for gen in (lambda: torch.randn((bsz, 2 * n), generator=_gen(n),
                                    device=dev) * 3,
                lambda: torch.randint(-2, 3, (bsz, 2 * n),
                                      generator=_gen(n + 1),
                                      device=dev).float()):
        x = gen()
        want = viterbi.viterbi_windowed_plain(x, *geometry)
        assert torch.equal(viterbi.viterbi_windowed(x, *geometry), want)
        # the previous body, chip_smoke.py's A/B baseline, gives the same
        assert torch.equal(
            viterbi._viterbi_windowed_warp_cuda(x, *geometry), want)


def test_viterbi_decode_algorithms_on_card(dev):
    """decode() through each algorithm equals its plain-forced run."""
    x = torch.randn((6, 2 * 2501), generator=_gen(9), device=dev) * 4
    for algorithm, layout in (("fused", "shuffle"), ("fused", "mm"),
                              ("windowed", "shuffle"), ("scan", "shuffle")):
        got = viterbi.decode(x, algorithm, layout)
        with policy.plain_versions():
            want = viterbi.decode(x, algorithm, layout)
        assert torch.equal(got, want), algorithm
    short = x[:, :2 * 301].contiguous()          # fused: whole, padded
    with policy.plain_versions():
        want = viterbi.viterbi_fused(short)
    assert torch.equal(viterbi.viterbi_fused(short), want)


# powers of two up to 2^16 (K3 in one launch up to 4096, the four-step
# route above; K5 up to 512)
FFT_NS = [1 << k for k in range(1, 17)]
CP_NS = [n for n in FFT_NS if n <= fft.MAX_CP_N]


@pytest.mark.parametrize("rows", [1, 77, 1001])
@pytest.mark.parametrize("n", FFT_NS)
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_kernel_close(dev, n, inverse, rows):
    """K3 at every n, both directions, within 1e-5 of max|y|: one row, 77
    rows, and 1001 rows (several blocks, the last one partial, for every
    plan's transforms per block)."""
    x = torch.randn((rows, n), dtype=torch.complex64, generator=_gen(n),
                    device=dev)
    f = fft.ifft if inverse else fft.fft
    got = f(x)
    ref = fft.fft_plain(x, inverse=inverse)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("n", [8192, 32768])
def test_fft_four_step_route_on_card(dev, n):
    """One launch at 8192, above it one column pass and one row pass a
    transform, both ways, and no other launch; each pass at the split n /
    512 x 512 within 1e-5 of max|y| of its plain step, both ways; the row
    pass refuses an n1 that is not a multiple of the rows its blocks
    hold."""
    x = torch.randn((5, n), dtype=torch.complex64, generator=_gen(n),
                    device=dev)
    n1, n2 = n // fft.ROW_N, fft.ROW_N
    tw = fft._route_twiddles(n1, n2, dev)
    want = ({"fft": 1} if n <= fft.ONE_LAUNCH_N
            else {"fft_columns": 1, "fft_rows_t": 1})
    for inverse in (False, True):
        policy.reset_launches()
        (fft.ifft if inverse else fft.fft)(x)
        got = {k: v for k, v in policy.launches().items() if v}
        assert got == want
        k = fft._columns_cuda(x, n1, n2, tw, inverse)
        _within(k, fft.columns_plain(x, n1, n2, tw, inverse))
        _within(fft._rows_t_cuda(k, n1, n2, inverse),
                fft.rows_t_plain(k, n1, n2, inverse))
    with pytest.raises(ValueError):           # 8 rows a block at n2 = 512
        fft._rows_t_cuda(x[:, :1024].contiguous(), 2, 512, False)


@pytest.mark.parametrize("odd", [0, 1])
@pytest.mark.parametrize("n", CP_NS)
def test_cp_strip_fft_kernel_close(dev, n, odd):
    """K5 RX at every n, from an even and an odd start, on odd row counts:
    on contiguous symbol rows, in place on rows whose stride exceeds
    in_len, and on non-contiguous batch views (every other frame, a slice
    of each frame's symbols)."""
    cp = max(n // 8, 2)
    in_len = n + cp
    x = torch.randn((13, 7, in_len + 5), dtype=torch.complex64,
                    generator=_gen(n + odd), device=dev)
    start = cp - odd
    for rows in (x[..., :in_len].contiguous(), x[..., :in_len],
                 x[::2, :, :in_len], x[:, 1:6, :in_len]):
        policy.reset_launches()
        got = fft.cp_strip_fft(rows, start, n)
        assert policy.launches()["cpfft"] == 1
        _within(got, fft.cp_strip_fft_plain(rows, start, n))


@pytest.mark.parametrize("cp_of", ["0", "1", "n/4", "n"])
@pytest.mark.parametrize("n", CP_NS)
def test_ifft_cp_kernel_close(dev, n, cp_of):
    """K5 TX at every n with no prefix, one sample, a quarter and all n."""
    cp = {"0": 0, "1": 1, "n/4": n // 4, "n": n}[cp_of]
    g = torch.randn((11, 3, n), dtype=torch.complex64, generator=_gen(n),
                    device=dev)
    for rows in (g, g[:, ::2]):
        policy.reset_launches()
        got = fft.ifft_cp(rows, cp)
        assert policy.launches()["ifftcp"] == 1
        _within(got, fft.ifft_cp_plain(rows, cp))
        assert torch.equal(got[..., :cp], got[..., n:])


@pytest.mark.parametrize("n", CP_NS)
def test_cp_strip_fft_equals_fft_bit_for_bit(dev, n):
    """K3 and K5 RX run one body: K5 on contiguous windows, and in place
    on the symbol rows, gives K3's output on those windows exactly."""
    cp = max(n // 8, 2)
    syms = torch.randn((9, 5, n + cp), dtype=torch.complex64,
                       generator=_gen(3 * n), device=dev)
    w = syms[..., cp - 1:cp - 1 + n].contiguous()
    want = fft.fft(w)
    assert torch.equal(fft.cp_strip_fft(w, 0, n), want)
    assert torch.equal(fft.cp_strip_fft(syms, cp - 1, n), want)


@pytest.mark.parametrize("l", [32, 128])
@pytest.mark.parametrize("n", [5000, 50001])
def test_sc_correlate_kernel_close(dev, l, n):
    """K9 against its plain version: P within 1e-5 of max|P|, R within
    1e-5 relative (the same doubling order, unfused)."""
    x = torch.randn((3, n), dtype=torch.complex64, generator=_gen(l + n),
                    device=dev)
    x[1, 1000:3000] = 0
    policy.reset_launches()
    p, rr = sync.sc_correlate(x, l)
    assert policy.launches()["sccorr"] == 1
    p0, rr0 = sync.sc_correlate_plain(x, l)
    _within(p, p0)
    assert float(((rr - rr0).abs() / rr0.abs().clamp_min(1e-30)).max()) \
        <= 1e-5
    m, m0 = sync.sc_metric(p, rr), sync.sc_metric(p0, rr0)
    assert (m - m0).abs().max() <= 1e-5


@pytest.mark.parametrize("metric", [False, True])
def test_sc_levels_route_close(dev, metric):
    """K6 and K9 at l = 8192 (n_sc = 16384), the split route: 2 launches
    (the span pass and the stride pass), within the S&C gates of the plain
    version."""
    l = 8192
    x = torch.randn((2, 50001), dtype=torch.complex64, generator=_gen(l),
                    device=dev)
    x[1, 10000:40000] = 0
    policy.reset_launches()
    f = scfront.sc_frontend if metric else sync.sc_correlate
    p, q = f(x, l)
    got = policy.launches()
    assert (got["sc_span"], got["sc_stride"]) == (1, 1)
    assert got["scfront"] == got["sccorr"] == 0
    p0, q0 = (scfront.sc_frontend_plain if metric
              else sync.sc_correlate_plain)(x, l)
    _within(p, p0)
    if metric:
        assert (q - q0).abs().max() <= 1e-5
    else:
        assert float(((q - q0).abs() / q0.abs().clamp_min(1e-30)).max()) \
            <= 1e-5


@pytest.mark.parametrize("l,rows,n", [(1, 3, 20001), (32, 3, 20001),
                                      (128, 3, 20001), (512, 3, 20001),
                                      (2048, 3, 20001), (4096, 3, 20001),
                                      (128, 1, 4_436_068)])
def test_sc_levels_route_equals_tile_route(dev, l, rows, n):
    """Both routes sum in the same order: the split route's two passes
    give the tile kernels' bits at a lag both take, at the route's width
    and at the widths 1 and l, up to the tile kernel's largest lag (the
    route takes the split route from 2048) and on a row of C3's width."""
    x = torch.randn((rows, n), dtype=torch.complex64, generator=_gen(l),
                    device=dev)
    for metric in (False, True):
        tile = sync._tile_cuda("sccorr", x, n - 2 * l + 1, l, metric)
        for w in sorted({sync.split_width(l), 1, l}):
            split = sync.split_route(x, l, metric, sync._span_cuda,
                                     sync._stride_cuda, w)
            for a, b in zip(tile, split):
                assert torch.equal(a, b)


@pytest.mark.parametrize("cfg,span_of", [("c3", None), ("c4", None),
                                         ("c2", None), ("c3", 4608),
                                         ("c3", 1500)])
def test_localize_kernel_exact(dev, cfg, span_of):
    """K1 against its plain version, one launch a call: C3's, C4's and
    C2's spans (the 9-, 36- and 3-load templates) and two above 1152 (the
    block body: big_nsc 4096's 4608, and 1500); rows of mixed candidates
    (a plateau, a window past nd, the sentinel nd, offsets past nd and
    below 0) and rows that are mostly or only sentinels."""
    spec = config(cfg)
    span = span_of or spec.sym_len
    g = _gen(3)
    nd = max(50000, 4 * span)
    m = torch.rand((4, nd), generator=g, device=dev) ** 4
    m[:, 1000:1300] = 0.9
    p = torch.randn((4, nd), dtype=torch.complex64, generator=g, device=dev)
    cand = torch.sort(torch.randint(0, nd, (4, 60), generator=g,
                                    device=dev)).values
    cand[:, -3:] = torch.tensor([990, nd - 50, nd], device=dev)
    cand[1, 5:] = nd                                # mostly sentinels
    cand[2, :] = nd                                 # only sentinels
    cand[3, ::7] = nd + 11
    cand[3, 1] = -4
    cand = cand.to(torch.int32)
    policy.reset_launches()
    d, eps = localize.localize(m, p, cand, span, spec.cp)
    assert policy.launches()["localize"] == 1
    d_p, eps_p = localize.localize_plain(m, p, cand, span, spec.cp)
    assert torch.equal(d, d_p)
    assert (eps - eps_p).abs().max() <= 1e-6
    sentinel = (nd + (span - 1) // 2 - spec.cp // 2)
    assert torch.equal(d[2], torch.full_like(d[2], sentinel))
    assert torch.equal(eps[2], torch.zeros_like(eps[2]))


def test_extract_kernel_exact(dev):
    g = _gen(4)
    n, fl = 30000, 4032
    cap = torch.randn((2, n), dtype=torch.complex64, generator=g, device=dev)
    ds = torch.tensor([[0, 5, n - 100, n, n + 9, -3],
                       [1023, 2048, 777, n - fl, n - 1, 12]],
                      dtype=torch.int32, device=dev)
    got = extract.extract_frames(cap, ds, fl)
    ref = extract.extract_plain(cap, ds, fl)
    assert torch.equal(torch.view_as_real(got), torch.view_as_real(ref))


def test_wrappers_reject_bad_input(dev):
    with pytest.raises(ValueError):
        viterbi.viterbi(torch.zeros((2, 7), device=dev))
    with pytest.raises(ValueError):
        viterbi._viterbi_cuda(torch.zeros((2, 8), device=dev), 12)
    with pytest.raises(ValueError):
        viterbi.viterbi_windowed(torch.zeros((2, 700), device=dev,
                                             dtype=torch.float64), 256, 64)
    with pytest.raises(ValueError):
        fft.fft(torch.zeros((2, 48), dtype=torch.complex64, device=dev))
    with pytest.raises(ValueError):
        extract.extract_frames(torch.zeros((1, 100), dtype=torch.complex64,
                                           device=dev),
                               torch.zeros((1, 2), dtype=torch.int64,
                                           device=dev), 10)
    with pytest.raises(ValueError):
        fir.fir_filter(torch.zeros((2, 100), device=dev), [0.5, 0.5])
    with pytest.raises(ValueError):
        scfront.sc_frontend(torch.zeros((2, 1000), dtype=torch.complex64,
                                        device=dev), 100)
    c = torch.zeros((2, 3, 1100), dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError):
        fft.cp_strip_fft(c, 16, 48)                # not a power of two
    with pytest.raises(ValueError):
        fft.cp_strip_fft(c, 76, 1024)              # above 512
    with pytest.raises(ValueError):
        fft.ifft_cp(c[..., :96], 16)
    with pytest.raises(ValueError):
        sync.sc_correlate(c[0, :, :63], 32)        # nd < 1
    with pytest.raises(ValueError):
        sync.sc_correlate(c[0], 48)


def test_slice_on_card_matches_cpu(dev):
    from ofdm_uhd_tpu_torch.bench_lib import build_capture, to_sc16
    from ofdm_uhd_tpu_torch.pipeline import RxPipeline
    spec = config("c3")
    built = [build_capture(spec, 3, 300, seed=s, device=dev)
             for s in range(2)]
    iq = torch.from_numpy(to_sc16(np.stack([c for c, _ in built])))
    pays = np.stack([p for _, p in built])
    rx = RxPipeline(spec)
    cpu = rx.rx_capture_sc16(iq, max_frames=5)
    policy.reset_launches()
    gpu = rx.rx_capture_sc16(iq.to(dev), max_frames=5)
    torch.cuda.synchronize()
    launched = policy.launches()
    assert all(launched[k] > 0 for k in C3_PATH), launched
    assert launched["fir"] == launched["interp"] == 0
    for k in ("crc_ok", "valid", "d", "det_sat"):
        assert torch.equal(gpu[k].cpu(), cpu[k]), k
    assert torch.equal(gpu["payload"].cpu()[cpu["valid"]],
                       cpu["payload"][cpu["valid"]])
    assert np.array_equal(gpu["payload"][:, :3].cpu().numpy(), pays)
    assert (gpu["eps"].cpu() - cpu["eps"]).abs().max() <= 1e-4


def _within(got, ref, rel=1e-5):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    err = float((got - ref).abs().max())
    assert err <= rel * float(ref.abs().max()), err


def _fir_taps(ntaps):
    if ntaps == 3:
        return [0.25, 0.5, 0.25]
    if ntaps == 193:
        return resample_filter(8, 1)
    return np.random.default_rng(ntaps).normal(size=ntaps).astype(np.float32)


# (stride, taps, rows, n_in): ragged rows (n_in no multiple of the
# stride, the 1152-output tile or the 9 outputs a thread) at strides 1, 2,
# 3 and 8 and 3, 193 and 194 taps (194: an even count, nd = 25 taps in
# two of 8 phases, 24 in the rest); then rows of C4's full width: its
# decimation input [4,138,472] and its baseband [517,309]
FIR_CASES = ([(s, t, 3, 20011) for s in (1, 2, 3, 8) for t in (3, 193, 194)]
             + [(8, 193, 2, 4_138_472), (1, 193, 2, 517_309)])


@pytest.mark.parametrize("stride,ntaps,rows,n_in", FIR_CASES)
def test_fir_strided_kernel_close(dev, stride, ntaps, rows, n_in):
    taps = _fir_taps(ntaps)
    x = torch.randn((rows, n_in), dtype=torch.complex64,
                    generator=_gen(ntaps + stride), device=dev)
    policy.reset_launches()
    if stride == 1:
        got, ref = fir.fir_filter(x, taps), fir.decim_plain(x, 1, taps)
    else:
        got = fir.polyphase_decim(x, stride, taps)
        ref = fir.decim_plain(x, stride, taps)
    assert policy.launches()["fir"] == 1
    _within(got, ref)
    one = fir.polyphase_decim(x[1:2].contiguous(), stride, taps)
    assert torch.equal(one[0], got[1])           # rows do not leak


@pytest.mark.parametrize("stride,ntaps", [(1, 193), (8, 193), (3, 194),
                                          (8, 3)])
def test_fir_stream_valid_kernel_close(dev, stride, ntaps):
    """The stream's valid-mode decimation (no padding, (n_in - nt) //
    stride + 1 outputs) on the strided kernel, one launch, against
    decim_stream_plain; rows do not leak."""
    taps = _fir_taps(ntaps)
    x = torch.randn((3, stride * 6000 + ntaps + 4), dtype=torch.complex64,
                    generator=_gen(ntaps + 5 * stride), device=dev)
    policy.reset_launches()
    got = fir.polyphase_decim_stream(x, stride, taps)
    assert policy.launches()["fir"] == 1
    _within(got, fir.decim_stream_plain(x, stride, taps))
    one = fir.polyphase_decim_stream(x[1:2].contiguous(), stride, taps)
    assert torch.equal(one[0], got[1])


@pytest.mark.parametrize("l,nt", [(2, None), (8, None), (3, None),
                                  (1, None), (8, 33), (2, 63), (8, 321),
                                  (3, 210), (40, 2000)])
def test_interp_kernel_close(dev, l, nt):
    """The exact interpolation against its plain version, one launch a
    call: the resampler's filters (nd = 25 branch taps) and seeded taps
    of nd 5, 32, and 41, 71, 51 (above the register limit: the taps in
    chunks of 32; l = 40 above the block's threads' q-blocks); rows do
    not leak."""
    taps = resample_filter(l, 1) if nt is None else np.random.default_rng(
        nt).normal(size=nt).astype(np.float32)
    x = torch.randn((2, 5003), dtype=torch.complex64, generator=_gen(l),
                    device=dev)
    policy.reset_launches()
    got = fir.polyphase_interp(x, l, taps)
    assert policy.launches()["interp"] == 1
    _within(got, fir.interp_plain(x, l, taps))
    one = fir.polyphase_interp(x[1:2].contiguous(), l, taps)
    assert torch.equal(one[0], got[1])


def test_interp_kernel_at_c4_tx(dev):
    """C4's TX interpolation of its [32, 16128] frames by 8 (193 taps),
    one launch."""
    taps = resample_filter(8, 1)
    base = torch.randn((32, 16128), dtype=torch.complex64,
                       generator=_gen(18), device=dev)
    policy.reset_launches()
    got = fir.polyphase_interp(base, 8, taps)
    assert policy.launches()["interp"] == 1
    _within(got, fir.interp_plain(base, 8, taps))


@pytest.mark.parametrize("stride", [1, 2, 8])
@pytest.mark.parametrize("ntaps", [3, 193])
def test_fir_bf16_strided_kernel_close(dev, stride, ntaps):
    """The bf16 tier's strided kernel (tensor cores) against its plain
    version, within 1e-5 of max|y| (f32 summation order); ragged rows; it
    differs from the exact tier by the bf16 rounding."""
    taps = resample_filter(8, 1) if ntaps == 193 else [0.25, 0.5, 0.25]
    x = torch.randn((3, 20011), dtype=torch.complex64,
                    generator=_gen(ntaps + stride), device=dev)
    policy.reset_launches()
    got = (fir.fir_filter(x, taps, precision="bf16") if stride == 1
           else fir.polyphase_decim(x, stride, taps, precision="bf16"))
    assert policy.launches()["fir_bf16"] == 1
    assert policy.launches()["fir"] == 0
    ref = fir.decim_plain_bf16(x, stride, taps)
    _within(got, ref)
    exact = fir.decim_plain(x, stride, taps)
    assert float((got - exact).abs().max()) > 1e-4 * float(exact.abs().max())
    one = fir.polyphase_decim(x[1:2].contiguous(), stride, taps,
                              precision="bf16")
    assert torch.equal(one[0], got[1])           # rows do not leak


@pytest.mark.parametrize("l", [2, 3, 8])
def test_interp_bf16_kernel_close(dev, l):
    taps = resample_filter(l, 1)
    x = torch.randn((2, 5003), dtype=torch.complex64, generator=_gen(l + 7),
                    device=dev)
    policy.reset_launches()
    got = fir.polyphase_interp(x, l, taps, precision="bf16")
    assert policy.launches()["interp_bf16"] == 1
    assert policy.launches()["interp"] == 0
    _within(got, fir.interp_plain_bf16(x, l, taps))
    one = fir.polyphase_interp(x[1:2].contiguous(), l, taps, precision="bf16")
    assert torch.equal(one[0], got[1])


def test_bf16_kernels_at_c4_shapes(dev):
    """C4's decimation of 8 padded captures [8, 4,138,472] by 8 and its
    TX interpolation of [32, 16128] frames by 8, 193 taps."""
    taps = resample_filter(8, 1)
    x = torch.randn((8, 4_138_472), dtype=torch.complex64, generator=_gen(8),
                    device=dev)
    _within(fir._strided_bf16_cuda(x, taps, 8),
            fir.decim_plain_bf16(x, 8, taps))
    base = torch.randn((32, 16128), dtype=torch.complex64, generator=_gen(9),
                       device=dev)
    _within(fir._interp_bf16_cuda(base, 8, taps),
            fir.interp_plain_bf16(base, 8, taps))


def test_bf16_kernels_on_second_card(dev):
    """A tensor on cuda:1 launches the bf16 kernels there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    taps = resample_filter(8, 1)
    x = torch.randn((2, 9001), dtype=torch.complex64, generator=_gen(1),
                    device=dev).to("cuda:1")
    policy.reset_launches()
    y = fir.polyphase_decim(x, 8, taps, precision="bf16")
    up = fir.polyphase_interp(x, 8, taps, precision="bf16")
    assert y.device == up.device == x.device
    assert policy.launches()["fir_bf16"] == policy.launches()[
        "interp_bf16"] == 1
    _within(y.cpu(), fir.decim_plain_bf16(x.cpu(), 8, taps))
    _within(up.cpu(), fir.interp_plain_bf16(x.cpu(), 8, taps))


def test_c4_bf16_slice_on_card_matches_cpu(dev):
    """C4 under kernel_backend 'pallas' with filter_precision 'bf16': the
    TX interpolates and the RX decimates through the bf16 kernels, never
    the exact ones, and decode as the CPU's plain versions."""
    from ofdm_uhd_tpu_torch.bench_lib import build_capture
    from ofdm_uhd_tpu_torch.pipeline import RxPipeline
    spec = config("c4").with_(n_data_syms=2, kernel_backend="pallas",
                              filter_precision="bf16")
    policy.reset_launches()
    built = [build_capture(spec, 3, 300, seed=s, cfo=0.1,
                           phase_noise_std=0.0, device=dev) for s in range(2)]
    assert policy.launches()["interp_bf16"] == 2
    assert policy.launches()["interp"] == 0
    caps = torch.from_numpy(np.stack([c for c, _ in built]))
    pays = np.stack([p for _, p in built])
    rx = RxPipeline(spec)
    cpu = rx.rx_capture(caps, max_frames=5)
    policy.reset_launches()
    gpu = rx.rx_capture(caps.to(dev), max_frames=5)
    torch.cuda.synchronize()
    launched = policy.launches()
    assert launched["fir_bf16"] == 1 and launched["fir"] == 0, launched
    for k in ("crc_ok", "valid", "d", "det_sat"):
        assert torch.equal(gpu[k].cpu(), cpu[k]), k
    assert np.array_equal(gpu["payload"][:, :3].cpu().numpy(), pays)
    assert (gpu["eps"].cpu() - cpu["eps"]).abs().max() <= 1e-4


@pytest.mark.parametrize("l", [32, 128, 512, 2048, 4096])
def test_scfront_kernel_close(dev, l):
    x = torch.randn((3, 50000), dtype=torch.complex64, generator=_gen(l),
                    device=dev)
    x[1, 10000:30000] = 0                        # idle stretch: M = 0
    policy.reset_launches()
    p, m = scfront.sc_frontend(x, l)
    got = policy.launches()
    if l <= sync.TILE_MAX_L:
        assert got["scfront"] == 1 and got["sc_span"] == 0
    else:                                        # the split route
        assert got["scfront"] == 0
        assert got["sc_span"] == got["sc_stride"] == 1
    p0, m0 = scfront.sc_frontend_plain(x, l)
    assert (m - m0).abs().max() <= 1e-5
    _within(p, p0)
    assert bool((m[1, 10000:30000 - 2 * l + 1] == 0).all())


@pytest.mark.parametrize("name", ["c1", "c3", "c4"])
def test_detect_frames_kernel_route_exact(dev, name):
    """detect_frames through the hand kernels equals its plain_versions()
    run (l = 32, 128 and 512)."""
    from ofdm_uhd_tpu_torch.bench_lib import build_capture
    from ofdm_uhd_tpu_torch.phy import agc, sync
    from ofdm_uhd_tpu_torch.pipeline import rx as rxp
    spec = config(name)
    if name == "c4":
        spec = spec.with_(n_data_syms=2)
    cfo = 0.8 / spec.resample_l
    caps = np.stack([build_capture(spec, 4, 300, seed=s, cfo=cfo,
                                   device=dev)[0] for s in range(2)])
    cap = torch.from_numpy(caps).to(dev)
    cap = agc.agc_normalize(rxp._capture_to_baseband(spec, cap))[0]
    got = sync.detect_frames(spec, cap, 6)
    with policy.plain_versions():
        want = sync.detect_frames(spec, cap, 6)
    for k in (0, 2, 3):                          # d, valid, det_sat
        assert torch.equal(got[k], want[k]), k
    assert (got[1] - want[1]).abs().max() <= 1e-6   # eps
    assert int(got[2].sum()) == 8


def test_c4_slice_on_card_matches_cpu(dev):
    from ofdm_uhd_tpu_torch.bench_lib import build_capture
    from ofdm_uhd_tpu_torch.pipeline import RxPipeline
    spec = config("c4").with_(n_data_syms=2)
    built = [build_capture(spec, 3, 300, seed=s, cfo=0.1,
                           phase_noise_std=0.0, device=dev) for s in range(2)]
    caps = torch.from_numpy(np.stack([c for c, _ in built]))
    pays = np.stack([p for _, p in built])
    rx = RxPipeline(spec)
    cpu = rx.rx_capture(caps, max_frames=5)
    policy.reset_launches()
    gpu = rx.rx_capture(caps.to(dev), max_frames=5)
    torch.cuda.synchronize()
    launched = policy.launches()
    assert all(launched[k] > 0 for k in C3_PATH + ("fir",)), launched
    for k in ("crc_ok", "valid", "d", "det_sat"):
        assert torch.equal(gpu[k].cpu(), cpu[k]), k
    assert np.array_equal(gpu["payload"][:, :3].cpu().numpy(), pays)
    assert (gpu["eps"].cpu() - cpu["eps"]).abs().max() <= 1e-4


def test_stream_on_card_matches_plain_forced(dev):
    """A C5 StreamRx on the card (kernel_backend 'auto', 34 slots a step:
    K4w at 256/64) gives the frames and state of its plain-forced run."""
    from ofdm_uhd_tpu_torch.bench_lib import build_capture
    from ofdm_uhd_tpu_torch.pipeline import StreamRx
    spec = config("c5").with_(kernel_backend="auto")
    cap, pays = build_capture(spec, 40, 300, seed=2, phase_noise_std=0.0,
                              device=dev)
    runs = []
    for plain in (False, True):
        rx = StreamRx(spec, chunk_len=129024, steps_per_dispatch=2,
                      device=dev)
        policy.reset_launches()
        if plain:
            with policy.plain_versions():
                frames = rx.process(cap) + rx.flush()
        else:
            frames = rx.process(cap) + rx.flush()
        runs.append((frames, rx, policy.launches()))
    (got, rx, launched), (want, rx_p, plain) = runs
    assert launched["viterbi_windowed"] > 0 and launched["viterbi"] == 0
    assert all(launched[k] > 0 for k in ("scfront", "localize", "extract",
                                         "fft"))
    assert sum(plain.values()) == 0
    assert [g.start for g in got] == [w.start for w in want]
    assert len(got) == 40 and all(g.crc_ok for g in got)
    for g, w, p in zip(got, want, pays):
        assert np.array_equal(g.payload, w.payload)
        assert np.array_equal(g.payload, p)
    for f in ("steps", "frames", "crc_ok", "track_wt"):
        assert int(getattr(rx.state, f)) == int(getattr(rx_p.state, f)), f


@pytest.mark.parametrize("name", ["c2", "c3"])
def test_pallas_slice_on_card_matches_cpu(dev, name):
    """The kernel_backend='pallas' route on the card (K5 on TX and RX; K9
    at C2, K6 at C3) equals the CPU's plain versions."""
    from ofdm_uhd_tpu_torch.bench_lib import build_capture, to_sc16
    from ofdm_uhd_tpu_torch.pipeline import RxPipeline
    spec = config(name).with_(kernel_backend="pallas")
    policy.reset_launches()
    built = [build_capture(spec, 3, 300, seed=s, device=dev)
             for s in range(2)]
    assert policy.launches()["ifftcp"] == 2
    iq = torch.from_numpy(to_sc16(np.stack([c for c, _ in built])))
    pays = np.stack([p for _, p in built])
    rx = RxPipeline(spec)
    cpu = rx.rx_capture_sc16(iq, max_frames=5)
    policy.reset_launches()
    gpu = rx.rx_capture_sc16(iq.to(dev), max_frames=5)
    torch.cuda.synchronize()
    launched = policy.launches()
    sc = "sccorr" if name == "c2" else "scfront"
    vit = "viterbi" if name == "c2" else "viterbi_windowed"
    path = (sc, "localize", "extract", "cpfft", vit)
    assert all(launched[k] > 0 for k in path), launched
    assert sum(launched.values()) == sum(launched[k] for k in path)
    for k in ("crc_ok", "valid", "d", "det_sat"):
        assert torch.equal(gpu[k].cpu(), cpu[k]), k
    assert torch.equal(gpu["payload"].cpu()[cpu["valid"]],
                       cpu["payload"][cpu["valid"]])
    assert np.array_equal(gpu["payload"][:, :3].cpu().numpy(), pays)
    assert (gpu["eps"].cpu() - cpu["eps"]).abs().max() <= 1e-4


def _halo_rows(devices, cb, h, seed):
    """Per-device shard rows [n, cb + h]: random blocks, zero halos; the
    same rows for the kernel and for its plain version."""
    from collections import Counter
    g = torch.Generator().manual_seed(seed)
    runs = []
    for d, n in Counter(devices).items():
        e = torch.zeros((n, cb + h), dtype=torch.complex64)
        e[:, :cb] = torch.randn((n, cb), dtype=torch.complex64, generator=g)
        runs.append(e.to(d))
    return runs, [e.clone() for e in runs]


@pytest.mark.parametrize("cb,h", [(300, 128), (301, 128), (1001, 77),
                                  (1032192, 4288)])
def test_halo_kernel_exact(dev, cb, h):
    """K10 with 4 shards on one card: one launch fills the halos of
    shards 0-2 with the next shard's head (16-byte copies; 8-byte ones
    where h or the row is odd), exactly as the plain version."""
    from ofdm_uhd_tpu_torch.kernels import halo
    ext_k, ext_p = _halo_rows([dev] * 4, cb, h, seed=cb)
    policy.reset_launches()
    halo.halo_from_right(ext_k, cb, h)
    assert policy.launches()["halo"] == 1
    halo.halo_plain(ext_p, cb, h)
    torch.cuda.synchronize()
    assert torch.equal(torch.view_as_real(ext_k[0]),
                       torch.view_as_real(ext_p[0]))
    assert torch.equal(ext_k[0][:3, cb:], ext_k[0][1:, :h])
    assert not ext_k[0][3, cb:].any()            # the last shard's: the caller's


def test_halo_kernel_peer_exact(dev):
    """K10 across two cards: the last shard of cuda:0 reads cuda:1's first
    head by peer access (one launch per destination card)."""
    from ofdm_uhd_tpu_torch.kernels import halo
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards for the peer read")
    devs = [torch.device("cuda", 0)] * 2 + [torch.device("cuda", 1)] * 2
    ext_k, ext_p = _halo_rows(devs, 5000, 4288, seed=1)
    policy.reset_launches()
    halo.halo_from_right(ext_k, 5000, 4288)
    assert policy.launches()["halo"] == 2
    halo.halo_plain(ext_p, 5000, 4288)
    for k, p in zip(ext_k, ext_p):
        assert torch.equal(torch.view_as_real(k.cpu()),
                           torch.view_as_real(p.cpu()))


def test_halo_exchange_reuses_its_setup(dev):
    """The stream step's exchange over fixed buffers: the setup built at
    the first launch serves every later one, as the buffers are written
    anew (one launch each, equal to the plain version every time)."""
    from ofdm_uhd_tpu_torch.kernels import halo
    devs = [dev] * 4
    if torch.cuda.device_count() >= 2:
        devs = [torch.device("cuda", 0)] * 2 + [torch.device("cuda", 1)] * 2
    ext_k, ext_p = _halo_rows(devs, 1001, 77, seed=3)
    exchange = halo.HaloExchange(ext_k, 1001, 77)
    policy.reset_launches()
    for step in range(3):
        for k, p in zip(ext_k, ext_p):
            fresh = torch.randn(k[:, :1001].shape, dtype=torch.complex64,
                                device=k.device)
            k[:, :1001].copy_(fresh)
            p[:, :1001].copy_(fresh)
        exchange()
        plan = exchange._plan
        halo.halo_plain(ext_p, 1001, 77)
        for k, p in zip(ext_k, ext_p):
            assert torch.equal(torch.view_as_real(k.cpu()),
                               torch.view_as_real(p.cpu()))
    assert exchange._plan is plan
    assert policy.launches()["halo"] == 3 * len(plan)


def test_halo_rejects_bad_input(dev):
    from ofdm_uhd_tpu_torch.kernels import halo
    with pytest.raises(ValueError):
        halo.halo_from_right([torch.zeros((4, 300), device=dev)], 200, 100)
    with pytest.raises(ValueError):
        halo.halo_from_right([torch.zeros((4, 299), dtype=torch.complex64,
                                          device=dev)], 200, 100)
    with pytest.raises(ValueError):
        halo.halo_from_right([torch.zeros((65, 300), dtype=torch.complex64,
                                          device=dev)], 200, 100)


@pytest.mark.parametrize("kw", [{"pallas_halo": True}, {"reshard": True}])
def test_sharded_stream_on_card_matches_cpu(dev, kw):
    """A C5 stream over 4 shards on the card (K10 for the halos, or the
    slot reshard) gives the frames and counters of the same mesh on the
    CPU's plain versions."""
    from ofdm_uhd_tpu_torch.bench_lib import build_capture
    from ofdm_uhd_tpu_torch.pipeline import StreamRx
    from ofdm_uhd_tpu_torch.shard import make_mesh
    spec = config("c5").with_(kernel_backend="auto")
    cap, pays = build_capture(spec, 30, 300, seed=3, phase_noise_std=0.0,
                              device=dev)
    runs = []
    for d in (dev, torch.device("cpu")):
        rx = StreamRx(spec, mesh=make_mesh(1, 4, [d] * 4),
                      chunk_len=4 * 16128, steps_per_dispatch=2, **kw)
        policy.reset_launches()
        frames = rx.process(cap) + rx.flush()
        runs.append((frames, rx, policy.launches()))
    (got, rx, launched), (want, rx_c, plain) = runs
    path = ("scfront", "localize", "extract", "fft", "viterbi_windowed")
    assert all(launched[k] > 0 for k in path), launched
    assert (launched["halo"] > 0) == bool(kw.get("pallas_halo"))
    assert sum(plain.values()) == 0
    assert [g.start for g in got] == [w.start for w in want]
    assert len(got) == 30 and all(g.crc_ok for g in got)
    for g, w, p in zip(got, want, pays):
        assert np.array_equal(g.payload, w.payload)
        assert np.array_equal(g.payload, p)
        assert abs(g.eps - w.eps) <= 1e-4
    for f in ("steps", "frames", "crc_ok", "track_wt"):
        assert int(getattr(rx.state, f)) == int(getattr(rx_c.state, f)), f


def test_frame_and_stage_axes_on_card_match_cpu(dev):
    """rx_frames_sharded over a (4, 1) mesh and rx_aligned_pipelined over
    a 2-stage mesh, both on one card, equal rx_aligned on the CPU."""
    from ofdm_uhd_tpu_torch.pipeline import RxPipeline, TxPipeline
    from ofdm_uhd_tpu_torch.shard import make_mesh, rx_frames_sharded
    from ofdm_uhd_tpu_torch.shard.mesh import make_stage_mesh
    from ofdm_uhd_tpu_torch.shard.stage_pipeline import rx_aligned_pipelined
    spec = config("c2")
    g = torch.Generator().manual_seed(5)
    pays = torch.randint(0, 2, (16, spec.payload_bits_per_frame),
                         generator=g, dtype=torch.uint8)
    frames = TxPipeline(spec)(pays)
    frames = frames + 0.05 * torch.randn(frames.shape, dtype=torch.complex64,
                                         generator=g)
    want = RxPipeline(spec).rx_aligned(frames)
    fp = rx_frames_sharded(spec, make_mesh(4, 1, [dev] * 4))(frames.to(dev))
    pp = rx_aligned_pipelined(spec, make_stage_mesh(2, [dev] * 2), 4)(
        frames.to(dev))
    for got in (fp, pp):
        for k in ("payload", "crc_ok"):
            assert torch.equal(got[k].cpu(), want[k]), k
        assert (got["evm_db"].cpu() - want["evm_db"]).abs().max() <= 0.01
    assert torch.equal(fp["payload"].cpu(), pays)
    assert int(fp["n_ok_global"]) == 16


@pytest.mark.parametrize("kw", [{"pallas_halo": True}, {"reshard": True}])
def test_sharded_stream_across_cards_matches_cpu(dev, kw):
    """4 shards over two cards (2 each): the halo of shard 1 crosses from
    cuda:1 to cuda:0 (K10's peer read, or the ppermute copy), the sums,
    the gathers and the reshard's slot transpose cross the cards; the
    frames and counters equal the same mesh on the CPU."""
    from ofdm_uhd_tpu_torch.bench_lib import build_capture
    from ofdm_uhd_tpu_torch.pipeline import StreamRx
    from ofdm_uhd_tpu_torch.shard import make_mesh
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    spec = config("c5").with_(kernel_backend="auto")
    cap, pays = build_capture(spec, 30, 300, seed=4, phase_noise_std=0.0,
                              device=dev)
    cards = [torch.device("cuda", i) for i in (0, 0, 1, 1)]
    runs = []
    for devices in (cards, ["cpu"] * 4):
        rx = StreamRx(spec, mesh=make_mesh(1, 4, devices),
                      chunk_len=4 * 16128, steps_per_dispatch=2, **kw)
        policy.reset_launches()
        frames = rx.process(cap) + rx.flush()
        torch.cuda.synchronize()
        runs.append((frames, rx, policy.launches()))
    (got, rx, launched), (want, rx_c, _) = runs
    # K10: one launch per card per step
    assert launched["halo"] == (2 * rx._steps if kw.get("pallas_halo")
                                else 0)
    assert [g.start for g in got] == [w.start for w in want]
    assert len(got) == 30 and all(g.crc_ok for g in got)
    for g, w, p in zip(got, want, pays):
        assert np.array_equal(g.payload, w.payload)
        assert np.array_equal(g.payload, p)
    for f in ("steps", "frames", "crc_ok", "track_wt"):
        assert int(getattr(rx.state, f)) == int(getattr(rx_c.state, f)), f


# ---- the shifted-FMA tier (K11, csrc/shift.cu; research/shift.py) ----

def _taps(kind, factor=8):
    return resample_filter(factor, 1) if kind == "proto" else [0.25, 0.5,
                                                               0.25]


@pytest.mark.parametrize("kind", ["proto", "3tap"])
@pytest.mark.parametrize("shape", [(5000,), (3, 4500), (2, 9000),
                                   (3, 20011)])
def test_shift_fir_kernel_close(dev, shape, kind):
    """The 'same' FIR at 193 and 3 taps on rows that cut a 1280-output tile
    and its halo, within 1e-5 of max|y|; rows never leak."""
    taps = _taps(kind)
    x = torch.randn(shape, dtype=torch.complex64, generator=_gen(shape[-1]),
                    device=dev)
    policy.reset_launches()
    got = shift.fir_shift(x, taps)
    assert policy.launches()["shift_fir"] == 1
    assert policy.launches()["fir"] == 0
    _within(got, fir.decim_plain(x, 1, taps))
    if x.dim() == 2:
        one = shift.fir_shift(x[1:2].contiguous(), taps)
        assert torch.equal(one[0], got[1])


@pytest.mark.parametrize("kind", ["proto", "3tap"])
@pytest.mark.parametrize("m", [2, 8])
@pytest.mark.parametrize("shape", [(9000,), (5, 16384), (3, 20011)])
def test_shift_decim_kernel_close(dev, m, shape, kind):
    taps = _taps(kind, m)
    x = torch.randn(shape, dtype=torch.complex64,
                    generator=_gen(m + shape[-1]), device=dev)
    policy.reset_launches()
    got = shift.polyphase_decim_shift(x, m, taps)
    assert policy.launches()["shift_decim"] == 1
    assert got.shape == shape[:-1] + (shape[-1] // m,)
    _within(got, fir.decim_plain(x, m, taps))
    if x.dim() == 2:
        one = shift.polyphase_decim_shift(x[1:2].contiguous(), m, taps)
        assert torch.equal(one[0], got[1])


@pytest.mark.parametrize("kind", ["proto", "3tap"])
@pytest.mark.parametrize("l", [2, 8])
@pytest.mark.parametrize("shape", [(3000,), (6, 2100), (2, 4500)])
def test_shift_interp_kernel_close(dev, l, shape, kind):
    taps = _taps(kind, l)
    x = torch.randn(shape, dtype=torch.complex64,
                    generator=_gen(l + shape[-1]), device=dev)
    policy.reset_launches()
    got = shift.polyphase_interp_shift(x, l, taps)
    assert policy.launches()["shift_interp"] == 1
    assert got.shape == shape[:-1] + (shape[-1] * l,)
    _within(got, fir.interp_plain(x, l, taps))


@pytest.mark.parametrize("l,shape", [(32, (9000,)), (128, (20480,)),
                                     (32, (3, 6000))])
def test_shift_sc_kernel_close(dev, l, shape):
    """sc_correlate_shift on K9's kernel, counted as shift_sc: P within
    1e-5 of max|P|, R within 1e-5 relative."""
    x = torch.randn(shape, dtype=torch.complex64, generator=_gen(l),
                    device=dev)
    policy.reset_launches()
    p, rr = shift.sc_correlate_shift(x, l)
    assert policy.launches()["shift_sc"] == 1
    assert policy.launches()["sccorr"] == 0
    p0, rr0 = sync.sc_correlate_plain(x, l)
    _within(p, p0)
    assert float(((rr - rr0).abs() / rr0.abs().clamp_min(1e-30)).max()) \
        <= 1e-5


def test_shift_kernels_at_c4_shapes(dev):
    """C4's decimation input [8, 4,138,472] by 8 and its TX interpolation
    [32, 16128] by 8, against the plain versions and the exact K7 kernels
    on the same inputs."""
    taps = resample_filter(8, 1)
    x = torch.randn((8, 4_138_472), dtype=torch.complex64, generator=_gen(4),
                    device=dev)
    got = shift.polyphase_decim_shift(x, 8, taps)
    _within(got, fir.decim_plain(x, 8, taps))
    _within(got, fir.polyphase_decim(x, 8, taps))
    b = torch.randn((32, 16128), dtype=torch.complex64, generator=_gen(5),
                    device=dev)
    got = shift.polyphase_interp_shift(b, 8, taps)
    _within(got, fir.interp_plain(b, 8, taps))
    _within(got, fir.polyphase_interp(b, 8, taps))


def test_shift_rejects_bad_input(dev):
    taps = [0.25, 0.5, 0.25]
    c = torch.zeros((2, 1000), dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError):
        shift.fir_shift(torch.zeros((2, 100), device=dev), taps)
    with pytest.raises(ValueError):
        shift.polyphase_decim_shift(c[:, ::2], 2, taps)     # not contiguous
    with pytest.raises(ValueError):
        shift.polyphase_decim_shift(c, 0, taps)
    with pytest.raises(ValueError):
        shift.polyphase_interp_shift(c, 0, taps)
    with pytest.raises(ValueError):
        shift.sc_correlate_shift(c, 48)                      # not 2^k
    with pytest.raises(RuntimeError):                        # shared memory
        shift.polyphase_decim_shift(c, 64, np.ones(4096, np.float32))


def test_cfar_on_card_matches_cpu(dev):
    """The CFAR threshold on the card (one sort of every metric row) gives
    the CPU run's thresholds to the bit and its slots."""
    from ofdm_uhd_tpu_torch.bench_lib import build_capture, to_sc16
    from ofdm_uhd_tpu_torch.phy import sync as psync
    from ofdm_uhd_tpu_torch.pipeline import RxPipeline
    spec = config("c3")
    iq = torch.from_numpy(to_sc16(np.stack(
        [build_capture(spec, 3, 300, seed=s, device=dev)[0]
         for s in range(2)])))
    rx = RxPipeline(spec, sync_threshold_mode="cfar")
    cpu = rx.rx_capture_sc16(iq, max_frames=5)
    gpu = rx.rx_capture_sc16(iq.to(dev), max_frames=5)
    for k in ("d", "valid", "crc_ok"):
        assert torch.equal(gpu[k].cpu(), cpu[k]), k
    m = torch.rand((3, 100_000), generator=_gen(6), device=dev) ** 3
    assert torch.equal(psync.cfar_threshold(m, 0.5, 16.0).cpu(),
                       psync.cfar_threshold(m.cpu(), 0.5, 16.0))


# ---- the banded tier (K8, kernels/banded.py) and the interleaved tier
# (K13, research/fir_ilv.py) on csrc/banded.cu; the deframer (K12) ----

@pytest.mark.parametrize("kind", ["proto", "3tap"])
@pytest.mark.parametrize("shape", [(1003,), (3, 1000), (2, 9001),
                                   (2, 2, 4096)])
def test_banded_and_ilv_fir_kernels_close(dev, shape, kind):
    """The 'same' FIR on K8's planes and on K13's interleaved rows, within
    1e-5 of max|y| of the exact float32 plain version (3xTF32 on the tensor
    cores); rows never leak."""
    taps = _taps(kind)
    x = torch.randn(shape, dtype=torch.complex64, generator=_gen(shape[-1]),
                    device=dev)
    want = fir.decim_plain(x, 1, taps)
    policy.reset_launches()
    got_b = banded.fir_banded(x, taps)
    got_i = fir_ilv.fir_ilv(x, taps)
    launched = policy.launches()
    assert launched["banded_fir"] == 1 and launched["ilv_fir"] == 1
    assert sum(launched.values()) == 2
    _within(got_b, want)
    _within(got_i, want)
    if x.dim() == 2:
        one = fir_ilv.fir_ilv(x[1:2].contiguous(), taps)
        assert torch.equal(one[0], got_i[1])


@pytest.mark.parametrize("kind", ["proto", "3tap"])
@pytest.mark.parametrize("m", [2, 8])
@pytest.mark.parametrize("shape", [(1003,), (5, 16384), (3, 20011)])
def test_banded_and_ilv_decim_kernels_close(dev, m, shape, kind):
    """K8 keeps ceil(n/m) outputs of the full-rate FIR, K13 n // m."""
    taps = _taps(kind, m)
    x = torch.randn(shape, dtype=torch.complex64,
                    generator=_gen(m + shape[-1]), device=dev)
    policy.reset_launches()
    got_b = banded.polyphase_decim_banded(x, m, taps)
    got_i = fir_ilv.polyphase_decim_ilv(x, m, taps)
    assert policy.launches()["banded_decim"] == 1
    assert policy.launches()["ilv_decim"] == 1
    assert got_b.shape == shape[:-1] + (-(-shape[-1] // m),)
    assert got_i.shape == shape[:-1] + (shape[-1] // m,)
    _within(got_b, banded.decim_banded_plain(x, m, taps))
    _within(got_i, fir.decim_plain(x, m, taps))


@pytest.mark.parametrize("kind", ["proto", "3tap"])
@pytest.mark.parametrize("l", [2, 3, 8, 12])
@pytest.mark.parametrize("shape", [(3000,), (6, 2100), (2, 4500)])
def test_banded_and_ilv_interp_kernels_close(dev, l, shape, kind):
    taps = _taps(kind, l)
    x = torch.randn(shape, dtype=torch.complex64,
                    generator=_gen(l + shape[-1]), device=dev)
    want = fir.interp_plain(x, l, taps)
    policy.reset_launches()
    got_b = banded.polyphase_interp_banded(x, l, taps)
    got_i = fir_ilv.polyphase_interp_ilv(x, l, taps)
    assert policy.launches()["banded_interp"] == 1
    assert policy.launches()["ilv_interp"] == 1
    assert got_b.shape == got_i.shape == shape[:-1] + (shape[-1] * l,)
    _within(got_b, want)
    _within(got_i, want)


@pytest.mark.parametrize("kind,f,shape", [
    ("fir", 1, (1003,)), ("fir", 1, (3, 9001)), ("decim", 8, (5, 16384)),
    ("decim", 2, (3, 20011)), ("interp", 8, (6, 2100)),
    ("interp", 2, (3000,))])
def test_ilv_default_kernels_close(dev, kind, f, shape):
    """K13 at precision='default' launches the bf16 tier's kernels, once,
    counted as ilv_*_bf16, within 1e-5 of max|y| of the bf16 plain
    versions; 'highest' stays on the banded kernels."""
    taps = _taps("proto", max(f, 8))
    x = torch.randn(shape, dtype=torch.complex64,
                    generator=_gen(f + shape[-1]), device=dev)
    fn, plain = {
        "fir": (lambda p: fir_ilv.fir_ilv(x, taps, precision=p),
                lambda: fir.decim_plain_bf16(x, 1, taps)),
        "decim": (lambda p: fir_ilv.polyphase_decim_ilv(x, f, taps,
                                                        precision=p),
                  lambda: fir.decim_plain_bf16(x, f, taps)),
        "interp": (lambda p: fir_ilv.polyphase_interp_ilv(x, f, taps,
                                                          precision=p),
                   lambda: fir.interp_plain_bf16(x, f, taps))}[kind]
    policy.reset_launches()
    got = fn("default")
    assert policy.launches()[f"ilv_{kind}_bf16"] == 1
    assert sum(policy.launches().values()) == 1
    _within(got, plain())
    policy.reset_launches()
    fn("highest")
    assert policy.launches()[f"ilv_{kind}"] == 1


@pytest.mark.parametrize("l,shape", [(32, (9000,)), (128, (20480,)),
                                     (48, (3, 6000)), (512, (2, 40000)),
                                     (1, (3, 6001)), (700, (2, 2500)),
                                     (300, (1001,))])
def test_banded_sc_kernel_close(dev, l, shape):
    """K8's S&C window sums in one launch from r: P within 1e-5 of max|P|,
    R within 1e-5 relative, against the direct window sums; at l = 1 (two
    samples a window of R) and at l > n / 4 (a halo of 2l beside few
    outputs)."""
    x = torch.randn(shape, dtype=torch.complex64, generator=_gen(l),
                    device=dev)
    policy.reset_launches()
    p, rr = banded.sc_correlate_banded(x, l)
    assert policy.launches()["banded_sc"] == 1
    assert sum(policy.launches().values()) == 1
    p0, rr0 = banded.sc_correlate_banded_plain(x, l)
    _within(p, p0)
    assert float(((rr - rr0).abs() / rr0.abs().clamp_min(1e-30)).max()) \
        <= 1e-5


def test_banded_kernels_at_c4_shapes(dev):
    """C4's decimation input [8, 4,138,472] by 8 and its TX interpolation
    [32, 16128] by 8 on both entries, against the plain versions."""
    taps = resample_filter(8, 1)
    x = torch.randn((8, 4_138_472), dtype=torch.complex64, generator=_gen(4),
                    device=dev)
    want = fir.decim_plain(x, 8, taps)
    _within(fir_ilv.polyphase_decim_ilv(x, 8, taps), want)
    _within(banded.polyphase_decim_banded(x, 8, taps), want)
    b = torch.randn((32, 16128), dtype=torch.complex64, generator=_gen(5),
                    device=dev)
    want = fir.interp_plain(b, 8, taps)
    _within(fir_ilv.polyphase_interp_ilv(b, 8, taps), want)
    _within(banded.polyphase_interp_banded(b, 8, taps), want)


def test_banded_rejects_bad_input(dev):
    taps = [0.25, 0.5, 0.25]
    c = torch.zeros((2, 1000), dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError):
        fir_ilv.fir_ilv(torch.zeros((2, 100), device=dev), taps)
    with pytest.raises(ValueError):
        fir_ilv.polyphase_decim_ilv(c[:, ::2], 2, taps)     # not contiguous
    with pytest.raises(ValueError):
        banded.polyphase_decim_banded(c, 0, taps)
    with pytest.raises(ValueError):
        fir_ilv.polyphase_interp_ilv(c, 0, taps)
    with pytest.raises(ValueError):
        banded.sc_correlate_banded(c, 600)                   # 2l > n
    with pytest.raises(ValueError):                          # no such tier
        fir_ilv.fir_ilv(c, taps, precision="high")
    with pytest.raises(RuntimeError):                        # shared memory
        fir_ilv.polyphase_decim_ilv(c, 64, np.ones(4096, np.float32))


@pytest.mark.parametrize("frame_len", [1, 2, 37, 4032, 4097, 9001])
@pytest.mark.parametrize("offset", [0, 1])
def test_deframe_kernel_exact(dev, frame_len, offset):
    """K12 bit-exact against its plain version: odd and even offsets, odd
    frame lengths, frames that need two and three 32 KB chunks, a capture
    whose rows start 8 bytes off a 16-byte boundary (`offset`: a view one
    sample into its buffer), negative offsets (zeros) and offsets past n;
    equal to K2 on offsets in [0, n]."""
    n = 20011
    buf = torch.randn((3, n + offset), dtype=torch.complex64,
                      generator=_gen(frame_len), device=dev)
    cap = buf.reshape(-1)[offset: offset + 3 * n].reshape(3, n)
    g = torch.Generator().manual_seed(frame_len)
    ds = torch.randint(-frame_len - 300, n + 50, (3, 40), generator=g,
                       dtype=torch.int32)
    ds[:, :6] = torch.tensor([0, 1, n - frame_len, n - 1, n, -1])
    ds = ds.to(dev)
    policy.reset_launches()
    got = deframe.extract_frames_dma(cap, ds, frame_len)
    assert policy.launches()["deframe"] == 1
    assert sum(policy.launches().values()) == 1
    want = deframe.deframe_plain(cap, ds, frame_len)
    assert torch.equal(torch.view_as_real(got), torch.view_as_real(want))
    inside = ds >= 0
    k2 = extract.extract_frames(cap, ds, frame_len)
    assert torch.equal(got[inside], k2[inside])
    assert not got[~inside].abs().any()
    one = deframe.extract_frames_dma(cap[1].contiguous(), ds[1], frame_len)
    assert torch.equal(one, got[1])


def test_deframe_at_c3_shapes(dev):
    """C3's extraction: 8 captures x 1026 slots of 4032 samples."""
    spec = config("c3")
    n = 4_436_068
    cap = torch.randn((8, n), dtype=torch.complex64, generator=_gen(8),
                      device=dev)
    ds = torch.randint(-10, n, (8, 1026), generator=_gen(9), device=dev,
                       dtype=torch.int32)
    got = deframe.extract_frames_dma(cap, ds, spec.frame_len)
    want = deframe.deframe_plain(cap, ds, spec.frame_len)
    assert torch.equal(torch.view_as_real(got), torch.view_as_real(want))
