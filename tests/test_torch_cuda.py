"""The hand-written CUDA kernels against their plain PyTorch versions, on
an NVIDIA GPU (sm_90a). Every test here needs the card and skips without
one. On a machine with a card and without JAX, run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(--noconftest: the repository's tests/conftest.py imports JAX)."""

import numpy as np
import pytest
import torch

from ofdm_uhd_tpu_torch.core.spec import config
from ofdm_uhd_tpu_torch.kernels import extract, fft, localize, policy, viterbi

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def _coded_llrs(bsz, n, snr_db, dev, seed):
    from ofdm_uhd_tpu_torch.phy import bits
    g = torch.Generator().manual_seed(seed)
    info = torch.randint(0, 2, (bsz, n), generator=g, dtype=torch.uint8)
    info[:, -6:] = 0
    coded = bits.conv_encode(info).float()
    sigma = 10 ** (-snr_db / 20)
    y = 1.0 - 2.0 * coded + sigma * torch.randn(coded.shape, generator=g)
    return (2 * y / sigma**2).to(dev), info


@pytest.mark.parametrize("bsz,n", [(1, 7), (5, 100), (37, 6912)])
def test_viterbi_kernel_exact(dev, bsz, n):
    llr, info = _coded_llrs(bsz, n, 5.0, dev, seed=n)
    policy.reset_launches()
    got = viterbi.viterbi(llr)
    assert policy.launches()["viterbi"] == 1
    assert torch.equal(got, viterbi.viterbi_plain(llr))
    rnd = torch.randn((bsz, 2 * n), generator=_gen(n), device=dev) * 3
    assert torch.equal(viterbi.viterbi(rnd), viterbi.viterbi_plain(rnd))
    ties = torch.randint(-2, 3, (bsz, 2 * n), generator=_gen(n + 1),
                         device=dev).float()
    assert torch.equal(viterbi.viterbi(ties), viterbi.viterbi_plain(ties))


@pytest.mark.parametrize("n", [64, 256, 1024, 2048])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_kernel_close(dev, n, inverse):
    x = torch.randn((77, n), dtype=torch.complex64, generator=_gen(n),
                    device=dev)
    f = fft.ifft if inverse else fft.fft
    got = f(x)
    ref = fft.fft_plain(x, inverse=inverse)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_localize_kernel_exact(dev):
    spec = config("c3")
    g = _gen(3)
    nd = 50000
    m = torch.rand((3, nd), generator=g, device=dev) ** 4
    m[:, 1000:1300] = 0.9
    p = torch.randn((3, nd), dtype=torch.complex64, generator=g, device=dev)
    cand = torch.sort(torch.randint(0, nd, (3, 60), generator=g,
                                    device=dev)).values
    cand[:, -3:] = torch.tensor([990, nd - 50, nd], device=dev)
    cand = cand.to(torch.int32)
    d, eps = localize.localize(m, p, cand, spec.sym_len, spec.cp)
    d_p, eps_p = localize.localize_plain(m, p, cand, spec.sym_len, spec.cp)
    assert torch.equal(d, d_p)
    assert (eps - eps_p).abs().max() <= 1e-6


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
        fft.fft(torch.zeros((2, 48), dtype=torch.complex64, device=dev))
    with pytest.raises(ValueError):
        extract.extract_frames(torch.zeros((1, 100), dtype=torch.complex64,
                                           device=dev),
                               torch.zeros((1, 2), dtype=torch.int64,
                                           device=dev), 10)


def test_slice_on_card_matches_cpu(dev):
    from ofdm_uhd_tpu_torch.bench_lib import build_capture, to_sc16
    from ofdm_uhd_tpu_torch.pipeline import RxPipeline
    spec = config("c3")
    built = [build_capture(spec, 3, 300, seed=s) for s in range(2)]
    iq = torch.from_numpy(to_sc16(np.stack([c for c, _ in built])))
    pays = np.stack([p for _, p in built])
    rx = RxPipeline(spec)
    cpu = rx.rx_capture_sc16(iq, max_frames=5)
    policy.reset_launches()
    gpu = rx.rx_capture_sc16(iq.to(dev), max_frames=5)
    torch.cuda.synchronize()
    assert all(v > 0 for v in policy.launches().values())
    for k in ("crc_ok", "valid", "d", "det_sat"):
        assert torch.equal(gpu[k].cpu(), cpu[k]), k
    assert torch.equal(gpu["payload"].cpu()[cpu["valid"]],
                       cpu["payload"][cpu["valid"]])
    assert np.array_equal(gpu["payload"][:, :3].cpu().numpy(), pays)
    assert (gpu["eps"].cpu() - cpu["eps"]).abs().max() <= 1e-4
