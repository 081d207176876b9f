"""The bf16 filter tier (kernels/fir.py, filter_precision='bf16') against
the JAX reference.

The reference computes this tier on the TPU's MXU at Precision.DEFAULT:
each product takes bf16-rounded samples and coefficients, and the sums
run in float32. On the CPU its dot ignores the precision and computes
exact float32, so the port's plain versions are held to the reference's
own float32 filters run on bf16-rounded planes and taps (rounded here
with JAX's bf16, round to nearest even), within 1e-5 of max|y| (float32
summation order); the reference's Pallas tier in interpret mode is
within 1e-2 of them, and differs from them by more than 1e-4, which
records that it computed exact.

Routing follows the reference's `choose`: the tier applies only where the
reference would run its MXU kernel. At C4 (L = 8): 'auto' takes it for
the TX interpolation, 'pallas' for both filters, 'xla' for neither. The
chain is gated as the reference gates its bf16 tier
(tests/kernels/test_mxu_fir.py:80-99): every CRC passes, the payloads are
the sent ones, and mean EVM stays under -25 dB.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ofdm_uhd_tpu.core.spec import config as ref_config  # noqa: E402
from ofdm_uhd_tpu.kernels import conv_backend as CB  # noqa: E402
from ofdm_uhd_tpu.kernels import pallas_fir_mxu as PM  # noqa: E402
from ofdm_uhd_tpu.pipeline import RxPipeline as RefRx  # noqa: E402
from ofdm_uhd_tpu.pipeline import TxPipeline as RefTx  # noqa: E402
from ofdm_uhd_tpu_torch.bench_lib import build_capture  # noqa: E402
from ofdm_uhd_tpu_torch.convert import spec_from_reference  # noqa: E402
from ofdm_uhd_tpu_torch.core.spec import config  # noqa: E402
from ofdm_uhd_tpu_torch.kernels import fir as KF  # noqa: E402
from ofdm_uhd_tpu_torch.kernels import policy  # noqa: E402
from ofdm_uhd_tpu_torch.phy.tables import resample_filter  # noqa: E402
from ofdm_uhd_tpu_torch.pipeline import RxPipeline, TxPipeline  # noqa: E402
from ofdm_uhd_tpu_torch.pipeline import rx as port_rx  # noqa: E402

torch.set_num_threads(2)

REL = 1e-5
TAPS3 = np.asarray([0.25, 0.5, 0.25], np.float32)
DEFAULT = jax.lax.Precision.DEFAULT


def _sig(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


def _bf(a):
    """Round float32 values to bf16 (JAX's, nearest even), as float32."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def _bfc(x):
    return (_bf(x.real) + 1j * _bf(x.imag)).astype(np.complex64)


def _within(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err
    return err


def _taps(name, l):
    return resample_filter(l, 1) if name == "proto" else TAPS3


@pytest.mark.parametrize("shape", [(3, 4000), (2, 2, 4003)])
@pytest.mark.parametrize("m", [1, 2, 8])
@pytest.mark.parametrize("taps", ["proto", "3tap"])
def test_plain_bf16_strided_matches_reference_on_rounded_inputs(shape, m,
                                                                taps):
    """decim_plain_bf16 (stride 1: fir_filter's tier) against the
    reference's float32 FIR on bf16-rounded planes and taps; n = 4003 is
    not a multiple of the stride, where the reference's decimation (which
    needs one) is its 'same' FIR at every m-th sample."""
    t = _taps(taps, 8)                  # the C4 prototype: 193 taps
    x = _sig(m + len(shape), shape)
    got = KF.decim_plain_bf16(torch.from_numpy(x), m, t)
    xb, tb = _bfc(x), _bf(t)
    n = shape[-1]
    if m == 1:
        want = CB.fir_same(xb, tb)
    elif n % m:
        want = np.asarray(CB.fir_same(xb, tb))[..., ::m][..., : n // m]
    else:
        want = CB.polyphase_decim_xla(xb, m, tb)
    assert got.shape == shape[:-1] + (n // m,)
    _within(got.numpy(), want)


@pytest.mark.parametrize("shape", [(3, 1500), (2, 2, 1001)])
@pytest.mark.parametrize("l", [2, 3, 8])
@pytest.mark.parametrize("taps", ["proto", "3tap"])
def test_plain_bf16_interp_matches_reference_on_rounded_inputs(shape, l,
                                                               taps):
    """interp_plain_bf16 against the reference's polyphase_interp_xla on
    bf16-rounded planes and taps where L is a power of two (the branch
    matrix scales the taps by L exactly, so rounding first gives the
    rounded branch matrix); at L = 3 against a float64 NumPy model of the
    port's branch matrix rounded to bf16."""
    t = _taps(taps, l)
    x = _sig(l + len(shape), shape)
    got = KF.interp_plain_bf16(torch.from_numpy(x), l, t).numpy()
    xb = _bfc(x)
    if l & (l - 1) == 0:
        want = np.asarray(CB.polyphase_interp_xla(xb, l, _bf(t)))
    else:
        g, d_min, d_max = KF.branch_matrix(t, l)
        gb = _bf(g).astype(np.float64)
        n = shape[-1]
        xp = np.concatenate([np.zeros(shape[:-1] + (d_max,)),
                             xb.astype(np.complex128),
                             np.zeros(shape[:-1] + (-d_min,))], -1)
        want = np.zeros(shape[:-1] + (n, l), np.complex128)
        for j, d in enumerate(range(d_min, d_max + 1)):
            # y[q*l + p] += g[p, d - d_min] * x[q - d]
            want += gb[:, j] * xp[..., d_max - d: d_max - d + n, None]
        want = want.reshape(shape[:-1] + (n * l,))
    assert got.shape == shape[:-1] + (shape[-1] * l,)
    _within(got, want)


@pytest.mark.parametrize("kind", ["fir", "decim", "interp"])
def test_reference_pallas_tier_computes_exact_on_the_cpu(kind):
    """The reference's MXU kernels at Precision.DEFAULT in interpret mode
    agree with the plain bf16 versions within 1e-2 of max|y|, and differ
    from them by more than 1e-4: XLA's CPU dot ignores the precision."""
    t = resample_filter(8, 1)
    x = _sig(11, (2, 5120))
    xt = torch.from_numpy(x)
    if kind == "fir":
        got, want = (KF.decim_plain_bf16(xt, 1, t),
                     PM.fir_mxu_pallas(x, t, precision=DEFAULT))
    elif kind == "decim":
        got, want = (KF.decim_plain_bf16(xt, 8, t),
                     PM.polyphase_decim_mxu_pallas(x, 8, t,
                                                   precision=DEFAULT))
    else:
        got, want = (KF.interp_plain_bf16(xt, 8, t),
                     PM.polyphase_interp_mxu_pallas(x, 8, t,
                                                    precision=DEFAULT))
    err = _within(got.numpy(), want, rel=1e-2)
    assert err > 1e-4 * float(np.abs(np.asarray(want)).max())


def test_precision_argument():
    x = torch.from_numpy(_sig(1, (2, 800)))
    for f in (lambda p: KF.fir_filter(x, TAPS3, precision=p),
              lambda p: KF.polyphase_decim(x, 2, TAPS3, precision=p),
              lambda p: KF.polyphase_interp(x, 2, TAPS3, precision=p)):
        assert not torch.equal(f("bf16"), f("exact"))
        with pytest.raises(ValueError):
            f("high")
    policy.reset_launches()
    KF.polyphase_decim(x, 2, TAPS3, precision="bf16")
    KF.polyphase_interp(x, 2, TAPS3, precision="bf16")
    assert policy.launches() == dict.fromkeys(policy.KERNELS, 0)


# (kernel_backend, filter_precision) -> (TX interpolation, RX decimation)
TIERS = {("auto", "bf16"): ("bf16", "exact"),
         ("pallas", "bf16"): ("bf16", "bf16"),
         ("xla", "bf16"): ("exact", "exact"),
         ("auto", "exact"): ("exact", "exact"),
         ("pallas", "exact"): ("exact", "exact"),
         ("xla", "exact"): ("exact", "exact")}


@pytest.mark.parametrize("backend,precision", sorted(TIERS))
def test_filter_calls_follow_the_reference_routing(backend, precision):
    """Each filter call of TxPipeline and RxPipeline takes the tier of the
    reference's routing, seen in the outputs: bit-equal to the exact plain
    version where the table says exact, to the bf16 one where it says
    bf16."""
    spec = config("c4").with_(n_data_syms=2, kernel_backend=backend,
                              filter_precision=precision)
    tx_tier, rx_tier = TIERS[(backend, precision)]
    taps = resample_filter(8, 1)
    plain = {("interp", "exact"): KF.interp_plain,
             ("interp", "bf16"): KF.interp_plain_bf16,
             ("decim", "exact"): KF.decim_plain,
             ("decim", "bf16"): KF.decim_plain_bf16}
    pays = torch.from_numpy(np.random.default_rng(4).integers(
        0, 2, (2, spec.payload_bits_per_frame)).astype(np.uint8))
    tx = TxPipeline(spec)
    frames = tx(pays)
    base = tx.baseband(pays)
    assert torch.equal(frames, plain[("interp", tx_tier)](base, 8, taps))
    other = "exact" if tx_tier == "bf16" else "bf16"
    assert not torch.equal(frames, plain[("interp", other)](base, 8, taps))
    cap = frames.reshape(1, -1)[:, :-5]          # padded to a multiple of 8
    padded = torch.cat([cap, cap.new_zeros((1, 5))], -1)
    for got, x in ((port_rx._to_baseband(spec, frames), frames),
                   (port_rx._capture_to_baseband(spec, cap), padded)):
        assert torch.equal(got, plain[("decim", rx_tier)](x, 8, taps))
    assert policy.filter_precision(spec, "interp", 8) == tx_tier
    assert policy.filter_precision(spec, "decim", 8) == rx_tier
    # fir_filter's call: the reference's MXU FIR from 64 taps under 'auto'
    fir_tier = precision if backend != "xla" else "exact"
    assert policy.filter_precision(spec, "fir", 193) == fir_tier
    assert policy.filter_precision(spec, "fir", 3) == (
        precision if backend == "pallas" else "exact")


@pytest.fixture(scope="module")
def chain():
    """C4 at 4 data symbols (the reference's gate), two frames from the
    port's TX and from the reference's on the same payloads, and both
    chains' rx_aligned results, for 'pallas' and 'auto' with bf16; the
    reference runs its Pallas tiers in interpret mode."""
    out = {}
    for backend in ("pallas", "auto"):
        rspec = ref_config("c4").with_(n_data_syms=4, kernel_backend=backend,
                                       filter_precision="bf16")
        spec = spec_from_reference(dataclasses.asdict(rspec))
        pays = np.random.default_rng(8).integers(
            0, 2, (2, spec.payload_bits_per_frame)).astype(np.uint8)
        got = RxPipeline(spec).rx_aligned(TxPipeline(spec)(
            torch.from_numpy(pays)))
        want = RefRx(rspec).rx_aligned(np.asarray(RefTx(rspec)(pays)))
        out[backend] = (spec, pays, {k: v.numpy() for k, v in got.items()},
                        {k: np.asarray(v) for k, v in want.items()})
    return out


@pytest.mark.parametrize("backend", ["pallas", "auto"])
def test_c4_bf16_chain_decodes_as_the_reference(chain, backend):
    _, pays, got, want = chain[backend]
    evm, evm_ref = float(got["evm_db"].mean()), float(want["evm_db"].mean())
    msg = f"EVM port {evm:.2f} dB, reference {evm_ref:.2f} dB"
    assert got["crc_ok"].all(), msg
    np.testing.assert_array_equal(got["payload"], pays)
    assert evm < -25.0, msg
    np.testing.assert_array_equal(got["payload"], want["payload"])
    np.testing.assert_array_equal(got["crc_ok"], want["crc_ok"])


def test_c4_bf16_capture_decodes_every_frame(chain):
    """2 captures x 4 frames built by the port's bf16 TX under 'pallas'
    through rx_capture (the bf16 decimation): every frame found and
    decoded bit-exact."""
    spec = chain["pallas"][0]
    built = [build_capture(spec, 4, 300, seed=s, cfo=0.1,
                           phase_noise_std=0.0, device="cpu")
             for s in range(2)]
    caps = torch.from_numpy(np.stack([c for c, _ in built]))
    pays = np.stack([p for _, p in built])
    out = RxPipeline(spec).rx_capture(caps, max_frames=6)
    assert int(out["valid"].sum()) == 8
    assert out["crc_ok"][:, :4].all()
    np.testing.assert_array_equal(out["payload"][:, :4].numpy(), pays)
