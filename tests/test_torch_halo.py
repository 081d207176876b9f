"""The halo exchange of the time-sharded stream (K10's plain version, and
the dispatch on CPU tensors) against the reference's remote-DMA halo
kernel, `halo_from_right_pallas` in interpret mode inside shard_map over
a 1-D 'time' mesh of 8 virtual CPU devices (as tests/distributed/
test_pallas_halo.py runs it), and against its ppermute. Exact: a halo is
a copy."""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh, PartitionSpec as P

from ofdm_uhd_tpu.kernels.pallas_halo import halo_from_right_pallas
from ofdm_uhd_tpu_torch.kernels import halo, policy

T = 8


def _blocks(cb, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T * cb,)) + 1j * rng.standard_normal(
        (T * cb,))).astype(np.complex64)


def _reference(x, h, pallas):
    """Every shard's halo [T, h] from the reference (zeros on the last)."""
    mesh = Mesh(np.array(jax.devices()[:T]), ("time",))

    def body(block):
        head = block[:h]
        if pallas:
            return halo_from_right_pallas(head, "time", frame_axis=None,
                                          interpret=True)
        return jax.lax.ppermute(head, "time",
                                [(i, i - 1) for i in range(1, T)])
    out = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("time"),
                                out_specs=P("time"), check_vma=False))(x)
    return np.asarray(out).reshape(T, h)


def _port(x, cb, h, split, fn):
    """The port's exchange on rows [cb + h] split into per-device tensors
    of `split` rows each; -> every shard's halo [T, h]."""
    rows = torch.from_numpy(x).view(T, cb)
    ext, lo = [], 0
    for n in split:
        e = torch.zeros((n, cb + h), dtype=torch.complex64)
        e[:, :cb] = rows[lo:lo + n]
        ext.append(e)
        lo += n
    fn(ext, cb, h)
    return torch.cat(ext)[:, cb:].numpy()


@pytest.mark.parametrize("cb,h", [(128, 128), (300, 128), (8576, 4288)])
@pytest.mark.parametrize("split", [(8,), (3, 5), (1,) * 8])
def test_halo_plain_matches_reference_kernel_and_ppermute(cb, h, split):
    x = _blocks(cb, seed=cb + len(split))
    got = _port(x, cb, h, split, halo.halo_plain)
    for pallas in (True, False):
        want = _reference(x, h, pallas)
        np.testing.assert_array_equal(got[:-1], want[:-1])
    # the last shard's halo is the caller's (the reference returns zeros)
    assert not got[-1].any() and not want[-1].any()
    # and it is the next block's head, sample for sample
    np.testing.assert_array_equal(got[:-1], x.reshape(T, cb)[1:, :h])


def test_halo_dispatch_on_cpu_takes_plain_version():
    x = _blocks(200, seed=1)
    policy.reset_launches()
    got = _port(x, 200, 64, (2, 6), halo.halo_from_right)
    assert policy.launches()["halo"] == 0
    np.testing.assert_array_equal(got, _port(x, 200, 64, (8,),
                                             halo.halo_plain))
