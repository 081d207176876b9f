"""The S&C tile body (csrc/scfront_tile.cuh) built for the host against the
plain C++ doubling, as test_torch_scfront_host.py describes: part 1 of
its cases (scfront_host_harness.TILE_FILES): the slowest (512 lags,
12007 samples, R) and the shortest rows.
"""

import pytest

from . import scfront_host_harness as H
from .scfront_host_harness import sc_host  # noqa: F401


@pytest.mark.parametrize("l,rows,n,metric", H.TILE_FILES[1])
def test_tile_body_equals_plain_doubling(sc_host, l, rows, n, metric):
    H.hold_tile(sc_host, l, rows, n, metric)
