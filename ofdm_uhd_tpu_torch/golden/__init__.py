"""The float64 NumPy golden oracle: a copy of the reference's golden/
package. The host tables are derived from its helpers, and GoldenModem,
the single-stream CPU chain, is the accuracy oracle and the yardstick a
card's throughput is divided by."""

from .chain import GoldenModem, RxFrameResult

__all__ = ["GoldenModem", "RxFrameResult"]
