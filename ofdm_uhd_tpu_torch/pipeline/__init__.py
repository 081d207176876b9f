from .rx import RxPipeline
from .tx import TxPipeline

__all__ = ["RxPipeline", "TxPipeline"]
