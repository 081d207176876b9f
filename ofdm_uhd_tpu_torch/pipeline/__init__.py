from .rx import RxPipeline
from .stream import StreamFrame, StreamRx
from .tx import TxPipeline

__all__ = ["RxPipeline", "StreamFrame", "StreamRx", "TxPipeline"]
