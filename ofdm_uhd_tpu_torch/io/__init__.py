from .capture import (CaptureReader, CaptureWriter, SyntheticSource,
                      read_capture, write_capture)

__all__ = ["CaptureReader", "CaptureWriter", "SyntheticSource",
           "read_capture", "write_capture"]
