from .models import apply_channel, awgn, cfo_shift, make_capture, multipath, phase_noise

__all__ = ["apply_channel", "awgn", "cfo_shift", "make_capture", "multipath",
           "phase_noise"]
