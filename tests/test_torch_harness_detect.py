"""The port's detect_sweep harness against the reference's
(bench/detect_sweep.py) on the same seeds, on the CPU: C1 at 0 and 2 dB
(detection partial under the fixed threshold, frames failing, the TRACK
rescue's stream run at both), 2 trials of 6 frames. Every count equal:
det_rate, fer, fa_per_100k and rescued. The reference's harness reads a
`rescued` attribute of each frame its StreamRx returns, which its
StreamFrame does not have, so its records say 0; the port's records give
the receiver's own count (StreamRx.rescued), held here against the
reference receiver's counter on the same stream."""

import ofdm_uhd_tpu.pipeline.stream as ref_stream

from .torch_harness_ref import run_port, run_reference


def test_detect_sweep_equals_the_reference(tmp_path, monkeypatch):
    counted = []

    class Counted(ref_stream.StreamRx):
        def flush(self):
            out = super().flush()
            counted.append(self.rescued)
            return out
    monkeypatch.setattr(ref_stream, "StreamRx", Counted)
    argv = ["--config", "c1", "--snrs=0,2", "--trials", "2"]
    ref = run_reference("detect_sweep.py", argv, str(tmp_path / "ref.jsonl"))
    got = run_port("detect_sweep", argv, str(tmp_path / "port.jsonl"))
    assert [(r["snr_db"], r["mode"]) for r in got] == \
        [(r["snr_db"], r["mode"]) for r in ref] == [
            (0.0, "fixed"), (0.0, "cfar"), (2.0, "fixed"), (2.0, "cfar")]
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in ("config", "det_rate", "fer", "fa_per_100k"):
            assert g[k] == r[k], (k, g, r)
    assert [r["rescued"] for r in ref] == [None, 0, None, 0]
    assert [g["rescued"] for g in got] == [None, counted[0], None,
                                           counted[1]]
    assert 0 < got[0]["det_rate"] < 1 and 0 < got[2]["fer"] < 1
