"""The SVGP serving cell's counts and readers: the call's FLOPs at the
cell's shape, the variance stage's bound, and the three per-layer metrics
from a synthetic run."""

from types import SimpleNamespace

import pytest

from portbench import manifest as mf, peaks, svgp_counts
from portbench.trace import Trace

H100 = peaks.for_card("NVIDIA H100 80GB HBM3")
M, B, D = 512, 262144, 8


def reader(name):
    return mf.metric_reader(name).read


def test_counts_at_the_cells_shape():
    per = svgp_counts.flops_per_prediction(M, D)
    assert per == M * (2 * D + 5) + 2 * D + 2 * M * M + 4 * M + 2 + 2 * M
    assert per * B == pytest.approx(1.41e11, rel=1e-2)
    # the variance stage is bound by its FLOPs, ~2.06 ms at 67 TFLOP/s
    assert svgp_counts.var_flops(M, B) / H100["fp32_flop_per_s"] > \
        svgp_counts.var_bytes(M, B) / H100["hbm_bytes_per_s"]
    assert svgp_counts.var_least_seconds(M, B, H100) * 1e3 == pytest.approx(2.0593, abs=1e-4)


def _run(trace, counters=None):
    return SimpleNamespace(trace=trace, peaks=H100 if trace else None,
                           shapes={"M": M, "B": B, "D": D},
                           trace_work={"calls": 10, "predictions": 10 * B} if trace else {},
                           work={"seconds": 1.0, "calls": 400,
                                 "counters": counters or {"se_gram_launches": 400}})


def test_readers_return_nothing_without_what_they_read():
    for name in ("mfu.svgp_serve", "var_roofline.svgp_serve", "graph_replay_share.svgp_serve"):
        assert reader(name)(_run(None)) is None, name


def test_readers_from_a_synthetic_run():
    least = svgp_counts.var_least_seconds(M, B, H100)
    # 10 calls: a Gram of 0.3 ms, then 4·least of other work, each call
    ops = []
    for k in range(10):
        t = 0.1 * k
        ops += [("se_gram_kernel", t, t + 3e-4), ("trsm", t + 3e-4, t + 3e-4 + 4 * least)]
    trace = Trace((0.0, 1.0), ops, [])
    run = _run(trace, {"se_gram_launches": 400, "graph_replays": 398})
    assert reader("var_roofline.svgp_serve")(run) == pytest.approx(25.0)
    flops = svgp_counts.flops_per_prediction(M, D) * 10 * B
    assert reader("mfu.svgp_serve")(run) == pytest.approx(100 * flops / 67e12)
    assert reader("graph_replay_share.svgp_serve")(run) == pytest.approx(99.5)
