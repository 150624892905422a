"""The metric arithmetic: rates over the window, percentiles over all samples,
idle share from a union of intervals, the Gram's roofline count, TF32
rounding."""

from types import SimpleNamespace

import pytest
import torch

from portbench import counts, manifest as mf, peaks
from portbench.reference.se import round_tf32
from portbench.trace import Trace, busy, gaps, idle_share, label, percentile, union


def reader(name):
    return mf.metric_reader(name).read


def test_rates_are_all_the_work_over_the_window():
    run = SimpleNamespace(work={"seconds": 2.5, "steps": 100, "rows": 1_000_000})
    assert reader("train_rows_per_s")(run) == 400_000.0
    run = SimpleNamespace(work={"seconds": 4.0, "calls": 10, "predictions": 2_621_440})
    assert reader("predictions_per_s")(run) == 655_360.0
    assert reader("train_rows_per_s")(run) is None


def test_p95_is_taken_over_all_samples():
    run = SimpleNamespace(work={"seconds": 1.0, "call_seconds": [i / 1e3 for i in range(1, 201)]})
    assert reader("serve_call_p95_ms")(run) == pytest.approx(190.0)
    assert reader("serve_call_p95_ms")(SimpleNamespace(work={"steps": 3})) is None
    v = list(range(1, 101))
    assert percentile(v, 95) == 95
    assert percentile([3.0], 95) == 3.0
    assert percentile([5, 1, 4, 2, 3], 95) == 5
    assert percentile(list(range(1, 21)), 95) == 19


def test_idle_share_is_one_minus_the_union_of_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert union(iv) == [(0.0, 2.0), (3.0, 4.0)]
    assert busy(iv, 0.0, 5.0) == 3.0
    assert idle_share(iv, 0.0, 5.0) == pytest.approx(0.4)
    assert busy(iv, 1.0, 3.5) == pytest.approx(1.5)
    assert gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]


def test_gaps_take_the_span_that_overlaps_them_most():
    spans = [("call", 0.0, 2.5), ("sync", 2.5, 3.2), ("read", 2.9, 3.0)]
    assert label((2.0, 3.0), spans) == "sync"
    assert label((2.9, 3.0), spans) == "read"
    assert label((9.0, 10.0), spans) == "no span"


def test_trace_readings():
    t = Trace((0.0, 10.0), [("se_gram_kernel(float)", 1.0, 2.0), ("gemv", 2.0, 4.0),
                            ("Memcpy DtoH", 4.0, 4.5)],
              [("serve.call", 0.5, 1.5), ("serve.sync", 1.5, 4.6)])
    assert t.busy_s() == 3.5 and t.idle_share() == pytest.approx(0.65)
    assert t.kernel_time("se_gram") == (1, 1.0)
    assert t.kernel_time() == (2, 3.0)
    assert t.top_ops(1) == [("gemv", 2.0)]
    assert t.idle_gaps(1)[0] == ("serve.sync", 5.5)
    assert t.edges() == (1.0, 5.5)


def test_gram_count_reproduces_the_bytes_bound_at_600x30000x8():
    h100 = peaks.for_card("NVIDIA H100 80GB HBM3")
    assert counts.se_gram_bytes(600, 30000, 8) == 4 * (600 * 8 + 30000 * 8 + 8 + 1 + 600 * 30000)
    assert counts.gram_least_seconds(600, 30000, 8, h100) * 1e3 == pytest.approx(0.02178, abs=5e-6)
    # bound by bytes, not FLOPs, at the serving shape
    assert counts.se_gram_flops(600, 30000, 8) / h100["fp32_flop_per_s"] < \
        counts.se_gram_bytes(600, 30000, 8) / h100["hbm_bytes_per_s"]
    assert peaks.for_card("cpu") is None


def test_step_and_prediction_counts():
    M, N, D = 600, 10000, 8
    f = counts.collapsed_step_flops(M, N, D)
    assert 6 * M * M * N < f < 7 * M * M * N  # dominated by the M²N products
    assert counts.serve_flops_per_prediction(600, 8, False) == 600 * 21 + 16 + 1200
    assert counts.serve_flops_per_prediction(500, 2, True) == 500 * 9 + 4 + 1000 + 6


def test_readers_return_nothing_without_a_trace():
    run = SimpleNamespace(trace=None, peaks=None, enqueue_s=[], trace_work={},
                          shapes={"M": 1, "N": 1, "B": 1, "D": 1}, classifier=False)
    for name in ("device_idle.serve", "device_idle.train", "gram_roofline.serve", "mfu.serve",
                 "mfu.train", "enqueue_us.serve",
                 "step_device_ms.train", "launches_per_step.train"):
        assert reader(name)(run) is None, name


def test_roofline_and_mfu_from_a_trace():
    h100 = peaks.for_card("NVIDIA H100 80GB HBM3")
    least = counts.gram_least_seconds(600, 262144, 8, h100)
    t = Trace((0.0, 1.0), [("se_gram_kernel", 0.0, 2 * least), ("x", 0.5, 0.6)], [])
    run = SimpleNamespace(trace=t, peaks=h100, shapes={"M": 600, "B": 262144, "D": 8},
                          classifier=False, trace_work={"predictions": 262144 * 100})
    assert reader("gram_roofline.serve")(run) == pytest.approx(50.0)
    flops = counts.serve_flops_per_prediction(600, 8, False) * 262144 * 100
    assert reader("mfu.serve")(run) == pytest.approx(100 * flops / 67e12)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, 3.14159265], dtype=torch.float32)
    r = round_tf32(x)
    assert r[0] == 1.0 and r[2] == 1.0 + 2.0 ** -10
    assert r[1] == 1.0 + 2.0 ** -10  # a tie rounds away from zero
    assert abs(float(r[3]) - 3.14159265) <= 2.0 ** -10 * 2
    bits = r.view(torch.int32) & 0x1FFF
    assert torch.all(bits == 0)
