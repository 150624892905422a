"""The program's span recorder (``utils/tracing.py``) on the CPU: what the
serving handles record with recording on, that they record nothing and
answer the same with it off, the garbage collector's spans, self times, an
untraced benchmark run, and the arithmetic of ``scripts/serve_spans.py``
that reads the spans."""

import gc
import importlib.util
import json
import time
from pathlib import Path

import pytest
import torch

from gaussianprocessnode_tpu_torch import serve
from gaussianprocessnode_tpu_torch.dists import GammaShapeRate, MvGaussianNat
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
from gaussianprocessnode_tpu_torch.utils import tracing
from gaussianprocessnode_tpu_torch.utils.tracing import Span

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("serve_spans", ROOT / "scripts" / "serve_spans.py")
serve_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(serve_spans)

HEADS = ("regressor", "classifier")
CALL_TREE = ["kernel.params", "se_gram.dispatch", "serve.matvec", "serve.fill"]


def _stopped():
    tracing.stop()
    return tracing.spans()


@pytest.fixture(autouse=True)
def _recorder_off():
    """Every test starts and ends with recording off and an empty store."""
    tracing.start()
    tracing.stop()
    yield
    tracing.stop()


def _handle(head):
    g = torch.Generator().manual_seed(7)
    M, D = 12, 3
    Xu = torch.randn(M, D, generator=g)
    A = torch.randn(M, M, generator=g, dtype=torch.float64)
    nat = MvGaussianNat(torch.randn(M, generator=g, dtype=torch.float64),
                        A @ A.T + M * torch.eye(M, dtype=torch.float64))
    kernel = Kernel("se", transform="softplus", use_kernel=True)
    theta = torch.tensor([0.3, -0.2, 0.1, 0.4])
    if head == "classifier":
        qw = GammaShapeRate(torch.tensor(3.0, dtype=torch.float64),
                            torch.tensor(2.0, dtype=torch.float64))
        h = serve.SGPClassifier.from_natural(kernel, theta, Xu, nat, qw,
                                             dtype=torch.float32, device="cpu")
        return h, h.probabilities, torch.randn(9, D, generator=g)
    w = torch.tensor(4.0, dtype=torch.float64)
    h = serve.SGPRegressor.from_natural(kernel, theta, Xu, nat, w,
                                        dtype=torch.float32, device="cpu")
    return h, h, torch.randn(9, D, generator=g)


def _flat(out):
    return torch.cat([o.reshape(-1) for o in out]) if isinstance(out, tuple) else out


@pytest.mark.parametrize("head", HEADS)
def test_off_records_nothing_and_answers_match_on_bit_for_bit(head):
    _, fn, X = _handle(head)
    off = _flat(fn(X))
    assert tracing.spans() == [] and not tracing.ON
    tracing.start()
    on = _flat(fn(X))
    n = len(_stopped())
    assert n and torch.equal(off, on)
    fn(X)
    assert len(tracing.spans()) == n


@pytest.mark.parametrize("head", HEADS)
def test_on_a_call_records_its_tree_under_one_request(head):
    _, fn, X = _handle(head)
    tracing.start()
    fn(X)
    fn(X)
    recorded = _stopped()
    roots = [i for i, s in enumerate(recorded) if s.parent is None and s.name != "python.gc"]
    assert [recorded[i].name for i in roots] == ["serve.predict"] * 2
    assert len({recorded[i].request for i in roots}) == 2
    want = CALL_TREE + (["probit.phi"] if head == "classifier" else [])
    for i in roots:
        root = recorded[i]
        kids = [s for s in recorded if s.parent == i and s.name != "python.gc"]
        assert [s.name for s in kids] == want
        assert all(s.request == root.request for s in kids)
        assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in kids)
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))


def test_span_times_lie_inside_the_call_on_the_wall_clock():
    _, fn, X = _handle("regressor")
    tracing.start()
    fn(X)
    before = time.time_ns()
    fn(X)
    after = time.time_ns()
    recorded = _stopped()
    request = [s for s in recorded if s.name == "serve.predict"][-1].request
    last = [s for s in recorded if s.request == request and s.name != "python.gc"]
    assert len(last) == 5
    assert all(before <= s.start_ns <= s.end_ns <= after for s in last)


def test_a_collection_while_recording_is_a_span_and_the_hook_goes_with_stop():
    tracing.start()
    assert tracing._on_gc in gc.callbacks
    with tracing.span("outer"):
        gc.collect()
    recorded = _stopped()
    assert tracing._on_gc not in gc.callbacks
    gcs = [s for s in recorded if s.name == "python.gc"]
    assert gcs and gcs[-1].attrs == {"generation": 2}
    outer = recorded[gcs[-1].parent]
    assert outer.name == "outer"
    assert outer.start_ns <= gcs[-1].start_ns <= gcs[-1].end_ns <= outer.end_ns
    gc.collect()
    assert len(tracing.spans()) == len(recorded)


@pytest.mark.parametrize("head", HEADS)
def test_from_natural_records_the_recovery(head):
    tracing.start()
    _handle(head)
    names = [s.name for s in _stopped()]
    assert names.count("serve.from_natural") == 1


def test_self_time_is_never_negative():
    _, fn, X = _handle("classifier")
    tracing.start()
    for _ in range(3):
        fn(X)
    recorded = _stopped()
    selfs = tracing.self_ns(recorded)
    assert min(selfs) >= 0
    # overlapping children, one running past its parent and one still open
    synthetic = [Span("root", 0, None, 0), Span("a", 10, 0, 0), Span("b", 15, 0, 0),
                 Span("c", 90, 0, 0)]
    for s, end in zip(synthetic, (100, 40, 120, None)):
        s.end_ns = end
    assert tracing.self_ns(synthetic) == [10, 30, 105, 0]
    root = [i for i, s in enumerate(recorded) if s.name == "serve.predict"][0]
    kids = sum(s.end_ns - s.start_ns for s in recorded if s.parent == root)
    span = recorded[root].end_ns - recorded[root].start_ns
    assert selfs[root] == span - kids


def test_sites_share_one_context_per_state_and_allocate_nothing():
    off = tracing.span("a")
    assert off is tracing.span("b")
    with tracing.span("a") as sp:
        assert sp is None
    tracing.start()
    on = tracing.span("a")
    assert on is tracing.span("a") and on is not off and on is not tracing.span("b")


def test_traced_keeps_the_function_its_arguments_and_its_answer():
    @tracing.traced("scaled")
    def scaled(x, *, by=2):
        """doc"""
        with tracing.span("inner"):
            return x * by

    assert scaled.__name__ == "scaled" and scaled.__doc__ == "doc"
    assert scaled(3, by=5) == 15 and tracing.spans() == []
    tracing.start()
    assert scaled(3, by=5) == 15
    outer, inner = _stopped()
    assert (outer.name, inner.name, inner.parent) == ("scaled", "inner", 0)


def test_the_library_load_is_a_span_that_says_whether_it_built(monkeypatch, tmp_path):
    from gaussianprocessnode_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    (tmp_path / f"gpn_kernels-{_build._digest(_build._sources())}.so").write_bytes(b"")
    tracing.start()
    with tracing.span("outer"):
        _build.load_library()
        tracing.attrs(note=1)
    _build.load_library()
    outer, load = _stopped()
    assert load.name == "ops.load_library" and load.parent == 0
    assert load.attrs == {"built": False} and outer.attrs == {"note": 1}
    assert outer.start_ns <= load.start_ns <= load.end_ns <= outer.end_ns


def test_a_span_that_raises_is_closed_and_the_next_is_a_root():
    tracing.start()
    with pytest.raises(ValueError):
        with tracing.span("outer"):
            with tracing.span("inner"):
                raise ValueError
    with tracing.span("next"):
        pass
    recorded = _stopped()
    outer, inner, nxt = ([s for s in recorded if s.name == n][0]
                         for n in ("outer", "inner", "next"))
    assert recorded[inner.parent] is outer and inner.end_ns is not None
    assert nxt.parent is None and nxt.request != outer.request


@pytest.mark.parametrize("cell", ["kin40k.serve.b262k", "banana.serve.grid512"])
def test_an_untraced_benchmark_run_records_no_span(cell):
    from portbench.run import run_cell
    from portbench.tests.small import files

    cfg, tr, spec = files(cell)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = run_cell(cell, 2**31 + 7, 0.2, False, device="cpu", cfg=cfg, traffic=tr,
                     spec=spec)
    finally:
        torch.set_num_threads(n)
    assert r["correct"] and r["attempted"] > 0
    assert not tracing.ON and tracing.spans() == []


# --- scripts/serve_spans.py's arithmetic on synthetic spans ------------------------

def _call(request, t0, params=(1, 3), dispatch=(4, 10), fill=(12, 13), end=15):
    """A serve.predict root at t0 (ns) with its children, offsets in ns."""
    root = Span("serve.predict", t0, None, request)
    root.end_ns = t0 + end
    kids = []
    for name, (a, b) in (("kernel.params", params), ("se_gram.dispatch", dispatch),
                         ("serve.matvec", (10, 12)), ("serve.fill", fill)):
        s = Span(name, t0 + a, None, request)
        s.end_ns = t0 + b
        kids.append(s)
    return root, kids


def _store(calls):
    out = []
    for root, kids in calls:
        i = len(out)
        out.append(root)
        for k in kids:
            k.parent = i
            out.append(k)
    return out


def _synthetic():
    """A warm-up call at 0, window calls at 100, 200 (in the sub-window
    [190, 260]), 300; time unit 1 ns."""
    calls = [_call(0, 0), _call(1, 100), _call(2, 200, dispatch=(4, 12)), _call(3, 300,
                                                                             fill=(12, 14))]
    program = _store(calls)
    bench = [("serve.call", t0 - 1, t0 + 16) for t0 in (100, 200, 300)]
    return program, bench, (190, 260)


def test_window_calls_leave_out_the_warmup_and_the_sub_window():
    program, bench, window = _synthetic()
    assert serve_spans.window_calls(program, bench, window) == [1, 3]
    assert serve_spans.window_calls(program, [], window) == []


def test_per_call_means_over_the_window_calls():
    program, bench, window = _synthetic()
    r = serve_spans.per_call(program, serve_spans.window_calls(program, bench, window))
    assert r["n"] == 2
    assert r["predict_host_us"] == pytest.approx(15e-3)
    assert r["gram_dispatch_us"] == pytest.approx(6e-3)
    assert r["params_fill_us"] == pytest.approx((2 + 1.5) * 1e-3)
    assert r["self_us"]["serve.predict"] == pytest.approx((15 - 2 - 6 - 2 - 1.5) * 1e-3)
    assert r["gram_dispatch_us"] + r["params_fill_us"] <= r["predict_host_us"]
    assert serve_spans.per_call(program, []) is None


def test_setup_part_counts_the_spans_before_the_first_window_call():
    program, bench, _ = _synthetic()
    lib = Span("ops.load_library", 5, 0, 0, {"built": False})
    lib.end_ns = 9
    nat = Span("serve.from_natural", -50, None, 9)
    nat.end_ns = -20
    late = Span("serve.from_natural", 400, None, 10)
    late.end_ns = 500
    r = serve_spans.setup_part([nat] + program[:1] + [lib] + program[1:] + [late], bench,
                               t0_ns=-99)
    assert r["ops.load_library"] == pytest.approx(4e-9)
    assert r["serve.from_natural"] == pytest.approx(30e-9)
    assert r["program_setup_s"] == pytest.approx(34e-9)
    assert r["built"] is False and r["warmup_calls"] == 1
    assert r["setup_s"] == pytest.approx(198e-9)
    assert serve_spans.setup_part([], [])["program_setup_s"] == 0


def test_idle_gaps_go_to_the_innermost_span_and_launches_are_counted():
    from portbench.trace import Trace

    program, bench, _ = _synthetic()
    launch = Span("se_gram.launch", 208, 7, 2)
    launch.end_ns = 209
    program.append(launch)
    # the synthetic times are read as ms: program spans scaled to ns, the
    # benchmark's and the device's in seconds
    scaled = []
    for s in program:
        t = Span(s.name, s.start_ns * 10**6, s.parent, s.request, s.attrs)
        t.end_ns = s.end_ns * 10**6
        scaled.append(t)
    trace = Trace((0.19, 0.26), [("k", 0.1995, 0.2045), ("se_gram_kernel", 0.2115, 0.26)],
                  [(n, a * 1e-3, b * 1e-3) for n, a, b in bench])
    r = serve_spans.labelled(trace, scaled)
    labels = dict((round(d, 6), n) for n, d in r["largest"])
    assert labels[0.0095] == "serve.call"      # 0.190–0.1995: the call before its root
    assert labels[0.007] == "se_gram.dispatch"  # 0.2045–0.2115: inside the dispatch
    assert len(r["over_1ms"]) == 2 and r["idle_s"] == pytest.approx(0.0165)
    name, d, within = r["over_1ms"][1]
    assert name == "se_gram.dispatch"
    assert [w[0] for w in within] == ["se_gram.launch", "serve.matvec", "se_gram.dispatch",
                                      "serve.predict"]
    assert [w[1] for w in within] == pytest.approx([0.001, 0.0015, 0.007, 0.007])
    # 0.190–0.199 before any span, 0.199–0.1995 in serve.call; 0.2045–0.2115
    # in the dispatch but for the launch (0.208–0.209) and the mat-vec (0.210–)
    assert r["by_innermost_s"] == pytest.approx({
        "no span": 0.009, "serve.call": 0.0005, "se_gram.dispatch": 0.0045,
        "se_gram.launch": 0.001, "serve.matvec": 0.0015})
    assert serve_spans.launches(trace, scaled) == {"launch_spans": 1, "kernel_records": 1}


def test_gc_during_the_window_and_the_spans_file(tmp_path):
    program, bench, _ = _synthetic()
    early = Span("python.gc", 3, 0, 0, {"generation": 0})
    early.end_ns = 4
    late = Span("python.gc", 305, 13, 3, {"generation": 1})
    late.end_ns = 2_000_305
    program += [early, late]
    assert serve_spans.gc_during(program, bench) == {"1": {"n": 1, "ms": 2.0, "max_ms": 2.0}}
    path = tmp_path / "spans.jsonl"
    serve_spans.write_spans(path, program, bench)
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(rows) == len(program) + len(bench)
    assert rows[1] == {"id": 1, "span": "kernel.params", "start_ns": 1, "end_ns": 3,
                       "parent": 0, "request": 0, "attrs": None}
    assert [r["request"] for r in rows if r["span"] == "serve.call"] == [1, 2, 3]
