"""The SVGP serving handle (``serve.SVGPRegressor``) on the CPU: against the
benchmark's plain float64 reference (``portbench/reference/svgp_serve.py``)
and against ``infer/svgp.py::svgp_predict``, through ``serve_fused``,
``throughput`` and a stand-in graph capture, with its spans, the
benchmark's faults, and the kin40k SVGP runner that scores through it; and
the route of ``svgp_predict_batch`` between the CUDA kernel of
``ops/svgp_var.py`` and its plain version: every call the CPU can make
takes the plain version, with today's answers bit for bit, and the
kernel's wrapper refuses what the kernel does not take.

Seeded problem: M = 40 inducing inputs and B = 4,096 request rows in 4-D
(standard normal), θ = softplus⁻¹ of (0.6, 1.3, 0.9, 1.6, 1.1) (κ(Kuu) ≈
6e2–2e3 at the jitter 1e-8 over seeds 5–12), a random whitened mean
m̃ ~ N(0, I) and a random lower-triangular Ã (N(0, 0.2²) below the
diagonal, diagonal in [0.05, 1]).

Tolerances, each beside its reason:
- float64 against the reference: 1e-12 of the mean's scale |K|ᵀ|α| and of
  σ² for the variance. The reference writes the same arithmetic out in
  plain torch; a different order of operations would leave ~κ(Kuu)·ε ≈
  5e-13. Measured 0 (seeds 5–12);
- float32 against the reference: the mean to 1e-5 of its scale and the
  variance to 2e-4 of σ², the benchmark cell's limits. Float32 rounding of
  the Gram, carried through the solve against Lu and the sums whose terms
  cancel in the variance, reads ≤ 1.2e-7 and ≤ 3.5e-6 (seeds 5–12);
- the float64 handle against ``svgp_predict``: bit for bit (one function,
  the same factors);
- the float32 handle against ``svgp_predict`` in float64: as against the
  reference.
"""

import dataclasses
import importlib.util
import math
from pathlib import Path

import pytest
import torch

from gaussianprocessnode_tpu_torch import serve
from gaussianprocessnode_tpu_torch.config import JITTER_KUU
from gaussianprocessnode_tpu_torch.infer import svgp
from gaussianprocessnode_tpu_torch.ops import svgp_var
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel, invsoftplus
from gaussianprocessnode_tpu_torch.ops.linalg import tri_solve_lower
from gaussianprocessnode_tpu_torch.utils import tracing
from portbench.drivers import svgp_serve as driver
from portbench.reference import svgp_serve as reference

F64, F32 = torch.float64, torch.float32
M, B, D = 40, 4096, 4
KERNEL = Kernel("se", transform="softplus", use_kernel=True)
SP = (0.6, 1.3, 0.9, 1.6, 1.1)
TOL = {F64: (1e-12, 1e-12), F32: (1e-5, 2e-4)}  # (mean / scale, var / σ²)

ROOT = Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("serve_graphs", ROOT / "test_torch_serve_graphs.py")
serve_graphs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(serve_graphs)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads would only contend with the
    other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed=5, raw_tril=True):
    """(params, Xu, X): float64 ``SVGPParams``, float32-valued Xu and X."""
    g = torch.Generator().manual_seed(seed)
    Xu = torch.randn(M, D, generator=g).double()
    X = torch.randn(B, D, generator=g).double()
    theta = invsoftplus(torch.tensor(SP, dtype=F64))
    m = torch.randn(M, generator=g, dtype=F64)
    A = 0.2 * torch.tril(torch.randn(M, M, generator=g, dtype=F64), -1)
    diag = 0.05 + 0.95 * torch.rand(M, generator=g, dtype=F64)
    A = A + torch.diag(diag if raw_tril else invsoftplus(diag))
    return svgp.SVGPParams(theta, m, A, torch.tensor(math.log(0.01), dtype=F64)), Xu, X


def _gaps(mean, var, ref):
    mean_r, var_r, scale = ref
    return (float((mean.double() - mean_r).abs().max() / scale.max()),
            float((var.double() - var_r).abs().max()) / SP[0])


@pytest.mark.parametrize("dtype", [F64, F32], ids=["float64", "float32"])
def test_handle_matches_the_plain_reference(dtype):
    params, Xu, X = _problem()
    h = serve.SVGPRegressor.from_params(KERNEL, params, Xu.to(dtype), dtype=dtype,
                                        device="cpu", raw_tril=True)
    Lu = reference.factor(SP[0], torch.tensor(SP[1:], dtype=F64), Xu, JITTER_KUU)
    ref = reference.predict(SP[0], torch.tensor(SP[1:], dtype=F64), Xu, X, Lu,
                            params.m_white, params.A_raw)
    mean, var = h(X)
    assert mean.dtype == var.dtype == dtype and mean.shape == var.shape == (B,)
    gm, gv = _gaps(mean, var, ref)
    assert gm <= TOL[dtype][0] and gv <= TOL[dtype][1], (gm, gv)
    assert float(var.min()) >= 1e-12


@pytest.mark.parametrize("raw_tril", [False, True])
def test_float64_handle_is_svgp_predict_bit_for_bit(raw_tril):
    params, Xu, X = _problem(6, raw_tril)
    h = serve.SVGPRegressor.from_params(KERNEL, params, Xu, device="cpu", raw_tril=raw_tril)
    want = svgp.svgp_predict(KERNEL, params, Xu, X, raw_tril=raw_tril)
    for got in (h(X), h(X)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_float32_handle_meets_svgp_predict_to_rounding():
    params, Xu, X = _problem(7, raw_tril=False)
    h = serve.SVGPRegressor.from_params(KERNEL, params, Xu.float(), dtype=F32, device="cpu")
    assert all(t.dtype == F32 for t in (h.theta, h.Xu, h.Lu, h.m_white, h.A))
    mean_r, var_r = svgp.svgp_predict(KERNEL, params, Xu, X)
    Lu, _ = svgp.svgp_factors(KERNEL, params, Xu)
    alpha = torch.linalg.solve_triangular(Lu.T, params.m_white[:, None], upper=True)[:, 0]
    scale = KERNEL(params.theta, Xu, X).abs().T @ alpha.abs()
    gm, gv = _gaps(*h(X.float()), (mean_r, var_r, scale))
    assert gm <= TOL[F32][0] and gv <= TOL[F32][1], (gm, gv)


def test_the_factors_are_formed_once_in_float64():
    params, Xu, _ = _problem(8)
    h = serve.SVGPRegressor.from_params(KERNEL, params, Xu.float(), dtype=F32, device="cpu",
                                        jitter=1e-6, raw_tril=True)
    Lu, A = svgp.svgp_factors(KERNEL, params, Xu, jitter=1e-6, raw_tril=True)
    assert torch.equal(h.Lu, Lu.float()) and torch.equal(h.A, A.float())
    assert torch.equal(h.m_white, params.m_white.float())
    assert torch.equal(h.theta, params.theta.float())


def test_serve_fused_and_throughput_on_the_handle():
    params, Xu, X = _problem(9)
    h = serve.SVGPRegressor.from_params(KERNEL, params, Xu.float(), dtype=F32, device="cpu",
                                        raw_tril=True)
    batches = X.float()[:3 * 512].reshape(3, 512, D)
    means, vars_ = serve.serve_fused(h, batches)
    assert means.shape == vars_.shape == (3, 512)
    for i in range(3):
        m, v = h(batches[i])
        assert torch.equal(means[i], m) and torch.equal(vars_[i], v)
    assert serve.throughput(h, batches[0], iters=2) > 0
    assert serve.throughput_fused(h, batches[0], n_batches=2, iters=1) > 0


@pytest.mark.parametrize("fault", sorted(driver.FAULTS))
def test_each_fault_changes_the_answers(fault):
    params, Xu, X = _problem(10)
    h = serve.SVGPRegressor.from_params(KERNEL, params, Xu.float(), dtype=F32, device="cpu",
                                        raw_tril=True)
    sound = h(X.float())
    with driver.FAULTS[fault]():
        planted = h(X.float())
    assert not all(torch.equal(a, b) for a, b in zip(sound, planted))
    assert all(torch.equal(a, b) for a, b in zip(sound, h(X.float())))
    if fault == "variance_term_dropped":
        assert torch.equal(planted[0], sound[0]) and bool((planted[1] < sound[1]).all())


def test_the_handle_through_the_stand_in_capture_answers_as_eagerly(monkeypatch):
    """The handle's own call path under ``test_torch_serve_graphs``'s
    stand-in capture: replays answer as the eager call, and a function
    patched into ``serve`` after the capture is not hidden by the graph."""
    StandIn = serve_graphs.StandIn
    StandIn.made = []
    before = dict(serve.graph_counts)
    params, Xu, X = _problem(11)
    h = serve.SVGPRegressor.from_params(KERNEL, params, Xu.float(), dtype=F32, device="cpu",
                                        raw_tril=True)
    object.__setattr__(h, "_graphs", serve.GraphCache(capture=StandIn,
                                                      graphable=serve_graphs._admit))
    try:
        outs = [h(X.float()) for _ in range(3)]
        assert len(StandIn.made) == 1
        assert all(torch.equal(a, b) for out in outs for a, b in zip(out, outs[0]))
        orig = serve.svgp_predict_batch
        monkeypatch.setattr(serve, "svgp_predict_batch",
                            lambda *args: tuple(o + 1.0 for o in orig(*args)))
        assert torch.equal(h(X.float())[0], outs[0][0] + 1.0)
        assert len(StandIn.made) == 1  # the patched function's first call is eager
        monkeypatch.undo()
        assert torch.equal(h(X.float())[1], outs[0][1])
    finally:
        serve.graph_counts.update(before)
    fresh = dataclasses.replace(h)
    assert fresh._graphs is not h._graphs and not fresh._graphs.states


def test_spans_of_set_up_and_of_a_call():
    params, Xu, X = _problem(12)
    tracing.start()
    try:
        h = serve.SVGPRegressor.from_params(KERNEL, params, Xu.float(), dtype=F32,
                                            device="cpu", raw_tril=True)
        h(X.float())
    finally:
        tracing.stop()
    recorded = tracing.spans()
    roots = [s.name for s in recorded if s.parent is None]
    assert roots == ["serve.from_svgp", "serve.predict"]
    call = next(i for i, s in enumerate(recorded) if s.name == "serve.predict")
    kids = [s.name for s in recorded if s.parent == call]
    assert [k for k in kids if k.startswith("svgp.")] == ["svgp.solve", "svgp.var"]
    assert kids.index("se_gram.dispatch") < kids.index("svgp.solve")
    tracing.start()
    tracing.stop()


def test_the_kin40k_svgp_runner_scores_through_the_handle(monkeypatch):
    """``run_kin40k`` serves its test rows through ``SVGPRegressor`` in
    float64: its SMSE is ``svgp_predict``'s on the same trained state."""
    from gaussianprocessnode_tpu_torch.experiments import vsgp_baselines as vb
    from gaussianprocessnode_tpu_torch.utils.metrics import smse

    trained, calls = {}, []
    fit = vb.fit_svgp

    def keep(*args, **kwargs):
        trained["params"] = fit(*args, **kwargs)
        trained["Xu"] = args[2]
        return trained["params"]

    monkeypatch.setattr(vb, "fit_svgp", keep)
    monkeypatch.setattr(serve.SVGPRegressor, "__call__",
                        lambda self, X, _orig=serve.SVGPRegressor.__call__: (
                            calls.append(X.shape), _orig(self, X))[1])
    out = vb.run_kin40k(epochs=1, m_inducing=16, batch=2500, device="cpu")
    assert calls == [(30_000, 8)]
    ds = vb.kin40k_runner.load_data("synthetic", 1, 30_000)
    X_test = torch.as_tensor(ds.x_test, dtype=F64)
    mean, _ = svgp.svgp_predict(vb.KERNEL, trained["params"], trained["Xu"], X_test)
    assert out["smse"] == float(smse(torch.as_tensor(ds.y_test), mean))


def test_serve_spans_reads_the_stages_of_the_eager_call_and_the_capture():
    """``scripts/serve_spans.py``'s ``svgp_stages``: the eager call's and
    the capture's ``svgp.solve`` and ``svgp.var`` self times (the plain
    route) or ``svgp.fused`` (the kernel's route), apart; a replay records
    none."""
    from gaussianprocessnode_tpu_torch.utils.tracing import Span

    spec = importlib.util.spec_from_file_location("serve_spans",
                                                  ROOT.parent / "scripts" / "serve_spans.py")
    serve_spans = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(serve_spans)

    def span(name, t0, t1, parent=None):
        s = Span(name, t0, parent, 0)
        s.end_ns = t1
        return s

    program = [span("serve.predict", 0, 100), span("svgp.solve", 10, 40, 0),
               span("svgp.var", 50, 90, 0), span("kernel.params", 60, 70, 2),
               span("serve.predict", 200, 300), span("serve.capture", 200, 290, 4),
               span("svgp.solve", 210, 220, 5), span("svgp.var", 230, 236, 5),
               span("serve.predict", 400, 410), span("serve.replay", 400, 409, 8)]
    assert serve_spans.svgp_stages(program) == {
        "eager": {"svgp.solve": {"n": 1, "self_us": 0.03},
                  "svgp.var": {"n": 1, "self_us": 0.03}},
        "capture": {"svgp.solve": {"n": 1, "self_us": 0.01},
                    "svgp.var": {"n": 1, "self_us": 0.006}}}
    replayed = [span("serve.predict", 400, 410), span("serve.replay", 400, 409, 0)]
    assert serve_spans.svgp_stages(replayed) == {}
    assert "serve.from_svgp" in serve_spans.SETUP_SPANS
    fused = [span("serve.predict", 0, 100), span("se_gram.dispatch", 5, 20, 0),
             span("svgp.fused", 30, 50, 0),
             span("serve.predict", 200, 300), span("serve.capture", 200, 290, 3),
             span("svgp.fused", 210, 214, 4), span("serve.predict", 400, 410),
             span("serve.replay", 400, 409, 6)]
    assert serve_spans.svgp_stages(fused) == {
        "eager": {"svgp.fused": {"n": 1, "self_us": 0.02}},
        "capture": {"svgp.fused": {"n": 1, "self_us": 0.004}}}


def _todays_predict_batch(kernel, theta, Xu, X, Lu, m_white, A):
    """``svgp_predict_batch`` as it was before the kernel's route: the
    answers the plain route must keep."""
    Kux = kernel(theta, Xu, X)
    Akx = tri_solve_lower(Lu, Kux)
    kxx = kernel.diag(theta, X)
    mean = Akx.T @ m_white
    SAk = A.T @ Akx
    var = kxx - torch.sum(Akx * Akx, dim=0) + torch.sum(SAk * SAk, dim=0)
    return mean, torch.maximum(var, var.new_full((), 1e-12))


def _operands(device, dtype, Mi, Bi=100, lu_dtype=None):
    """(Kux, Lu, A, m̃, k(x, x)) as metadata only: fake tensors, which may
    claim a CUDA card on a machine with none (the route reads no data)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        def t(*shape, dt=dtype):
            return torch.empty(shape, device=device, dtype=dt)

        return (t(Mi, Bi), t(Mi, Mi, dt=lu_dtype or dtype), t(Mi, Mi), t(Mi), t(Bi))


@pytest.mark.parametrize("device, dtype, grad, M, want", [
    ("cuda", F32, False, 512, "kernel"),
    ("cuda:0", F32, False, svgp_var.SVGP_VAR_MAX_M, "kernel"),
    ("cpu", F32, False, 512, "plain"),
    ("cuda", F64, False, 512, "plain"),
    ("cuda", F32, True, 512, "plain"),
    ("cuda", F32, False, svgp_var.SVGP_VAR_MAX_M + 1, "plain"),
    ("meta", F32, False, 512, "plain"),
])
def test_the_route_is_chosen_from_what_the_call_can_observe(device, dtype, grad, M, want):
    """Float32 operands on a CUDA card with gradients off and M within the
    kernel's maximum go to the kernel; the CPU, float64, a call with
    gradients on (the trainers' ELBO) and a larger M keep the plain
    version. Deciding reads no card."""
    with torch.set_grad_enabled(grad):
        assert svgp_var.svgp_var_route(*_operands(device, dtype, M)) == want


@pytest.mark.parametrize("which", range(5))
def test_an_operand_in_another_dtype_takes_the_plain_route(which):
    """The route reads the dtype of every operand the kernel would read, not
    of the rows alone: float32 rows against float64 factors (``svgp_predict``
    with float64 parameters) keep the plain version, which answers them, and
    never reach the kernel's float32 check."""
    ops = list(_operands("cuda", F32, 64))
    ops[which] = _operands("cuda", F64, 64)[which]
    with torch.no_grad():
        assert svgp_var.svgp_var_route(*_operands("cuda", F32, 64)) == "kernel"
        assert svgp_var.svgp_var_route(*ops) == "plain"


@pytest.mark.parametrize("dtype, grad, m_inducing", [
    (F32, False, M), (F64, False, M), (F64, True, M), (F32, True, M),
    (F32, False, svgp_var.SVGP_VAR_MAX_M + 1),
], ids=["cpu-float32", "float64", "float64-grad", "float32-grad", "M-above-the-maximum"])
def test_the_plain_route_keeps_todays_answers_and_spans(dtype, grad, m_inducing):
    """CPU tensors, float64, a call with gradients on and M above the
    kernel's maximum each take the plain version: bit for bit the answers
    of the code before the kernel's route, with its spans ``svgp.solve``
    and ``svgp.var`` and no ``svgp.fused``; with gradients on, the answers
    carry a graph back to θ, m̃ and Ã."""
    g = torch.Generator().manual_seed(13)
    Mi, Bi = m_inducing, (64 if m_inducing > M else B)
    Xu = torch.randn(Mi, D, generator=g, dtype=dtype)
    X = torch.randn(Bi, D, generator=g, dtype=dtype)
    theta = invsoftplus(torch.tensor(SP, dtype=dtype))
    Lu = torch.linalg.cholesky(KERNEL.kuu(theta, Xu, jitter=1e-4))
    m = torch.randn(Mi, generator=g, dtype=dtype)
    A = torch.tril(0.2 * torch.randn(Mi, Mi, generator=g, dtype=dtype), -1) + torch.eye(Mi, dtype=dtype)
    want = _todays_predict_batch(KERNEL, theta, Xu, X, Lu, m, A)
    with torch.set_grad_enabled(grad):
        leaves = [t.detach().requires_grad_(grad) for t in (theta, m, A)]
        tracing.start()
        try:
            got = svgp.svgp_predict_batch(KERNEL, leaves[0], Xu, X, Lu, leaves[1], leaves[2])
        finally:
            tracing.stop()
    assert all(torch.equal(a.detach(), b) for a, b in zip(got, want))
    names = [s.name for s in tracing.spans() if s.name.startswith("svgp.")]
    assert names == ["svgp.solve", "svgp.var"]
    if grad:
        assert all(t.grad is None for t in leaves)
        torch.autograd.grad(got[0].sum() + got[1].sum(), leaves)
    else:
        assert not got[0].requires_grad and not got[1].requires_grad


def test_the_kernel_wrapper_takes_the_plain_version_for_cpu_tensors_only():
    """``svgp_var_cuda`` gives the kernel or an error: on CPU tensors, as on
    a device with no kernel, it raises before a launch rather than falling
    back (``svgp_var_route`` sends such calls to the plain version before
    the call)."""
    g = torch.Generator().manual_seed(14)
    Kux = torch.rand(M, 300, generator=g)
    Lu = torch.tril(torch.rand(M, M, generator=g)) + M * torch.eye(M)
    A = torch.tril(torch.rand(M, M, generator=g))
    m, kxx = torch.randn(M, generator=g), torch.full((300,), 2.0)
    launches = svgp_var.svgp_var_cuda.launches
    for device in ("cpu", "meta"):
        with pytest.raises(ValueError, match=f"no kernel for device {device}"):
            svgp_var.svgp_var_cuda(*(t.to(device) for t in (Kux, Lu, A, m, kxx)))
    assert svgp_var.svgp_var_cuda.launches == launches


def _wrapper_inputs(Mi=M, Bi=100, dtype=F32):
    return [torch.zeros(Mi, Bi, dtype=dtype), torch.eye(Mi, dtype=dtype),
            torch.eye(Mi, dtype=dtype), torch.zeros(Mi, dtype=dtype),
            torch.ones(Bi, dtype=dtype)]


@pytest.mark.parametrize("fault, error, match", [
    ("Lu float64", TypeError, "Lu is torch.float64"),
    ("Kux float64", TypeError, "Kux is torch.float64"),
    ("kxx float16", TypeError, "kxx is torch.float16"),
    ("Kux transposed", ValueError, "Kux must be contiguous"),
    ("A strided", ValueError, "A must be contiguous"),
    ("Lu strided", ValueError, "Lu must be contiguous"),
    ("m_white too long", ValueError, "m_white"),
    ("kxx too short", ValueError, "kxx"),
    ("Lu not square", ValueError, "Lu"),
    ("Kux one-dimensional", ValueError, "must be"),
    ("M above the maximum", ValueError, "outside 1..1024"),
    ("not a tensor", TypeError, "must be a tensor"),
])
def test_the_kernel_wrapper_refuses_what_the_kernel_does_not_take(fault, error, match):
    """The checks ``svgp_var_cuda`` makes on CUDA tensors before a launch
    raise on a wrong dtype, layout or shape, so such a call fails instead
    of falling back (held here on CPU tensors: the checks read no card)."""
    Kux, Lu, A, m, kxx = _wrapper_inputs()
    if fault == "Lu float64":
        Lu = Lu.double()
    elif fault == "Kux float64":
        Kux = Kux.double()
    elif fault == "kxx float16":
        kxx = kxx.half()
    elif fault == "Kux transposed":
        Kux = torch.zeros(100, M).T
    elif fault == "A strided":
        A = torch.zeros(M, 2 * M)[:, ::2]
    elif fault == "Lu strided":
        Lu = torch.zeros(2 * M, M)[::2]
    elif fault == "m_white too long":
        m = torch.zeros(M + 1)
    elif fault == "kxx too short":
        kxx = torch.ones(99)
    elif fault == "Lu not square":
        Lu = torch.zeros(M, M + 1)
    elif fault == "Kux one-dimensional":
        Kux = torch.zeros(M)
    elif fault == "M above the maximum":
        Kux, Lu, A, m, kxx = _wrapper_inputs(svgp_var.SVGP_VAR_MAX_M + 1, 8)
    elif fault == "not a tensor":
        m = [0.0] * M
    with pytest.raises(error, match=match):
        svgp_var._check(Kux, Lu, A, m, kxx)
    svgp_var._check(*_wrapper_inputs())
    # Lu and Ã may be column-major, as torch.linalg.cholesky's factor is on a card
    Kux, Lu, A, m, kxx = _wrapper_inputs()
    svgp_var._check(Kux, torch.zeros(M, M).T, torch.zeros(M, M).T, m, kxx)
    assert svgp_var._column_major(torch.zeros(M, M).T)
    assert not svgp_var._column_major(torch.zeros(M, M))
    assert not svgp_var._column_major(torch.zeros(1, 1).T)


@pytest.mark.parametrize("Mi", [1, 30, 32, 66, 512, 1022])
@pytest.mark.parametrize("given", ["row-major", "column-major"])
@pytest.mark.parametrize("column_major", [True, False], ids=["Lu", "A"])
def test_the_factors_are_laid_out_as_the_kernels_tensor_maps_read_them(Mi, given, column_major):
    """``_laid_out`` gives Lu column-major and Ã row-major, ld floats from
    one column (row) to the next with ld a multiple of 4, and the same
    values; it hands back the tensor itself where it already lies so (the
    card's Cholesky factor and Ã at M % 4 = 0), and copies only the other
    layout or a ragged M, into ld = M rounded up to a multiple of 4."""
    g = torch.Generator().manual_seed(Mi)
    t = torch.randn(Mi, Mi, generator=g)
    if given == "column-major":
        t = t.T.contiguous().T
    got, ld = svgp_var._laid_out(t, column_major)
    assert torch.equal(got, t) and ld % 4 == 0 and ld >= Mi
    rows = got.mT if column_major else got
    assert rows.stride() == (ld, 1) and got.data_ptr() % 16 == 0
    in_place = Mi % 4 == 0 and Mi > 1 and (given == "column-major") == column_major
    assert (got.data_ptr() == t.data_ptr()) == in_place
    assert ld == (Mi if in_place else -(-Mi // 4) * 4)
