"""The serving handles' graph cache (``serve.GraphCache``) and the capture
helper (``ops._build.CallGraph``) on the CPU.

The policy runs without CUDA: a stand-in for the capture (a subclass of
``CallGraph`` with no side stream, whose "graph" reruns the captured call
into its static outputs and, as a replay runs no Python, leaves every
launch counter as it was) keeps the helper's replay path (input copy,
replay, launch accounting, output clones), and a ``graphable`` that admits
CPU tensors lets the cache's key, warm-up, eviction and fallback run here.
The card tests in ``tests/test_torch_gpu.py`` hold real captures to eager
calls.
"""

import contextlib
import dataclasses
import gc
from types import SimpleNamespace

import pytest
import torch

from gaussianprocessnode_tpu_torch import serve
from gaussianprocessnode_tpu_torch.dists import GammaShapeRate, MvGaussianNat
from gaussianprocessnode_tpu_torch.ops import _build
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
from gaussianprocessnode_tpu_torch.utils import tracing

HEADS = ("regressor", "classifier")


class StandIn(_build.CallGraph):
    """A capture on the CPU. ``made`` lists the captures."""

    made = []

    def __init__(self, call, X, warmup=False):
        super().__init__(call, X, warmup)
        StandIn.made.append(self)

    @staticmethod
    def _side_stream(device):
        return contextlib.nullcontext()

    def _capture(self, call):
        out = call(self.x)

        def replay():
            before = {name: w.launches for name, w in _build._counted.items()}
            fresh = call(self.x)
            for name, n in before.items():
                _build._counted[name].launches = n
            for o, f in zip(out if isinstance(out, tuple) else (out,),
                            fresh if isinstance(fresh, tuple) else (fresh,)):
                o.copy_(f)

        self.graph = SimpleNamespace(replay=replay)
        return out


class Raises:
    """A capture that fails as a synchronising operation fails under
    capture."""

    def __init__(self, call, X):
        raise RuntimeError("operation not permitted when stream is capturing")


def _admit(X):
    return not torch.is_grad_enabled()


@pytest.fixture(autouse=True)
def _fresh():
    StandIn.made = []
    before = dict(serve.graph_counts)
    yield
    serve.graph_counts.update(before)


def _delta(before):
    return {k: serve.graph_counts[k] - before[k] for k in before}


def _cache(capture=StandIn):
    return serve.GraphCache(capture=capture, graphable=_admit)


def _double(x):
    return 2.0 * x, x + 1.0


def _run(cache, X, fn=_double):
    with torch.no_grad():
        return cache(fn, fn, X)


def test_first_call_is_eager_the_second_captures_the_third_replays():
    cache, X = _cache(), torch.randn(5, 3)
    before = dict(serve.graph_counts)
    outs = []
    for k in range(3):
        outs.append(_run(cache, X))
        assert len(StandIn.made) == (0 if k == 0 else 1)
    assert _delta(before) == {"captures": 1, "replays": 2, "eager": 1, "fallbacks": 0}
    for out in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out, outs[0]))


@pytest.mark.parametrize("change", ["shape", "dtype", "function"])
def test_a_new_shape_dtype_or_function_captures_again(change):
    cache, X = _cache(), torch.randn(5, 3)
    for _ in range(3):
        _run(cache, X)
    fn = _double
    if change == "shape":
        X = torch.randn(6, 3)
    elif change == "dtype":
        X = X.double()
    else:
        def fn(x):
            return 3.0 * x, x

    first = _run(cache, X, fn)
    assert len(StandIn.made) == 1  # the new key's first call is eager
    second = _run(cache, X, fn)
    assert len(StandIn.made) == 2 and len(cache.graphs) == 2
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert torch.equal(second[0], fn(X)[0])


def test_a_capture_that_raises_leaves_its_key_eager_and_is_counted():
    cache, X = _cache(Raises), torch.randn(4, 2)
    before = dict(serve.graph_counts)
    outs = [_run(cache, X) for _ in range(4)]
    assert _delta(before) == {"captures": 0, "replays": 0, "eager": 4, "fallbacks": 1}
    assert not cache.graphs and list(cache.states.values()) == [serve._EAGER]
    assert all(torch.equal(o[0], 2.0 * X) for o in outs)


def test_the_fifth_key_evicts_the_least_recently_used():
    cache = _cache()
    Xs = [torch.randn(n, 2) for n in range(1, 6)]
    for X in Xs[:4]:
        _run(cache, X)
        _run(cache, X)
    _run(cache, Xs[0])  # the first key becomes the most recently used
    assert len(cache.graphs) == serve.GRAPH_SLOTS == 4
    _run(cache, Xs[4])
    _run(cache, Xs[4])
    shapes = [key[1] for key in cache.graphs]
    assert len(shapes) == 4 and (2, 2) not in shapes and (1, 2) in shapes
    before = len(StandIn.made)
    _run(cache, Xs[1])  # evicted, but warm: captures again at once
    assert len(StandIn.made) == before + 1


def test_cpu_tensors_are_never_captured():
    cache, X = serve.GraphCache(capture=StandIn), torch.randn(5, 3)
    before = dict(serve.graph_counts)
    for _ in range(3):
        _run(cache, X)
    assert not StandIn.made and not cache.states
    assert _delta(before) == {"captures": 0, "replays": 0, "eager": 0, "fallbacks": 0}


def test_calls_with_gradients_on_are_not_graphed():
    cache, X = _cache(), torch.randn(5, 3)
    for _ in range(3):
        cache(_double, _double, X)
    assert not StandIn.made and not cache.states


def test_returned_outputs_never_share_storage_across_calls():
    cache = _cache()
    X1, X2 = torch.randn(5, 3), torch.randn(5, 3)
    outs = [_run(cache, X) for X in (X1, X2, X1, X2)]
    graph = StandIn.made[0]
    ptrs = [o.untyped_storage().data_ptr() for out in outs for o in out]
    ptrs += [o.untyped_storage().data_ptr() for o in graph.out]
    assert len(set(ptrs)) == len(ptrs)
    for out, X in zip(outs, (X1, X2, X1, X2)):
        assert torch.equal(out[0], 2.0 * X) and torch.equal(out[1], X + 1.0)


@pytest.fixture
def kernels(monkeypatch):
    """Two stand-in kernels registered as the library's are: each call
    counts one launch, as a wrapper counts an eager launch."""
    monkeypatch.setattr(_build, "_counted", {})

    def gram(x):
        gram.launches += 1
        return 2.0 * x

    def variance(x):
        variance.launches += 1
        return x + 1.0

    for name, wrapper in (("gram", gram), ("variance", variance)):
        _build.EntryPoint(name, [], wrapper, ("max", 1))
    return gram, variance


def _two_kernels(kernels):
    gram, variance = kernels

    def call(x):
        return gram(x), variance(variance(x))

    return call


def _launched(kernels):
    return [k.launches for k in kernels]


def test_a_replay_adds_its_captured_launches_and_records_its_spans(kernels):
    """Through the cache: the eager call counts its launches, the capture
    adds nothing, each replay adds what its capture queued, kernel by
    kernel, and its ``serve.replay`` span carries those counts."""
    cache, X, call = _cache(), torch.randn(5, 3), _two_kernels(kernels)
    assert _launched(kernels) == [0, 0]
    with torch.no_grad():
        cache(call, call, X)
        assert _launched(kernels) == [1, 2]
        gc.disable()  # a collection would record a python.gc span among them
        tracing.start()
        try:
            outs = [cache(call, call, X) for _ in range(3)]
        finally:
            tracing.stop()
            gc.enable()
    assert _launched(kernels) == [1 + 3, 2 + 6]
    (graph,) = cache.graphs.values()
    assert graph.launches == {"gram": 1, "variance": 2}
    names = [(s.name, s.attrs) for s in tracing.spans()]
    want = {"launches": {"gram": 1, "variance": 2}}
    assert names == [("serve.capture", None)] + [("serve.replay", want)] * 3
    assert all(torch.equal(o[1], (X + 1.0) + 1.0) for o in outs)


@pytest.mark.parametrize("warmup", [False, True])
def test_the_capture_helper_counts_what_ran(kernels, warmup):
    """``CallGraph`` alone: a warm-up counts its launches once, the capture
    none; each of two replays adds its kernels' captured launches; a kernel
    the call does not reach is not in ``launches``."""
    gram, variance = kernels
    X = torch.randn(4, 2)
    graph = StandIn(gram, X, warmup=warmup)
    assert _launched(kernels) == [int(warmup), 0]
    assert graph.launches == {"gram": 1}
    for k in (1, 2):
        assert torch.equal(graph(X + k), 2.0 * (X + k))
        assert _launched(kernels) == [int(warmup) + k, 0]


def test_a_capture_that_raises_restores_the_counters(kernels):
    """A capture cut short by an error leaves every counter as it was before
    the capture, whatever it queued."""
    gram, _ = kernels

    def fails(x):
        gram(x)
        raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError):
        StandIn(fails, torch.randn(3, 2))
    assert _launched(kernels) == [0, 0]


def test_many_keys_keep_the_cache_bounded():
    """However many call shapes pass through, the cache remembers at most
    ``CACHE_KEYS`` keys and holds at most ``GRAPH_SLOTS`` graphs; the most
    recently used keys stay."""
    cache = _cache()
    n = 3 * serve.CACHE_KEYS
    for rows in range(1, n + 1):
        X = torch.randn(rows, 2)
        for _ in range(3):
            _run(cache, X)
        assert len(cache.states) <= serve.CACHE_KEYS
        assert len(cache.graphs) <= serve.GRAPH_SLOTS
    assert len(cache.states) == serve.CACHE_KEYS
    assert [key[1] for key in cache.graphs] == [(r, 2) for r in range(n - 3, n + 1)]
    assert [key[1] for key in cache.states][0] == (n - serve.CACHE_KEYS + 1, 2)


def _handle(head):
    g = torch.Generator().manual_seed(3)
    M, D = 10, 2
    Xu = torch.randn(M, D, generator=g)
    A = torch.randn(M, M, generator=g, dtype=torch.float64)
    nat = MvGaussianNat(torch.randn(M, generator=g, dtype=torch.float64),
                        A @ A.T + M * torch.eye(M, dtype=torch.float64))
    kernel = Kernel("se", transform="softplus", use_kernel=True)
    theta = torch.tensor([0.2, -0.1, 0.3])
    if head == "classifier":
        qw = GammaShapeRate(torch.tensor(3.0, dtype=torch.float64),
                            torch.tensor(2.0, dtype=torch.float64))
        h = serve.SGPClassifier.from_natural(kernel, theta, Xu, nat, qw,
                                             dtype=torch.float32, device="cpu")
        fn = h.probabilities
    else:
        h = serve.SGPRegressor.from_natural(kernel, theta, Xu, nat,
                                            torch.tensor(4.0, dtype=torch.float64),
                                            dtype=torch.float32, device="cpu")
        fn = h
    return h, fn, torch.randn(7, D, generator=g)


def _flat(out):
    return torch.cat([o.reshape(-1) for o in out]) if isinstance(out, tuple) else out


@pytest.mark.parametrize("head", HEADS)
def test_a_handle_keeps_its_cpu_calls_eager(head):
    h, fn, X = _handle(head)
    outs = [_flat(fn(X)) for _ in range(3)]
    assert not h._graphs.states
    assert all(torch.equal(o, outs[0]) for o in outs)


@pytest.mark.parametrize("head", HEADS)
def test_a_handle_through_the_stand_in_answers_as_eagerly(head, monkeypatch):
    """The handle's own call path (its resolved function, its state) under
    the stand-in capture: replays answer as the eager call, and a function
    patched into ``serve`` after the capture is not hidden by the graph."""
    h, fn, X = _handle(head)
    object.__setattr__(h, "_graphs", _cache())
    outs = [_flat(fn(X)) for _ in range(3)]
    assert len(StandIn.made) == 1
    assert all(torch.equal(o, outs[0]) for o in outs)
    name = "predict_probit" if head == "classifier" else "predict_out"
    orig = getattr(serve, name)

    def altered(*args):
        out = orig(*args)
        return tuple(o + 1.0 for o in out) if isinstance(out, tuple) else 1.0 - out

    monkeypatch.setattr(serve, name, altered)
    for _ in range(3):
        assert not torch.equal(_flat(fn(X)), outs[0])
    assert len(StandIn.made) == 2
    monkeypatch.undo()
    assert torch.equal(_flat(fn(X)), outs[0])
    assert len(StandIn.made) == 2


def test_handles_built_directly_or_replaced_get_a_cache_of_their_own():
    h, _, _ = _handle("regressor")
    direct = serve.SGPRegressor(h.kernel, h.theta, h.Xu, h.mu_v, h.w_mean)
    other = dataclasses.replace(h, kernel=Kernel("se", transform="softplus"))
    caches = [x._graphs for x in (h, direct, other)]
    assert all(isinstance(c, serve.GraphCache) for c in caches)
    assert len({id(c) for c in caches}) == 3
    assert "_graphs" not in repr(h)
