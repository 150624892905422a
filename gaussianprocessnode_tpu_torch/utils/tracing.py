"""Spans of the program's host path, kept in memory while recording is on.

Recording is off by default and turned on and off by :func:`start` and
:func:`stop`. While it is off an instrumented site costs one check of the
module flag ``ON`` and records nothing. A block is a site as ::

    with tracing.span("serve.matvec"):
        mean = Kut.T @ mu_v

and a whole function as ``@tracing.traced("serve.predict")``, which costs
less than a ``with`` while off (no context's two calls).

Each span keeps its name, its start and end, the span it opened inside
(``parent``, an index into :func:`spans`) and a request id: a span opened
inside no other is a root and opens a new request, and its descendants
carry that id. Times are ``perf_counter_ns`` plus one offset to the wall
clock (``time.time_ns``), taken when recording starts: the clock of
``torch.profiler``'s device records, so a span and a kernel record compare
directly. While recording, each collection of Python's garbage collector
is recorded as a ``python.gc`` span (attribute ``generation``) inside the
span that was open when it ran.

While recording, a site appends one integer as it opens and one as it
closes (the time since :func:`start` in the high bits, the name's code or
0 for a close in the low 8) to a flat array, which the garbage collector
does not track, so a long recording does not lengthen the collections it
records.
:func:`spans` rebuilds the tree from that sequence, so the spans of one
recording come from one thread (the serving handles are called from one).

The program's spans (names as the benchmark's layers read them):

- ``serve.predict`` (root): a serving handle's call;
- ``kernel.params``: softplus θ → (σ², ℓ) in ``ops.kernels.Kernel.params``;
- ``se_gram.dispatch``: ``ops.se_gram.se_gram_fused`` from entry to return;
- ``se_gram.launch``: the stream lookup and the kernel library's call;
- ``serve.matvec`` and ``serve.fill``: Kᵀμ_v and the 1/w̄ fill of
  ``infer.batch_vmp.predict_out``;
- ``probit.phi``: Φ in ``infer.batch_vmp.predict_probit``;
- ``serve.from_natural``: μ_v's recovery when a handle is built;
- ``ops.load_library``: building or loading the kernel library
  (attribute ``built``);
- ``python.gc``: a garbage collection.
"""

import functools
import gc
import time
from array import array
from time import perf_counter_ns

__all__ = ["ON", "Span", "start", "stop", "span", "traced", "attrs", "spans", "self_ns"]

ON = False

_CODE_BITS = 8
_events = array("q")   # (ns since start) << _CODE_BITS | code; code 0 closes a span
_attrs = []            # (index into _events, dict): attributes of the span open there
_names = []            # name of code i + 1
_contexts = {}         # name → its context
_t0 = 0                # perf_counter_ns at start()
_offset_ns = 0         # wall clock − perf_counter_ns


class Span:
    """One recorded span. ``start_ns`` and ``end_ns`` are wall-clock ns
    (``end_ns`` None while open), ``parent`` the index of the span it opened
    inside (None for a root), ``request`` its root's request id, ``attrs`` a
    dict or None."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "request", "attrs")

    def __init__(self, name, start_ns, parent, request, attrs=None, end_ns=None):
        self.name, self.start_ns, self.end_ns = name, start_ns, end_ns
        self.parent, self.request, self.attrs = parent, request, attrs


class _Off:
    """The context of every site while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


class _On:
    """The context of one span name while recording is on (one per name,
    shared by nested and successive spans: it holds no state of a span)."""

    __slots__ = ("code",)

    def __init__(self, code: int):
        self.code = code

    def __enter__(self):
        _events.append((perf_counter_ns() - _t0) << _CODE_BITS | self.code)

    def __exit__(self, exc_type, exc, tb):
        _events.append((perf_counter_ns() - _t0) << _CODE_BITS)
        return False


def _context(name: str) -> _On:
    ctx = _contexts.get(name)
    if ctx is None:
        if len(_names) + 1 >= 1 << _CODE_BITS:
            raise ValueError(f"tracing: more than {(1 << _CODE_BITS) - 1} span names")
        _names.append(name)
        ctx = _contexts[name] = _On(len(_names))
    return ctx


def span(name: str):
    """A context that records one span named ``name`` while recording is on
    and does nothing while it is off."""
    if not ON:
        return _OFF
    return _contexts.get(name) or _context(name)


def traced(name: str):
    """Decorator: each call of the function is a span named ``name`` while
    recording is on."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not ON:
                return fn(*args, **kwargs)
            with _contexts.get(name) or _context(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def attrs(**kw) -> None:
    """Attach ``kw`` to the innermost span open now, while recording."""
    if ON:
        _attrs.append((len(_events), kw))


_GC = _context("python.gc")


def _on_gc(phase, info) -> None:
    if phase == "start":
        _GC.__enter__()
    else:
        _attrs.append((len(_events), {"generation": info["generation"]}))
        _GC.__exit__(None, None, None)


def start() -> None:
    """Clear the store and start recording: take the clock's offset and
    hook the garbage collector."""
    global ON, _t0, _offset_ns
    stop()
    del _events[:]
    _attrs.clear()
    p0 = perf_counter_ns()
    wall = time.time_ns()
    p1 = perf_counter_ns()
    _t0, _offset_ns = p1, wall - (p0 + p1) // 2
    gc.callbacks.append(_on_gc)
    ON = True


def stop() -> None:
    """Stop recording and unhook the garbage collector; the store keeps
    what was recorded until the next :func:`start`."""
    global ON
    ON = False
    if _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)


def spans() -> list:
    """The spans recorded since the last :func:`start`, in the order they
    opened, as :class:`Span` records (a span still open has ``end_ns``
    None)."""
    base, mask = _t0 + _offset_ns, (1 << _CODE_BITS) - 1
    notes = iter(_attrs + [(len(_events) + 1, None)])
    pos, note = next(notes)
    out, stack, requests = [], [], 0

    def attach(upto):
        nonlocal pos, note
        while pos <= upto:
            if stack:
                out[stack[-1]].attrs = {**(out[stack[-1]].attrs or {}), **note}
            pos, note = next(notes)

    for i, ev in enumerate(_events):
        attach(i)
        t, code = base + (ev >> _CODE_BITS), ev & mask
        if code:
            if stack:
                parent, request = stack[-1], out[stack[-1]].request
            else:
                parent, request, requests = None, requests, requests + 1
            stack.append(len(out))
            out.append(Span(_names[code - 1], t, parent, request))
        elif stack:
            out[stack.pop()].end_ns = t
    attach(len(_events))
    return out


def self_ns(recorded) -> list:
    """Each span's self time, ns: its duration less the part of its interval
    that its children's union covers (children clipped to it), so never
    negative. ``recorded`` is a list of :class:`Span` as :func:`spans`
    returns it; open spans count 0."""
    kids = [[] for _ in recorded]
    for s in recorded:
        if s.parent is not None:
            kids[s.parent].append(s)
    out = []
    for s, ch in zip(recorded, kids):
        if s.end_ns is None:
            out.append(0)
            continue
        covered, t = 0, s.start_ns
        for c in sorted(ch, key=lambda c: c.start_ns):
            lo, hi = max(c.start_ns, t), min(c.end_ns or s.end_ns, s.end_ns)
            if hi > lo:
                covered += hi - lo
                t = hi
        out.append(s.end_ns - s.start_ns - covered)
    return out
