"""Process groups, collectives and rank launching for the parallel layer.

The JAX package runs one ``shard_map`` program over a mesh of devices; the
port runs one process per shard (a rank), each holding its local slice and
calling the same function with a ``torch.distributed`` process group
(``group=None`` is the default group). The JAX collectives map onto:

    psum                   all_reduce_sum      (all_reduce, SUM)
    pmax                   all_reduce_max      (all_reduce, MAX)
    all_gather(tiled)      all_gather_rows     (all_gather, list form)
    ppermute (ring)        ring_shift          (batch_isend_irecv)
    ppermute (chain ends)  halo_from_left / halo_from_right
    axis_index             rank(group)

The backend follows the tensors' device: gloo for CPU tensors, NCCL for
CUDA tensors (``backend_for``). No collective is differentiated: every JAX
psum on a gradient path sums gradients after they are taken, so the
reducers clone their input and reduce it under ``torch.no_grad()``; they
never touch a tensor that autograd saved. At world size 1 the
point-to-point exchanges post nothing (a ring of one has nothing to pass, a
chain end has no neighbour); the reductions and gathers still go through
the backend.

:func:`spawn_ranks` starts ``world`` ranks with the ``spawn`` method,
rendezvous through a ``file://`` store in a fresh temporary directory (so
concurrent launches never share a port), and joins them with a deadline:
a collective that never completes fails by timeout, and a rank that dies
raises in the parent. :func:`single_rank_group` makes a one-rank default
group in the calling process.
"""

import contextlib
import datetime
import multiprocessing as mp
import os
import shutil
import tempfile
import time
import traceback
from typing import NamedTuple

import torch
import torch.distributed as dist

__all__ = ["backend_for", "world_size", "rank", "rank_slice", "make_mesh", "all_reduce_sum",
           "all_reduce_max", "all_gather_rows", "ring_shift", "halo_from_left",
           "halo_from_right", "spawn_ranks", "single_rank_group", "RankFailure"]

DEFAULT_TIMEOUT_S = 300.0


def backend_for(device) -> str:
    """The backend for tensors on ``device``: NCCL for CUDA, gloo otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def world_size(group=None) -> int:
    return dist.get_world_size(group)


def rank(group=None) -> int:
    """This process's rank within ``group`` (JAX's ``axis_index``)."""
    return dist.get_rank(group)


def rank_slice(a, dim: int, group=None,
               message: str = "dim {size} does not shard evenly over {n} ranks"):
    """This rank's contiguous slice of ``a`` along ``dim``, which must
    divide evenly over the group's ranks (else ValueError with ``message``
    formatted with ``size`` and ``n``)."""
    n, r = world_size(group), rank(group)
    if a.shape[dim] % n:
        raise ValueError(message.format(size=a.shape[dim], n=n))
    k = a.shape[dim] // n
    return a.narrow(dim, r * k, k)


def _global_rank(group, group_rank: int) -> int:
    return group_rank if group is None else dist.get_global_rank(group, group_rank)


class Mesh2D(NamedTuple):
    """This rank's two subgroups of a (dp, tp) layout: global rank
    d·tp + t is row d of the dp axis and column t of the tp axis."""

    dp: object
    tp: object


def make_mesh(shape=None):
    """The counterpart of ``sharding.make_mesh``: ``None`` is the default
    group, one axis over every rank; a 2-tuple ``(dp, tp)`` makes the
    subgroups of a 2-D layout (rank = d·tp + t, as JAX's
    ``devices.reshape(dp, tp)``) and returns this rank's :class:`Mesh2D`.
    Every rank must call it, in the same order, since ``new_group`` is
    collective."""
    if shape is None:
        return None
    pd, pt = shape
    if pd * pt != dist.get_world_size():
        raise ValueError(f"mesh {pd}x{pt} does not cover the {dist.get_world_size()} ranks")
    me = dist.get_rank()
    tp_groups = [dist.new_group([d * pt + t for t in range(pt)]) for d in range(pd)]
    dp_groups = [dist.new_group([d * pt + t for d in range(pd)]) for t in range(pt)]
    return Mesh2D(dp_groups[me % pt], tp_groups[me // pt])


@torch.no_grad()
def _all_reduce(x, op, group):
    buf = x.detach().clone()
    dist.all_reduce(buf, op=op, group=group)
    return buf


def all_reduce_sum(x, group=None):
    """psum: the sum over the group's ranks of ``x``, as a new tensor; ``x``
    is left as it was (and may be one that autograd saved)."""
    return _all_reduce(x, dist.ReduceOp.SUM, group)


def all_reduce_max(x, group=None):
    """pmax: the elementwise maximum over the group's ranks, as a new tensor."""
    return _all_reduce(x, dist.ReduceOp.MAX, group)


@torch.no_grad()
def all_gather_rows(x, group=None):
    """all_gather(tiled=True): the ranks' ``x`` (equal shapes) concatenated
    along the leading dimension in rank order."""
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, 0)


@torch.no_grad()
def _exchange(send_to, send, recv_from, like, group):
    """Post this rank's send and receive (either may be None) in one batch;
    returns the received tensor (zeros where nothing is received)."""
    recv = torch.zeros_like(like)
    ops = []
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, send.detach().contiguous(),
                              _global_rank(group, send_to), group))
    if recv_from is not None:
        ops.append(dist.P2POp(dist.irecv, recv, _global_rank(group, recv_from), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv


def ring_shift(x, group=None):
    """ppermute over the ring i → i+1 (mod P): this rank's ``x`` goes to
    its successor and it receives its predecessor's. ``x`` itself at P = 1."""
    P = dist.get_world_size(group)
    if P == 1:
        return x
    r = dist.get_rank(group)
    return _exchange((r + 1) % P, x, (r - 1) % P, x, group)


def halo_from_left(x, group=None):
    """ppermute over the chain i → i+1: rank r receives rank r−1's ``x``;
    rank 0 receives zeros."""
    P, r = dist.get_world_size(group), dist.get_rank(group)
    return _exchange(r + 1 if r < P - 1 else None, x, r - 1 if r > 0 else None, x, group)


def halo_from_right(x, group=None):
    """ppermute over the chain i → i−1: rank r receives rank r+1's ``x``;
    the last rank receives zeros."""
    P, r = dist.get_world_size(group), dist.get_rank(group)
    return _exchange(r - 1 if r > 0 else None, x, r + 1 if r < P - 1 else None, x, group)


class RankFailure(RuntimeError):
    """A spawned rank died, raised or did not finish by the deadline."""


def _rank_main(fn, r, world, backend, store, timeout_s, args):
    """The body of one spawned rank: join the group, run ``fn(*args)``,
    save its result (or its traceback) under the store's directory."""
    out_dir = os.path.dirname(store)
    try:
        if backend == "gloo":
            torch.set_num_threads(1)  # ranks share the host's cores
        else:
            torch.cuda.set_device(r)
        dist.init_process_group(backend, init_method=f"file://{store}", world_size=world,
                                rank=r, timeout=datetime.timedelta(seconds=timeout_s))
        result = fn(*args)
        tmp = os.path.join(out_dir, f"rank{r}.pt.tmp")
        torch.save(result, tmp)
        os.replace(tmp, os.path.join(out_dir, f"rank{r}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{r}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)  # skip the group's teardown, which waits on the peers


def _kill(procs):
    started = [p for p in procs if p.pid is not None]
    for p in started:
        if p.is_alive():
            p.kill()
    for p in started:
        p.join(5)


def spawn_ranks(fn, world: int, backend: str, *args, timeout_s: float = DEFAULT_TIMEOUT_S):
    """Run ``fn(*args)`` on ``world`` new ranks (``backend`` "gloo" or
    "nccl"; NCCL rank r on card r) and return their results in rank order.
    ``fn`` must be a module-level function (it is pickled by name), and its
    result is passed back through ``torch.save``.

    The collectives' timeout and the join's deadline are both
    ``timeout_s``: past it, every rank is killed and :class:`RankFailure`
    raised, as it is as soon as one rank exits with an error."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="gpn_ranks_")
    store = os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, backend, store, timeout_s, args))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.exitcode for p in procs]
            if any(c not in (None, 0) for c in codes):
                _kill(procs)
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                raise RankFailure(_failure_report(tmp, procs, f"rank(s) {failed} failed"))
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                _kill(procs)
                raise RankFailure(_failure_report(
                    tmp, procs, f"ranks did not finish within {timeout_s:g} s"))
            time.sleep(0.05)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        _kill(procs)
        shutil.rmtree(tmp, ignore_errors=True)


def _failure_report(tmp, procs, what):
    lines = [what + "; exit codes " + str([p.exitcode for p in procs])]
    for r in range(len(procs)):
        path = os.path.join(tmp, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                lines.append(f"--- rank {r} ---\n" + f.read().rstrip())
    return "\n".join(lines)


@contextlib.contextmanager
def single_rank_group(device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S):
    """A default group of one rank in this process, for ``device``'s
    backend (NCCL on the card), destroyed on exit: the parallel functions
    then run at world size 1 in the calling process."""
    tmp = tempfile.mkdtemp(prefix="gpn_rank0_")
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device).index or 0)
        dist.init_process_group(backend_for(device), init_method=f"file://{tmp}/rendezvous",
                                world_size=1, rank=0,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            yield None
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
