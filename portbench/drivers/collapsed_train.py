"""Back-to-back collapsed-VSGP trainings through ``infer.svgp``.

As ``experiments/vsgp_baselines.py::run_kin40k_collapsed`` drives them:
``fit_svgp_collapsed_resumable`` in chunks, each ended by one host read of
the chunk's first and last −ELBO; each job starts from θ0 = softplus⁻¹(1)
with a fresh AdaMax state (``collapsed_opt_init``). Set-up builds the one
trainer (kernel, data, inducing rows, optimizer state) and drives its first
job's first steps through the same call; the window goes on with that job
and starts the next ones. The reference follows those first steps.

Faults a training cell can have (``FAULTS``):

- ``state_unchanged``: a step returns its −ELBO and updates neither θ nor
  the optimizer state;
- ``half_batch``: the collapsed bound on the first half of the rows, scaled
  to N (the mean over the rest taken for the whole)."""

import math
import time
from contextlib import ExitStack

import torch

from gaussianprocessnode_tpu_torch.infer import svgp
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
from gaussianprocessnode_tpu_torch.ops.se_gram import se_gram_cuda

from .. import compare, data, faults, traffic as traffic_gen
from ..card import sync
from ..reference import collapsed_vsgp
from ..trace import now_ns

TRACE_FROM_STEP = 100  # a traced run profiles from this step of a job...
TRACE_CHUNKS = 4       # ...for this many chunks, each with its host read


class Session:
    def __init__(self, cfg, traffic, spec, seed, device, tracer):
        self.cfg, self.traffic, self.spec = cfg, traffic, spec
        self.device, self.tracer = torch.device(device), tracer
        gen = data.generator(seed, device)
        X, y = data.training_set(cfg, gen, device)
        Xu = data.inducing_rows(X, cfg["num_inducing"], gen)
        f32 = torch.float32
        self.X, self.y, self.Xu = X.to(f32), y.to(f32), Xu.to(f32)
        D = self.X.shape[1]
        self.theta0 = torch.full((1 + D,), math.log(math.expm1(1.0)), dtype=f32,
                                 device=self.device)
        self.kernel = Kernel("se", transform="softplus", use_kernel=True)
        self.lr = cfg["optimizer"]["learning_rate"]
        self.shapes = {"M": self.Xu.shape[0], "N": self.X.shape[0], "D": D}
        self.trace_work, self.enqueue_s, self.failed = {}, [], 0

        theta, state = self.theta0, svgp.collapsed_opt_init(self.theta0, self.lr)
        losses = []
        for i, n in enumerate(traffic["first_steps"]):
            theta, state, trace = self._chunk(theta, state, n)
            losses.append(trace)
            if i == 0:
                grad = state["mu"] / (1.0 - cfg["optimizer"]["b1"])
        self.outputs = {"losses": torch.cat(losses), "grad": grad,
                        "change": theta - self.theta0}
        self.theta, self.state = theta, state
        self.step = sum(traffic["first_steps"])

    def _chunk(self, theta, state, n):
        tr = self.tracer
        a = now_ns()
        theta, state, trace = svgp.fit_svgp_collapsed_resumable(
            self.kernel, theta, state, self.Xu, self.X, self.y, self.cfg["collapsed_noise"],
            steps=n, learning_rate=self.lr, jitter=self.cfg["jitter"])
        b = now_ns()
        first, last = torch.stack((trace[0], trace[-1])).tolist()
        c = now_ns()
        tr.add("train.chunk", a, b)
        tr.add("train.host_read", b, c)
        self.failed += not (math.isfinite(first) and math.isfinite(last))
        return theta, state, trace

    def window(self, seconds: float) -> dict:
        tr = self.tracer
        chunks = traffic_gen.job_chunks(self.traffic, self.step)
        theta, state = self.theta, self.state
        self.failed = 0
        steps, traced, left = 0, not tr.on, 0
        launches = se_gram_cuda.launches
        with ExitStack() as stack:
            t0 = time.perf_counter()
            while True:
                step, n = next(chunks)
                if step == 0:
                    a = now_ns()
                    theta = self.theta0.clone()
                    state = svgp.collapsed_opt_init(self.theta0, self.lr)
                    tr.add("train.job_start", a, now_ns())
                if (not traced and step == TRACE_FROM_STEP
                        and time.perf_counter() - t0 >= seconds / 2):
                    stack.enter_context(tr.profiled(lambda: sync(self.device)))
                    traced, left = True, TRACE_CHUNKS
                    self.trace_work = {"steps": 0}
                theta, state, _ = self._chunk(theta, state, n)
                steps += n
                if left:
                    self.trace_work["steps"] += n
                    left -= 1
                    if not left:
                        stack.close()
                if traced and not left and time.perf_counter() - t0 >= seconds:
                    break
            elapsed = time.perf_counter() - t0
        self.theta, self.state = theta, state
        self.attempted = steps
        return {"seconds": elapsed, "steps": steps, "rows": steps * self.shapes["N"],
                "counters": {"se_gram_launches": se_gram_cuda.launches - launches}}

    def release(self) -> None:
        del self.theta, self.state, self.kernel

    def check(self, limits: dict):
        n = sum(self.traffic["first_steps"])
        ref = collapsed_vsgp.first_steps(self.theta0, self.Xu, self.X, self.y, self.cfg, n)
        gaps = compare.training_gaps(self.outputs, ref)
        return gaps, self.failed

    def control(self) -> dict:
        """The compared numbers of the control: the reference in the
        program's place at TF32, against the reference."""
        n = sum(self.traffic["first_steps"])
        args = (self.theta0, self.Xu, self.X, self.y, self.cfg, n)
        return compare.training_gaps(collapsed_vsgp.first_steps(*args, precision="tf32"),
                                     collapsed_vsgp.first_steps(*args))


def _state_unchanged(orig_step):
    def step(kernel, optimizer, theta, opt_state, Xu, X, y, noise, jitter=1e-6):
        with torch.no_grad():
            return svgp.collapsed_neg_elbo(kernel, theta, Xu, X, y, noise, jitter)
    return step


def _half_rows_bound(orig):
    def bound(kernel, theta, Xu, X, y, noise, jitter=1e-10):
        h = X.shape[0] // 2
        return orig(kernel, theta, Xu, X[:h], y[:h], noise, jitter) * (X.shape[0] / h)
    return bound


FAULTS = {
    "state_unchanged": lambda: faults.patched((svgp, "collapsed_step", _state_unchanged)),
    "half_batch": lambda: faults.patched((svgp, "collapsed_neg_elbo", _half_rows_bound)),
}
