"""Serving a pool of request batches through ``serve.SVGPRegressor``.

Set-up makes the data from the seed, takes the configuration's θ, draws the
inducing rows and makes the optimal whitened q(u) for the configuration's
fixed likelihood variance over the training rows in float64
(``reference/svgp_serve.py::optimal_qu``), and builds the handle from it
with ``from_params``, as users build it from a trained ``SVGPParams`` (Kuu's
factor formed there). The window is ``serve_pool``'s: one handle call per
pool batch, ended by a synchronize, closed loop with one call in flight; it
also counts the graph cache's replays (``graph_replays``). Each batch's
answers from its first and its last window call are compared with the
plain float64 reference:

- ``mean_gap``: max |m − m_ref| over the largest |K|ᵀ|α| among the rows
  (α = Lu⁻ᵀm̃), as the UniSGP regressor's cell reads it;
- ``svgp_var_gap``: max |v − v_ref| / σ², σ² the kernel's variance, the
  size of the terms that cancel in the variance.

Faults (``FAULTS``), planted in ``serve.svgp_predict_batch``, which the
handle resolves at call time:

- ``answer_altered``: one mean of each call moved by 1;
- ``half_batch``: a call answers the first half of its rows and gives the
  rest the prior's answer (mean 0, variance σ²);
- ``variance_term_dropped``: the variance leaves out ‖Ãᵀy‖²."""

import math
import time

import torch

from gaussianprocessnode_tpu_torch import serve
from gaussianprocessnode_tpu_torch.infer.svgp import SVGPParams
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
from gaussianprocessnode_tpu_torch.serve import SVGPRegressor

from .. import compare, data, faults, traffic as traffic_gen
from ..card import sync
from ..reference import svgp_serve
from . import serve_pool

F64, F32 = torch.float64, torch.float32


class Session(serve_pool.Session):
    def __init__(self, cfg, traffic, spec, seed, device, tracer):
        self.cfg, self.traffic, self.spec = cfg, traffic, spec
        self.device, self.tracer = torch.device(device), tracer
        gen = data.generator(seed, device)
        X, y = data.training_set(cfg, gen, device)
        # the served inducing inputs, the same float32 values on both sides
        self.Xu = data.inducing_rows(X, cfg["num_inducing"], gen).to(F32)
        th = cfg["serve_theta"]
        self.var = torch.tensor(th["variance"], dtype=F64, device=self.device)
        self.ls = torch.tensor(th["lengthscales"], dtype=F64, device=self.device)
        noise, jitter = cfg["likelihood_variance"], cfg["jitter"]
        self.Lu = svgp_serve.factor(self.var, self.ls, self.Xu, jitter)
        self.m_white, self.A = svgp_serve.optimal_qu(self.var, self.ls, self.Xu, X, y,
                                                     noise, self.Lu)
        del X, y
        self.pool = traffic_gen.request_pool(traffic, self.Xu.shape[1], gen, self.device)

        sp = torch.cat([self.var.reshape(1), self.ls])
        theta_raw = sp + torch.log(-torch.expm1(-sp))  # softplus⁻¹
        params = SVGPParams(theta_raw, self.m_white, self.A,
                            torch.tensor(math.log(noise), dtype=F64, device=self.device))
        kernel = Kernel("se", transform="softplus", use_kernel=True)
        self.handle = SVGPRegressor.from_params(kernel, params, self.Xu, dtype=F32,
                                                device=self.device, jitter=jitter,
                                                raw_tril=True)
        self.fn = self.handle
        P, B, D = self.pool.shape
        self.shapes = {"M": self.Xu.shape[0], "B": B, "D": D}
        for _ in range(serve_pool.WARMUP_CALLS):
            self.fn(self.pool[0])
        sync(self.device)
        self.trace_work, self.enqueue_s, self.latency_ns = {}, [], []
        self.wall_ns = time.time_ns() - time.perf_counter_ns()  # spans on the profiler's clock
        self.first, self.last = {}, {}

    def window(self, seconds: float) -> dict:
        replays = serve.graph_counts["replays"]
        work = super().window(seconds)
        work["counters"]["graph_replays"] = serve.graph_counts["replays"] - replays
        return work

    def _reference(self, slot, precision="float64"):
        return svgp_serve.predict(self.var, self.ls, self.Xu, self.pool[slot], self.Lu,
                                  self.m_white, self.A, precision)

    def _gaps(self, out, ref) -> dict:
        mean_r, var_r, scale = ref
        sigma2 = float(self.var)
        return {"mean_gap": compare.mean_gap(out[0], mean_r, scale),
                # max |v − v_ref| / σ², not finite read as the largest float
                "svgp_var_gap": compare.prob_gap(out[1].to(F64) / sigma2, var_r / sigma2)}

    def control(self) -> dict:
        """The compared numbers of the control: the reference at TF32 in the
        program's place, against the reference, over every batch."""
        gaps = {}
        for slot in range(self.pool.shape[0]):
            m, v, _ = self._reference(slot, "tf32")
            for k, g in self._gaps((m, v), self._reference(slot)).items():
                gaps[k] = max(gaps.get(k, 0.0), g)
        return gaps

    def check(self, limits: dict):
        """Every batch of the pool as its first and its last window call
        served it, against the reference on the same inputs."""
        gaps, failed = {}, 0
        for slot in sorted(self.first):
            ref = self._reference(slot)
            for out in {id(o): o for o in (self.first[slot], self.last[slot])}.values():
                g = self._gaps(out, ref)
                failed += not all(v <= limits[k] for k, v in g.items())
                for k, v in g.items():
                    gaps[k] = max(gaps.get(k, 0.0), v)
        return gaps, failed


def _altered(orig):
    def out(*args):
        mean, var = orig(*args)
        mean = mean.clone()
        mean[mean.shape[0] // 3] += 1.0
        return mean, var
    return out


def _half_rows(orig):
    def out(kernel, theta, Xu, X, *state):
        h = X.shape[0] // 2
        mean, var = orig(kernel, theta, Xu, X[:h], *state)
        rest = X[h:]
        return (torch.cat([mean, mean.new_zeros(rest.shape[0])]),
                torch.cat([var, kernel.diag(theta, rest)]))
    return out


def _variance_term_dropped(orig):
    def out(kernel, theta, Xu, X, Lu, m_white, A):
        return orig(kernel, theta, Xu, X, Lu, m_white, torch.zeros_like(A))
    return out


FAULTS = {
    "answer_altered": lambda: faults.patched((serve, "svgp_predict_batch", _altered)),
    "half_batch": lambda: faults.patched((serve, "svgp_predict_batch", _half_rows)),
    "variance_term_dropped": lambda: faults.patched(
        (serve, "svgp_predict_batch", _variance_term_dropped)),
}
