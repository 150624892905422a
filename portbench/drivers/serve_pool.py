"""Serving a pool of request batches through a ``serve`` handle.

Set-up makes q(v)'s natural parameters in float64 from the seed, as a
conjugate update from the trainers' prior N(0, v₀·I) over the cell's seeded
training rows gives them, Λ = I/v₀ + w̄·Kux·Kuxᵀ and ξ = w̄·Kux·y (a
classifier's labels as ±1), and builds the handle from them with
``from_natural``, as users build it (μ_v recovered there). Each window call
is one handle call on the next batch of the pool, ended by a synchronize:
closed loop, one call in flight. Every call's time, from its start to the
end of its synchronize, is kept on the host's clock. The window keeps each
batch's answers from its first and its last call for the comparison.

Faults a serving cell can have (``FAULTS``):

- ``answer_altered``: one answer of each call is changed where it is
  produced (a mean moved by 1, a probability p made 1 − p at the row
  farthest from ½);
- ``half_batch``: a call answers the first half of its rows and fills the
  rest with the prior's answer."""

import time

import torch

from gaussianprocessnode_tpu_torch import serve
from gaussianprocessnode_tpu_torch.dists import GammaShapeRate, MvGaussianNat
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
from gaussianprocessnode_tpu_torch.ops.se_gram import se_gram_cuda
from gaussianprocessnode_tpu_torch.serve import SGPClassifier, SGPRegressor

from .. import compare, data, faults, traffic as traffic_gen
from ..card import sync
from ..reference import sgp_serve
from ..reference.se import se_gram

WARMUP_CALLS = 2    # calls before the window: build and warm the cell's one shape
TRACE_CALLS = 400   # calls in a traced run's profiled sub-window


class Session:
    def __init__(self, cfg, traffic, spec, seed, device, tracer):
        self.cfg, self.traffic, self.spec = cfg, traffic, spec
        self.device, self.tracer = torch.device(device), tracer
        self.classifier = spec["head"] == "classifier"
        f64, f32 = torch.float64, torch.float32
        gen = data.generator(seed, device)
        X, t = data.training_set(cfg, gen, device)
        y = 2.0 * t - 1.0 if self.classifier else t
        # the served inducing inputs, the same float32 values on both sides
        self.Xu = data.inducing_rows(X, cfg["num_inducing"], gen).to(f32)
        th = cfg["serve_theta"]
        self.var = torch.tensor(th["variance"], dtype=f64, device=self.device)
        self.ls = torch.tensor(th["lengthscales"], dtype=f64, device=self.device)
        srv = cfg["serve_state"]
        self.w_mean = (srv["q_w"]["shape"] / srv["q_w"]["rate"] if self.classifier
                       else srv["w_mean"])
        Kux = se_gram(self.Xu.to(f64), X, self.var, self.ls)
        M = Kux.shape[0]
        self.prec = (torch.eye(M, dtype=f64, device=self.device) / srv["prior_variance"]
                     + self.w_mean * (Kux @ Kux.T))
        self.xi = self.w_mean * (Kux @ y)
        del Kux
        self.pool = traffic_gen.request_pool(traffic, X.shape[1], gen, self.device)

        sp = torch.cat([self.var.reshape(1), self.ls])
        theta_raw = sp + torch.log(-torch.expm1(-sp))  # softplus⁻¹
        kernel = Kernel("se", transform="softplus", use_kernel=True)
        nat = MvGaussianNat(self.xi, self.prec)
        if self.classifier:
            qw = GammaShapeRate(*(torch.tensor(srv["q_w"][k], dtype=f64, device=self.device)
                                  for k in ("shape", "rate")))
            self.handle = SGPClassifier.from_natural(kernel, theta_raw, self.Xu, nat, qw,
                                                     dtype=f32, device=self.device)
            self.fn = self.handle.probabilities
        else:
            w = torch.tensor(self.w_mean, dtype=f64, device=self.device)
            self.handle = SGPRegressor.from_natural(kernel, theta_raw, self.Xu, nat, w,
                                                    dtype=f32, device=self.device)
            self.fn = self.handle
        P, B, D = self.pool.shape
        self.shapes = {"M": M, "B": B, "D": D}
        for _ in range(WARMUP_CALLS):
            self.fn(self.pool[0])
        sync(self.device)
        self.trace_work, self.enqueue_s, self.latency_ns = {}, [], []
        self.wall_ns = time.time_ns() - time.perf_counter_ns()  # spans on the profiler's clock
        self.first, self.last = {}, {}

    def _call(self, k: int) -> None:
        tr = self.tracer
        slot = k % self.pool.shape[0]
        a = time.perf_counter_ns()
        out = self.fn(self.pool[slot])
        b = time.perf_counter_ns()
        sync(self.device)
        c = time.perf_counter_ns()
        self.latency_ns.append(c - a)
        if tr.on:
            w = self.wall_ns
            tr.add("serve.call", a + w, b + w)
            tr.add("serve.sync", b + w, c + w)
            if not tr.profiling:
                self.enqueue_s.append((b - a) / 1e9)
        self.first.setdefault(slot, out)
        self.last[slot] = out

    def window(self, seconds: float) -> dict:
        tr, n_trace = self.tracer, TRACE_CALLS
        calls, traced = 0, not tr.on
        launches = se_gram_cuda.launches
        self.latency_ns = []
        t0 = time.perf_counter()
        while True:
            if not traced and time.perf_counter() - t0 >= seconds / 2:
                with tr.profiled(lambda: sync(self.device)):
                    for _ in range(n_trace):
                        self._call(calls)
                        calls += 1
                self.trace_work = {"calls": n_trace,
                                   "predictions": n_trace * self.shapes["B"]}
                traced = True
            else:
                self._call(calls)
                calls += 1
            if traced and time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        self.attempted = calls
        return {"seconds": elapsed, "calls": calls, "predictions": calls * self.shapes["B"],
                "call_seconds": [t / 1e9 for t in self.latency_ns],
                "counters": {"se_gram_launches": se_gram_cuda.launches - launches}}

    def release(self) -> None:
        del self.handle, self.fn

    def _compared(self, slot, outputs, mu):
        """{name: gap} of the answers in ``outputs`` for one batch."""
        mean_r, var_r, scale = sgp_serve.predict(self.var, self.ls, self.Xu,
                                                 self.pool[slot], mu, self.w_mean)
        if self.classifier:
            prob_r = sgp_serve.probabilities(mean_r, var_r)
            return [{"prob_gap": compare.prob_gap(o, prob_r)} for o in outputs]
        return [{"mean_gap": compare.mean_gap(o[0], mean_r, scale),
                 "var_gap": compare.var_gap(o[1], var_r)} for o in outputs]

    def control(self) -> dict:
        """The compared numbers of the control: the reference in the
        program's place at TF32, against the reference, over every batch."""
        mu = sgp_serve.mu_v(self.xi, self.prec)
        gaps = {}
        for slot in range(self.pool.shape[0]):
            m, v, _ = sgp_serve.predict(self.var, self.ls, self.Xu, self.pool[slot], mu,
                                        self.w_mean, precision="tf32")
            out = sgp_serve.probabilities(m, v) if self.classifier else (m, v)
            for k, g in self._compared(slot, [out], mu)[0].items():
                gaps[k] = max(gaps.get(k, 0.0), g)
        return gaps

    def check(self, limits: dict):
        """Every batch of the pool as its first and its last window call
        served it, against the reference on the same inputs."""
        mu = sgp_serve.mu_v(self.xi, self.prec)
        gaps, failed = {}, 0
        for slot in sorted(self.first):
            outs = {id(o): o for o in (self.first[slot], self.last[slot])}.values()
            for g in self._compared(slot, list(outs), mu):
                failed += not all(v <= limits[k] for k, v in g.items())
                for k, v in g.items():
                    gaps[k] = max(gaps.get(k, 0.0), v)
        return gaps, failed


def _half_rows_out(orig):
    def out(kernel, theta, Xu, X, mu_v, w_mean):
        h = X.shape[0] // 2
        mean, var = orig(kernel, theta, Xu, X[:h], mu_v, w_mean)
        rest = X.shape[0] - h
        return torch.cat([mean, mean.new_zeros(rest)]), torch.cat([var, var[:1].expand(rest)])
    return out


def _half_rows_probit(orig):
    def out(kernel, theta, Xu, X, mu_v, w_mean):
        h = X.shape[0] // 2
        p = orig(kernel, theta, Xu, X[:h], mu_v, w_mean)
        return torch.cat([p, p.new_full((X.shape[0] - h,), 0.5)])
    return out


def _altered_out(orig):
    def out(*args):
        mean, var = orig(*args)
        mean = mean.clone()
        mean[mean.shape[0] // 3] += 1.0
        return mean, var
    return out


def _altered_probit(orig):
    def out(*args):
        p = orig(*args).clone()
        k = torch.argmax(torch.abs(p - 0.5))
        p[k] = 1.0 - p[k]
        return p
    return out


FAULTS = {
    "answer_altered": lambda: faults.patched((serve, "predict_out", _altered_out),
                                             (serve, "predict_probit", _altered_probit)),
    "half_batch": lambda: faults.patched((serve, "predict_out", _half_rows_out),
                                         (serve, "predict_probit", _half_rows_probit)),
}
