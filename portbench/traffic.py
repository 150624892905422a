"""The one traffic generator: it reads a mix's parameters (``traffic/<name>.json``).

Two kinds of mix:

- ``request_pool``: ``pool`` request batches made at set-up on the device
  and cycled by the serving loop, closed loop with one call in flight.
  ``inputs`` is ``normal`` (``rows`` rows drawn N(0, I_D)) or ``grid``
  (``side``×``side`` points on a regular grid over a square window whose
  centre is drawn uniformly from ``center`` per coordinate and whose
  half-width is drawn uniformly from ``half_width``). Every seed has the
  same sizes; only the values differ.
- ``training_jobs``: back-to-back trainings of ``steps_per_job`` steps
  from the configuration's start, driven in chunks of ``chunk`` steps
  with one host read per chunk; ``first_steps`` are the chunk lengths that
  set-up drives first (the steps that the reference follows).
"""

import torch


def request_pool(spec: dict, dim: int, gen: torch.Generator, device,
                 dtype=torch.float32) -> torch.Tensor:
    """(pool, rows, dim) request inputs."""
    P = spec["pool"]
    if spec["inputs"] == "normal":
        return torch.randn(P, spec["rows"], dim, generator=gen, device=device).to(dtype)
    if spec["inputs"] == "grid":
        side = spec["side"]
        lo, hi = spec["center"]
        c = lo + (hi - lo) * torch.rand(P, 1, dim, generator=gen, device=device,
                                        dtype=torch.float64)
        lo, hi = spec["half_width"]
        h = lo + (hi - lo) * torch.rand(P, 1, 1, generator=gen, device=device,
                                        dtype=torch.float64)
        g = torch.linspace(-1.0, 1.0, side, dtype=torch.float64, device=device)
        axes = torch.meshgrid(*([g] * dim), indexing="ij")
        unit = torch.stack([a.reshape(-1) for a in axes], dim=1)  # (side**dim, dim)
        return (c + h * unit[None]).to(dtype)
    raise ValueError(f"unknown request inputs {spec['inputs']!r}")


def job_chunks(spec: dict, start_step: int):
    """Endless (step in the job, n_steps) chunks of back-to-back jobs, resuming
    a job at ``start_step`` with a first chunk that ends on a chunk boundary;
    step 0 starts a new job."""
    per_job, chunk = spec["steps_per_job"], spec["chunk"]
    step = start_step
    while True:
        if step >= per_job:
            step = 0
        n = min(chunk - step % chunk, per_job - step)
        yield step, n
        step += n
