"""The port's last utilities (utils/checkpoint.py, configs.py, logging.py,
driver.py) and the runners' chunk, checkpoint, sequence-parallel and
kin40k options, and experiments/pit_bench.py, on the CPU at small depth.

Each runner option is held to the JAX runner's sequence of library calls
on the same inputs (the JAX runners themselves read absent data or write a
compile cache into the repository; the pendulum's hyperparameter epochs
are held to JAX by ``tests/test_torch_pendulum_runner.py``), and chunked or
resumed runs to the same run in one piece:

- chunks and resumes are the same arithmetic in the same order: bit-equal;
- kin40k and pit_bench in float64 on well-conditioned Grams: the printed
  figures (SMSE to 6 decimals; pit_bench's rounded row) equal, θ within
  1e-10;
- GPLVM: 1e-7 relative, the GPLVM runner test's band;
- the pendulum on its own grid (κ(Kuu) ≈ 3e13): 1e-3 relative, the
  pendulum runner test's band (JAX's own spread under a 1e-15 change of
  y), here for the final sweeps (30 of the runner's 150) sequence-parallel
  on 2 gloo ranks against the JAX package's sequence-parallel smoother on
  2 devices from the same θ.
"""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_pendulum_runner as TPR
from experiments import pit_bench as jax_pit_bench
from gaussianprocessnode_tpu.dists import MvGaussianNat as JNat
from gaussianprocessnode_tpu.infer import chain_smoother as jc
from gaussianprocessnode_tpu.infer import gplvm as jg
from gaussianprocessnode_tpu.infer import minibatch as jmb
from gaussianprocessnode_tpu.infer.batch_vmp import predict_out as jpredict_out
from gaussianprocessnode_tpu.ops import linalg as jla
from gaussianprocessnode_tpu.ops.kernels import Kernel as JKernel
from gaussianprocessnode_tpu.parallel import seq_parallel as jsp
from gaussianprocessnode_tpu.parallel.sharding import make_mesh as jmake_mesh
from gaussianprocessnode_tpu.utils import configs as jconfigs
from gaussianprocessnode_tpu.utils import driver as jdriver
from gaussianprocessnode_tpu.utils import logging as jlogging
from gaussianprocessnode_tpu_torch.dists import MvGaussianNat
from gaussianprocessnode_tpu_torch.experiments import gplvm as grunner
from gaussianprocessnode_tpu_torch.experiments import kin40k as krunner
from gaussianprocessnode_tpu_torch.experiments import pendulum as prunner
from gaussianprocessnode_tpu_torch.experiments import pit_bench
from gaussianprocessnode_tpu_torch.infer.minibatch import FastCarry, fit_kin40k_fast
from gaussianprocessnode_tpu_torch.utils import configs, datasets
from gaussianprocessnode_tpu_torch.utils.checkpoint import load_pytree, save_pytree
from gaussianprocessnode_tpu_torch.utils.driver import chunked_run
from gaussianprocessnode_tpu_torch.utils.logging import MetricsLogger

JK = JKernel("se", transform="softplus")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(g - w).max() / np.abs(w).max())


def _equal_trees(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_trees(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_equal_trees, a, b))
    return a == b


# --- utils -----------------------------------------------------------------------

def _tree():
    theta = torch.tensor([0.1, -0.2, 0.3], dtype=torch.float64)
    carry = FastCarry(torch.zeros(4), torch.eye(4), torch.ones(1, 4, 4, dtype=torch.float64),
                      theta, {"count": torch.tensor(7, dtype=torch.int32),
                              "found_nan": torch.tensor(False), "mu": theta * 2, "nu": theta * 3},
                      torch.full((4, 4), 0.5, dtype=torch.float32))
    return {"carry": carry, "done": np.asarray(3, np.int64), "fe": np.arange(5.0),
            "pair": (torch.arange(3), [torch.ones(2)]), "none": None}


def test_checkpoint_round_trips_a_nested_tree(tmp_path):
    path = str(tmp_path / "sub" / "ck.npz")
    tree = _tree()
    save_pytree(path, tree)
    got = load_pytree(path, _tree())
    assert isinstance(got["carry"], FastCarry) and got["none"] is None
    assert _equal_trees(got["carry"], tree["carry"])
    assert _equal_trees(got["pair"], tree["pair"])
    assert int(got["done"]) == 3 and got["done"].dtype == torch.int64
    assert torch.equal(got["fe"], torch.arange(5.0, dtype=torch.float64))


@pytest.mark.parametrize("change", ["drop_key", "other_namedtuple", "extra_leaf"])
def test_checkpoint_refuses_another_structure(tmp_path, change):
    path = str(tmp_path / "ck.npz")
    save_pytree(path, _tree())
    like = _tree()
    if change == "drop_key":
        del like["done"]
    elif change == "other_namedtuple":
        like["carry"] = MvGaussianNat(torch.zeros(4), torch.eye(4))
    else:
        like["pair"] = (torch.arange(3), [torch.ones(2), torch.ones(1)])
    with pytest.raises(ValueError, match="structure does not match"):
        load_pytree(path, like)


def test_chunked_run_in_chunks_is_one_run():
    """3 epochs of the fast trainer in chunks of 2 (2 + 1, each resumed from
    the last carry) are the 3-epoch call, bit for bit."""
    r = np.random.default_rng(4)
    Xu = torch.as_tensor(r.standard_normal((12, 3)))
    Xb, yb = torch.as_tensor(r.standard_normal((4, 16, 3))), torch.as_tensor(
        r.standard_normal((4, 16)))
    th0 = torch.zeros(4, dtype=torch.float64)
    prior = MvGaussianNat(torch.zeros(12, dtype=torch.float64),
                          torch.eye(12, dtype=torch.float64) / 50.0)
    calls = []

    def step(e, st):
        calls.append(e)
        return fit_kin40k_fast(krunner.Kernel("se", "softplus"), th0, Xu, Xb, yb, prior, 100.0, e,
                               resume_state=st)

    chunked = chunked_run(step, 3, 2, None)
    whole = fit_kin40k_fast(krunner.Kernel("se", "softplus"), th0, Xu, Xb, yb, prior, 100.0, 3)
    assert calls == [2, 1]
    assert _equal_trees(tuple(chunked[3]), tuple(whole[3]))
    assert chunked_run(step, 0, 2, None) is None


def test_configs_are_the_jax_packages():
    assert configs.__all__ == jconfigs.__all__
    for name in configs.__all__:
        assert dataclasses.asdict(getattr(configs, name)()) == \
            dataclasses.asdict(getattr(jconfigs, name)())


def test_metrics_logger_is_the_jax_packages(tmp_path):
    port, jaxl = MetricsLogger(), jlogging.MetricsLogger()
    for lg in (port, jaxl):
        for i, v in enumerate((3.0, 2.5, 2.25)):
            lg.log("fe", v)
        lg.log("smse", 0.08, step=40)
    assert port.summary() == jaxl.summary() == {"fe": 2.25, "smse": 0.08}
    assert port.last("fe") == 2.25
    port.to_json(str(tmp_path / "m.json"))
    port.to_csv(str(tmp_path / "m.csv"))
    series = json.loads((tmp_path / "m.json").read_text())
    assert [r["step"] for r in series["fe"]] == [0, 1, 2] and series["smse"][0]["step"] == 40
    assert (tmp_path / "m.csv").read_text().splitlines()[0] == "name,step,t,value"


# --- the pendulum runner ----------------------------------------------------------

PEND = dict(epochs=TPR.EPOCHS, n_iters=TPR.N_ITERS, adamax_steps=8, device="cpu")
SP_SWEEPS = 30  # the runner's 150 final sweeps, cut for time


def _jax_sp_smoothing(theta):
    """The JAX runner's ``--sp=2`` final smoothing from θ: ``gpssm_vmp_sp``
    over 2 devices, ``SP_SWEEPS`` sweeps; then the filter."""
    x_state, y_obs, _, P, _ = datasets.pendulum()
    y, yt = jnp.asarray(y_obs[:300]), jnp.asarray(y_obs[300:])
    Xu = jnp.asarray(datasets.pendulum_inducing())
    M, D = 48, 2
    prior = (jnp.asarray(P), jnp.asarray([1.6, 0.0]), 0.1 * jnp.eye(2),
             JNat(jnp.zeros(M * D), jnp.eye(M * D) / 50.0), 100.0, jnp.eye(2))
    theta = jnp.asarray(theta)
    mesh = jmake_mesh(jax.devices()[:2], axis="sp")
    state, _ = jsp.gpssm_vmp_sp(JK, theta, Xu, jsp.shard_chain_data(mesh, y), *prior, mesh=mesh,
                                n_iters=SP_SWEEPS)
    pm, _ = jc.one_step_ahead(JK, theta, Xu, state, yt, prior[0])
    return dict(smse_smooth=TPR._smse(x_state[:300], np.asarray(state.x_means[1:])),
                smse_predict=TPR._smse(x_state[300:], np.asarray(pm)))


def test_pendulum_sp_on_two_gloo_ranks_matches_the_jax_runner(monkeypatch):
    """``--device cpu --sp=2``: the hyperparameter epochs are the runner's
    without ``--sp``, bit for bit (``test_torch_pendulum_runner.py`` holds
    those to the JAX runner at these settings); the final Jacobi sweeps
    (``SP_SWEEPS`` of them) on 2 spawned gloo ranks from their θ, against
    the JAX runner's ``--sp=2`` smoothing on 2 devices from the same θ."""
    monkeypatch.setattr(prunner, "SMOOTHING_SWEEPS", SP_SWEEPS)
    out = prunner.run(sp_ranks=2, **PEND)
    one = prunner.run(**PEND)
    assert out["final_smoothing"] == f"sp_jacobi({SP_SWEEPS}, 2 ranks)" and out["finite"]
    assert out["theta"] == one["theta"] and out["fe_trace"] == one["fe_trace"]
    ref = _jax_sp_smoothing(out["theta"])
    for key in ("smse_smooth", "smse_predict"):
        assert _rel(out[key], ref[key]) <= TPR.RTOL, (key, _rel(out[key], ref[key]))


def test_pendulum_sp_rank_count_is_checked_before_training():
    with pytest.raises(ValueError, match="do not shard evenly"):
        prunner.run(sp_ranks=7, **PEND)
    with pytest.raises(ValueError, match="cards"):
        prunner.check_sp_ranks(torch.cuda.device_count() + 2, "cuda")
    with pytest.raises(SystemExit):
        prunner.main(["1", "--device", "cpu", "--sp=7"])


@pytest.fixture
def short_pendulum(monkeypatch):
    """The pendulum runner with 2 final (and UT) sweeps: the options under
    test act on the hyperparameter epochs."""
    monkeypatch.setattr(prunner, "SMOOTHING_SWEEPS", 2)


@pytest.mark.parametrize("mstep", ["lbfgs", "adamax"])
def test_pendulum_chunks_and_resume_are_one_run(short_pendulum, tmp_path, mstep):
    """Epochs in chunks of 1 with a checkpoint after each, and a run of 2
    epochs resumed from the checkpoint of a 1-epoch run, are the 2-epoch
    run: θ, the free-energy trace and the scores bit for bit (the AdaMax
    M-step carries its optimizer state through the checkpoint; at a
    constant rate, as ``--faithful`` runs it, since a decaying rate's
    schedule spans the run's epochs)."""
    kw = dict(PEND, use_lbfgs=mstep == "lbfgs", adamax_steps=8 if mstep == "lbfgs" else 3,
              adamax_decay=1.0)
    whole = prunner.run(**kw)
    chunked = prunner.run(chunk=1, checkpoint_path=str(tmp_path / "c.npz"), **kw)
    ck = str(tmp_path / "r.npz")
    prunner.run(**dict(kw, epochs=1), checkpoint_path=ck)
    resumed = prunner.run(checkpoint_path=ck, **kw)
    for got in (chunked, resumed):
        for key in ("theta", "fe_trace", "smse_smooth", "smse_predict"):
            assert got[key] == whole[key], key
    assert resumed["lbfgs_evaluations"] < whole["lbfgs_evaluations"] or mstep == "adamax"


def test_pendulum_command_line_takes_the_options(short_pendulum, tmp_path, capsys):
    ck = tmp_path / "ck.npz"
    assert prunner.main(["1", "--device", "cpu", "--chunk=1", f"--ckpt={ck}"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ck.exists() and out["epochs"] == 1 and len(out["fe_trace"]) == 1


# --- the GPLVM runner --------------------------------------------------------------

GPLVM_N, GPLVM_FINAL, GPLVM_RTOL = 32, 12, 1e-7


@pytest.fixture(scope="module")
def tiny_gplvm():
    """The GPLVM runner at N = 32 rows and 12 final sweeps (two blocks of 6
    when chunked)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(grunner, "oil_flow_synthetic",
                   lambda seed: datasets.oil_flow_synthetic(seed, GPLVM_N))
        mp.setattr(grunner, "FINAL_SWEEPS", GPLVM_FINAL)
        yield


@pytest.fixture(scope="module")
def gplvm_chunked(tiny_gplvm, tmp_path_factory):
    """2 gradient epochs in chunks of 1, checkpointed after each; returns
    the result and a copy of the checkpoint written after epoch 1."""
    d = tmp_path_factory.mktemp("gplvm")
    saved = []

    def save_and_keep(path, tree):
        save_pytree(path, tree)
        saved.append(str(d / f"epoch{len(saved) + 1}.npz"))
        shutil.copy(path, saved[-1])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(grunner, "save_pytree", save_and_keep)
        res = _gplvm(grad_epochs=2, chunk=1, checkpoint_path=str(d / "g.npz"))
    assert len(saved) == 2
    return res, saved[0]


def _gplvm(**kw):
    return grunner.run(n_iters=1, grad=True, verbose=False, device="cpu", **kw)


def _jax_gplvm_chunked(epochs):
    """The JAX runner's chunked path: ``fit_gplvm_grad`` one epoch at a time
    from the explicit cold state, then the final sweeps as warm-started
    blocks of 6."""
    Y_np, _ = datasets.oil_flow_synthetic(0, GPLVM_N)
    mean_X = grunner.pca_2d(Y_np)
    pos = np.random.default_rng(86).permutation(GPLVM_N)[:30]
    Y, Xm, Xu = jnp.asarray(Y_np), jnp.asarray(mean_X), jnp.asarray(mean_X[pos])
    theta = jnp.asarray(grunner.THETA0)
    state, fes = jg.gplvm_init_state(JK, theta, Xu, Y, Xm), []
    for _ in range(epochs):
        theta, state, fe_c = jg.fit_gplvm_grad(JK, theta, Xu, Y, Xm, epochs=1, n_iters=1,
                                               init_state=state)
        fes += [float(f) for f in np.asarray(fe_c)]
    state, fe = jg.gplvm_init_state(JK, theta, Xu, Y, Xm), None
    for _ in range(GPLVM_FINAL // 6):
        state, fe = jg.gplvm_vmp(JK, theta, Xu, Y, Xm, n_iters=6, init_state=state)
    return dict(theta=np.asarray(theta), fe_trace=fes, fe=float(fe),
                latents=np.asarray(state.x_means))


def test_gplvm_chunked_run_matches_the_jax_runner(gplvm_chunked):
    res, _ = gplvm_chunked
    want = _jax_gplvm_chunked(2)
    errs = {k: _rel(res[k], want[k]) for k in ("theta", "fe_trace", "fe", "latents")}
    assert max(errs.values()) <= GPLVM_RTOL, errs


def test_gplvm_resume_is_one_run(tiny_gplvm, gplvm_chunked, tmp_path):
    """A 2-epoch run resumed from the checkpoint written after epoch 1 is
    the 2-epoch run: θ, the FE trace, the final FE and the latents bit for
    bit."""
    whole, after_one = gplvm_chunked
    ck = str(tmp_path / "g.npz")
    shutil.copy(after_one, ck)
    resumed = _gplvm(grad_epochs=2, chunk=1, checkpoint_path=ck)
    for key in ("theta", "fe_trace", "fe"):
        assert resumed[key] == whole[key], key
    assert np.array_equal(resumed["latents"], whole["latents"])


# --- the kin40k runner -------------------------------------------------------------

KIN = dict(m_inducing=16, batch_size=50, n_train=200, n_test=100, device="cpu",
           dtype=torch.float64)


def _jax_kin40k(epochs, chunk, faithful=False, xu=None, learning_rate=1e-3, stats_refreshes=1,
                ns_budget=34):
    """The JAX runner's ``run`` on the port's synthetic data, float64."""
    ds = datasets.kin40k_synthetic(1, n_test=KIN["n_test"])
    f64 = jnp.float64
    n, b = KIN["n_train"], KIN["batch_size"]
    if xu is None:
        xu = ds.x_train[np.random.default_rng(1).permutation(n)[:KIN["m_inducing"]]]
    Xu = jnp.asarray(xu, f64)
    M = Xu.shape[0]
    Xb = jnp.asarray(ds.x_train[:n], f64).reshape(n // b, b, -1)
    yb = jnp.asarray(ds.y_train[:n], f64).reshape(n // b, b)
    kernel = JKernel("se", transform="softplus")
    theta0 = jnp.log(jnp.expm1(jnp.ones(9, f64)))
    prior = JNat(jnp.zeros(M, f64), jnp.eye(M, dtype=f64) / 50.0)
    if faithful:
        theta, nat, _ = jdriver.chunked_run(
            lambda e, st: jmb.fit_kin40k(kernel, theta0, Xu, Xb, yb, prior, 1e4, e,
                                         learning_rate=learning_rate, resume_state=st,
                                         ns_budget=ns_budget), epochs, chunk, None)
        cov = jla.spd_inverse_ns(jla.sym(nat.prec), iters=60)
    else:
        groups = max(1, min(stats_refreshes, Xb.shape[0]))
        theta, nat, cov, _ = jdriver.chunked_run(
            lambda e, st: jmb.fit_kin40k_fast(kernel, theta0, Xu, Xb, yb, prior, 1e4, e,
                                              learning_rate=learning_rate,
                                              stats_refreshes=stats_refreshes, resume_state=st),
            epochs, chunk, jmb.init_kin40k_fast_state(theta0, prior, M, groups))
    mu = jla.ir_solve(jla.sym(nat.prec), nat.xi, cov, rounds=4)
    mean, _ = jpredict_out(kernel, theta, Xu, jnp.asarray(ds.x_test, f64), mu, 1e4)
    smse = float(np.mean((ds.y_test - np.asarray(mean)) ** 2) / np.var(ds.y_test, ddof=1))
    return np.asarray(jax.nn.softplus(theta)), smse


@pytest.mark.parametrize("faithful", [False, True], ids=["fast", "faithful"])
def test_kin40k_chunked_run_matches_the_jax_runner(monkeypatch, faithful):
    """3 epochs in chunks of 2 through ``chunked_run`` (the runner's chunk
    sizes, 100 and max(10, ⌊50·34/budget⌋), cut to 2)."""
    monkeypatch.setattr(krunner, "FAST_CHUNK", 2)
    monkeypatch.setattr(krunner, "faithful_chunk", lambda budget: 2)
    out = krunner.run(epochs=3, faithful=faithful, ns_budget=20, **KIN)
    theta, smse = _jax_kin40k(3, 2, faithful=faithful, ns_budget=20)
    assert round(out["smse"], 6) == round(smse, 6)
    assert np.abs(np.asarray(out["theta_softplus"]) - theta).max() <= 1e-10


def test_kin40k_xu_learning_rate_and_refreshes_match_the_jax_runner(tmp_path):
    """``xu`` (12 given inducing inputs, read from a .npy file as the
    command line does), learning rate 0.01 and 2 statistics refreshes per
    epoch."""
    xu = np.random.default_rng(9).standard_normal((12, 8))
    np.save(tmp_path / "xu.npy", xu)
    out = krunner.run(epochs=2, xu=krunner.load_xu(str(tmp_path / "xu.npy")),
                      learning_rate=0.01, stats_refreshes=2, **KIN)
    theta, smse = _jax_kin40k(2, 100, xu=xu, learning_rate=0.01, stats_refreshes=2)
    assert out["m_inducing"] == 12 and out["stats_refreshes"] == 2
    assert round(out["smse"], 6) == round(smse, 6)
    assert np.abs(np.asarray(out["theta_softplus"]) - theta).max() <= 1e-10


# --- pit_bench ----------------------------------------------------------------------

PIT = dict(n_pit=2, n_polish=4, jacobi_chunk=10, sweep_cap=20, verbose=False)
TIMES = {"pit_seconds", "jacobi_seconds_to_pit_fe", "jacobi_sweep_ms", "speedup_to_fixed_point"}


def _regular_grid():
    g1, g2 = np.meshgrid(np.linspace(-2, 2, 4), np.linspace(-4, 4, 3), indexing="ij")
    return np.stack([g1.ravel(), g2.ravel()], 1)


def test_pit_bench_row_matches_the_jax_bench_at_small_t(monkeypatch):
    """T = 32, 2 PIT and 4 polish sweeps, a Jacobi race in chunks of 10 to
    20 sweeps; on the chain smoother tests' regular 4×3 inducing grid (on
    the pendulum's own grid, κ(Kuu) ≈ 3e13, the two packages' free
    energies differ by ~2e-3 relative after so few sweeps: the spread of
    their Kuu⁻¹). Every figure of the row but the times, as rounded for
    the row, is JAX's."""
    for mod in (pit_bench, jax_pit_bench):
        monkeypatch.setattr(mod, "pendulum_inducing", _regular_grid)
    got = pit_bench.bench_one(32, device="cpu", **PIT)
    want = jax_pit_bench.bench_one(32, **PIT)
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in TIMES} == \
        {k: v for k, v in want.items() if k not in TIMES}


def test_pit_bench_writes_rows_after_every_t(monkeypatch, tmp_path):
    """The parent runs one process per T and merges each row into ``--out``
    as it comes; a T whose process fails ends the run with its exit code,
    once, with the rows before it kept and no later T run."""
    out = tmp_path / "rows.json"
    out.write_text(json.dumps({"rows": [{"T": 8, "device": "cpu", "old": True},
                                        {"T": 64, "device": "cpu", "kept": True}]}))
    ran = []

    def fake_run(cmd, **kw):
        T = int(next(a for a in cmd if a.startswith("--one-T=")).split("=")[1])
        row_out = next(a for a in cmd if a.startswith("--row-out=")).split("=", 1)[1]
        ran.append(T)
        if T != 16:
            with open(row_out, "w") as f:
                json.dump({"T": T, "device": "cpu"}, f)
            return type("P", (), {"returncode": 0})()
        return type("P", (), {"returncode": 3})()

    monkeypatch.setattr(pit_bench.subprocess, "run", fake_run)
    assert pit_bench.main(["--T=8,16,32", f"--out={out}", "--device", "cpu"]) == 3
    assert ran == [8, 16]
    rows = json.loads(out.read_text())["rows"]
    assert [r["T"] for r in rows] == [8, 64]
    assert "old" not in rows[0] and rows[1]["kept"]
