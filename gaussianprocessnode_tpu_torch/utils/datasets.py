"""Dataset loaders and synthetic-data generators (L7 layer): the toy
workloads, kin40k, banana and the GPLVM's oil-flow data, the pendulum
GPSSM's data and inducing grid, and the legacy runner's two real-data
files (Mauna-Loa CO₂ and BTC-USD).

Counterpart of ``gaussianprocessnode_tpu/utils/datasets.py``; numpy and
scipy only. The port keeps its own copy of the loader: importing the JAX
package's module would run that package's ``__init__``, which imports jax.
"""

import os
from pathlib import Path
from typing import NamedTuple

import numpy as np

__all__ = ["REFERENCE_ROOT", "Dataset", "toy_sinc", "toy_classification",
           "toy_sinc_reference", "toy_classification_reference", "split2batch", "kin40k",
           "kin40k_synthetic", "banana", "banana_synthetic", "oil_flow", "oil_flow_synthetic",
           "pendulum", "pendulum_inducing", "co2", "btc_usd"]

_REPO = Path(__file__).resolve().parents[2]
# the reference's data files: $GPNODE_REFERENCE_DATA, else reference/ in the
# repository
REFERENCE_ROOT = os.environ.get("GPNODE_REFERENCE_DATA", str(_REPO / "reference"))

# the committed trained kin40k state (θ, ξ, Λ), the synthetic data's source
_TRAINED = _REPO / "benchmarks" / "kin40k_refxu_trained.npz"
_N_TRAIN = 10_000
_NOISE_PRECISION = 1e4  # kin40k's w


class Dataset(NamedTuple):
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray


def toy_sinc(n_train: int = 50, n_test: int = 600, precision: float = 100.0, seed: int = 3):
    """Toy 1-D sinc regression (reference: GPT_regression.ipynb cell 3), the
    JAX package's draw: numpy's generator from ``seed`` (the Julia stream
    differs; the statistics match). y_test is the noiseless sinc."""
    rng = np.random.default_rng(seed)
    xmin, xmax = -4.0, 4.0
    x = np.sort(rng.uniform(xmin, xmax, n_train))
    x_test = np.linspace(xmin - 0.1, xmax + 0.1, n_test)
    # Julia sinc(x) = sin(πx)/(πx); numpy.sinc is identical
    y = np.sinc(x) + rng.normal(size=n_train) * np.sqrt(1.0 / precision)
    f_true = np.sinc(x_test)
    return Dataset(x[:, None], y, x_test[:, None], f_true)


def toy_classification(n_train: int = 100, n_test: int = 400, seed: int = 7):
    """Toy 1-D probit classification (reference: GPT_classification.ipynb
    cell 3), the JAX package's draw: latent f ~ GP(0, 2·SE(ℓ=1.2)) drawn
    jointly at the train and test inputs, labels y ~ Bernoulli(Φ(f)). The
    default seed gives a draw whose Bayes error (39/400) matches the
    difficulty of the reference's Julia draw."""
    from scipy.spatial.distance import cdist
    from scipy.stats import norm

    rng = np.random.default_rng(seed)
    x_train = np.sort(rng.uniform(-5.0, 5.0, n_train))
    x_test = np.linspace(-5.0, 5.0, n_test)
    x_all = np.concatenate([x_train, x_test])
    d2 = cdist(x_all[:, None], x_all[:, None], "sqeuclidean")
    K = 2.0 * np.exp(-0.5 * d2 / 1.2**2) + 1e-6 * np.eye(len(x_all))
    f = np.linalg.cholesky(K) @ rng.standard_normal(len(x_all))
    y = (rng.uniform(size=len(x_all)) < norm.cdf(f)).astype(float)
    return Dataset(x_train[:, None], y[:n_train], x_test[:, None], y[n_train:])


def _load_savefiles(root, name):
    from .jld import load_jld

    d = os.path.join(root, "savefiles")
    parts = [os.path.join(d, f"{p}_{name}.jld") for p in ("xtrain", "ytrain", "xtest", "ytest")]
    for path in parts:
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
    x, y, xt, yt = (np.asarray(load_jld(path)) for path in parts)
    return Dataset(x[:, None], y, xt[:, None], yt)


def toy_sinc_reference(root: str = REFERENCE_ROOT):
    """The reference's own toy-regression draw (savefiles/*_toyregression.jld).
    Raises FileNotFoundError when the files are absent."""
    return _load_savefiles(root, "toyregression")


def toy_classification_reference(root: str = REFERENCE_ROOT):
    """The reference's own toy-classification draw
    (savefiles/*_toyclassification.jld). Raises FileNotFoundError when the
    files are absent."""
    return _load_savefiles(root, "toyclassification")


def split2batch(x, y, batch_size: int):
    """Minibatch splitter (reference: split2batch, gp_helperfunction.jl:137-142):
    arrays shaped (B, batch_size, ...); the trailing remainder is dropped."""
    n = (len(y) // batch_size) * batch_size
    xa, ya = np.asarray(x), np.asarray(y)
    xb = xa[:n].reshape(n // batch_size, batch_size, *xa.shape[1:])
    yb = ya[:n].reshape(n // batch_size, batch_size)
    return xb, yb


def kin40k(root: str = REFERENCE_ROOT):
    """kin40k regression: 10k train / 30k test, 8-D
    (reference: regression_kin40k.ipynb cell 3). Raises FileNotFoundError
    when the files are absent."""
    from scipy.io import loadmat

    d = os.path.join(root, "data", "kin40k")
    xtr = loadmat(os.path.join(d, "kin40k_xtrain.mat"))["xtrain"].astype(np.float64)
    ytr = loadmat(os.path.join(d, "kin40k_ytrain.mat"))["ytrain"].ravel().astype(np.float64)
    xte = loadmat(os.path.join(d, "kin40k_xtest.mat"))["xtest"].astype(np.float64)
    yte = loadmat(os.path.join(d, "kin40k_ytest.mat"))["ytest"].ravel().astype(np.float64)
    return Dataset(xtr, ytr, xte, yte)


def kin40k_synthetic(seed: int = 0, n_test: int = 30_000):
    """Data of kin40k's shape, for where the kin40k files are absent.

    10,000 training and ``n_test`` test inputs, standard normal in 8-D. The
    latent function is the mean of
    the committed trained kin40k model (``benchmarks/kin40k_refxu_trained.npz``:
    its SE θ and μ_v = Λ⁻¹ξ) placed at 600 standard-normal centres,
    f(x) = K_θ(C, x)ᵀ μ_v, scaled to unit variance over the training
    inputs: a fixed smooth function with the trained model's lengthscales.
    Training targets add N(0, 1/w) noise with kin40k's w = 1e4; test
    targets are the noise-free f. All draws come from ``seed``."""
    n_train = _N_TRAIN
    z = np.load(_TRAINED, allow_pickle=False)
    theta, xi, prec = z["theta"], z["xi"], z["prec"]
    sp = np.logaddexp(theta, 0.0)
    var, ls = sp[0], sp[1:]
    mu = np.linalg.solve(prec, xi)
    rng = np.random.default_rng(seed)
    D = ls.shape[0]
    C = rng.standard_normal((mu.shape[0], D))
    X = rng.standard_normal((n_train + n_test, D))

    def f(x):
        a, b = C / ls, x / ls
        d2 = np.sum(a * a, 1)[:, None] + np.sum(b * b, 1)[None, :] - 2.0 * a @ b.T
        return (var * np.exp(-0.5 * np.maximum(d2, 0.0))).T @ mu

    fx = np.concatenate([f(X[i:i + 4096]) for i in range(0, X.shape[0], 4096)])
    fx = fx / np.std(fx[:n_train])
    y_train = fx[:n_train] + rng.standard_normal(n_train) / np.sqrt(_NOISE_PRECISION)
    return Dataset(X[:n_train], y_train, X[n_train:], fx[n_train:])


def banana(root: str = REFERENCE_ROOT, n_train: int = 4000):
    """Banana 2-D classification, labels −1/1 → 0/1
    (reference: classification_banana.ipynb cell 3). Raises
    FileNotFoundError when the file is absent."""
    path = os.path.join(root, "data", "banana", "banana.csv")
    raw = np.genfromtxt(path, delimiter=",", skip_header=1)
    x = raw[:, :2].astype(np.float64)
    y = (raw[:, 2] > 0).astype(np.float64)  # replace -1 => 0
    return Dataset(x[:n_train], y[:n_train], x[n_train:], y[n_train:])


_BANANA_NOISE = 0.3  # standard deviation of the noise around each arc


def banana_synthetic(seed: int = 1, n_train: int = 4000, n_test: int = 1300):
    """Data of banana's shape, for where the banana file is absent: 2-D
    inputs, labels in {0, 1}, ``n_train`` + ``n_test`` points.

    Two interleaved curved arcs: class 1 on the upper half circle (cos t,
    sin t), class 0 on the lower arc (1 − cos t, ½ − sin t), t uniform on
    [0, π], each point moved by isotropic Gaussian noise of standard
    deviation 0.3, so the classes overlap and no classifier is free of
    errors. Labels alternate before one shuffle, so the two classes are
    equal over all points. Inputs are standardised with the training
    points' mean and deviation. All draws come from ``seed``."""
    n = n_train + n_test
    rng = np.random.default_rng(seed)
    y = rng.permutation(np.arange(n) % 2).astype(np.float64)
    t = rng.uniform(0.0, np.pi, n)
    x = np.where(y[:, None] == 1.0,
                 np.stack([np.cos(t), np.sin(t)], axis=1),
                 np.stack([1.0 - np.cos(t), 0.5 - np.sin(t)], axis=1))
    x = x + _BANANA_NOISE * rng.standard_normal((n, 2))
    mu, sd = x[:n_train].mean(axis=0), x[:n_train].std(axis=0)
    x = (x - mu) / sd
    return Dataset(x[:n_train], y[:n_train], x[n_train:], y[n_train:])


def oil_flow(root: str = REFERENCE_ROOT, n: int = 200):
    """3PhData oil-flow for GPLVM: the first ``n`` rows of 12-D outputs and
    their 3-class labels (reference: GPLVM.ipynb cells 4-6). Raises
    FileNotFoundError when the files are absent."""
    d = os.path.join(root, "3PhData")
    data = np.loadtxt(os.path.join(d, "DataTrn.txt"))[:n]
    labels = np.loadtxt(os.path.join(d, "DataTrnLbls.txt"))[:n]
    return data, labels.argmax(axis=1)


# the synthetic oil-flow map: latent spread per class and the frequency
# scale of the 2-D → 12-D map, chosen so that PCA mixes the classes
_OIL_SPREAD = 0.35
_OIL_FREQ = 2.5
_OIL_NOISE = 0.05


def oil_flow_synthetic(seed: int = 0, n: int = 200):
    """Data of 3PhData's shape, for where the oil-flow files are absent:
    ``n`` rows of 12-D outputs and labels in {0, 1, 2}.

    Each run of three rows holds the three labels in a random order (the
    classes are equal to within one row). Each row's 2-D latent is its
    class centre on the unit circle (angles 0, 2π/3, 4π/3) plus isotropic
    Gaussian noise of standard deviation 0.35, so the classes are
    near-separable in the plane. A fixed nonlinear map, y = sin(zA + b)
    with A (2, 12) Gaussian of scale 2.5 and b uniform phases, folds the
    plane into 12-D, and N(0, 0.05²) noise is added: the 2-D PCA
    projection then mixes the classes where the latents separate them.
    All draws, the map's included, come from ``seed``: the map from one
    stream, the labels, latents and noise from three more, row by row, so
    that the first ``k`` rows of a longer draw are the draw of ``k`` rows
    (rows past the runner's 200 are held-out rows of the same data)."""
    maps, lab, lat, noise = (np.random.default_rng(s)
                             for s in np.random.SeedSequence(seed).spawn(4))
    A = _OIL_FREQ * maps.standard_normal((2, 12))
    b = maps.uniform(0.0, 2.0 * np.pi, 12)
    labels = np.argsort(lab.random((-(-n // 3), 3)), axis=1).reshape(-1)[:n]
    ang = 2.0 * np.pi * labels / 3.0
    z = np.stack([np.cos(ang), np.sin(ang)], axis=1) + _OIL_SPREAD * lat.standard_normal((n, 2))
    Y = np.sin(z @ A + b) + _OIL_NOISE * noise.standard_normal((n, 12))
    return Y, labels


def pendulum(n: int = 700, max_time: float = 7.0, qc: float = 0.01, obs_var: float = 0.1,
             seed: int = 69):
    """Pendulum GPSSM data (reference: Pendulum_Wishart_2d.ipynb cells 4-5):

        x_{t+1} = [x1 + x2·Δt, x2 − 9.81·sin(x1)·Δt] + N(0, Q),  y = x + N(0, P),

    drawn by the same numpy recurrence from ``default_rng(seed)`` as the JAX
    package's ``pendulum``, so the arrays are equal bit for bit. Seed 69 is
    its difficulty-matched draw (the reference's Julia seed cannot be
    reproduced). Returns (states (n, 2), observations (n, 2), Q, P, Δt)."""
    rng = np.random.default_rng(seed)
    dt = max_time / (n - 1)
    Q = np.array([[qc * dt**3 / 3, qc * dt**2 / 2], [qc * dt**2 / 2, qc * dt]])
    P = obs_var * np.eye(2)
    Lq = np.linalg.cholesky(Q)
    Lp = np.linalg.cholesky(P)
    x_prev = np.array([1.5, 0.0])
    xs, ys = [], []
    for _ in range(n):
        x = np.array(
            [x_prev[0] + x_prev[1] * dt, x_prev[1] - 9.81 * np.sin(x_prev[0]) * dt]
        ) + Lq @ rng.standard_normal(2)
        y = x + Lp @ rng.standard_normal(2)
        xs.append(x)
        ys.append(y)
        x_prev = x
    return np.asarray(xs), np.asarray(ys), Q, P, dt


def pendulum_inducing():
    """The pendulum GPSSM's structured 48-point inducing grid in 2-D
    (reference: Pendulum cells 9, 13): pairs of points 1e-5 apart, so Kuu is
    near singular without jitter."""
    xu2_neg1 = np.linspace(-4, 0, 12)[::-1]
    xu2_neg2 = xu2_neg1[::-1] + 1e-5
    xu2_pos1 = np.linspace(1e-4, 4, 12)
    xu2_pos2 = xu2_pos1[::-1]
    xu2 = np.concatenate([xu2_neg1, xu2_neg2, xu2_pos1, xu2_pos2])
    xu1 = np.linspace(-2, 2, len(xu2) // 2)
    xu1 = np.concatenate([xu1[::-1], xu1 + 1e-5])
    return np.stack([xu1, xu2], axis=1)


def _existing(path):
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{path} is missing: the reference's data file is not in "
                                "the repository")
    return path


def co2(root: str = REFERENCE_ROOT):
    """Mauna-Loa CO₂ series (reference: data/co2data.csv, 1958–2024
    monthly). The file is semicolon-delimited with a leading empty column
    (``;year;month;decimal-date;monthly-average;de-seasonalized;…``).
    Returns (t, y): decimal dates and monthly averages (ppm), rows with a
    missing-value sentinel (≤ 0) dropped. Raises FileNotFoundError naming
    the path when the file is absent."""
    raw = np.genfromtxt(_existing(os.path.join(root, "data", "co2data.csv")),
                        delimiter=";", skip_header=1)
    t, y = raw[:, 3], raw[:, 4]
    keep = y > 0.0
    return t[keep], y[keep]


def btc_usd(root: str = REFERENCE_ROOT):
    """BTC-USD daily prices (reference: BTC-USD.csv, 365 rows). Returns
    (t, ohlcv): the day index (float) and the columns Open, High, Low,
    Close, Volume. Raises FileNotFoundError naming the path when the file
    is absent."""
    raw = np.genfromtxt(_existing(os.path.join(root, "BTC-USD.csv")),
                        delimiter=",", skip_header=1, usecols=(1, 2, 3, 4, 6))
    return np.arange(raw.shape[0], dtype=np.float64), raw
