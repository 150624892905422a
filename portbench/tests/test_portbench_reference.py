"""The plain references against the port at tiny sizes in float64: the
collapsed bound, its gradient and the first AdaMax steps; μ_v and the served
answers."""

import math

import pytest
import torch

from gaussianprocessnode_tpu_torch.dists import GammaShapeRate, MvGaussianNat
from gaussianprocessnode_tpu_torch.infer import svgp
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
from gaussianprocessnode_tpu_torch.serve import SGPClassifier, SGPRegressor
from portbench import data
from portbench.reference import collapsed_vsgp, sgp_serve
from portbench.reference.se import se_gram, softplus

F64 = torch.float64
KERNEL = Kernel("se", transform="softplus")
CFG = {"input_dim": 3, "num_inducing": 12, "num_train": 80, "noise_precision": 1e4,
       "collapsed_noise": 0.01, "jitter": 1e-5,
       "theta": {"variance": 0.5, "lengthscales": [1.5, 2.0, 0.8]},
       "optimizer": {"learning_rate": 0.05, "b1": 0.9, "b2": 0.999, "eps": 1e-8}}


@pytest.fixture(scope="module")
def problem():
    torch.set_num_threads(1)
    g = data.generator(2**31 + 11, "cpu")
    X, y = data.training_set(dict(CFG, data="kin40k_like"), g, "cpu")
    Xu = data.inducing_rows(X, CFG["num_inducing"], g)
    theta = torch.tensor([0.3, -0.2, 0.5, 0.1], dtype=F64)
    return X, y, Xu, theta


def test_se_gram_matches_the_ports(problem):
    X, _, Xu, theta = problem
    sp = softplus(theta)
    torch.testing.assert_close(se_gram(Xu, X, sp[0], sp[1:]), KERNEL(theta, Xu, X),
                               rtol=1e-13, atol=1e-15)


def test_collapsed_bound_and_gradient(problem):
    X, y, Xu, theta = problem
    a = theta.clone().requires_grad_(True)
    b = theta.clone().requires_grad_(True)
    ref = collapsed_vsgp.neg_elbo(a, Xu, X, y, 0.01, 1e-5)
    port = svgp.collapsed_neg_elbo(KERNEL, b, Xu, X, y, 0.01, 1e-5)
    assert ref.item() == pytest.approx(port.item(), rel=1e-12)
    (ga,), (gb,) = torch.autograd.grad(ref, a), torch.autograd.grad(port, b)
    torch.testing.assert_close(ga, gb, rtol=1e-9, atol=1e-9)


def test_first_adamax_steps(problem):
    X, y, Xu, _ = problem
    theta0 = torch.full((4,), math.log(math.expm1(1.0)), dtype=F64)
    ref = collapsed_vsgp.first_steps(theta0, Xu, X, y, CFG, 3)
    lr = CFG["optimizer"]["learning_rate"]
    th, st, tr1 = svgp.fit_svgp_collapsed_resumable(
        KERNEL, theta0, svgp.collapsed_opt_init(theta0, lr), Xu, X, y, 0.01, steps=1,
        learning_rate=lr, jitter=1e-5)
    grad = st["mu"] / (1 - CFG["optimizer"]["b1"])
    th, st, tr2 = svgp.fit_svgp_collapsed_resumable(KERNEL, th, st, Xu, X, y, 0.01, steps=2,
                                                    learning_rate=lr, jitter=1e-5)
    torch.testing.assert_close(torch.cat([tr1, tr2]), ref["losses"], rtol=1e-11, atol=0)
    torch.testing.assert_close(grad, ref["grad"], rtol=1e-8, atol=1e-10)
    torch.testing.assert_close(th - theta0, ref["change"], rtol=1e-8, atol=1e-12)


def _state(X, Xu, y, w):
    sp = torch.tensor([0.5, 1.5, 2.0, 0.8], dtype=F64)
    K = se_gram(Xu, X, sp[0], sp[1:])
    prec = torch.eye(Xu.shape[0], dtype=F64) / 50.0 + w * K @ K.T
    return sp, prec, w * K @ y


def test_served_answers(problem):
    X, y, Xu, _ = problem
    sp, prec, xi = _state(X, Xu, y, 1e4)
    theta = sp + torch.log(-torch.expm1(-sp))
    Xt = torch.randn(50, 3, generator=data.generator(3, "cpu"), dtype=F64)
    mu = sgp_serve.mu_v(xi, prec)
    mean, var, scale = sgp_serve.predict(sp[0], sp[1:], Xu, Xt, mu, 1e4)
    h = SGPRegressor.from_natural(KERNEL, theta, Xu, MvGaussianNat(xi, prec),
                                  torch.tensor(1e4, dtype=F64), dtype=F64, device="cpu")
    torch.testing.assert_close(h.mu_v, mu, rtol=1e-7, atol=1e-9 * float(mu.abs().max()))
    m, v = h(Xt)
    assert float((m - mean).abs().max() / scale.max()) < 1e-9
    torch.testing.assert_close(v, var, rtol=1e-15, atol=0)
    c = SGPClassifier.from_natural(KERNEL, theta, Xu, MvGaussianNat(xi, prec),
                                   GammaShapeRate(torch.tensor(2.0e4, dtype=F64),
                                                  torch.tensor(2.0, dtype=F64)),
                                   dtype=F64, device="cpu")
    p = sgp_serve.probabilities(mean, var)
    assert float((c.probabilities(Xt) - p).abs().max()) < 1e-9
