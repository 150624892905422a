"""gaussianprocessnode_tpu_torch — the PyTorch/CUDA port of gaussianprocessnode_tpu.

The layout mirrors the JAX package module for module, so each function here
has one JAX counterpart that the tests hold it against. The port imports
torch and numpy only; it keeps its own copies of what it needs rather than
importing the JAX package (whose ``__init__`` imports jax).

Ported so far (kin40k regression and banana probit classification, their
trainers and serving paths):
    config                 jitter constants, dtype and the f32 precision pin
    dists                  Gaussian / MvGaussian / MvGaussianNat /
                           GammaShapeRate, ``mv_nat_to_meancov``
    ops.kernels            stationary Grams and ``Kernel``
    ops.se_gram            the hand-written CUDA SE Gram (``ops/csrc/se_gram.cu``)
    ops.linalg             jitter, Newton–Schulz SPD inverse (with its VJP),
                           iterative refinement
    ops.quadrature         the Gauss–Hermite rule (the probit node's subset)
    nodes.probit           probit tilted moments (closed form and GH-32),
                           average energy, the :out probability
    objectives             ``neg_log_backwardmess_gram``
    infer.batch_vmp        ``predict_out``, ``predict_probit``
    infer.minibatch        ``fit_kin40k_fast``, ``fit_kin40k``,
                           ``fit_banana_fast``, ``fit_banana`` and their AdaMax
                           chain
    serve                  ``SGPRegressor``, ``SGPClassifier``, ``serve_fused``,
                           throughput timers
    convert                the JAX package's arrays → a serving handle or a
                           trainer carry
    utils.datasets         the kin40k and banana loaders and synthetic data of
                           their shapes
    utils.metrics          SMSE, error counts
    experiments.kin40k     the kin40k training run on the card
    experiments.banana     the banana classification run on the card
"""

from . import config as config  # noqa: F401  (side effect: precision pin)
from .dists import GammaShapeRate, Gaussian, MvGaussian, MvGaussianNat  # noqa: F401
from .ops.kernels import Kernel, invsoftplus, softplus  # noqa: F401

__version__ = "0.1.0"
