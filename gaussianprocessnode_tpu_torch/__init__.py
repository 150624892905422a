"""gaussianprocessnode_tpu_torch — the PyTorch/CUDA port of gaussianprocessnode_tpu (JAX, TPU).

The layout mirrors the JAX package module for module, so each function here
has one JAX counterpart that the tests hold it against. The port imports
torch, numpy and scipy (and h5py to read JLD files); it keeps its own copies
of what it needs rather than importing the JAX package (whose ``__init__``
imports jax).

Ported so far (kin40k regression and banana probit classification, their
trainers and serving paths; the toy regression and classification
workloads with the UniSGP node, quadrature, Ψ-statistics, batch VMP and the
L-BFGS trainers; the VSGP and FITC/SoR/DTC baselines; the MultiSGP node;
the GPSSM family with the pendulum runner; the GPLVM and the model
front-end; the legacy-notebook families with their runner; data, tensor
and sequence parallelism over torch.distributed):
    config                 jitter constants, dtype and the f32 precision pin
    dists                  Gaussian / MvGaussian / MvGaussianNat /
                           GammaShapeRate / Wishart / WishartFast /
                           PointMass, their products, moments and entropies
    ops.kernels            stationary Grams and ``Kernel``
    ops.se_gram            the hand-written CUDA SE Gram (``ops/csrc/se_gram.cu``)
    ops.linalg             jitter, Cholesky factors (NaN where not positive
                           definite) and solves, block contractions,
                           Newton–Schulz SPD inverse (with its VJP),
                           iterative refinement
    ops.quadrature         GH, SR, UT and GenUT rules, expectations, moment
                           matching (one product or a batch, univariate
                           and multivariate), GenUT
                           statistics and joint forms
    ops.scan               the associative (parallel prefix) scan
    ops.psi                exact and expected Ψ-statistics
    nodes.unisgp           the UniSGP node's rules and average energies
    nodes.probit           probit tilted moments (closed form and GH-32),
                           average energy, the :out probability
    nodes.multisgp         the MultiSGP node's rules (Laplace in-message
                           included) and average energy (one node or many)
    objectives             ``neg_log_backwardmess_fast`` / ``_uncertain`` /
                           ``_multi`` / ``_gram`` and their gradients
    infer.batch_vmp        ``regression_vmp``, ``classification_vmp``,
                           ``predict_out``, ``predict_probit``
    infer.training         optax's L-BFGS with its zoom linesearch,
                           ``fit_regression``, ``fit_classification``
    infer.minibatch        ``fit_kin40k_fast``, ``fit_kin40k``,
                           ``fit_banana_fast``, ``fit_banana`` and their AdaMax
                           chain
    infer.svgp             the whitened/centered SVGP, its ELBOs, the
                           collapsed Titsias bound and their trainers
    infer.fitc             SoR / DTC / FITC marginal likelihoods, prediction
                           and trainer
    infer.chain_smoother   the GPSSM chain smoother (Jacobi and Gauss–Seidel),
                           its free energy, the 1-step-ahead filter
    infer.ut_smoother      the UT smoother with known dynamics
    infer.pit_gpssm        the parallel-in-time GPSSM engine
    infer.gpssm_control    the controlled GPSSM
    infer.gplvm            the GPLVM (batched Laplace L-BFGS), its embedding
    infer.model            the model front-end classes
    infer.sde_gp           the Matérn-5/2 SDE GP: Kalman/RTS smoothing,
                           sequential or parallel in time, and its NLML
    infer.tprocess         the dense GP and the Student-t process posteriors
    infer.fullcov_gp       the full-covariance GP with q(θ) and q(γ)
    infer.gppad            GP-PAD, white and colored carrier (parallel EP)
    infer.pad_learn        EP evidence, ELBOs, lengthscale posteriors, EP-EM
                           and variational EM (implicit fixed-point
                           gradient), model banks
    serve                  ``SGPRegressor``, ``SGPClassifier``, ``GPSSMFilter``,
                           ``serve_fused``, ``shard_requests``, throughput
                           timers
    parallel.comm          process groups, the collectives (gloo / NCCL),
                           ``spawn_ranks``, ``single_rank_group``
    parallel.sharding      the data-parallel sweep, step and kin40k / banana
                           trainers
    parallel.tensor_parallel
                           the inducing-dimension (ring) sweep and prediction
    parallel.seq_parallel  the time-sharded GPSSM Jacobi smoother
    parallel.dryrun        one step of every parallel path on N ranks
    convert                the JAX package's arrays → a serving handle, a
                           trainer carry, a batch VMP result, VSGP / FITC
                           parameters or their AdaMax state, a GPSSM or UT
                           smoother state, a GPLVM, GP-PAD or
                           full-covariance GP state
    utils.datasets         the toy, kin40k, banana, oil-flow, co2 and
                           BTC-USD loaders, synthetic data of their
                           shapes, the pendulum data and its inducing grid
    utils.jld              the reference's JLD files (h5py)
    utils.metrics          SMSE, error counts
    utils.checkpoint       save / load a tree of tensors (one .npz)
    utils.configs          the workloads' configurations
    utils.tracing          spans of the serving path in memory, recorded
                           while turned on (off by default)
    utils.driver           ``chunked_run``
    utils.optim            bare optax AdaMax at Flux's defaults, optax's
                           Adam, scipy L-BFGS-B and Nelder–Mead over
                           torch objectives
    experiments.kin40k     the kin40k training run on the card
    experiments.banana     the banana classification run on the card
    experiments.toy_regression, experiments.toy_classification
                           the toy runs on the card
    experiments.vsgp_baselines
                           the VSGP / FITC baseline runs (the collapsed
                           kin40k run on the card)
    experiments.pendulum   the pendulum GPSSM run on the card
    experiments.gplvm      the GPLVM run on the card
    experiments.legacy_gp  the legacy-notebook workloads on the card
    experiments.pit_bench  long-chain smoothing, parallel in time against
                           Jacobi
"""

from . import config as config  # noqa: F401  (side effect: precision pin)
from .dists import GammaShapeRate, Gaussian, MvGaussian, MvGaussianNat  # noqa: F401
from .ops.kernels import Kernel, invsoftplus, softplus  # noqa: F401

__version__ = "0.1.0"
