"""Global configuration: jitter constants, default dtype and device, and the
float32 precision pin.

Counterpart of ``gaussianprocessnode_tpu/config.py``. The jitter constants
are the same values (reference call sites are listed there).

Precision: the JAX package pins every matmul to full f32 (``config.py:42``)
and the SE Gram's cross term to ``Precision.HIGHEST`` (``pallas_gram.py``),
because a low-precision cross term visibly degraded kin40k hyperparameter
learning (SMSE 0.080 → 0.091). The CUDA counterpart of that pin is to keep
TF32 off for matmuls and convolutions, set here at import.
"""

import os

import torch

_X64 = os.environ.get("GPNODE_X64", "1") not in ("0", "false", "False")

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

JITTER_KUU = 1e-8
JITTER_PSI2 = 1e-8
JITTER_KUU_SSM = 1e-12
VAR_FLOOR = 1e-6
CLAMP_LO = 1e-12
CLAMP_HI = 1e12


def default_dtype() -> torch.dtype:
    """float64 unless ``GPNODE_X64=0`` (as in the JAX package)."""
    return torch.float64 if _X64 else torch.float32


def x64_enabled() -> bool:
    """Whether float64 is the default (``GPNODE_X64``, on unless set to 0)."""
    return _X64


def default_device() -> str:
    """Entry points run on the card unless the caller passes another device."""
    return "cuda"
