"""The port's ``config`` (gaussianprocessnode_tpu_torch/config.py) against
the JAX package's: the jitter and clamp constants, ``default_dtype()`` and
``x64_enabled()``, under the test environment's ``GPNODE_X64`` and, in
fresh interpreters, under each spelling that switches float64 off or on."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu import config as jcfg
from gaussianprocessnode_tpu_torch import config as tcfg

ROOT = Path(__file__).resolve().parent.parent
CONSTANTS = ("JITTER_KUU", "JITTER_PSI2", "JITTER_KUU_SSM", "VAR_FLOOR", "CLAMP_LO",
             "CLAMP_HI")


@pytest.mark.parametrize("name", CONSTANTS)
def test_constant_matches_jax(name):
    assert getattr(tcfg, name) == getattr(jcfg, name)
    assert type(getattr(tcfg, name)) is type(getattr(jcfg, name))


def test_dtype_and_x64_match_jax_under_this_environment():
    assert tcfg.x64_enabled() is jcfg.x64_enabled()
    assert tcfg.x64_enabled() == (tcfg.default_dtype() == torch.float64)
    assert str(tcfg.default_dtype()).removeprefix("torch.") == np.dtype(
        jcfg.default_dtype()).name


_PROBE = """
import json, numpy as np
from gaussianprocessnode_tpu import config as j
from gaussianprocessnode_tpu_torch import config as t
print(json.dumps([j.x64_enabled(), t.x64_enabled(), np.dtype(j.default_dtype()).name,
                  str(t.default_dtype()).removeprefix("torch.")]))
"""


@pytest.mark.parametrize("value", ["0", "false", "False", "1", "yes"])
def test_dtype_and_x64_match_jax_under_gpnode_x64(value):
    """A fresh interpreter per value, since both modules read
    ``GPNODE_X64`` once, at import."""
    env = {**os.environ, "GPNODE_X64": value, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    jx64, tx64, jdt, tdt = json.loads(out.stdout.strip().splitlines()[-1])
    assert jx64 is tx64 is (value not in ("0", "false", "False"))
    assert jdt == tdt == ("float64" if jx64 else "float32")
