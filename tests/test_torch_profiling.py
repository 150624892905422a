"""The port's timing helpers (utils/profiling.py) where there is no card.

A device time can only come from a card: without one the helpers raise,
and none of them times the call on a host clock instead. Whether there is
a card is decided inside each test, not at import.
"""

import pytest
import torch

from gaussianprocessnode_tpu_torch.utils import profiling


def _need_no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")


@pytest.mark.parametrize("timer", ["cuda_graph_time_ms", "cuda_time_ms"])
def test_device_timers_raise_without_card(timer):
    _need_no_card()
    calls = []
    with pytest.raises((RuntimeError, AssertionError)):
        getattr(profiling, timer)(lambda: calls.append(1), iters=3, warmup=1)
    if timer == "cuda_graph_time_ms":
        assert calls == []  # refused before any call: no host-clock timing


def test_kernel_times_raise_without_card():
    _need_no_card()
    calls = []
    with pytest.raises(RuntimeError, match="CUDA card"):
        profiling.cuda_kernel_times(lambda: calls.append(1))
    assert calls == []


def test_synchronize_is_a_no_op_for_cpu():
    profiling.synchronize("cpu")
