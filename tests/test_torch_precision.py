"""``float32_products``: TF32 off for cuDNN and matmuls inside the block on
a CUDA device, the caller's flags back after (also when the block raises),
nothing changed for another device. The flags are process settings, so
this runs without a card."""

import pytest
import torch

from eabnet_tpu_torch.utils.precision import float32_products


def flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark,
            torch.backends.cudnn.deterministic)


@pytest.fixture
def tf32_on():
    saved = flags()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield flags()
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved[:2]


@pytest.mark.parametrize("raises", [False, True], ids=["returns", "raises"])
def test_cuda_block_runs_without_tf32_and_restores(tf32_on, raises):
    try:
        with float32_products("cuda"):
            assert flags()[:2] == (False, False)
            assert flags()[2:] == tf32_on[2:]
            if raises:
                raise KeyError("inside")
    except KeyError:
        assert raises
    assert flags() == tf32_on


def test_cpu_block_changes_nothing(tf32_on):
    with float32_products(torch.device("cpu")):
        assert flags() == tf32_on
    assert flags() == tf32_on
