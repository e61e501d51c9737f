"""PyTorch's default kernel initialiser for tests whose random models were
written with it: the port draws every Dense and conv kernel with the JAX
package's ``lecun_normal`` (``nn/blocks.py::lecun_normal_``); inside
``kaiming_init()`` it draws them with ``kaiming_uniform_(a=sqrt(5))`` in
the same order, so the same seed gives those tests the same weights, bit
for bit, as before the port took the JAX package's initialisers."""

import contextlib

import torch

from eabnet_tpu_torch.nn import blocks


@contextlib.contextmanager
def kaiming_init():
    draw = blocks.lecun_normal_
    blocks.lecun_normal_ = lambda w, fan_in: torch.nn.init.kaiming_uniform_(
        w, a=5 ** 0.5)
    try:
        yield
    finally:
        blocks.lecun_normal_ = draw


def kaiming_model(cfg):
    """``build_model(cfg)`` inside ``kaiming_init()``."""
    from eabnet_tpu_torch.models import build_model

    with kaiming_init():
        return build_model(cfg)
