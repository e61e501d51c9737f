"""What the compute dtype "float32" means on the card: float32 products.

PyTorch lets cuDNN's convolutions take TF32 by default
(``torch.backends.cudnn.allow_tf32``), and a TF32 product keeps about
three decimal digits. ``float32_products(device)`` turns TF32 off for
cuDNN and for matmuls inside its block on a CUDA device and gives the
caller's flags back after; on another device it does nothing. The
``Enhancer`` and ``train()`` run under it.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def float32_products(device):
    if torch.device(device).type != "cuda":
        yield
        return
    matmul = torch.backends.cuda.matmul
    cudnn = torch.backends.cudnn
    matmul_tf32 = matmul.allow_tf32
    try:
        matmul.allow_tf32 = False
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = matmul_tf32
