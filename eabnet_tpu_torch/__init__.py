"""eabnet_tpu_torch: the PyTorch/CUDA port of eabnet_tpu for NVIDIA Hopper.

Offline enhancement of 9-mic, 16 kHz audio with a model trained by either
package (``inference.load_enhancer``), and training on one device
(``train.trainer.train``) with checkpoints both packages read. The TPU
kernels of those paths, the LSTM beamforming recurrence and the
squeezed-TCN chain, forward and backward, are hand-written CUDA kernels
(``csrc/``) built with nvcc at first use. A tensor's device picks the
path: CUDA tensors go through the kernels, CPU tensors through their plain
PyTorch versions. The package imports torch, numpy and scipy, and nothing
of JAX or of the JAX package.
"""

__version__ = "0.1.0"
