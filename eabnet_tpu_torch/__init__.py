"""eabnet_tpu_torch: the PyTorch/CUDA port of eabnet_tpu for NVIDIA Hopper.

Offline enhancement of 9-mic, 16 kHz audio with a model trained by the JAX
package (``inference.load_enhancer``). The two TPU kernels of that path, the
LSTM beamforming recurrence and the squeezed-TCN chain, are hand-written
CUDA kernels (``csrc/``) built with nvcc at first use. A tensor's device
picks the path: CUDA tensors go through the kernels, CPU tensors through
their plain PyTorch versions. The package imports torch, numpy and scipy,
and nothing of JAX or of the JAX package.
"""

__version__ = "0.1.0"
