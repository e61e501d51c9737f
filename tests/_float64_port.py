"""The port's one-process Enhancer in float64 on the CPU, the reference
against which the serving tests hold float32 paths at the JAX package's
init scale: the model cast, the STFT and iSTFT bases in float64, and the
two kernel wrappers replaced by their plain versions (the wrappers take
float32 and bf16 only). ``float64_port`` patches the port for the length
of a ``with`` block and restores it after."""

import contextlib

import numpy as np
import torch

from eabnet_tpu_torch import dsp, inference
from eabnet_tpu_torch.kernels.lstm_bf import double_lstm_reference
from eabnet_tpu_torch.kernels.tcm_chain import tcm_chain_reference
from eabnet_tpu_torch.models import eabnet
from eabnet_tpu_torch.nn import blocks

JAX_TEST_ATOL = 2e-5  # tests/test_inference_mesh.py:103


def _enhance64(self, batch, replica=0):
    model, _ = self.replicas[replica]
    noisy, _ = dsp.prepare_data(batch, None, self.cfg.stft)
    out = model(noisy.double())[self.output]
    return dsp.stft_to_wav(eabnet.to_reference_layout(out), self.cfg.stft)


@contextlib.contextmanager
def float64_port():
    saved = (blocks.tcm_chain, eabnet.double_lstm, dsp._constants,
             inference.Enhancer._enhance)
    consts = dsp._constants

    def constants64(n_fft, win_size, device, inverse):
        w, b = consts(n_fft, win_size, device, inverse)
        return w.double(), b.double()

    blocks.tcm_chain = lambda x, w, d, twin: tcm_chain_reference(x, w, d,
                                                                 twin)
    eabnet.double_lstm = double_lstm_reference
    dsp._constants = constants64
    inference.Enhancer._enhance = _enhance64
    try:
        yield
    finally:
        (blocks.tcm_chain, eabnet.double_lstm, dsp._constants,
         inference.Enhancer._enhance) = saved


def enhance64(cfg, tree, wavs, output="esti"):
    """Enhancer(cfg, tree, output).enhance_batch(wavs) in float64."""
    with float64_port():
        enh = inference.Enhancer(cfg, tree, output=output, device="cpu")
        enh.model.double()
        return enh.enhance_batch(wavs)


def scaled_error(got, ref) -> tuple:
    """(largest |got - ref|, its limit: the JAX test's 2e-5 times
    max(1, max |ref|))."""
    err = max(float(np.abs(np.asarray(g, np.float64) - r).max())
              for g, r in zip(got, ref))
    top = max(float(np.abs(r).max()) for r in ref)
    return err, JAX_TEST_ATOL * max(1.0, top)
