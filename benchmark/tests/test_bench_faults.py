"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (tiny cells on the CPU, past the
harness's look for a card) with one fault planted in the program: an
answer altered where it is produced, half of the batch left out, a
training step that returns its state unchanged. The sound run of the
same cell comes out correct. One card only, so no exchange between
cards can be left out."""

from __future__ import annotations

import pytest
import torch

from benchmark.drivers import serve, train
from benchmark.tests.tiny import tiny_cell


def _serve(monkeypatch, fault=None):
    from eabnet_tpu_torch.inference import Enhancer

    real = Enhancer.enhance_batch
    if fault is not None:
        monkeypatch.setattr(Enhancer, "enhance_batch",
                            lambda self, wavs, *a: fault(real, self, wavs))
    result, checks, found = serve.run(tiny_cell("serve"), 31, 0.5, False,
                                      device="cpu")
    assert result["attempted"] > 0 and not found
    return result["correct"], {c.name: c.value for c in checks}


def test_sound_serving_is_correct(monkeypatch):
    correct, checks = _serve(monkeypatch)
    assert correct, checks


def test_an_altered_answer_is_not_correct(monkeypatch):
    def alter(real, self, wavs):
        out = real(self, wavs)
        out[0] = out[0] * 1.01
        return out

    correct, checks = _serve(monkeypatch, alter)
    assert not correct and checks["wav_err"] > 5e-3


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    def half(real, self, wavs):
        h = len(wavs) // 2
        out = real(self, wavs[:h])
        rest = [out[i % h][:w.shape[-1]] for i, w in enumerate(wavs[h:])]
        rest = [torch.nn.functional.pad(torch.from_numpy(r.copy()), (
            0, w.shape[-1] - r.shape[-1])).numpy()
            for r, w in zip(rest, wavs[h:])]
        return out + rest

    correct, _ = _serve(monkeypatch, half)
    assert not correct


def _train(monkeypatch, fault=None):
    import eabnet_tpu_torch.train.step as step_mod

    real_make = step_mod.make_train_step
    if fault is not None:
        monkeypatch.setattr(step_mod, "make_train_step",
                            lambda cfg, *a, **k: fault(real_make(cfg)))
    result, checks, found = train.run(
        tiny_cell("train", "eabnet_9mic_cln"), 32, 0.5, False, device="cpu")
    assert result["attempted"] > 0 and not found
    return result["correct"], {c.name: c.value for c in checks}


def test_sound_training_is_correct(monkeypatch):
    correct, checks = _train(monkeypatch)
    assert correct, checks


def test_a_step_that_keeps_its_state_is_not_correct(monkeypatch):
    def unchanged(step):
        def faulty(state, noisy, clean, n=None):
            keep = {k: p.detach().clone()
                    for k, p in state.model.named_parameters()}
            state, losses = step(state, noisy, clean, n)
            with torch.no_grad():
                for k, p in state.model.named_parameters():
                    p.copy_(keep[k])
            return state, losses
        return faulty

    correct, checks = _train(monkeypatch, unchanged)
    assert not correct and checks["change_gap"] == pytest.approx(1.0)


def test_half_of_the_training_batch_left_out_is_not_correct(monkeypatch):
    def half(step):
        def faulty(state, noisy, clean, n=None):
            h = noisy.shape[0] // 2
            return step(state, noisy[:h], clean[:h], n)
        return faulty

    correct, checks = _train(monkeypatch, half)
    assert not correct and checks["block_gap"] > 0.5, checks
