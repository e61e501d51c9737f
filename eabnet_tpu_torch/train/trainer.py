"""The training loop on one device: epochs, logging, checkpoints and
validation, as the JAX package's ``train/trainer.py`` runs them:

- auto-resume from the newest checkpoint in ``train.checkpoint_dir`` (a
  ``.params`` file resumes its params with a fresh optimizer and the step
  from its name);
- loss means printed (and logged) every ``log_every`` steps, a checkpoint
  every ``saving_interval`` epochs' worth of steps, validation every
  ``valid_interval``; a checkpoint at ``max_steps`` and at the end.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from eabnet_tpu_torch.config import ExperimentConfig, require_training
from eabnet_tpu_torch.data.datasets import BatchLoader, make_dataset
from eabnet_tpu_torch.dsp import stft_to_wav
from eabnet_tpu_torch.models.eabnet import to_reference_layout
from eabnet_tpu_torch.train.checkpoint import (latest_checkpoint,
                                               load_checkpoint,
                                               save_checkpoint, save_config)
from eabnet_tpu_torch.train.loggers import TrainLogger, num_params
from eabnet_tpu_torch.train.step import (create_train_state, make_eval_step,
                                         make_train_step)


def _to_device(batch, device):
    return tuple(torch.from_numpy(a).to(device) for a in batch)


def validate(cfg: ExperimentConfig, state, eval_step, val_loader, logger,
             step: int) -> float:
    """Mean ``final`` loss over the validation set (batches of one), with
    audio and spectrogram examples at ``train.example_index``."""
    losses = []
    device = next(state.model.parameters()).device
    for i, batch in enumerate(val_loader.epoch(0)):
        noisy, target, n_samples = _to_device(batch, device)
        out, esti = eval_step(state, noisy, target, n_samples)
        losses.append(float(out["final"]))
        if logger.enabled and i in cfg.train.example_index:
            with torch.no_grad():
                wav = stft_to_wav(to_reference_layout(esti), cfg.stft)
            logger.audio(f"audio{i}/estimated", wav[0].cpu().numpy(), step,
                         cfg.stft.sr)
            logger.audio(f"audio{i}/noisy", np.mean(batch[0][0], axis=0),
                         step, cfg.stft.sr)
            logger.audio(f"audio{i}/target", batch[1][0], step, cfg.stft.sr)
            logger.spectrogram(f"spec{i}/estimated",
                               esti[0].norm(dim=-1).cpu().numpy(), step)
    mean_loss = float(np.mean(losses)) if losses else float("nan")
    logger.scalars("valid", {"valid_loss": mean_loss}, step)
    return mean_loss


def train(cfg: ExperimentConfig, max_steps: Optional[int] = None,
          device: str = "cuda", tensorboard: bool = True) -> List[Dict]:
    """Train (or resume) on ``device``. Returns one record per step taken:
    ``{"step", "epoch", "eabnet", "postnet", "final", "seconds"}``, the
    losses before that step's update and the step's wall time (host to
    device copy, forward, backward, update, loss read back). On the card
    it turns TF32 off for cuDNN and matmuls, process-wide: the compute
    dtype "float32" means float32 products."""
    require_training(cfg)
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    save_config(cfg, cfg.train.exp_root)
    logger = TrainLogger(cfg.train.checkpoint_dir, enabled=tensorboard)
    if cfg.train.fixed_seed:
        np.random.seed(cfg.train.seed)
    state = create_train_state(cfg, device)
    print(f"model parameters: {num_params(state.model):,}")
    print(f"device: {device}")

    resume_epoch = -1
    ckpt = latest_checkpoint(cfg.train.checkpoint_dir)
    if ckpt is not None:
        state, resume_epoch = load_checkpoint(ckpt, state, cfg)
        print(f"resumed from {ckpt} (iter {state.step}, epoch "
              f"{resume_epoch})")

    train_ds, val_ds = make_dataset(cfg.data, mics=cfg.model.eabnet.M,
                                    seed=cfg.train.seed)
    if train_ds is None:
        raise ValueError("the data config names no training set")
    pad_multiple = max(1, int(cfg.data.pad_to_seconds * cfg.stft.sr))
    train_loader = BatchLoader(train_ds, cfg.train.batch_size, shuffle=True,
                               seed=cfg.train.seed, pad_multiple=pad_multiple)
    val_loader = (BatchLoader(val_ds, 1, shuffle=False, drop_last=False,
                              pad_multiple=pad_multiple)
                  if val_ds is not None else None)
    train_step = make_train_step(cfg)
    eval_step = make_eval_step(cfg)

    steps_per_epoch = max(1, len(train_loader))
    save_every = max(1, int(cfg.train.saving_interval * steps_per_epoch))
    valid_every = max(1, int(cfg.train.valid_interval * steps_per_epoch))
    current_iter = state.step
    if cfg.train.validate_once_before_train and val_loader is not None:
        validate(cfg, state, eval_step, val_loader, logger, current_iter)

    history: List[Dict] = []
    window: Dict[str, List[float]] = {}
    t_last = time.time()
    try:
        for epoch in range(resume_epoch + 1, cfg.train.total_epoch):
            for batch in train_loader.epoch(epoch):
                t0 = time.perf_counter()
                state, losses = train_step(state,
                                           *_to_device(batch, device))
                values = {k: float(v) for k, v in losses.items()}
                history.append({"step": state.step, "epoch": epoch,
                                **values,
                                "seconds": time.perf_counter() - t0})
                current_iter = state.step
                for k, v in values.items():
                    window.setdefault(k, []).append(v)
                if current_iter % cfg.train.log_every == 0:
                    means = {k: float(np.mean(v)) for k, v in window.items()}
                    sps = cfg.train.log_every / max(time.time() - t_last,
                                                    1e-9)
                    print(f"iter {current_iter} epoch {epoch} loss "
                          f"{means.get('final', float('nan')):.4f} "
                          f"({sps:.2f} it/s)")
                    logger.scalars("loss", means, current_iter)
                    logger.scalars("perf", {"iters_per_sec": sps},
                                   current_iter)
                    window = {}
                    t_last = time.time()
                if current_iter % save_every == 0:
                    save_checkpoint(state, epoch, cfg.train.checkpoint_dir)
                if val_loader is not None and current_iter % valid_every == 0:
                    validate(cfg, state, eval_step, val_loader, logger,
                             current_iter)
                if max_steps is not None and current_iter >= max_steps:
                    save_checkpoint(state, epoch, cfg.train.checkpoint_dir)
                    return history
        save_checkpoint(state, cfg.train.total_epoch - 1,
                        cfg.train.checkpoint_dir)
        return history
    finally:
        logger.close()
