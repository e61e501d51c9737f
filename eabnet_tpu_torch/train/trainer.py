"""The training loop: epochs, logging, checkpoints and validation, as the
JAX package's ``train/trainer.py`` runs them:

- auto-resume from the newest checkpoint in ``train.checkpoint_dir`` (a
  ``.params`` file resumes its params with a fresh optimizer and the step
  from its name), at the epoch after the checkpoint's;
- loss means printed (and logged) every ``log_every`` steps, a checkpoint
  every ``saving_interval`` epochs' worth of steps, validation every
  ``valid_interval``; a checkpoint at ``max_steps`` and at the end;
- online synthesis (``data.train_set="online"``) through the loader's
  spawned workers, with the room propagation on the device by
  ``data.device_mix``: the ``parts`` and ``scene`` steps mix inside the
  train step, ``scene`` against the int16 corpus loaded onto the device
  once; every ``scene`` or ``parts`` batch of a run has one shape.

Inside a ``torch.distributed`` process group (any backend, any size, 1
included) ``train`` is one rank of a data-parallel run, one process per
card, with the semantics of the JAX package's mesh over the global batch
``train.batch_size``:

- the rank trains on ``cuda:<local rank>`` when given the bare ``"cuda"``
  (made the current card, so every bare ``"cuda"`` in the port means it);
- after create or resume, rank 0's parameters, batch statistics, Adam
  state and step are broadcast to every rank, as JAX's ``replicate``
  places one copy; every rank resumes from the same newest checkpoint;
- each rank draws its rows of every global batch (``BatchLoader``'s
  ``rank``/``world``) and the step all-reduces (``train/step.py``); a
  ``scene`` run loads the corpus onto each rank's card;
- validation is sharded (each rank scores its share of the val set, every
  item once) and its loss is the mean over every item;
- only rank 0 (the chief) writes the config, logs, prints and saves
  checkpoints; every rank waits at a barrier after each save;
- every rank returns the history, with the global batch's losses.

A group whose size does not divide ``train.batch_size`` raises
``ValueError``. Without a group ``train`` is the one-device run.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from eabnet_tpu_torch.config import ExperimentConfig, require_training
from eabnet_tpu_torch.data.datasets import BatchLoader, make_dataset
from eabnet_tpu_torch.data.device_mix import batch_to_device
from eabnet_tpu_torch.dsp import stft_to_wav
from eabnet_tpu_torch.models.eabnet import to_reference_layout
from eabnet_tpu_torch.parallel.mesh import (all_processes_mean,
                                            collective_device,
                                            host_local_slice, in_group,
                                            is_chief, local_index,
                                            process_count, process_index)
from eabnet_tpu_torch.train.checkpoint import (latest_checkpoint,
                                               load_checkpoint,
                                               save_checkpoint, save_config)
from eabnet_tpu_torch.train.loggers import TrainLogger, num_params
from eabnet_tpu_torch.train.step import (create_train_state, make_eval_step,
                                         make_train_step)
from eabnet_tpu_torch.utils.precision import float32_products
from eabnet_tpu_torch.utils.quantize import flat_views


def _to_device(batch, device):
    return tuple(torch.from_numpy(a).to(device) for a in batch)


def _nbytes(batch) -> int:
    """Host-to-device bytes of a batch (a dict's ``tail_seeds`` stay on the
    host)."""
    if isinstance(batch, dict):
        return sum(v.nbytes for k, v in batch.items() if k != "tail_seeds")
    return sum(a.nbytes for a in batch)


class _Items:
    """Items ``indices`` of a dataset, as a dataset."""

    def __init__(self, ds, indices):
        self.ds, self.indices = ds, list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.ds[self.indices[i]]


def validation_share(val_ds):
    """This rank's contiguous share of the validation set
    (``host_local_slice``: the shares cover every item once); the whole
    set without a group."""
    if process_count() == 1:
        return val_ds
    return _Items(val_ds, host_local_slice(process_index(), process_count(),
                                           len(val_ds)))


def validate(cfg: ExperimentConfig, state, eval_step, val_loader, logger,
             step: int) -> float:
    """Mean ``final`` loss over the validation set (batches of one), with
    audio and spectrogram examples at ``train.example_index`` (the chief's
    share: its first items are the set's first). In a process group each
    rank scores its share and the mean is over every rank's items."""
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
    mean_loss = (all_processes_mean(float(np.sum(losses)), float(len(losses)))
                 if losses or process_count() > 1 else float("nan"))
    logger.scalars("valid", {"valid_loss": mean_loss}, step)
    return mean_loss


def _say(msg: str) -> None:
    """Print on the chief only."""
    if is_chief():
        print(msg)


def broadcast_state(state) -> None:
    """Rank 0's parameters, batch statistics, Adam moments, step and Adam
    count on every rank of the group, in place: two broadcasts."""
    model, opt = state.model, state.opt_state
    tensors = [*model.parameters(), *model.buffers(), *opt.mu.values(),
               *opt.nu.values()]
    dev = collective_device()
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors]
                     ).to(dev)
    counts = torch.tensor([state.step, opt.count], dtype=torch.int64,
                          device=dev)
    for t in (flat, counts):
        dist.broadcast(t, 0)
    with torch.no_grad():
        for t, v in zip(tensors, flat_views(
                flat, [tuple(t.shape) for t in tensors])):
            t.copy_(v)
    state.step, opt.count = (int(v) for v in counts.tolist())


def train(cfg: ExperimentConfig, max_steps: Optional[int] = None,
          device: str = "cuda", tensorboard: bool = True) -> List[Dict]:
    """Train (or resume) on ``device``. Returns one record per step taken:
    ``{"step", "epoch", "eabnet", "postnet", "final", "seconds", "wait",
    "bytes"}``: the losses before that step's update, the step's wall
    time (host to device copy, mix, forward, backward, update, loss read
    back), the seconds the loop waited on the loader for its batch, and
    the batch's host-to-device bytes. On the card it runs with float32
    products (``float32_products``). In a process group it is one rank of
    a data-parallel run (module doc)."""
    require_training(cfg, process_count())
    if in_group():
        world = process_count()
        if cfg.train.batch_size % world:
            raise ValueError(
                f"train.batch_size {cfg.train.batch_size} does not divide "
                f"over the {world} ranks of the process group")
        if device == "cuda":
            device = f"cuda:{local_index()}"
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(device)
    with float32_products(device):
        return _train(cfg, max_steps, device, tensorboard)


def _train(cfg: ExperimentConfig, max_steps: Optional[int], device: str,
           tensorboard: bool) -> List[Dict]:
    world = process_count()
    if is_chief():
        save_config(cfg, cfg.train.exp_root)
    logger = TrainLogger(cfg.train.checkpoint_dir,
                         enabled=tensorboard and is_chief())
    if cfg.train.fixed_seed:
        np.random.seed(cfg.train.seed)
    state = create_train_state(cfg, device)
    _say(f"model parameters: {num_params(state.model):,}")
    _say(f"device: {device}" + (f" (rank 0 of {world}, "
                                 f"{dist.get_backend()})" if in_group()
                                else ""))

    resume_epoch = -1
    ckpt = latest_checkpoint(cfg.train.checkpoint_dir)
    if ckpt is not None:
        state, resume_epoch = load_checkpoint(ckpt, state, cfg)
        _say(f"resumed from {ckpt} (iter {state.step}, epoch "
             f"{resume_epoch})")
    if in_group():
        broadcast_state(state)

    train_ds, val_ds = make_dataset(cfg.data, mics=cfg.model.eabnet.M,
                                    seed=cfg.train.seed)
    if train_ds is None:
        raise ValueError("the data config names no training set")
    pad_multiple = max(1, int(cfg.data.pad_to_seconds * cfg.stft.sr))
    mix_mode = {True: "loader", False: None}.get(cfg.data.device_mix,
                                                 cfg.data.device_mix)
    scene_dims, rir_pad = None, 0
    if mix_mode in ("parts", "scene") and hasattr(train_ds, "opt"):
        from eabnet_tpu_torch.data.scene_mix import scene_static_dims

        try:
            scene_dims = scene_static_dims(train_ds.opt,
                                           cfg.data.clip_seconds)
            rir_pad = scene_dims["l_rir"]  # one RIR shape for the run
        except ValueError:
            if mix_mode == "scene":
                raise
    train_loader = BatchLoader(
        train_ds, cfg.train.batch_size, num_workers=cfg.data.num_workers,
        prefetch=cfg.data.prefetch, shuffle=True, seed=cfg.train.seed,
        pad_multiple=pad_multiple, device_mix=cfg.data.device_mix,
        mix_quantize=cfg.data.transfer_int16, rir_pad=rir_pad,
        device=device, rank=process_index(), world=world)
    try:
        return _loop(cfg, max_steps, device, state, resume_epoch, logger,
                     train_loader, val_ds, pad_multiple, scene_dims)
    finally:
        train_loader.close()
        logger.close()


def _save(state, epoch: int, cfg: ExperimentConfig) -> None:
    """The chief writes the checkpoint; in a group every rank waits for it
    (a barrier), so none reads a half-written file."""
    if is_chief():
        save_checkpoint(state, epoch, cfg.train.checkpoint_dir)
    if in_group():
        dist.barrier()


def _loop(cfg, max_steps, device, state, resume_epoch, logger,
          train_loader, val_ds, pad_multiple, scene_dims) -> List[Dict]:
    # what a batch is follows the loader: a dataset that is not online
    # gives wav batches whatever device_mix says
    mode = train_loader.mix_mode
    batch_kind = mode if mode in ("parts", "scene") else "wav"
    extras = ()
    if batch_kind == "scene":
        from eabnet_tpu_torch.data.scene_mix import load_corpus_int16

        ds = train_loader.ds
        fs = int(ds.opt["audio"]["fs"])
        extras = tuple(
            torch.from_numpy(load_corpus_int16(root, names, fs)).to(device)
            for root, names in ((ds.speech_root, ds.speech_list),
                                (ds.noise_root, ds.noise_list)))
        _say(f"scene mode: device-resident corpus {extras[0].shape[0]} "
             f"speech + {extras[1].shape[0]} noise files "
             f"({sum(c.numel() * 2 for c in extras) / 1e6:.1f} MB"
             + (" on each rank's card)" if in_group() else ")"))
    val_loader = (BatchLoader(validation_share(val_ds), 1, shuffle=False,
                              drop_last=False, pad_multiple=pad_multiple)
                  if val_ds is not None else None)
    train_step = make_train_step(cfg, batch_kind, scene_dims)
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
    for epoch in range(resume_epoch + 1, cfg.train.total_epoch):
        batches = train_loader.epoch(epoch)
        while True:
            t_wait = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            t0 = time.perf_counter()
            if batch_kind == "wav":
                state, losses = train_step(state,
                                           *_to_device(batch, device))
            else:
                state, losses = train_step(
                    state, batch_to_device(batch, device), *extras)
            values = {k: float(v) for k, v in losses.items()}
            history.append({"step": state.step, "epoch": epoch,
                            **values,
                            "seconds": time.perf_counter() - t0,
                            "wait": t0 - t_wait,
                            "bytes": _nbytes(batch)})
            current_iter = state.step
            for k, v in values.items():
                window.setdefault(k, []).append(v)
            if current_iter % cfg.train.log_every == 0:
                means = {k: float(np.mean(v)) for k, v in window.items()}
                sps = cfg.train.log_every / max(time.time() - t_last,
                                                1e-9)
                _say(f"iter {current_iter} epoch {epoch} loss "
                     f"{means.get('final', float('nan')):.4f} "
                     f"({sps:.2f} it/s)")
                logger.scalars("loss", means, current_iter)
                logger.scalars("perf", {"iters_per_sec": sps},
                               current_iter)
                window = {}
                t_last = time.time()
            if current_iter % save_every == 0:
                _save(state, epoch, cfg)
            if val_loader is not None and current_iter % valid_every == 0:
                validate(cfg, state, eval_step, val_loader, logger,
                         current_iter)
            if max_steps is not None and current_iter >= max_steps:
                _save(state, epoch, cfg)
                return history
    _save(state, cfg.train.total_epoch - 1, cfg)
    return history
