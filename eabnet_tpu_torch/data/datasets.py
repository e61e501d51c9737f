"""Datasets and the batch loader, the port's own copy of the JAX package's
``data/datasets.py`` for the data it loads in process:

- :class:`OfflineMcseDataset`: paired ``clean/`` and ``noisy/`` wav
  directories, optionally as their native int16 samples;
- :class:`FakeDataset`: seeded random waveforms shaped like real items;
- :class:`BatchLoader`: seeded shuffle, padded batches, true lengths.

Online synthesis, ``l3das23`` and the device-mix modes are later slices of
the port; ``make_dataset`` refuses them.
"""

from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np
from scipy.io import wavfile

from eabnet_tpu_torch.config import DataConfig
from eabnet_tpu_torch.utils.audio_io import read_wav


class OfflineMcseDataset:
    """Paired clean/ + noisy/ wav directories. ``transfer_int16=True``
    returns the wavs' native int16 samples (non-int16 sources quantized
    with the fixed PCM scale); the train and eval steps dequantize them on
    the device."""

    def __init__(self, root: str, transfer_int16: bool = False):
        self.clean_root = os.path.join(root, "clean")
        self.noisy_root = os.path.join(root, "noisy")
        self.names = sorted(os.listdir(self.clean_root))
        self.transfer_int16 = transfer_int16

    def __len__(self) -> int:
        return len(self.names)

    def _read(self, path: str) -> np.ndarray:
        if not self.transfer_int16:
            return read_wav(path)[1]
        _, data = wavfile.read(path)
        if data.dtype == np.int32:
            data = (data >> 16).astype(np.int16)
        elif data.dtype == np.uint8:  # offset-binary 8-bit PCM
            data = (data.astype(np.int16) - 128) << 8
        elif np.issubdtype(data.dtype, np.floating):
            data = (np.clip(data.astype(np.float64), -1, 1)
                    * 32767).astype(np.int16)
        elif data.dtype != np.int16:
            raise ValueError(f"unsupported wav sample dtype {data.dtype} "
                             f"in {path}")
        return data.T if data.ndim == 2 else data

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        name = self.names[index]
        clean = self._read(os.path.join(self.clean_root, name))
        noisy = self._read(os.path.join(self.noisy_root, name))
        if clean.ndim > 1:
            clean = clean[0]
        return np.atleast_2d(noisy), clean


class FakeDataset:
    """Seeded random waveforms: item i is drawn from
    ``np.random.default_rng(seed + i)``, as in the JAX package."""

    def __init__(self, n_items: int = 64, mics: int = 9,
                 seconds: float = 6.0, sr: int = 16000, seed: int = 0):
        self.n_items = n_items
        self.mics = mics
        self.n = int(seconds * sr)
        self.seed = seed

    def __len__(self) -> int:
        return self.n_items

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self.seed + index)
        clean = (rng.standard_normal(self.n) * 0.05).astype(np.float32)
        noise = (rng.standard_normal((self.mics, self.n))
                 * 0.02).astype(np.float32)
        noisy = clean[None, :] * (
            0.8 + 0.4 * rng.random((self.mics, 1)).astype(np.float32)
        ) + noise
        return noisy.astype(np.float32), clean


def _collate(items, pad_multiple: int = 1
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(noisy (M, N_i), clean (N_i,)) pairs -> (noisy (B, M, N), clean
    (B, N), n_samples (B,)): zero-padded to the longest item, rounded up to
    ``pad_multiple`` samples; int16 items stay int16."""
    lengths = np.array([it[0].shape[-1] for it in items], np.int32)
    n = int(lengths.max())
    if pad_multiple > 1:
        n = -(-n // pad_multiple) * pad_multiple
    dt = np.int16 if items[0][0].dtype == np.int16 else np.float32
    noisy = np.zeros((len(items),) + items[0][0].shape[:-1] + (n,), dt)
    clean = np.zeros((len(items), n), dt)
    for i, (ns, cl) in enumerate(items):
        noisy[i, ..., :ns.shape[-1]] = ns
        clean[i, :cl.shape[-1]] = cl
    return noisy, clean, lengths


class BatchLoader:
    """Batches of a map-style dataset, loaded in process. Each epoch's
    order is a shuffle seeded with ``seed + epoch`` (the JAX loader's), so
    a resumed run sees the batches an uninterrupted one would."""

    def __init__(self, dataset, batch_size: int, drop_last: bool = True,
                 shuffle: bool = True, seed: int = 0, pad_multiple: int = 1):
        self.ds = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.seed = seed
        self.pad_multiple = max(1, int(pad_multiple))

    def __len__(self) -> int:
        n = len(self.ds)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        return idx

    def epoch(self, epoch: int = 0) -> Iterator[
            Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        idx = self._epoch_indices(epoch)
        for i in range(len(self)):
            batch = idx[i * self.batch_size:(i + 1) * self.batch_size]
            yield _collate([self.ds[int(j)] for j in batch],
                           self.pad_multiple)


def make_dataset(cfg: DataConfig, mics: int = 9, seed: int = 0):
    """-> (train_ds, val_ds); either may be None, as in the JAX package."""
    if cfg.dataset == "fake":
        return (FakeDataset(64, mics, cfg.clip_seconds, seed=seed),
                FakeDataset(8, mics, cfg.clip_seconds, seed=seed + 10_000))
    if cfg.dataset == "mcse":
        if cfg.train_set == "online":
            if cfg.mcse_settings:
                raise NotImplementedError(
                    "train_set='online': on-the-fly room synthesis is a "
                    "later slice of the port; use offline pairs")
            train = None  # an eval-only config
        else:
            train = OfflineMcseDataset(cfg.speech_root or cfg.val_set,
                                       transfer_int16=cfg.transfer_int16)
        val = OfflineMcseDataset(cfg.val_set) if cfg.val_set else None
        return train, val
    if cfg.dataset == "l3das23":
        raise NotImplementedError(
            "dataset='l3das23' is a later slice of the port")
    raise ValueError(f"unknown dataset {cfg.dataset!r}")
