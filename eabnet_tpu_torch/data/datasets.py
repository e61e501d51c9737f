"""Datasets and the batch loader, the port's own copy of the JAX package's
``data/datasets.py``:

- :class:`OnlineMcseDataset`: per-item on-the-fly synthesis (sample a
  scene, crop the speech and noises, mix them at their SNRs, propagate
  them through the room: noisy at the array, the anechoic clean at the
  reference mic), seeded per (epoch, index);
- :class:`OfflineMcseDataset`: paired ``clean/`` and ``noisy/`` wav
  directories, optionally as their native int16 samples;
- :class:`FakeDataset`: seeded random waveforms shaped like real items;
- :class:`BatchLoader`: seeded shuffle, padded batches, true lengths; for
  an online dataset, synthesis in a pool of spawned worker processes with
  prefetch, and the device-mix modes (``loader``, ``parts``, ``scene``).

``l3das23`` is a later slice of the port; ``make_dataset`` refuses it.
Nothing here imports torch: the loader's workers import this module, and
the device halves of the mix modes import torch where they run.
"""

from __future__ import annotations

import multiprocessing
import os
from collections import deque
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
from scipy.io import wavfile

from eabnet_tpu_torch.config import DataConfig
from eabnet_tpu_torch.data.mixer import mix_at_snr
from eabnet_tpu_torch.data.rir import simulate_scene
from eabnet_tpu_torch.data.scenes import load_settings, sample_scene
from eabnet_tpu_torch.utils.audio_io import read_wav, resample


def _read_noise_names(
    opt: Dict, noise_paths: Sequence[str], rng: np.random.Generator
) -> List[str]:
    """Draw the per-item noise files (count from the settings range)."""
    lo, hi = opt["noise"]["n"]
    k = int(rng.integers(lo, hi + 1))
    return [
        noise_paths[int(i)]
        for i in rng.integers(0, len(noise_paths), size=k)
    ]


def load_and_crop(
    path: str,
    target_fs: int,
    crop_seconds: Optional[float],
    rng: np.random.Generator,
    start_seconds: Optional[float] = None,
    return_start: bool = False,
):
    """Load mono audio, random-crop (pad if short), resample.
    ``return_start`` also returns the crop's start sample (in file
    samples), so scene mode can replay the same crop from the
    device-resident corpus."""
    fs, audio = read_wav(path)
    if audio.ndim > 1:
        audio = audio[0]
    if crop_seconds is None:
        n = len(audio)
    else:
        n = round(fs * crop_seconds)
    if len(audio) < n:
        audio = np.pad(audio, (0, n - len(audio)))
    if start_seconds is None:
        start = int(rng.integers(0, len(audio) - n + 1))
    else:
        start = int(start_seconds * fs)
    audio = audio[start : start + n]
    if fs != target_fs:
        audio = resample(audio, fs, target_fs)
    audio = audio.astype(np.float32)
    if return_start:
        return audio, start
    return audio


def synthesize_item(
    opt: Dict,
    clip_seconds: Optional[float],
    speech_path: str,
    noise_paths: Sequence[str],
    seed: int,
    specific: Optional[Dict] = None,
    speech_start_sec: Optional[float] = None,
    noise_start_sec: Optional[float] = None,
    rir_backend: str = "auto",
    return_meta: bool = False,
):
    """Synthesize one (noisy (M, N), clean (N,)) training pair: geometry,
    audio crops, SNR/dBFS scaling of the dry signals, room propagation;
    the target is the anechoic clean at the reference mic."""
    rng = np.random.default_rng(seed)
    specific = dict(specific or {})
    fs = int(opt["audio"]["fs"])

    # choose noises first so the scene knows how many sources it needs
    names = specific.get("noise_name_list")
    if names is None:
        names = _read_noise_names(opt, noise_paths, rng)
    scene = sample_scene(
        opt, rng, n_noises_override=len(names), specific=specific
    )
    scene.noise_names = [os.path.basename(n) for n in names]
    scene.speech_name = os.path.basename(speech_path)

    clean = load_and_crop(speech_path, fs, clip_seconds, rng,
                          speech_start_sec)
    noises = [
        load_and_crop(p, fs, clip_seconds if clip_seconds else
                      len(clean) / fs, rng, noise_start_sec)
        for p in names
    ]

    clean_dry, noises_dry = mix_at_snr(
        clean, noises, scene.snrs_db, scene.dbfs, fs
    )
    noisy, clean_ref = simulate_scene(
        scene.room_dim, scene.e_absorption, scene.max_order,
        scene.rir_method, fs, scene.ref_mic, scene.p_mics, scene.p_target,
        scene.p_noises, clean_dry, noises_dry, rt60=scene.rt60, rng=rng,
        backend=rir_backend,
    )
    if return_meta:
        return noisy, clean_ref, scene.meta()
    return noisy, clean_ref


class OnlineMcseDataset:
    """On-the-fly multichannel scene synthesis over a speech list and a
    noise list, with the scene settings of ``cfg.mcse_settings``."""

    def __init__(self, cfg: DataConfig, seed: int = 0):
        self.opt = load_settings(cfg.mcse_settings)
        self.speech_root = cfg.speech_root
        self.noise_root = cfg.noise_root
        self.speech_list = _read_list(cfg.speech_list)
        self.noise_list = _read_list(cfg.noise_list)
        self.clip_seconds = cfg.clip_seconds
        self.seed = seed
        self.rir_backend = cfg.rir_backend

    def __len__(self) -> int:
        return len(self.speech_list)

    def item_args(self, index: int, epoch: int = 0):
        """Pure-data description of item ``index`` (picklable for workers)."""
        return dict(
            opt=self.opt,
            clip_seconds=self.clip_seconds,
            speech_path=os.path.join(
                self.speech_root, self.speech_list[index % len(self)]
            ),
            noise_paths=[
                os.path.join(self.noise_root, n) for n in self.noise_list
            ],
            seed=(self.seed * 1_000_003 + epoch * 7_919 + index) & 0x7FFFFFFF,
            rir_backend=self.rir_backend,
        )

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        return synthesize_item(**self.item_args(index))


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


def _read_list(path: str) -> List[str]:
    with open(path) as f:
        return [ln for ln in f.read().split("\n") if ln.strip()]


def _worker_synthesize(args: Dict):
    return synthesize_item(**args)


def _worker_synthesize_parts(args: Dict):
    from eabnet_tpu_torch.data.device_mix import synthesize_item_parts

    args = {k: v for k, v in args.items() if k != "specific"}
    return synthesize_item_parts(**args)


def _worker_synthesize_scene(args: Dict):
    from eabnet_tpu_torch.data.scene_mix import synthesize_item_scene

    args = {k: v for k, v in args.items() if k != "specific"}
    return synthesize_item_scene(**args)


_WORKERS = {None: _worker_synthesize, "loader": _worker_synthesize_parts,
            "parts": _worker_synthesize_parts,
            "scene": _worker_synthesize_scene}


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
    """Batches of a map-style dataset. Each epoch's order is a shuffle
    seeded with ``seed + epoch`` and each online item's seed comes from
    (epoch, index), so batches do not depend on worker scheduling and a
    resumed run sees the batches an uninterrupted one would.

    For an online dataset (one with ``item_args``), ``num_workers > 0``
    synthesizes in that many ``spawn``ed worker processes (the trainer's
    process holds a CUDA context and threads, which a fork would copy),
    at most ``prefetch`` batches ahead; the native RIR engine is built in
    this process before they start. ``device_mix`` picks what the workers
    make and what a batch is (``DataConfig.device_mix``):

    - ``False``: mixed audio, ``(noisy, clean, lengths)``;
    - ``"loader"`` (or ``True``): dry sources and RIRs, mixed here on
      ``device`` (the card by default) into ``(noisy, clean, lengths)``
      numpy arrays;
    - ``"parts"``: the collated parts dict for the fused train step
      (int16 with per-signal scales when ``mix_quantize``; RIRs padded to
      ``rir_pad`` samples when given);
    - ``"scene"``: the collated scene-parameter dict
      (``data/scene_mix.py``).

    Other datasets ignore ``device_mix``. ``close()`` stops the workers.

    ``rank`` of ``world`` (the ranks of a data-parallel run) draws the
    same global batches of ``batch_size`` rows as one process, and takes
    rows [rank * B / world, (rank + 1) * B / world) of each: it reads or
    synthesizes only those, with the item seeds one process would use, and
    ``len()`` is the same on every rank. Its rows are padded to their own
    longest (the data-parallel step pads them to the global batch's).
    ``shard_index``/``shard_count`` instead give each host a contiguous
    shard of the dataset of its own.
    """

    def __init__(self, dataset, batch_size: int, num_workers: int = 0,
                 prefetch: int = 4, drop_last: bool = True,
                 shuffle: bool = True, seed: int = 0,
                 shard_index: int = 0, shard_count: int = 1,
                 pad_multiple: int = 1, device_mix=False,
                 mix_quantize: bool = False, rir_pad: int = 0,
                 device="cuda", rank: int = 0, world: int = 1):
        if batch_size % world:
            raise ValueError(f"batch_size {batch_size} does not divide over "
                             f"{world} ranks")
        self.ds = dataset
        self.batch_size = batch_size
        self.rank, self.world = rank, world
        self.pad_multiple = max(1, int(pad_multiple))
        mode = {True: "loader", False: None}.get(device_mix, device_mix)
        if mode not in _WORKERS:
            raise ValueError(f"unknown device_mix mode {device_mix!r}")
        online = hasattr(dataset, "item_args")
        self.mix_mode = mode if online else None
        self.mix_quantize = mix_quantize
        self.rir_pad = int(rir_pad)
        self.device = device
        self._scene_dims = None
        if self.mix_mode == "scene":
            from eabnet_tpu_torch.data.scene_mix import scene_static_dims

            self._scene_dims = scene_static_dims(dataset.opt,
                                                 dataset.clip_seconds)
        self._s_max = (1 + int(dataset.opt["noise"]["n"][1])
                       if self.mix_mode and hasattr(dataset, "opt") else 6)
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.seed = seed
        self.shard_index = shard_index
        self.shard_count = shard_count
        self._pool = None
        if num_workers > 0 and online:
            from eabnet_tpu_torch.data.rir_native import native_available

            if dataset.rir_backend in ("auto", "native"):
                native_available()  # build once, before the workers start
            self._pool = ProcessPoolExecutor(
                max_workers=num_workers,
                mp_context=multiprocessing.get_context("spawn"))

    def __len__(self) -> int:
        n = len(self.ds) // self.shard_count
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        per = len(self.ds) // self.shard_count  # contiguous shard per host
        return idx[self.shard_index * per:(self.shard_index + 1) * per]

    def _rows(self, batch: np.ndarray) -> np.ndarray:
        """This rank's rows of a global batch."""
        n = len(batch)
        return batch[self.rank * n // self.world:
                     (self.rank + 1) * n // self.world]

    def epoch(self, epoch: int = 0) -> Iterator:
        idx = self._epoch_indices(epoch)
        nb = len(self)
        batches = [self._rows(idx[i * self.batch_size:
                                  (i + 1) * self.batch_size])
                   for i in range(nb)]
        if not hasattr(self.ds, "item_args"):
            for b in batches:
                yield _collate([self.ds[int(i)] for i in b],
                               self.pad_multiple)
            return
        worker = _WORKERS[self.mix_mode]

        def item_args(i):
            args = self.ds.item_args(int(i), epoch)
            if self.mix_mode == "scene":
                args = dict(args, speech_index=int(i) % len(self.ds))
            return args

        if self._pool is None:
            for b in batches:
                yield self._finish([worker(item_args(i)) for i in b])
            return
        # a sliding window of at most `prefetch` batches in flight
        inflight = deque()
        for head in range(min(self.prefetch, nb)):
            inflight.append([self._pool.submit(worker, item_args(i))
                             for i in batches[head]])
        head = len(inflight)
        while inflight:
            futures = inflight.popleft()
            if head < nb:
                inflight.append([self._pool.submit(worker, item_args(i))
                                 for i in batches[head]])
                head += 1
            yield self._finish([f.result() for f in futures])

    def _finish(self, results):
        if self.mix_mode is None:
            return _collate(results, self.pad_multiple)
        if self.mix_mode == "parts":
            from eabnet_tpu_torch.data.device_mix import collate_parts

            return collate_parts(results, s_max=self._s_max,
                                 rir_pad=self.rir_pad,
                                 quantize=self.mix_quantize)
        if self.mix_mode == "scene":
            from eabnet_tpu_torch.data.scene_mix import collate_scenes

            return collate_scenes(results, self._scene_dims)
        from eabnet_tpu_torch.data.device_mix import device_mix_batch

        noisy, clean = device_mix_batch(results, device=self.device)
        return noisy, clean, np.full((noisy.shape[0],), noisy.shape[-1],
                                     np.int32)

    def close(self) -> None:
        """Cancel what is queued and wait for the workers to exit."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None


def make_dataset(cfg: DataConfig, mics: int = 9, seed: int = 0):
    """-> (train_ds, val_ds); either may be None, as in the JAX package."""
    if cfg.dataset == "fake":
        return (FakeDataset(64, mics, cfg.clip_seconds, seed=seed),
                FakeDataset(8, mics, cfg.clip_seconds, seed=seed + 10_000))
    if cfg.dataset == "mcse":
        if cfg.train_set == "online":
            # eval-only configs may omit the synthesis settings entirely
            train = (OnlineMcseDataset(cfg, seed=seed)
                     if cfg.mcse_settings else None)
        else:
            train = OfflineMcseDataset(cfg.speech_root or cfg.val_set,
                                       transfer_int16=cfg.transfer_int16)
        val = OfflineMcseDataset(cfg.val_set) if cfg.val_set else None
        return train, val
    if cfg.dataset == "l3das23":
        raise NotImplementedError(
            "dataset='l3das23' is a later slice of the port")
    raise ValueError(f"unknown dataset {cfg.dataset!r}")
