"""L3DAS23 dataset support + SELD (task-2) utilities, the port's own copy
of the JAX package's ``data/l3das.py`` (numpy, scipy; PIL only inside
``load_image``, the audio-visual mode).

Covers the reference's second data backend and its legacy utilities
(dataset/custom_dataset.py, dataset/utility_functions.py):

- :class:`L3dasDataset` — pickled predictor/target arrays with an optional
  audio-visual image modality (custom_dataset.py:10-43, 64-122);
- scipy-STFT magnitude(+phase) featurizer (utility_functions.py:65-91);
- SELD task-2 codecs: model-output -> submission list and label-csv ->
  frame matrix (utility_functions.py:94-177);
- waveform / task-2 segmentation helpers (utility_functions.py:217-287);
- fake-data generators for tests (utility_functions.py:290-420).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

SELD_CLASSES = (
    "Chink_and_clink", "Computer_keyboard", "Cupboard_open_or_close",
    "Drawer_open_or_close", "Female_speech_and_woman_speaking",
    "Finger_snapping", "Keys_jangling", "Knock", "Laughter",
    "Male_speech_and_man_speaking", "Printer", "Scissors", "Telephone",
    "Writing",
)


# ----------------------------------------------------------------- dataset


def audio_image_csv_to_dict(path: str) -> Dict[str, str]:
    """(audio_name, image_filename) CSV -> dict
    (reference: utility_functions.py:179-184)."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            name, _, img = line.partition(",")
            out[name] = img
    return out


def load_image(path: str, resize: Optional[int] = None) -> np.ndarray:
    """RGB image as float32 HWC in [0, 1]."""
    from PIL import Image

    with open(path, "rb") as f:
        img = Image.open(f).convert("RGB")
    if resize is not None:
        img = img.resize((resize, resize))
    return np.asarray(img, np.float32) / 255.0


class L3dasDataset:
    """Pickled predictor/target pairs, optionally audio-visual.

    Items: (audio (C, N), target (1, N)) or ((audio, image), target) when
    ``image_path`` is set (reference: CustomAudioVisualDataset).
    """

    def __init__(self, predictors_path: str, target_path: str,
                 image_path: Optional[str] = None,
                 image_audio_csv_path: Optional[str] = None):
        with open(predictors_path, "rb") as f:
            predictors = pickle.load(f)
        with open(target_path, "rb") as f:
            target = pickle.load(f)
        # predictors may be (audio_list, audio_path_list) or a bare list
        if (isinstance(predictors, (tuple, list)) and len(predictors) == 2
                and not np.isscalar(predictors[0])
                and not hasattr(predictors[0], "shape")):
            self.audio = [np.asarray(a, np.float32) for a in predictors[0]]
            self.audio_paths = list(predictors[1])
        else:
            self.audio = [np.asarray(a, np.float32) for a in predictors]
            self.audio_paths = [str(i) for i in range(len(self.audio))]
        self.target = [np.asarray(t, np.float32) for t in target]
        self.image_path = image_path
        self.image_map = (
            audio_image_csv_to_dict(image_audio_csv_path)
            if image_path and image_audio_csv_path
            else None
        )

    def __len__(self) -> int:
        return len(self.audio)

    def __getitem__(self, idx: int):
        audio = self.audio[idx]
        target = self.target[idx]
        if self.image_path and self.image_map is not None:
            img = load_image(os.path.join(
                self.image_path, self.image_map[self.audio_paths[idx]]
            ))
            return (audio, img), target
        return audio, target


def load_l3das_datasets(args_like) -> Tuple[L3dasDataset, L3dasDataset]:
    """(train, val) from the reference's path arguments
    (custom_dataset.py:64-122)."""
    train = L3dasDataset(
        args_like.training_predictors_path,
        args_like.training_target_path,
        getattr(args_like, "path_images", None),
        getattr(args_like, "path_csv_images_train", None),
    )
    val = L3dasDataset(
        args_like.validation_predictors_path,
        args_like.validation_target_path,
        getattr(args_like, "path_images", None),
        getattr(args_like, "path_csv_images_train", None),
    )
    return train, val


# ------------------------------------------------------------- featurizer


def spectrum_fast(x: np.ndarray, nperseg: int = 512, noverlap: int = 128,
                  window: str = "hamming", cut_dc: bool = True,
                  output_phase: bool = True,
                  cut_last_timeframe: bool = True) -> np.ndarray:
    """Magnitude(+phase) spectrogram via scipy stft
    (reference: utility_functions.py:65-91)."""
    from scipy.signal import stft as sp_stft

    _, _, seg = sp_stft(x, window=window, nperseg=nperseg,
                        noverlap=noverlap)
    out = np.abs(seg)
    if output_phase:
        out = np.concatenate([out, np.angle(seg)], axis=-3)
    if cut_dc:
        out = out[:, 1:, :]
    if cut_last_timeframe:
        out = out[:, :, :-1]
    return out


# ------------------------------------------------------------ SELD codecs


def gen_submission_list_task2(
    sed: np.ndarray, doa: np.ndarray, max_loc_value: float = 360.0,
    num_frames: int = 600, num_classes: int = 14, max_overlaps: int = 3,
) -> np.ndarray:
    """SED/DoA model outputs -> challenge submission rows
    [frame, class, x, y, z] (reference: utility_functions.py:94-117)."""
    rows = []
    for frame, (c, l) in enumerate(zip(sed, doa)):
        c = np.round(c)
        l = (l * max_loc_value).reshape(num_classes, max_overlaps, 3)
        if np.sum(c) == 0:
            continue
        for j, active in enumerate(c):
            if active != 0:
                cls = j // max_overlaps
                k = j % max_overlaps
                rows.append([frame, cls, l[cls][k][0], l[cls][k][1],
                             l[cls][k][2]])
    return np.array(rows)


def csv_to_matrix_task2(
    path: str, class_dict: Dict[str, int], dur: float = 60.0,
    step: float = 0.1, max_loc_value: float = 360.0,
    no_overlaps: bool = False,
) -> np.ndarray:
    """Label CSV -> per-frame (class activity || normalized locations)
    matrix (reference: utility_functions.py:120-177). Expects columns
    Start, End, Class, rho, theta, z."""
    import csv as csv_mod

    max_overlap = 3
    num_classes = len(class_dict)
    num_frames = int(dur / step)
    cl = np.zeros((num_frames, num_classes, max_overlap))
    loc = np.zeros((num_frames, num_classes, max_overlap, 3))

    def get_frame(t: float) -> int:
        q = round(float(t) / step) * step
        return int(np.interp(q, (0, dur), (0, num_frames - 1)))

    with open(path) as f:
        for row in csv_mod.DictReader(f):
            start_f = get_frame(row["Start"])
            end_f = get_frame(row["End"])
            cid = class_dict[row["Class"]]
            for fr in range(start_f, end_f + 1):
                pos = int(np.sum(cl[fr][cid]))
                cl[fr][cid][pos] = 1.0
                loc[fr][cid][pos] = [float(row["rho"]),
                                     float(row["theta"]), float(row["z"])]

    loc = loc / max_loc_value
    if no_overlaps:
        cl_out = cl[:, :, 0].reshape(num_frames, num_classes)
        loc_out = loc[:, :, 0, :].reshape(num_frames, num_classes * 3)
    else:
        cl_out = cl.reshape(num_frames, num_classes * max_overlap)
        loc_out = loc.reshape(num_frames, num_classes * max_overlap * 3)
    return np.concatenate([cl_out, loc_out], axis=1)


# ----------------------------------------------------------- segmentation


def segment_waveforms(predictors: np.ndarray, target: np.ndarray,
                      length: int) -> Tuple[List, List]:
    """Cut (C, N) waveforms into fixed-length chunks, zero-padding the tail
    (reference: utility_functions.py:217-244)."""
    xs, ys = [], []
    for start in range(0, predictors.shape[-1], length):
        cut_x = predictors[:, start : start + length]
        cut_y = target[:, start : start + length]
        if cut_x.shape[-1] < length:
            cut_x = np.pad(cut_x,
                           ((0, 0), (0, length - cut_x.shape[-1])))
            cut_y = np.pad(cut_y,
                           ((0, 0), (0, length - cut_y.shape[-1])))
        xs.append(cut_x)
        ys.append(cut_y)
    return xs, ys


# --------------------------------------------------------- fake fixtures


def gen_seld_out(n_frames: int, n_overlaps: int = 3, n_classes: int = 14,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Random SELD submission rows for testing
    (reference: utility_functions.py:290-324)."""
    rng = rng or np.random.default_rng(0)
    rows = []
    for frame in range(n_frames):
        for _ in range(int(rng.integers(0, 4))):
            cls = SELD_CLASSES[int(rng.integers(0, n_classes))]
            tx = rng.random() * 4 - 2
            ty = (rng.random() * 2 - 1) * 1.5
            tz = rng.random() * 2 - 1
            rows.append([frame, cls, tx, ty, tz])
    return np.array(rows, dtype=object)


def gen_dummy_waveforms(n: int, out_path: str,
                        rng: Optional[np.random.Generator] = None) -> None:
    """Random .npy waveforms (reference: utility_functions.py:363-374)."""
    rng = rng or np.random.default_rng(0)
    sr, max_len = 16000, 10
    os.makedirs(out_path, exist_ok=True)
    for i in range(n):
        ln = int(rng.random() * max_len * sr) + 1
        np.save(os.path.join(out_path, f"{i}.npy"),
                (rng.random(ln) * 2 - 1) * 0.9)


def gen_fake_l3das_dataset(output_path: str, n_items: int = 4,
                           channels: int = 4, n: int = 160000) -> None:
    """Pickle a random dataset shaped like the real L3DAS23 task-1 data
    (reference: gen_fake_task1_dataset, utility_functions.py:377-420)."""
    os.makedirs(output_path, exist_ok=True)
    rng = np.random.default_rng(0)
    preds, targets = [], []
    for _ in range(n_items):
        preds.append(np.tile(rng.random(n), (channels, 1)))
        targets.append(rng.random(n).reshape(1, n))
    for name, obj in (("predictors", preds), ("target", targets)):
        for split in ("training", "validation", "test"):
            with open(os.path.join(output_path,
                                   f"{split}_{name}.pkl"), "wb") as f:
                pickle.dump(obj, f)
