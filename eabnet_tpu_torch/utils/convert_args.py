"""Reference experiment-config ingestion.

The reference freezes its argparse namespace as `args.pickle` next to the
checkpoints (train_distributed.py:360-361) and the inference CLI reloads it
(enhance.py:16-18). This module maps that namespace onto
:class:`ExperimentConfig`, so a whole reference experiment directory
(args.pickle + <iter>.pth) is consumable as-is by the port's
``load_enhancer``. The port's own copy of the JAX package's
``utils/convert_args.py`` (the import direction).
"""

from __future__ import annotations

import os
import pickle
from typing import Any

from eabnet_tpu_torch.config import (
    ComposedConfig,
    DataConfig,
    EaBNetConfig,
    ExperimentConfig,
    GaGNetConfig,
    StftConfig,
    TrainConfig,
)


def _get(ns: Any, name: str, default):
    return getattr(ns, name, default)


def config_from_reference_args(ns: Any) -> ExperimentConfig:
    """argparse-namespace-like object -> ExperimentConfig.

    A reference ``norm_type='cLN'`` maps to our ``'cLN-ref'``: that is
    the exact math of the reference's cumulative norm (EaBNet.py:
    717-726), so an ingested checkpoint reproduces reference activations
    bit-for-bit; our ``'cLN'`` name is reserved for the variant with the
    gradient-stabilizing virtual-frame prior (nn/norms.py)."""
    _our_norm = lambda n: "cLN-ref" if n == "cLN" else n  # noqa: E731
    eab = EaBNetConfig(
        k1=tuple(_get(ns, "k1", (2, 3))),
        k2=tuple(_get(ns, "k2", (1, 3))),
        c=_get(ns, "c", 64),
        M=_get(ns, "M", 9),
        embed_dim=_get(ns, "embed_dim", 64),
        kd1=_get(ns, "kd1", 5),
        cd1=_get(ns, "cd1", 64),
        d_feat=_get(ns, "d_feat", 256),
        p=_get(ns, "p", 6),
        q=_get(ns, "q", 3),
        is_causal=bool(_get(ns, "is_causal", True)),
        is_u2=bool(_get(ns, "is_u2", True)),
        bf_type=_get(ns, "bf_type", "lstm"),
        topo_type=_get(ns, "topo_type", "mimo"),
        intra_connect=_get(ns, "intra_connect", "cat"),
        norm_type=_our_norm(_get(ns, "norm_type", "IN")),
    )
    gag = GaGNetConfig(
        cin=2,
        k1=tuple(_get(ns, "gagnet_k1", (2, 3))),
        k2=tuple(_get(ns, "gagnet_k2", (1, 3))),
        c=_get(ns, "gagnet_c", 64),
        kd1=_get(ns, "gagnet_kd1", 3),
        cd1=_get(ns, "gagnet_cd1", 64),
        d_feat=_get(ns, "gagnet_d_feat", 256),
        p=_get(ns, "gagnet_p", 2),
        q=_get(ns, "gagnet_q", 3),
        dilas=tuple(_get(ns, "gagnet_dilas", (1, 2, 5, 9))),
        fft_num=_get(ns, "gagnet_fft_num", 320),
        is_u2=bool(_get(ns, "gagnet_is_u2", True)),
        is_causal=bool(_get(ns, "gagnet_is_causal", True)),
        is_squeezed=bool(_get(ns, "gagnet_is_squeezed", False)),
        acti_type=_get(ns, "gagnet_acti_type", "sigmoid"),
        intra_connect=_get(ns, "gagnet_intra_connect", "cat"),
        norm_type=_our_norm(_get(ns, "gagnet_norm_type", "IN")),
    )
    stft = StftConfig(
        sr=_get(ns, "sr", 16000),
        fft_num=_get(ns, "fft_num", 320),
        win_size=_get(ns, "win_size", 0.020),
        win_shift=_get(ns, "win_shift", 0.010),
    )
    data = DataConfig(
        dataset=_get(ns, "dataset", "mcse"),
        train_set=_get(ns, "mcse_dataset_train_set", "online"),
        speech_root=_get(ns, "mcse_dataset_train_speech_root", "") or "",
        noise_root=_get(ns, "mcse_dataset_train_noise_root", "") or "",
        mcse_settings=_get(ns, "mcse_dataset_settings", "") or "",
        val_set=_get(ns, "mcse_dataset_val_set", "") or "",
        num_workers=_get(ns, "num_workers", 8),
        training_predictors_path=_get(ns, "training_predictors_path", "")
        or "",
        training_target_path=_get(ns, "training_target_path", "") or "",
        validation_predictors_path=_get(
            ns, "validation_predictors_path", "") or "",
        validation_target_path=_get(ns, "validation_target_path", "")
        or "",
        path_images=_get(ns, "path_images", "") or "",
    )
    train = TrainConfig(
        batch_size=_get(ns, "batch_size", 8),
        total_epoch=_get(ns, "total_epoch", 100),
        wav_len=_get(ns, "wav_len", 6.0),
        saving_interval=_get(ns, "saving_interval", 1.0),
        valid_interval=_get(ns, "valid_interval", 1.0),
        checkpoint_dir=_get(ns, "checkpoint_dir", "checkpoints"),
        exp_root=_get(ns, "exp_root", "exp"),
        fixed_seed=bool(_get(ns, "fixed_seed", False)),
        example_index=tuple(_get(ns, "example_index",
                                 (0, 10, 20, 30, 40, 50, 60, 70, 80, 90))),
        validate_once_before_train=bool(
            _get(ns, "validate_once_before_train", False)),
    )
    return ExperimentConfig(
        model=ComposedConfig(
            eabnet=eab,
            gagnet=gag,
            ref_mic=_get(ns, "ref_mic", 0),
            freeze_eabnet=bool(_get(ns, "freeze_eabnet", False)),
        ),
        stft=stft,
        data=data,
        train=train,
    )


def load_reference_experiment(exp_root: str) -> ExperimentConfig:
    """Load `args.pickle` from a reference experiment directory."""
    path = os.path.join(exp_root, "args.pickle")
    with open(path, "rb") as f:
        ns = pickle.load(f)
    return config_from_reference_args(ns)
