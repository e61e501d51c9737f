"""Typed experiment configuration for the PyTorch port.

The port's own copy of the JAX package's dataclasses (same field names,
defaults and JSON layout), so that every ``config.json`` written by either
package loads here unchanged. Every key is accepted, and every model form
of the JAX package builds; what the port cannot run (a frequency mesh
axis) is refused where it is asked for, never silently rerouted.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Tuple


def _astuple(x) -> Tuple[int, ...]:
    return tuple(int(v) for v in x)


def _check(name: str, value, allowed) -> None:
    if value not in allowed:
        raise ValueError(f"{name} must be one of {allowed}, got {value!r}")


@dataclass(frozen=True)
class StftConfig:
    """Signal front end: 16 kHz, 320-point FFT, 20 ms window, 10 ms hop
    (161 bins), magnitude**0.5 compression."""

    sr: int = 16000
    fft_num: int = 320
    win_size: float = 0.020   # seconds
    win_shift: float = 0.010  # seconds
    compression: float = 0.5  # magnitude exponent
    # invert the compression before the iSTFT (see dsp.stft_to_wav)
    decompress_output: bool = True

    @property
    def win_samples(self) -> int:
        return int(self.win_size * self.sr)

    @property
    def hop_samples(self) -> int:
        return int(self.win_shift * self.sr)

    @property
    def freq_bins(self) -> int:
        return self.fft_num // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        return 1 + num_samples // self.hop_samples


@dataclass(frozen=True)
class EaBNetConfig:
    """EaBNet beamformer hyperparameters."""

    k1: Tuple[int, int] = (2, 3)
    k2: Tuple[int, int] = (1, 3)
    c: int = 64
    M: int = 9
    embed_dim: int = 64
    kd1: int = 5
    cd1: int = 64
    d_feat: int = 256
    p: int = 6
    q: int = 3
    is_causal: bool = True
    is_u2: bool = True
    bf_type: str = "lstm"        # "lstm" | "cnn"
    topo_type: str = "mimo"      # "mimo" | "miso"
    intra_connect: str = "cat"   # "cat" | "add"
    norm_type: str = "IN"        # "BN" | "IN" | "cLN" | "cLN-ref"
    hid_node: int = 64
    # Lowering choices of the JAX package. Read so that every config loads;
    # in the port the tensor's device picks the kernel, not these flags.
    bf_impl: str = "scan"
    tcn_impl: str = "xla"
    bf_remat: bool = False
    enc_remat: bool = False

    def __post_init__(self):
        object.__setattr__(self, "k1", _astuple(self.k1))
        object.__setattr__(self, "k2", _astuple(self.k2))
        _check("bf_type", self.bf_type, ("lstm", "cnn"))
        _check("topo_type", self.topo_type, ("mimo", "miso"))
        _check("intra_connect", self.intra_connect, ("cat", "add"))
        _check("norm_type", self.norm_type, ("BN", "IN", "cLN", "cLN-ref"))


@dataclass(frozen=True)
class GaGNetConfig:
    """GaGNet post-filter hyperparameters."""

    cin: int = 2
    k1: Tuple[int, int] = (2, 3)
    k2: Tuple[int, int] = (1, 3)
    c: int = 64
    kd1: int = 3
    cd1: int = 64
    d_feat: int = 256
    p: int = 2
    q: int = 3
    dilas: Tuple[int, ...] = (1, 2, 5, 9)
    fft_num: int = 320
    is_u2: bool = True
    is_causal: bool = True
    is_squeezed: bool = False
    acti_type: str = "sigmoid"   # "sigmoid" | "tanh" | "relu"
    intra_connect: str = "cat"
    norm_type: str = "IN"        # "BN" | "IN" | "cLN"
    # Lowering choices of the JAX package; read, not acted on (see above).
    fused_stages: bool = False
    tcn_impl: str = "xla"
    enc_remat: bool = False

    def __post_init__(self):
        object.__setattr__(self, "k1", _astuple(self.k1))
        object.__setattr__(self, "k2", _astuple(self.k2))
        object.__setattr__(self, "dilas", _astuple(self.dilas))
        _check("acti_type", self.acti_type, ("sigmoid", "tanh", "relu"))
        _check("norm_type", self.norm_type, ("BN", "IN", "cLN", "cLN-ref"))

    @property
    def freq_bins(self) -> int:
        return self.fft_num // 2 + 1


@dataclass(frozen=True)
class ComposedConfig:
    """EaBNet -> GaGNet composed model."""

    eabnet: EaBNetConfig = field(default_factory=EaBNetConfig)
    gagnet: GaGNetConfig = field(default_factory=GaGNetConfig)
    ref_mic: int = 0
    freeze_eabnet: bool = False


@dataclass(frozen=True)
class DataConfig:
    """Data loading, as the JAX package's: the ``fake`` dataset, offline
    ``mcse`` pairs (``transfer_int16`` ships their int16 samples) and
    online ``mcse`` synthesis (``train_set="online"``: scenes drawn from
    ``mcse_settings`` over ``speech_list``/``noise_list``, RIRs by
    ``rir_backend``, in ``num_workers`` spawned processes ``prefetch``
    batches ahead). ``device_mix`` moves the room propagation onto the
    device: ``"loader"`` (or ``True``) mixes each batch there before the
    step, ``"parts"`` inside the train step, ``"scene"`` also rebuilds the
    RIRs there from scene parameters against a device-resident corpus
    (``transfer_int16`` ships the parts as int16). ``l3das23`` reads the
    L3DAS23 challenge's pickled predictor/target pairs
    (``data/l3das.py``). Every key is accepted so every config loads."""

    dataset: str = "mcse"
    train_set: str = "online"
    speech_root: str = ""
    noise_root: str = ""
    speech_list: str = ""
    noise_list: str = ""
    mcse_settings: str = ""
    val_set: str = ""
    clip_seconds: float = 6.0
    num_workers: int = 8
    prefetch: int = 4
    pad_to_seconds: float = 1.0
    device_mix: object = False
    transfer_int16: bool = False
    rir_backend: str = "auto"
    training_predictors_path: str = ""
    training_target_path: str = ""
    validation_predictors_path: str = ""
    validation_target_path: str = ""
    path_images: str = ""
    path_csv_images: str = ""


@dataclass(frozen=True)
class TrainConfig:
    """Training settings, acted on by ``train.trainer.train``.
    ``compute_dtype`` must be "float32" or "bfloat16" and ``mesh_axes``
    ("data",) (``require_training``): one card, or one rank per card of
    a data-parallel process group over ``batch_size``. ``remat`` and ``remat_policy`` are
    read and not acted on: they trade memory for recompute and do not
    change results."""

    batch_size: int = 8
    total_epoch: int = 100
    lr: float = 5e-4
    grad_clip: float = 1.0
    wav_len: float = 6.0
    saving_interval: float = 1.0
    valid_interval: float = 1.0
    log_every: int = 50
    checkpoint_dir: str = "checkpoints"
    exp_root: str = "exp"
    fixed_seed: bool = False
    seed: int = 1
    example_index: Tuple[int, ...] = (0, 10, 20, 30, 40, 50, 60, 70, 80, 90)
    validate_once_before_train: bool = False
    compute_dtype: str = "float32"
    mesh_axes: Tuple[str, ...] = ("data",)
    remat: bool = False
    remat_policy: str = ""


@dataclass(frozen=True)
class ExperimentConfig:
    """Top-level experiment config, as frozen next to checkpoints."""

    model: ComposedConfig = field(default_factory=ComposedConfig)
    stft: StftConfig = field(default_factory=StftConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentConfig":
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentConfig":
        m = d["model"]
        return cls(
            model=ComposedConfig(
                eabnet=EaBNetConfig(**m["eabnet"]),
                gagnet=GaGNetConfig(**m["gagnet"]),
                ref_mic=m.get("ref_mic", 0),
                freeze_eabnet=m.get("freeze_eabnet", False),
            ),
            stft=StftConfig(**d.get("stft", {})),
            data=DataConfig(**d.get("data", {})),
            train=TrainConfig(**{
                k: (tuple(v) if k in ("example_index", "mesh_axes") else v)
                for k, v in d.get("train", {}).items()
            }),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "ExperimentConfig":
        with open(path) as f:
            return cls.from_json(f.read())


def require_training(cfg: ExperimentConfig) -> None:
    """Refuse a training configuration the port does not run: a compute
    dtype other than float32 and bfloat16, and mesh axes other than
    ("data",). The data axis runs on one card or, inside a process group,
    on every rank (``train/trainer.py``). An unknown ``device_mix`` mode
    raises ``ValueError``, as in the JAX package."""
    if cfg.train.compute_dtype not in ("float32", "bfloat16"):
        raise NotImplementedError(
            f"compute_dtype={cfg.train.compute_dtype!r}: the port trains in "
            "float32 or bfloat16 mixed precision")
    if cfg.data.device_mix not in (False, True, "loader", "parts", "scene"):
        raise ValueError(f"unknown device_mix mode {cfg.data.device_mix!r}")
    if tuple(cfg.train.mesh_axes) != ("data",):
        raise NotImplementedError(
            f"mesh_axes={cfg.train.mesh_axes!r}: the port trains over the "
            "'data' axis only; frequency-axis model parallelism is a later "
            "slice (ROADMAP)")
