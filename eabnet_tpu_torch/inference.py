"""Offline enhancement with a shipped model, in PyTorch.

``load_enhancer(exp_root)`` reads ``config.json`` and the newest
``<iter>.params`` of an experiment directory written by the JAX package
(or ``args.pickle`` and the newest ``<iter>.pth`` of a reference one) and
returns an ``Enhancer``: 9-mic wav in, enhanced wav out, with either
shipped model (``release/composed_9mic``, IN; ``release/eabnet_9mic_cln``,
cLN). The model runs on ``device`` (default ``"cuda"``); on a CUDA device
the LSTM head and the causal IN TCN groups go through the hand-written
kernels, on ``"cpu"`` through their plain versions. Like the JAX
package's, the Enhancer applies params only, so batch-norm models are not
served.

``compute_dtype`` is the JAX package's: ``"float32"``; ``"bfloat16"``, the
whole model in bf16 (the kernels' bf16 variants on the card); or
``"int8w"``, weights-only int8 (``utils/quantize.py``) kept packed on the
device and dequantized to bf16 inside each call. The STFT front end and
the iSTFT run in float32 in every mode.

``mesh`` (``parallel.make_mesh``) serves batches over devices, as the JAX
package's Enhancer shards a batch over a mesh's ``data`` axis: one replica
of the model (packed per replica in int8w) on each device of that axis;
the batch is padded to a multiple of the axis's size, slice k runs on
device k, and the outputs come back in order. The slices are issued from
one thread: the inputs are copied up first, then every replica's forward
is queued (the forwards hold no host sync, and each card runs its own
queue), then the outputs are read. A mesh with other axes beside
``data`` serves the same way over its ``data`` axis (the JAX package
replicates the batch over them).

``shard_freq`` (frequency-axis model parallelism) serves one utterance
over the ranks of a ``torch.distributed`` group laid out on a ('data',
'freq') ``mesh`` of the group's size, one rank per entry (rank r = (d,
f), ``parallel/mesh.py::axis_group``), as the JAX package's GSPMD splits F
over the mesh's ``freq`` axis: every rank calls the Enhancer with the same
wavs; rank (d, f) takes rows d of the batch (padded to a multiple of
``data``), runs the STFT on them, keeps its bins and runs the model on
them inside ``parallel.freq.sharding`` (halo-exchanged convs along F,
F-wide norm sums, the LSTM-BF head on its own B·F_r lanes, the post-filter
row- and column-parallel); the estimate's bins are gathered over
``freq`` before the iSTFT and the rows over ``data``, so each rank returns
the whole output. int8w dequantizes on each rank. On a CUDA rank the
hand-written kernels run as on one card, and a collective that waits past
the group's timeout raises.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
from torch.func import functional_call

from eabnet_tpu_torch.checkpoint import latest_checkpoint, load_params
from eabnet_tpu_torch.config import ExperimentConfig
from eabnet_tpu_torch.dsp import prepare_data, stft_to_wav
from eabnet_tpu_torch.models import build_model
from eabnet_tpu_torch.models.eabnet import to_reference_layout
from eabnet_tpu_torch.parallel import freq
from eabnet_tpu_torch.parallel.mesh import (axis_group, process_count,
                                            process_index)
from eabnet_tpu_torch.utils.audio_io import read_wav, resample, write_wav
from eabnet_tpu_torch.utils.precision import float32_products
from eabnet_tpu_torch.utils.quantize import (PackedWeights, pack_for_module,
                                             quantize_weights_int8)
from eabnet_tpu_torch.weights import load_jax_params

COMPUTE_DTYPES = ("float32", "bfloat16", "int8w")


class Enhancer:
    """wav (M, N) -> enhanced wav (N,).

    Inputs are zero-padded up to a length bucket (``bucket_seconds``), with
    a guaranteed zero tail of n_fft/2 + 1 samples first unless ``pad_mode``
    is ``"reference"``, as the JAX package's Enhancer does. ``output``
    picks the stage: ``"esti"`` (beamformer + post-filter) or ``"esti0"``
    (beamformer alone). ``compute_dtype``: see the module doc; in
    ``"int8w"`` the model's own parameters live on the meta device and the
    packed ones (``self.packed``) on ``device``. With a ``mesh``,
    ``device`` is unused: ``self.replicas`` holds one (model, packed) per
    device of the mesh's ``data`` axis, and ``self.model``/``self.packed``
    are the first. With ``shard_freq`` the rank's entry of the mesh is its
    device, ``self.shard`` its ``parallel.freq.FreqShard`` and
    ``self.rows`` its (index, ranks, group) on the ``data`` axis.
    """

    def __init__(self, cfg: ExperimentConfig, params: dict,
                 bucket_seconds: float = 1.0, output: str = "esti",
                 compute_dtype: str = "float32", mesh=None,
                 shard_freq: bool = False, pad_mode: str = "tail",
                 device: str = "cuda"):
        if output not in ("esti", "esti0"):
            raise ValueError(f"output must be 'esti' or 'esti0', "
                             f"got {output!r}")
        if pad_mode not in ("tail", "reference"):
            raise ValueError(f"pad_mode must be 'tail' or 'reference', "
                             f"got {pad_mode!r}")
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                             f"got {compute_dtype!r}")
        if "BN" in (cfg.model.eabnet.norm_type, cfg.model.gagnet.norm_type):
            raise NotImplementedError(
                "norm_type='BN': the Enhancer applies params only, as the "
                "JAX package's does, and has no running statistics to serve "
                "a batch-norm model with")
        devices, self.shard, self.rows = [device], None, None
        if shard_freq:
            if mesh is None or "freq" not in mesh.shape \
                    or "data" not in mesh.shape:
                raise ValueError(
                    "shard_freq needs a mesh with a 'freq' axis, e.g. "
                    "make_mesh(('data', 'freq'), devices, sizes=(1, -1))")
            if mesh.size != process_count():
                raise ValueError(
                    f"shard_freq: a mesh of {mesh.size} entries for a group "
                    f"of {process_count()} rank(s); each rank serves one "
                    "entry of the ('data', 'freq') mesh")
            devices = [mesh.devices.flat[process_index()]]
            if devices[0].type == "cuda":  # NCCL's collectives use it
                torch.cuda.set_device(devices[0])
            index, peers, group = axis_group(mesh, "freq")
            self.shard = freq.FreqShard(group, index, len(peers), peers,
                                        cfg.stft.freq_bins)
            self.rows = axis_group(mesh, "data")
        elif mesh is not None:
            if "data" not in mesh.shape:
                raise ValueError(f"mesh {mesh.shape} has no 'data' axis")
            # one replica per entry of the 'data' axis
            devices = list(np.moveaxis(
                mesh.devices, mesh.axis_names.index("data"), 0).reshape(
                mesh.shape["data"], -1)[:, 0])
        self.cfg = cfg
        self.output = output
        self.pad_mode = pad_mode
        self.device = torch.device(devices[0])
        self.bucket = max(1, int(bucket_seconds * cfg.stft.sr))
        self.compute_dtype = compute_dtype
        self.dtype = (torch.float32 if compute_dtype == "float32"
                      else torch.bfloat16)
        if compute_dtype == "int8w":
            model = build_model(cfg.model).to("meta").eval()
            packed = pack_for_module(model, quantize_weights_int8(params))
            self.replicas = [(model, PackedWeights(packed, torch.device(d)))
                             for d in devices]
        else:
            self.replicas = [(load_jax_params(build_model(cfg.model), params)
                              .to(d, self.dtype).eval(), None)
                             for d in devices]
        self.model, self.packed = self.replicas[0]
        self.devices = [torch.device(d) for d in devices]
        self._batch_quantum = (len(self.rows[1]) if self.rows
                               else len(self.replicas))

    def param_bytes(self) -> int:
        """Bytes of the parameters resident on the devices: the model's in
        float32 and bfloat16, the packed values and scales in int8w, summed
        over the replicas."""
        if self.packed is not None:
            return sum(p.nbytes() for _, p in self.replicas)
        return sum(p.nbytes for m, _ in self.replicas
                   for p in m.parameters())

    @torch.no_grad()
    def enhance_tensor(self, batch: torch.Tensor) -> torch.Tensor:
        """(B, M, N) padded waveforms on ``self.device`` -> (B, N), with
        float32 products on the card (``float32_products``)."""
        with float32_products(batch.device):
            return self._enhance(batch)

    def _enhance(self, batch: torch.Tensor, replica: int = 0
                 ) -> torch.Tensor:
        model, packed = self.replicas[replica]
        noisy_stft, _ = prepare_data(batch, None, self.cfg.stft)
        noisy_stft = noisy_stft.to(self.dtype)
        if self.shard is not None:  # this rank's bins
            lo, hi = self.shard.owned(self.shard.bins)
            noisy_stft = noisy_stft[:, :, lo:hi]
        with freq.sharding(self.shard):
            if packed is not None:
                # no parameter is tied, so the tied-weight search is skipped
                out = functional_call(model, packed.dequantize(self.dtype),
                                      (noisy_stft,), tie_weights=False)
            else:
                out = model(noisy_stft)
        esti = out[self.output].float()
        if self.shard is not None:
            esti = self.shard.gather_freq(esti, dim=2)
        return stft_to_wav(to_reference_layout(esti), self.cfg.stft)

    def __call__(self, noisy: np.ndarray,
                 mic_permutation: Optional[list] = None) -> np.ndarray:
        return self.enhance_batch([noisy], mic_permutation)[0]

    def enhance_batch(self, wavs, mic_permutation: Optional[list] = None
                      ) -> List[np.ndarray]:
        """Enhance a list of (M, N_i) wavs as one batch; each output is
        trimmed back to its item's length."""
        if not wavs:
            return []
        mics = {w.shape[0] for w in wavs}
        if len(mics) != 1:
            raise ValueError(
                f"all items in a batch must share a mic count, got {mics}")
        if mic_permutation is not None:
            idx = np.asarray(mic_permutation)
            (m,) = mics
            if idx.ndim != 1 or idx.size == 0 or idx.min() < 0 \
                    or idx.max() >= m:
                raise ValueError(f"mic_permutation {mic_permutation} out of "
                                 f"range for {m}-mic input")
            wavs = [w[idx] for w in wavs]
        lengths = [w.shape[-1] for w in wavs]
        tail = 0 if self.pad_mode == "reference" \
            else self.cfg.stft.fft_num // 2 + 1
        padded = -(-(max(lengths) + tail) // self.bucket) * self.bucket
        batch = np.stack([np.pad(w, ((0, 0), (0, padded - w.shape[-1])))
                          for w in wavs]).astype(np.float32)
        out = self._enhance_slices(batch)
        return [out[i][:n] for i, n in enumerate(lengths)]

    @torch.no_grad()
    def _enhance_slices(self, batch: np.ndarray) -> np.ndarray:
        """The batch padded to a multiple of the replicas, slice k through
        replica k (one slice without a mesh); every input copied up before
        any forward is queued, and no output read before every forward
        is. With ``shard_freq``: this rank's rows, every row back."""
        q = self._batch_quantum
        rows = -(-batch.shape[0] // q)
        batch = np.pad(batch, ((0, rows * q - batch.shape[0]), (0, 0),
                               (0, 0)))
        if self.shard is not None:
            d, peers, group = self.rows
            x = torch.from_numpy(batch[d * rows:(d + 1) * rows]).to(
                self.device)
            with float32_products(x.device):
                out = freq.gather_rows(self._enhance(x), group, len(peers))
            return out.cpu().numpy()
        ins = [torch.from_numpy(batch[k * rows:(k + 1) * rows]).to(dev)
               for k, dev in enumerate(self.devices)]
        outs = []
        for k, x in enumerate(ins):
            with float32_products(x.device):
                outs.append(self._enhance(x, k))
        return np.concatenate([o.cpu().numpy() for o in outs])

    def _read(self, path: str) -> np.ndarray:
        sr, noisy = read_wav(path)
        if noisy.ndim == 1:
            noisy = noisy[None]
        if sr != self.cfg.stft.sr:
            noisy = resample(noisy, sr, self.cfg.stft.sr)
        return noisy

    def enhance_files(self, in_paths, out_paths,
                      mic_permutation: Optional[list] = None,
                      batch_size: Optional[int] = None) -> None:
        """Enhance many files in batches of ``batch_size`` (default: the
        mesh's ``data`` axis, 1 without a mesh). With ``shard_freq`` every
        rank enhances and rank 0 writes."""
        if len(in_paths) != len(out_paths):
            raise ValueError("in_paths and out_paths must align")
        batch_size = batch_size or self._batch_quantum
        for lo in range(0, len(in_paths), batch_size):
            outs = self.enhance_batch(
                [self._read(p) for p in in_paths[lo:lo + batch_size]],
                mic_permutation)
            if self.shard is not None and process_index() != 0:
                continue
            for path, wav in zip(out_paths[lo:lo + batch_size], outs):
                write_wav(path, self.cfg.stft.sr, wav, dtype="float")

    def enhance_file(self, in_path: str, out_path: str,
                     mic_permutation: Optional[list] = None) -> None:
        self.enhance_files([in_path], [out_path], mic_permutation)


def load_enhancer(exp_root: str, checkpoint: Optional[str] = None,
                  output: str = "esti", compute_dtype: str = "float32",
                  mesh=None, shard_freq: bool = False,
                  device: str = "cuda") -> Enhancer:
    """Build an Enhancer from an experiment directory, the JAX package's
    (``config.json`` and the newest checkpoint) or a reference one
    (``args.pickle`` and the newest ``<iter>.pth``,
    ``utils/convert_args.py``), or from an explicit checkpoint path."""
    if os.path.exists(os.path.join(exp_root, "config.json")):
        cfg = ExperimentConfig.load(os.path.join(exp_root, "config.json"))
    elif os.path.exists(os.path.join(exp_root, "args.pickle")):
        from eabnet_tpu_torch.utils.convert_args import \
            load_reference_experiment

        cfg = load_reference_experiment(exp_root)
    else:
        raise FileNotFoundError(
            f"no config.json or args.pickle under {exp_root}")
    ckpt_dir = cfg.train.checkpoint_dir
    if not os.path.isabs(ckpt_dir):
        ckpt_dir = os.path.join(exp_root, os.path.basename(ckpt_dir))
    ckpt = checkpoint or latest_checkpoint(ckpt_dir) \
        or latest_checkpoint(exp_root)
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint found under {exp_root}")
    return Enhancer(cfg, load_params(ckpt, cfg.model), output=output,
                    compute_dtype=compute_dtype, mesh=mesh,
                    shard_freq=shard_freq, device=device)
