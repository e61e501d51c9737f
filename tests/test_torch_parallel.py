"""The port's multi-card pieces that need no process group, in one
process: meshes against the JAX package's, each rank's rows of the
global batch, the validation shares, the loss's share of a global batch,
and batch serving over a mesh of two CPU devices against one replica.
The two-rank runs are in tests/test_torch_ddp.py."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from eabnet_tpu.parallel.mesh import host_local_slice as jax_host_local_slice
from eabnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from eabnet_tpu_torch import parallel
from eabnet_tpu_torch.config import (ComposedConfig, DataConfig, EaBNetConfig,
                                     ExperimentConfig, GaGNetConfig,
                                     TrainConfig, require_training)
from eabnet_tpu_torch.data import datasets as PD
from eabnet_tpu_torch.inference import Enhancer
from eabnet_tpu_torch.losses import eabnet_with_postnet_loss
from eabnet_tpu_torch.models import build_model
from eabnet_tpu_torch.parallel import make_mesh
from eabnet_tpu_torch.train.trainer import _Items
from eabnet_tpu_torch.utils.audio_io import write_wav
from eabnet_tpu_torch.weights import to_jax_tree

from _float64_port import enhance64, scaled_error
from _kaiming_init import kaiming_model
from test_data import SETTINGS_V2, _write_fake_corpus

SERVE_ATOL = 2e-5  # tests/test_inference_mesh.py:75


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the port: on a host that other test workers
    load, more threads mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("axes,sizes", [
    (("data",), None), (("data", "freq"), None), (("data", "freq"), (2, 4)),
    (("data", "freq"), (1, -1)), (("data", "freq"), (-1, 2)),
    (("a", "b", "c"), (2, -1, 2))])
def test_make_mesh_shapes_are_jax(axes, sizes):
    devices = jax.devices()
    assert len(devices) == 8
    want = jax_make_mesh(axes, devices, sizes)
    got = make_mesh(axes, ["cpu"] * 8, sizes)
    assert got.shape == dict(want.shape) and got.size == want.size == 8
    assert got.axis_names == tuple(want.axis_names)
    assert all(d == torch.device("cpu") for d in got.devices.flat)
    with pytest.raises(ValueError):
        make_mesh(("data", "freq"), ["cpu"] * 8, (3, 3))


def test_host_local_slice_is_jax():
    for n in range(0, 12):
        for world in range(1, 5):
            shares = [parallel.host_local_slice(r, world, n)
                      for r in range(world)]
            assert shares == [jax_host_local_slice(r, world, n)
                              for r in range(world)]
            assert sorted(i for s in shares for i in s) == list(range(n))


def test_without_a_group():
    assert not parallel.in_group()
    assert (parallel.process_index(), parallel.process_count(),
            parallel.local_index(), parallel.is_chief()) == (0, 1, 0, True)
    assert parallel.all_processes_mean(6.0, 4.0) == 1.5
    assert parallel.all_processes_mean(0.0, 0.0) == 0.0


def test_require_training_takes_the_data_axis():
    """The JAX trainer's mesh: the leading axis over every rank, the others
    of extent 1, so ('data', 'freq') trains as ('data',) does; a 'freq'
    axis wider than 1 raises and names serving, and axes without 'data'
    are refused."""
    for axes in (("data",), ("data", "freq"), ("freq", "data")):
        require_training(ExperimentConfig(train=TrainConfig(mesh_axes=axes)))
    require_training(ExperimentConfig(train=TrainConfig(
        mesh_axes=("data", "freq"))), world=4)
    with pytest.raises(NotImplementedError, match="serving"):
        require_training(ExperimentConfig(train=TrainConfig(
            mesh_axes=("freq", "data"))), world=2)
    with pytest.raises(ValueError, match="data"):
        require_training(ExperimentConfig(train=TrainConfig(
            mesh_axes=("freq",))))


def test_data_parallel_cards_rule():
    """The JAX trainer's rule: the most devices that divide the batch."""
    from eabnet_tpu_torch.cli.train import data_parallel_cards

    assert [data_parallel_cards(b, 8) for b in (8, 16, 7, 6, 12, 1)] == \
        [8, 8, 7, 6, 6, 1]
    assert data_parallel_cards(8, 0) == data_parallel_cards(8, 1) == 1


# ---------------------------------------------------------------- loader
def offline_set(root, lengths, seed=0):
    rng = np.random.default_rng(seed)
    for sub in ("clean", "noisy"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i, n in enumerate(lengths):
        write_wav(os.path.join(root, "clean", f"{i:02d}.wav"), 16000,
                  rng.standard_normal(n) * 0.1, dtype="float")
        write_wav(os.path.join(root, "noisy", f"{i:02d}.wav"), 16000,
                  rng.standard_normal((2, n)) * 0.1, dtype="float")
    return PD.OfflineMcseDataset(str(root))


def pad_to(x, n):
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, n - x.shape[-1])])


@pytest.mark.parametrize("world", [2, 4])
def test_rank_rows_of_offline_batches(tmp_path, world):
    """Each rank's rows of each global batch, padded to the global batch's
    length as the data-parallel step pads them, are that batch's rows bit
    for bit, with their lengths; every rank has the same len()."""
    ds = offline_set(tmp_path, [1600, 900, 1300, 1600, 700, 1100, 1500,
                                1000, 1200, 800, 1400, 600])
    one = PD.BatchLoader(ds, 4, shuffle=True, seed=3)
    ranks = [PD.BatchLoader(ds, 4, shuffle=True, seed=3, rank=r, world=world)
             for r in range(world)]
    assert {len(r) for r in ranks} == {len(one)} and len(one) == 3
    for epoch in (0, 1):
        per_rank = [list(r.epoch(epoch)) for r in ranks]
        for b, (noisy, clean, n) in enumerate(one.epoch(epoch)):
            rows = [p[b] for p in per_rank]
            assert all(r[0].shape[0] == 4 // world for r in rows)
            np.testing.assert_array_equal(
                np.concatenate([pad_to(r[0], noisy.shape[-1]) for r in rows]),
                noisy)
            np.testing.assert_array_equal(
                np.concatenate([pad_to(r[1], clean.shape[-1]) for r in rows]),
                clean)
            np.testing.assert_array_equal(
                np.concatenate([r[2] for r in rows]), n)
    with pytest.raises(ValueError):
        PD.BatchLoader(ds, 4, rank=0, world=3)


@pytest.mark.parametrize("mode", ["parts", "scene"])
def test_rank_rows_of_online_batches(tmp_path, mode):
    """Online synthesis (numpy RIRs): each rank synthesizes only its rows,
    with one process's item seeds, and the rows join into one process's
    batch bit for bit."""
    sp_dir, no_dir = _write_fake_corpus(tmp_path)
    settings = tmp_path / "settings.json"
    settings.write_text(json.dumps(SETTINGS_V2))
    ds = PD.OnlineMcseDataset(DataConfig(
        dataset="mcse", train_set="online", speech_root=str(sp_dir),
        noise_root=str(no_dir), speech_list=str(tmp_path / "speech_list.txt"),
        noise_list=str(tmp_path / "noise_list.txt"),
        mcse_settings=str(settings), clip_seconds=1.0, rir_backend="numpy"),
        seed=5)
    kw = dict(shuffle=True, seed=3, device_mix=mode, rir_pad=14016)
    one = list(PD.BatchLoader(ds, 2, **kw).epoch(1))
    ranks = [list(PD.BatchLoader(ds, 2, rank=r, world=2, **kw).epoch(1))
             for r in range(2)]
    assert len(one) == len(ranks[0]) == len(ranks[1]) == 1
    for key, want in one[0].items():
        got = np.concatenate([r[0][key] for r in ranks])
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("world", [2, 3])
def test_validation_shares_cover_every_item(tmp_path, world):
    """7 validation items over 2 and 3 ranks: every item once, and the mean
    of the ranks' (sum, count) pairs is the unsharded mean."""
    ds = offline_set(tmp_path, [800, 1200, 900, 1600, 700, 1000, 1100],
                     seed=1)

    def item_means(d):
        return [float(np.mean(b[1])) for b in PD.BatchLoader(
            d, 1, shuffle=False, drop_last=False).epoch(0)]

    whole = item_means(ds)
    shares = [item_means(_Items(ds, parallel.host_local_slice(r, world, 7)))
              for r in range(world)]
    assert sorted(x for s in shares for x in s) == sorted(whole)
    total = sum(sum(s) for s in shares)
    count = sum(len(s) for s in shares)
    assert total / count == pytest.approx(np.mean(whole), rel=1e-12)


def test_loss_shares_sum_to_the_global_loss():
    """Two halves of a ragged batch, each divided by the global batch's
    frames: their losses and gradients sum to the global batch's; each
    divided by its own frames (a mean of means) they do not."""
    rng = np.random.default_rng(0)
    b, t, f = 4, 12, 9
    label = torch.from_numpy(rng.standard_normal((b, t, f, 2))
                             .astype(np.float32))
    stages = [torch.from_numpy(rng.standard_normal((b, t, f, 2)).astype(
        np.float32)).requires_grad_() for _ in range(3)]
    counts = torch.tensor([12, 5, 3, 2])
    mask = (torch.arange(t)[None] < counts[:, None]).float()
    whole = eabnet_with_postnet_loss(
        {"esti0": stages[0], "esti1": stages[1:]}, label, mask)
    grads = torch.autograd.grad(whole["final"], stages)
    frames = mask.sum()
    parts, part_grads, means = [], [], []
    for rows in (slice(0, 2), slice(2, 4)):
        out = {"esti0": stages[0][rows], "esti1": [s[rows] for s in
                                                    stages[1:]]}
        share = eabnet_with_postnet_loss(out, label[rows], mask[rows], frames)
        parts.append(share)
        part_grads.append(torch.autograd.grad(share["final"], stages))
        means.append(eabnet_with_postnet_loss(out, label[rows], mask[rows])
                     ["final"])
    for k in whole:
        np.testing.assert_allclose(float(parts[0][k] + parts[1][k]),
                                   float(whole[k]), rtol=1e-6)
    for g, g0, g1 in zip(grads, *part_grads):
        np.testing.assert_allclose((g0 + g1).numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-8)
    assert abs(float(sum(means)) / 2 - float(whole["final"])) > \
        1e-3 * float(whole["final"])


# ---------------------------------------------------------------- serving
def tiny_serving_cfg(norm):
    return ExperimentConfig(model=ComposedConfig(
        eabnet=EaBNetConfig(c=8, M=3, embed_dim=8, cd1=8, p=2, q=1,
                            norm_type=norm),
        gagnet=GaGNetConfig(c=8, cd1=8, p=1, q=1, dilas=(1, 2),
                            norm_type=norm)))


@pytest.mark.parametrize("norm", ["IN", "cLN"])
@pytest.mark.parametrize("dtype", ["float32", "int8w"])
def test_enhancer_over_a_mesh_matches_one_replica(norm, dtype):
    """Enhancer(mesh=make_mesh(devices=["cpu", "cpu"])): one replica per
    entry; 3 items padded to 4, slice k (2 items) through replica k, the
    outputs in order: bit for bit what one replica gives on each slice,
    and in float32 within 2e-5 of one replica on the whole batch (in
    int8w, bf16 products of another batch size round otherwise)."""
    cfg = tiny_serving_cfg(norm)
    torch.manual_seed(0)
    model = kaiming_model(cfg.model)
    params = to_jax_tree(model, dict(model.named_parameters()))
    mesh = make_mesh(devices=["cpu", "cpu"])
    assert mesh.shape == {"data": 2}
    meshed = Enhancer(cfg, params, mesh=mesh, compute_dtype=dtype,
                      device="cuda")  # the mesh's devices, not this one
    one = Enhancer(cfg, params, compute_dtype=dtype, device="cpu")
    assert len(meshed.replicas) == 2 and meshed._batch_quantum == 2
    assert meshed.param_bytes() == 2 * one.param_bytes()
    rng = np.random.default_rng(1)
    lengths = (4000, 2500, 3300)
    wavs = [(rng.standard_normal((3, n)) * 0.1).astype(np.float32)
            for n in lengths]
    got = meshed.enhance_batch(wavs)
    assert [g.shape for g in got] == [(n,) for n in lengths]
    padded = -(-(max(lengths) + cfg.stft.fft_num // 2 + 1) // meshed.bucket
               ) * meshed.bucket
    batch = torch.from_numpy(np.stack(
        [np.pad(w, ((0, 0), (0, padded - w.shape[-1]))) for w in wavs]
        + [np.zeros((3, padded), np.float32)]))
    sliced = torch.cat([one.enhance_tensor(batch[:2]),
                        one.enhance_tensor(batch[2:])]).numpy()
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g, sliced[i][:lengths[i]])
    if dtype == "float32":
        for g, w in zip(got, one.enhance_batch(wavs)):
            np.testing.assert_allclose(g, w, atol=SERVE_ATOL, rtol=0)


def test_mesh_replicas_at_the_jax_init_scale():
    """The mesh test's IN model drawn with the port's own initialisers
    (the JAX package's, whose outputs are larger): the two replicas'
    outputs within the JAX test's 2e-5 times max(1, max |output|) of one
    replica on the whole batch run in float64."""
    cfg = tiny_serving_cfg("IN")
    torch.manual_seed(0)
    model = build_model(cfg.model)
    params = to_jax_tree(model, dict(model.named_parameters()))
    rng = np.random.default_rng(1)
    wavs = [(rng.standard_normal((3, n)) * 0.1).astype(np.float32)
            for n in (4000, 2500, 3300)]
    got = Enhancer(cfg, params, mesh=make_mesh(devices=["cpu", "cpu"]),
                   device="cpu").enhance_batch(wavs)
    err, limit = scaled_error(got, enhance64(cfg, params, wavs))
    assert err <= limit, (err, limit)


def test_cli_enhance_over_a_mesh(tmp_path):
    """cli.enhance --mesh on a directory, on the CPU's one-device mesh:
    every file written, equal to the Enhancer's output."""
    from eabnet_tpu_torch.cli.enhance import main
    from eabnet_tpu_torch.utils.audio_io import read_wav

    cfg = tiny_serving_cfg("cLN")
    torch.manual_seed(1)
    model = kaiming_model(cfg.model)
    params = to_jax_tree(model, dict(model.named_parameters()))
    exp = tmp_path / "exp"
    (exp / "ckpt").mkdir(parents=True)
    d = json.loads(cfg.to_json())
    d["train"]["checkpoint_dir"] = str(exp / "ckpt")
    (exp / "config.json").write_text(json.dumps(d))
    from eabnet_tpu_torch.checkpoint import msgpack_serialize

    (exp / "ckpt" / "10.params").write_bytes(
        msgpack_serialize({"params": params}))
    src, dst = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    rng = np.random.default_rng(2)
    wavs = [(rng.standard_normal((3, n)) * 0.1).astype(np.float32)
            for n in (3000, 2000, 2600)]
    for i, w in enumerate(wavs):
        write_wav(str(src / f"{i}.wav"), 16000, w, dtype="float")
    main([str(src), str(dst), "--exp-root", str(exp), "--device", "cpu",
          "--mesh"])
    want = Enhancer(cfg, params, device="cpu").enhance_batch(wavs)
    for i, w in enumerate(want):
        np.testing.assert_allclose(read_wav(str(dst / f"{i}.wav"))[1], w,
                                   atol=SERVE_ATOL, rtol=0)
