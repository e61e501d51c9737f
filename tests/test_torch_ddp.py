"""The port's data-parallel training in two gloo ranks on the CPU, against
the JAX package's train step on a 2-device mesh over the same global
batches.

The ranks run this file as a script, so a rank process imports neither
JAX nor ``tests/conftest.py`` (JAX is imported inside the test functions
only):

    python tests/test_torch_ddp.py steps <rank> <world> <port> <dir>
    python tests/test_torch_ddp.py cli <dir> <cli.train arguments...>
    python tests/test_torch_ddp.py launch <dir>

- ``steps``: ``train_step`` of an IN and of a BN config (the plain-UNet
  form of ``tests/test_train_multichip.py::small_cfg``: M=3, 0.2 s,
  global batch 4; the plain UNet: under half the U²Net's JAX compile)
  for 2 steps on ragged rows (unequal frame counts and lengths across the
  ranks, so a mean of the ranks' means is wrong), then the same steps
  with the loss normalised per rank (the variant the checks must reject),
  then ``train()`` of the BN config on a ragged offline set, validating
  once on 7 items sharded over the ranks;
- ``cli``: ``cli.train --multihost`` of the IN config, joining the group
  from torchrun's environment variables;
- ``launch``: ``parallel.launch.spawn`` after ``build_once``: the ranks
  find the native RIR engine built, and a failed rank ends a run whose
  other rank waits in an all-reduce; then ``cli.train``'s own spawn over
  cards (``train_on_cards``, here two gloo ranks on the host) against
  ``train()`` in one process, from the same seeded init.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, BATCH, N, M = 2, 4, 3200, 3
INIT_STEP = 1000
LENGTHS = ((3200, 2500, 2900, 2300), (2600, 3200, 2000, 2800))
TRAIN_LENGTHS = (3200, 2400, 3000, 2100, 2900, 3200, 1900, 2700)
VAL_LENGTHS = (3200, 2200, 2600, 3100, 1800, 2900, 2500)
NORMS = ("IN", "BN")
LOSS_KEYS = ("eabnet", "postnet", "final")
# JAX's own tolerances between one device and a mesh
# (tests/test_train_multichip.py:100-109)
LOSS_RTOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-5, 1e-3
LR = 5e-4
# Parameters outside JAX's multi-device tolerance: at most this many
# elements of 848,529, each within this many lr (module doc of
# _check_params). Measured (CPU): train_step 1 (IN) and 2 (BN) elements,
# within 0.0999 / 0.2071 lr; train() 355 (IN) and 257 (BN), within
# 1.2044 / 0.9261 lr.
STEP_OUTSIDE, STEP_WORST_LR = 10, 0.5
TRAIN_OUTSIDE, TRAIN_WORST_LR = 530, 1.8
RANK_TIMEOUT_S = 300


def cfg_dict(norm: str, root: str) -> dict:
    """The test's config as a JSON dict (the JAX package's keys)."""
    net = dict(c=8, M=M, embed_dim=8, cd1=8, p=2, q=1, norm_type=norm,
               is_u2=False)
    post = dict(c=8, cd1=8, p=1, q=1, dilas=[1, 2], norm_type=norm,
                is_u2=False)
    run = os.path.join(root, f"run_{norm}")
    return {
        "model": {"eabnet": net, "gagnet": post},
        "data": {"dataset": "mcse", "train_set": "offline",
                 "speech_root": os.path.join(root, "train"),
                 "val_set": os.path.join(root, "val"),
                 "pad_to_seconds": 0.2},
        "train": {"batch_size": BATCH, "wav_len": 0.2, "lr": LR,
                  "grad_clip": 1.0, "total_epoch": 100, "log_every": 1000,
                  "saving_interval": 1e18, "valid_interval": 1e18,
                  "fixed_seed": True, "validate_once_before_train": True,
                  "checkpoint_dir": os.path.join(run, "ckpt"),
                  "exp_root": run},
    }


def rank_rows(x, rank: int):
    return x[rank * BATCH // WORLD:(rank + 1) * BATCH // WORLD]


# ---------------------------------------------------------------------------
# rank processes (no JAX)


def _one_thread():
    import torch

    torch.set_num_threads(1)


def _record_validation(out: list):
    """Record every validation loss train() computes."""
    from eabnet_tpu_torch.train import trainer as T

    validate = T.validate

    def recorded(*args, **kwargs):
        out.append(validate(*args, **kwargs))
        return out[-1]

    T.validate = recorded


def _flat_params(model) -> dict:
    from eabnet_tpu_torch.weights import flatten_tree, to_jax_tree

    return flatten_tree(to_jax_tree(model, dict(model.named_parameters())))


def _steps(rank: int, world: int, port: int, root: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    from eabnet_tpu_torch.checkpoint import load_params
    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.models import build_model
    from eabnet_tpu_torch.train import step as P
    from eabnet_tpu_torch.train.trainer import train
    from eabnet_tpu_torch.weights import (flatten_tree, load_jax_params,
                                          to_jax_batch_stats)

    _one_thread()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    data = np.load(os.path.join(root, "batches.npz"))
    out = {}
    for norm in NORMS:
        cfg = ExperimentConfig.from_dict(cfg_dict(norm, root))
        init = load_params(os.path.join(root, f"init_{norm}.params"))
        for variant in ("ddp", "rank_mean"):
            model = load_jax_params(build_model(cfg.model), init)
            state = P.TrainState(INIT_STEP, model, P.adam_init(model))
            step = P.make_train_step(cfg)
            frames = P.global_frames
            if variant == "rank_mean":  # each rank's loss over its own frames
                P.global_frames = lambda c: c * world
            try:
                for s, lengths in enumerate(LENGTHS):
                    n = rank_rows(np.array(lengths, np.int32), rank)
                    # the rank's own collation: padded to its longest row
                    cut = int(n.max())
                    state, losses = step(
                        state,
                        torch.from_numpy(rank_rows(data["noisy"][s], rank)
                                         [..., :cut].copy()),
                        torch.from_numpy(rank_rows(data["clean"][s], rank)
                                         [..., :cut].copy()),
                        torch.from_numpy(n))
                    key = f"{norm}/{variant}/{s}"
                    out[f"{key}/losses"] = np.array(
                        [float(losses[k]) for k in LOSS_KEYS])
                    for k, v in _flat_params(model).items():
                        out[f"{key}/params/{k}"] = v
                    if s == 0:
                        mu = {n_: state.opt_state.mu[n_]
                              for n_, _ in model.named_parameters()}
                        from eabnet_tpu_torch.weights import to_jax_tree

                        for k, v in flatten_tree(
                                to_jax_tree(model, mu)).items():
                            out[f"{key}/mu/{k}"] = v
                    for k, v in flatten_tree(
                            to_jax_batch_stats(model)).items():
                        out[f"{key}/stats/{k}"] = v
            finally:
                P.global_frames = frames
    # train() of the BN config inside this group: ragged offline data,
    # validation on 7 items sharded over the ranks
    valid = []
    _record_validation(valid)
    hist = train(ExperimentConfig.from_dict(cfg_dict("BN", root)),
                 max_steps=INIT_STEP + 2, device="cpu", tensorboard=False)
    out["train/BN/losses"] = np.array([[h[k] for k in LOSS_KEYS]
                                       for h in hist])
    out["train/BN/epochs"] = np.array([h["epoch"] for h in hist])
    out["train/BN/valid"] = np.array(valid)
    odd = cfg_dict("BN", root)
    odd["train"]["batch_size"] = 3
    try:
        train(ExperimentConfig.from_dict(odd), max_steps=INIT_STEP + 1,
              device="cpu", tensorboard=False)
        out["odd_batch"] = np.array("trained")
    except ValueError as e:
        out["odd_batch"] = np.array(str(e))
    np.savez(os.path.join(root, f"steps_{rank}.npz"), **out)
    dist.destroy_process_group()


def _cli(root: str, argv) -> None:
    from eabnet_tpu_torch.cli.train import main

    _one_thread()
    valid = []
    _record_validation(valid)
    hist = main(argv)
    np.savez(os.path.join(root, f"cli_{os.environ['RANK']}.npz"),
             losses=np.array([[h[k] for k in LOSS_KEYS] for h in hist]),
             epochs=np.array([h["epoch"] for h in hist]),
             valid=np.array(valid))


def _probe_native():
    """A rank's view of the native RIR engine: whether it compiled it."""
    from eabnet_tpu_torch.data import rir_native

    built = []
    build = rir_native._build
    rir_native._build = lambda path: (built.append(str(path)), build(path))
    ok = rir_native.native_available()
    return {"ok": ok, "built": built,
            "mtime": rir_native.library_path().stat().st_mtime_ns}


def _fail_one_rank():
    """Rank 1 raises; rank 0 waits in an all-reduce for it."""
    import torch
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("planted failure of rank 1")
    dist.all_reduce(torch.zeros(1))


def _launch(root: str) -> None:
    from eabnet_tpu_torch.cli.train import train_on_cards
    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.data import rir_native
    from eabnet_tpu_torch.parallel import launch
    from eabnet_tpu_torch.train.trainer import train

    launch.build_once(cuda=False)
    result = {"parent_ok": rir_native.native_available(),
              "parent_mtime": rir_native.library_path().stat().st_mtime_ns,
              "ranks": launch.spawn(_probe_native, WORLD, backend="gloo",
                                    timeout_s=RANK_TIMEOUT_S)}
    t0 = time.perf_counter()
    try:
        launch.spawn(_fail_one_rank, WORLD, backend="gloo",
                     timeout_s=RANK_TIMEOUT_S)
        result["failure"] = None
    except RuntimeError as e:
        result["failure"] = str(e)
    result["failure_s"] = time.perf_counter() - t0
    # cli.train's spawn over cards, and one process, each from a fresh
    # seeded init in a run directory of its own
    _wavs(os.path.join(root, "train"), TRAIN_LENGTHS, 1)
    _wavs(os.path.join(root, "val"), VAL_LENGTHS, 2)
    for kind in ("cards", "one"):
        d = cfg_dict("IN", os.path.join(root))
        run = os.path.join(root, kind)
        d["train"].update(validate_once_before_train=False, exp_root=run,
                          checkpoint_dir=os.path.join(run, "ckpt"))
        cfg = ExperimentConfig.from_dict(d)
        hist = (train_on_cards(cfg, WORLD, 2, device="cpu") if kind == "cards"
                else train(cfg, max_steps=2, device="cpu",
                           tensorboard=False))
        result[f"{kind}_losses"] = [[h[k] for k in LOSS_KEYS] for h in hist]
    with open(os.path.join(root, "launch.json"), "w") as f:
        json.dump(result, f)


# ---------------------------------------------------------------------------
# the tests (JAX imported here only)


def _free_port() -> int:
    from eabnet_tpu_torch.parallel.launch import free_port

    return free_port()


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return env


def _wavs(root: str, lengths, seed: int) -> None:
    from eabnet_tpu_torch.utils.audio_io import write_wav

    rng = np.random.default_rng(seed)
    for sub in ("clean", "noisy"):
        os.makedirs(os.path.join(root, sub))
    for i, n in enumerate(lengths):
        clean = (rng.standard_normal(n) * 0.1).astype(np.float32)
        noisy = (clean[None] * 0.8 + rng.standard_normal((M, n))
                 * 0.05).astype(np.float32)
        write_wav(os.path.join(root, "clean", f"{i:03d}.wav"), 16000, clean,
                  dtype="float")
        write_wav(os.path.join(root, "noisy", f"{i:03d}.wav"), 16000,
                  noisy, dtype="float")


def _stage(root: str) -> dict:
    """Seeded data and the JAX init of both configs, written for the
    ranks; -> {norm: (JAX config, JAX init state)}."""
    import jax
    import jax.numpy as jnp

    from eabnet_tpu.config import ExperimentConfig
    from eabnet_tpu.models import build_model
    from eabnet_tpu.train.step import TrainState, make_optimizer
    from eabnet_tpu_torch.checkpoint import msgpack_serialize

    rng = np.random.default_rng(0)
    clean = (rng.standard_normal((len(LENGTHS), BATCH, N)) * 0.1
             ).astype(np.float32)
    noisy = (clean[:, :, None] * 0.8 + rng.standard_normal(
        (len(LENGTHS), BATCH, M, N)) * 0.05).astype(np.float32)
    for s, lengths in enumerate(LENGTHS):
        for i, n in enumerate(lengths):
            noisy[s, i, :, n:] = 0.0
            clean[s, i, n:] = 0.0
    np.savez(os.path.join(root, "batches.npz"), noisy=noisy, clean=clean)
    _wavs(os.path.join(root, "train"), TRAIN_LENGTHS, 1)
    _wavs(os.path.join(root, "val"), VAL_LENGTHS, 2)
    out = {}
    for norm in NORMS:
        cfg = ExperimentConfig.from_json(json.dumps(cfg_dict(norm, root)))
        model = build_model(cfg.model)
        t = cfg.stft.num_frames(N)
        variables = jax.jit(model.init)(jax.random.key(0), jnp.zeros(
            (1, t, cfg.stft.freq_bins, M, 2)))
        params = jax.tree.map(np.asarray, variables["params"])
        blob = msgpack_serialize({"params": params})
        with open(os.path.join(root, f"init_{norm}.params"), "wb") as f:
            f.write(blob)
        ckpt = os.path.join(root, f"run_{norm}", "ckpt")
        os.makedirs(ckpt)
        with open(os.path.join(ckpt, f"{INIT_STEP}.params"), "wb") as f:
            f.write(blob)
        state = TrainState(step=jnp.array(INIT_STEP, jnp.int32),
                           params=variables["params"],
                           opt_state=make_optimizer(cfg).init(
                               variables["params"]),
                           batch_stats=variables.get("batch_stats", {}))
        out[norm] = (cfg, state)
    return out


def _jax_runs(staged: dict, root: str, train_epoch: int) -> dict:
    """The JAX package's step on make_mesh(("data",), jax.devices()[:2]):
    the ragged batches of the step runs, and the trainer's global batches
    of ``train_epoch`` (its own loader over the same offline set)."""
    import jax

    from eabnet_tpu.data.datasets import BatchLoader, OfflineMcseDataset
    from eabnet_tpu.parallel import data_sharding, make_mesh, replicate
    from eabnet_tpu.train.step import make_train_step
    from eabnet_tpu_torch.weights import flatten_tree

    mesh = make_mesh(("data",), jax.devices()[:WORLD])
    data = np.load(os.path.join(root, "batches.npz"))
    out = {}
    for norm, (cfg, state0) in staged.items():
        step = make_train_step(cfg, donate=False)
        put = lambda x: jax.device_put(x, data_sharding(mesh))  # noqa: E731
        state = jax.device_put(state0, replicate(mesh))
        for s, lengths in enumerate(LENGTHS):
            state, losses = step(state, put(data["noisy"][s]),
                                 put(data["clean"][s]),
                                 put(np.array(lengths, np.int32)))
            out[f"{norm}/{s}/losses"] = np.array(
                [float(losses[k]) for k in LOSS_KEYS])
            out[f"{norm}/{s}/params"] = flatten_tree(
                jax.tree.map(np.asarray, state.params))
            out[f"{norm}/{s}/stats"] = flatten_tree(
                jax.tree.map(np.asarray, state.batch_stats))
            if s == 0:
                out[f"{norm}/0/mu"] = flatten_tree(jax.tree.map(
                    np.asarray, state.opt_state[1][0].mu))
        loader = BatchLoader(OfflineMcseDataset(cfg.data.speech_root),
                             BATCH, shuffle=True, seed=cfg.train.seed,
                             pad_multiple=int(cfg.data.pad_to_seconds
                                              * cfg.stft.sr))
        state, losses = jax.device_put(state0, replicate(mesh)), []
        for noisy, clean, n in list(loader.epoch(train_epoch))[:2]:
            state, l = step(state, put(noisy), put(clean), put(n))
            losses.append([float(l[k]) for k in LOSS_KEYS])
        out[f"train/{norm}/losses"] = np.array(losses)
        out[f"train/{norm}/params"] = flatten_tree(
            jax.tree.map(np.asarray, state.params))
    return out


def _unsharded_valid(staged, root: str, norm: str) -> float:
    """One process's validation loss of the init params: the port's eval
    step over the 7 items, batches of one, as ``validate`` pads them."""
    import torch

    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.data.datasets import BatchLoader, OfflineMcseDataset
    from eabnet_tpu_torch.models import build_model
    from eabnet_tpu_torch.train import step as P
    from eabnet_tpu_torch.weights import load_jax_params

    cfg = ExperimentConfig.from_dict(cfg_dict(norm, root))
    params = jax_params(staged[norm][1])
    model = load_jax_params(build_model(cfg.model), params)
    state = P.TrainState(0, model, None)
    eval_step = P.make_eval_step(cfg)
    loader = BatchLoader(OfflineMcseDataset(cfg.data.val_set), 1,
                         shuffle=False, drop_last=False, pad_multiple=N)
    return float(np.mean([float(eval_step(state, *(
        torch.from_numpy(a) for a in b))[0]["final"])
        for b in loader.epoch(0)]))


def jax_params(state):
    import jax

    return jax.tree.map(np.asarray, state.params)


def _wait(procs, what: str):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"{what}: {log[-3000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both rank pairs, started first, and the JAX references computed
    while they run."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    root = str(tmp_path_factory.mktemp("ddp"))
    try:
        staged = _stage(root)
        me = os.path.abspath(__file__)
        port = _free_port()
        steps = [subprocess.Popen(
            [sys.executable, me, "steps", str(r), str(WORLD), str(port),
             root], cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
        with open(os.path.join(root, "in.json"), "w") as f:
            json.dump(cfg_dict("IN", root), f)
        cli_port = _free_port()
        cli = [subprocess.Popen(
            [sys.executable, me, "cli", root, "--config",
             os.path.join(root, "in.json"), "--multihost", "--device", "cpu",
             "--max-steps", str(INIT_STEP + 2)], cwd=ROOT,
            env=dict(_env(), RANK=str(r), LOCAL_RANK=str(r),
                     WORLD_SIZE=str(WORLD), MASTER_ADDR="localhost",
                     MASTER_PORT=str(cli_port)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]
        # the port's trainer resumes a .params file at epoch 0 and trains
        # from epoch 1 on
        jax_out = _jax_runs(staged, root, train_epoch=1)
        valid = {norm: _unsharded_valid(staged, root, norm)
                 for norm in NORMS}
        _wait(steps, "steps ranks")
        _wait(cli, "cli.train --multihost ranks")
        ranks = [dict(np.load(os.path.join(root, f"steps_{r}.npz")))
                 for r in range(WORLD)]
        for r in range(WORLD):
            ranks[r].update({f"train/IN/{k}": v for k, v in np.load(
                os.path.join(root, f"cli_{r}.npz")).items()})
        yield dict(root=root, jax=jax_out, ranks=ranks, valid=valid,
                   staged=staged)
    finally:
        torch.set_num_threads(n)


def _group(d: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def _close(got: dict, want: dict, atol: float, rtol: float) -> list:
    """Names of the leaves of ``got`` outside the tolerance of ``want``."""
    assert got.keys() == want.keys() and got
    return [k for k, v in want.items()
            if not np.allclose(got[k], v, atol=atol, rtol=rtol)]


def _check_params(got: dict, want: dict, what: str, max_outside: int,
                  max_worst_lr: float) -> None:
    """Parameters at JAX's multi-device tolerance but for at most
    ``max_outside`` elements, and every element within ``max_worst_lr``
    lr: Adam moves an element by ~lr whatever its gradient's size, so
    where the gradient is float32 noise the two packages may move it in
    opposite directions. The limits keep room over the readings
    (STEP_OUTSIDE, TRAIN_OUTSIDE)."""
    assert got.keys() == want.keys() and got
    outside = sum(int((~np.isclose(got[k], want[k], atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)).sum()) for k in got)
    worst = max(float(np.abs(got[k] - want[k]).max()) for k in got)
    assert outside <= max_outside, (what, outside)
    assert worst <= max_worst_lr * LR, (what, worst / LR)


@pytest.mark.parametrize("norm", NORMS)
def test_train_step_matches_the_jax_mesh(runs, norm):
    """Two ranks of ragged rows against the JAX step over the global batch:
    the losses of both steps (global, the same on both ranks) within 1e-5
    relative; the gradients of step 1 (Adam's first moment / (1 - b1),
    after clipping) at JAX's multi-device tolerance; the parameters after
    each step and, for BN, the running statistics."""
    jx, ranks = runs["jax"], runs["ranks"]
    for s in range(len(LENGTHS)):
        want = jx[f"{norm}/{s}/losses"]
        for r in range(WORLD):
            key = f"{norm}/ddp/{s}"
            np.testing.assert_allclose(ranks[r][f"{key}/losses"], want,
                                       rtol=LOSS_RTOL, err_msg=f"{key} {r}")
            params = _group(ranks[r], f"{key}/params/")
            _check_params(params, jx[f"{norm}/{s}/params"], f"{key} {r}",
                          STEP_OUTSIDE, STEP_WORST_LR)
            if norm == "BN":
                assert not _close(_group(ranks[r], f"{key}/stats/"),
                                  jx[f"{norm}/{s}/stats"], 1e-6, 1e-5)
    mu = _group(ranks[0], f"{norm}/ddp/0/mu/")
    grads = {k: v / 0.1 for k, v in mu.items()}
    want = {k: v / 0.1 for k, v in jx[f"{norm}/0/mu"].items()}
    bad = _close(grads, want, GRAD_ATOL, GRAD_RTOL)
    assert not bad, bad


@pytest.mark.parametrize("norm", NORMS)
def test_ranks_hold_the_same_parameters(runs, norm):
    r0, r1 = runs["ranks"]
    for s in range(len(LENGTHS)):
        a = _group(r0, f"{norm}/ddp/{s}/params/")
        b = _group(r1, f"{norm}/ddp/{s}/params/")
        assert a.keys() == b.keys() and a
        assert all(a[k].tobytes() == b[k].tobytes() for k in a), s


@pytest.mark.parametrize("norm", NORMS)
def test_a_mean_of_rank_means_fails_the_check(runs, norm):
    """Each rank normalising by its own frames (DDP's mean of the ranks'
    means) misses JAX's step-1 loss by more than ten times the
    tolerance."""
    got = runs["ranks"][0][f"{norm}/rank_mean/0/losses"]
    want = runs["jax"][f"{norm}/0/losses"]
    assert np.abs(got - want).max() / np.abs(want).max() > 10 * LOSS_RTOL


@pytest.mark.parametrize("norm", NORMS)
def test_train_in_a_group_matches_the_jax_mesh(runs, norm):
    """train() in two gloo ranks (IN through ``cli.train --multihost``, BN
    called in the group): its losses, the same on both ranks, against the
    JAX step on the JAX loader's global batches of the same epoch; the
    chief's checkpoint against JAX's parameters; the validation loss,
    sharded over the ranks, against one process's."""
    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.train.checkpoint import load_checkpoint
    from eabnet_tpu_torch.train.step import create_train_state
    from eabnet_tpu_torch.weights import flatten_tree, to_jax_tree

    root, jx = runs["root"], runs["jax"]
    r0, r1 = runs["ranks"]
    assert list(r0[f"train/{norm}/epochs"]) == [1, 1]
    np.testing.assert_array_equal(r0[f"train/{norm}/losses"],
                                  r1[f"train/{norm}/losses"])
    np.testing.assert_allclose(r0[f"train/{norm}/losses"],
                               jx[f"train/{norm}/losses"], rtol=LOSS_RTOL)
    cfg = ExperimentConfig.from_dict(cfg_dict(norm, root))
    state, _ = load_checkpoint(
        os.path.join(cfg.train.checkpoint_dir, f"{INIT_STEP + 2}.ckpt"),
        create_train_state(cfg, "cpu"), cfg)
    assert state.step == INIT_STEP + 2
    params = flatten_tree(to_jax_tree(state.model,
                                      dict(state.model.named_parameters())))
    want = jx[f"train/{norm}/params"]
    _check_params(params, want, f"train {norm}", TRAIN_OUTSIDE,
                  TRAIN_WORST_LR)
    for r in (r0, r1):
        np.testing.assert_allclose(r[f"train/{norm}/valid"],
                                   [runs["valid"][norm]], rtol=1e-6)


def test_a_world_that_does_not_divide_the_batch_is_refused(runs):
    for r in runs["ranks"]:
        msg = str(r["odd_batch"])
        assert "batch_size 3" in msg and "2 ranks" in msg, msg


def test_spawned_ranks_reuse_the_native_engine_and_a_failed_rank_ends_the_run(
        tmp_path):
    """``spawn`` after ``build_once``: both ranks load the engine the parent
    built (no compile, the same file); a rank that raises while the other
    waits in an all-reduce ends the run at once with its traceback;
    ``cli.train``'s spawn over two ranks gives one process's losses
    (within 1e-5 relative)."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "launch", str(tmp_path)],
        cwd=ROOT, env=dict(_env(), OMP_NUM_THREADS="1"),
        capture_output=True, text=True,
        timeout=RANK_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(tmp_path / "launch.json") as f:
        res = json.load(f)
    assert res["parent_ok"]
    assert [r["ok"] for r in res["ranks"]] == [True] * WORLD
    assert [r["built"] for r in res["ranks"]] == [[]] * WORLD
    assert {r["mtime"] for r in res["ranks"]} == {res["parent_mtime"]}
    assert res["failure"] and "planted failure of rank 1" in res["failure"]
    assert res["failure_s"] < 60
    assert len(res["cards_losses"]) == len(res["one_losses"]) == 2
    np.testing.assert_allclose(res["cards_losses"], res["one_losses"],
                               rtol=LOSS_RTOL)


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "steps":
        _steps(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
               sys.argv[5])
    elif mode == "cli":
        _cli(sys.argv[2], sys.argv[3:])
    elif mode == "launch":
        _launch(sys.argv[2])
    else:
        raise SystemExit(f"unknown mode {mode!r}")
