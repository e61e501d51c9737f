"""Frequency-axis model parallelism (``Enhancer(shard_freq=True)``) in
gloo ranks on the CPU, against the JAX package's ``Enhancer(mesh=...,
shard_freq=True)`` on the virtual 8-device CPU mesh and against the port's
one-process Enhancer.

One ``parallel.launch.spawn`` of gloo ranks per mesh shape (1x2, 1x3 and
2x2), each rank running every check of its mesh in one pass, while the
test process computes the JAX references (the ranks import no JAX: JAX is
imported inside the test functions only). Four small configs cover the
Enhancer's forms: JAX's tiny cLN config (tests/test_inference_mesh.py),
the same with IN, a plain-UNet cLN-ref config with the miso topology, and
a U²Net IN config with the cnn head; every weight seeded (1-D leaves
moved off their init). 1x3 splits 161 bins as 54 + 54 + 53 and
replicates widths 9 and 4; 2x2 pads 3 items to 4. The tolerance is the
JAX test's (tests/test_inference_mesh.py: 2e-5). The random models are
drawn with PyTorch's default kernel initialiser (tests/_kaiming_init.py),
as these tests were written; the cases ``in`` and ``cnn`` drawn with the
port's own initialisers, the JAX package's, whose outputs are larger, are
held against the one-process Enhancer run in float64 at 2e-5 times
max(1, max |output|) (tests/_float64_port.py).
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from _float64_port import enhance64, scaled_error
from _kaiming_init import kaiming_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-5  # tests/test_inference_mesh.py:103
MESHES = {"1x2": ((1, -1), 2), "1x3": ((1, -1), 3), "2x2": ((2, -1), 4)}
CASES = {
    "cln": dict(norm="cLN"),
    "in": dict(norm="IN"),
    "unet": dict(norm="cLN-ref", is_u2=False, topo_type="miso"),
    "cnn": dict(norm="IN", bf_type="cnn"),
}
LOWP = ("bfloat16", "int8w")  # at 1x2, cases cln and in
LOWP_MODEL_DB = 6.0  # PERF.md §2: a model at R - 6
# (global width in, frequency kernel, transposed) of every conv along F
CONV_WIDTHS = ((161, 5, False), (79, 3, False), (39, 3, False),
               (19, 3, False), (9, 3, False), (4, 3, True), (9, 3, True),
               (19, 3, True), (39, 3, True), (79, 5, True))
RANK_TIMEOUT_S = 300
SCALE_CASES = ("in", "cnn")  # also drawn with the port's initialisers


def cfg_dict(case: str) -> dict:
    c = CASES[case]
    net = dict(M=3, c=16, embed_dim=16, cd1=16, p=2, q=1,
               norm_type=c["norm"], is_u2=c.get("is_u2", True),
               bf_type=c.get("bf_type", "lstm"),
               topo_type=c.get("topo_type", "mimo"))
    post = dict(c=12, cd1=12, p=1, q=1, dilas=[1, 2], norm_type=c["norm"],
                is_u2=c.get("is_u2", True))
    return {"model": {"eabnet": net, "gagnet": post}}


def port_cfg(case: str):
    from eabnet_tpu_torch.config import ExperimentConfig

    return ExperimentConfig.from_dict(cfg_dict(case))


def params(case: str, init: str = "kaiming") -> dict:
    """The case's flax param tree (numpy): the model drawn under a fixed
    seed (``kaiming_model``, or with ``init="jax"`` the port's own
    initialisers, the JAX package's), its 1-D leaves (biases, norm scales,
    PReLU slopes) moved by seeded noise."""
    import torch

    from eabnet_tpu_torch.models import build_model
    from eabnet_tpu_torch.weights import to_jax_params

    torch.manual_seed(17)
    model = (kaiming_model if init == "kaiming" else build_model)(
        port_cfg(case).model)
    rng = np.random.default_rng(17)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(torch.from_numpy(rng.standard_normal(
                    tuple(p.shape)).astype(np.float32) * 0.1))
    return to_jax_params(model)


def wavs(mesh: str):
    """One utterance on a 1 x N mesh (the latency path), three ragged
    items on 2x2 (padded to a multiple of the data axis)."""
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((3, 9600)) * 0.05).astype(np.float32)
    if MESHES[mesh][0][0] == 1:
        return [w]
    return [w, w[:, :8000] * 0.5, np.ascontiguousarray(w[::-1, :6500])]


# ---------------------------------------------------------------------------
# rank processes (no JAX)


def _conv_errors(mesh) -> dict:
    """Each Conv2d / ConvTranspose2d at every width, sharded (the rank's
    columns in, the halo exchanged, the output gathered) against the
    unsharded module on the same seeded input."""
    import torch

    from eabnet_tpu_torch.nn.blocks import Conv2d, ConvTranspose2d
    from eabnet_tpu_torch.parallel import freq
    from eabnet_tpu_torch.parallel.mesh import axis_group

    index, peers, group = axis_group(mesh, "freq")
    sh = freq.FreqShard(group, index, len(peers), peers, 161)
    out = {}
    for w, k, transposed in CONV_WIDTHS:
        torch.manual_seed(w + k)
        conv = (ConvTranspose2d if transposed else Conv2d)(4, 6, (2, k),
                                                           (1, 2))
        x = torch.from_numpy(np.random.default_rng(w).standard_normal(
            (2, 4, 5, w)).astype(np.float32))
        with torch.no_grad():
            ref = conv(x)
            sh.width = w
            with freq.sharding(sh):
                y = conv(sh.own(x))
            y = sh.whole(y)
        out[f"{'deconv' if transposed else 'conv'} {w}"] = float(
            (y - ref).abs().max()) if y.shape == ref.shape else np.inf
    return out


def _rank(mesh_name: str, trees: dict) -> dict:
    import torch

    from eabnet_tpu_torch.inference import Enhancer
    from eabnet_tpu_torch.parallel import freq, make_mesh

    torch.set_num_threads(1)
    sizes, n = MESHES[mesh_name]
    mesh = make_mesh(("data", "freq"), ["cpu"] * n, sizes)
    x = wavs(mesh_name)
    res = {"conv": _conv_errors(mesh), "out": {}, "counts": {}}
    for case in CASES:
        enh = Enhancer(port_cfg(case), trees[case], mesh=mesh,
                       shard_freq=True, device="cpu")
        for stage in ("esti", "esti0"):
            enh.output = stage
            freq.zero_counts()
            res["out"][f"{case} {stage}"] = enh.enhance_batch(x)
            if stage == "esti":
                res["counts"][case] = {k: dict(v)
                                       for k, v in freq.counts.items()}
    for case in SCALE_CASES:
        key = f"{case} jax-init"
        res["out"][key] = Enhancer(port_cfg(case), trees[key], mesh=mesh,
                                   shard_freq=True,
                                   device="cpu").enhance_batch(x)
    if mesh_name == "1x2":
        for case in ("cln", "in"):
            for dtype in LOWP:
                enh = Enhancer(port_cfg(case), trees[case], mesh=mesh,
                               shard_freq=True, compute_dtype=dtype,
                               device="cpu")
                res["out"][f"{case} {dtype}"] = enh.enhance_batch(x)
            # the planted fault: each rank's norms take the statistics of
            # its own bins, not of every rank's
            split_map = freq.FreqShard.split_map
            freq.FreqShard.split_map = lambda self, m: False
            try:
                enh = Enhancer(port_cfg(case), trees[case], mesh=mesh,
                               shard_freq=True, device="cpu")
                res["out"][f"{case} fault"] = enh.enhance_batch(x)
            finally:
                freq.FreqShard.split_map = split_map
    return res


def _spawn_all(trees: dict, out: dict) -> None:
    from eabnet_tpu_torch.parallel import launch

    try:
        for name, (_, n) in MESHES.items():
            out[name] = launch.spawn(_rank, n, (name, trees),
                                     backend="gloo",
                                     timeout_s=RANK_TIMEOUT_S)
    except BaseException as e:  # reported by the fixture
        out["error"] = e


def _cli(exp: str, root: str, out: dict) -> None:
    """cli.enhance on one wav in one process and with --shard-freq on two
    gloo ranks."""
    try:
        for tag, extra in (("one", []), ("sharded", ["--shard-freq",
                                                     "--ranks", "2"])):
            p = subprocess.run(
                [sys.executable, "-m", "eabnet_tpu_torch.cli.enhance",
                 os.path.join(root, "in.wav"),
                 os.path.join(root, f"{tag}.wav"), "--exp-root", exp,
                 "--device", "cpu", *extra], cwd=ROOT, capture_output=True,
                text=True, timeout=RANK_TIMEOUT_S,
                env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"))
            out[tag] = (p.returncode, p.stdout[-2000:] + p.stderr[-3000:])
    except BaseException as e:
        out["error"] = e


# ---------------------------------------------------------------------------
# the tests (JAX imported here only)


def _jax_outputs(trees: dict) -> dict:
    """The JAX package's sharded Enhancer on every (mesh, case): esti, and
    esti0 for cLN at 1x3; compiled three at a time (XLA's compiler runs
    outside the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    import jax

    from eabnet_tpu.config import ExperimentConfig as JaxCfg
    from eabnet_tpu.inference import Enhancer
    from eabnet_tpu.parallel import make_mesh

    def run(job):
        name, case, stage = job
        sizes, n = MESHES[name]
        mesh = make_mesh(("data", "freq"), devices=jax.devices()[:n],
                         sizes=sizes)
        enh = Enhancer(JaxCfg.from_dict(cfg_dict(case)), trees[case],
                       output=stage, mesh=mesh, shard_freq=True)
        return enh.enhance_batch(wavs(name))

    jobs = [(name, case, "esti") for name in MESHES for case in CASES]
    jobs.append(("1x3", "cln", "esti0"))
    with ThreadPoolExecutor(3) as pool:
        return dict(zip(jobs, pool.map(run, jobs)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's ranks and the two CLI runs, started first, and the JAX
    references and the port's one-process outputs computed while they
    run."""
    import torch

    from eabnet_tpu_torch.checkpoint import msgpack_serialize
    from eabnet_tpu_torch.inference import Enhancer
    from eabnet_tpu_torch.utils.audio_io import write_wav

    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = str(tmp_path_factory.mktemp("freq_shard"))
    try:
        trees = {case: params(case) for case in CASES}
        trees.update({f"{case} jax-init": params(case, "jax")
                      for case in SCALE_CASES})
        exp = os.path.join(root, "exp")
        os.makedirs(exp)
        port_cfg("cln").save(os.path.join(exp, "config.json"))
        with open(os.path.join(exp, "1.params"), "wb") as f:
            f.write(msgpack_serialize({"params": trees["cln"]}))
        write_wav(os.path.join(root, "in.wav"), 16000, wavs("1x2")[0],
                  dtype="float")
        ranks, cli = {}, {}
        threads = [threading.Thread(target=_spawn_all, args=(trees, ranks)),
                   threading.Thread(target=_cli, args=(exp, root, cli))]
        for t in threads:
            t.start()
        try:
            jax_out = _jax_outputs(trees)
            one = {}
            for case in CASES:
                for mode in ("float32",) + LOWP:
                    enh = Enhancer(port_cfg(case), trees[case],
                                   compute_dtype=mode, device="cpu")
                    for name in MESHES:
                        for stage in ("esti", "esti0"):
                            enh.output = stage
                            one[name, case, stage, mode] = \
                                enh.enhance_batch(wavs(name))
            ref64 = {(name, case): enhance64(
                port_cfg(case), trees[f"{case} jax-init"], wavs(name))
                for name in MESHES for case in SCALE_CASES}
        finally:
            for t in threads:
                t.join(timeout=2 * RANK_TIMEOUT_S)
        if any(t.is_alive() for t in threads):
            raise TimeoutError("the ranks or the CLI runs did not end")
        for d in (ranks, cli):
            if "error" in d:
                raise d["error"]
        yield dict(ranks=ranks, jax=jax_out, one=one, cli=cli, root=root,
                   trees=trees, ref64=ref64)
    finally:
        torch.set_num_threads(n_threads)


def max_err(got, want) -> float:
    assert len(got) == len(want)
    assert all(g.shape == w.shape for g, w in zip(got, want))
    return max(float(np.abs(g - w).max()) for g, w in zip(got, want))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_matches_the_jax_mesh(runs, mesh, case):
    """Every rank returns the whole output, within 2e-5 of the JAX
    package's sharded Enhancer on the same mesh shape (esti; esti0 too
    for cLN at 1x3)."""
    for r, rank in enumerate(runs["ranks"][mesh]):
        for (name, c, stage), want in runs["jax"].items():
            if (name, c) == (mesh, case):
                err = max_err(rank["out"][f"{case} {stage}"], want)
                assert err <= ATOL, (mesh, case, stage, r, err)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_matches_one_process(runs, mesh, case):
    """Both stages within 2e-5 of the port's one-process Enhancer, and the
    ranks' outputs the same bits."""
    ranks = runs["ranks"][mesh]
    for stage in ("esti", "esti0"):
        key = f"{case} {stage}"
        err = max_err(ranks[0]["out"][key],
                      runs["one"][mesh, case, stage, "float32"])
        assert err <= ATOL, (mesh, case, stage, err)
        assert all(max_err(r["out"][key], ranks[0]["out"][key]) == 0
                   for r in ranks[1:])


@pytest.mark.parametrize("case", SCALE_CASES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_at_the_jax_init_scale(runs, mesh, case):
    """The model drawn with the port's initialisers (the JAX package's):
    every rank's sharded esti within the JAX test's 2e-5 times max(1, max
    |output|) of the one-process Enhancer run in float64."""
    ref = runs["ref64"][mesh, case]
    for r, rank in enumerate(runs["ranks"][mesh]):
        err, limit = scaled_error(rank["out"][f"{case} jax-init"], ref)
        assert err <= limit, (mesh, case, r, err, limit)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_convs_at_every_width(runs, mesh):
    """Each sharded Conv2d and ConvTranspose2d against the unsharded one,
    161 -> 79 -> 39 -> 19 -> 9 -> 4 and back, on every rank."""
    for rank in runs["ranks"][mesh]:
        assert len(rank["conv"]) == len(CONV_WIDTHS)
        bad = {k: v for k, v in rank["conv"].items() if not v <= 1e-5}
        assert not bad, bad


@pytest.mark.parametrize("mesh", list(MESHES))
def test_collectives_are_counted_by_kind(runs, mesh):
    """Halos, norm sums, gathers and the row-parallel sums of the
    post-filter's two gated inputs are issued and counted; the U²Net
    exchanges more halos than the plain UNet, and IN sums twice per norm
    where cLN sums once."""
    counts = runs["ranks"][mesh][0]["counts"]
    for case, c in counts.items():
        assert all(c[k]["calls"] > 0 and c[k]["bytes"] > 0
                   for k in ("halo", "norm", "gather", "row")), (case, c)
        assert c["row"]["calls"] == 2  # glance and gaze of one stage
    assert counts["cln"]["halo"]["calls"] > counts["unet"]["halo"]["calls"]
    assert counts["in"]["norm"]["calls"] == 2 * counts["cln"]["norm"]["calls"]


def snr_db(ref, est) -> float:
    """inf where the two are the same bits."""
    ref, est = np.concatenate(ref), np.concatenate(est)
    with np.errstate(divide="ignore"):
        return float(10 * np.log10(np.sum(ref ** 2)
                                   / np.sum((ref - est) ** 2)))


@pytest.mark.parametrize("dtype", LOWP)
@pytest.mark.parametrize("case", ["cln", "in"])
def test_low_precision_by_the_model_rule(runs, case, dtype):
    """bf16 and int8w at 1x2 against the port's one-process output of the
    same mode at R - 6 dB, R the SNR of that output against float32
    (PERF.md §2's model rule)."""
    one = runs["one"]
    ref32 = one["1x2", case, "esti", "float32"]
    ref = one["1x2", case, "esti", dtype]
    r = snr_db(ref32, ref)
    for rank in runs["ranks"]["1x2"]:
        got = snr_db(ref, rank["out"][f"{case} {dtype}"])
        assert got >= r - LOWP_MODEL_DB, (case, dtype, got, r)


@pytest.mark.parametrize("case", ["cln", "in"])
def test_norm_sums_per_rank_fail_the_check(runs, case):
    """The planted fault: each rank's norms over its own bins, not over
    every rank's, is caught by the 2e-5 check against the JAX mesh."""
    want = runs["jax"]["1x2", case, "esti"]
    for rank in runs["ranks"]["1x2"]:
        assert max_err(rank["out"][f"{case} fault"], want) > 10 * ATOL


def test_value_errors_as_in_jax():
    """shard_freq without a 'freq' axis, or with a mesh whose size is not
    the group's, is a ValueError naming 'freq'; cli.enhance refuses
    --mesh with --shard-freq, as the JAX CLI does."""
    from eabnet_tpu_torch.cli.enhance import main
    from eabnet_tpu_torch.inference import Enhancer
    from eabnet_tpu_torch.parallel import make_mesh

    cfg = port_cfg("cln")
    for mesh in (None, make_mesh(devices=["cpu"]),
                 make_mesh(("data", "freq"), ["cpu"] * 2, (1, -1))):
        with pytest.raises(ValueError, match="freq"):
            Enhancer(cfg, {}, mesh=mesh, shard_freq=True, device="cpu")
    with pytest.raises(SystemExit, match="exclusive"):
        main(["in.wav", "out.wav", "--exp-root", ".", "--mesh",
              "--shard-freq", "--device", "cpu"])


def test_a_mesh_of_one_rank_serves_as_one_process(runs):
    """A 1x1 ('data', 'freq') mesh in one process (no group) runs the
    sharded code path at freq extent 1: the one-process output."""
    from eabnet_tpu_torch.inference import Enhancer
    from eabnet_tpu_torch.parallel import make_mesh

    enh = Enhancer(port_cfg("in"), runs["trees"]["in"],
                   mesh=make_mesh(("data", "freq"), ["cpu"], (1, -1)),
                   shard_freq=True, device="cpu")
    assert max_err(enh.enhance_batch(wavs("1x2")),
                   runs["one"]["1x2", "in", "esti", "float32"]) <= ATOL


def test_cli_shard_freq_writes_the_one_process_wav(runs):
    """cli.enhance --shard-freq --device cpu on two gloo ranks writes the
    wav that cli.enhance writes in one process."""
    from eabnet_tpu_torch.utils.audio_io import read_wav

    for tag in ("one", "sharded"):
        rc, log = runs["cli"][tag]
        assert rc == 0, f"{tag}: {log}"
    _, one = read_wav(os.path.join(runs["root"], "one.wav"))
    _, sharded = read_wav(os.path.join(runs["root"], "sharded.wav"))
    assert one.shape == sharded.shape == (9600,)
    assert float(np.abs(one - sharded).max()) <= ATOL


def test_a_freq_mesh_axis_trains_as_the_data_axis(tmp_path):
    """train.mesh_axes=("data", "freq") trains as ("data",) does, as in the
    JAX trainer (the freq axis has extent 1 there): one step, the same
    loss bits."""
    import torch

    from eabnet_tpu_torch.config import (ComposedConfig, DataConfig,
                                         EaBNetConfig, ExperimentConfig,
                                         GaGNetConfig, TrainConfig)
    from eabnet_tpu_torch.train.trainer import train

    losses = []
    for axes in (("data",), ("data", "freq")):
        run = tmp_path / "_".join(axes)
        cfg = ExperimentConfig(
            model=ComposedConfig(
                eabnet=EaBNetConfig(c=8, M=3, embed_dim=8, cd1=8, p=2, q=1),
                gagnet=GaGNetConfig(c=8, cd1=8, p=1, q=1, dilas=(1, 2))),
            data=DataConfig(dataset="fake", clip_seconds=0.1, num_workers=0,
                            pad_to_seconds=0.1),
            train=TrainConfig(batch_size=2, wav_len=0.1, log_every=1,
                              fixed_seed=True, mesh_axes=axes,
                              checkpoint_dir=str(run / "ckpt"),
                              exp_root=str(run)))
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            hist = train(cfg, max_steps=1, device="cpu", tensorboard=False)
        finally:
            torch.set_num_threads(n)
        losses.append([h[k] for h in hist
                       for k in ("eabnet", "postnet", "final")])
    assert np.array(losses[0]).tobytes() == np.array(losses[1]).tobytes()
    assert np.isfinite(losses[0]).all()
