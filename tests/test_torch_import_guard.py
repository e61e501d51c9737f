"""The port stands alone: no module of eabnet_tpu_torch, and not
chip_smoke.py, imports JAX, flax, optax, msgpack or the JAX package, in
the parent process or in a spawned worker of the data loader. PIL (absent
on the card's machine) is imported only inside
``data/l3das.py::load_image``, never when a module is imported."""

import ast
import os
import pkgutil
import subprocess
import sys

import eabnet_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "eabnet_tpu")
SOURCES = [os.path.join(ROOT, "chip_smoke.py")] + [
    os.path.join(d, f) for d, _, files in
    os.walk(os.path.join(ROOT, "eabnet_tpu_torch")) for f in files
    if f.endswith(".py")]


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        eabnet_tpu_torch.__path__, "eabnet_tpu_torch."))


def test_importing_the_port_loads_no_jax():
    mods = ["eabnet_tpu_torch"] + port_modules()
    assert {"eabnet_tpu_torch.inference", "eabnet_tpu_torch.losses",
            "eabnet_tpu_torch.train.step", "eabnet_tpu_torch.train.trainer",
            "eabnet_tpu_torch.train.checkpoint",
            "eabnet_tpu_torch.train.loggers", "eabnet_tpu_torch.cli.train",
            "eabnet_tpu_torch.data.datasets", "eabnet_tpu_torch.streaming",
            "eabnet_tpu_torch.nn.lstm", "eabnet_tpu_torch.cli.stream",
            "eabnet_tpu_torch.nn.stepping",
            "eabnet_tpu_torch.utils.quantize", "eabnet_tpu_torch.eval",
            "eabnet_tpu_torch.eval.harness", "eabnet_tpu_torch.eval.p862",
            "eabnet_tpu_torch.eval.pesq", "eabnet_tpu_torch.eval.stoi",
            "eabnet_tpu_torch.cli.common", "eabnet_tpu_torch.cli.test",
            "eabnet_tpu_torch.cli.score",
            "eabnet_tpu_torch.utils.convert_torch",
            "eabnet_tpu_torch.utils.convert_args",
            "eabnet_tpu_torch.data.rir", "eabnet_tpu_torch.data.rir_native",
            "eabnet_tpu_torch.data.scenes", "eabnet_tpu_torch.data.mixer",
            "eabnet_tpu_torch.data.synth_speech",
            "eabnet_tpu_torch.data.device_mix",
            "eabnet_tpu_torch.data.scene_mix", "eabnet_tpu_torch.cli.split",
            "eabnet_tpu_torch.cli.datagen",
            "eabnet_tpu_torch.cli.resample", "eabnet_tpu_torch.parallel",
            "eabnet_tpu_torch.parallel.mesh",
            "eabnet_tpu_torch.parallel.launch",
            "eabnet_tpu_torch.parallel.freq",
            "eabnet_tpu_torch.data.l3das",
            "eabnet_tpu_torch.tools.e2e_demo",
            "eabnet_tpu_torch.tools.long_train",
            "eabnet_tpu_torch.tools.release_report",
            "eabnet_tpu_torch.tools.export_params",
            "eabnet_tpu_torch.tools.demo",
            "eabnet_tpu_torch.tools.tail_sensitivity"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('PIL',)!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


WORKER_CODE = """
import os, sys
import numpy as np
from eabnet_tpu_torch.config import DataConfig
from eabnet_tpu_torch.data import datasets as PD
from eabnet_tpu_torch.utils.audio_io import write_wav


def main(root):
    rng = np.random.default_rng(0)
    for name in ("sp0.wav", "sp1.wav", "no0.wav"):
        write_wav(os.path.join(root, name), 16000,
                  rng.standard_normal(16000) * 0.1)
    for name, text in (("sp", "sp0.wav\\nsp1.wav"), ("no", "no0.wav")):
        with open(os.path.join(root, name), "w") as f:
            f.write(text)
    ds = PD.OnlineMcseDataset(DataConfig(
        speech_root=root, noise_root=root, mcse_settings="v2",
        speech_list=os.path.join(root, "sp"),
        noise_list=os.path.join(root, "no"), clip_seconds=0.5,
        rir_backend="auto"))
    loader = PD.BatchLoader(ds, 1, num_workers=1)
    try:
        pool, args = loader._pool, ds.item_args(0)
        pool.submit(PD._worker_synthesize, args).result()
        pool.submit(PD._worker_synthesize_parts, args).result()
        pool.submit(PD._worker_synthesize_scene,
                    dict(args, speech_index=0)).result()
        mods = pool.submit(eval, "sorted(__import__('sys').modules)").result()
    finally:
        loader.close()
    print(sorted(m for m in mods if m.split(".")[0] in FORBIDDEN))
    sys.exit(0 if "eabnet_tpu_torch.data.scene_mix" in mods and not [
        m for m in mods if m.split(".")[0] in FORBIDDEN] else 1)


if __name__ == "__main__":
    main(sys.argv[1])
"""


def test_a_loader_worker_loads_no_jax(tmp_path):
    """A spawned worker of the port's loader, after a job of each of its
    three worker functions, holds no JAX and no JAX package module."""
    code = f"FORBIDDEN = {FORBIDDEN!r}\n" + WORKER_CODE
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def imported_names(path):
    """Every module name a source imports, at any depth, by statement or
    by ``import_module``/``__import__`` of a constant."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(
                  node.func, "id", "")) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_no_source_names_a_forbidden_module():
    for path in SOURCES:
        for n in imported_names(path):
            assert n.split(".")[0] not in FORBIDDEN, (path, n)


def test_no_source_imports_the_repos_jax_tools():
    """The port keeps its own copies of the repo's ``tools/`` and
    ``examples/`` scripts (``eabnet_tpu_torch/tools/``), which import the
    JAX package; no port source imports them."""
    for path in SOURCES:
        for n in imported_names(path):
            assert n.split(".")[0] not in ("tools", "examples"), (path, n)


def test_only_load_image_imports_pil():
    """No source imports PIL at module level or in another function; the
    one import sits in ``data/l3das.py::load_image``."""
    found = []
    for path in SOURCES:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        owner = {}  # node -> its innermost function (walk is outer first)
        for fn in ast.walk(tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                owner.update((node, fn.name) for node in ast.walk(fn))
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            if any(n.split(".")[0] == "PIL" for n in names):
                found.append((os.path.relpath(path, ROOT), owner.get(node)))
    assert found == [(os.path.join("eabnet_tpu_torch", "data", "l3das.py"),
                      "load_image")]


def test_no_pytorch_cpp_extension():
    """Kernels build through nvcc + ctypes, never cpp_extension."""
    for path in SOURCES:
        with open(path) as f:
            assert "cpp_extension" not in f.read(), path


RANK_CODE = """
import sys

from eabnet_tpu_torch.parallel.launch import spawn

PROBE = ("(__import__('eabnet_tpu_torch.train.trainer'), "
         "__import__('eabnet_tpu_torch.cli.train'), "
         "__import__('eabnet_tpu_torch.inference'), "
         "sorted(__import__('sys').modules))[-1]")

if __name__ == "__main__":
    mods = spawn(eval, 2, (PROBE,), backend="gloo", timeout_s=240)
    bad = sorted({m for ms in mods for m in ms
                  if m.split(".")[0] in FORBIDDEN})
    print(bad)
    sys.exit(0 if not bad and all("eabnet_tpu_torch.train.trainer" in ms
                                  for ms in mods) else 1)
"""


def test_a_spawned_rank_loads_no_jax(tmp_path):
    """Two ranks started by ``parallel.launch.spawn``, after importing the
    trainer, the training CLI and the Enhancer, hold no JAX and no JAX
    package module."""
    script = tmp_path / "ranks.py"
    script.write_text(f"FORBIDDEN = {FORBIDDEN!r}\n" + RANK_CODE)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, str(script)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
