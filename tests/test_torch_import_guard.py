"""The port stands alone: no module of eabnet_tpu_torch, and not
chip_smoke.py, imports JAX, flax, optax, msgpack or the JAX package."""

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
            "eabnet_tpu_torch.utils.quantize"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_names_a_forbidden_module():
    for path in SOURCES:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "attr", getattr(
                      node.func, "id", "")) in ("import_module",
                                                "__import__")
                  and node.args and isinstance(node.args[0], ast.Constant)):
                names = [node.args[0].value]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)


def test_no_pytorch_cpp_extension():
    """Kernels build through nvcc + ctypes, never cpp_extension."""
    for path in SOURCES:
        with open(path) as f:
            assert "cpp_extension" not in f.read(), path
