"""Where the serving tests' errors come from at the JAX package's init
scale: float32 rounding that grows with the output, or precision that the
sharded paths lose.

For the random models of tests/test_torch_freq_shard.py (cases ``in`` and
``cnn`` on the 1x2, 1x3 and 2x2 meshes) and of
tests/test_torch_parallel.py's mesh test (IN), drawn the way those tests
draw them but with today's initialisers, it prints the largest |output|
and the error of each float32 path against a float64 run of the port's
one-process path on the CPU:

- ``jax``: the JAX package's Enhancer on the same mesh shape (the freq
  cases: sharded; the mesh case: one process);
- ``one``: the port's one-process Enhancer;
- ``sharded``: the port's sharded Enhancer (gloo ranks on the CPU) or its
  two replicas over a mesh.

The float64 run is ``tests/_float64_port.py::enhance64``. A sharded path
that adds no error of its own lies within 2x of the one-process path's
error against it.

    python tests/init_scale_diagnosis.py
"""

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

CASES = ("in", "cnn")


def _freq_rank(mesh_name, trees):
    import torch

    import test_torch_freq_shard as T
    from eabnet_tpu_torch.inference import Enhancer
    from eabnet_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    sizes, n = T.MESHES[mesh_name]
    mesh = make_mesh(("data", "freq"), ["cpu"] * n, sizes)
    return {case: Enhancer(T.port_cfg(case), trees[case], mesh=mesh,
                           shard_freq=True, device="cpu").enhance_batch(
                               T.wavs(mesh_name)) for case in CASES}


def err(got, want) -> float:
    return max(float(np.abs(np.asarray(g, np.float64) - w).max())
               for g, w in zip(got, want))


def report(label, ref, paths) -> None:
    top = max(float(np.abs(w).max()) for w in ref)
    one = err(paths["one"], ref)
    print(f"{label}: max|out| {top:.4f}; vs float64: " + ", ".join(
        f"{k} {err(v, ref):.3e}" for k, v in paths.items())
        + f"; sharded / one {err(paths['sharded'], ref) / one:.2f}",
        flush=True)


def freq_cases() -> None:
    import jax

    from _float64_port import enhance64
    import test_torch_freq_shard as T
    from eabnet_tpu.config import ExperimentConfig as JaxCfg
    from eabnet_tpu.inference import Enhancer as JEnhancer
    from eabnet_tpu.parallel import make_mesh as jmesh
    from eabnet_tpu_torch.inference import Enhancer
    from eabnet_tpu_torch.parallel import launch

    trees = {case: T.params(case, "jax") for case in CASES}
    for name, (sizes, n) in T.MESHES.items():
        ranks = launch.spawn(_freq_rank, n, (name, trees), backend="gloo",
                             timeout_s=T.RANK_TIMEOUT_S)
        mesh = jmesh(("data", "freq"), devices=jax.devices()[:n],
                     sizes=sizes)
        for case in CASES:
            x = T.wavs(name)
            jax_out = JEnhancer(JaxCfg.from_dict(T.cfg_dict(case)),
                                trees[case], mesh=mesh,
                                shard_freq=True).enhance_batch(x)
            one = Enhancer(T.port_cfg(case), trees[case],
                           device="cpu").enhance_batch(x)
            ref = enhance64(T.port_cfg(case), trees[case], x)
            report(f"freq {name} {case}", ref,
                   {"jax": jax_out, "one": one, "sharded": ranks[0][case]})


def mesh_case() -> None:
    import torch

    from _float64_port import enhance64
    import test_torch_parallel as P
    from eabnet_tpu.config import ExperimentConfig as JaxCfg
    from eabnet_tpu.inference import Enhancer as JEnhancer
    from eabnet_tpu_torch.inference import Enhancer
    from eabnet_tpu_torch.models import build_model
    from eabnet_tpu_torch.parallel import make_mesh
    from eabnet_tpu_torch.weights import to_jax_tree

    cfg = P.tiny_serving_cfg("IN")
    torch.manual_seed(0)
    model = build_model(cfg.model)  # the port's init, the JAX package's
    tree = to_jax_tree(model, dict(model.named_parameters()))
    rng = np.random.default_rng(1)
    x = [(rng.standard_normal((3, n)) * 0.1).astype(np.float32)
         for n in (4000, 2500, 3300)]
    meshed = Enhancer(cfg, tree, mesh=make_mesh(devices=["cpu", "cpu"]),
                      device="cpu").enhance_batch(x)
    one = Enhancer(cfg, tree, device="cpu").enhance_batch(x)
    jax_out = JEnhancer(JaxCfg.from_dict(json.loads(cfg.to_json())),
                        tree).enhance_batch(x)
    report("mesh 2 replicas IN", enhance64(cfg, tree, x),
           {"jax": jax_out, "one": one, "sharded": meshed})


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault(
        "XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax

    jax.config.update("jax_platforms", "cpu")
    mesh_case()
    freq_cases()
