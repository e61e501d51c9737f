"""Writes tests/golden/torch_port_heads_00000.npz: the JAX package's
Enhancer outputs of release/val_set/noisy/00000.wav for release/composed_9mic
with its LSTM head replaced by the seeded cnn or miso head of
``chip_smoke.head_experiment`` (a Dense ``bf_map`` from
``default_rng(16)``; the same numpy tree goes to both packages).

    python tests/golden/torch_port_heads_00000.py

Runs the JAX package on the CPU (6 full-width forwards, a few minutes).
Keys: ``<stage>_<head>`` for the stages esti0 and esti and the heads cnn
and miso (float32), and ``esti_cnn_bfloat16``, ``esti_cnn_int8w``.
``chip_smoke.py`` (the heads phase) holds the port on the card against
this file, ``tests/test_torch_heads_release.py`` the port on the CPU.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke as C
    from eabnet_tpu.config import ExperimentConfig
    from eabnet_tpu.inference import Enhancer
    from eabnet_tpu.utils.audio_io import read_wav

    _, noisy = read_wav(os.path.join(C.VAL, "noisy", "00000.wav"))
    golden = {}
    for head in C.HEADS:
        d, tree = C.head_experiment(C.EXP, head)
        cfg = ExperimentConfig.from_dict(d)
        runs = [("esti0", "float32"), ("esti", "float32")]
        if head == "cnn":
            runs += [("esti", "bfloat16"), ("esti", "int8w")]
        for stage, dtype in runs:
            key = f"{stage}_{head}" + ("" if dtype == "float32"
                                       else f"_{dtype}")
            golden[key] = np.asarray(Enhancer(
                cfg, tree, output=stage, compute_dtype=dtype)(noisy),
                np.float32)
            print(key, golden[key].shape, flush=True)
    np.savez(os.path.join(ROOT, C.HEADS_GOLDEN), **golden)
    print(f"wrote {C.HEADS_GOLDEN}")


if __name__ == "__main__":
    main()
