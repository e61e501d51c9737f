"""Writes tests/golden/torch_port_eval_val_set.npz: the JAX package's own
``cli.test`` scores of both released models on release/val_set, per item,
for the stages ``esti0`` and ``esti`` (default padding, as a user runs it).

    python tests/golden/torch_port_eval_val_set.py

Runs the JAX package on the CPU (28 full-width forwards and scorings, a
few minutes). Keys: ``<model>/<stage>/<metric>`` (one float64 per item,
in file order) and ``<model>/<stage>/filename``. ``chip_smoke.py`` runs
the port's ``cli.test`` with the same arguments on the card and holds its
CSV against this file.
"""

import csv
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_eval_val_set.npz")
VAL = "release/val_set"
MODELS = {"composed_9mic": "40000.params", "eabnet_9mic_cln": "50000.params"}
STAGES = ("esti0", "esti")
METRICS = ("pesq", "nb_pesq", "stoi", "estoi", "si_sdr", "si_sir", "si_sar",
           "seg_snr", "lsd")


def cli_test_argv(model: str, stage: str, out_prefix: str) -> list:
    """The ``cli.test`` arguments for one model and stage (either package),
    relative to the repository's root."""
    return ["--config", f"release/{model}/config.json",
            "--set", f"data.val_set={VAL}",
            "--set", f"data.speech_root={VAL}",
            "--ckpt", f"release/{model}/{MODELS[model]}",
            "--output", stage, "--out-prefix", out_prefix]


def read_scores(csv_path: str) -> dict:
    """A ``write_report`` CSV -> {"filename": [...], metric: float64 array}."""
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    out = {"filename": np.array([r["filename"] for r in rows])}
    for m in METRICS:
        out[m] = np.array([float(r[m]) for r in rows], np.float64)
    return out


def main() -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from eabnet_tpu.cli import test as jax_test

    golden = {}
    with tempfile.TemporaryDirectory() as tmp:
        for model in MODELS:
            for stage in STAGES:
                prefix = os.path.join(tmp, f"{model}_{stage}")
                jax_test.main(cli_test_argv(model, stage, prefix))
                for k, v in read_scores(prefix + ".csv").items():
                    golden[f"{model}/{stage}/{k}"] = v
    np.savez(GOLDEN, **golden)
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    main()
