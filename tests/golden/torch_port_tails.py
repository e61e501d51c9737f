"""Writes tests/golden/torch_port_tails.json: the JAX tool
``tools/tail_sensitivity.py`` at ``chip_smoke.TAILS_CUT`` with
release/eabnet_9mic_cln, on the staging ``chip_smoke.py``'s longrun phase
makes (``chip_smoke.TAILS_STAGING``, staged here by the JAX package's
``tools/long_train.py::stage_data``, which the port's reproduces).

    python tests/golden/torch_port_tails.py

Runs the JAX package on the CPU (the three renders and 18 scored
forwards; a few minutes), under ``build/golden_tails/``. Keys: ``cut``
(the tool's flags), ``staging``, ``markdown`` (the report's lines) and
``table`` (``chip_smoke.parse_tails`` of it). ``chip_smoke.py`` (the tails
phase) and ``tests/test_torch_gpu.py::test_tail_sensitivity_on_card`` hold
the port's tool on the card against it by ``chip_smoke.check_tails``.
"""

import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke as C
    from tools import tail_sensitivity
    from tools.e2e_demo import SETTINGS
    from tools.long_train import stage_data

    root = os.path.join(ROOT, "build", "golden_tails")
    shutil.rmtree(root, ignore_errors=True)
    work = os.path.join(root, "work")
    stage_data(work, *C.TAILS_STAGING, SETTINGS, render_train=False)
    out = os.path.join(root, "TAIL_SENSITIVITY.md")
    sys.argv = ["tail_sensitivity", "--workdir", work, "--exp-root",
                C.EXP_CLN, "--out", out, "--render-root",
                os.path.join(root, "render"), *C.TAILS_CUT,
                "--platform", "cpu"]
    tail_sensitivity.main()
    with open(out) as f:
        text = f.read()
    golden = {"cut": list(C.TAILS_CUT), "staging": list(C.TAILS_STAGING),
              "markdown": text.splitlines(), "table": C.parse_tails(text)}
    with open(os.path.join(ROOT, C.TAILS_GOLDEN), "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")
    print(f"wrote {C.TAILS_GOLDEN}")


if __name__ == "__main__":
    main()
