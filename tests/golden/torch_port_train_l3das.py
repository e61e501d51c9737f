"""Writes tests/golden/torch_port_train_l3das.npz: the JAX package's losses
of 3 joint train steps of release/composed_9mic cut to 4 microphones on
release/val_set re-packed as L3DAS23 pickles, the run ``chip_smoke.py``'s
heads phase makes on the card through the port's ``train()``.

    python tests/golden/torch_port_train_l3das.py

The pickles (``chip_smoke.write_l3das_pickles``: the noisy wavs' mics 0-3
as (4, N), the clean wavs as (1, N)) are written under
build/chip_smoke_l3das/, where the card run writes them; the params are
the release 40000.params restricted to mics 0-3
(``chip_smoke.l3das_params``); the config is ``chip_smoke.l3das_config``
(batch 7, float32, lr 5e-4, clip 1.0). The JAX steps run one item at a
time, as tests/test_torch_train_golden.py makes its golden (each item has
all 601 frames, so the mean of the items' gradients is the batch's). On
the CPU, ~4 GB, some ten minutes. Keys: ``losses`` (3 steps x {eabnet,
postnet, final}), ``first_items`` (step 1 per item), ``config``.
"""

import json
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
    from eabnet_tpu.data.datasets import make_dataset

    from tests.test_torch_train_golden import jax_item_steps

    d = C.l3das_config(C.write_l3das_pickles(C.L3DAS_DIR))
    cfg = ExperimentConfig.from_dict(d)
    train_ds, _ = make_dataset(cfg.data, mics=cfg.model.eabnet.M)
    items = [(x, y[0]) for x, y in (train_ds[i]
                                    for i in range(len(train_ds)))]
    losses, first_items, _ = jax_item_steps(cfg, C.l3das_params(), items,
                                            C.L3DAS_STEPS)
    path = os.path.join(ROOT, C.L3DAS_GOLDEN)
    np.savez(path, losses=losses, first_items=first_items,
             config=json.dumps(d))
    print(f"wrote {path}:\n{losses}")


if __name__ == "__main__":
    main()
