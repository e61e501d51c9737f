"""Demo of the port: deterministic scene -> synthesis -> enhancement ->
metrics, as the repo's ``examples/demo.py`` runs the JAX package.

The script equivalent of the reference's demo.ipynb: pin a scene with the
``specific`` override dict (``SPECIFIC``), synthesize the 9-mic mixture,
enhance it with a trained experiment, and print the metric battery of the
result. Without ``--exp-root`` the weights are a fresh model from the
port's own seeded initialisers (``create_train_state``, seed
``train.seed``: PyTorch's default draws), not the JAX package's ``key(0)``
initialisation, so those outputs differ from the JAX demo's. The model
runs on the card unless ``--platform cpu`` is given.

    python -m eabnet_tpu_torch.tools.demo --settings dataset_settings.json \\
        --speech sp.wav --noise-dir noises/ [--exp-root exp/]
"""

from __future__ import annotations

import argparse
import os

# the deterministic scene of demo.ipynb cell 8
SPECIFIC = {
    "room_dim": [6.0, 5.0, 3.0],
    "target_xyz": [3.0, 3.5, 1.2],
    "mics_xyz": [3.0, 1.5, 1.3],
    "noise_xyz_list": [[1.0, 4.0, 1.2], [5.0, 1.0, 1.2]],
    "noise_snr_list": [1.0, 1.0],
    "rt60": 0.3,
    "noisy_dBFS": -20.0,
}


def pinned_scene(settings: str, speech: str, noise_dir: str):
    """(noisy (M, N), clean (N,), meta) of the pinned 6-s scene: the
    first two wavs of ``noise_dir`` (sorted), seed 0."""
    from eabnet_tpu_torch.data.datasets import synthesize_item
    from eabnet_tpu_torch.data.scenes import load_settings

    noises = sorted(os.path.join(noise_dir, n) for n in os.listdir(noise_dir)
                    if n.endswith(".wav"))
    return synthesize_item(load_settings(settings), 6.0, speech, noises[:2],
                           seed=0, specific=SPECIFIC, return_meta=True)


def main(argv=None) -> dict:
    from eabnet_tpu_torch.tools.e2e_demo import add_platform, device_for

    parser = argparse.ArgumentParser()
    parser.add_argument("--settings", required=True)
    parser.add_argument("--speech", required=True)
    parser.add_argument("--noise-dir", required=True)
    parser.add_argument("--exp-root", default=None)
    parser.add_argument("--out-dir", default="demo_out")
    add_platform(parser)
    args = parser.parse_args(argv)
    device = device_for(args.platform)

    import numpy as np

    from eabnet_tpu_torch.eval import cal_single_metrics
    from eabnet_tpu_torch.utils.audio_io import write_wav

    noisy, clean, meta = pinned_scene(args.settings, args.speech,
                                      args.noise_dir)
    print("scene:", {k: meta[k] for k in ("room_dim", "rt60", "snrs_db")})

    os.makedirs(args.out_dir, exist_ok=True)
    write_wav(os.path.join(args.out_dir, "noisy.wav"), 16000, noisy)
    write_wav(os.path.join(args.out_dir, "clean.wav"), 16000, clean)

    if args.exp_root:
        from eabnet_tpu_torch.inference import load_enhancer

        enhancer = load_enhancer(args.exp_root, device=device)
    else:
        print("no --exp-root given; using randomly initialized weights")
        from eabnet_tpu_torch.config import ExperimentConfig
        from eabnet_tpu_torch.inference import Enhancer
        from eabnet_tpu_torch.train.step import create_train_state
        from eabnet_tpu_torch.weights import to_jax_params

        cfg = ExperimentConfig()
        enhancer = Enhancer(cfg, to_jax_params(
            create_train_state(cfg, "cpu").model), device=device)

    esti = enhancer(noisy)
    write_wav(os.path.join(args.out_dir, "enhanced.wav"), 16000, esti)

    scores = cal_single_metrics(clean, noisy[0], np.asarray(esti))
    for k, v in scores.items():
        if v is not None:
            print(f"{k}: {v:.3f}")
    print(f"wavs written to {args.out_dir}/")
    return scores


if __name__ == "__main__":
    main()
