"""Corpus split tool of the port: frozen train/val source lists.

    python -m eabnet_tpu_torch.cli.split --speech-root sp/ --noise-root no/
        --out-dir lists/ [--ratio 20] [--seed 123]

Splits the speech and noise wavs 20:1 with a seeded RNG (the reference's
benchmark split) into ``{speechs,noises}_{train,val}`` list files; the
frozen val set is then rendered with ``eabnet_tpu_torch.cli.datagen`` on
the val lists. The same as the JAX package's ``cli/split.py``.
"""

from __future__ import annotations

import argparse
import os


def split(names, ratio: int, seed: int):
    import numpy as np

    rng = np.random.RandomState(seed)
    names = sorted(names)
    idx = rng.permutation(len(names))
    n_val = max(1, len(names) // (ratio + 1))
    val = [names[i] for i in sorted(idx[:n_val])]
    train = [names[i] for i in sorted(idx[n_val:])]
    return train, val


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="seeded train/val source split"
    )
    parser.add_argument("--speech-root", required=True)
    parser.add_argument("--noise-root", required=True)
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--ratio", type=int, default=20,
                        help="train:val ratio (default 20:1)")
    parser.add_argument("--seed", type=int, default=123,
                        help="split seed (reference uses RandomState(123))")
    args = parser.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    for kind, root in (("speech", args.speech_root),
                       ("noise", args.noise_root)):
        names = [n for n in os.listdir(root) if n.lower().endswith(".wav")]
        train, val = split(names, args.ratio, args.seed)
        for part, lst in (("train", train), ("val", val)):
            path = os.path.join(args.out_dir, f"{kind}s_{part}")
            with open(path, "w") as f:
                f.write("\n".join(lst))
            print(f"{path}: {len(lst)} files")


if __name__ == "__main__":
    main()
