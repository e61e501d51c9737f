"""Dataset resampling CLI of the port: offline conversion of a wav
directory to another rate (48 kHz to 16 kHz by default in the reference's
recipe), as the JAX package's ``cli/resample.py``.

    python -m eabnet_tpu_torch.cli.resample src/ dst/ [--fs 16000]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="resample wav directories")
    parser.add_argument("src_dir")
    parser.add_argument("dst_dir")
    parser.add_argument("--fs", type=int, default=16000)
    args = parser.parse_args(argv)

    from eabnet_tpu_torch.utils.audio_io import read_wav, resample, write_wav

    os.makedirs(args.dst_dir, exist_ok=True)
    names = sorted(
        n for n in os.listdir(args.src_dir) if n.lower().endswith(".wav")
    )
    print(f"{args.src_dir} -> {args.dst_dir} ({len(names)} files)")
    for i, name in enumerate(names):
        sr, audio = read_wav(os.path.join(args.src_dir, name))
        audio = resample(audio, sr, args.fs)
        write_wav(os.path.join(args.dst_dir, name), args.fs, audio)
        if (i + 1) % 100 == 0:
            print(f"{i + 1}/{len(names)}")


if __name__ == "__main__":
    main()
