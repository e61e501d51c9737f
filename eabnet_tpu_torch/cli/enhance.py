"""Enhancement CLI of the port:

    python -m eabnet_tpu_torch.cli.enhance in.wav out.wav \
        --exp-root release/composed_9mic [--output-stage esti0] \
        [--compute-dtype bfloat16] [--device cpu]

The input may be a directory of wavs; the output is then a directory.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="offline enhancement "
                                     "(PyTorch port)")
    parser.add_argument("input", help="input wav or directory of wavs")
    parser.add_argument("output", help="output wav or directory")
    parser.add_argument("--exp-root", required=True,
                        help="experiment dir with config.json + checkpoint")
    parser.add_argument("--ckpt", default=None,
                        help="explicit .params or .ckpt checkpoint")
    parser.add_argument("--output-stage", default="esti",
                        choices=["esti", "esti0"],
                        help="esti = EaBNet + GaGNet, esti0 = the bare "
                        "EaBNet beamformer")
    parser.add_argument("--compute-dtype", default="float32",
                        choices=["float32", "bfloat16", "int8w"],
                        help="model compute dtype: bfloat16 casts the "
                        "weights and activations; int8w stores weights as "
                        "int8 and dequantizes them to bf16 per call "
                        "(STFT/iSTFT stay float32)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    parser.add_argument("--batch-size", type=int, default=1,
                        help="files per batch in directory mode")
    parser.add_argument("--mic-permutation", default=None,
                        help="comma-separated capture-channel order")
    args = parser.parse_args(argv)

    from eabnet_tpu_torch.inference import load_enhancer

    perm = None
    if args.mic_permutation:
        perm = [int(x) for x in args.mic_permutation.split(",")]
    enhancer = load_enhancer(args.exp_root, args.ckpt,
                             output=args.output_stage,
                             compute_dtype=args.compute_dtype,
                             device=args.device)
    if os.path.isdir(args.input):
        os.makedirs(args.output, exist_ok=True)
        names = sorted(n for n in os.listdir(args.input)
                       if n.endswith(".wav"))
        enhancer.enhance_files([os.path.join(args.input, n) for n in names],
                               [os.path.join(args.output, n) for n in names],
                               mic_permutation=perm,
                               batch_size=args.batch_size)
    else:
        enhancer.enhance_file(args.input, args.output, mic_permutation=perm)


if __name__ == "__main__":
    main()
