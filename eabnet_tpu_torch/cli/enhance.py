"""Enhancement CLI of the port:

    python -m eabnet_tpu_torch.cli.enhance in.wav out.wav \
        --exp-root release/composed_9mic [--output-stage esti0] \
        [--compute-dtype bfloat16] [--device cpu] [--mesh]

The input may be a directory of wavs; the output is then a directory.
``--mesh`` serves batches over every visible card (one replica per card,
``Enhancer(mesh=...)``), in batches of the mesh's size unless
``--batch-size`` says otherwise.
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
    parser.add_argument("--mesh", action="store_true",
                        help="serve over every visible card: one replica "
                        "per card, each batch split over them")
    parser.add_argument("--batch-size", type=int, default=None,
                        help="files per batch in directory mode (default: "
                        "1, or the mesh's size with --mesh)")
    parser.add_argument("--mic-permutation", default=None,
                        help="comma-separated capture-channel order")
    args = parser.parse_args(argv)

    from eabnet_tpu_torch.inference import load_enhancer

    perm = None
    if args.mic_permutation:
        perm = [int(x) for x in args.mic_permutation.split(",")]
    mesh = None
    if args.mesh:
        from eabnet_tpu_torch.parallel import make_mesh

        mesh = make_mesh(devices=None if args.device == "cuda"
                         else [args.device])
    enhancer = load_enhancer(args.exp_root, args.ckpt,
                             output=args.output_stage,
                             compute_dtype=args.compute_dtype,
                             device=args.device, mesh=mesh)
    bs = args.batch_size or (mesh.size if mesh else 1)
    if mesh is not None and bs % mesh.size:
        # a smaller chunk would leave replicas computing padding
        bs = -(-bs // mesh.size) * mesh.size
        print(f"--batch-size rounded up to {bs}, a multiple of the mesh's "
              f"{mesh.size} devices")
    if os.path.isdir(args.input):
        os.makedirs(args.output, exist_ok=True)
        names = sorted(n for n in os.listdir(args.input)
                       if n.endswith(".wav"))
        enhancer.enhance_files([os.path.join(args.input, n) for n in names],
                               [os.path.join(args.output, n) for n in names],
                               mic_permutation=perm, batch_size=bs)
    else:
        enhancer.enhance_file(args.input, args.output, mic_permutation=perm)


if __name__ == "__main__":
    main()
