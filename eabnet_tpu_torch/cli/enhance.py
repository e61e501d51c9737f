"""Enhancement CLI of the port:

    python -m eabnet_tpu_torch.cli.enhance in.wav out.wav \
        --exp-root release/composed_9mic [--output-stage esti0] \
        [--compute-dtype bfloat16] [--device cpu] [--mesh | --shard-freq]

The input may be a directory of wavs; the output is then a directory.
``--mesh`` serves batches over every visible card (one replica per card,
``Enhancer(mesh=...)``), in batches of the mesh's size unless
``--batch-size`` says otherwise. ``--shard-freq`` splits each utterance's
frequency bins over a 1 x N ('data', 'freq') mesh of ranks
(``Enhancer(shard_freq=True)``): after building the kernels once it
spawns one NCCL rank per visible card (``--ranks`` of them at most), or
with ``--device cpu`` ``--ranks`` gloo ranks on the host (default 2);
rank 0 writes the files. The two are exclusive, as in the JAX package.
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
    parser.add_argument("--shard-freq", action="store_true",
                        help="frequency-axis model parallelism: one rank "
                        "per card (or --ranks gloo ranks with --device "
                        "cpu) splits each utterance's bins; exclusive "
                        "with --mesh")
    parser.add_argument("--ranks", type=int, default=None,
                        help="ranks for --shard-freq (default: every "
                        "visible card; 2 with --device cpu)")
    parser.add_argument("--batch-size", type=int, default=None,
                        help="files per batch in directory mode (default: "
                        "1, or the mesh's size with --mesh)")
    parser.add_argument("--mic-permutation", default=None,
                        help="comma-separated capture-channel order")
    args = parser.parse_args(argv)
    if args.mesh and args.shard_freq:
        raise SystemExit("--mesh (batch over cards) and --shard-freq (bins "
                         "over ranks) are exclusive")
    if args.shard_freq:
        return shard_freq(args)
    run(args)


def shard_freq(args) -> None:
    """``run`` in one spawned rank per card (NCCL), or ``args.ranks`` gloo
    ranks on the host with ``--device cpu``, after building the kernels
    in this process."""
    import torch

    from eabnet_tpu_torch.parallel import launch

    cuda = torch.device(args.device).type == "cuda"
    ranks = args.ranks or (torch.cuda.device_count() if cuda else 2)
    if cuda:
        ranks = min(ranks, torch.cuda.device_count())
    if ranks < 1:
        raise SystemExit("--shard-freq: no card to run on")
    launch.build_once(cuda=cuda)
    launch.spawn(run, ranks, (args,), backend="nccl" if cuda else "gloo")


def run(args) -> None:
    """Enhance the input(s) as ``args`` says: in this process, or as one
    rank of ``--shard-freq``'s group."""
    from eabnet_tpu_torch.inference import load_enhancer
    from eabnet_tpu_torch.parallel import make_mesh
    from eabnet_tpu_torch.parallel.mesh import process_count, process_index

    perm = None
    if args.mic_permutation:
        perm = [int(x) for x in args.mic_permutation.split(",")]
    mesh, kw = None, {}
    if args.shard_freq:  # rank r on card r, or every rank on the host
        devices = ([f"cuda:{r}" for r in range(process_count())]
                   if args.device == "cuda"
                   else [args.device] * process_count())
        args.device = devices[process_index()]
        kw = dict(shard_freq=True, mesh=make_mesh(("data", "freq"), devices,
                                                  sizes=(1, -1)))
    elif args.mesh:
        mesh = make_mesh(devices=None if args.device == "cuda"
                         else [args.device])
        kw = dict(mesh=mesh)
    enhancer = load_enhancer(args.exp_root, args.ckpt,
                             output=args.output_stage,
                             compute_dtype=args.compute_dtype,
                             device=args.device, **kw)
    bs = args.batch_size or (mesh.size if mesh else 1)
    if mesh is not None and bs % mesh.size:
        # a smaller chunk would leave replicas computing padding
        bs = -(-bs // mesh.size) * mesh.size
        print(f"--batch-size rounded up to {bs}, a multiple of the mesh's "
              f"{mesh.size} devices")
    if os.path.isdir(args.input):
        if process_index() == 0:
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
