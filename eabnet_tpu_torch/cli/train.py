"""Training CLI of the port:

    python -m eabnet_tpu_torch.cli.train --config exp.json [--max-steps N]
        [--device cuda] [--multihost] [--set train.compute_dtype=float32 ...]

Runs ``train.trainer.train``. ``--config`` and ``--set`` are those of
``cli/common.py``. A released config records
``train.compute_dtype: "bfloat16"`` and trains in bf16 mixed precision as
recorded; ``--set train.compute_dtype=float32`` trains it in float32.
``main`` returns ``train``'s per-step records (rank 0's).

On the card (``--device cuda``) it trains data-parallel on the most
visible cards that divide ``train.batch_size`` (the JAX package's rule):
with more than one it builds the kernels and the native RIR engine once,
then starts one process per card (``spawn``, NCCL on a free localhost
port); a rank that fails ends the run with its traceback. ``--device
cpu`` or an explicit ``cuda:N`` trains in this process.

``--multihost`` joins the process group that a launcher's environment
describes (``torchrun``: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``; NCCL on the card, gloo on the CPU) and
trains as one rank of it, on ``cuda:<LOCAL_RANK>``:

    torchrun --nproc-per-node 8 -m eabnet_tpu_torch.cli.train \\
        --config exp.json --multihost

An online config (``data.train_set="online"``) synthesizes in
``data.num_workers`` spawned processes, which import the calling script
as a module: a script that calls ``main`` or ``train`` runs them under
``if __name__ == "__main__":``."""

from __future__ import annotations

import argparse

from eabnet_tpu_torch.cli.common import add_config_args, load_config


def data_parallel_cards(batch_size: int, visible: int) -> int:
    """The most cards, of ``visible``, that divide ``batch_size``."""
    return max(k for k in range(1, max(visible, 1) + 1)
               if batch_size % k == 0)


def _rank(cfg_json: str, max_steps, device: str):
    """One spawned rank: ``train`` inside the launcher's group."""
    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.train.trainer import train

    return train(ExperimentConfig.from_json(cfg_json), max_steps=max_steps,
                 device=device)


def train_on_cards(cfg, cards: int, max_steps=None, device: str = "cuda"):
    """``train`` in ``cards`` spawned ranks, one per card under NCCL, after
    building the kernels and the native RIR engine in this process; rank
    0's records. ``device="cpu"`` runs the ranks on the host under gloo."""
    from eabnet_tpu_torch.parallel import launch

    launch.build_once(cuda=device == "cuda")
    return launch.spawn(_rank, cards, (cfg.to_json(), max_steps, device),
                        backend=launch.default_backend(device))[0]


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="train EaBNet+GaGNet (PyTorch port)")
    add_config_args(parser)
    parser.add_argument("--max-steps", type=int, default=None,
                        help="stop after N optimizer steps")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default: cuda: "
                        "every visible card that divides the batch)")
    parser.add_argument("--multihost", action="store_true",
                        help="join the process group of the launcher's "
                        "environment (torchrun) and train as one rank")
    args = parser.parse_args(argv)
    cfg = load_config(args)

    import torch

    from eabnet_tpu_torch.parallel import launch
    from eabnet_tpu_torch.train.trainer import train

    if args.multihost:
        launch.join_from_env(launch.default_backend(args.device))
        try:
            return train(cfg, max_steps=args.max_steps, device=args.device)
        finally:
            torch.distributed.destroy_process_group()
    cards = (data_parallel_cards(cfg.train.batch_size,
                                 torch.cuda.device_count())
             if args.device == "cuda" else 1)
    if cards == 1:
        return train(cfg, max_steps=args.max_steps, device=args.device)
    print(f"data-parallel over {cards} cards (NCCL), global batch "
          f"{cfg.train.batch_size}")
    return train_on_cards(cfg, cards, args.max_steps)


if __name__ == "__main__":
    main()
