"""Wall time per frame of the streaming step, at 1, 7 and 64 streams.

    python eabnet_tpu_torch/tools/stream_step_time.py [--exp-root DIR]
        [--frames N] [--device cuda]

Loads the experiment (default ``release/eabnet_9mic_cln``, relative to the
working directory), makes the STFT frames of the 7 items of
``release/val_set/noisy`` and steps ``streaming.StreamingComposed`` over
them at 1, 7 and 64 streams (the items tiled) under float32 products and
inference mode: 5 frames of warm-up, then N timed frames (default 60),
each synchronised. Prints one JSON line: the package's path, the card's
name and power limit, and the mean and p50 ms per frame at each count.

It imports ``eabnet_tpu_torch`` from ``sys.path``, so run it by its path
with ``PYTHONPATH`` set to a tree's root to time that tree's package:
two trees in turns in one process each compare their steps on one card.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import time

STREAMS = (1, 7, 64)
WARMUP = 5


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--exp-root", default="release/eabnet_9mic_cln")
    parser.add_argument("--val", default="release/val_set/noisy")
    parser.add_argument("--frames", type=int, default=60)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    import eabnet_tpu_torch
    from eabnet_tpu_torch.dsp import prepare_data
    from eabnet_tpu_torch.inference import load_enhancer
    from eabnet_tpu_torch.streaming import StreamingComposed
    from eabnet_tpu_torch.utils.audio_io import read_wav
    from eabnet_tpu_torch.utils.precision import float32_products

    device = torch.device(args.device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    enh = load_enhancer(args.exp_root, device=args.device)
    noisy = [read_wav(p)[1] for p in sorted(glob.glob(
        os.path.join(args.val, "*.wav")))]
    n = max(x.shape[-1] for x in noisy)
    wavs = torch.from_numpy(np.stack([
        np.pad(x, ((0, 0), (0, n - x.shape[-1]))) for x in noisy])).to(device)
    stepper = StreamingComposed(enh.model)
    per_frame = {}
    with float32_products(device), torch.inference_mode():
        frames, _ = prepare_data(wavs, None, enh.cfg.stft)
        for b in STREAMS:
            batch = frames[[i % len(noisy) for i in range(b)]]
            state = stepper.init_state(b)
            ms = []
            for t in range(WARMUP + args.frames):
                sync()
                t1 = time.perf_counter()
                state, _ = stepper.step(state, batch[:, t])
                sync()
                ms.append((time.perf_counter() - t1) * 1e3)
            ms = ms[WARMUP:]
            per_frame[b] = {"mean": float(np.mean(ms)),
                            "p50": float(np.percentile(ms, 50))}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip() if cuda else "cpu"
    print(json.dumps({"package": os.path.dirname(eabnet_tpu_torch.__file__),
                      "card": card, "frames": args.frames,
                      "ms_per_frame": per_frame}), flush=True)


if __name__ == "__main__":
    main()
