"""Streaming enhancement CLI of the port: audio frame by frame, as a
real-time deployment runs it (hop-sized sample blocks in, hop-sized
blocks out, O(1) state).

    # one stream
    python -m eabnet_tpu_torch.cli.stream in.wav out.wav \
        --exp-root release/eabnet_9mic_cln
    # N concurrent streams: a directory of wavs served in lockstep from one
    # batched state (each step advances every stream by one 10 ms frame)
    python -m eabnet_tpu_torch.cli.stream in_dir/ out_dir/ \
        --exp-root release/eabnet_9mic_cln

The model must use a causal norm (cLN or cLN-ref). Prints the mean step
time per frame against the hop; in directory mode one step serves every
stream. Streams of a batch are independent, so ragged lengths are served
by feeding finished streams zeros and trimming their outputs. Runs on the
card (``--device``, default cuda) with float32 products
(``utils/precision.float32_products``), as the Enhancer does.
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description="streaming enhancement "
                                     "(PyTorch port)")
    parser.add_argument("input", help="wav file, or a directory of wavs "
                        "served as concurrent streams")
    parser.add_argument("output", help="wav file (or directory)")
    parser.add_argument("--exp-root", required=True,
                        help="experiment dir with config.json + checkpoint")
    parser.add_argument("--ckpt", default=None,
                        help="explicit .params or .ckpt checkpoint")
    parser.add_argument("--mic-permutation", default=None,
                        help="comma-separated capture-channel order")
    parser.add_argument("--output-stage", default="esti",
                        choices=["esti", "esti0"],
                        help="esti = EaBNet + GaGNet, esti0 = the bare "
                        "EaBNet beamformer (as cli.enhance)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from eabnet_tpu_torch.dsp import (StreamingIstft, StreamingStft,
                                      power_uncompress)
    from eabnet_tpu_torch.inference import load_enhancer
    from eabnet_tpu_torch.streaming import StreamingComposed
    from eabnet_tpu_torch.utils.audio_io import read_wav, resample, write_wav
    from eabnet_tpu_torch.utils.precision import float32_products

    device = torch.device(args.device)
    enh = load_enhancer(args.exp_root, args.ckpt, device=args.device)
    cfg = enh.cfg
    model = StreamingComposed(enh.model)
    s_stft = StreamingStft(cfg.stft, device=device)
    s_istft = StreamingIstft(cfg.stft, device=device)
    hop = cfg.stft.hop_samples

    perm = None
    if args.mic_permutation:
        perm = [int(x) for x in args.mic_permutation.split(",")]

    def load(path):
        sr, noisy = read_wav(path)
        if noisy.ndim == 1:
            noisy = noisy[None]
        if sr != cfg.stft.sr:
            noisy = resample(noisy, sr, cfg.stft.sr)
        if perm is not None:
            noisy = noisy[np.asarray(perm)]
        n = noisy.shape[1] - noisy.shape[1] % hop
        return noisy[:, :n]

    if os.path.isdir(args.input):
        names = sorted(n for n in os.listdir(args.input)
                       if n.endswith(".wav"))
        if not names:
            raise FileNotFoundError(f"no wavs under {args.input}")
        os.makedirs(args.output, exist_ok=True)
        streams = [load(os.path.join(args.input, n)) for n in names]
        out_paths = [os.path.join(args.output, n) for n in names]
        mics = {s.shape[0] for s in streams}
        if len(mics) != 1:
            raise ValueError(f"streams must share a mic count, got {mics}")
    else:
        streams = [load(args.input)]
        out_paths = [args.output]

    b, m = len(streams), streams[0].shape[0]
    lengths = [s.shape[1] for s in streams]
    n_max = max(lengths)
    batch = np.zeros((b, m, n_max), np.float32)
    for i, s in enumerate(streams):
        batch[i, :, :s.shape[1]] = s

    frames = n_max // hop
    with float32_products(device), torch.inference_mode():
        stft_state = s_stft.init_state(b, m)
        model_state = model.init_state(b)
        istft_state = s_istft.init_state(b)
        chunks = []
        t0 = time.perf_counter()
        for t in range(frames):
            block = torch.from_numpy(batch[:, :, t * hop:(t + 1) * hop]
                                     ).to(device)
            stft_state, frame = s_stft.push(stft_state, block)  # (B,M,F,2)
            model_state, out = model.step(model_state,
                                          frame.transpose(1, 2))
            esti = out[args.output_stage]
            if cfg.stft.decompress_output:
                # the inverse power compression of the offline stft_to_wav
                esti = power_uncompress(esti, cfg.stft.compression)
            istft_state, samples = s_istft.push(istft_state, esti)
            chunks.append(samples)
        out = torch.cat(chunks, dim=-1).cpu().numpy()
        wall = time.perf_counter() - t0
    budget = hop / cfg.stft.sr * 1e3
    per_frame = wall / frames * 1e3
    print(f"{b} stream(s), {frames} frames, {per_frame:.2f} ms/frame "
          f"(budget {budget:.0f} ms"
          + (f"; {per_frame / b:.2f} ms/frame/stream" if b > 1 else "")
          + f") on {device}")
    for i, (path, n_i) in enumerate(zip(out_paths, lengths)):
        write_wav(path, cfg.stft.sr, out[i, :n_i], dtype="float")


if __name__ == "__main__":
    main()
