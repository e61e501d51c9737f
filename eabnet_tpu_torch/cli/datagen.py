"""Offline dataset generator of the port: pre-renders ``clean/`` and
``noisy/`` wav pairs through the port's ``synthesize_item``, as the JAX
package's ``cli/datagen.py`` does, item for item:

    python -m eabnet_tpu_torch.cli.datagen --output-dir val/
        --speech-root sp/ --noise-root no/ --speech-list lists/speechs_val
        --noise-list lists/noises_val --mcse-settings settings.json
        --clip-seconds 6 [--workers 16] [--seed 12345] [--limit N]
        [--items N | --reuse-speech]

Item k of the speech list is rendered with seed ``seed + k`` (``--items N``
cycles the list for exactly N items; ``--reuse-speech`` cuts every file
into consecutive clips, seed ``seed + 1000 i + j``), so the set does not
depend on the worker count. Workers are ``spawn``ed processes; the native
RIR engine is built here before they start.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor


def _render(job):
    from eabnet_tpu_torch.data.datasets import synthesize_item
    from eabnet_tpu_torch.utils.audio_io import write_wav

    (opt, clip_seconds, speech_path, noise_paths, seed, out_noisy,
     out_clean, start_sec, fs) = job
    noisy, clean = synthesize_item(
        opt, clip_seconds, speech_path, noise_paths, seed,
        speech_start_sec=start_sec,
    )
    write_wav(out_noisy, fs, noisy)
    write_wav(out_clean, fs, clean)
    return os.path.basename(out_noisy)


def main(argv=None):
    parser = argparse.ArgumentParser(description="offline dataset generator")
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--speech-root", required=True)
    parser.add_argument("--noise-root", required=True)
    parser.add_argument("--speech-list", required=True)
    parser.add_argument("--noise-list", required=True)
    parser.add_argument("--mcse-settings", required=True)
    parser.add_argument("--clip-seconds", type=float, required=True)
    parser.add_argument("--reuse-speech", action="store_true")
    parser.add_argument("--workers", type=int, default=16)
    parser.add_argument("--seed", type=int, default=12345)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--items", type=int, default=None,
                        help="render exactly N items by cycling the "
                        "speech list with fresh per-item scene seeds; "
                        "mutually exclusive with --reuse-speech")
    args = parser.parse_args(argv)
    if args.items and args.reuse_speech:
        parser.error("--items and --reuse-speech are mutually exclusive")

    from eabnet_tpu_torch.data.rir_native import native_available
    from eabnet_tpu_torch.data.scenes import load_settings
    from eabnet_tpu_torch.utils.audio_io import read_wav

    opt = load_settings(args.mcse_settings)
    fs = int(opt["audio"]["fs"])
    noisy_root = os.path.join(args.output_dir, "noisy")
    clean_root = os.path.join(args.output_dir, "clean")
    os.makedirs(noisy_root, exist_ok=True)
    os.makedirs(clean_root, exist_ok=True)

    with open(args.speech_list) as f:
        speech_list = [x for x in f.read().split("\n") if x.strip()]
    with open(args.noise_list) as f:
        noise_list = [x for x in f.read().split("\n") if x.strip()]
    noise_paths = [os.path.join(args.noise_root, n) for n in noise_list]
    if args.limit:
        speech_list = speech_list[: args.limit]

    def job(speech, seed, name, start=None):
        return (opt, args.clip_seconds,
                os.path.join(args.speech_root, speech), noise_paths, seed,
                os.path.join(noisy_root, name),
                os.path.join(clean_root, name), start, fs)

    jobs = []
    if args.items:
        jobs = [job(speech_list[k % len(speech_list)], args.seed + k,
                    f"{k:05d}.wav") for k in range(args.items)]
    elif not args.reuse_speech:
        jobs = [job(speech, args.seed + i, f"{i:05d}.wav")
                for i, speech in enumerate(speech_list)]
    else:
        for i, speech in enumerate(speech_list):
            sr, audio = read_wav(os.path.join(args.speech_root, speech))
            t, j = 0.0, 0
            while (t + args.clip_seconds) * sr <= len(audio):
                jobs.append(job(speech, args.seed + i * 1000 + j,
                                f"{i:05d}_{j}.wav", t))
                t += args.clip_seconds
                j += 1

    native_available()  # build the RIR engine once, before the workers
    print(f"rendering {len(jobs)} items with {args.workers} workers")
    with ProcessPoolExecutor(
            max_workers=args.workers,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        for k, name in enumerate(pool.map(_render, jobs)):
            if (k + 1) % 50 == 0 or k + 1 == len(jobs):
                print(f"{k + 1}/{len(jobs)} done")


if __name__ == "__main__":
    main()
