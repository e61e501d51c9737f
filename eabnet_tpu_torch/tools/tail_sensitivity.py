"""Task-level sensitivity of a trained model's metrics to the RIR late-tail
model, as the repo's ``tools/tail_sensitivity.py`` measures it with the
JAX package.

It renders a seeded held-out set from the same scene envelope as the
committed one, with identical scenes, crops and gains across the three
tail models (only the late-field synthesis differs: the controlled
variable of the study), and scores a released artifact on all of them:

    hybrid        - ISM(3) + exact image-source energy histogram
    hybrid-sabine - ISM(3) + Polack/Sabine diffuse envelope
    ism           - brute-force full-order image sources (no stochastic
                    tail: the physical ground truth for scattering-free
                    shoeboxes)

Rendering goes through the port's ``cli.datagen``, scoring through its
dataset, metrics and ``load_enhancer``; the markdown is the JAX tool's,
line for line. Staging reuses the deterministic corpus and split of
``long_train`` (its workdir). ``--check`` reports how closely the
``hybrid`` render reproduces the committed ``release/val_set_large``.
Every flag and default is the JAX tool's, except ``--platform``
(``default``, the card, as the port's other tools) and ``--workdir`` /
``--render-root`` (paths in the working directory).

    python -m eabnet_tpu_torch.tools.tail_sensitivity --workdir longrun \\
        --exp-root release/eabnet_9mic_cln --out TAIL_SENSITIVITY.md
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

METHODS = ("hybrid", "hybrid-sabine", "ism")
KEYS = ("si_sdr", "pesq", "estoi", "stoi")
STAGES = ("noisy", "esti0", "esti")
COMMITTED = os.path.join(os.path.dirname(__file__), "..", "..", "release",
                         "val_set_large")


def render(workdir, method, out_dir, items, clip, workers):
    """The held-out set under one tail model into ``out_dir``: the
    workdir's settings with ``rir_method`` replaced, its val lists."""
    from eabnet_tpu_torch.cli.datagen import main as datagen_main

    with open(os.path.join(workdir, "settings.json")) as f:
        settings = json.load(f)
    settings["audio"]["rir_method"] = method
    spath = os.path.join(out_dir, "settings.json")
    os.makedirs(out_dir, exist_ok=True)
    with open(spath, "w") as f:
        json.dump(settings, f)
    lists = os.path.join(workdir, "lists")
    datagen_main([
        "--output-dir", out_dir,
        "--speech-root", os.path.join(workdir, "speech"),
        "--noise-root", os.path.join(workdir, "noise"),
        "--speech-list", os.path.join(lists, "speechs_val"),
        "--noise-list", os.path.join(lists, "noises_val"),
        "--mcse-settings", spath, "--clip-seconds", str(clip),
        "--workers", str(workers), "--items", str(items),
    ])


def score(enhancer_or_none, val_dir, sr=16000):
    """{metric: (mean, std)} over a rendered set of the table's four
    metrics (one P.862 pass): the reference mic with None, else the
    enhancer's output."""
    from eabnet_tpu_torch.data.datasets import OfflineMcseDataset
    from eabnet_tpu_torch.eval.metrics import si_sdr
    from eabnet_tpu_torch.eval.pesq import pesq as pesq_fn
    from eabnet_tpu_torch.eval.stoi import stoi

    val = OfflineMcseDataset(val_dir)
    fn = enhancer_or_none if enhancer_or_none else (lambda n: n[0])
    vals = {k: [] for k in KEYS}
    for i in range(len(val)):
        noisy, clean = val[i]
        clean = np.asarray(clean).reshape(-1)
        esti = np.asarray(fn(np.atleast_2d(noisy)))
        vals["si_sdr"].append(si_sdr(clean, esti))
        vals["pesq"].append(pesq_fn(sr, clean, esti, "wb"))
        vals["estoi"].append(stoi(clean, esti, sr, extended=True))
        vals["stoi"].append(stoi(clean, esti, sr))
    return {k: (float(np.mean(v)), float(np.std(v)))
            for k, v in vals.items()}


def check(render_root, committed=COMMITTED, n=8) -> float:
    """The worst relative sample deviation of the ``hybrid`` render's
    first ``n`` noisy wavs from the committed set's, printed."""
    from scipy.io import wavfile

    names = sorted(os.listdir(os.path.join(committed, "noisy")))[:n]
    worst = 0.0
    for name in names:
        _, a = wavfile.read(os.path.join(committed, "noisy", name))
        _, b = wavfile.read(os.path.join(render_root, "hybrid", "noisy",
                                         name))
        assert a.shape == b.shape, name
        rel = float(np.abs(a.astype(np.int64) - b).max()
                    / max(np.abs(a).max(), 1))
        worst = max(worst, rel)
    print(f"[tails] hybrid re-render vs committed set: worst "
          f"relative sample deviation {worst:.4f} over "
          f"{len(names)} items (same scenes; numeric drift from "
          f"post-render code evolution is expected)", flush=True)
    return worst


def markdown(rows, exp_root, items):
    """The report's lines: one row per tail model and stage, then the
    deltas of the other two models against ``hybrid``."""
    lines = [
        "# Late-tail sensitivity of the released cLN artifact",
        "",
        "A 48-item seeded held-out set (same scene envelope/settings as",
        "the committed set) rendered under three RIR late-tail models",
        "with IDENTICAL scenes, crops and gains across models — only the",
        "late-field synthesis differs — scored with",
        f"`{exp_root}` (mean over {items} items).",
        "`ism` is the brute-force full-order image-source render — the",
        "physical ground truth for scattering-free shoeboxes, no",
        "stochastic tail at all. Produced by `tools/tail_sensitivity.py`.",
        "",
        "| tail model | stage | " + " | ".join(KEYS) + " |",
        "|---|---|" + "---|" * len(KEYS),
    ]
    for method in METHODS:
        for stage in STAGES:
            vals = rows[method][stage]
            lines.append(
                f"| {method} | {stage} | "
                + " | ".join(f"{vals[k][0]:.3f}" for k in KEYS) + " |")
    lines += ["", "Deltas vs `hybrid` (the framework's default):", ""]
    lines += ["| tail model | stage | "
              + " | ".join(f"d {k}" for k in KEYS) + " |",
              "|---|---|" + "---|" * len(KEYS)]
    for method in METHODS[1:]:
        for stage in ("esti0", "esti"):
            d = [rows[method][stage][k][0] - rows["hybrid"][stage][k][0]
                 for k in KEYS]
            lines.append(f"| {method} | {stage} | "
                         + " | ".join(f"{x:+.3f}" for x in d) + " |")
    return lines


def parse_args(argv=None):
    from eabnet_tpu_torch.tools.e2e_demo import add_platform

    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="longrun",
                    help="a long_train workdir whose staged corpus/"
                    "lists reproduce the committed set")
    ap.add_argument("--exp-root", default="release/eabnet_9mic_cln")
    ap.add_argument("--out", default="release/TAIL_SENSITIVITY.md")
    ap.add_argument("--render-root", default="tail_sensitivity")
    ap.add_argument("--items", type=int, default=48)
    ap.add_argument("--clip", type=float, default=6.0)
    ap.add_argument("--workers", type=int, default=2)
    add_platform(ap)
    ap.add_argument("--check", action="store_true",
                    help="report how closely the 'hybrid' re-render "
                    "reproduces the committed release/val_set_large "
                    "(same seeds; small numeric drift is expected, and "
                    "the study is self-consistent either way because "
                    "all three tails render from the same code)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Render what is not rendered yet, score, write ``--out``; returns
    {method: {stage: {metric: (mean, std)}}}."""
    from eabnet_tpu_torch.inference import load_enhancer
    from eabnet_tpu_torch.tools.e2e_demo import device_for

    args = parse_args(argv)
    device = device_for(args.platform)
    for method in METHODS:
        out_dir = os.path.join(args.render_root, method)
        if not os.path.isdir(os.path.join(out_dir, "clean")):
            print(f"[tails] rendering {method}...", flush=True)
            render(args.workdir, method, out_dir, args.items, args.clip,
                   args.workers)
    if args.check:
        check(args.render_root)

    enhancers = {stage: load_enhancer(args.exp_root, output=stage,
                                      device=device)
                 for stage in ("esti0", "esti")}
    rows = {}
    for method in METHODS:
        val_dir = os.path.join(args.render_root, method)
        rows[method] = {"noisy": score(None, val_dir)}
        for stage, enh in enhancers.items():
            print(f"[tails] scoring {method}/{stage}...", flush=True)
            rows[method][stage] = score(enh, val_dir)
    lines = markdown(rows, args.exp_root, args.items)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    return rows


if __name__ == "__main__":
    main()
