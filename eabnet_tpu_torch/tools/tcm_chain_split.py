"""Where the first TCM-chain design's time goes, on the card, and how the
package's kernels compare with it.

    python -m eabnet_tpu_torch.tools.tcm_chain_split [--out PATH]

Builds ``tcm_chain_split.cu`` (the first design, with clock64() counters)
by its own ``nvcc -shared`` into ``build/tcm_chain_split/`` and runs it on
the shapes of the main paths, with seeded weights and inputs:

- the backward, twin (EaBNet: K = 5, dilations 1-32, p = 6) and single
  (GaGNet: K = 3, dilations 1, 2, 5, 9, p = 4) at T = 601 for B = 1, 7, 8
  and 16: its blocks, blocks per SM and tile rounds per block; clocks per
  tile and TCM of each phase (A, B, C of the recompute; R1-R4 of the
  reverse walk), split into statistics merges, staging, products,
  weight-gradient work (products and read-modify-writes of the partial
  slots), block-barrier waits, grid.sync() waits and the rest (mean over
  warps); its time without counters (CUDA events), with merges and with
  weight-gradient work knocked out, and of the memset plus partial sum
  alone;
- the forward at T = 701 for B = 1 and 7, the same way (phases A-C);
- beside each, this package's kernel at the same inputs (``_launch_fwd``,
  ``_launch_bwd``): its time, its launch geometry, its largest difference
  from the first design's output (for the forward also from the plain
  version), and its own clocks per tile and TCM by phase (merges, staging,
  products, barrier waits, grid waits, the rest), from a second build of
  ``csrc/tcm_chain.cu`` with ``TCM_CHAIN_CLOCKS`` defined (its counters
  compiled in; the package's build has none).

Writes the numbers as JSON to PATH (default
``build/tcm_chain_split/split.json``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
PHASES = ("A", "B", "C", "R1", "R2", "R3", "R4")
CATS = ("merge", "stage", "product", "wgrad", "barrier", "grid", "other")
NEW_CATS = ("merge", "stage", "product", "barrier", "grid", "other")
GROUPS = {"twin": (True, 5, (1, 2, 4, 8, 16, 32)),
          "single": (False, 3, (1, 2, 5, 9))}
BWD_CASES = [(name, b) for name in ("twin", "single") for b in (1, 7, 8, 16)]
FWD_CASES = [(name, b) for name in ("twin", "single") for b in (1, 7)]
MODES = {"no merges": 1, "no weight-gradient work": 2, "neither": 3}
D, C = 256, 64

_P, _I = ctypes.c_void_p, ctypes.c_int


def nvcc(src: str, lib: str, *flags: str) -> ctypes.CDLL:
    cmd = ["/usr/local/cuda/bin/nvcc", "-gencode",
           "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", *flags, "-o", lib, src]
    log = subprocess.run(cmd, capture_output=True, text=True)
    if log.returncode:
        raise RuntimeError(log.stdout + log.stderr)
    for line in (log.stdout + log.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())
    return ctypes.CDLL(lib)


def build():
    """The first design with counters, and the package's source with its
    counters compiled in, built side by side."""
    out = os.path.join(ROOT, "build", "tcm_chain_split")
    os.makedirs(out, exist_ok=True)
    so = nvcc(os.path.join(HERE, "tcm_chain_split.cu"),
              os.path.join(out, "libsplit.so"))
    new = nvcc(os.path.join(os.path.dirname(HERE), "csrc", "tcm_chain.cu"),
               os.path.join(out, "libnew_clocks.so"), "-DTCM_CHAIN_CLOCKS")
    new.eabnet_tcm_chain_clock_buffer.argtypes = [_P]
    new.eabnet_tcm_chain_clock_buffer.restype = _I
    new.eabnet_tcm_chain_workspace.argtypes = [_I] * 2
    new.eabnet_tcm_chain_workspace.restype = ctypes.c_longlong
    new.eabnet_tcm_chain_bwd_workspace.argtypes = [_I] * 7
    new.eabnet_tcm_chain_bwd_workspace.restype = ctypes.c_longlong
    new.eabnet_tcm_chain_fwd.argtypes = [_P] * 10 + [_I] * 5 + [_P, _I, _P]
    new.eabnet_tcm_chain_fwd.restype = _I
    new.eabnet_tcm_chain_bwd.argtypes = [_P] * 12 + [_I] * 5 + [_P, _I, _P]
    new.eabnet_tcm_chain_bwd.restype = _I
    so.split_grid.argtypes = [_I] * 5 + [_P]
    so.split_grid.restype = _I
    so.split_bwd_workspace.argtypes = [_I] * 6
    so.split_bwd_workspace.restype = ctypes.c_longlong
    so.split_fwd_workspace.argtypes = [_I] * 2
    so.split_fwd_workspace.restype = ctypes.c_longlong
    so.split_fwd.argtypes = [_P] * 5 + [_I] * 5 + [_P] + [_I] * 3 + [_P]
    so.split_fwd.restype = _I
    so.split_bwd.argtypes = [_P] * 7 + [_I] * 5 + [_P] + [_I] * 4 + [_P]
    so.split_bwd.restype = _I
    return so, new


def new_clocks(new, bwd, x, dy, w, dils, twin, geo, stream):
    """One launch of the package's source with counters -> (blocks, 8, 7,
    6) clocks (phases A-C, R1-R4; NEW_CATS)."""
    b, t, _ = x.shape
    k, p = w[1].shape[1], len(dils)
    clk = torch.zeros(geo["blocks"], 8, 7, len(NEW_CATS), dtype=torch.int64,
                      device="cuda")
    dils_c = (ctypes.c_int * p)(*dils)
    ptrs = [v.data_ptr() for v in w]
    err = new.eabnet_tcm_chain_clock_buffer(clk.data_ptr())
    if bwd:
        work = torch.empty(int(new.eabnet_tcm_chain_bwd_workspace(
            b, t, D, k, p, int(twin), 0)), device="cuda")
        dx = torch.empty_like(x)
        grads = torch.empty(sum(v.numel() for v in w), device="cuda")
        err = err or new.eabnet_tcm_chain_bwd(
            x.data_ptr(), dy.data_ptr(), *ptrs, dx.data_ptr(),
            grads.data_ptr(), work.data_ptr(), b, t, D, k, p, dils_c,
            int(twin), stream)
    else:
        work = torch.empty(int(new.eabnet_tcm_chain_workspace(b, t)),
                           device="cuda")
        y = torch.empty_like(x)
        err = err or new.eabnet_tcm_chain_fwd(
            x.data_ptr(), *ptrs, y.data_ptr(), work.data_ptr(), b, t, D, k,
            p, dils_c, int(twin), stream)
    torch.cuda.synchronize()
    err = err or new.eabnet_tcm_chain_clock_buffer(None)
    if err:
        raise RuntimeError(f"counted launch: CUDA error {err}")
    return clk


def events_ms(fn, reps: int = 10) -> float:
    """Mean milliseconds per call of fn over reps calls (CUDA events)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def weights(twin: bool, k: int, p: int, gen) -> tuple:
    """Seeded chain weights in the stacked layout, scaled like an init."""
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(  # noqa: E731
        p, 3, C, generator=gen, device="cuda")
    return (r(p, D, C) / 16, r(p, k, C, C) / (8 * k ** 0.5),
            r(p, k, C, C) / (8 * k ** 0.5), r(p, C, D) / 8,
            u(0.0, 0.5), u(0.5, 1.5), u(-0.5, 0.5))


def clock_table(clk, grid: int, tiles: int, p: int):
    """clk (grid, 8, 7, cats) -> per phase and category, clocks per tile and
    TCM, mean over warps (each block's counts over its own tiles)."""
    n_tiles = torch.tensor([len(range(bk, tiles, grid)) for bk in
                            range(grid)], dtype=torch.float64,
                           device=clk.device).clamp(min=1)
    per = clk.double() / (n_tiles.view(-1, 1, 1, 1) * p)
    return per.mean(dim=(0, 1)).tolist()


def phase_line(tab, phases, cats=CATS) -> str:
    out = []
    for i, ph in enumerate(PHASES):
        if ph not in phases:
            continue
        row = tab[i]
        out.append(f"{ph} {sum(row):.0f} (" + ", ".join(
            f"{c} {v:.0f}" for c, v in zip(cats, row) if v >= 0.5) + ")")
    return "; ".join(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "tcm_chain_split", "split.json"))
    out = ap.parse_args().out
    if not torch.cuda.is_available():
        print("tcm_chain_split: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from eabnet_tpu_torch.kernels import tcm_chain as K

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    so, new = build()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    results = {"device": smi, "sms": n_sm, "bwd": [], "fwd": []}

    def geometry(bwd, twin, k, b, t):
        g = (ctypes.c_int * 2)()
        err = so.split_grid(int(bwd), int(twin), k, b, t, g)
        if err:
            raise RuntimeError(f"split_grid failed: CUDA error {err}")
        tiles = b * -(-t // 16)
        return dict(tiles=tiles, blocks=g[0], blocks_per_sm=g[1],
                    rounds_max=-(-tiles // g[0]),
                    rounds_mean=tiles / g[0])

    for bwd, name, b in ([(False, n, b) for n, b in FWD_CASES]
                         + [(True, n, b) for n, b in BWD_CASES]):
        twin, k, dils = GROUPS[name]
        p = len(dils)
        t = 601 if bwd else 701
        gen = torch.Generator(device="cuda").manual_seed(b * 100 + k)
        w = weights(twin, k, p, gen)
        wptr = (ctypes.c_void_p * 7)(*(v.data_ptr() for v in w))
        dils_c = (ctypes.c_int * p)(*dils)
        x = torch.randn(b, t, D, generator=gen, device="cuda")
        geo = geometry(bwd, twin, k, b, t)
        clk = torch.zeros(geo["blocks"], 8, 7, 7, dtype=torch.int64,
                          device="cuda")
        row = dict(group=name, B=b, T=t, **geo)
        if not bwd:
            y = torch.empty_like(x)
            work = torch.empty(int(so.split_fwd_workspace(b, t)),
                               device="cuda")

            def run(mode, clk_on):
                err = so.split_fwd(x.data_ptr(), wptr, y.data_ptr(),
                                   work.data_ptr(), clk.data_ptr(), b, t, D,
                                   k, p, dils_c, int(twin), mode, clk_on,
                                   stream)
                if err:
                    raise RuntimeError(f"split_fwd: CUDA error {err}")

            run(0, 0)
            ref = K.tcm_chain_reference(x, w, dils, twin)
            row["max_abs_err"] = (y - ref).abs().max().item()
            row["ms"] = events_ms(lambda: run(0, 0), 20)
            row["knockout_ms"] = {m: events_ms(lambda: run(v, 0), 20)
                                  for m, v in (("no merges", 1),)}
            row["clk_ms"] = events_ms(lambda: run(0, 1), 5)
            tab = clock_table(clk, geo["blocks"], geo["tiles"], p)
            row["clocks"] = tab
            pkg = K._launch_fwd(x, w, dils, twin)
            row["package_ms"] = events_ms(
                lambda: K._launch_fwd(x, w, dils, twin), 20)
            row["package_max_abs_err"] = (pkg - ref).abs().max().item()
            row["package_vs_first"] = (pkg - y).abs().max().item()
            results["fwd"].append(row)
            phases = ("A", "B", "C")
        else:
            dy = torch.randn(b, t, D, generator=gen, device="cuda")
            dx = torch.empty_like(x)
            grads = torch.empty(sum(v.numel() for v in w), device="cuda")
            work = torch.empty(int(so.split_bwd_workspace(b, t, D, k, p,
                                                          int(twin))),
                               device="cuda")

            def run(mode, clk_on, stages=3):
                err = so.split_bwd(x.data_ptr(), dy.data_ptr(), wptr,
                                   dx.data_ptr(), grads.data_ptr(),
                                   work.data_ptr(), clk.data_ptr(), b, t, D,
                                   k, p, dils_c, int(twin), mode, clk_on,
                                   stages, stream)
                if err:
                    raise RuntimeError(f"split_bwd: CUDA error {err}")

            run(0, 0)
            first = (dx.clone(), grads.clone())
            reps = 5 if b >= 8 else 10
            row["ms"] = events_ms(lambda: run(0, 0), reps)
            row["knockout_ms"] = {m: events_ms(lambda: run(v, 0), reps)
                                  for m, v in MODES.items()}
            row["memset_sum_ms"] = events_ms(lambda: run(0, 0, 2), reps)
            row["clk_ms"] = events_ms(lambda: run(0, 1), 3)
            tab = clock_table(clk, geo["blocks"], geo["tiles"], p)
            row["clocks"] = tab
            ndx, ndw = K._launch_bwd(x, dy, w, dils, twin)
            row["package_vs_first"] = max(
                (ndx - first[0]).abs().max().item(),
                max((a.flatten() - bb).abs().max().item() for a, bb in zip(
                    ndw, torch.split(first[1], [v.numel() for v in w]))))
            row["package_ms"] = events_ms(
                lambda: K._launch_bwd(x, dy, w, dils, twin), reps)
            results["bwd"].append(row)
            phases = PHASES
        pgeo = K.geometry(b, t, k, twin, bwd)
        row["package_geometry"] = pgeo
        ptab = clock_table(new_clocks(new, bwd, x, dy if bwd else None, w,
                                      dils, twin, pgeo, stream),
                           pgeo["blocks"], pgeo["tiles"], p)
        row["package_clocks"] = ptab
        # SM clock from the counted run: the busiest warp's clocks over the
        # counted kernel's time
        total = clk.double().sum(dim=(2, 3)).max().item()
        ghz = total / (row["clk_ms"] * 1e6)
        row["ghz"] = ghz
        extra = (f", merges knocked out {row['knockout_ms']['no merges']:.4f}"
                 + ("" if not bwd else
                    f", weight-gradient work knocked out "
                    f"{row['knockout_ms']['no weight-gradient work']:.4f}, "
                    f"both {row['knockout_ms']['neither']:.4f}, memset + "
                    f"partial sum alone {row['memset_sum_ms']:.4f}"))
        print(f"{'bwd' if bwd else 'fwd'} {name} B={b} T={t}: "
              f"{geo['tiles']} tiles on {geo['blocks']} blocks "
              f"({geo['blocks_per_sm']} per SM), rounds max "
              f"{geo['rounds_max']} / mean {geo['rounds_mean']:.3f}; first "
              f"design {row['ms']:.4f} ms{extra}; counted {row['clk_ms']:.4f}"
              f" ms at {ghz:.3f} GHz; package {row['package_ms']:.4f} ms "
              f"(max|package-first| {row['package_vs_first']:.3e})",
              flush=True)
        print("  clocks per tile and TCM: " + phase_line(tab, phases),
              flush=True)
        print(f"  package: {pgeo['tiles']} tiles on {pgeo['blocks']} blocks "
              f"({pgeo['blocks_per_sm']} per SM), rounds max "
              f"{pgeo['rounds_max']} / mean {pgeo['rounds_mean']:.3f}; "
              "clocks per tile and TCM: "
              + phase_line(ptab, phases, NEW_CATS), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(dict(phases=PHASES, categories=CATS,
                       package_categories=NEW_CATS, **results), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
