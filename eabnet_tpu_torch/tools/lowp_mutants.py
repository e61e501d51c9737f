"""Do the bf16 rules catch the faults they are meant to catch?

    python -m eabnet_tpu_torch.tools.lowp_mutants          # on the card
    python -m eabnet_tpu_torch.tools.lowp_mutants --cpu    # plain versions

Plants one fault at a time in a copy of this package under
``build/lowp_mutants/<variant>/`` (each copy builds its own kernels under
its own ``build/``) and holds it to the rules the package is held to
(PERF.md §2):

- on the card, the bf16 forward kernel (``csrc/tcm_chain.cu``) of the
  release groups at T = 701, B = 1 and 7, by ``chip_smoke.tcm_lowp_case``
  (each TCM alone at R + 20 dB; the whole chain at min(R + 20, D - 3)).
  Faults: ``trunk``, the trunk rounded to bf16 after every TCM (what a
  bf16 ``y`` buffer would do); ``operand``, the activation operand of
  every product left unrounded (a second bf16 product on the rounding
  residual);
- with ``--cpu``, the plain bf16 version (``kernels/tcm_chain.py``)
  against the JAX package's Pallas kernel, by
  ``tests/test_torch_lowp.py -k tcm`` (that file imports JAX; this tool
  does not). Faults: ``trunk`` as above; ``operand_out`` and
  ``operand_conv``, the out-conv's or the dilated convs' activation
  operand left unrounded.

The bf16 training backwards (PERF.md §2), with their own faults:
``lstm_dgates``, the LSTM-BF walk's dgates left unrounded before the
recurrent products (a second bf16 product on the rounding residual; in
the plain version the unrounded dgates); ``c_f32``, the LSTM-BF training
forward's cell states saved in float32 instead of bf16 (read so by the
backward); ``tcm_wgrad_tiles``, the TCM-chain weight gradients rounded to
bf16 per tile (the GEMM's chunk partials; in the plain version each
16-frame tile's dwo) before their ordered sum instead of once;
``tcm_bwd_trunk``, the trunk the TCM-chain backward recomputes rounded to
bf16 after every TCM (in the plain version, the recomputed trunk of
``_forward_saves``). On the
card they are held to ``chip_smoke.lstm_train_lowp_case`` (L = 1,127)
and ``chip_smoke.tcm_bwd_lowp_case`` (twin and single, B = 7), and to the
bf16 train loss rule (``chip_smoke.bf16_train_rule``: 5 steps of the
release model against the JAX golden); with ``--cpu`` to
``tests/test_torch_lowp_train.py -k "backward or rounded_once"``. Each
fault must fail its kernel's check.

``base`` is the unchanged copy and must pass; every fault must fail each
per-TCM check (the forward's) or its kernel's check (the backward's).
Prints each case's margins over R; exits 1 when a variant does not do
what it must.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(ROOT, "build", "lowp_mutants")
CU = "eabnet_tpu_torch/csrc/tcm_chain.cu"
PY = "eabnet_tpu_torch/kernels/tcm_chain.py"
LCU = "eabnet_tpu_torch/csrc/lstm_bf.cu"
LPY = "eabnet_tpu_torch/kernels/lstm_bf.py"

# variant -> [(file, text, replacement)]; each text occurs once
CARD = {
    "base": [],
    "trunk": [(CU, "        st2(yout + o, xv.x + acc[u][2 * h], "
                   "xv.y + acc[u][2 * h + 1]);",
               """        float y0 = xv.x + acc[u][2 * h];
        float y1 = xv.y + acc[u][2 * h + 1];
        if constexpr (sizeof(W) == 2) {
          y0 = __bfloat162float(__float2bfloat16_rn(y0));
          y1 = __bfloat162float(__float2bfloat16_rn(y1));
        }
        st2(yout + o, y0, y1);""")],
    "operand": [(CU, """  uint32_t a2[2];
  __device__ __forceinline__ void a(const float* t, int S, int k0,
                                    const Lane& l) {""",
                 """  uint32_t a2[2], r2[2];
  __device__ __forceinline__ static float rnd(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ __forceinline__ void a(const float* t, int S, int k0,
                                    const Lane& l) {"""),
                (CU, """    a2[1] = pack_bf16(v.x, v.y);
  }""", """    a2[1] = pack_bf16(v.x, v.y);
    r2[0] = pack_bf16(u.x - rnd(u.x), u.y - rnd(u.y));
    r2[1] = pack_bf16(v.x - rnd(v.x), v.y - rnd(v.y));
  }"""),
                (CU, """    mma_bf16_add(c, a2, lo | hi << 16);""",
                 """    mma_bf16_add(c, a2, lo | hi << 16);
    mma_bf16_add(c, r2, lo | hi << 16);""")],
}
CPU = {
    "base": [],
    "trunk": [(PY, """        x = x + _operand(no, lowp) @ wo[j]
""", """        x = x + _operand(no, lowp) @ wo[j]
        x = _operand(x, lowp)
""")],
    "operand_out": [(PY, "x = x + _operand(no, lowp) @ wo[j]",
                     "x = x + no @ wo[j]")],
    "operand_conv": [(PY, "_causal_conv(_operand(n, lowp), w[j], dil)",
                      "_causal_conv(n, w[j], dil)")],
}

# the backward faults: variant -> (patches on the card, patches of the
# plain versions, the kernel whose check must fail)
BWD = {
    "base": ([], [], None),
    "lstm_dgates": ([(LCU, """  uint32_t a[2];
  __device__ __forceinline__ void load(const float* p, bool r0, bool r1) {
    a[0] = a_word(p, r0);
    a[1] = a_word(p + 8 * SD, r1);
  }
  __device__ __forceinline__ void mma(float* acc, uint32_t b) const {
    mma_bf16(acc, a, b);
  }""", """  uint32_t a[2], r[2];
  __device__ __forceinline__ static float rnd(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ __forceinline__ void load(const float* p, bool r0, bool r1) {
    a[0] = a_word(p, r0);
    a[1] = a_word(p + 8 * SD, r1);
    const float2 u = ld2(p, r0), v = ld2(p + 8 * SD, r1);
    r[0] = pack_bf16(u.x - rnd(u.x), u.y - rnd(u.y));
    r[1] = pack_bf16(v.x - rnd(v.x), v.y - rnd(v.y));
  }
  __device__ __forceinline__ void mma(float* acc, uint32_t b) const {
    mma_bf16(acc, a, b);
    mma_bf16(acc, r, b);
  }""")],
                    [(LPY, """        dg2 = _operand(dg2, lowp)  # the operand of every product below
        dh2 = dg2 @ w_hh2.t()
        dg1, dc1 = _cell_bwd(dh1 + dg2 @ w_ih2.t(), dc1, c1p, c1[s], gates1)
        dg1 = _operand(dg1, lowp)
        dh1 = dg1 @ w_hh1.t()""", """        dh2 = dg2 @ w_hh2.t()
        dg1, dc1 = _cell_bwd(dh1 + dg2 @ w_ih2.t(), dc1, c1p, c1[s], gates1)
        dh1 = dg1 @ w_hh1.t()
        dg2 = _operand(dg2, lowp)
        dg1 = _operand(dg1, lowp)""")], "lstm"),
    "c_f32": ([(LCU, "using CSave = bf16;", "using CSave = float;"),
               (LPY, "    dtypes = (xw1.dtype,) * 4",
                "    dtypes = (xw1.dtype, torch.float32) * 2")],
              [(LPY, """    return tuple(torch.stack(s).to(out_dtype) for s in seqs)""",
                """    return tuple(torch.stack(s).to(out_dtype if i % 2 == 0
                                   else xw1.dtype)
                 for i, s in enumerate(seqs))""")], "lstm"),
    "tcm_wgrad_tiles": ([(CU, """__device__ __forceinline__ void part_store(float* p, float u, float v) {
  st2(p, u, v);""", """__device__ __forceinline__ void part_store(float* p, float u, float v) {
  st2(p, __bfloat162float(__float2bfloat16_rn(u)),
      __bfloat162float(__float2bfloat16_rn(v)));""")],
                        [(PY, """        dwo[j] += torch.einsum("btc,btd->cd", _operand(s["no"], lowp), dyr)""",
                          """        no_r, t_ = _operand(s["no"], lowp), dyr.shape[1]
        dwo[j] += sum(_operand(torch.einsum(
            "btc,btd->cd", no_r[:, i:i + 16], dyr[:, i:i + 16]), lowp)
            for i in range(0, t_, 16))""")], "tcm"),
    "tcm_bwd_trunk": ([(CU, """        st2(yout + o, xv.x + acc[u][2 * h], xv.y + acc[u][2 * h + 1]);""",
                        """        float y0 = xv.x + acc[u][2 * h], y1 = xv.y + acc[u][2 * h + 1];
        if constexpr (sizeof(W) == 2) {  // the backward's trunk update
          if (static_cast<const void*>(xin) != static_cast<const void*>(yout)) {
            y0 = __bfloat162float(__float2bfloat16_rn(y0));
            y1 = __bfloat162float(__float2bfloat16_rn(y1));
          }
        }
        st2(yout + o, y0, y1);""")],
                      [(PY, """        x = x + _operand(s["no"], lowp) @ wo[j]
        saves.append(s)""", """        x = _operand(x + _operand(s["no"], lowp) @ wo[j], lowp)
        saves.append(s)""")], "tcm"),
}

CHILD_BWD = """
import json, os, sys
sys.path.insert(0, sys.argv[1]); sys.path.append(sys.argv[2])
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import eabnet_tpu_torch
assert eabnet_tpu_torch.__file__.startswith(sys.argv[1])
import chip_smoke as cs
from eabnet_tpu_torch.checkpoint import latest_checkpoint, load_params
from eabnet_tpu_torch.config import ExperimentConfig
from eabnet_tpu_torch.models import build_model
from eabnet_tpu_torch.weights import load_jax_params
exp = sys.argv[2] + "/release/composed_9mic"
cfg = ExperimentConfig.load(exp + "/config.json")
m = load_jax_params(build_model(cfg.model),
                    load_params(latest_checkpoint(exp))).cuda()
out = {}
with torch.no_grad():
    r = cs.lstm_train_lowp_case(m.eabnet.bf_map, 7 * 161, 601, 41)
    out["lstm"] = dict(ok=bool(r["ok"]), margins=[
        q["snr"] - q["r"] for q in r["fwd"] + r["bwd"]], needs=[
        q["need"] - q["r"] for q in r["fwd"] + r["bwd"]])
    for key, g, seed in (("twin", m.eabnet.stcn_0, 45),
                         ("single", m.postnet.gag_0.glance.tcn_0, 49)):
        r = cs.tcm_bwd_lowp_case(g, 7, 601, seed)
        out[key] = dict(ok=bool(r["ok"]), each=r["each_margins"],
                        trunk=r["trunk_margins"], wgrad=min(
                            min(m.values()) for m in r["each_wgrad_margins"]
                            if m),
                        sums=r["sums"],
                        chain={n: (q["snr"] - q["r"], q["need"] - q["r"])
                               for n, q in zip(("dx",) + cs.TCM_GRADS,
                                               r["chain"])})
del m
out["loss"] = cs.bf16_train_rule(sys.argv[3])
print("RESULT " + json.dumps(out))
"""


def card_bwd() -> bool:
    ok = True
    for variant, (patches, _, kernel) in BWD.items():
        dest = plant(variant, patches, ("release", "tests"))
        run = subprocess.run([sys.executable, "-c", CHILD_BWD, dest, ROOT,
                              variant], cwd=dest, capture_output=True,
                             text=True)
        line = [s for s in run.stdout.splitlines() if s.startswith("RESULT")]
        if run.returncode or not line:
            print(f"{variant}: did not run\n{run.stderr[-3000:]}")
            ok = False
            continue
        res = json.loads(line[0][len("RESULT "):])
        lm = res["lstm"]
        print(f"{variant} lstm (h1, c1, h2, c2, dxw1, dw_hh1, dw_ih2, "
              f"dw_hh2, db2): R + "
              f"{', '.join(f'{a:.2f}' for a in lm['margins'])} (needs R + "
              f"{', '.join(f'{a:.2f}' for a in lm['needs'])}) "
              f"({'pass' if lm['ok'] else 'FAIL'})")
        for key in ("twin", "single"):
            r = res[key]
            print(f"{variant} tcm {key}: recomputed trunk R + "
                  f"{', '.join(f'{a:.2f}' for a in r['trunk'])}; each TCM's "
                  f"dx R + {', '.join(f'{a:.2f}' for a in r['each'])}; "
                  f"each TCM's weight gradients at least R + "
                  f"{r['wgrad']:.2f}; each TCM's "
                  f"dwo against its operands' float64 sum "
                  f"{', '.join(f'{a:.2f}' for a in r['sums'])} dB; chain "
                  + ", ".join(f"{n} R + {a:.2f} (needs {b:.2f})"
                              for n, (a, b) in r["chain"].items())
                  + f" ({'pass' if r['ok'] else 'FAIL'})")
        loss = res["loss"]
        print(f"{variant} train loss rule: R {loss['r']:.2f} dB, vs JAX bf16 "
              f"{loss['s16']:.2f}, vs JAX float32 {loss['s32']:.2f} "
              f"({'pass' if loss['ok'] else 'FAIL'})")
        checks = {"lstm": lm["ok"],
                  "tcm": res["twin"]["ok"] and res["single"]["ok"]}
        want = (all(checks.values()) and loss["ok"] if kernel is None
                else not checks[kernel])
        ok &= want
        print(f"{variant}: {'as it must' if want else 'NOT as it must'}")
    return ok


def cpu_bwd() -> bool:
    ok = True
    links = ("eabnet_tpu", "tests", "release", "pyproject.toml")
    for variant, (_, patches, kernel) in BWD.items():
        dest = plant("cpu_" + variant, patches, links)
        run = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-s", "-p",
             "no:cacheprovider", "-k", "backward or rounded_once", "-rA",
             "tests/test_torch_lowp_train.py"],
            cwd=dest, capture_output=True, text=True)
        res = re.findall(r"^(PASSED|FAILED) \S+::(\S+)", run.stdout, re.M)
        for status, name in res:
            print(f"{variant}: {status} {name}")
        mine = [s == "PASSED" for s, n in res if kernel and kernel in n]
        want = bool(res) and (all(s == "PASSED" for s, _ in res)
                              if kernel is None
                              else bool(mine) and not all(mine))
        ok &= want
        print(f"{variant}: {'as it must' if want else 'NOT as it must'}")
    return ok


# run in a copy: its package first on sys.path, then the repo's root
CHILD = """
import json, sys
sys.path.insert(0, sys.argv[1]); sys.path.append(sys.argv[2])
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import eabnet_tpu_torch
assert eabnet_tpu_torch.__file__.startswith(sys.argv[1])
import chip_smoke as cs
from eabnet_tpu_torch.checkpoint import latest_checkpoint, load_params
from eabnet_tpu_torch.config import ExperimentConfig
from eabnet_tpu_torch.models import build_model
from eabnet_tpu_torch.weights import load_jax_params
exp = sys.argv[2] + "/release/composed_9mic"
cfg = ExperimentConfig.load(exp + "/config.json")
m = load_jax_params(build_model(cfg.model),
                    load_params(latest_checkpoint(exp))).cuda()
out = {}
with torch.no_grad():
    single = m.postnet.gag_0.glance.tcn_0
    for key, g, b, seed in (("twin_1", m.eabnet.stcn_0, 1, 33),
                            ("twin_7", m.eabnet.stcn_0, 7, 34),
                            ("single_1", single, 1, 35),
                            ("single_7", single, 7, 36)):
        r = cs.tcm_lowp_case(g, b, 701, seed)
        out[key] = dict(chain_ok=bool(r["snr"] >= r["need"]),
                        chain_margin=r["snr"] - r["r"],
                        chain_need=r["need"] - r["r"],
                        each_margins=[s - q for s, q in
                                      zip(r["each_snr"], r["each_r"])],
                        each_ok=bool(r["each_ok"]))
print("RESULT " + json.dumps(out))
"""


def plant(variant: str, patches, links) -> str:
    """A copy of the package with ``patches`` applied, and links to the
    repo's ``links``; -> the copy's root."""
    dest = os.path.join(OUT, variant)
    shutil.rmtree(dest, ignore_errors=True)
    os.makedirs(dest)
    shutil.copytree(os.path.join(ROOT, "eabnet_tpu_torch"),
                    os.path.join(dest, "eabnet_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for path, old, new in patches:
        f = os.path.join(dest, path)
        text = open(f).read()
        if text.count(old) != 1:
            raise RuntimeError(f"{variant}: the text to replace occurs "
                               f"{text.count(old)} times in {path}")
        with open(f, "w") as fh:
            fh.write(text.replace(old, new))
    for name in links:
        os.symlink(os.path.join(ROOT, name), os.path.join(dest, name))
    return dest


def card() -> bool:
    ok = True
    for variant, patches in CARD.items():
        dest = plant(variant, patches, ())
        run = subprocess.run([sys.executable, "-c", CHILD, dest, ROOT],
                             cwd=dest, capture_output=True, text=True)
        line = [s for s in run.stdout.splitlines() if s.startswith("RESULT")]
        if run.returncode or not line:
            print(f"{variant}: did not run\n{run.stderr[-3000:]}")
            ok = False
            continue
        res = json.loads(line[0][len("RESULT "):])
        for key, r in res.items():
            print(f"{variant} {key}: each TCM R + "
                  f"{', '.join(f'{m:.2f}' for m in r['each_margins'])} "
                  f"({'pass' if r['each_ok'] else 'FAIL'}); whole chain "
                  f"R + {r['chain_margin']:.2f}, needs R + "
                  f"{r['chain_need']:.2f} "
                  f"({'pass' if r['chain_ok'] else 'FAIL'})")
        each = [r["each_ok"] for r in res.values()]
        chain = [r["chain_ok"] for r in res.values()]
        want = all(each) and all(chain) if variant == "base" else \
            not any(each)
        ok &= want
        print(f"{variant}: {'as it must' if want else 'NOT as it must'}")
    return ok


def cpu() -> bool:
    ok = True
    links = ("eabnet_tpu", "tests", "release", "pyproject.toml")
    for variant, patches in CPU.items():
        dest = plant(variant, patches, links)
        run = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-s", "-p",
             "no:cacheprovider", "-k", "tcm and not keeps", "-rA",
             "tests/test_torch_lowp.py"],
            cwd=dest, capture_output=True, text=True)
        for m in re.findall(r"(tcm (?:\d+|chain): R [^\n]*)", run.stdout):
            print(f"{variant}: {m}")
        res = re.findall(r"^(PASSED|FAILED) \S+::(\S+)", run.stdout, re.M)
        for status, name in res:
            print(f"{variant}: {status} {name}")
        each = [s == "PASSED" for s, n in res if "each_tcm" in n]
        want = bool(res) and (all(s == "PASSED" for s, _ in res)
                              if variant == "base"
                              else bool(each) and not any(each))
        ok &= want
        print(f"{variant}: {'as it must' if want else 'NOT as it must'}")
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="the plain versions against the Pallas kernel")
    args = ap.parse_args()
    if not args.cpu:
        import torch

        if not torch.cuda.is_available():
            print("lowp_mutants: needs a CUDA device (or --cpu)",
                  file=sys.stderr)
            return 2
    if args.cpu:
        return 0 if cpu() & cpu_bwd() else 1
    return 0 if card() & card_bwd() else 1


if __name__ == "__main__":
    sys.exit(main())
