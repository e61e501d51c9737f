"""Do the bf16 TCM-chain rules catch the faults they are meant to catch?

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

``base`` is the unchanged copy and must pass; every fault must fail each
per-TCM check. Prints each case's margins over R; exits 1 when a
variant does not do what it must.
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
    return 0 if (cpu() if args.cpu else card()) else 1


if __name__ == "__main__":
    sys.exit(main())
