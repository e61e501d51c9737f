"""Reference PyTorch checkpoint (``.pth``) -> the JAX package's parameter
tree, in the port.

Consumes a reference `state_dict` (as produced by the reference trainer's
`save_checkpoint`, train_distributed.py:30-45 — optionally with DDP
`module.` prefixes) and emits the flax-layout param tree (nested dicts of
numpy arrays) that the JAX package's converter emits;
``weights.load_jax_params`` then loads it into the port's modules, as it
loads a ``.params`` file; ``export_torch_state_dict`` goes the other way,
by probing these converters. The port's own copy of the JAX package's
``utils/convert_torch.py``; ``tests/test_torch_pth.py`` and
``tests/test_torch_heads.py`` hold the two packages' trees and state
dicts equal, array for array.

Layout transforms handled here (and only here):
- Conv2d   (O,I,kh,kw)  -> HWIO kernel (kh,kw,I,O)
- ConvT2d  (I,O,kh,kw)  -> spatially flipped (kh,kw,I,O) (lax.conv_transpose
  with transpose_kernel=False computes the un-flipped correlation)
- Conv1d   (O,I,k)      -> (k,I,O);  1x1 convs/Linears -> Dense (I,O)
- LSTM     weight_*_l0 (4H,*) -> (*,4H); gate order (i,f,g,o) is shared
- first-conv input channels: reference folds (ri, mic) ri-major
  (EaBNet.py:96-97), this framework folds mic-major -> row permutation
- bottleneck flatten: reference is channel-major (c*F'+f, EaBNet.py:100),
  this framework is freq-major (f*C+c) -> row/col permutation on every
  TCM pointwise conv that crosses the (B,T,d_feat) boundary, and on the
  glance/gaze input projections (GaGNet.py:83).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from eabnet_tpu_torch.config import ComposedConfig, EaBNetConfig, GaGNetConfig


# ----------------------------------------------------------------- helpers

def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def conv2d_w(w) -> np.ndarray:
    return _np(w).transpose(2, 3, 1, 0)


def convt2d_w(w) -> np.ndarray:
    return _np(w).transpose(2, 3, 0, 1)[::-1, ::-1].copy()


def conv1d_w(w) -> np.ndarray:
    return _np(w).transpose(2, 1, 0)


def dense_w(w) -> np.ndarray:
    w = _np(w)
    if w.ndim >= 3:  # 1x1 conv1d/conv2d
        w = w.reshape(w.shape[0], w.shape[1])
    return w.T.copy()


def mic_fold_perm(m: int) -> np.ndarray:
    """perm[mine] = theirs for the (mic, ri) channel fold."""
    mine = np.arange(2 * m)
    mic, ri = mine // 2, mine % 2
    return ri * m + mic


def bottleneck_perm(f: int, c: int) -> np.ndarray:
    """perm[mine] = theirs for the (F', C) -> d_feat flatten."""
    mine = np.arange(f * c)
    ff, cc = mine // c, mine % c
    return cc * f + ff


class _Ref:
    """Accessor over the torch state_dict with DDP-prefix stripping."""

    def __init__(self, sd: Mapping[str, "np.ndarray"]):
        self.sd = {
            (k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items()
        }
        self.used = set()

    def __call__(self, key: str) -> np.ndarray:
        self.used.add(key)
        return self.sd[key]

    def has(self, key: str) -> bool:
        return key in self.sd

    def unused(self):
        return sorted(set(self.sd) - self.used)


# ------------------------------------------------------- block converters

def _norm(ref: _Ref, key: str) -> Dict:
    # BN/IN affine params are `<key>.weight`; the reference's cumulative
    # norms name theirs `<key>.gain` with broadcast shape (1,C,1[,1])
    # (reference: EaBNet.py:707-709, 743-745) — flatten both to (C,)
    attr = "weight" if ref.has(f"{key}.weight") else "gain"
    return {"norm": {"scale": _np(ref(f"{key}.{attr}")).reshape(-1),
                     "bias": _np(ref(f"{key}.bias")).reshape(-1)}}


def _gate_conv(ref: _Ref, key: str, k_t: int, transposed: bool,
               in_perm: np.ndarray | None = None) -> Dict:
    # GateConv2d: Sequential(pad, conv) when k_t>1 else bare conv
    # GateConvTranspose2d: Sequential(convT, chomp) when k_t>1 else bare
    idx = (0 if transposed else 1) if k_t > 1 else None
    sub = f"{key}.conv.{idx}" if idx is not None else f"{key}.conv"
    w = (convt2d_w if transposed else conv2d_w)(ref(f"{sub}.weight"))
    if in_perm is not None:
        w = w[:, :, in_perm, :]
    return {"conv": {"kernel": w, "bias": _np(ref(f"{sub}.bias"))}}


def _conv_unit(ref: _Ref, key: str, transposed: bool) -> Dict:
    attr = "deconv" if transposed else "conv"
    w_fn = convt2d_w if transposed else conv2d_w
    return {
        "conv": {"kernel": w_fn(ref(f"{key}.{attr}.0.weight")),
                 "bias": _np(ref(f"{key}.{attr}.0.bias"))},
        "norm": _norm(ref, f"{key}.{attr}.1.norm"),
        "act": {"alpha": _np(ref(f"{key}.{attr}.2.weight"))},
    }


def _en_unet_module(ref: _Ref, key: str, scale: int, is_deconv: bool,
                    in_perm: np.ndarray | None = None) -> Dict:
    out: Dict = {
        "in_conv": _gate_conv(ref, f"{key}.in_conv.0", k_t=2,
                              transposed=is_deconv, in_perm=in_perm),
        "in_norm": _norm(ref, f"{key}.in_conv.1.norm"),
        "in_act": {"alpha": _np(ref(f"{key}.in_conv.2.weight"))},
    }
    for j in range(scale):
        out[f"enco_{j}"] = _conv_unit(ref, f"{key}.enco.{j}", False)
        out[f"deco_{j}"] = _conv_unit(ref, f"{key}.deco.{j}", True)
    return out


def _u2_encoder(ref: _Ref, key: str,
                in_perm: np.ndarray | None = None) -> Dict:
    out: Dict = {}
    for i, scale in enumerate((4, 3, 2, 1)):
        out[f"unet_{i}"] = _en_unet_module(
            ref, f"{key}.meta_unet_list.{i}", scale, False,
            in_perm=in_perm if i == 0 else None,
        )
    out["last_conv"] = _gate_conv(ref, f"{key}.last_conv.0", 2, False)
    out["last_norm"] = _norm(ref, f"{key}.last_conv.1.norm")
    out["last_act"] = {"alpha": _np(ref(f"{key}.last_conv.2.weight"))}
    return out


def _unet_encoder(ref: _Ref, key: str, norm_stages,
                  in_perm: np.ndarray | None = None) -> Dict:
    out: Dict = {}
    for i in range(5):
        base = f"{key}.unet_list.{i}"
        out[f"conv_{i}"] = _gate_conv(
            ref, f"{base}.0", 2, False,
            in_perm=in_perm if i == 0 else None,
        )
        prelu_idx = 1
        if norm_stages[i]:
            out[f"norm_{i}"] = _norm(ref, f"{base}.1.norm")
            prelu_idx = 2
        out[f"act_{i}"] = {"alpha": _np(ref(f"{base}.{prelu_idx}.weight"))}
    return out


def _u2_decoder(ref: _Ref, key: str) -> Dict:
    out: Dict = {}
    for i, scale in enumerate((1, 2, 3, 4)):
        out[f"unet_{i}"] = _en_unet_module(
            ref, f"{key}.meta_unet_list.{i}", scale, True
        )
    out["last_conv"] = _gate_conv(ref, f"{key}.last_conv.0", 2, True)
    out["last_norm"] = _norm(ref, f"{key}.last_conv.1.norm")
    out["last_act"] = {"alpha": _np(ref(f"{key}.last_conv.2.weight"))}
    return out


def _unet_decoder(ref: _Ref, key: str) -> Dict:
    out: Dict = {}
    for i in range(5):
        base = f"{key}.unet_list.{i}"
        out[f"conv_{i}"] = _gate_conv(ref, f"{base}.0", 2, True)
        out[f"norm_{i}"] = _norm(ref, f"{base}.1.norm")
        out[f"act_{i}"] = {"alpha": _np(ref(f"{base}.2.weight"))}
    return out


def _tcm_twin(ref: _Ref, key: str, perm: np.ndarray | None) -> Dict:
    """EaBNet twin-gate TCM (left_conv/right_conv/out_conv)."""
    def branch(name):
        return {
            f"{name}_act": {"alpha": _np(ref(f"{key}.{name}_conv.0.weight"))},
            f"{name}_norm": _norm(ref, f"{key}.{name}_conv.1.norm"),
            f"{name}_conv": {
                "kernel": conv1d_w(ref(f"{key}.{name}_conv.3.weight"))
            },
        }

    w_in = dense_w(ref(f"{key}.in_conv.weight"))
    w_out = dense_w(ref(f"{key}.out_conv.2.weight"))
    if perm is not None:
        w_in = w_in[perm, :]
        w_out = w_out[:, perm]
    out = {"in_conv": {"kernel": w_in}}
    out.update(branch("left"))
    out.update(branch("right"))
    out["out_act"] = {"alpha": _np(ref(f"{key}.out_conv.0.weight"))}
    out["out_norm"] = _norm(ref, f"{key}.out_conv.1.norm")
    out["out_conv"] = {"kernel": w_out}
    return out


def _tcm_single(ref: _Ref, key: str) -> Dict:
    """GaGNet single-branch TCM (d_conv/out_conv)."""
    return {
        "in_conv": {"kernel": dense_w(ref(f"{key}.in_conv.weight"))},
        "main_act": {"alpha": _np(ref(f"{key}.d_conv.0.weight"))},
        "main_norm": _norm(ref, f"{key}.d_conv.1.norm"),
        "main_conv": {"kernel": conv1d_w(ref(f"{key}.d_conv.3.weight"))},
        "out_act": {"alpha": _np(ref(f"{key}.out_conv.0.weight"))},
        "out_norm": _norm(ref, f"{key}.out_conv.1.norm"),
        "out_conv": {"kernel": dense_w(ref(f"{key}.out_conv.2.weight"))},
    }


def _lstm(ref: _Ref, key: str) -> Dict:
    return {
        "w_ih": _np(ref(f"{key}.weight_ih_l0")).T.copy(),
        "w_hh": _np(ref(f"{key}.weight_hh_l0")).T.copy(),
        "b_ih": _np(ref(f"{key}.bias_ih_l0")),
        "b_hh": _np(ref(f"{key}.bias_hh_l0")),
    }


# ----------------------------------------------------------- model-level

def convert_eabnet(sd: Mapping, cfg: EaBNetConfig,
                   prefix: str = "") -> Dict:
    """torch state_dict -> flax-layout params dict of EaBNet."""
    ref = _Ref({k: v for k, v in sd.items()})
    p = prefix
    in_perm = mic_fold_perm(cfg.M)
    # bottleneck freq size after 5 freq-halvings of 161 bins
    f_bottle = cfg.d_feat // 64
    bperm = bottleneck_perm(f_bottle, 64)

    out: Dict = {}
    if cfg.is_u2:
        out["en"] = _u2_encoder(ref, f"{p}en", in_perm)
        out["de"] = _u2_decoder(ref, f"{p}de")
    else:
        out["en"] = _unet_encoder(
            ref, f"{p}en", (True, False, False, True, True), in_perm
        )
        out["de"] = _unet_decoder(ref, f"{p}de")

    for i in range(cfg.q):
        grp: Dict = {}
        for j in range(cfg.p):
            key = f"{p}stcns.{i}.tcm_list.{j}"
            # the d_feat boundary permutation applies to every TCM: its
            # in/out pointwise convs are the only ops crossing (B,T,d_feat)
            grp[f"tcm_{j}"] = _tcm_twin(ref, key, bperm)
        out[f"stcn_{i}"] = grp

    if cfg.topo_type == "mimo" and cfg.bf_type == "lstm":
        out["bf_map"] = {
            "norm": {"scale": _np(ref(f"{p}bf_map.norm.weight")),
                     "bias": _np(ref(f"{p}bf_map.norm.bias"))},
            "rnn1": _lstm(ref, f"{p}bf_map.rnn1"),
            "rnn2": _lstm(ref, f"{p}bf_map.rnn2"),
            "fc1": {"kernel": dense_w(ref(f"{p}bf_map.w_dnn.0.weight")),
                    "bias": _np(ref(f"{p}bf_map.w_dnn.0.bias"))},
            "fc2": {"kernel": dense_w(ref(f"{p}bf_map.w_dnn.2.weight")),
                    "bias": _np(ref(f"{p}bf_map.w_dnn.2.bias"))},
        }
    else:  # pointwise conv head
        out["bf_map"] = {
            "kernel": dense_w(ref(f"{p}bf_map.weight")),
            "bias": _np(ref(f"{p}bf_map.bias")),
        }
    return out


def convert_gagnet(sd: Mapping, cfg: GaGNetConfig,
                   prefix: str = "") -> Dict:
    """torch state_dict -> flax-layout params dict of GaGNet."""
    ref = _Ref({k: v for k, v in sd.items()})
    p = prefix
    f_bottle = cfg.d_feat // 64
    bperm = bottleneck_perm(f_bottle, 64)
    ci = cfg.freq_bins * 2 + cfg.d_feat
    # input rows: [feat (perm), pre_flat (identity)]
    in_perm = np.concatenate([bperm, np.arange(cfg.d_feat, ci)])

    out: Dict = {}
    if cfg.is_u2:
        out["en"] = _u2_encoder(ref, f"{p}en")
    else:
        out["en"] = _unet_encoder(ref, f"{p}en", (True,) * 5)

    def tcn_groups(base: str, n: int, myname: str, dst: Dict):
        for j in range(n):
            grp: Dict = {}
            for l in range(len(cfg.dilas)):
                grp[f"tcm_{l}"] = _tcm_single(ref, f"{base}.{j}.tcns.{l}")
            dst[f"{myname}_{j}"] = grp

    for i in range(cfg.q):
        g = f"{p}gags.{i}"
        glance: Dict = {
            "in_main": {
                "kernel": dense_w(
                    ref(f"{g}.glance_block.in_conv_main.weight")
                )[in_perm, :],
                "bias": _np(ref(f"{g}.glance_block.in_conv_main.bias")),
            },
            "in_gate": {
                "kernel": dense_w(
                    ref(f"{g}.glance_block.in_conv_gate.0.weight")
                )[in_perm, :],
                "bias": _np(ref(f"{g}.glance_block.in_conv_gate.0.bias")),
            },
            "head": {
                "kernel": dense_w(ref(f"{g}.glance_block.linear_g.0.weight")),
                "bias": _np(ref(f"{g}.glance_block.linear_g.0.bias")),
            },
        }
        tcn_groups(f"{g}.glance_block.tcn_g", cfg.p, "tcn", glance)

        gaze: Dict = {
            "in_main": {
                "kernel": dense_w(
                    ref(f"{g}.gaze_block.in_conv_main.weight")
                )[in_perm, :],
                "bias": _np(ref(f"{g}.gaze_block.in_conv_main.bias")),
            },
            "in_gate": {
                "kernel": dense_w(
                    ref(f"{g}.gaze_block.in_conv_gate.0.weight")
                )[in_perm, :],
                "bias": _np(ref(f"{g}.gaze_block.in_conv_gate.0.bias")),
            },
            "head_r": {
                "kernel": dense_w(ref(f"{g}.gaze_block.linear_r.weight")),
                "bias": _np(ref(f"{g}.gaze_block.linear_r.bias")),
            },
            "head_i": {
                "kernel": dense_w(ref(f"{g}.gaze_block.linear_i.weight")),
                "bias": _np(ref(f"{g}.gaze_block.linear_i.bias")),
            },
        }
        if cfg.is_squeezed:
            tcn_groups(f"{g}.gaze_block.tcm_ri", cfg.p, "tcn_ri", gaze)
        else:
            tcn_groups(f"{g}.gaze_block.tcm_r", cfg.p, "tcn_r", gaze)
            tcn_groups(f"{g}.gaze_block.tcm_i", cfg.p, "tcn_i", gaze)
        out[f"gag_{i}"] = {"glance": glance, "gaze": gaze}
    return out


def convert_composed(sd: Mapping, cfg: ComposedConfig) -> Dict:
    """torch state_dict of the composed model -> flax params
    ({'eabnet': ..., 'postnet': ...})."""
    sd = {
        (k[len("module."):] if k.startswith("module.") else k): v
        for k, v in sd.items()
    }
    eab = {k: v for k, v in sd.items() if k.startswith("eabnet.")}
    gag = {k: v for k, v in sd.items() if k.startswith("postnet.")}
    return {
        "eabnet": convert_eabnet(eab, cfg.eabnet, prefix="eabnet."),
        "postnet": convert_gagnet(gag, cfg.gagnet, prefix="postnet."),
    }


def _warn_cln_interop(cfg) -> None:
    """norm_type="cLN" intentionally diverges from the reference's
    cumulative norm: a virtual-frame variance prior stabilizes early-
    frame gradients (nn/norms.py; the reference's own cLN branch crashes
    as written, EaBNet.py:689-691, and its intended math at
    EaBNet.py:717-726 has no prior). Converted cLN checkpoints therefore
    produce different activations across the torch<->flax boundary —
    largest at the first frames, decaying ~1/t (pinned in
    tests/test_parity_cln.py). norm_type="cLN-ref" is bit-exact."""
    import warnings

    norms = set()
    for sub in ("eabnet", "gagnet"):
        m = getattr(cfg, sub, None)
        if m is not None:
            norms.add(m.norm_type)
    if norms == set():  # bare EaBNetConfig / GaGNetConfig
        norms.add(getattr(cfg, "norm_type", None))
    if "cLN" in norms:
        warnings.warn(
            "norm_type='cLN' uses a virtual-frame variance prior that the "
            "reference's cumulative norm does not (gradient stabilization; "
            "see nn/norms.py). Converted checkpoints will NOT be "
            "numerically identical across the torch<->flax boundary at "
            "early frames (divergence decays ~1/t). For exact interop use "
            "norm_type='cLN-ref'. Either way the reference stack needs "
            "the NormSwitch repair in utils/reference_compat.py to run "
            "cumulative norms at all (its cLN wiring crashes as written, "
            "reference EaBNet.py:689-691, and its GaGNet has no cLN "
            "branch).",
            stacklevel=3,
        )


def load_torch_checkpoint(path: str, cfg: ComposedConfig) -> Dict:
    """Load a reference `<iter>.pth` checkpoint file and convert it.

    Requires torch (CPU) for unpickling; returns {'params': pytree}.
    """
    import torch

    _warn_cln_interop(cfg)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model_state_dict", ckpt)
    return {"params": convert_composed(sd, cfg)}


# ----------------------------------------------------- reverse (export)

def _flatten_tree(d, path=()):
    if isinstance(d, Mapping):
        for k in sorted(d):
            yield from _flatten_tree(d[k], path + (str(k),))
    else:
        yield path, np.asarray(d)


def _np_keep_dtype(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def export_torch_state_dict(params, cfg, template_sd):
    """flax params -> reference torch ``state_dict`` values (numpy).

    The exact inverse of :func:`convert_composed` /
    :func:`convert_eabnet` / :func:`convert_gagnet`, derived
    mechanically rather than re-implemented: the forward converter is
    probed with unique integer ids (exact in float32 below 2**24), which
    yields, for every element of every flax leaf, its source position in
    the torch tensors; the real parameter values are then scattered back
    through that index map. This cannot drift from the forward path —
    any transform added there (transposes, kernel flips, channel-fold /
    bottleneck permutations) is inverted automatically, and a transform
    that stops being a per-tensor bijection is detected and rejected.

    ``template_sd`` supplies the reference model's exact key names,
    shapes, and dtypes — e.g. ``make_eabnet_with_postnet(args).
    state_dict()`` (reference: EaBNet.py:815). Returns
    ``(state_dict, unmapped_keys)``: keys the forward converter never
    reads (none for the shipped configs) keep their template values.
    """
    keys = list(template_sd.keys())
    tmpl = {k: _np_keep_dtype(template_sd[k]) for k in keys}
    offsets, off = {}, 0
    for k in keys:
        offsets[k] = off
        off += int(tmpl[k].size)
    total = off
    if total >= 2 ** 24:
        raise ValueError(
            f"{total} probe ids exceed float32's exact-integer range"
        )
    probe = {
        k: np.arange(offsets[k] + 1, offsets[k] + 1 + tmpl[k].size,
                     dtype=np.float32).reshape(tmpl[k].shape)
        for k in keys
    }
    if isinstance(cfg, ComposedConfig):
        fwd = lambda sd: convert_composed(sd, cfg)  # noqa: E731
    elif isinstance(cfg, EaBNetConfig):
        fwd = lambda sd: convert_eabnet(sd, cfg)  # noqa: E731
    elif isinstance(cfg, GaGNetConfig):
        fwd = lambda sd: convert_gagnet(sd, cfg)  # noqa: E731
    else:
        raise TypeError(f"unsupported config type {type(cfg).__name__}")

    idx_tree = dict(_flatten_tree(fwd(probe)))
    par_tree = dict(_flatten_tree(params))
    if set(idx_tree) != set(par_tree):
        diff = sorted(
            "/".join(p) for p in set(idx_tree) ^ set(par_tree)
        )[:8]
        raise ValueError(f"param tree mismatch vs converter output: {diff}")

    flat = np.zeros(total, np.float64)
    written = np.zeros(total, bool)
    for path, ids in idx_tree.items():
        ii = ids.astype(np.int64).ravel()
        if not (np.all(ids.ravel() == ii) and ii.size
                and ii.min() >= 1 and ii.max() <= total):
            raise ValueError(
                f"forward transform at {'/'.join(path)} is not a "
                f"per-tensor bijection; cannot invert"
            )
        v = np.asarray(par_tree[path], np.float64).ravel()
        dup = written[ii - 1]
        if np.any(dup) and not np.array_equal(flat[ii - 1][dup], v[dup]):
            raise ValueError(
                f"conflicting duplicate mapping at {'/'.join(path)}"
            )
        flat[ii - 1] = v
        written[ii - 1] = True

    out, unmapped = {}, []
    for k in keys:
        n = int(tmpl[k].size)
        w = written[offsets[k]:offsets[k] + n]
        if not w.any():
            out[k] = tmpl[k].copy()
            unmapped.append(k)
        elif not w.all():
            raise ValueError(f"partially mapped torch tensor {k!r}")
        else:
            out[k] = (flat[offsets[k]:offsets[k] + n]
                      .reshape(tmpl[k].shape).astype(tmpl[k].dtype))
    return out, unmapped
