"""Scene geometry sampling for online data synthesis (the port's own copy
of the JAX package's ``data/scenes.py``).

Consumes the reference's array-geometry settings JSONs unchanged
(dataset/mcse_dataset_settings*.json) and reproduces its sampling
distributions (dataset/mcse_dataset.py:52-212): uniform room dims, mic-array
and target placement under distance constraints, array rotation so its
nominal direction faces the target, 1-5 noise sources with a minimum-DoA
separation, RT60 with inverse-Sabine feasibility retry, per-noise SNRs and
mixture dBFS.

All randomness flows through an explicit `np.random.Generator`, so scenes
are reproducible per-item from a (seed, index) pair — stronger than the
reference's global-RNG workers. The `specific` override dict (deterministic
scene pinning for demos/tests, mcse_dataset.py:53-63) is supported with the
same keys.
"""

from __future__ import annotations

import json
import pathlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from eabnet_tpu_torch.data.rir import inverse_sabine


#: Short names for the framework-shipped array-geometry settings
#: (equivalents of the reference's three dataset/mcse_dataset_settings*.json:
#: v1 = 8-mic planar 3x6cm grid, v2 = 9-mic linear 4cm pitch, v3 = 8-mic
#: planar variant facing +x).
BUILTIN_SETTINGS = {
    "v1": "mcse_dataset_settings.json",
    "v2": "mcse_dataset_settings_v2.json",
    "v3": "mcse_dataset_settings_v3.json",
}


def builtin_settings_path(name: str) -> str:
    """Absolute path of a packaged settings JSON ('v1'/'v2'/'v3' or filename)."""
    fname = BUILTIN_SETTINGS.get(name, name)
    return str(
        pathlib.Path(__file__).resolve().parent / "settings" / fname
    )


def load_settings(path: str) -> Dict:
    """Load a scene-settings JSON.

    ``path`` may be a filesystem path, a builtin short name ('v1'/'v2'/'v3'),
    or the bare filename of a packaged settings file.
    """
    p = pathlib.Path(path)
    if not p.exists():
        builtin = pathlib.Path(builtin_settings_path(path))
        if builtin.exists():
            p = builtin
    with open(p) as f:
        return json.load(f)


@dataclass
class Scene:
    room_dim: np.ndarray          # (3,)
    e_absorption: float
    max_order: int
    rt60: float
    fs: int
    rir_method: str
    ref_mic: int
    p_mics: np.ndarray            # (M, 3)
    p_target: np.ndarray          # (3,)
    p_noises: List[np.ndarray]    # each (3,)
    snrs_db: List[float]
    dbfs: float
    noise_names: List[str] = field(default_factory=list)
    speech_name: str = ""

    def meta(self) -> Dict:
        return {
            "room_dim": self.room_dim.tolist(),
            "rt60": self.rt60,
            "e_absorption": self.e_absorption,
            "max_order": self.max_order,
            "p_mics": self.p_mics.tolist(),
            "p_target": self.p_target.tolist(),
            "p_noises": [p.tolist() for p in self.p_noises],
            "snrs_db": list(self.snrs_db),
            "dbfs": self.dbfs,
            "speech": self.speech_name,
            "noises": list(self.noise_names),
        }


def _uniform(rng: np.random.Generator, bounds) -> float:
    lo, hi = float(bounds[0]), float(bounds[1])
    return lo + (hi - lo) * float(rng.random())


def _rotation_2d_to(v_from: np.ndarray, v_to: np.ndarray) -> np.ndarray:
    """2-D rotation matrix turning direction v_from onto v_to
    (the reference's array-facing rotation, mcse_dataset.py:21-30)."""
    a = np.arctan2(v_to[1], v_to[0]) - np.arctan2(v_from[1], v_from[0])
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s], [s, c]])


def _angle_deg(v1: np.ndarray, v2: np.ndarray) -> float:
    cosang = np.dot(v1, v2) / (
        np.linalg.norm(v1) * np.linalg.norm(v2) + 1e-12
    )
    return float(np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0))))


def sample_scene(
    opt: Dict,
    rng: np.random.Generator,
    n_noises_override: Optional[int] = None,
    specific: Optional[Dict] = None,
    max_retries: int = 1000,
) -> Scene:
    """Draw one scene from the settings distribution.

    ``specific`` pins any subset of {room_dim, target_xyz, mics_xyz,
    noise_xyz_list, noise_snr_list, rt60, noisy_dBFS} for deterministic
    scenes (reference: mcse_dataset.py:53-63).
    """
    specific = specific or {}
    fs = int(opt["audio"]["fs"])
    rir_method = opt["audio"]["rir_method"]

    if "room_dim" in specific:
        room = np.asarray(specific["room_dim"], float)
    else:
        lo = np.asarray(opt["room"]["min_dim"], float)
        hi = np.asarray(opt["room"]["max_dim"], float)
        room = lo + (hi - lo) * rng.random(3)

    mic_cfg = opt["mic_array"]
    p_mics_2d = np.array(
        [[m["x"], m["y"]] for m in mic_cfg["mics"]], float
    ).T  # (2, M)
    direction = np.array(
        [mic_cfg["direction"]["x"], mic_cfg["direction"]["y"]], float
    )

    # --- target & array placement with distance constraint -------------
    tgt_cfg = opt["target"]
    fixed_target = "target_xyz" in specific
    fixed_mics = "mics_xyz" in specific
    if fixed_target:
        p_target = np.asarray(specific["target_xyz"], float)
    if fixed_mics:
        mic_cen = np.asarray(specific["mics_xyz"], float)

    for attempt in range(max_retries):
        if not fixed_target:
            d = tgt_cfg["min_dist_to_wall"]
            p_target = np.array([
                _uniform(rng, [d, room[0] - d]),
                _uniform(rng, [d, room[1] - d]),
                _uniform(rng, tgt_cfg["h"]),
            ])
        if not fixed_mics:
            d = mic_cfg["min_dist_to_wall"]
            mic_cen = np.array([
                _uniform(rng, [d, room[0] - d]),
                _uniform(rng, [d, room[1] - d]),
                _uniform(rng, mic_cfg["h"]),
            ])
        dist = float(np.linalg.norm(p_target - mic_cen))
        lo, hi = tgt_cfg["dist_to_mic_array"]
        if lo <= dist <= hi or (fixed_target and fixed_mics):
            break
        if attempt == 50:
            # same heads-up the reference prints (mcse_dataset.py:206-207)
            import warnings

            warnings.warn(
                "scene placement failed 50 times in a sample; the "
                "geometry constraints may be too tight"
            )
    else:
        raise RuntimeError("scene placement failed; constraints too tight")

    # rotate the array toward the target (fixed-DoA mode, the only mode the
    # reference supports: mcse_dataset.py:126)
    if not opt["target"].get("fixed_doa", True):
        raise NotImplementedError("only fixed_doa scenes are supported")
    to_target = (p_target - mic_cen)[:2]
    rot = _rotation_2d_to(direction, to_target)
    mics_2d = rot @ p_mics_2d  # (2, M)
    p_mics = np.concatenate(
        [mics_2d, np.zeros((1, mics_2d.shape[1]))], axis=0
    ).T + mic_cen[None, :]  # (M, 3)

    # --- noise sources ---------------------------------------------------
    noi_cfg = opt["noise"]
    p_noises = [np.asarray(p, float)
                for p in specific.get("noise_xyz_list", [])]
    snrs = list(specific.get("noise_snr_list", []))
    names = list(specific.get("noise_name_list", []))
    n_noises = max(len(p_noises), len(snrs), len(names))
    if n_noises == 0:
        n_noises = (
            n_noises_override
            if n_noises_override is not None
            else int(rng.integers(noi_cfg["n"][0], noi_cfg["n"][1] + 1))
        )
    if not snrs:
        snrs = [_uniform(rng, noi_cfg["SNR"]) for _ in range(n_noises)]
    if not p_noises:
        for _ in range(n_noises):
            for attempt in range(max_retries):
                p = np.array([
                    _uniform(rng, [0, room[0]]),
                    _uniform(rng, [0, room[1]]),
                    _uniform(rng, noi_cfg["h"]),
                ])
                if (
                    np.linalg.norm(p - mic_cen)
                    < noi_cfg["min_dist_to_mic_array"]
                ):
                    continue
                ang = _angle_deg(p_target - mic_cen, p - mic_cen)
                if ang < noi_cfg["min_doa_diff_wrt_target"]:
                    continue
                p_noises.append(p)
                break
            else:
                raise RuntimeError("noise placement failed")

    # --- reverberation ---------------------------------------------------
    if "rt60" in specific:
        rt60 = float(specific["rt60"])
        e_abs, max_order = inverse_sabine(rt60, room)
    else:
        for attempt in range(max_retries):
            rt60 = _uniform(rng, opt["room"]["rt60"])
            try:
                e_abs, max_order = inverse_sabine(rt60, room)
                break
            except ValueError:
                continue
        else:
            raise RuntimeError("no feasible rt60 for sampled room")

    dbfs = (
        float(specific["noisy_dBFS"])
        if "noisy_dBFS" in specific
        else _uniform(rng, opt["noisy_dBFS"])
    )

    return Scene(
        room_dim=room,
        e_absorption=e_abs,
        max_order=max_order,
        rt60=rt60,
        fs=fs,
        rir_method=rir_method,
        ref_mic=int(mic_cfg["ref_mic"]),
        p_mics=p_mics,
        p_target=p_target,
        p_noises=p_noises,
        snrs_db=snrs,
        dbfs=dbfs,
        noise_names=names,
    )
