"""Seeded numpy scenes that hold the uv raster kernel against its plain
twin (``chip_smoke.py``) and the twin against the JAX package's Pallas
raster (``tests/test_torch_raster.py``): random triangles in one chunk of
128 faces and in several, with invalid faces, and a two-triangle depth
tie."""
from __future__ import annotations

from typing import Dict

import numpy as np


def random_scene(rng: np.random.RandomState, B: int, V: int, F: int, H: int, W: int,
                 z0: float = 0.3) -> Dict:
    """Random triangles over an H x W frame with (u, v, shade, page) attrs."""
    verts = np.zeros((B, V, 3), np.float32)
    verts[..., 0] = rng.rand(B, V) * W
    verts[..., 1] = rng.rand(B, V) * H
    verts[..., 2] = z0 + rng.rand(B, V)
    faces = rng.randint(0, V, (F, 3)).astype(np.int32)
    attrs = np.concatenate([rng.rand(B, V, 2), rng.rand(B, V, 1) * 3.5,
                            np.floor(rng.rand(B, 1, 1) * 9).repeat(V, 1)], -1)
    return {"verts": verts, "attrs": attrs.astype(np.float32), "faces": faces,
            "valid": np.ones((B, F), np.float32), "H": H, "W": W}


def tie_scene() -> Dict:
    """Two stacked triangles, the far one first in caller order: the near
    one (caller id 1, page 7) must win every covered pixel."""
    verts = np.asarray([[[2.0, 2.0, 0.5], [30.0, 2.0, 0.5], [2.0, 30.0, 0.5],
                         [2.0, 2.0, 1.0], [30.0, 2.0, 1.0], [2.0, 30.0, 1.0]]], np.float32)
    page = np.asarray([[7.0, 7.0, 7.0, 3.0, 3.0, 3.0]], np.float32)[..., None]
    return {"verts": verts, "attrs": np.concatenate([np.full((1, 6, 3), 0.5, np.float32), page], -1),
            "faces": np.asarray([[3, 4, 5], [0, 1, 2]], np.int32),
            "valid": np.ones((1, 2), np.float32), "H": 32, "W": 32}


def rgb_attrs(scene: Dict) -> np.ndarray:
    """Per-vertex colours for the Gouraud raster, derived from the scene's
    (u, v, shade, page) attrs without further draws: (u, v, shade / 3.5),
    so the shade channel spans [0, 1] like the other two."""
    return (scene["attrs"][..., :3] / np.float32([1.0, 1.0, 3.5])).astype(np.float32)


def raster_check_scenes(seed: int = 0) -> Dict[str, Dict]:
    """F = 60 (one chunk), F = 700 (6 chunks), F = 700 with ~30 % of the
    faces invalid on a non-square frame, and the tie."""
    rng = np.random.RandomState(seed)
    small = random_scene(rng, 2, 40, 60, 32, 32)
    multi = random_scene(rng, 2, 300, 700, 48, 48)
    invalid = random_scene(rng, 2, 300, 700, 48, 40)
    invalid["valid"] = (rng.rand(2, 700) > 0.3).astype(np.float32)
    return {"small": small, "multi": multi, "invalid": invalid, "tie": tie_scene()}
