"""Framework-wide constants and small helpers (counterpart of
``artiboost_tpu/utils/misc.py``; CONST mirrors the reference's
``anakin/utils/misc.py`` lines 64-119)."""
from __future__ import annotations

import functools
import math
import os
from typing import Optional, Union

import numpy as np
import torch

from artiboost_torch.utils.logger import logger  # noqa: F401  (the port's logger)


class CONST:
    PI = math.pi
    INT_MAX = 2**32 - 1
    NUM_JOINTS = 21
    NUM_CORNERS = 8
    NUM_MANO_VERTS = 778
    NUM_MANO_JOINTS = 16
    SIDE = "right"
    DUMMY = "dummy"
    JOINTS_IDX_PARENTS = [0, 0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 0, 13, 14, 15, 0, 17, 18, 19]
    CORNERCUBE_IDX_ORDER = [
        (0, 1), (0, 2), (1, 3), (2, 3),
        (0, 4), (1, 5), (2, 6), (3, 7),
        (4, 5), (4, 6), (5, 7), (6, 7),
    ]
    REF_BONE_LEN = 0.09473151311686484  # meters, wrist->middle-MCP
    PYRENDER_EXTRINSIC = np.array(
        [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]],
        dtype=np.float32)
    UVD_DEPTH_RANGE = 0.4  # meters
    YCB_IDX2CLASSES = {
        1: "002_master_chef_can", 2: "003_cracker_box", 3: "004_sugar_box",
        4: "005_tomato_soup_can", 5: "006_mustard_bottle", 6: "007_tuna_fish_can",
        7: "008_pudding_box", 8: "009_gelatin_box", 9: "010_potted_meat_can",
        10: "011_banana", 11: "019_pitcher_base", 12: "021_bleach_cleanser",
        13: "024_bowl", 14: "025_mug", 15: "035_power_drill", 16: "036_wood_block",
        17: "037_scissors", 18: "040_large_marker", 19: "051_large_clamp",
        20: "052_extra_large_clamp", 21: "061_foam_brick",
    }
    YCB_CLASSES2IDX = {v: k for k, v in YCB_IDX2CLASSES.items()}


def resolve_dtype(dtype) -> torch.dtype:
    """YAML string ("bfloat16", "float32", ...), torch dtype or None
    (-> float32) -> torch dtype."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, str):
        return {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
                "float32": torch.float32, "fp32": torch.float32,
                "float16": torch.float16, "fp16": torch.float16}[dtype.lower()]
    return dtype


def asset_path(rel: str) -> str:
    """A repo-relative asset path (e.g. ``assets/refinenet_tpu.npz``): as
    given when it exists from the working directory, else under the
    repository root, else as given."""
    if os.path.exists(rel):
        return rel
    cand = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), rel)
    return cand if os.path.exists(cand) else rel


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Entry-point device policy: CUDA unless the caller asks for the CPU.

    ``None`` means CUDA; with no CUDA device that raises instead of
    carrying on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "artiboost_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU explicitly")
    return dev


@functools.lru_cache(maxsize=None)
def device_constant(values: tuple, device: torch.device,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The constant ``torch.tensor(values, dtype)`` on ``device``, copied
    there once a process and shared by every caller, who must not write to
    it. Made in a step instead, such a tensor (and a Python list used as an
    index) is copied from pageable host memory, which waits on the card."""
    return torch.tensor(values, dtype=dtype, device=device)
