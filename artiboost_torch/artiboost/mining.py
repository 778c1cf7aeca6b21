"""Hard-example mining: the per-epoch CCV weight-map updates (counterpart
of ``artiboost_tpu/artiboost/mining.py``; reference
``anakin/artiboost/artiboost_loader.py:503-598``) as masked tensor ops
over the dense (O, V, G) maps, ``seen`` a boolean map."""
from __future__ import annotations

from typing import Dict

import torch


def _confidence(val_map: torch.Tensor, seen: torch.Tensor) -> torch.Tensor:
    """(max - val) / range over the seen triplets (1 = easiest)."""
    big = torch.finfo(val_map.dtype).max
    vmin = torch.where(seen, val_map, big).amin()
    vmax = torch.where(seen, val_map, -big).amax()
    return (vmax - val_map) / (vmax - vmin + 1e-8)


def update_method_1(weight_map, val_map, seen, lower, upper, **kw) -> Dict:
    """Percentile reweight: w *= 1 / (confidence + 0.5), clamped."""
    update = 1.0 / (_confidence(val_map, seen) + 0.5)
    new = torch.where(seen, weight_map * update, weight_map)
    return {"sample_weight_map": torch.clamp(new, lower, upper)}


def update_method_2(weight_map, val_map, seen, lower, upper, **kw) -> Dict:
    """Incremental: -0.1 for easy (confidence > 0.5), +0.1 for hard."""
    delta = torch.where(_confidence(val_map, seen) > 0.5, -0.1, 0.1)
    new = torch.where(seen, weight_map + delta, weight_map)
    return {"sample_weight_map": torch.clamp(new, lower, upper)}


def update_method_3(weight_map, val_map, seen, lower, upper,
                    dist_lower_threshold=8.0, dist_upper_threshold=16.0, **kw) -> Dict:
    """Lower-bound deactivation: solved triplets get weight 0, very hard
    ones reset to 1, the rest decay by half."""
    low = val_map < dist_lower_threshold
    high = val_map > dist_upper_threshold
    new = torch.where(low, 0.0, torch.where(high, 1.0, weight_map * 0.5))
    new = torch.where(seen, new, weight_map)
    n_seen = torch.clamp_min(seen.float().sum(), 1.0)
    ratio = (low & seen).float().sum() / n_seen
    return {"sample_weight_map": new, "dist_lower_ratio": ratio}


def update_method_4(weight_map, val_map, seen, lower, upper,
                    dist_lower_threshold=8.0, dist_upper_threshold=16.0,
                    epoch_idx=0, n_epochs=100, **kw) -> Dict:
    """method_1 for the first 75 % of epochs, then method_3."""
    if float(epoch_idx) / n_epochs < 0.75:
        out = update_method_1(weight_map, val_map, seen, lower, upper)
        out["dist_lower_ratio"] = torch.tensor(-1.0)
        return out
    return update_method_3(weight_map, val_map, seen, lower, upper,
                           dist_lower_threshold=dist_lower_threshold,
                           dist_upper_threshold=dist_upper_threshold)


def update_uniform(weight_map, val_map, seen, lower, upper, **kw) -> Dict:
    """No-mining baseline: weights untouched."""
    return {"sample_weight_map": weight_map}


UPDATE_METHODS = {
    "method_1": update_method_1,
    "method_2": update_method_2,
    "method_3": update_method_3,
    "method_4": update_method_4,
    "uniform": update_uniform,
}
