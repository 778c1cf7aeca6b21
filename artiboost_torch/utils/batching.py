"""Masked-union assembly of mixed real/synth batches (counterpart of
``artiboost_tpu/utils/batching.py``).

The real and synth halves come from different pipelines and can disagree
on keys. ``union_concat`` takes the key UNION: a part missing a key is
zero-filled (integer id keys get -1) and a per-key per-sample validity
mask is emitted under ``KEY_VALID``. Every loss folds the masks of the
keys it reads into its per-sample weighting through ``key_validity``, so
filled samples contribute exactly zero. When every part carries every
key, no mask dict is emitted and the batch is a plain concatenation.

Object vertices are padded per batch (``ho_collate``, ``PADDING_MASK``), so
a real half (HO3D's YCB meshes) and a synth half (the object library's
``V_MAX``) can disagree on their count: the shorter part is padded as
``ho_collate`` pads the samples joined, its ``PADDING_MASK`` with zeros,
so a masked loss or metric reads each sample's own vertices only. (The JAX
package's ``union_concat`` concatenates them as they are and raises there,
ROADMAP C.)"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from artiboost_torch.parallel.mesh import shard_normaliser

# reserved batch key: {query name: (B,) float32, 1 = annotated / 0 = filled}
KEY_VALID = "_key_valid"

# integer id keys whose natural missing value is -1, not 0
_NEG_ONE_FILL = {"sample_idx", "obj_id", "persp_id", "grasp_id", "obj_idx"}
# per-vertex keys padded to the batch's longest object (ho_collate)
_VERTEX_KEYS = ("obj_verts_3d", "obj_verts_can", "obj_verts_2d")
_PADDING_MASK = "padding_mask"


def _vertex_count(part: Dict) -> Optional[int]:
    for k in _VERTEX_KEYS + (_PADDING_MASK,):
        if k in part:
            return int(part[k].shape[1])
    return None


def _pad_vertices(parts: List[Dict]) -> List[Dict]:
    """Parts that disagree on the vertex count -> parts padded to the
    longest as ``ho_collate`` pads the samples joined: each sample's own
    vertices (those of its ``PADDING_MASK``, a prefix) repeated cyclically,
    the mask extended with zeros."""
    counts = [_vertex_count(p) for p in parts]
    if len({c for c in counts if c is not None}) < 2:
        return parts
    n = max(c for c in counts if c is not None)
    out = []
    for p, v in zip(parts, counts):
        if v is None or v == n:
            out.append(p)
            continue
        p = dict(p)
        mask = p.get(_PADDING_MASK)
        dev = mask.device if mask is not None else p[_VERTEX_KEYS[0]].device
        b = _batch_size(p)
        own = (torch.full((b,), v, device=dev) if mask is None
               else torch.clamp_min((mask > 0).sum(1), 1))
        idx = torch.arange(n, device=dev)[None] % own[:, None]  # (B, n)
        for k in _VERTEX_KEYS:
            if k in p:
                p[k] = torch.gather(p[k], 1, idx[..., None].expand(-1, -1, p[k].shape[2]))
        if mask is not None:
            p[_PADDING_MASK] = (torch.arange(n, device=dev)[None] < own[:, None]).to(mask.dtype)
        out.append(p)
    return out


def _batch_size(part: Dict) -> int:
    for k, v in part.items():
        if k != KEY_VALID:
            return int(v.shape[0])
    raise ValueError("empty batch part")


def _fill(key: str, template: torch.Tensor, n: int) -> torch.Tensor:
    """Zero (or -1 for id keys) in the shape of ``template`` with the batch
    dim replaced by n."""
    shape = (n,) + tuple(template.shape[1:])
    if key in _NEG_ONE_FILL and not template.is_floating_point():
        return torch.full(shape, -1, dtype=template.dtype, device=template.device)
    return torch.zeros(shape, dtype=template.dtype, device=template.device)


def union_concat(parts: Sequence[Dict]) -> Dict:
    """Concatenate batch parts along dim 0 over the union of their keys.
    Parts may carry ``KEY_VALID`` masks themselves; they compose. Tensors
    of different dtypes promote (a bf16 image half and a float32 one give
    float32)."""
    parts = [p for p in parts if p]
    if len(parts) == 1:
        return dict(parts[0])
    parts = _pad_vertices(parts)
    sizes = [_batch_size(p) for p in parts]
    all_keys: List[str] = []
    for p in parts:
        all_keys += [k for k in p if k != KEY_VALID and k not in all_keys]

    out: Dict = {}
    masks: Dict[str, torch.Tensor] = {}
    for k in all_keys:
        template = next(p[k] for p in parts if k in p)
        cols, mcols, any_missing = [], [], False
        for p, n in zip(parts, sizes):
            sub = p.get(KEY_VALID, {})
            ones = torch.ones((n,), dtype=torch.float32, device=template.device)
            if k in p:
                cols.append(p[k])
                mcols.append(sub.get(k, ones))
                any_missing = any_missing or k in sub
            else:
                cols.append(_fill(k, template, n))
                mcols.append(torch.zeros_like(ones))
                any_missing = True
        out[k] = torch.cat(cols, dim=0)
        if any_missing:
            masks[k] = torch.cat(mcols, dim=0)
    if masks:
        out[KEY_VALID] = masks
    return out


def key_validity(targs: Dict, *keys) -> Optional[torch.Tensor]:
    """(B,) float32 AND of the validity masks of ``keys``; None when the
    batch carries no mask for any of them (the caller then skips masking)."""
    kv = targs.get(KEY_VALID)
    if not kv:
        return None
    out = None
    for k in keys:
        m = kv.get(str(k))
        if m is not None:
            out = m if out is None else out * m
    return out


def masked_sample_mean(per_sample: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of per-sample scalars over valid samples (the plain mean when
    mask is None); an all-invalid batch gives 0, not NaN. Under a process
    group the valid count is the global batch's (``mesh.shard_normaliser``)."""
    if mask is None:
        return torch.mean(per_sample)
    return torch.sum(per_sample * mask) / torch.clamp_min(shard_normaliser(torch.sum(mask)), 1e-8)
