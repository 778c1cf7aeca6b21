"""The frozen counters against a count made another way: the FLOP counter
against ``torch.utils.flop_counter.FlopCounterMode`` on the plain
reference model, the raster work against a scan of every face and pixel,
and the reference rasterizer against a loop over pixels and faces."""
import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port import run
from bench_port.count.flops import clas_flops
from bench_port.count.raster_work import OPS_PER_PAIR, raster_work
from bench_port.reference import HybridBaseline as ref_model
from bench_port.reference.raster import raster_depth

RECIPE = run.load_json(run.BENCH, "configs", "clas-ho3dv2.json")["recipe"]


def _batch(B, size, g):
    return {"image": torch.rand(B, size, size, 3, generator=g) - 0.5,
            "cam_intr": torch.tensor([[200.0, 0, size / 2], [0, 200.0, size / 2], [0, 0, 1]]).expand(B, 3, 3).clone(),
            "root_joint": torch.tensor([0.0, 0.0, 0.5]).expand(B, 3).clone(),
            "corners_can": torch.randn(B, 8, 3, generator=g) * 0.05}


@pytest.mark.parametrize("size", [64, 96])
def test_flops_against_flop_counter(size):
    torch.manual_seed(0)
    recipe = json.loads(json.dumps(RECIPE))
    recipe["DATA_PRESET"]["IMAGE_SIZE"] = [size, size]
    arch = recipe["ARCH"]
    spec = ref_model.weight_spec(arch["HYBRID_HEAD"], arch["BOX_HEAD"])
    w = ref_model.init_weights(spec, 7, "cpu")
    for n in w:
        if ref_model._is_trainable(n):
            w[n].requires_grad_(True)
    B = 2
    batch = _batch(B, size, torch.Generator().manual_seed(1))
    model = ref_model.Ref(recipe)
    want = clas_flops((size, size), arch["HYBRID_HEAD"], arch["BOX_HEAD"])
    assert ref_model.flops(recipe) == want
    with FlopCounterMode(display=False) as fwd:
        preds = model.forward(batch, w, train=True)
    assert fwd.get_total_flops() == pytest.approx(B * want["forward"], rel=1e-9)
    loss = preds["joints_3d_abs"].sum() + preds["corners_3d_abs"].sum()
    with FlopCounterMode(display=False) as bwd:
        loss.backward()
    assert bwd.get_total_flops() == pytest.approx(B * want["backward"], rel=1e-9)


def _scene(seed, B=2, V=30, F=40, H=12, W=16):
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(B, V, 2, generator=g) * torch.tensor([W + 6.0, H + 6.0]) - 3.0
    z = 0.5 + torch.rand(B, V, 1, generator=g)
    faces = torch.randint(0, V, (B, F, 3), generator=g)
    valid = (torch.rand(B, F, generator=g) > 0.2).float()
    return torch.cat([xy, z], -1), faces, valid, H, W


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_raster_work_against_a_scan(seed, cull):
    vs, faces, valid, H, W = _scene(seed)
    attrs = torch.zeros(vs.shape[0], vs.shape[1], 4)
    got = raster_work(vs, attrs, faces, valid, H, W, cull)
    pairs, nf, verts = 0, 0, set()
    for b in range(vs.shape[0]):
        for f in range(faces.shape[1]):
            p = vs[b, faces[b, f], :2].double().numpy()
            area = (p[1, 0] - p[0, 0]) * (p[2, 1] - p[0, 1]) - (p[2, 0] - p[0, 0]) * (p[1, 1] - p[0, 1])
            if valid[b, f] == 0 or abs(area) <= 1e-9 or (cull and area >= 0):
                continue
            nf += 1
            verts.update((b, int(v)) for v in faces[b, f])
            for y in range(H):
                for x in range(W):
                    if p[:, 0].min() <= x + 0.5 <= p[:, 0].max() and p[:, 1].min() <= y + 0.5 <= p[:, 1].max():
                        pairs += 1
    assert got["pairs"] == pairs and got["faces"] == nf
    assert got["ops"] == pairs * OPS_PER_PAIR
    assert got["bytes"] == len(verts) * 4 * 7 + nf * 12 + vs.shape[0] * H * W * 16


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("seed", [3, 4])
def test_reference_raster_against_a_pixel_loop(seed, cull):
    vs, faces, valid, H, W = _scene(seed, F=25)
    got = raster_depth(vs, faces, valid, H, W, cull, block=37)
    want = np.zeros((vs.shape[0], H, W))
    v64 = vs.double().numpy()
    for b in range(vs.shape[0]):
        for y in range(H):
            for x in range(W):
                best = -1.0
                for f in range(faces.shape[1]):
                    p = v64[b, faces[b, f].numpy()]
                    area = (p[1, 0] - p[0, 0]) * (p[2, 1] - p[0, 1]) - (p[2, 0] - p[0, 0]) * (p[1, 1] - p[0, 1])
                    if valid[b, f] == 0 or abs(area) <= 1e-9 or (cull and area >= 0):
                        continue
                    q = np.array([x + 0.5, y + 0.5])
                    lam = []
                    for k in range(3):
                        a, c = p[(k + 1) % 3], p[(k + 2) % 3]
                        lam.append(((c[0] - a[0]) * (q[1] - a[1]) - (c[1] - a[1]) * (q[0] - a[0])) / area)
                    if min(lam) >= -1e-6:
                        best = max(best, sum(l / pk[2] for l, pk in zip(lam, p)))
                want[b, y, x] = 1.0 / best if best > 0 else 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
    assert (got > 0).any()
