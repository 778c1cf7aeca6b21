"""The numbers that decide ``correct``: what the timed path produced, held
against the plain reference (``bench_port/reference``), each number a gap
that its limit bounds. ``variant`` puts something else in the program's
place: ``"control"`` the reference computed one precision lower than the
recipe states (float8 convolutions and matrix products for the bfloat16
model, float8 for the bfloat16 image, bfloat16 for the float32 pose engine,
labels, raster, FK and reweight), ``"half"`` the reference trained on half
of each batch (a planted fault)."""
from __future__ import annotations

import math
import os
from typing import Dict, List, Optional

import torch

from bench_port.reference import engine
from bench_port.reference import mano as ref_mano
from bench_port.reference import metrics as ref_metrics
from bench_port.reference import synth as ref_synth
from bench_port.reference.raster import raster

EXCLUDE_BELOW = 1e-3  # a leaf whose first gradient is under this share of the median leaf's
# numbers read as multiples of the same gap of the reference run in bfloat16,
# the recipe's own precision, on the same seed and rows
VS_BF16 = {"grad_med_vs_bf16": "grad_gap_med", "change_med_vs_bf16": "change_gap_med",
           "bn_med_vs_bf16": "bn_gap_med", "loss1_vs_bf16": "loss_gap1",
           "grad_diff_med_vs_bf16": "grad_diff_med",
           "joints_med_vs_bf16": "joints_gap_med_mm", "epe_map_med_vs_bf16": "epe_map_gap_med_mm",
           "mssd_map_med_vs_bf16": "mssd_map_gap_med_mm"}
VS_BF16.update({"win_" + k: "win_" + v for k, v in list(VS_BF16.items())})


def fp8(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float8_e4m3fn).float()


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    return s[len(s) // 2]


def row_gaps_mm(got: Dict, ref: Dict) -> torch.Tensor:
    """Each row's worst joint or corner of ``got`` against ``ref``, in mm; a
    row ``got`` lacks (an answer that never came) reads infinite."""
    n, m = got["joints_3d_abs"].shape[0], ref["joints_3d_abs"].shape[0]
    gaps = torch.stack([(got[k][:m].double() - ref[k][:n].double()).abs().amax(dim=(1, 2))
                        for k in ("joints_3d_abs", "corners_3d_abs")]).amax(0) * 1e3
    return torch.cat([gaps, torch.full((max(m - n, 0),), math.inf, dtype=gaps.dtype,
                                       device=gaps.device)])


def train_gaps(ref: Dict, prog_loss: List[float], prog_g1: Dict, prog_w: Dict,
               w0: Dict, prog_preds1: Dict, prefix: str = "") -> Dict[str, float]:
    """joints_gap_med_mm: the first step's forward, the median row's worst
    joint or corner against the reference's; loss_gap: the worst step's
    |loss - reference| / |reference|
    (loss_gap1: the first step's); grad_gap: the worst leaf's gap of
    first-gradient norms over the larger of its reference norm and the
    median leaf's (grad_gap_med: the median leaf's gap); change_gap and
    change_gap_med: the same of the parameters' change over the steps,
    leaves with a first gradient under EXCLUDE_BELOW of the median leaf's
    left out; bn_gap_med: the median BatchNorm's gap of running statistics
    after the steps over the reference's update of them; grad_diff_med: the
    median leaf's norm of the first gradients' difference over the larger
    of its reference norm and the median leaf's (their directions: a
    gradient of other rows of the same size reads about 1). ``prefix``
    names the numbers of a later start than the first step's."""
    loss = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog_loss, ref["loss"])]
    names = list(ref["grad1"])
    g_ref = {n: float(ref["grad1"][n].double().norm()) for n in names}
    g_prog = {n: float(prog_g1[n].double().norm()) for n in names}
    g_med = _median(list(g_ref.values()))
    g_gap = {n: abs(g_prog[n] - g_ref[n]) / max(g_ref[n], g_med) for n in names}
    g_diff = [float((prog_g1[n].double() - ref["grad1"][n].double()).norm()) / max(g_ref[n], g_med)
              for n in names]
    kept = [n for n in names if g_ref[n] >= EXCLUDE_BELOW * g_med]
    d_ref = {n: float((ref["w"][n].double() - w0[n].double()).norm()) for n in kept}
    d_prog = {n: float((prog_w[n].double() - w0[n].double()).norm()) for n in kept}
    d_med = _median(list(d_ref.values()))
    d_gap = {n: abs(d_prog[n] - d_ref[n]) / max(d_ref[n], d_med) for n in kept}
    worst_g, worst_d = max(g_gap, key=g_gap.get), max(d_gap, key=d_gap.get)
    bn = []  # each BatchNorm's running statistics after the steps, against their update
    for p in sorted({n.rsplit(".", 1)[0] for n in w0 if n.endswith(".running_mean")}):
        def stats(w):
            return torch.cat([w[p + ".running_mean"].double(), w[p + ".running_var"].double()])
        bn.append(float((stats(prog_w) - stats(ref["w"])).norm()
                        / (stats(ref["w"]) - stats(w0)).norm()))
    nums = {"joints_gap_med_mm": float(row_gaps_mm(prog_preds1, ref["preds1"]).median()),
            "loss_gap": max(loss), "loss_gap1": loss[0], "bn_gap_med": _median(bn),
            "grad_gap": g_gap[worst_g], "grad_gap_med": _median(list(g_gap.values())),
            "grad_diff_med": _median(g_diff),
            "change_gap": d_gap[worst_d], "change_gap_med": _median(list(d_gap.values()))}
    nums = {prefix + k: v for k, v in nums.items()}
    nums["detail"] = {"excluded_leaves": len(names) - len(kept), "worst_grad_leaf": worst_g,
                       "grad_norms": [g_prog[worst_g], g_ref[worst_g], g_med],
                       "worst_change_leaf": worst_d,
                       "change_norms": [d_prog[worst_d], d_ref[worst_d], d_med],
                       "losses": [list(prog_loss), list(ref["loss"])]}
    return nums


def raster_mismatch(cap: Dict, variant: str = "program") -> float:
    """Share of the captured rows' pixels where the raster differs from the
    reference's: coverage, the depth by more than 1e-4 of it, or where both
    cover, u or v by more than 2 / 4095, the shade by more than 2e-3 or the
    page."""
    args = (cap["verts"], cap["faces"], cap["face_valid"], cap["height"], cap["width"],
            cap["cull"], cap["attrs"])
    ref, a = raster(*args)
    a = torch.cat([torch.clamp(a[..., :2], 0.0, 1.0), torch.clamp(a[..., 2:3], 0.0, 4.0),
                   torch.round(a[..., 3:])], -1)
    if variant == "control":
        got, g = raster(*args, dtype=torch.bfloat16)
        g = torch.cat([torch.clamp(g[..., :2], 0.0, 1.0), torch.clamp(g[..., 2:3], 0.0, 4.0),
                       torch.round(g[..., 3:])], -1)
    else:
        got, q = cap["depth"].float(), cap["quv"].double()
        u = torch.floor(q / 4096)
        g = torch.stack([u / 4095, (q - u * 4096) / 4095, cap["shade"].double(),
                         cap["page"].double()], -1).float()
    both = (got > 0) & (ref > 0)
    off = ((g[..., :2] - a[..., :2]).abs() > 2 / 4095).any(-1) | (
        (g[..., 2] - a[..., 2]).abs() > 2e-3) | (g[..., 3] != a[..., 3])
    bad = ((got > 0) != (ref > 0)) | ((got - ref).abs() > 1e-4 * ref.abs()) | (both & off)
    return float(bad.float().mean())


def mano_gap_mm(batches: List[Dict], m64: Dict, center_idx: int,
                variant: str = "program") -> float:
    """Worst joint of the batches' root-relative hand joints against the
    reference FK of the batch's own final MANO pose and shape, in mm."""
    worst = 0.0
    for b in batches:
        j = ref_mano.joints21(m64, b["hand_pose"], b["hand_shape"])
        ref = j - j[:, center_idx:center_idx + 1]
        if variant == "control":
            m16 = {k: v.to(torch.bfloat16) for k, v in m64.items()}
            g = ref_mano.joints21(m16, b["hand_pose"], b["hand_shape"]).double()
            got = g - g[:, center_idx:center_idx + 1]
        else:
            got = b["joints_3d"].double()
        worst = max(worst, float((got - ref).abs().max()) * 1e3)
    return worst


def reweight_gap(snap: Dict, lower: float, upper: float, variant: str = "program") -> float:
    """The worst triplet's |weight after the reweight - the reference's
    ``method_1`` of the weights before it and the evaluator's maps (their
    mean, seen where all are seen)| over the reference's weight."""
    maps = snap["maps"]
    avg = sum(m[1].double() for m in maps) / len(maps)
    seen = maps[0][2]
    for m in maps[1:]:
        seen = seen & m[2]
    ref = ref_metrics.method_1(snap["w_before"].double(), avg, seen, lower, upper)
    if variant == "control":
        got = ref_metrics.method_1(snap["w_before"].to(torch.bfloat16), avg.to(torch.bfloat16),
                                   seen, lower, upper).double()
    else:
        got = snap["w_after"].double()
    return float(((got - ref).abs() / ref.abs()).max())


def val_gaps(ref_model, recipe: Dict, w: Dict, caps: List[Dict], snap: Dict,
             models_info: Optional[Dict], variant: str = "program") -> Dict[str, float]:
    """joints_gap_mm: the worst joint or corner of the sampled rows against
    the reference forward (joints_gap_med_mm: the median row's worst);
    epe_map_gap_mm (and mssd_map_gap_mm with an AR map): the worst sampled
    triplet's map entry against the reference's error of its reference
    prediction. ``ref_model``: the architecture's reference module;
    ``variant`` "control" or "bf16": the reference in float8 or bfloat16 in
    the program's place."""
    lower = {"control": "fp8", "bf16": "bf16"}.get(variant)
    rows_gap, epe_gap, mssd_gap = [], [], []
    names = [m[0] for m in snap["maps"]]
    epe_map = snap["maps"][names.index("ValMetricMean3DEPE2")][1]
    mssd_map = snap["maps"][names.index("ValMetricAR2")][1] if "ValMetricAR2" in names else None
    if mssd_map is not None:
        syms = {int(k): ref_metrics.symmetries(v) for k, v in models_info.items()}

    def epe(p, c):
        return (ref_metrics.epe_mm(p["corners_3d_abs"], c["corners_3d"], c["root_joint"])
                + ref_metrics.epe_mm(p["joints_3d_abs"], c["joints_3d"], c["root_joint"])) / 2

    for c in caps:
        ref = ref_model.forward_eval(recipe, w, c)
        got = c["preds"] if lower is None else ref_model.forward_eval(recipe, w, c, precision=lower)
        rows_gap.append(row_gaps_mm(got, ref))
        idx = (c["obj_id"].long(), c["persp_id"].long(), c["grasp_id"].long())
        prog = epe_map[idx].double() if lower is None else epe(got, c)
        epe_gap.append((prog - epe(ref, c)).abs())
        if mssd_map is not None:
            def mssd(p):
                return torch.stack([ref_metrics.mssd_mm(
                    p["box_rot_rotmat"][i], p["boxroot_3d_abs"][i], c["corners_can"][i],
                    c["obj_transf"][i], syms[int(c["obj_idx"][i])])
                    for i in range(c["obj_idx"].shape[0])])
            prog = mssd_map[idx].double() if lower is None else mssd(got)
            mssd_gap.append((prog - mssd(ref)).abs())
    rows = torch.cat(rows_gap)
    epe_rows = torch.cat(epe_gap)
    out = {"joints_gap_mm": float(rows.max()), "joints_gap_med_mm": float(rows.median()),
           "epe_map_gap_mm": float(epe_rows.max()), "epe_map_gap_med_mm": float(epe_rows.median())}
    if mssd_gap:
        mssd_rows = torch.cat(mssd_gap)
        out["mssd_map_gap_mm"] = float(mssd_rows.max())
        out["mssd_map_gap_med_mm"] = float(mssd_rows.median())
    return out


def finite(x: float) -> bool:
    return isinstance(x, float) and math.isfinite(x)


def reference_data(asset_dir: str, recipe: Dict, device) -> Dict:
    """What the engine's and the sample's references read from the asset
    files: objects, grasps, MANO, RefineNet's weights, textures and
    backgrounds."""
    M = recipe["MANAGER"]
    names = list(M["OBJ_ENGINE"]["OBJ"])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return {"objects": engine.load_objects(os.path.join(asset_dir, "data", "YCB_models_process"),
                                           names, M["OBJ_ENGINE"].get("OBJ_ORIGIN_DATASET", "HO3D"),
                                           device),
            "grasps": engine.load_grasps(os.path.join(asset_dir, "assets", "grasp_engine",
                                                      "ycb_grasp"), names,
                                         int(M["GRASP_ENGINE"]["GRASP_NUM"]), device),
            "mano": ref_mano.load_pickle(os.path.join(asset_dir, "assets", "mano_v1_2", "models",
                                                      "MANO_RIGHT.pkl"), device),
            "net": engine.load_refinenet(os.path.join(root, "assets", "refinenet_tpu.npz"), device),
            "atlas": ref_synth.load_atlas(asset_dir, names, device),
            "bgs": ref_synth.load_backgrounds(os.path.join(asset_dir, M["RENDERER"]["BGS_PATH"]),
                                              device)}


def pose_gap_mm(cap: Dict, data: Dict, recipe: Dict, variant: str = "program") -> float:
    """The worst joint of the final hands and corner of the objects of the
    captured pose rows, in the camera frame, against the reference engine's
    from the same triplets and draws, in mm."""
    args = (data, recipe["MANAGER"], cap["oid"], cap["vid"], cap["gid"], cap["draws"])
    ref = engine.generate(*args, torch.float64)
    if variant == "control":
        got = {k: v.double() for k, v in engine.generate(*args, torch.bfloat16).items()}
    else:
        o = cap["out"]
        pose = o["obj_pose"].double()
        got = {"joints": engine.final_hand(data["mano"], o["hand_pose"], o["hand_shape"],
                                           o["hand_tsl"], o["cam_offset"], o["cam_free"]),
               "corners": data["objects"]["corners"][cap["oid"]] @ pose[:, :3, :3].transpose(1, 2)
               + pose[:, None, :3, 3]}
    return 1e3 * max(float((got[k] - ref[k]).abs().max()) for k in ("joints", "corners"))


def synth_gaps(cap: Dict, data: Dict, recipe: Dict, lod: Optional[Dict],
               variant: str = "program") -> Dict[str, float]:
    """The captured synthetic rows against the reference from their pose
    cache rows and draws: labels_gap_mm (the worst 3D label), labels_gap_px
    (the worst 2D label or crop intrinsic), vis_mismatch (visibility flags
    that differ, in rows with no point within 0.01 px of a border),
    screen_gap_px (the worst vertex of the raster call against the scene
    placed and projected by the reference) and image_mismatch (the share
    of the images' pixels with a channel off by more than 0.02, from the
    raster's outputs on)."""
    rows, draws, out, rc = cap["rows"], cap["draws"], cap["out"], cap["raster"]
    dt = torch.bfloat16 if variant == "control" else torch.float64
    mano = {k: v.to(dt) for k, v in data["mano"].items()}
    oid = rows["obj_id"]
    hand = engine.final_hand(mano, rows["hand_pose"], rows["hand_shape"], rows["hand_tsl"],
                             rows["cam_offset"], rows["cam_free"])
    ref = ref_synth.labels(rows, draws, data["objects"]["corners"][oid], hand.double(), recipe,
                           torch.float64)
    got = ref_synth.labels(rows, draws, data["objects"]["corners"][oid], hand, recipe, dt) \
        if variant == "control" else {k: out[k] for k in ref if k in out}
    mm = 1e3 * max(float((got[k].double() - ref[k]).abs().max())
                   for k in ("joints_3d", "corners_3d", "root_joint"))
    px = max(float((got[k].double() - ref[k]).abs().max())
             for k in ("joints_2d", "corners_2d", "cam_intr"))
    H = float(recipe["DATA_PRESET"]["IMAGE_SIZE"][0])
    near = torch.zeros(oid.shape[0], dtype=torch.bool, device=oid.device)
    for k in ("joints_2d", "corners_2d"):
        near |= ((ref[k] - 0).abs().amin((1, 2)) < 0.01) | ((ref[k] - H).abs().amin((1, 2)) < 0.01)
    vis = sum(int(((got[k].double() != ref[k]) & ~near[:, None]).sum())
              for k in ("joints_vis", "corners_vis"))

    def scene(lab, dt):  # the scene as the raster call got it, on its screen
        mano = {k: v.to(dt) for k, v in data["mano"].items()}
        verts, _ = ref_mano.forward(mano, rows["hand_shape"], pose=rows["hand_pose"])
        verts = (verts + (rows["hand_tsl"].to(dt) + rows["cam_offset"].to(dt))[:, None]) \
            @ rows["cam_free"].to(dt).transpose(1, 2)
        if lod is not None:  # the hand's render vertices and the object's render mesh
            verts, obj = verts[:, lod["hand_rep"]], lod["obj_verts"][oid].to(dt)
        else:
            obj = data["objects"]["verts"][oid].to(dt)
        pose = rows["obj_pose"].to(dt)
        obj = obj @ pose[:, :3, :3].transpose(1, 2) + pose[:, None, :3, 3]
        K = lab["cam_intr"].to(dt).clone()
        K[:, :2] = K[:, :2] * (rc["height"] / H)
        return ref_synth.screen(torch.cat([verts, obj], 1) @ lab["rot"].to(dt).transpose(1, 2), K)

    vs = scene(got, dt) if variant == "control" else rc["verts"]
    screen_px = float((vs[..., :2].double() - scene(ref, torch.float64)[..., :2]).abs().max())

    img_ref = ref_synth.image(rc, draws, data["atlas"], data["bgs"], int(H))
    img = ref_synth.image(rc, draws, data["atlas"], data["bgs"], int(H), rnd=fp8) \
        if variant == "control" else out["image"].float()
    return {"labels_gap_mm": mm, "labels_gap_px": px, "vis_mismatch": float(vis),
            "screen_gap_px": screen_px,
            "image_mismatch": float(((img - img_ref).abs().amax(-1) > 0.02).float().mean())}
