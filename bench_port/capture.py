"""What the timed path produced, kept for the check after the window: the
hooks wrap the program's own calls and copy a few rows of each, the last
unit's copies replacing the earlier ones.

- ``pose``: one chunk of the unit's pose sweep (``PoseGenerator``): its
  triplets, its draws and the pose cache rows it made, for a sample of rows;
- ``synth``: one synthetic batch of the unit (``SynthBatch``): its pose cache
  rows, draws and sample, with the raster call made inside it (its inputs and
  outputs), for a sample of rows;
- ``steps``: the first train steps of the unit, with the parameters, the
  BatchNorm statistics and the optimizer's state just before them
  (``TrainStep``): the batches, the loss draws, the losses, the first
  forward's outputs, Adam's first moment after the first step and the
  parameters after the last;
- ``val``: sampled val batches of the unit with the forward's outputs;
- ``snap``: the mining step's weights before and after and the evaluator's
  maps."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

BATCH_KEYS = ("image", "cam_intr", "root_joint", "corners_can", "joints_3d", "corners_3d",
              "joints_2d", "corners_2d", "joints_vis", "corners_vis", "hand_pose", "hand_shape",
              "obj_transf", "obj_idx", "obj_id", "persp_id", "grasp_id")
PRED_KEYS = ("joints_3d_abs", "corners_3d_abs", "box_rot_rotmat", "boxroot_3d_abs")


def clone(d: Dict, keys=None) -> Dict:
    """Detached copies of the tensors of a (nested) dict."""
    out = {}
    for k, v in d.items():
        if keys is not None and k not in keys:
            continue
        out[k] = clone(v) if isinstance(v, dict) else (v.detach().clone() if torch.is_tensor(v)
                                                       else v)
    return out


def take(d: Dict, rows: torch.Tensor, n: int) -> Dict:
    """The rows of every tensor of a (nested) dict whose first size is n."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out[k] = take(v, rows, n)
        elif torch.is_tensor(v) and v.dim() and v.shape[0] == n:
            out[k] = v[rows.to(v.device)].detach().clone()
        else:
            out[k] = v
    return out


class Captures:
    def __init__(self, rng: np.random.RandomState, check: Dict):
        self.rng, self.check = rng, check
        self.pose: Optional[Dict] = None
        self.synth: Optional[Dict] = None
        self.steps: Optional[Dict] = None
        self.val: List[Dict] = []
        self.snap: Optional[Dict] = None
        self.traced_raster: Optional[List] = None
        self._pose_armed = False
        self._synth_want, self._synth_seen, self._raster_armed, self._raster = -1, 0, None, None
        self._steps_want = 0
        self.val_want, self.val_seen = set(), 0

    def arm(self, n_synth_calls: int, n_steps: int = 0, step=None, val_want=()):
        """At the start of a unit: capture its first pose chunk, its synth
        call drawn from ``n_synth_calls``, its first ``n_steps`` train steps
        (from ``step``'s state now) and the val batches ``val_want``."""
        self._pose_armed = True
        self._synth_want, self._synth_seen = int(self.rng.randint(max(n_synth_calls, 1))), 0
        self.val_want, self.val_seen, self.val = set(val_want), 0, []
        self._steps_want = n_steps
        if n_steps:
            self.steps = {"start": snapshot(step), "batches": [], "draws": [], "losses": [],
                          "preds1": None, "m1": None, "w_after": None}

    # ---- the pose sweep ----
    def pose_hook(self, pg):
        cap = self

        class Hooked:
            def __getattr__(self, name):
                return getattr(pg, name)

            def __call__(self, oid, vid, gid, draws):
                out = pg(oid, vid, gid, draws)
                if cap._pose_armed:
                    n = oid.shape[0]
                    rows = torch.as_tensor(np.sort(cap.rng.choice(
                        n, min(int(cap.check.get("pose_rows", 32)), n), replace=False)))
                    cap.pose = {"oid": oid[rows.to(oid.device)].clone(),
                                "vid": vid[rows.to(vid.device)].clone(),
                                "gid": gid[rows.to(gid.device)].clone(),
                                "draws": take(draws, rows, n), "out": take(out._asdict(), rows, n)}
                    cap._pose_armed = False
                return out
        return Hooked()

    # ---- the synthetic batch and its raster call ----
    def synth_hook(self, fn):
        cap = self

        class Hooked:
            def __getattr__(self, name):
                return getattr(fn, name)

            def draws(self, generator, B):
                return fn.draws(generator, B)

            def __call__(self, gen, idx, draws):
                if cap._synth_seen != cap._synth_want:
                    cap._synth_seen += 1
                    return fn(gen, idx, draws)
                cap._synth_seen += 1
                n = idx.shape[0]
                rows = torch.as_tensor(np.sort(cap.rng.choice(
                    n, min(int(cap.check.get("raster_rows", 8)), n), replace=False)))
                cap._raster_armed = rows
                out = fn(gen, idx, draws)
                cap._raster_armed = None
                cap.synth = {"rows": take(gen._asdict(), idx[rows.to(idx.device)], gen.obj_id.shape[0]),
                             "draws": take(draws, rows, n), "out": take(out, rows, n),
                             "raster": cap._raster}
                return out
        return Hooked()

    def raster_hook(self, args, out):
        vs, attrs, faces, fvalid, h, w, cull = args
        if self.traced_raster is not None:
            self.traced_raster.append(args)
        r = self._raster_armed
        if r is not None:
            r = r.to(vs.device)
            self._raster = {"verts": vs[r].detach().clone(), "attrs": attrs[r].detach().clone(),
                            "faces": (faces[r] if faces.dim() == 3 else faces).detach().clone(),
                            "face_valid": None if fvalid is None else fvalid[r].detach().clone(),
                            "height": h, "width": w, "cull": cull,
                            "quv": out[0][r].clone(), "shade": out[1][r].clone(),
                            "page": out[2][r].clone(), "depth": out[4][r].clone()}

    # ---- the train steps ----
    def step_hooks(self, step):
        """Wraps ``step.forward_backward`` and ``step.update``; -> a remover."""
        cap, orig_fb, orig_up = self, step.forward_backward, step.update

        def fb(batch, loss_draws):
            s = cap.steps
            keep = s is not None and len(s["batches"]) < cap._steps_want
            if keep:
                s["batches"].append(clone(batch, BATCH_KEYS))
                s["draws"].append([clone(d) for d in loss_draws])
            preds, losses = orig_fb(batch, loss_draws)
            if keep:
                if s["preds1"] is None:
                    s["preds1"] = clone(preds, PRED_KEYS)
                s["losses"].append(losses["final_loss"].detach().clone())
            return preds, losses

        def up():
            orig_up()
            s = cap.steps
            if s is None or not cap._steps_want:
                return
            done = len(s["batches"])
            if done == 1 and s["m1"] is None:
                s["m1"] = adam_moments(step)[0]
            if done == cap._steps_want and s["w_after"] is None:
                s["w_after"] = weights(step)
                cap._steps_want = 0

        step.forward_backward, step.update = fb, up

        def remove():
            del step.forward_backward
            del step.update
        return remove

    # ---- val batches ----
    def val_hook(self, train_mod):
        cap, orig = self, train_mod.eval_step

        def hooked(model, criterion, batch, loss_draws):
            preds, losses = orig(model, criterion, batch, loss_draws)
            if cap.val_seen in cap.val_want:
                c = clone(batch, BATCH_KEYS)
                c["preds"] = clone(preds, PRED_KEYS)
                cap.val.append(c)
            cap.val_seen += 1
            return preds, losses

        train_mod.eval_step = hooked
        return lambda: setattr(train_mod, "eval_step", orig)

    # ---- the mining step ----
    def mining_hook(self, loader):
        cap, orig = self, loader.step_eval

        def hooked(epoch_idx, evaluator):
            snap = {"w_before": loader.ccv.sample_weight_map.clone(),
                    "maps": [(type(m).__name__, *(t.clone() for t in m.get_averaged_maps()))
                             for m in evaluator.metrics_list
                             if type(m).__name__.startswith("ValMetric")]}
            orig(epoch_idx, evaluator)
            snap["w_after"] = loader.ccv.sample_weight_map.clone()
            cap.snap = snap

        loader.step_eval = hooked


def leaf(name: str) -> str:
    """The arch's parameter name -> the model's own."""
    return name.split("model_list.0.", 1)[-1]


def weights(step) -> Dict[str, torch.Tensor]:
    """The model's parameters and BatchNorm running statistics, copied."""
    w = {leaf(n): p.detach().clone() for n, p in step.named_params}
    w.update({leaf(n): b.detach().clone() for n, b in step.model.named_buffers()
              if n.endswith(("running_mean", "running_var"))})
    return w


def adam_moments(step):
    """Adam's first and second moments of each parameter and its step count
    (zeros and 0 before the first update)."""
    state = step.optimizer.state
    m = {leaf(n): state[p]["exp_avg"].detach().clone() if p in state else torch.zeros_like(p)
         for n, p in step.named_params}
    v = {leaf(n): state[p]["exp_avg_sq"].detach().clone() if p in state else torch.zeros_like(p)
         for n, p in step.named_params}
    t = next((int(state[p]["step"]) for _, p in step.named_params if p in state), 0)
    return m, v, t


def snapshot(step) -> Dict:
    m, v, t = adam_moments(step)
    return {"w": weights(step), "m": m, "v": v, "t": t}
