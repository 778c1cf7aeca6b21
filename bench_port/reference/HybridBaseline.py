"""The plain reference of the released "Clas" model and its training step:
HybridBaseline (ResNet34, the integral deconvolution head over 22 classes,
the MLP_O box head), its losses (JointsLoss, HandOrdLoss, SceneOrdLoss
under LAMBDAS), the global-norm clip and Adam, as plain torch functions on
a dict of weights. It follows the ArtiBoost paper's and the released
code's description (arXiv:2109.05488; ``anakin/models/hybridbaseline.py``,
``simplebaseline.py``, ``criterions/jointloss.py``, ``ordinal.py``) and
imports nothing of the program.

It computes in float32 with TF32 off. ``precision="fp8"`` rounds the
inputs and weights of every convolution and linear layer to float8 e4m3
(per-tensor scale): the control that a lower precision than the recipe's
bfloat16 must fail. ``precision="bf16"`` rounds them to bfloat16, the
recipe's own precision: how far that rounding alone moves the float32
reference is the scale some of the check's numbers are measured in.

Weights are named as torchvision and the program name them, so one dict
made by ``init_weights`` loads into both. The harness finds this module by
the recipe's ``ARCH.TYPE``: ``weights``, ``load_into`` and ``flops`` are
what it asks of an architecture's reference."""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.nn import functional as F

STAGES = ((64, 3), (128, 4), (256, 6), (512, 3))  # ResNet34: BasicBlock widths and counts
NUM_JOINTS, NUM_CORNERS = 21, 8
JOINTS_IDX_PARENTS = (0, 0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 0, 13, 14, 15, 0, 17, 18, 19)
BN_EPS = 1e-5


def weight_spec(head: Dict, box: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every tensor of the model, in state-dict order.
    ``head`` is the recipe's HYBRID_HEAD, ``box`` its BOX_HEAD."""
    spec = []

    def bn(prefix, c):
        spec.extend([(f"{prefix}.weight", (c,), "bn_weight"), (f"{prefix}.bias", (c,), "zero"),
                     (f"{prefix}.running_mean", (c,), "bn_mean"),
                     (f"{prefix}.running_var", (c,), "bn_var"),
                     (f"{prefix}.num_batches_tracked", (), "count")])

    spec.append(("backbone.conv1.weight", (64, 3, 7, 7), "conv"))
    bn("backbone.bn1", 64)
    cin = 64
    for i, (w, n) in enumerate(STAGES):
        for j in range(n):
            p = f"backbone.layer{i + 1}.{j}"
            stride = 2 if (i > 0 and j == 0) else 1
            spec.append((f"{p}.conv1.weight", (w, cin, 3, 3), "conv"))
            bn(f"{p}.bn1", w)
            spec.append((f"{p}.conv2.weight", (w, w, 3, 3), "conv"))
            bn(f"{p}.bn2", w)
            if stride != 1 or cin != w:
                spec.append((f"{p}.downsample.0.weight", (w, cin, 1, 1), "conv"))
                bn(f"{p}.downsample.1", w)
            cin = w
    for k, (f, ks) in enumerate(zip(head["NUM_DECONV_FILTERS"], head["NUM_DECONV_KERNELS"])):
        spec.append((f"hybrid_head.deconv_layers.{3 * k}.weight", (cin, f, ks, ks), "deconv"))
        bn(f"hybrid_head.deconv_layers.{3 * k + 1}", f)
        cin = f
    n_out = head["NCLASSES"] * head["DEPTH_RESOLUTION"]
    fk = head["FINAL_CONV_KERNEL"]
    spec.append(("hybrid_head.final_layer.weight", (n_out, cin, fk, fk), "conv_out"))
    spec.append(("hybrid_head.final_layer.bias", (n_out,), "zero"))
    widths = list(box["LAYERS_N"]) + [box["OUT_CHANNEL"]]
    for k in range(len(widths) - 1):
        spec.append((f"box_head.layers.{2 * k}.weight", (widths[k + 1], widths[k]), "linear"))
        spec.append((f"box_head.layers.{2 * k}.bias", (widths[k + 1],), "zero"))
    return spec


def init_weights(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every tensor of ``spec`` from ``seed``, on ``device``, in two draws
    from one generator there: He-normal convolutions, LeCun-normal
    deconvolutions and linear layers, a small output convolution, unit
    BatchNorm scales (half on each block's second BatchNorm, so the
    residual stream stays bounded), drawn running statistics, zero biases."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    floats = [(n, s, k) for n, s, k in spec if k != "count"]
    sizes = [math.prod(s) for _, s, _ in floats]
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for (name, shape, kind), n in zip(floats, sizes):
        z, u = normal[off:off + n].view(shape), uniform[off:off + n].view(shape)
        off += n
        if kind == "conv":
            t = z * math.sqrt(2.0 / math.prod(shape[1:]))
        elif kind == "deconv":  # (cin, cout, k, k): stride 2 gives each output cin * k * k / 4 taps
            t = z * math.sqrt(4.0 / (shape[0] * shape[2] * shape[3]))
        elif kind == "conv_out":
            t = z * (0.5 / math.sqrt(math.prod(shape[1:])))
        elif kind == "linear":
            t = z * math.sqrt(1.0 / shape[1])
        elif kind == "bn_weight":
            t = torch.full(shape, 0.5 if name.endswith("bn2.weight") else 1.0, device=device)
        elif kind == "bn_mean":
            t = (u - 0.5) * 0.2
        elif kind == "bn_var":
            t = 0.75 + u * 0.5
        else:
            t = torch.zeros(shape, device=device)
        out[name] = t.contiguous()
    for name, shape, kind in spec:
        if kind == "count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
    return out


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 rounding with a per-tensor scale."""
    scale = torch.clamp_min(t.abs().amax(), 1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


class _Rounded(torch.autograd.Function):
    """A layer's operand rounded to a lower precision, and the gradient that
    comes back through it rounded alike: the forward and the backward pass
    both compute on rounded values, as a network run in that precision does."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def _q8(x: torch.Tensor) -> torch.Tensor:
    return _Rounded.apply(x, _fp8)


def _qbf16(x: torch.Tensor) -> torch.Tensor:
    return _Rounded.apply(x, _bf16)


class Ref:
    """The model and losses over a weight dict ``w`` (float32 tensors; the
    trainable ones may require grad)."""

    def __init__(self, recipe: Dict, precision: str = "fp32", dtype=torch.float32):
        self.dt = dtype
        arch = recipe["ARCH"]
        self.head, self.box = arch["HYBRID_HEAD"], arch["BOX_HEAD"]
        preset = recipe["DATA_PRESET"]
        self.inp_res = tuple(preset["IMAGE_SIZE"])
        self.center_idx = int(preset["CENTER_IDX"])
        self.lambdas = [float(x) for x in recipe["LAMBDAS"]]
        self.crit = recipe["CRITERION"]
        self.q = {"fp8": _q8, "bf16": _qbf16}.get(precision, lambda t: t)

    # ---- layers ----
    def conv(self, x, w, stride=1, pad=0, b=None):
        return F.conv2d(self.q(x), self.q(w), b, stride, pad)

    def bn(self, x, w, p, train: bool):
        if train:
            with torch.no_grad():  # flax's running averages: 0.9 old + 0.1 the batch's (biased)
                dims = [0] + list(range(2, x.dim()))
                mean, var = x.mean(dims), x.var(dims, unbiased=False)
                w[p + ".running_mean"] = 0.9 * w[p + ".running_mean"] + 0.1 * mean
                w[p + ".running_var"] = 0.9 * w[p + ".running_var"] + 0.1 * var
            return F.batch_norm(x, None, None, w[p + ".weight"], w[p + ".bias"], True, 0.0, BN_EPS)
        return F.batch_norm(x, w[p + ".running_mean"], w[p + ".running_var"], w[p + ".weight"],
                            w[p + ".bias"], False, 0.0, BN_EPS)

    def backbone(self, x, w, train):
        x = torch.relu(self.bn(self.conv(x, w["backbone.conv1.weight"], 2, 3), w,
                               "backbone.bn1", train))
        x = F.max_pool2d(x, 3, 2, 1)
        cin = 64
        for i, (width, n) in enumerate(STAGES):
            for j in range(n):
                p = f"backbone.layer{i + 1}.{j}"
                stride = 2 if (i > 0 and j == 0) else 1
                idn = x
                if stride != 1 or cin != width:
                    idn = self.bn(self.conv(x, w[p + ".downsample.0.weight"], stride), w,
                                  p + ".downsample.1", train)
                y = torch.relu(self.bn(self.conv(x, w[p + ".conv1.weight"], stride, 1), w,
                                       p + ".bn1", train))
                y = self.bn(self.conv(y, w[p + ".conv2.weight"], 1, 1), w, p + ".bn2", train)
                x = torch.relu(y + idn)
                cin = width
        return x

    def integral_head(self, feat, w, train):
        x = feat
        for k, ks in enumerate(self.head["NUM_DECONV_KERNELS"]):
            # flax's "SAME" stride-2 transpose: output exactly twice the input
            pad_a = ks - 1 if 2 > ks - 1 else -(-ks // 2)
            p = ks - 1 - pad_a
            x = F.conv_transpose2d(self.q(x), self.q(w[f"hybrid_head.deconv_layers.{3 * k}.weight"]),
                                   None, 2, p, max(2 - ks + 2 * p, 0))
            x = torch.relu(self.bn(x, w, f"hybrid_head.deconv_layers.{3 * k + 1}", train))
        x = self.conv(x, w["hybrid_head.final_layer.weight"], 1, 0, w["hybrid_head.final_layer.bias"])
        B, _, H, W = x.shape
        nc, dr = self.head["NCLASSES"], self.head["DEPTH_RESOLUTION"]
        hm = torch.softmax(x.reshape(B, nc, dr * H * W), dim=2).reshape(B, nc, dr, H, W)
        u = (hm.sum(dim=(2, 3)) * (torch.arange(W, device=x.device) / W)).sum(-1)
        v = (hm.sum(dim=(2, 4)) * (torch.arange(H, device=x.device) / H)).sum(-1)
        d = (hm.sum(dim=(3, 4)) * (torch.arange(dr, device=x.device) / dr)).sum(-1)
        return torch.stack([u, v, d], dim=-1)

    def box_head(self, x, w):
        n = len(self.box["LAYERS_N"])
        for k in range(n):
            x = F.linear(self.q(x), self.q(w[f"box_head.layers.{2 * k}.weight"]),
                         w[f"box_head.layers.{2 * k}.bias"])
            if k < n - 1:
                x = torch.relu(x)
        return x

    def forward(self, batch: Dict, w: Dict, train: bool) -> Dict[str, torch.Tensor]:
        img = batch["image"].to(self.dt).permute(0, 3, 1, 2)
        feat = self.backbone(img, w, train)
        uvd = self.integral_head(feat, w, train)
        rot6 = self.box_head(feat.mean(dim=(2, 3)), w)
        intr, root = batch["cam_intr"].to(self.dt), batch["root_joint"].to(self.dt)
        res = torch.tensor(self.inp_res, dtype=self.dt, device=uvd.device)
        z = (uvd[..., 2] - 0.5) * 0.4 + root[:, 2:3]
        f = torch.stack([intr[:, 0, 0], intr[:, 1, 1]], -1)[:, None]
        c = torch.stack([intr[:, 0, 2], intr[:, 1, 2]], -1)[:, None]
        xyz = torch.cat([(uvd[..., :2] * res - c) / f * z[..., None], z[..., None]], -1)
        a, b = rot6[:, 0:3], rot6[:, 3:6]
        ex = a / torch.clamp_min(a.norm(dim=-1, keepdim=True), 1e-8)
        ez = torch.linalg.cross(ex, b, dim=-1)
        ez = ez / torch.clamp_min(ez.norm(dim=-1, keepdim=True), 1e-8)
        ey = torch.linalg.cross(ez, ex, dim=-1)
        rot = torch.stack([ex, ey, ez], dim=-1)
        boxroot = xyz[:, NUM_JOINTS:NUM_JOINTS + 1]
        corners = torch.einsum("bij,bnj->bni", rot, batch["corners_can"].to(self.dt)) + boxroot
        return {"joints_3d_abs": xyz[:, :NUM_JOINTS], "corners_3d_abs": corners,
                "boxroot_3d_abs": boxroot, "box_rot_rotmat": rot}

    # ---- losses ----
    def loss(self, preds: Dict, batch: Dict, draws: List[Dict]) -> torch.Tensor:
        root = batch["root_joint"].to(self.dt)[:, None]
        tj = batch["joints_3d"].to(self.dt) + root
        tc = batch["corners_3d"].to(self.dt) + root
        jv, cv = batch["joints_vis"].to(self.dt), batch["corners_vis"].to(self.dt)
        pj, pc = preds["joints_3d_abs"], preds["corners_3d_abs"]
        total = torch.zeros((), device=pj.device)
        for lam, c, d in zip(self.lambdas, self.crit, draws):
            kind = c["TYPE"]
            if kind == "JointsLoss":
                term = torch.zeros((), device=pj.device)
                if c.get("LAMBDA_JOINTS_3D", 0.0):
                    term = term + c["LAMBDA_JOINTS_3D"] * torch.mean(
                        (pj * jv[..., None] - tj * jv[..., None]) ** 2)
                if c.get("LAMBDA_CORNERS_3D", 0.0):
                    term = term + c["LAMBDA_CORNERS_3D"] * torch.mean(
                        (pc * cv[..., None] - tc * cv[..., None]) ** 2)
            elif kind == "HandOrdLoss":
                term = hand_ord(pj * jv[..., None], tj * jv[..., None], d)
            elif kind == "SceneOrdLoss":
                term = scene_ord(pj * jv[..., None], tj * jv[..., None],
                                 pc * cv[..., None], tc * cv[..., None], d)
            else:
                raise NotImplementedError(kind)
            total = total + lam * term
        return total


def _pairs_all(n: int) -> torch.Tensor:
    return torch.tensor([(i, j) for i in range(n) for j in range(i + 1, n)], dtype=torch.int64)


def _order(a: torch.Tensor, b: torch.Tensor, view: torch.Tensor) -> torch.Tensor:
    """(B, P, 3) difference vectors projected on (V, 3) views -> (B, P, V)."""
    return torch.einsum("bpk,vk->bpv", a - b, view)


def hand_ord(pj, tj, d):
    """Joint-level (log1p of the disagreeing order) and part-level (bone
    cross products, no log) ordinal losses over the drawn pair subsets."""
    view = d["view"].to(pj.dtype)
    jp = _pairs_all(NUM_JOINTS).to(pj.device)[d["sel_j"]]
    ts = torch.sign(_order(tj[:, jp[:, 0]], tj[:, jp[:, 1]], view))
    joint = torch.mean(torch.log1p(torch.relu(-ts * _order(pj[:, jp[:, 0]], pj[:, jp[:, 1]], view))))
    parents = torch.tensor(JOINTS_IDX_PARENTS, device=pj.device)
    tb, pb = (tj - tj[:, parents])[:, 1:], (pj - pj[:, parents])[:, 1:]
    pp = _pairs_all(NUM_JOINTS - 1).to(pj.device)[d["sel_p"]]
    tcr = torch.linalg.cross(tb[:, pp[:, 0]], tb[:, pp[:, 1]], dim=-1)
    pcr = torch.linalg.cross(pb[:, pp[:, 0]], pb[:, pp[:, 1]], dim=-1)
    tps = torch.sign(torch.einsum("bpk,vk->bpv", tcr, view))
    part = torch.mean(torch.relu(-tps * torch.einsum("bpk,vk->bpv", pcr, view)))
    return joint + part


def scene_ord(pj, tj, pc, tc, d):
    """Hand joint against object corner ordinal loss over the drawn pairs."""
    view = d["view"].to(pj.dtype)
    ho = torch.tensor([(i, j) for i in range(NUM_JOINTS) for j in range(NUM_CORNERS)],
                      dtype=torch.int64, device=pj.device)[d["sel"]]
    ts = torch.sign(_order(tj[:, ho[:, 0]], tc[:, ho[:, 1]], view))
    return torch.mean(torch.log1p(torch.relu(-ts * _order(pj[:, ho[:, 0]], pc[:, ho[:, 1]], view))))


class RefAdam:
    """The recipe's update: optax's global-norm clip at GRAD_CLIP, then Adam
    (betas 0.9 and 0.999, eps 1e-8) at the step schedule's constant rate."""

    def __init__(self, names: List[str], lr: float, clip: float, m: Optional[Dict] = None,
                 v: Optional[Dict] = None, t: int = 0):
        self.names, self.lr, self.clip = names, lr, clip
        self.m: Dict[str, torch.Tensor] = {k: x.float().clone() for k, x in (m or {}).items()}
        self.v: Dict[str, torch.Tensor] = {k: x.float().clone() for k, x in (v or {}).items()}
        self.t = int(t)

    @torch.no_grad()
    def step(self, w: Dict, grads: Dict) -> Dict[str, torch.Tensor]:
        """Updates ``w`` in place -> the clipped gradients."""
        norm = torch.sqrt(sum(torch.sum(grads[n] * grads[n]) for n in self.names))
        scale = (self.clip / norm if (self.clip and norm >= self.clip)
                 else torch.ones((), device=norm.device))
        self.t += 1
        clipped = {}
        for n in self.names:
            g = grads[n] * scale
            clipped[n] = g
            m = self.m.get(n, torch.zeros_like(g)) * 0.9 + 0.1 * g
            v = self.v.get(n, torch.zeros_like(g)) * 0.999 + 0.001 * g * g
            self.m[n], self.v[n] = m, v
            denom = torch.sqrt(v) / math.sqrt(1 - 0.999 ** self.t) + 1e-8
            w[n].sub_(self.lr / (1 - 0.9 ** self.t) * m / denom)
        return clipped


def train_steps(recipe: Dict, start: Dict, batches: List[Dict], draws: List[List[Dict]],
                precision: str = "fp32", rows: Optional[slice] = None) -> Dict:
    """The reference's own run of len(batches) train steps from ``start``
    ({"w": weights and running statistics, "m", "v": Adam's moments, "t":
    its step count}): -> {"loss": [per step], "grad1": {leaf: the first
    clipped gradient}, "w": the weights after the last step, "preds1": the
    first step's forward outputs}. ``rows`` trains on a slice of each batch
    only (a planted fault)."""
    w0 = start["w"]
    names = [n for n in w0 if _is_trainable(n)]
    w = {n: t.detach().clone().float() if t.is_floating_point() else t.clone()
         for n, t in w0.items()}
    model = Ref(recipe, precision)
    opt = RefAdam(names, float(recipe["TRAIN"]["LR"]), float(recipe["TRAIN"].get("GRAD_CLIP", 0.0)),
                  start.get("m"), start.get("v"), start.get("t", 0))
    losses, grad1, preds1 = [], None, None
    for batch, d in zip(batches, draws):
        if rows is not None:
            B = batch["image"].shape[0]
            batch = {k: v[rows] if torch.is_tensor(v) and v.dim() and v.shape[0] == B else v
                     for k, v in batch.items()}
        for n in names:
            w[n].requires_grad_(True)
        preds = model.forward(batch, w, train=True)
        if preds1 is None:
            preds1 = {k: v.detach() for k, v in preds.items()}
        loss = model.loss(preds, batch, d)
        grads = torch.autograd.grad(loss, [w[n] for n in names])
        for n in names:
            w[n] = w[n].detach()
        clipped = opt.step(w, dict(zip(names, grads)))
        if grad1 is None:
            grad1 = clipped
        losses.append(float(loss.detach()))
    return {"loss": losses, "grad1": grad1, "w": w, "preds1": preds1}


def weights(recipe: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's weights from ``seed``, made on ``device``."""
    arch = recipe["ARCH"]
    return init_weights(weight_spec(arch["HYBRID_HEAD"], arch["BOX_HEAD"]), seed, device)


def load_into(arch_module, w: Dict[str, torch.Tensor]) -> None:
    """Puts ``w`` into the program's built arch (its one model)."""
    arch_module.model_list[0].load_state_dict(w, strict=True)


def flops(recipe: Dict) -> Dict[str, float]:
    """Operations per image: {"forward", "backward", "train"}."""
    from bench_port.count.flops import clas_flops

    arch = recipe["ARCH"]
    return clas_flops(tuple(recipe["DATA_PRESET"]["IMAGE_SIZE"]), arch["HYBRID_HEAD"],
                      arch["BOX_HEAD"])


def _is_trainable(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var", "num_batches_tracked"))


@torch.no_grad()
def forward_eval(recipe: Dict, w: Dict, batch: Dict, precision: str = "fp32") -> Dict:
    """The model with its running statistics, as a val sweep runs it."""
    return Ref(recipe, precision).forward(batch, {k: v.float() if v.is_floating_point() else v
                                                  for k, v in w.items()}, train=False)
