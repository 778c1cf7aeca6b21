"""Batched MANO mesh fitting (counterpart of
``artiboost_tpu/postprocess/fitting.py:1-170``; reference
``anakin/postprocess/iknet/fittingunit.py``).

The whole batch fits at once: a warm start (IKNet, or the flat hand), then
Adam (b1 0.5, b2 0.5, eps 1e-8, lr 0.03) on one scalar residual, the mean
over the batch of pose and shape regularisers, the normalised joint error
and the finger-planarity prior, so each row's gradient carries the same
1/B as in JAX. Each step is one autograd backward through MANO on the
device. IKNet's weights come from ``assets/iknet_tpu.npz``
(``load_iknet_params``); ``IKNetTrainStep`` trains them (JAX
``make_iknet_train_step``, :160-217) and ``save_iknet_params`` writes
that npz (``python -m artiboost_torch.scripts.train_iknet``)."""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from artiboost_torch.mano.layer import mano_forward, mano_forward_rotmat
from artiboost_torch.mano.model import ManoModel, get_mano_model
from artiboost_torch.postprocess.iknet import IKNet
from artiboost_torch.utils.misc import asset_path, logger, resolve_device
from artiboost_torch.utils.transform import aa_to_quat, quat_to_rotmat

IKNET_WEIGHTS = "assets/iknet_tpu.npz"
ADAM_B1, ADAM_B2, ADAM_EPS = 0.5, 0.5, 1e-8


def geo_prior(joints: torch.Tensor) -> torch.Tensor:
    """Finger planarity and ordering prior (fittingunit.py geo(), :43-59)."""
    a, b, c, d = (joints[:, [k, k + 4, k + 8, k + 12, k + 16]] for k in (1, 2, 3, 4))
    v_ab, v_bc, v_cd = a - b, b - c, c - d
    n1 = torch.linalg.cross(v_ab, v_bc)
    loss_1 = torch.abs(torch.sum(n1 * v_cd, -1)).mean()
    loss_2 = -torch.clamp(torch.sum(n1 * torch.linalg.cross(v_bc, v_cd), -1), max=0.0).mean()
    return 1e4 * loss_1 + 1e5 * loss_2


def load_iknet_params(path: str) -> Dict[str, torch.Tensor]:
    """The flat npz of IKNet's flax variables (the JAX package's
    ``save_iknet_params``) -> the state dict of ``IKNet``."""
    from artiboost_torch.utils.convert import iknet_from_flax, load_flax_npz

    return iknet_from_flax(load_flax_npz(path))


def _bone(j: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """|joint 9 - joint 0| of (B, 21, 3) -> (B, 1, 1)."""
    return torch.linalg.norm(j[:, 9] - j[:, 0] + eps, dim=1, keepdim=True)[:, None]


class FittingUnit:
    """joints (B, 21, 3) in camera space -> fitted MANO verts and joints.

    ``ik_mode``: ``iknet`` warm-starts from IKNet and runs 20 steps;
    ``iksolver`` starts from the flat hand (zero pose) and runs 100."""

    def __init__(self, mano_model: Optional[ManoModel] = None, n_steps: Optional[int] = None,
                 lr: float = 0.03, iknet_state: Optional[Dict[str, torch.Tensor]] = None,
                 ik_mode: str = "iknet", device=None):
        if ik_mode not in ("iknet", "iksolver"):
            raise ValueError(f"unknown ik_mode {ik_mode!r} (choices: iknet, iksolver)")
        self.device = resolve_device(device)
        self.mano_model = mano_model if mano_model is not None else get_mano_model(
            device=self.device)
        self.ik_mode = ik_mode
        self.n_steps = int(n_steps) if n_steps is not None else (20 if ik_mode == "iknet" else 100)
        self.lr = lr
        self.iknet = None
        if ik_mode == "iknet":
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                self.iknet = IKNet()
            if iknet_state is None:
                path = asset_path(IKNET_WEIGHTS)
                if os.path.isfile(path):
                    iknet_state = load_iknet_params(path)
                else:
                    logger.warning(f"fitting: {IKNET_WEIGHTS} not found; IKNet init is RANDOM "
                                   "(fit quality degrades; run python -m "
                                   "artiboost_torch.scripts.train_iknet)")
            if iknet_state is not None:
                self.iknet.load_state_dict(iknet_state)
            self.iknet = self.iknet.to(self.device).eval()

    def _normalise(self, joints_abs: torch.Tensor):
        """-> (root (B, 1, 3), bone (B, 1, 1), root-relative joints over bone)."""
        root = joints_abs[:, 0:1]  # the wrist, the fitting unit's root
        bone = _bone(joints_abs)
        return root, bone, (joints_abs - root) / torch.clamp_min(bone, 1e-8)

    @torch.no_grad()
    def init_pose(self, joints_norm: torch.Tensor) -> torch.Tensor:
        """The warm start (B, 48): IKNet's so3, or the flat hand."""
        if self.iknet is None:
            return torch.zeros((joints_norm.shape[0], 48), device=joints_norm.device)
        return self.iknet(joints_norm)[0]

    def residual(self, so3, beta, so3_init, beta_init, joints_norm, root, bone):
        """The scalar the Adam loop descends (fitting.py ``residuals``)."""
        out = mano_forward(self.mano_model, so3, beta)
        j = out.joints - out.joints[:, 0:1]
        j_norm = j / torch.clamp_min(_bone(j, 1e-8), 1e-8)
        reg = torch.mean((so3 - so3_init) ** 2)
        reg_beta = torch.mean((beta - beta_init) ** 2)
        errkp = torch.mean((j_norm - joints_norm) ** 2)
        # geo_prior carries its own 1e4 / 1e5 weights
        return 0.01 * reg + 0.01 * reg_beta + errkp + geo_prior(j_norm * bone + root)

    @torch.no_grad()
    def decode(self, so3: torch.Tensor, beta: torch.Tensor, root: torch.Tensor,
               bone: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The MANO mesh of (so3, beta) scaled to ``bone`` and moved to
        ``root`` in camera space."""
        out = mano_forward(self.mano_model, so3, beta)
        v = out.verts - out.joints[:, 0:1]
        j = out.joints - out.joints[:, 0:1]
        scale = bone / torch.clamp_min(_bone(j, 1e-8), 1e-8)
        return {"hand_verts": v * scale + root, "joints": j * scale + root,
                "so3": so3, "beta": beta}

    def warm_start(self, joints_abs: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The decode of the warm start alone, with no fitting step."""
        root, bone, joints_norm = self._normalise(joints_abs.float())
        so3 = self.init_pose(joints_norm)
        return self.decode(so3, torch.zeros((so3.shape[0], 10), device=so3.device), root, bone)

    def __call__(self, joints_abs, batch: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        joints_abs = torch.as_tensor(joints_abs, device=self.device).float()
        root, bone, joints_norm = self._normalise(joints_abs)
        so3_init = self.init_pose(joints_norm)
        beta_init = torch.zeros((so3_init.shape[0], 10), device=so3_init.device)
        params = [so3_init.clone().requires_grad_(True), beta_init.clone().requires_grad_(True)]
        mu = [torch.zeros_like(p) for p in params]
        nu = [torch.zeros_like(p) for p in params]
        # optax.adam's order of operations: moments, bias correction, the step
        for t in range(1, self.n_steps + 1):
            with torch.enable_grad():
                loss = self.residual(*params, so3_init, beta_init, joints_norm, root, bone)
                grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                for p, g, m, v in zip(params, grads, mu, nu):
                    m.copy_((1.0 - ADAM_B1) * g + ADAM_B1 * m)
                    v.copy_((1.0 - ADAM_B2) * (g * g) + ADAM_B2 * v)
                    m_hat = m / (1.0 - ADAM_B1 ** t)
                    v_hat = v / (1.0 - ADAM_B2 ** t)
                    p.add_(-self.lr * (m_hat / (torch.sqrt(v_hat) + ADAM_EPS)))
        return self.decode(params[0].detach(), params[1].detach(), root, bone)


class IKNetTrainStep:
    """One Adam step (optax.adam: b1 0.9, b2 0.999, eps 1e-8) of IKNet in
    train mode on synthetic MANO data (JAX ``make_iknet_train_step``): random
    poses, their FK joints normalised as ``FittingUnit`` normalises them, and
    the loss w_quat * the sign-invariant quaternion error plus w_joints * the
    normalised joints' recovery through ``quat_to_rotmat`` and
    ``mano_forward_rotmat`` (never through ``quat_to_aa``, singular at
    identity). BatchNorm takes flax's update (``models/layers.py``).

    ``draws(generator, B)`` -> {"pose" (B, 48) and "shape" (B, 10) standard
    normal, "sigma" U(0.05, 0.5) (B, 1)}; ``step(draws)`` -> the detached
    metrics {loss, l_quat, l_joints}."""

    def __init__(self, mano_model: ManoModel, iknet: IKNet, learning_rate: float = 1e-3,
                 w_quat: float = 1.0, w_joints: float = 10.0):
        self.mano_model, self.iknet = mano_model, iknet
        self.weights = (w_quat, w_joints)
        self.optimizer = torch.optim.Adam(iknet.parameters(), lr=learning_rate,
                                          betas=(0.9, 0.999), eps=1e-8)

    def draws(self, generator: torch.Generator, B: int = 256) -> Dict[str, torch.Tensor]:
        device = next(self.iknet.parameters()).device
        return {"pose": torch.randn(B, 48, generator=generator, device=device),
                "shape": torch.randn(B, 10, generator=generator, device=device),
                "sigma": torch.rand(B, 1, generator=generator, device=device) * 0.45 + 0.05}

    def _normalised_joints(self, out) -> torch.Tensor:
        j = out.joints - out.joints[:, 0:1]
        return j / torch.clamp_min(_bone(j), 1e-8)

    @torch.no_grad()
    def sample_batch(self, draws: Dict) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(normalised joints (B, 21, 3), target quaternions (B, 16, 4) with
        w >= 0, shape (B, 10)) (JAX ``_sample_batch``)."""
        pose = draws["pose"] * draws["sigma"]
        shape = draws["shape"] * 0.5
        j_norm = self._normalised_joints(mano_forward(self.mano_model, pose, shape))
        q_tgt = aa_to_quat(pose.reshape(-1, 16, 3))
        q_tgt = q_tgt * torch.sign(q_tgt[..., :1] + 1e-12)
        return j_norm, q_tgt, shape

    def loss(self, draws: Dict) -> Tuple[torch.Tensor, Dict]:
        j_norm, q_tgt, shape = self.sample_batch(draws)
        _, quat = self.iknet(j_norm)
        l_quat = torch.mean(torch.minimum(torch.sum((quat - q_tgt) ** 2, -1),
                                          torch.sum((quat + q_tgt) ** 2, -1)))
        out = mano_forward_rotmat(self.mano_model, quat_to_rotmat(quat), shape)
        l_joints = torch.mean(torch.sum((self._normalised_joints(out) - j_norm) ** 2, -1))
        w_quat, w_joints = self.weights
        loss = w_quat * l_quat + w_joints * l_joints
        return loss, {"loss": loss, "l_quat": l_quat, "l_joints": l_joints}

    def __call__(self, draws: Dict) -> Dict:
        self.iknet.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.loss(draws)
        loss.backward()
        self.optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}



def save_iknet_params(iknet: IKNet, path: str) -> None:
    """The JAX package's flat npz of IKNet's flax variables ("params/...",
    "batch_stats/..."), which ``load_iknet_params`` here and there read."""
    from artiboost_torch.utils.convert import iknet_to_flax, save_flax_npz

    save_flax_npz(iknet_to_flax(iknet.state_dict()), path)
