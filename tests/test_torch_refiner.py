"""The port's ``hand_obj`` refiner against the JAX package: the chamfer
search, RefineNet with the in-repo weights (``assets/refinenet_tpu.npz``),
the ITERS = 3 refinement, ``build_refiner``'s weight fallback and the pose
sweep with the refiner in it.

Tolerances: chamfer distances at rtol 1e-5 plus atol 5e-7 m^2, with
equal indices (the sets are random, so exact ties do not occur). The
absolute term is two float32 steps of |x|^2 + |y|^2 (~1.5 m^2 at 0.5 m):
jitted XLA contracts |x|^2 + |y|^2 - 2 x.y into an FMA, and the
cancellation leaves that rounding as an absolute error (measured
2.4e-7). FK from rotation matrices at atol 1e-6 (measured 1.8e-7 on the
transforms, 1.2e-7 on the axis-angle report). RefineNet's deltas at atol
1e-5 (LayerNorm's variance is summed in another order). The refinement
(run under jit on the JAX side, as the pose generator runs it) and the
pose sweep go through FK three times plus the final FK; XLA's sin/cos
differ from torch's in the last bit (ROADMAP C), and RefineNet amplifies
the difference through its 778 distance inputs. Measured: the refinement
1.8e-6 on the axis-angle pose, 8.9e-8 m on the translation, 2.2e-7 m on
the joints; the pose sweep 5.3e-6 on the pose and 3.8e-7 m on the
translation. Both tests hold 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artiboost_torch.artiboost import refiner as t_ref
from artiboost_torch.artiboost.grasp_library import synthetic_grasp_library
from artiboost_torch.artiboost.object_library import synthetic_object_library
from artiboost_torch.artiboost.pose_generator import PoseGenerator as t_make_pg
from artiboost_torch.artiboost.scrambler import Scrambler as t_scrambler
from artiboost_torch.artiboost.view_engine import ViewEngineConfig as TViewCfg
from artiboost_torch.mano.model import synthetic_mano_model
from artiboost_torch.ops.chamfer import chamfer_distance as t_chamfer
from artiboost_torch.utils.convert import refinenet_from_flax
from artiboost_tpu.artiboost import refiner as j_ref
from artiboost_tpu.artiboost.grasp_library import synthetic_grasp_library as j_grasps
from artiboost_tpu.artiboost.object_library import synthetic_object_library as j_objs
from artiboost_tpu.artiboost.pose_generator import make_pose_generator as j_make_pg
from artiboost_tpu.artiboost.scrambler import build_scrambler as j_scrambler
from artiboost_tpu.artiboost.view_engine import ViewEngineConfig as JViewCfg
from artiboost_tpu.mano.model import synthetic_mano_model as j_mano
from artiboost_tpu.ops.chamfer import chamfer_distance as j_chamfer
from test_torch_engine import OBJS, SCRAM, jax_view_scram_draws

HO = {"TYPE": "hand_obj", "PRETRAINED": "assets/GrabNet/refinenet.pt", "ITERS": 3}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per process while this file runs: the suite runs
    several workers on the host's cores, and a per-op thread pool in each
    of them oversubscribes the cores and makes these small ops several
    times slower. Every comparison here is made at one thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_ho():
    """The JAX MANO model and its hand_obj refiner on the in-repo weights,
    built once: what ``build_refiner(HO, ...)`` returns, without the flax
    init that it runs (and compiles) before it loads them."""
    jm = j_mano()
    return jm, j_ref.make_ho_refiner(jm, j_ref.RefineNet(), _jax_params(), n_iters=HO["ITERS"])


def _jax_params():
    from artiboost_tpu.utils.misc import asset_path

    return j_ref.load_refiner_params(asset_path("assets/refinenet_tpu.npz"))


@pytest.mark.parametrize("masks", ["none", "x", "y", "both"])
def test_chamfer_against_jax(masks):
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 50, 3) * 0.05 + 0.5).astype(np.float32)
    y = (rng.randn(3, 70, 3) * 0.05 + 0.5).astype(np.float32)
    mx = (rng.rand(3, 50) > 0.3).astype(np.float32) if masks in ("x", "both") else None
    my = (rng.rand(3, 70) > 0.3).astype(np.float32) if masks in ("y", "both") else None
    j = j_chamfer(jnp.asarray(x), jnp.asarray(y), None if mx is None else jnp.asarray(mx),
                  None if my is None else jnp.asarray(my), return_idx=True)
    t = t_chamfer(torch.from_numpy(x), torch.from_numpy(y),
                  None if mx is None else torch.from_numpy(mx),
                  None if my is None else torch.from_numpy(my), return_idx=True)
    for a, b in zip(t[:2], j[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=5e-7)
    for a, b in zip(t[2:], j[2:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if my is not None:
        assert (t[1].numpy()[my == 0] == 0).all() and my[np.arange(3)[:, None], t[2].numpy()].all()


def test_mano_forward_rotmat_against_jax():
    """FK from rotation matrices, as the refiner's loop calls it. The port
    reports no axis-angle pose there; JAX's, taken by the JAX refiner's jit
    only to be dropped, equals ``rotmat_to_aa`` of the same matrices."""
    from artiboost_torch.mano.layer import mano_forward_rotmat as t_fk
    from artiboost_torch.utils.transform import aa_to_rotmat, rotmat_to_aa
    from artiboost_tpu.mano.layer import mano_forward_rotmat as j_fk

    rng = np.random.RandomState(4)
    rots = aa_to_rotmat(torch.from_numpy((rng.randn(5, 16, 3) * 0.4).astype(np.float32)))
    betas = (rng.randn(5, 10) * 0.5).astype(np.float32)
    out = t_fk(synthetic_mano_model(device="cpu"), rots, torch.from_numpy(betas))
    assert out.full_poses is None
    j = j_fk(j_mano(), jnp.asarray(rots.numpy()), jnp.asarray(betas))
    for name in ("verts", "joints", "transforms_abs"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(j, name)),
                                   atol=1e-6, rtol=0, err_msg=name)
    np.testing.assert_allclose(rotmat_to_aa(rots).reshape(5, 48).numpy(),
                               np.asarray(j.full_poses), atol=1e-6, rtol=0)


def test_refinenet_forward_against_flax():
    params = _jax_params()
    net = t_ref.RefineNet()
    net.load_state_dict(refinenet_from_flax(params["params"]))
    rng = np.random.RandomState(1)
    dist = (rng.rand(4, 778) * 0.05).astype(np.float32)
    pose6d = rng.randn(4, 96).astype(np.float32)
    trans = (rng.randn(4, 3) * 0.1).astype(np.float32)
    jd = j_ref.RefineNet().apply(jax.tree_util.tree_map(jnp.asarray, params),
                                 jnp.asarray(dist), jnp.asarray(pose6d), jnp.asarray(trans))
    with torch.no_grad():
        td = net(torch.from_numpy(dist), torch.from_numpy(pose6d), torch.from_numpy(trans))
    for a, b in zip(td, jd):
        assert float(np.abs(np.asarray(b)).max()) > 1e-4  # the weights are trained, not zero
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


def _feed(rng, B):
    return {"hand_pose": (rng.randn(B, 48) * 0.3).astype(np.float32),
            "hand_tsl": (rng.randn(B, 3) * 0.02).astype(np.float32),
            "hand_shape": (rng.randn(B, 10) * 0.5).astype(np.float32)}


def test_ho_refiner_against_jax(jax_ho):
    _, jrefine = jax_ho
    tm = synthetic_mano_model(device="cpu")
    trefine = t_ref.build_refiner(HO, tm, device="cpu")
    rng = np.random.RandomState(2)
    B = 6
    feed = _feed(rng, B)
    oid = rng.randint(0, 4, B)
    jo, to = j_objs(OBJS), synthetic_object_library(OBJS, device="cpu")
    # under jit, as the JAX pose generator runs it
    jout = jax.jit(jrefine)({k: jnp.asarray(v) for k, v in feed.items()}, jo.verts[oid],
                            jo.vert_valid[oid])
    tout = trefine({k: torch.from_numpy(v) for k, v in feed.items()},
                   to.verts[torch.from_numpy(oid)], to.vert_valid[torch.from_numpy(oid)])
    moved = np.abs(np.asarray(jout["hand_tsl"]) - feed["hand_tsl"]).max()
    assert moved > 1e-4, "the refiner left the translation unchanged"
    for k, atol in (("hand_pose", 1e-5), ("hand_tsl", 1e-5), ("joints", 1e-5),
                    ("hand_verts", 1e-5)):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), atol=atol, rtol=0,
                                   err_msg=k)


def test_build_refiner_fallback(tmp_path, caplog):
    tm = synthetic_mano_model(device="cpu")
    null = t_ref.build_refiner({"TYPE": "null"}, tm, device="cpu")
    assert null.__qualname__.startswith("make_null_refiner")
    rng = np.random.RandomState(3)
    feed = {k: torch.from_numpy(v) for k, v in _feed(rng, 2).items()}
    objs = synthetic_object_library(OBJS, device="cpu")
    args = (feed, objs.verts[:2], objs.vert_valid[:2])
    # absent PRETRAINED (the released config's GrabNet .pt) and none at all
    # both fall back to the in-repo npz
    outs = [t_ref.build_refiner(dict(HO, PRETRAINED=p), tm, device="cpu")(*args)
            for p in ("assets/GrabNet/refinenet.pt", None)]
    for k in outs[0]:
        torch.testing.assert_close(outs[0][k], outs[1][k], rtol=0, atol=0)
    assert not torch.equal(outs[0]["hand_tsl"], feed["hand_tsl"])
    # a configured npz that exists is loaded as given
    params = _jax_params()
    path = tmp_path / "zeros.npz"
    np.savez(path, **{"params/" + "/".join(k): np.zeros_like(v)
                      for k, v in _flat(params["params"]).items()})
    zero = t_ref.build_refiner(dict(HO, PRETRAINED=str(path)), tm, device="cpu")(*args)
    torch.testing.assert_close(zero["hand_tsl"], feed["hand_tsl"], rtol=0, atol=0)
    # an existing file that is not an npz: the identity refiner, with a warning
    pt = tmp_path / "refinenet.pt"
    pt.write_bytes(b"not flax")
    with caplog.at_level("WARNING", logger="artiboost_torch"):
        ident = t_ref.build_refiner(dict(HO, PRETRAINED=str(pt)), tm, device="cpu")(*args)
    assert any("identity refiner" in r.message for r in caplog.records)
    torch.testing.assert_close(ident["hand_tsl"], feed["hand_tsl"], rtol=0, atol=0)
    torch.testing.assert_close(ident["hand_pose"], feed["hand_pose"], rtol=0, atol=2e-6)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def test_pose_sweep_with_ho_refiner_against_jax(jax_ho):
    vcfg_j, vcfg_t = JViewCfg(6, 8), TViewCfg(6, 8)
    (jm, jrefine), tm = jax_ho, synthetic_mano_model(device="cpu")
    jgen = j_make_pg(jm, j_objs(OBJS), j_grasps(4, 16), vcfg_j, j_scrambler(SCRAM), jrefine)
    tgen = t_make_pg(tm, synthetic_object_library(OBJS, device="cpu"),
                     synthetic_grasp_library(4, 16, device="cpu"), vcfg_t, t_scrambler(SCRAM),
                     t_ref.build_refiner(HO, tm, device="cpu"))
    rng = np.random.RandomState(7)
    B = 16
    oid, vid, gid = rng.randint(0, 4, B), rng.randint(0, 48, B), rng.randint(0, 16, B)
    key = jax.random.PRNGKey(11)
    jout = jgen(key, jnp.asarray(oid), jnp.asarray(vid), jnp.asarray(gid))
    tout = tgen(torch.from_numpy(oid), torch.from_numpy(vid), torch.from_numpy(gid),
                jax_view_scram_draws(key, B, vcfg_j))
    for name in jout._fields:
        np.testing.assert_allclose(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)),
                                   atol=1e-5, rtol=0, err_msg=name)
