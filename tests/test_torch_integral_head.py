"""The integral head's options in the port (``artiboost_torch/models/
integral_head.py`` and the stride-2 SAME deconv of ``models/layers.py``)
against the JAX head on the CPU: every NORM_TYPE (softmax, sigmoid,
divide_sum) over deconv kernels 2, 3 and 4 and final convs 1 and 3, in
train and eval mode; one forward and backward of a narrow HybridBaseline
with sigmoid and 3-tap deconvs; the converter's round trip of 2- and 3-tap
deconv weights; HEATMAP_SIZE; the errors JAX raises.

The flax head is initialised by flax, its BatchNorm parameters and
statistics are randomised from a numpy seed, and its variables are carried
to the port by ``artiboost_torch.utils.convert``. Tolerances are stated in
each test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from artiboost_torch.models.arch import build_arch as t_build_arch
from artiboost_torch.models.integral_head import IntegralDeconvHead as THead
from artiboost_torch.models.integral_head import build_integral_deconv_head
from artiboost_torch.models.layers import ConvTranspose2d, same_transpose_pads
from artiboost_torch.utils.config import load_config
from artiboost_torch.utils.convert import (_integral_head, deconv_weight,
                                           hybrid_baseline_from_flax, hybrid_baseline_to_flax)
from artiboost_tpu.models import build_arch as j_build_arch
from artiboost_tpu.models.integral_head import IntegralDeconvHead as JHead

NORMS = ("softmax", "sigmoid", "divide_sum")
KERNELS = (2, 3, 4)
# the narrow head: 3 classes, depth 4, two deconvs of 8 filters over a
# 2 x 2 feature of 8 channels -> 8 x 8 heatmaps. Every deconv kernel of a
# size has one shape, (k, k, 8, 8), so that flax's initialiser compiles
# once for it
NC, D, FILTERS, CIN, B = 3, 4, (8, 8), 8, 2
# float32 on both sides, summed in another order: softmax and sigmoid
# agree to 3.3e-7 here, held at 1e-5. divide_sum divides by the sum of
# signed logits, which amplifies float32 rounding by the map's size over
# that sum: 5.9e-5 on a coordinate of 19.5 and 1.2e-5 relative here (train
# mode), held at 1e-4
HEAD_TOL = {"softmax": 1e-5, "sigmoid": 1e-5, "divide_sum": 1e-4}
CLAS = "config/synthetic_smoke.yaml"


def _randomize(tree, rng):
    """BatchNorm scale/bias and running statistics drawn from ``rng``; the
    convolution kernels stay flax's."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k == "mean":
            out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k in ("var", "scale"):
            out[k] = (0.5 + rng.rand(*v.shape)).astype(np.float32)
        elif k == "bias" and v.ndim == 1 and not np.any(v):
            out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _heads(norm, kernel, final, seed=0):
    """(flax head, its variables, the port's head holding them, feature)."""
    rng = np.random.RandomState(seed)
    feat = rng.randn(B, 2, 2, CIN).astype(np.float32)
    jhead = JHead(nclasses=NC, depth_res=D, heatmap_size=(8, 8), norm_type=norm,
                  deconv_filters=FILTERS, deconv_kernels=(kernel, kernel),
                  final_conv_kernel=final)
    variables = jhead.init(jax.random.PRNGKey(seed), jnp.asarray(feat), train=False)
    variables = {c: _randomize(jax.tree_util.tree_map(np.asarray, t), rng)
                 for c, t in variables.items()}
    thead = THead(in_channels=CIN, nclasses=NC, depth_res=D, heatmap_size=(8, 8),
                  norm_type=norm, deconv_filters=FILTERS, deconv_kernels=(kernel, kernel),
                  final_conv_kernel=final)
    sd = {}
    _integral_head(sd, variables["params"], variables["batch_stats"], "h")
    thead.load_state_dict({k[len("h."):]: v for k, v in sd.items()})
    return jhead, variables, thead, feat


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("final", [1, 3])
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("norm", NORMS)
def test_head_forward_against_jax(norm, kernel, final, train):
    """kp3d and kp3d_confd within HEAD_TOL (rtol = atol) of the JAX head;
    in train mode the BatchNorm running statistics within 1e-5 too (flax's
    momentum-0.9 update)."""
    jhead, variables, thead, feat = _heads(norm, kernel, final)
    if train:
        jout, new = jhead.apply(variables, jnp.asarray(feat), train=True,
                                mutable=["batch_stats"])
    else:
        jout = jhead.apply(variables, jnp.asarray(feat), train=False)
    thead.train(train)
    with torch.no_grad():
        tout = thead(torch.from_numpy(feat.transpose(0, 3, 1, 2).copy()))
    for k in ("kp3d", "kp3d_confd"):
        assert tout[k].dtype == torch.float32
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), err_msg=k,
                                   rtol=HEAD_TOL[norm], atol=HEAD_TOL[norm])
    if train:
        for i in range(len(FILTERS)):
            bn = thead.deconv_layers[3 * i + 1]
            s = new["batch_stats"][f"BatchNorm_{i}"]
            np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(s["mean"]),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(s["var"]),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel", [1, 2, 3, 4, 5])
def test_deconv_alignment_against_flax(kernel):
    """The port's ConvTranspose2d gives flax's ``ConvTranspose(k, 2,
    "SAME")`` on 5 x 5 inputs: 10 x 10 out, within 1e-5. For k = 3 torch's
    usual ``padding=1, output_padding=1`` is one pixel off and reads O(1)."""
    rng = np.random.RandomState(kernel)
    x = rng.randn(2, 5, 5, CIN).astype(np.float32)
    fdeconv = fnn.ConvTranspose(FILTERS[0], (kernel, kernel), strides=(2, 2), padding="SAME",
                                use_bias=False)
    kern = fdeconv.init(jax.random.PRNGKey(kernel), jnp.asarray(x))["params"]["kernel"]
    ref = np.asarray(fdeconv.apply({"params": {"kernel": kern}}, jnp.asarray(x)))
    assert ref.shape == (2, 10, 10, FILTERS[0])
    layer = ConvTranspose2d(CIN, FILTERS[0], kernel)
    with torch.no_grad():
        layer.weight.copy_(deconv_weight(np.asarray(kern)))
        got = layer(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    pad_a, pad_b = same_transpose_pads(kernel)
    assert pad_a + pad_b == kernel
    if kernel == 3:
        assert (pad_a, pad_b) == (2, 1)
        usual = torch.nn.ConvTranspose2d(CIN, FILTERS[0], 3, 2, padding=1, output_padding=1,
                                         bias=False)
        with torch.no_grad():
            usual.weight.copy_(layer.weight)
            off = usual(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
        assert np.abs(off.transpose(0, 2, 3, 1) - ref).max() > 0.1


def _clas_cfg(norm, kernels):
    cfg = load_config(CLAS)
    cfg["ARCH"]["HYBRID_HEAD"].update(NORM_TYPE=norm, NUM_DECONV_KERNELS=list(kernels))
    preset = dict(cfg["DATA_PRESET"], IMAGE_SIZE=[64, 64], HEATMAP_SIZE=[8, 8])
    return cfg, preset


def test_hybrid_baseline_step_sigmoid_3tap():
    """One forward and backward of config/synthetic_smoke.yaml's
    HybridBaseline with NORM_TYPE sigmoid and deconv kernels (3, 3)
    (float32, 64 x 64, train-mode BatchNorm, its criterion) from one flax
    initialisation, batch and ordinal draws: every loss, and each gradient
    tensor relative to its norm, within tests/test_torch_model.py's TOL
    (1e-4)."""
    from artiboost_torch.criterions import build_criterion as t_crit
    from artiboost_torch.parallel.train_state import TrainStep
    from artiboost_tpu.criterions import build_criterion as j_crit
    from tests.test_torch_model import TOL
    from tests.test_torch_models_reg import _train_batch
    from tests.test_torch_train import _rel_err, jax_loss_draws, to_torch_draws

    cfg, preset = _clas_cfg("sigmoid", (3, 3))
    batch = _train_batch(np.random.RandomState(8))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jarch, jcrit = j_build_arch(cfg["ARCH"], preset), j_crit(cfg)
    variables = jax.jit(lambda k, b: jarch.init(k, b, train=True))(jax.random.PRNGKey(9), jb)
    key = jax.random.PRNGKey(10)

    def loss_fn(params):
        preds, _ = jarch.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               jb, train=True, mutable=["batch_stats"])
        return jcrit.compute_losses(preds, jb, key)

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    m0 = lambda tree: jax.tree_util.tree_map(np.asarray, tree["model_list_0"])  # noqa: E731
    tarch = t_build_arch(cfg["ARCH"], preset)
    assert tarch.model_list[0].hybrid_head.norm_type == "sigmoid"
    tarch.model_list[0].load_state_dict(hybrid_baseline_from_flax(
        {"params": m0(variables["params"]), "batch_stats": m0(variables["batch_stats"])}))
    step = TrainStep(tarch, t_crit(cfg), cfg["TRAIN"], device="cpu")
    _, tlosses = step.forward_backward({k: torch.from_numpy(v) for k, v in batch.items()},
                                       to_torch_draws(jax_loss_draws(jax, key, jcrit)))
    assert set(tlosses) == set(jlosses)
    for k in jlosses:
        np.testing.assert_allclose(float(tlosses[k]), float(jlosses[k]), err_msg=k, **TOL)
    want = hybrid_baseline_from_flax({"params": m0(jgrads),
                                      "batch_stats": m0(variables["batch_stats"])})
    got = {n[len("model_list.0."):]: p.grad for n, p in tarch.named_parameters()
           if p.requires_grad}
    worst = max(_rel_err(got[k].numpy(), want[k].numpy()) for k in got)
    assert worst <= TOL["rtol"], worst


@pytest.mark.parametrize("kernel", [2, 3])
def test_convert_round_trips_deconv(kernel):
    """flax -> port -> flax (``hybrid_baseline_from_flax``'s head map and
    ``hybrid_baseline_to_flax``) returns every leaf of the head bit-exact,
    the 2- or 3-tap ConvTranspose_i kernels in their flax layout."""
    _, variables, thead, _ = _heads("sigmoid", kernel, 3, seed=kernel)
    assert thead.deconv_layers[0].weight.shape == (CIN, FILTERS[0], kernel, kernel)
    back = hybrid_baseline_to_flax({"hybrid_head." + k: v for k, v in thead.state_dict().items()})
    for coll in ("params", "batch_stats"):
        want, got = variables[coll], back[coll]["hybrid_head"]
        assert set(got) == set(want)
        for mod, leaves in want.items():
            assert set(got[mod]) == set(leaves), mod
            for leaf, v in leaves.items():
                assert got[mod][leaf].shape == v.shape, (mod, leaf)
                assert np.array_equal(got[mod][leaf], v), (mod, leaf)


def test_heatmap_size_read_from_the_preset():
    """HEATMAP_SIZE comes from the DATA_PRESET through ``build_arch``
    (default (28, 28), as in JAX), and a head's own key overrides it."""
    cfg, preset = _clas_cfg("sigmoid", (4, 4))
    head = t_build_arch(cfg["ARCH"], dict(preset, HEATMAP_SIZE=[8, 6])).model_list[0].hybrid_head
    assert head.heatmap_size == (8, 6)
    assert build_integral_deconv_head(NCLASSES=NC).heatmap_size == (28, 28)
    assert build_integral_deconv_head(HEATMAP_SIZE=[16, 12]).heatmap_size == (16, 12)


def test_unknown_norm_type_raises():
    """As JAX's norm_heatmap does, at the head's forward."""
    jhead, variables, thead, feat = _heads("softmax", 4, 1)
    with pytest.raises(NotImplementedError):
        jhead.clone(norm_type="l1").apply(variables, jnp.asarray(feat))
    thead.norm_type = "l1"
    with pytest.raises(NotImplementedError):
        thead.eval()(torch.from_numpy(feat.transpose(0, 3, 1, 2).copy()))


@pytest.mark.parametrize("heatmap_size", [(8, 4), (7, 7)])
@pytest.mark.parametrize("norm", ["sigmoid", "divide_sum"])
def test_heatmap_size_that_does_not_fit_raises(norm, heatmap_size):
    """8 x 8 heatmaps read back at a HEATMAP_SIZE of another area fail in
    the port's reshape as in JAX's; they are not reinterpreted."""
    jhead, variables, thead, feat = _heads(norm, 4, 1)
    with pytest.raises(TypeError, match="cannot reshape"):
        jhead.clone(heatmap_size=heatmap_size).apply(variables, jnp.asarray(feat))
    thead.heatmap_size = heatmap_size
    with pytest.raises(RuntimeError, match="shape"):
        thead.eval()(torch.from_numpy(feat.transpose(0, 3, 1, 2).copy()))
