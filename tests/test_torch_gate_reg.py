"""The Reg family's gate: ``artiboost_torch.train.run`` on the uncut
config/synthetic_smoke_reg.yaml (HOPRegNet with ManoBranch, ManoLoss,
ObjLoss, JointsLoss and the ordinal losses) against the JAX package's
train loop on the CPU, as tests/test_torch_gate.py holds the Clas model,
for one epoch: 8 mixed steps (8 SyntheticHO + 8 synth per batch of 16),
the val sweep (VAL_LEN 32), the ``method_1`` reweight and the TEST pass
over the 32-sample test split (``--test_freq 1``); every
draw of the JAX run replayed, the model started from the flax
initialisation (``hopregnet_from_flax``), the JAX side in a subprocess
with ``--xla_cpu_max_isa=AVX``. tests/test_torch_gate_honet.py holds the
HoNet family the same way; one family a file, so the suite's workers
take them apart. Bounds are in the test's docstring."""
import sys

import numpy as np
import pytest

from tests.test_torch_gate import _jax_gate, run_jax_gate, run_torch_gate

CFG = "config/synthetic_smoke_reg.yaml"
EPOCHS = 1  # the suite's time: each family gate costs what the two-epoch Clas gate does


@pytest.fixture(scope="module")
def jax_gate(tmp_path_factory):
    return run_jax_gate(tmp_path_factory, __file__)


@pytest.fixture(scope="module")
def torch_gate(jax_gate):
    return run_torch_gate(jax_gate, CFG, EPOCHS)


def gate_figures(torch_gate, epochs=EPOCHS) -> dict:
    """Hold what must be exact (the replay counts, every pass's batch count
    and measure names, after each epoch the seen mask and the occurrence
    map) and return the largest departures from the JAX run over the
    ``epochs``: the first step's train ``final_loss`` ("step0", before any
    update), every step's ("step"), the LossesMetric ordinal terms ("ord")
    and the others ("losses"), Mean3DEPE
    ("mean3depe") and ``val_epe_mean`` ("val_epe"), each relative; the
    per-triplet EPE map where seen in mm ("map_mm") and the weight map
    relative ("weights")."""
    ref, out, after, replay = torch_gate
    assert len(out["history"]) == epochs
    assert replay.count == {"triplets": 1 + 2 * epochs, "poses": 1 + 2 * epochs,
                            "synth": epochs * (8 + 2), "perm": 2 * epochs,
                            "loss": epochs * (8 + 2 + 2)}
    fig = dict.fromkeys(("step0", "step", "ord", "losses", "mean3depe", "val_epe", "map_mm", "weights"),
                        0.0)
    kind = {"LossesMetric": "losses", "Mean3DEPE": "mean3depe", "ValMetricMean3DEPE2": "val_epe"}
    for epoch, hist in enumerate(out["history"]):
        assert hist["epoch"] == epoch and hist["train"]["steps"] == 8
        assert hist["val"]["batches"] == 2 and hist["test"]["batches"] == 2
        rel = np.abs(np.asarray(hist["train"]["final_loss"]) / ref[f"{epoch}/train_final_loss"] - 1)
        fig["step"] = max(fig["step"], float(rel.max()))
        if epoch == 0:
            fig["step0"] = float(rel[0])
        for split in ("train", "val", "test"):
            measures = hist[split]["measures"]
            want = {k.split("/")[2] for k in ref if k.startswith(f"{epoch}/{split}/")}
            assert set(measures) == want == ({"LossesMetric", "Mean3DEPE"} | (
                set() if split == "test" else {"ValMetricMean3DEPE2"}))
            for name, scalars in measures.items():
                assert len(scalars) == sum(k.startswith(f"{epoch}/{split}/{name}/") for k in ref)
                for k, v in scalars.items():
                    r = float(ref[f"{epoch}/{split}/{name}/{k}"])
                    f = "ord" if name == "LossesMetric" and "ord" in k else kind[name]
                    fig[f] = max(fig[f], abs(v - r) / abs(r))
        state, seen = after[epoch], ref[f"{epoch}/seen"]
        np.testing.assert_array_equal(state["seen"].numpy(), seen)
        assert int(seen.sum()) == 32
        np.testing.assert_array_equal(state["occurrence"].numpy(), ref[f"{epoch}/occurrence"])
        fig["map_mm"] = max(fig["map_mm"], float(np.abs(state["avg"].numpy()[seen]
                                                        - ref[f"{epoch}/avg"][seen]).max()))
        w = ref[f"{epoch}/weights"]
        assert not np.all(w == 1.0)
        fig["weights"] = max(fig["weights"], float(np.abs(state["weights"].numpy() / w - 1).max()))
    print("gate figures:", fig)
    return fig


BOUNDS = {"step0": 7.6e-4, "step": 0.097, "ord": 0.11, "losses": 0.182, "mean3depe": 0.068,
          "val_epe": 0.034, "map_mm": 18.7, "weights": 0.167}


@pytest.mark.limit(900)
def test_gate_reg_against_jax(torch_gate):
    """Bounds, each 3x the figure measured here over the epoch's three
    passes (in parentheses):
      * the first step's final_loss within 7.6e-4 relative (2.53e-4):
        before any update the runs differ only in their synth images (FK
        sums in another order, ROADMAP C);
      * every step's final_loss within 0.097 relative (0.032; the object
        terms, obj_verts_3d_loss and corners_3d_loss, drift most);
      * LossesMetric: the ordinal terms within 0.11 (0.036), the others
        within 0.182 (0.061);
      * Mean3DEPE within 0.068 (0.023, the corners) and val_epe_mean within
        0.034 (0.011);
      * the per-triplet EPE map within 18.7 mm where seen (6.2 mm, on maps
        of ~190-290 mm) and sample_weight_map within 0.167 relative
        (0.055).
    Where the step drift comes from (``python -m
    tests.test_torch_gate_witness``, the same run with one thing changed;
    "step" figures): not from Adam, since under plain SGD the run reads
    0.0218; nor from the synth images alone, since with every synth batch of
    the JAX run replayed into the port's the run reads 0.0181 (first step
    2.69e-5), and 0.0194 under SGD. With no input difference, six steps of
    the Reg model part from JAX's no faster than six of the Clas model
    (tests/test_torch_train_steps.py): one step's gradients agree to 1e-4 of
    their norms, and each step grows that noise 2-3x. Why this run grows it
    further than the Clas gate's first epoch does (0.0047) is not
    established. Run for two epochs the same gate measured 0.199 a step (the
    Clas gate, tests/test_torch_gate.py: 0.020); one epoch keeps the suite's
    time."""
    fig = gate_figures(torch_gate)
    for k, bound in BOUNDS.items():
        assert fig[k] <= bound, (k, fig[k], bound)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    _jax_gate(sys.argv[1], sys.argv[2], CFG, EPOCHS)
