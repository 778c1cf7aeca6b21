"""Witness runs of the Reg gate (tests/test_torch_gate_reg.py): its
one-epoch run of config/synthetic_smoke_reg.yaml against the JAX loop,
with TRAIN's adam swapped for plain SGD, with every synth batch the JAX
run made replayed into the port's run (so the two differ in no input), and
with both. Each variant prints the gate's figures (``gate_figures``).
The file holds no test, so the suite runs none of it; from the
repository root run

    python -m tests.test_torch_gate_witness [variant ...]

with variants among adam (the gate itself), sgd, adam+replay and
sgd+replay (all four by default), each about 3-6 minutes on the CPU."""
import shutil
import sys
import tempfile
from pathlib import Path

from tests.test_torch_gate import _jax_gate, run_jax_gate, run_torch_gate
from tests.test_torch_gate_reg import CFG, EPOCHS, gate_figures

# the clipped gradient has global norm GRAD_CLIP (1e-3): one step moves the
# parameters by LR * 1e-3 in all
SGD = {"OPTIMIZER": "sgd", "MOMENTUM": 0.0, "LR": 30.0}
VARIANTS = {"adam": {}, "sgd": {"train_cfg": SGD}, "adam+replay": {"synth_batches": True},
            "sgd+replay": {"train_cfg": SGD, "synth_batches": True}}


class _TmpDirs:
    """tmp_path_factory's ``mktemp`` under one directory."""

    def __init__(self):
        self.root = Path(tempfile.mkdtemp(prefix="gate_witness_"))

    def mktemp(self, name):
        return Path(tempfile.mkdtemp(prefix=name, dir=self.root))


def main(names):
    import jax

    jax.config.update("jax_platforms", "cpu")
    for name in names:
        tmp = _TmpDirs()
        try:
            ref = run_jax_gate(tmp, __file__, name)
            fig = gate_figures(run_torch_gate(ref, CFG, EPOCHS, **VARIANTS[name]))
        finally:
            shutil.rmtree(tmp.root, ignore_errors=True)
        print(f"{name}: " + ", ".join(f"{k} {v:.4g}" for k, v in fig.items()), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[3] in VARIANTS:  # the JAX side, in run_jax_gate's call
        import jax

        jax.config.update("jax_platforms", "cpu")
        _jax_gate(sys.argv[1], sys.argv[2], CFG, EPOCHS, **VARIANTS[sys.argv[3]])
    else:
        main(sys.argv[1:] or list(VARIANTS))
