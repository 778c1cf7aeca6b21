"""Witness runs of the real-data slice (tests/test_torch_real_slice.py) at
the size it was first written at: 6 steps at 128 x 128 (32 HO3D frames,
CONFIG_LEN_TRAIN 64, 5 real + 11 synth a batch), one epoch and a TEST pass
of 20 evaluation frames, against the JAX loop. Variants: the fixture and
augmentation ``seed``; ``replay``, every synth batch the JAX run made
replayed into the port's run, so the two differ only in the real image's
last bits (<= 1.3e-5, ROADMAP C); and ``threads``, the port run again at 4
torch threads in place of 1 and held against its own 1-thread run: the
same code and inputs with the float reductions in another order, a
measure of how far float rounding alone moves the figures. Each variant
prints the first step's and every step's final_loss departure and, per
pass, the measure that comes nearest its gate bound (``_bound``), with the
departure over the bound. The file holds no test, so the suite runs none
of it; from the repository root run

    python -m tests.test_torch_real_slice_witness [variant ...]

with variants among seed21 (the slice test's seed), seed22, seed21+replay
and seed21+threads (all four by default), each about 3-5 minutes on the
CPU."""
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

from tests.test_torch_gate import _bound, run_jax_gate, run_torch_gate
from tests.test_torch_real_slice import _jax_real_gate, slice_config

SIZE = dict(size=128, frames=16, config_len=64)
VARIANTS = {"seed21": (21, False, False), "seed22": (22, False, False),
            "seed21+replay": (21, True, False), "seed21+threads": (21, False, True)}


class _TmpDirs:
    """tmp_path_factory's ``mktemp`` under one directory."""

    def __init__(self):
        self.root = Path(tempfile.mkdtemp(prefix="real_witness_"))

    def mktemp(self, name):
        return Path(tempfile.mkdtemp(prefix=name, dir=self.root))


def figures(hist, ref_loss, ref_measure):
    """-> {name: value}: step0 and step (relative final_loss departures),
    and per pass the measure with the largest departure over its bound."""
    loss = np.asarray(hist["train"]["final_loss"], np.float64)
    rel = np.abs(loss / np.asarray(ref_loss, np.float64) - 1)
    fig = {"steps": len(loss), "step0": float(rel[0]), "step": float(rel.max())}
    for split in ("train", "test"):
        worst = (0.0, "", 0.0)
        for name, scalars in hist[split]["measures"].items():
            for k, v in scalars.items():
                r = ref_measure(split, name, k)
                d = abs(v - r) / abs(r) if r else abs(v)
                if d / _bound(name, k) > worst[0]:
                    worst = (d / _bound(name, k), f"{name}/{k}", d)
        fig[split] = worst
    return fig


def show(name, fig):
    parts = [f"steps {fig['steps']}", f"step0 {fig['step0']:.3g}", f"step {fig['step']:.3g}"]
    for split in ("train", "test"):
        ratio, key, d = fig[split]
        parts.append(f"{split} worst {key} {d:.3g} ({ratio:.2f} of its bound)")
    print(f"{name}: " + ", ".join(parts), flush=True)


def main(names):
    import jax

    jax.config.update("jax_platforms", "cpu")
    for name in names:
        seed, replay, threads = VARIANTS[name]
        tmp = _TmpDirs()
        try:
            cfg_path = slice_config(tmp.mktemp("fixture"), seed=seed, **SIZE)
            args = (cfg_path, "replay") if replay else (cfg_path,)
            jax_run = run_jax_gate(tmp, __file__, *args)
            ref, out, _, _ = run_torch_gate(jax_run, cfg_path=cfg_path, epochs=1,
                                            synth_batches=replay)
            hist = out["history"][0]
            show(name, figures(hist, ref["0/train_final_loss"],
                               lambda s, n, k: float(ref[f"0/{s}/{n}/{k}"])))
            if threads:
                _, out4, _, _ = run_torch_gate(jax_run, cfg_path=cfg_path, epochs=1, threads=4)
                h4 = out4["history"][0]
                show(name + " (4 threads against 1)",
                     figures(h4, hist["train"]["final_loss"],
                             lambda s, n, k: float(hist[s]["measures"][n][k])))
        finally:
            shutil.rmtree(tmp.root, ignore_errors=True)


if __name__ == "__main__":
    if len(sys.argv) >= 4 and sys.argv[3].endswith(".yaml"):  # the JAX side, in run_jax_gate's call
        import os

        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_cpu_multi_thread_eigen=false")
        import jax

        jax.config.update("jax_platforms", "cpu")
        _jax_real_gate(sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4:] == ["replay"])
    else:
        main(sys.argv[1:] or list(VARIANTS))
