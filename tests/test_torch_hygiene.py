"""Package hygiene of the port: ``artiboost_torch`` and ``chip_smoke.py``
never import JAX, flax or the JAX package (statically, and by importing
every submodule in a process where those imports fail), and the entry
points (``train``, ``chip_parity``) refuse to fall back to the CPU
quietly."""
import ast
import subprocess
import sys

import pytest
import torch

from tests._proc import REPO, subprocess_env
FORBIDDEN = ("jax", "jaxlib", "flax", "artiboost_tpu")


def _sources():
    return sorted((REPO / "artiboost_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_no_forbidden_imports_anywhere_in_the_source():
    bad = []
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_every_submodule_imports_with_jax_blocked():
    code = (
        "import sys, importlib, importlib.util, pkgutil\n"
        f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
        "import artiboost_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(artiboost_torch.__path__, "
        "'artiboost_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=240,
                         env=subprocess_env())
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout.strip().splitlines()[-1]) >= 25


def test_entry_point_refuses_cpu_fallback(monkeypatch):
    from artiboost_torch import chip_parity, train
    from artiboost_torch.artiboost.loader import ArtiBoostLoader
    from artiboost_torch.artiboost.synth_batch import SynthBatch, SynthConfig
    from artiboost_torch.criterions import build_criterion
    from artiboost_torch.datasets.synthetic import SyntheticHO, build_dataset
    from artiboost_torch.metrics.evaluator import build_evaluator
    from artiboost_torch.parallel.train_state import TrainStep
    from artiboost_torch.utils.config import load_config
    from artiboost_torch.utils.misc import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg_path = REPO / "config" / "synthetic_smoke.yaml"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--cfg", str(cfg_path), "--epochs", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chip_parity.main()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chip_parity.run_all()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ArtiBoostLoader(cfg=train.slice_config(load_config(str(cfg_path))), batch_size=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SynthBatch(None, None, None, SynthConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_evaluator([])
    cfg = load_config(str(cfg_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_dataset(cfg["DATASET"]["TRAIN"], cfg["DATA_PRESET"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyntheticHO(cfg["DATA_PRESET"], N_SAMPLES=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_criterion(cfg).draws(torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainStep(torch.nn.Linear(2, 2), build_criterion(cfg), cfg["TRAIN"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_no_module_raises_not_ported():
    """The bring-up is done: no string in ``artiboost_torch`` (an error's
    message above all) says that something is not ported, or not ported
    yet."""
    import re

    said = re.compile(r"\bnot\s+(yet\s+)?ported\b|\bported\s+yet\b", re.IGNORECASE)
    bad = []
    for path in sorted((REPO / "artiboost_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and said.search(node.value)):
                bad.append(f"{path.relative_to(REPO)}:{node.lineno}")
    assert not bad, bad
