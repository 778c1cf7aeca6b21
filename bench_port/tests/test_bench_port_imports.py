"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program: top-level module names (the part
before the first dot) compared whole, in a fresh interpreter each."""
import json
import subprocess
import sys

import pytest

from bench_port import run

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{n.split('.')[0] for n in sys.modules}})))
"""


def top_level_modules(imports: str):
    code = PROBE.format(root=run.ROOT, imports=imports)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=run.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_and_the_program_load_no_jax():
    """``bench_port.run`` with every module a run imports: the program's
    builders, its train loop, the summarizer and every metric reader."""
    mods = top_level_modules(
        "import types\n"
        "sys.modules['tensorboard.compat.notf'] = types.ModuleType('tensorboard.compat.notf')\n"
        "from bench_port import run, checks, assets, control, capture\n"
        "for k, n in (('entries', 'train'), ('entries', 'val'), ('reference', 'HybridBaseline')):\n"
        "    run.load_module(k, n)\n"
        "from artiboost_torch import train\n"
        "from artiboost_torch.artiboost.loader import ArtiBoostLoader\n"
        "from artiboost_torch.criterions import build_criterion\n"
        "from artiboost_torch.metrics.evaluator import build_evaluator\n"
        "from artiboost_torch.models.arch import build_arch\n"
        "from artiboost_torch.parallel.train_state import TrainStep\n"
        "from artiboost_torch.utils.summarizer import Summarizer\n"
        "import tempfile; d = tempfile.TemporaryDirectory(); Summarizer(d.name).close(); d.cleanup()\n"
        "from bench_port.count import trace, flops, raster_work\n"
        "for m in json.load(open(run.ROOT + '/BENCHMARK.json'))['per_layer']: run.load_reader(m['name'])\n")
    assert "artiboost_torch" in mods
    assert not mods & set(run.FORBIDDEN)


@pytest.mark.parametrize("module", ["HybridBaseline", "raster", "mano", "metrics", "engine",
                                    "synth"])
def test_reference_loads_nothing_of_the_program(module):
    mods = top_level_modules(f"from bench_port.reference import {module}")
    assert not mods & ({"artiboost_torch"} | set(run.FORBIDDEN))


def test_forbidden_names_are_whole():
    """The port's name begins with the JAX package's: only whole names count."""
    sys.modules.setdefault("artiboost_torch_probe_only", sys)
    try:
        assert "artiboost_torch_probe_only" not in run.forbidden_modules()
    finally:
        del sys.modules["artiboost_torch_probe_only"]
