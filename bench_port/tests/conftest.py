"""The benchmark's own tests: ``python -m pytest bench_port/tests -q``
from the root of a checkout. Tests that need a CUDA card carry the
``card`` marker and skip, inside their fixture, where there is none; on
the card they run with the rest."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the benchmark measures only on one")
    return torch.device("cuda")


SMALL_MESH = {"n_lat": 12, "n_lon": 16, "tex_size": 64}
SMALL = {
    "overrides": {"TRAIN.BATCH_SIZE": 4, "MANAGER.CONFIG_LEN_TRAIN": 12, "MANAGER.VAL_LEN": 8},
    "asset_sizes": {"ycb_mesh": SMALL_MESH, "ycb_supp_mesh": SMALL_MESH, "backgrounds": 4,
                    "html_hands": [0, 1, 3], "html_tex_size": 64},
}


@pytest.fixture(scope="session")
def small_cache(tmp_path_factory):
    """One asset directory for the session's small CPU runs."""
    return str(tmp_path_factory.mktemp("bench_port_cache"))


@pytest.fixture(autouse=True)
def keep_cwd():
    """A run works from its asset directory; give each test the one it had."""
    cwd = os.getcwd()
    yield
    os.chdir(cwd)
