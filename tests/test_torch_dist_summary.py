"""The loss summary under data parallelism: two gloo ranks train
``tests/test_torch_dist.py``'s small config (2 steps of a global batch of
8) through ``train.run``, rank 0 with a summarizer and rank 1 with the
``NullSummarizer`` that ``train.main`` gives it; the losses rank 0
summarizes are the global batch's, as JAX's are: within the bound of
``tests/test_torch_dist.py`` for each step's loss (1e-5 relative) of the
one-process run's summary. Rank 0's own rows' losses part from them by
far more (each rank divides its rows' sum by the global valid count, so
its own figure is about half the global one).

And the CCV draw under a process group (ROADMAP C.2): each rank's
``DrawSource.triplets`` returns rank 0's draw, though each rank's sampler
drew its own (here made to differ, as ``torch.multinomial`` on CUDA did
on separate cards), the generators stay equal, and ``own_digests`` keeps
each rank's own draw from before the broadcast (so a parting shows).

The ranks are this file run as a script:

    python tests/test_torch_dist_summary.py RANK PORT WORKDIR CFG OUT
    python tests/test_torch_dist_summary.py draws RANK PORT OUT
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from artiboost_torch import train  # noqa: E402
from artiboost_torch.artiboost.loader import digest  # noqa: E402
from artiboost_torch.parallel import mesh  # noqa: E402
from artiboost_torch.utils.summarizer import NullSummarizer  # noqa: E402
from tests._proc import subprocess_env  # noqa: E402

RANK_TIMEOUT_S = 150


class ListSummarizer(NullSummarizer):
    """Keeps every loss summary as (step, {key: float})."""

    def __init__(self):
        self.losses = []

    def summarize_losses(self, losses, step, prefix="train"):
        self.losses.append((step, {k: float(v) for k, v in losses.items()}))


def worker():
    rank, port = int(sys.argv[1]), int(sys.argv[2])
    workdir, cfg_path, out_path = sys.argv[3:6]
    os.chdir(workdir)
    import yaml

    with open(cfg_path) as f:
        cfg = yaml.safe_load(f)
    mesh.init_distributed(f"localhost:{port}", 2, rank, device_type="cpu", timeout_s=120)
    try:
        summarizer = ListSummarizer() if rank == 0 else NullSummarizer()
        local = []
        orig = train.global_losses

        def spy(losses):  # keeps this rank's own rows' figures, for contrast
            local.append({k: float(v) for k, v in losses.items() if v is not None})
            return orig(losses)

        train.global_losses = spy
        out = train.run(cfg, epochs=1, device="cpu", summarizer=summarizer, test_freq=0)
    finally:
        mesh.close()
    torch.save({"summary": getattr(summarizer, "losses", None), "local": local,
                "steps": out["history"][0]["train"]["steps"]}, out_path)


def draws_worker():
    """One rank of ``test_ranks_take_rank_0s_draw``: a sampler that draws
    this rank's own ids from the generator."""
    from artiboost_torch.artiboost import loader

    rank, port, out_path = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    mesh.init_distributed(f"localhost:{port}", 2, rank, device_type="cpu", timeout_s=60)
    try:
        def sampler(space, generator, n, replace=True):
            return torch.randint(0, 100, (n,), generator=generator) + 1000 * rank

        loader.sample_triplets_draws = sampler
        source = loader.DrawSource(torch.Generator().manual_seed(3), torch.device("cpu"))
        flat = [source.triplets(None, 6, replace) for replace in (True, False)]
    finally:
        mesh.close()
    torch.save({"flat": flat, "state": source.generator.get_state(),
                "own": source.own_digests}, out_path)


def _spawn(args_of_rank, timeout=RANK_TIMEOUT_S):
    env = subprocess_env()
    procs = [subprocess.Popen([sys.executable, __file__, *args_of_rank(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]


def test_ranks_take_rank_0s_draw(tmp_path):
    from test_torch_dist import _free_port

    port = str(_free_port())
    _spawn(lambda r: ["draws", str(r), port, str(tmp_path / f"draws{r}.pt")])
    got = [torch.load(tmp_path / f"draws{r}.pt", weights_only=False) for r in range(2)]
    for a, b in zip(got[0]["flat"], got[1]["flat"]):
        assert torch.equal(a, b) and int(a.max()) < 1000  # rank 0's ids on both ranks
    assert torch.equal(got[0]["state"], got[1]["state"])
    # each rank's own draws, before the broadcast: rank 0's are what both
    # returned, rank 1's (ids + 1000) differ
    assert got[0]["own"] == [digest(f) for f in got[0]["flat"]]
    assert len(got[1]["own"]) == 2 and all(a != b for a, b in zip(got[0]["own"], got[1]["own"]))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks, then the one-process run of the same config."""
    import yaml
    from test_torch_dist import _free_port, small_config

    d = tmp_path_factory.mktemp("dist_summary")
    cfg = small_config(d / "small.yaml")
    port = str(_free_port())
    env = subprocess_env()
    procs = [subprocess.Popen([sys.executable, __file__, str(r), port, str(d),
                               str(d / "small.yaml"), str(d / f"rank{r}.pt")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for r in range(2)]
    try:
        single = ListSummarizer()
        cwd = os.getcwd()
        os.chdir(d)
        try:
            train.run(cfg, epochs=1, device="cpu", summarizer=single, test_freq=0)
        finally:
            os.chdir(cwd)
        logs = [p.communicate(timeout=RANK_TIMEOUT_S)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    assert yaml.safe_load((d / "small.yaml").read_text())["TRAIN"]["BATCH_SIZE"] == 8
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(2)], single


def test_two_rank_summary_is_the_global_batchs(ranks):
    (r0, r1), single = ranks
    assert r1["summary"] is None and r0["steps"] == 2
    assert len(r0["summary"]) == len(single.losses) == 1  # bidx 0 of 2 (LOG_EVERY 20)
    (step, got), (want_step, want) = r0["summary"][0], single.losses[0]
    assert step == want_step == 1 and set(got) == set(want) and "final_loss" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0, err_msg=k)
    # every rank entered the collective, and rank 0's own rows part from it
    assert len(r0["local"]) == len(r1["local"]) == 1
    mean = {k: (r0["local"][0][k] + r1["local"][0][k]) / 2 for k in want}
    np.testing.assert_allclose(mean["final_loss"], got["final_loss"], rtol=1e-6)
    assert abs(r0["local"][0]["final_loss"] - want["final_loss"]) > 1e-3 * want["final_loss"]


if __name__ == "__main__":
    sys.modules["tensorflow"] = None  # the summarizer's stand-in needs none
    draws_worker() if sys.argv[1] == "draws" else worker()
