"""One rank of ``tests/test_torch_dist.py``'s data-parallel run on the CPU
(gloo). It holds no test: the test starts two of these.

    python tests/test_torch_dist_worker.py RANK PORT_A PORT_B WORKDIR CFG OUT

In WORKDIR, after ``mesh.init_distributed`` on PORT_A: the global
BatchNorm on this rank's rows of a seeded batch (outputs, gradients and
running statistics gathered); ``train.main`` with ``--multihost`` for one
epoch with a TEST pass; then, on PORT_B, ``--resume`` of rank 0's
experiment (nothing left to train: the state each rank restored is
recorded). Writes a ``torch.save`` dict to OUT."""
import hashlib
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from artiboost_torch import train  # noqa: E402
from artiboost_torch.artiboost.loader import ArtiBoostLoader  # noqa: E402
from artiboost_torch.models.layers import BatchNorm2d  # noqa: E402
from artiboost_torch.parallel import mesh  # noqa: E402
from artiboost_torch.utils.recorder import NullRecorder, Recorder  # noqa: E402

BN_SHAPE = (8, 5, 3, 4)  # the global batch of the BatchNorm check


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def step_digests(step) -> dict:
    opt = [v for s in step.optimizer.state.values() for v in s.values()
           if isinstance(v, torch.Tensor)]
    return {"params": digest(step.model.parameters()), "buffers": digest(step.model.buffers()),
            "optimizer": digest(opt), "step": step.step}


def loader_digests(state: dict) -> dict:
    """The ArtiBoost state as a checkpoint holds it (``loader.state_dict()``)."""
    return {k: digest([torch.as_tensor(np.asarray(state[k]))])
            for k in ("sample_weight_map", "occurrence_map", "rng_state")}


def bn_check() -> dict:
    """This rank's rows through the global BatchNorm, gathered."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(*BN_SHAPE).astype(np.float32) * 2 + 1)
    c = torch.from_numpy(rng.randn(*BN_SHAPE).astype(np.float32))
    bn = BatchNorm2d(BN_SHAPE[1]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, BN_SHAPE[1]))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, BN_SHAPE[1]))
    lo, hi = mesh.rows(BN_SHAPE[0])
    xl = x[lo:hi].clone().requires_grad_(True)
    y = bn(xl)
    torch.mean(y * c[lo:hi]).backward()  # this rank's loss: a mean over its rows
    mesh.all_reduce_grads(list(bn.parameters()))
    return {"y": mesh.all_gather_rows(y.detach()), "dx": mesh.all_gather_rows(xl.grad),
            "dweight": bn.weight.grad, "dbias": bn.bias.grad,
            "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone()}


def main():
    rank, port_a, port_b = (int(a) for a in sys.argv[1:4])
    workdir, cfg_path, out_path = sys.argv[4:7]
    os.chdir(workdir)
    out = {"rank": rank}
    mesh.init_distributed(f"localhost:{port_a}", 2, rank, device_type="cpu", timeout_s=120)
    out["bn"] = bn_check()

    common = ["--device", "cpu", "--multihost", "--num_processes", "2", "--process_id",
              str(rank)]
    saved = {}
    orig = {"record": Recorder.record_checkpoints, "null": NullRecorder.record_checkpoints}

    def recording(fn):
        def wrapped(self, step, epoch, artiboost_state=None, snapshot=10):
            saved.update(step_digests(step), **loader_digests(artiboost_state))
            return fn(self, step, epoch, artiboost_state, snapshot)
        return wrapped

    Recorder.record_checkpoints = recording(orig["record"])
    NullRecorder.record_checkpoints = recording(orig["null"])
    first = train.main(["--cfg", cfg_path, "--epochs", "1", "--test_freq", "1",
                        "--coordinator", f"localhost:{port_a}"] + common)
    Recorder.record_checkpoints, NullRecorder.record_checkpoints = orig["record"], orig["null"]
    hist = first["history"][0]
    out["saved"] = saved
    out["first"] = dict(step_digests(first["step"]),
                        **loader_digests(first["loader"].state_dict()),
                        final_loss=[float(v) for v in hist["train"]["final_loss"]],
                        measures={k: hist[k]["measures"] for k in ("train", "val", "test")},
                        images=hist["train"]["images"], val_images=hist["val"]["images"])
    if rank == 0:
        out["first"]["model"] = {k: v.clone() for k, v in first["model"].state_dict().items()}
        out["first"]["weight_map"] = first["loader"].ccv.sample_weight_map.clone()
        with open("dump.txt.tmp", "w") as f:
            f.write(first["dump_path"])
        os.replace("dump.txt.tmp", "dump.txt")
    del first
    deadline = time.time() + 60
    while not os.path.isfile("dump.txt"):
        if time.time() > deadline:
            raise TimeoutError("rank 0 wrote no experiment directory")
        time.sleep(0.1)
    with open("dump.txt") as f:
        dump = f.read()

    restored = {}
    orig["load"] = ArtiBoostLoader.load_state_dict

    def load_state_dict(self, state):
        orig["load"](self, state)
        restored.update(loader_digests(self.state_dict()))

    def resume(recorder_cls):
        fn = recorder_cls.resume_checkpoints

        def wrapped(self, step, path=None):
            epoch = fn(self, step, path)
            restored.update(step_digests(step), epoch=epoch)
            return epoch
        return wrapped

    ArtiBoostLoader.load_state_dict = load_state_dict
    Recorder.resume_checkpoints = resume(Recorder)
    NullRecorder.resume_checkpoints = resume(NullRecorder)
    train.main(["--resume", dump, "--epochs", "1", "--test_freq", "0",
                "--coordinator", f"localhost:{port_b}"] + common)
    out["restored"] = restored
    torch.save(out, out_path)


if __name__ == "__main__":
    # the summarizer's tensorboard would import TensorFlow (about 5 s a
    # process) where it is installed; its own stand-in writes the same files
    sys.modules["tensorflow"] = None
    main()
