"""The train step replayed as CUDA graphs (``parallel/train_state.py``
``StepGraphs``): the signature a pair of graphs is keyed by, the policy of
when a step warms up, captures, replays or stays eager, and on a card the
replayed step against the eager one.

The policy tests run on the CPU with a stand-in for the graph pair that
keeps the pair's static buffers and runs each half eagerly on them when
"replayed". The ``card`` tests skip without CUDA; on a card (whose
machine has no JAX, so without the suite's conftest)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train_graphs.py -q
"""
import copy
import gc
import io
import math

import pytest
import torch

from artiboost_torch.parallel import mesh
from artiboost_torch.parallel import train_state as ts
from artiboost_torch.parallel.train_state import StepGraphs, TrainStep, step_signature
from artiboost_torch.utils.batching import KEY_VALID, union_concat

ADAM = {"OPTIMIZER": "adam", "LR": 1e-3, "GRAD_CLIP": 0.001}
CPU = torch.device("cpu")


# ---- the signature ----

def _batch(B=4, dtype=torch.float32, masked=False):
    g = torch.Generator().manual_seed(B)
    synth = {"image": torch.rand(B, 8, 8, 3, generator=g).to(dtype),
             "joints_3d": torch.randn(B, 21, 3, generator=g),
             "root_joint": torch.randn(B, 3, generator=g), "obj_id": torch.arange(B)}
    if not masked:
        return synth
    real = {k: v for k, v in synth.items() if k != "root_joint"}
    return union_concat([real, synth])


def _draws(n=10):
    return [{}, {"view": torch.zeros(n, 3), "sel_j": torch.arange(n)}]


def test_signature_keys_shapes_dtypes_masks_and_draws():
    sig = step_signature(_batch(), _draws(), CPU)
    assert sig == step_signature(_batch(), _draws(), CPU)  # the values do not enter it
    assert hash(sig) == hash(step_signature(_batch(), _draws(), CPU))
    others = [step_signature(_batch(B=6), _draws(), CPU),
              step_signature(_batch(dtype=torch.bfloat16), _draws(), CPU),
              step_signature(_batch(), _draws(n=12), CPU),
              step_signature(dict(_batch(), extra=torch.zeros(1)), _draws(), CPU),
              step_signature(_batch(), [{}, {"view": torch.zeros(10, 3)}], CPU)]
    assert all(o is not None and o != sig for o in others)
    assert len(set(others)) == len(others)
    masked = _batch(masked=True)
    assert KEY_VALID in masked and "root_joint" in masked[KEY_VALID]
    msig = step_signature(masked, _draws(), CPU)
    assert msig is not None and msig != sig
    # a mask over another key is another signature
    other = dict(masked, **{KEY_VALID: {"joints_3d": masked[KEY_VALID]["root_joint"]}})
    assert step_signature(other, _draws(), CPU) != msig
    # host values are part of it: a graph bakes them in
    assert step_signature(dict(_batch(), n=1), _draws(), CPU) != step_signature(
        dict(_batch(), n=2), _draws(), CPU)


def test_signature_refuses_what_a_replay_cannot_copy():
    assert step_signature(_batch(), _draws(), torch.device("cuda")) is None  # off the device
    assert step_signature(dict(_batch(), ids=[1, 2]), _draws(), CPU) is None
    assert step_signature(_batch(), [{"view": object()}], CPU) is None


# ---- the policy ----

def test_graphs_apply_on_one_cuda_device_only(monkeypatch):
    assert ts.graphs_apply(torch.device("cuda")) is True
    assert ts.graphs_apply(CPU) is False
    # any process group keeps the step eager, one of a single rank too
    monkeypatch.setattr(mesh, "active", lambda: True)
    for world in (1, 2):
        monkeypatch.setattr(mesh, "world", lambda world=world: world)
        assert ts.graphs_apply(torch.device("cuda")) is False


class _Model(torch.nn.Module):
    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.lin = torch.nn.Linear(3, 2)

    def forward(self, batch):
        return {"y": self.lin(batch["joints_3d"]).sum(1)}


class _Criterion:
    def compute_losses(self, preds, batch, draws):
        total = (preds["y"] ** 2).mean() + 0.0 * draws[1]["view"].sum()
        return total, {"final_loss": total}


def _step():
    return TrainStep(_Model(), _Criterion(), ADAM, device="cpu")


def test_the_cpu_step_is_eager_with_the_plain_optimizer():
    step = _step()
    assert step.graphs is None and step.lr is None
    assert not step.optimizer.defaults["capturable"]
    assert isinstance(step.optimizer.param_groups[0]["lr"], float)


def test_the_optimizer_is_capturable_where_graphs_apply(monkeypatch):
    monkeypatch.setattr(ts, "graphs_apply", lambda device: False)
    model = _Model()
    opt, _ = ts.build_optimizer(ADAM, list(model.named_parameters()))
    assert not opt.defaults["capturable"]
    monkeypatch.setattr(ts, "graphs_apply", lambda device: True)
    opt, _ = ts.build_optimizer(ADAM, list(model.named_parameters()))
    assert opt.defaults["capturable"] and torch.is_tensor(opt.param_groups[0]["lr"])


class _CpuPair(ts._Pair):
    """The pair's bookkeeping without a card: capture records, replay runs
    the half eagerly on the static buffers."""
    fail = False

    def __init__(self, batch, loss_draws):
        self.update = None
        self.batch = ts._static_like(batch)
        self.draws = [ts._static_like(d) for d in loss_draws]
        self.load(batch, loss_draws)

    def capture_fb(self, step):
        if self.fail:
            for p in step.params:  # what a capture cut short leaves behind
                p.grad = torch.full_like(p, 7.0)
            raise RuntimeError("operation not permitted when stream is capturing")
        self.step = step

    def replay_fb(self, params):
        step = self.step
        step.optimizer.zero_grad(set_to_none=True)
        preds = step.model(self.batch)
        total, losses = step.criterion.compute_losses(preds, self.batch, self.draws)
        total.backward()
        return ({k: v.detach().clone() for k, v in preds.items()},
                {k: v.detach().clone() for k, v in losses.items()})

    def capture_update(self, step):
        self.update = step

    def replay_update(self):
        step = self.update
        ts.clip_by_global_norm(step.params, step.grad_clip)
        step.optimizer.step()


def _graphed(monkeypatch, pair=_CpuPair):
    monkeypatch.setattr(ts, "_Pair", pair)
    step = _step()
    step.graphs = StepGraphs(step)
    return step


class _Spans:
    """``profiling.trace`` recording each span's name and counts."""

    def __init__(self, monkeypatch):
        self.seen = []
        spans = self

        class Span:
            def __init__(self, name, counts):
                self.counts = dict(counts)
                spans.seen.append((name, self.counts))

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

            def count(self, **counts):
                self.counts.update(counts)

        monkeypatch.setattr(ts.profiling, "trace", lambda name, **counts: Span(name, counts))

    def counts(self, name="model/forward_backward"):
        return [c for n, c in self.seen if n == name]


def _run(step, batches):
    return [step(b, _draws()) for b in batches]


def test_warm_up_then_capture_then_replay(monkeypatch):
    spans = _Spans(monkeypatch)
    eager, graphed = _step(), _graphed(monkeypatch)
    batches = [_batch() for _ in range(4)]
    want, got = _run(eager, batches), _run(graphed, batches)
    for (wp, wl), (gp, gl) in zip(want, got):
        assert torch.equal(wp["y"], gp["y"]) and torch.equal(wl["final_loss"], gl["final_loss"])
    assert all(torch.equal(a, b) for a, b in zip(eager.params, graphed.params))
    assert graphed.graphs.captures == 2 and graphed.graphs.fallbacks == 0  # fb and update
    fb = spans.counts()[-4:]
    assert [c["graph"] for c in fb] == [0, 1, 1, 1]
    assert [c.get("capture", 0) for c in fb] == [0, 1, 0, 0]
    assert [c.get("capture", 0) for c in spans.counts("model/update")[-4:]] == [0, 1, 0, 0]


def _sig(B):
    return step_signature(_batch(B=B), _draws(), CPU)


def test_the_cap_on_pairs_holds(monkeypatch):
    spans = _Spans(monkeypatch)
    step = _graphed(monkeypatch)
    sizes = [2, 3, 4, 2, 3, 4, 2, 3, 4]
    _run(step, [_batch(B=b) for b in sizes])
    graphs = step.graphs
    assert set(graphs.pairs) == {_sig(2), _sig(3)} and len(graphs.pairs) == StepGraphs.MAX_PAIRS
    assert _sig(4) not in graphs.pairs and not graphs.eager  # the third: eager, no entry
    assert graphs.captures == 4
    assert [c["graph"] for c in spans.counts()] == [0, 0, 0, 1, 1, 0, 1, 1, 0]


def test_one_off_signatures_take_no_slot(monkeypatch):
    """Signatures seen once hold no slot, and only the last ``MAX_SEEN`` of
    them are kept: a signature that recurs later still captures."""
    spans = _Spans(monkeypatch)
    step = _graphed(monkeypatch)
    one_offs = list(range(5, 5 + 3 * StepGraphs.MAX_SEEN))
    _run(step, [_batch(B=b) for b in one_offs])
    graphs = step.graphs
    assert not graphs.pairs and graphs.captures == 0
    assert list(graphs.seen) == [_sig(b) for b in one_offs[-StepGraphs.MAX_SEEN:]]
    _run(step, [_batch(B=b) for b in (2, 3, 2, 3, 2, 3)])
    assert set(graphs.pairs) == {_sig(2), _sig(3)} and graphs.captures == 4
    # 2 and 3 pushed out the two oldest one-offs, and left on their capture
    assert list(graphs.seen) == [_sig(b) for b in one_offs[2 - StepGraphs.MAX_SEEN:]]
    assert [c["graph"] for c in spans.counts()[-6:]] == [0, 0, 1, 1, 1, 1]
    # a one-off seen once more before it is forgotten captures
    step.graphs.pairs.clear()
    _run(step, [_batch(B=one_offs[-1])])
    assert _sig(one_offs[-1]) in graphs.pairs and spans.counts()[-1]["graph"] == 1


def test_a_capture_that_raises_leaves_its_signature_eager(monkeypatch):
    class Failing(_CpuPair):
        fail = True

    spans = _Spans(monkeypatch)
    eager, graphed = _step(), _graphed(monkeypatch, Failing)
    batches = [_batch() for _ in range(4)]
    want = _run(eager, batches[:2])
    got = _run(graphed, batches[:2])
    assert graphed.graphs.fallbacks == 1 and graphed.graphs.captures == 0
    sig = step_signature(batches[0], _draws(), CPU)
    assert sig in graphed.graphs.eager and sig not in graphed.graphs.pairs
    # the failed capture's gradients are gone: the step is the eager one
    assert torch.equal(want[1][1]["final_loss"], got[1][1]["final_loss"])
    assert all(torch.equal(a, b) for a, b in zip(eager.params, graphed.params))
    assert all(torch.equal(a.grad, b.grad) for a, b in zip(eager.params, graphed.params))
    _run(graphed, batches[2:])
    assert graphed.graphs.fallbacks == 1 and graphed.graphs.captures == 0
    fb = spans.counts()[-4:]
    assert [c["graph"] for c in fb] == [0, 0, 0, 0]
    assert [c.get("fallback", 0) for c in fb] == [0, 1, 0, 0]


def test_a_capturable_checkpoint_resumes_on_the_cpu():
    """A checkpoint of the graphed step, loaded to the host as ``Recorder``
    loads it (capturable groups, foreach, a rate tensor), resumes on the
    CPU as the CPU step's own checkpoint does, and the caller's dict is
    left as it was."""
    batches = [_batch() for _ in range(5)]
    src = _step()
    _run(src, batches[:2])
    saved = copy.deepcopy(src.optimizer.state_dict())
    card = copy.deepcopy(saved)
    for g in card["param_groups"]:
        g.update(capturable=True, foreach=True, lr=torch.tensor(g["lr"]))
    mine, theirs = _step(), _step()
    for step, state in ((mine, saved), (theirs, card)):
        step.model.load_state_dict(src.model.state_dict())
        step.optimizer.load_state_dict(state)
        step.step = src.step
    assert all(g["capturable"] and torch.is_tensor(g["lr"]) for g in card["param_groups"])
    for g, want in zip(theirs.optimizer.param_groups, mine.optimizer.param_groups):
        assert not g["capturable"] and g["foreach"] is None
        assert g["lr"] == float(torch.tensor(want["lr"]))  # the saved float32 rate
        assert isinstance(g["lr"], float)
    want, got = _run(mine, batches[2:]), _run(theirs, batches[2:])
    assert all(torch.equal(w[1]["final_loss"], g[1]["final_loss"]) for w, g in zip(want, got))
    assert all(torch.equal(a, b) for a, b in zip(mine.params, theirs.params))


# ---- on a card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: CUDA graphs are captured and replayed only on one")
    return torch.device("cuda", torch.cuda.current_device())


def _clas(card, cfg_train=None):
    """The config's Clas model in bf16 at 64 x 64, its criterion, and a
    batch maker and draw maker on the card."""
    from artiboost_torch.criterions import build_criterion
    from artiboost_torch.models.arch import build_arch
    from artiboost_torch.utils.config import load_config

    cfg = load_config("config/synthetic_smoke.yaml")
    cfg["ARCH"]["DTYPE"] = "bfloat16"
    preset = dict(cfg["DATA_PRESET"], IMAGE_SIZE=[64, 64])
    torch.manual_seed(0)
    arch = build_arch(cfg["ARCH"], preset)
    train = dict(cfg["TRAIN"], **(cfg_train or {}))
    gen = torch.Generator(device=card).manual_seed(5)

    def batch(B=8, S=64):
        r = lambda *s: torch.rand(*s, generator=gen, device=card)  # noqa: E731
        intr = torch.tensor([[180.0, 0, 32], [0, 180.0, 32], [0, 0, 1]], device=card)
        return {"image": r(B, S, S, 3) - 0.5, "cam_intr": intr.expand(B, 3, 3).contiguous(),
                "root_joint": r(B, 3) * 0.02 + torch.tensor([0, 0, 0.5], device=card),
                "corners_can": (r(B, 8, 3) - 0.5) * 0.1, "joints_3d": (r(B, 21, 3) - 0.5) * 0.1,
                "corners_3d": (r(B, 8, 3) - 0.5) * 0.1, "joints_vis": (r(B, 21) > 0.2).float(),
                "corners_vis": (r(B, 8) > 0.2).float()}

    def draws(criterion):
        return criterion.draws(gen, card)

    return arch, (lambda: build_criterion(cfg)), train, batch, draws


def _state(step):
    """Parameters, BatchNorm statistics and Adam's moments, copied."""
    out = {f"p.{n}": p.detach().clone() for n, p in step.model.named_parameters()}
    out.update({f"b.{n}": b.detach().clone() for n, b in step.model.named_buffers()})
    for n, p in step.named_params:
        st = step.optimizer.state.get(p, {})
        out.update({f"{k}.{n}": v.detach().clone() for k, v in st.items() if torch.is_tensor(v)})
    return out


def _pair_of_steps(card, cfg_train=None, n=5, B=8):
    """The same seeded model trained n steps eagerly and through the graphs,
    on the same batches and draws -> (eager step, graphed step, the eager
    steps' outputs, the graphed ones' outputs)."""
    arch, crit, train, batch, draws = _clas(card, cfg_train)
    eager = TrainStep(copy.deepcopy(arch), crit(), train, device=card)
    graphed = TrainStep(copy.deepcopy(arch), crit(), train, device=card)
    eager.graphs = None  # the same capturable optimizer, every step eager
    inputs = [(batch(B), draws(eager.criterion)) for _ in range(n)]
    outs = {}
    for name, step in (("eager", eager), ("graphed", graphed)):
        outs[name] = [step(b, d) for b, d in inputs]
    torch.cuda.synchronize()
    return eager, graphed, outs["eager"], outs["graphed"]


def _same(a, b):
    return {k: float((a[k].float() - b[k].float()).abs().max()) for k in a
            if not torch.equal(a[k], b[k])}


@pytest.mark.card
def test_graphed_steps_are_the_eager_steps_bit_for_bit(card):
    eager, graphed, want, got = _pair_of_steps(card)
    assert graphed.graphs.captures == 2 and graphed.graphs.fallbacks == 0
    for (wp, wl), (gp, gl) in zip(want, got):
        assert not _same(wp, gp) and not _same(wl, gl)
    assert not _same(_state(eager), _state(graphed))
    assert set(_state(eager)) == set(_state(graphed))


@pytest.mark.card
def test_returned_outputs_outlive_the_next_replay(card):
    arch, crit, train, batch, draws = _clas(card)
    step = TrainStep(arch, crit(), train, device=card)
    outs, copies = [], []
    for _ in range(5):
        preds, losses = step(batch(), draws(step.criterion))
        outs.append((preds, losses))
        copies.append(({k: v.clone() for k, v in preds.items()},
                       {k: v.clone() for k, v in losses.items()}))
    assert step.graphs.captures == 2
    for (p, l), (pc, lc) in zip(outs, copies):
        assert not _same(p, pc) and not _same(l, lc)
    assert not torch.equal(outs[-1][1]["final_loss"], outs[-2][1]["final_loss"])


@pytest.mark.card
def test_halves_replaced_before_the_first_step_are_what_runs(card):
    """The benchmark's two plants: an update that leaves the state as it was
    (the graphed step's parameters stay the seeded ones), and the loss over
    half of each batch (the graphed losses are the eager step's with it)."""
    arch, crit, train, batch, draws = _clas(card)
    step = TrainStep(copy.deepcopy(arch), crit(), train, device=card)
    before = _state(step)
    step.update = lambda: setattr(step, "step", step.step + 1)
    for _ in range(4):
        step(batch(), draws(step.criterion))
    assert step.graphs.captures == 1  # fb only: the update never ran
    after = _state(step)
    assert not _same({k: v for k, v in before.items() if k.startswith("p.")},
                     {k: v for k, v in after.items() if k.startswith("p.")})

    def halve(crit_obj):
        orig = crit_obj.compute_losses

        def half(preds, b, d):
            B = b["image"].shape[0]
            cut = lambda x: {k: v[:B // 2] if torch.is_tensor(v) and v.dim() and v.shape[0] == B  # noqa: E731
                             else v for k, v in x.items()}
            return orig(cut(preds), cut(b), d)
        crit_obj.compute_losses = half

    eager = TrainStep(copy.deepcopy(arch), crit(), train, device=card)
    graphed = TrainStep(copy.deepcopy(arch), crit(), train, device=card)
    eager.graphs = None
    halve(eager.criterion)
    halve(graphed.criterion)
    inputs = [(batch(), draws(eager.criterion)) for _ in range(4)]
    want = [eager(b, d)[1] for b, d in inputs]
    got = [graphed(b, d)[1] for b, d in inputs]
    assert graphed.graphs.captures == 2
    assert all(not _same(w, g) for w, g in zip(want, got))


@pytest.mark.card
def test_the_rate_follows_a_cosine_schedule_across_replays(card):
    cos = {"SCHEDULER": "cosine", "TOTAL_STEPS": 6, "WARMUP_STEPS": 2, "LR": 1e-3}
    eager, graphed, _, _ = _pair_of_steps(card, cos, n=6)
    assert graphed.graphs.captures == 2
    # after update k the rate tensor holds the schedule at k
    want = [graphed.schedule(k) for k in range(6)]
    assert len(set(want)) > 3 and math.isclose(float(graphed.lr), want[-1], rel_tol=1e-6)
    assert not _same(_state(eager), _state(graphed))
    rates = []
    arch, crit, train, batch, draws = _clas(card, cos)
    step = TrainStep(arch, crit(), train, device=card)
    for _ in range(6):
        step(batch(), draws(step.criterion))
        rates.append(float(step.lr))
    assert rates == [float(torch.tensor(r, dtype=torch.float32)) for r in want]


@pytest.mark.card
def test_a_forward_that_syncs_runs_eagerly_and_is_counted(card):
    arch, crit, train, batch, draws = _clas(card)
    eager = TrainStep(copy.deepcopy(arch), crit(), train, device=card)
    graphed = TrainStep(copy.deepcopy(arch), crit(), train, device=card)
    eager.graphs = None
    for step in (eager, graphed):
        orig = step.model.forward
        step.model.forward = lambda b, orig=orig: (float(b["image"].sum()), orig(b))[1]
    inputs = [(batch(), draws(eager.criterion)) for _ in range(4)]
    want = [eager(b, d) for b, d in inputs]
    got = [graphed(b, d) for b, d in inputs]
    assert graphed.graphs.fallbacks == 1 and graphed.graphs.captures == 0
    assert all(not _same(w[1], g[1]) for w, g in zip(want, got))
    assert not _same(_state(eager), _state(graphed))
    # the process captures on: a sound step afterwards replays
    _, _, w2, g2 = _pair_of_steps(card, n=3)
    assert all(not _same(a[1], b[1]) for a, b in zip(w2, g2))


@pytest.mark.card
def test_loading_a_state_drops_the_graphs(card):
    arch, crit, train, batch, draws = _clas(card)
    step = TrainStep(arch, crit(), train, device=card)
    for _ in range(3):
        step(batch(), draws(step.criterion))
    assert step.graphs.captures == 2 and any(step.graphs.pairs.values())
    saved = copy.deepcopy(step.optimizer.state_dict())
    step.optimizer.load_state_dict(saved)
    assert not step.graphs.pairs
    assert all(g["lr"] is step.lr and g["capturable"] for g in step.optimizer.param_groups)
    for _ in range(2):
        step(batch(), draws(step.criterion))
    assert step.graphs.captures == 4
    step.model.load_state_dict(copy.deepcopy(step.model.state_dict()))
    assert not step.graphs.pairs


def _checkpoint(step):
    """The step's model and optimizer through ``torch.save`` and back,
    loaded to the host as ``Recorder.resume_checkpoints`` loads them."""
    buf = io.BytesIO()
    torch.save({"model": step.model.state_dict(), "optimizer": step.optimizer.state_dict()}, buf)
    buf.seek(0)
    return torch.load(buf, map_location="cpu", weights_only=True)


def _resume(step, ckpt, at):
    step.model.load_state_dict(ckpt["model"])
    step.optimizer.load_state_dict(ckpt["optimizer"])
    step.step = at


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else
            v.to(device) if torch.is_tensor(v) else v for k, v in tree.items()}


@pytest.mark.card
def test_checkpoints_resume_across_capturable_and_plain_steps(card, monkeypatch):
    """A checkpoint of a card step without graphs (a process group's: plain
    Adam, step counts on the host) resumes into the graphed step, which then
    replays as an eager capturable step does from it; the graphed step's
    checkpoint resumes on the CPU."""
    arch, crit, train, batch, draws = _clas(card)
    with monkeypatch.context() as m:
        m.setattr(ts, "graphs_apply", lambda device: False)
        plain = TrainStep(copy.deepcopy(arch), crit(), train, device=card)
    assert plain.graphs is None and not plain.optimizer.defaults["capturable"]
    for _ in range(2):
        plain(batch(), draws(plain.criterion))
    ckpt = _checkpoint(plain)
    assert ckpt["optimizer"]["state"][0]["step"].device.type == "cpu"
    eager = TrainStep(copy.deepcopy(arch), crit(), train, device=card)
    graphed = TrainStep(copy.deepcopy(arch), crit(), train, device=card)
    for step in (eager, graphed):
        _resume(step, ckpt, plain.step)
        assert all(st["step"].device == card for st in step.optimizer.state.values())
        assert all(g["capturable"] and g["lr"] is step.lr for g in step.optimizer.param_groups)
    eager.graphs = None
    inputs = [(batch(), draws(eager.criterion)) for _ in range(4)]
    want = [eager(b, d) for b, d in inputs]
    got = [graphed(b, d) for b, d in inputs]
    assert graphed.graphs.captures == 2 and graphed.graphs.fallbacks == 0
    assert all(not _same(w[1], g[1]) for w, g in zip(want, got))
    assert not _same(_state(eager), _state(graphed))

    ckpt = _checkpoint(graphed)
    groups = ckpt["optimizer"]["param_groups"]
    assert all(g["capturable"] and torch.is_tensor(g["lr"]) for g in groups)
    cpu = TrainStep(copy.deepcopy(arch), crit(), train, device="cpu")
    _resume(cpu, ckpt, graphed.step)
    assert all(not g["capturable"] and isinstance(g["lr"], float)
               for g in cpu.optimizer.param_groups)
    before = [p.detach().clone() for p in cpu.params]
    b, d = batch(), draws(eager.criterion)
    _, losses = cpu(_to(b, CPU), [_to(x, CPU) for x in d])
    assert math.isfinite(float(losses["final_loss"]))
    assert all(st["step"].device == CPU for st in cpu.optimizer.state.values())
    assert any(not torch.equal(a, p) for a, p in zip(before, cpu.params))


@pytest.mark.card
def test_a_graph_left_to_the_collector_does_not_end_a_capture(card):
    """A step's graphs sit in reference cycles (the step, its hooks): the
    collector destroys them when it runs, which must not be inside another
    step's capture. Here the forward itself collects, during the capture
    too."""
    arch, crit, train, batch, draws = _clas(card)
    old = TrainStep(copy.deepcopy(arch), crit(), train, device=card)
    for _ in range(3):
        old(batch(), draws(old.criterion))
    assert old.graphs.captures == 2
    del old  # garbage in a cycle, graphs and all
    step = TrainStep(copy.deepcopy(arch), crit(), train, device=card)
    orig = step.model.forward
    step.model.forward = lambda b: (gc.collect(), orig(b))[1]
    for _ in range(3):
        step(batch(), draws(step.criterion))
    assert step.graphs.captures == 2 and step.graphs.fallbacks == 0
