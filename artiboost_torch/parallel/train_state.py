"""Optimizer, scheduler and the train / eval steps (counterpart of
``artiboost_tpu/parallel/train_state.py``; reference ``train/train_artiboost.py``
epoch_pass: forward -> criterion -> backward -> clip -> optimizer step, and
``anakin/utils/netutils.py:26,44`` for the factories).

The train step is the torch shape of ``make_mixed_train_step`` (:222-268):
the caller assembles the mixed batch (``utils.batching.union_concat``) and
the step runs forward in train mode (BatchNorm updates its running
averages there), the criterion, backward, optax's global-norm clip and the
optimizer step. The learning rate follows the schedule at the count of
updates made so far, as optax's ``scale_by_schedule`` does.

Under a process group (``parallel/mesh.py``) the step starts from rank 0's
parameters and buffers and averages the gradients over ranks right after
backward, before the clip and the optimizer, so the clip sees the global
norm as JAX's jitted step does (:93-130).

On one CUDA device with Adam the step replays as two CUDA graphs
(``StepGraphs``): the host then queues two graph launches a step in place
of a launch per kernel. The CPU, a process group and SGD run eagerly."""
from __future__ import annotations

import gc
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from artiboost_torch.criterions.criterion import Criterion
from artiboost_torch.parallel import mesh
from artiboost_torch.utils import profiling
from artiboost_torch.utils.misc import logger, resolve_device


def build_scheduler(cfg: Dict, base_lr: float) -> Callable[[int], float]:
    """step (StepLR), cosine (warmup + cosine decay to 0) or linear (warmup
    + linear decay to 0): update count -> learning rate.

    ``step`` counts LR_DECAY_STEP in optimizer updates times
    STEPS_PER_EPOCH, which nothing sets, so it stays 1: the JAX package's
    fault (:27-34; the reference counts epochs), kept for parity."""
    kind = str(cfg.get("SCHEDULER", "step")).lower()
    if kind in ("step", "steplr"):
        period = int(cfg.get("LR_DECAY_STEP", 100)) * int(cfg.get("STEPS_PER_EPOCH", 1))
        gamma = float(cfg.get("LR_DECAY_GAMMA", 1.0))
        return lambda step: base_lr * gamma ** (step // period)
    total = int(cfg.get("TOTAL_STEPS", 10000))
    warm = int(cfg.get("WARMUP_STEPS", 0))
    if kind not in ("cosine", "linear"):
        raise ValueError(f"unknown scheduler {kind}")

    def schedule(step: int) -> float:
        if step < warm:
            return base_lr * step / warm
        t = min(step - warm, total - warm) / max(total - warm, 1)
        if kind == "cosine":
            return base_lr * 0.5 * (1.0 + math.cos(math.pi * t))
        return base_lr * (1.0 - t)

    return schedule


def _decay_mask(name: str) -> bool:
    """Weight decay everywhere except frozen buffers: ManoAdaptor's
    ``regressor`` (the JAX package's ``_decay_mask``, :48-60)."""
    return "regressor" not in name.split(".")


def graphs_apply(device: torch.device) -> bool:
    """Whether a train step on ``device`` replays as CUDA graphs: on a CUDA
    device outside any process group, one of a single rank included (a
    graph around the collectives is not built)."""
    return device.type == "cuda" and not mesh.active()


def build_optimizer(cfg: Dict, named_params: List[Tuple[str, torch.nn.Parameter]]
                    ) -> Tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """TRAIN cfg -> (optimizer, schedule). adam (optax.adam, eps 1e-8), adam
    with WEIGHT_DECAY (optax.adamw under ``_decay_mask``), sgd with
    MOMENTUM. The rate is set per update from the schedule.

    Where the step replays as graphs (``graphs_apply``) Adam is built
    capturable from the start, so its eager and replayed updates do the
    same arithmetic: its step counts live on the card and its rate is a 0-d
    device tensor that the step fills."""
    base_lr = float(cfg.get("LR", 1e-4))
    sched = build_scheduler(cfg, base_lr)
    name = str(cfg.get("OPTIMIZER", "adam")).lower()
    wd = float(cfg.get("WEIGHT_DECAY", 0.0))
    params = [p for _, p in named_params]
    adam = {"lr": base_lr, "betas": (0.9, 0.999), "eps": 1e-8}
    if name == "adam" and params and graphs_apply(params[0].device):
        adam.update(capturable=True, foreach=True,
                    lr=torch.tensor(base_lr, dtype=torch.float32, device=params[0].device))
    if name == "adam" and wd:
        groups = [{"params": [p for n, p in named_params if _decay_mask(n)], "weight_decay": wd},
                  {"params": [p for n, p in named_params if not _decay_mask(n)],
                   "weight_decay": 0.0}]
        opt = torch.optim.AdamW(groups, **adam)
    elif name == "adam":
        opt = torch.optim.Adam(params, **adam)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=base_lr, momentum=float(cfg.get("MOMENTUM", 0.9)))
    else:
        raise ValueError(f"unknown optimizer {name}")
    return opt, sched


@torch.no_grad()
def clip_by_global_norm(params: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm: when the global norm g of the gradients
    exceeds max_norm, each gradient becomes (grad / g) * max_norm. Returns g."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
    scale_down = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(scale_down, g / norm * max_norm, g))
    return norm


def step_signature(batch: Dict, loss_draws: List[Dict], device: torch.device
                   ) -> Optional[tuple]:
    """What a captured train step is specific to beyond the values in its
    tensors: each key of the batch (the nested ``KEY_VALID`` masks
    included) and of each loss's draws, with its tensor's shape and dtype,
    or its host value. None where the step cannot replay from copies of
    its inputs: a tensor off ``device``, or a value that is neither a
    tensor, a dict nor a host scalar."""
    def walk(d: Dict) -> tuple:
        out = []
        for k, v in d.items():
            if torch.is_tensor(v):
                if v.device != device:
                    raise _Ungraphable
                out.append((k, tuple(v.shape), v.dtype))
            elif isinstance(v, dict):
                out.append((k, walk(v)))
            elif v is None or isinstance(v, (bool, int, float, str)):
                out.append((k, v))
            else:
                raise _Ungraphable
        return tuple(out)

    try:
        return walk(batch), tuple(walk(d) for d in loss_draws)
    except _Ungraphable:
        return None


class _Ungraphable(Exception):
    pass


def _static_like(d: Dict) -> Dict:
    """Buffers of the shapes and dtypes of a (nested) dict's tensors, its
    host values as they are."""
    return {k: torch.empty_like(v) if torch.is_tensor(v)
            else _static_like(v) if isinstance(v, dict) else v for k, v in d.items()}


def _copy_into(static: Dict, d: Dict) -> None:
    for k, v in d.items():
        if torch.is_tensor(v):
            static[k].copy_(v)
        elif isinstance(v, dict):
            _copy_into(static[k], v)


def _capture(graph, pool, stream, fn):
    """``fn()`` captured into ``graph`` on ``stream`` -> what it returned;
    the current stream is restored whether or not the capture holds (an
    operation that cannot be captured raises RuntimeError here). The
    garbage collector runs before and not during it: a graph left in a
    reference cycle and destroyed mid-capture would end the capture."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool)
            try:
                return fn()
            finally:
                graph.capture_end()
    finally:
        if collecting:
            gc.enable()


class _Pair:
    """One signature's two graphs: ``fb`` (forward, criterion, backward)
    and ``update`` (the clip and the optimizer step), captured on one
    stream into one memory pool and replayed on the caller's stream, in
    that order; their static inputs (the batch, the loss draws) and
    outputs (the gradients, the predictions and the losses)."""

    def __init__(self, batch: Dict, loss_draws: List[Dict]):
        self.stream = torch.cuda.Stream()
        self.pool = torch.cuda.graph_pool_handle()
        self.fb, self.update = torch.cuda.CUDAGraph(), None
        self.batch = _static_like(batch)
        self.draws = [_static_like(d) for d in loss_draws]
        self.load(batch, loss_draws)

    def load(self, batch: Dict, loss_draws: List[Dict]) -> None:
        """Copy a step's inputs into the static buffers, on the stream."""
        _copy_into(self.batch, batch)
        for s, d in zip(self.draws, loss_draws):
            _copy_into(s, d)

    def capture_fb(self, step: "TrainStep") -> None:
        def run():
            preds = step.model(self.batch)
            total, losses = step.criterion.compute_losses(preds, self.batch, self.draws)
            total.backward()
            return ({k: v.detach() for k, v in preds.items()},
                    {k: v.detach() for k, v in losses.items()})

        self.outputs = _capture(self.fb, self.pool, self.stream, run)
        self.grads = [p.grad for p in step.params]

    def replay_fb(self, params: List[torch.Tensor]) -> Tuple[Dict, Dict]:
        """Replay ``fb``: each parameter's ``.grad`` is its static gradient;
        -> (preds, losses), fresh copies that no later replay overwrites."""
        self.fb.replay()
        for p, g in zip(params, self.grads):
            p.grad = g
        preds, losses = ({k: v.clone() for k, v in d.items()} for d in self.outputs)
        return preds, losses

    def capture_update(self, step: "TrainStep") -> None:
        def run():
            if step.grad_clip:
                clip_by_global_norm(step.params, step.grad_clip)
            step.optimizer.step()

        self.update = torch.cuda.CUDAGraph()
        _capture(self.update, self.pool, self.stream, run)

    def replay_update(self) -> None:
        self.update.replay()


class StepGraphs:
    """A ``TrainStep`` replayed as CUDA graphs, one ``_Pair`` a
    ``step_signature``. The first step of a signature runs eagerly (the
    warm-up: lazy state, algorithm choices, constants on the card); its
    next captures ``fb`` and replays it, and its ``update`` captures and
    replays the update graph; every later step replays both. Capture
    happens at a step, never at construction, so whatever replaced the
    step's halves or the criterion's methods before then is what the
    graphs hold.

    At most ``MAX_PAIRS`` signatures are captured, and only one seen before
    takes a slot: the last ``MAX_SEEN`` signatures seen once are kept, so
    one-off signatures neither hold a slot nor pile up. Once the slots are
    full any other signature runs eagerly, as does a signature whose capture
    raised (a host sync in a model's forward, say; in ``eager``, counted in
    ``fallbacks``). ``drop`` forgets every pair (a ``load_state_dict`` of
    the model or the optimizer replaces tensors a graph reads)."""

    MAX_PAIRS = 2
    MAX_SEEN = 8

    def __init__(self, step: "TrainStep"):
        self.step = step
        self.device = step.params[0].device
        self.pairs: Dict[tuple, _Pair] = {}  # signature -> its captured pair
        self.seen: Dict[tuple, None] = {}  # signatures seen once, oldest first
        self.eager: set = set()  # signatures whose capture raised
        self.active: Optional[_Pair] = None  # the pair whose fb replayed last
        self.captures = self.fallbacks = 0

    def drop(self) -> None:
        self.pairs.clear()
        self.seen.clear()
        self.active = None
        self.step.optimizer.zero_grad(set_to_none=True)

    def _fallback(self, sig, err: RuntimeError, span) -> None:
        """``sig`` runs eagerly from now on."""
        self.pairs.pop(sig, None)
        self.eager.add(sig)
        self.fallbacks += 1
        span.count(fallback=1)
        logger.warning(f"a train step could not be captured as a CUDA graph ({err}); "
                       "the steps of its shapes run eagerly")

    def _first_sight(self, sig) -> bool:
        """Whether ``sig`` is not among the signatures seen once; either way
        it is the newest of them after the call, unless it was there (it is
        then taken out), the oldest forgotten past ``MAX_SEEN``."""
        if sig in self.seen:
            del self.seen[sig]
            return False
        self.seen[sig] = None
        if len(self.seen) > self.MAX_SEEN:
            del self.seen[next(iter(self.seen))]
        return True

    def forward_backward(self, batch: Dict, loss_draws: List[Dict], span
                         ) -> Optional[Tuple[Dict, Dict]]:
        """-> (preds, losses) of the replayed ``fb``, or None where the step
        runs eagerly."""
        self.active = None
        sig = step_signature(batch, loss_draws, self.device)
        if sig is None or sig in self.eager:
            return None
        pair = self.pairs.get(sig)
        if pair is not None:
            pair.load(batch, loss_draws)
        else:
            if len(self.pairs) >= self.MAX_PAIRS or self._first_sight(sig):
                return None
            self.step.optimizer.zero_grad(set_to_none=True)
            pair = _Pair(batch, loss_draws)
            try:
                pair.capture_fb(self.step)
            except RuntimeError as err:  # the eager step resets what it left in .grad
                self._fallback(sig, err, span)
                return None
            self.pairs[sig] = pair
            self.captures += 1
            span.count(capture=1)
        self.active = pair
        return pair.replay_fb(self.step.params)

    def update(self, span) -> bool:
        """Replay the update graph of the pair whose ``fb`` just replayed
        (capturing it at its first use) -> False where the update runs
        eagerly."""
        pair, self.active = self.active, None
        if pair is None:
            return False
        if pair.update is None:
            try:
                pair.capture_update(self.step)
            except RuntimeError as err:  # this step's gradients stand: an eager update
                self._fallback(next(s for s, p in self.pairs.items() if p is pair), err, span)
                return False
            self.captures += 1
            span.count(capture=1)
        self.step.set_lr()
        pair.replay_update()
        return True


class TrainStep:
    """step(batch, loss_draws) -> (preds, losses), both detached.
    ``forward_backward`` and ``update`` are its two halves: after the first,
    each parameter's ``.grad`` holds the gradient (averaged over ranks
    under a process group). The model is moved to ``device`` (None means
    CUDA, which raises without a card).

    Where ``graphs_apply`` and the optimizer is Adam, each half replays its
    graph (``StepGraphs``, in ``graphs``; None elsewhere): the
    ``model/forward_backward`` span counts ``graph`` 1 for a replayed step
    and 0 for an eager one, and ``capture`` and ``fallback`` where they
    happened."""

    def __init__(self, model: torch.nn.Module, criterion: Criterion, train_cfg: Dict,
                 device=None):
        self.model, self.criterion = model.to(resolve_device(device)), criterion
        mesh.broadcast_module(model)
        self.named_params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.params = [p for _, p in self.named_params]
        self.optimizer, self.schedule = build_optimizer(train_cfg, self.named_params)
        self.grad_clip = float(train_cfg.get("GRAD_CLIP", 0.0))
        self.step = 0
        self.lr = self.graphs = None
        if self.optimizer.defaults.get("capturable"):
            self.lr = self.optimizer.param_groups[0]["lr"]
            self.graphs = StepGraphs(self)
            # the warm-up steps run the capturable optimizer uncaptured by design
            self.optimizer._warned_capturable_if_run_uncaptured = True
            model.register_load_state_dict_post_hook(lambda *_: self.graphs.drop())
            self.optimizer.register_load_state_dict_post_hook(self._optimizer_loaded)
        self.optimizer.register_load_state_dict_pre_hook(self._optimizer_loading)

    @staticmethod
    def _optimizer_loading(optimizer: torch.optim.Optimizer, state: Dict) -> Dict:
        """A checkpoint's groups take this optimizer's ``capturable`` and
        ``foreach`` before they are loaded, so its step counts land where
        this optimizer keeps them, whichever step wrote it: on the card
        where it is capturable, as saved (on the host, as ``Recorder``
        loads) where it is not. A saved rate tensor becomes a float where
        this optimizer's rate is one."""
        def take(saved: Dict, own: Dict) -> Dict:
            group = dict(saved, **{k: own[k] for k in ("capturable", "foreach") if k in own})
            if not torch.is_tensor(own["lr"]):
                group["lr"] = float(saved["lr"])
            return group

        return dict(state, param_groups=[take(g, o) for g, o in zip(state["param_groups"],
                                                                   optimizer.param_groups)])

    def _optimizer_loaded(self, optimizer: torch.optim.Optimizer) -> None:
        """A loaded optimizer keeps this step's rate tensor (the load copied
        it), which takes the loaded rate."""
        self.lr.fill_(float(optimizer.param_groups[0]["lr"]))
        for group in optimizer.param_groups:
            group["lr"] = self.lr
        self.graphs.drop()

    def set_lr(self) -> None:
        """The rate at the count of updates made so far; into the rate tensor
        by a kernel where there is one."""
        lr = self.schedule(self.step)
        if self.lr is None:
            for group in self.optimizer.param_groups:
                group["lr"] = lr
        else:
            self.lr.fill_(lr)

    def forward_backward(self, batch: Dict, loss_draws: List[Dict]) -> Tuple[Dict, Dict]:
        with profiling.trace("model/forward_backward") as span:
            self.model.train()
            out = None if self.graphs is None else self.graphs.forward_backward(
                batch, loss_draws, span)
            span.count(graph=int(out is not None))
            if out is None:
                self.optimizer.zero_grad(set_to_none=True)
                preds = self.model(batch)
                total, losses = self.criterion.compute_losses(preds, batch, loss_draws)
                total.backward()
                out = ({k: v.detach() for k, v in preds.items()},
                       {k: v.detach() for k, v in losses.items()})
            mesh.all_reduce_grads(self.params)
            return out

    def update(self):
        with profiling.trace("model/update") as span:
            if self.graphs is None or not self.graphs.update(span):
                if self.grad_clip:
                    clip_by_global_norm(self.params, self.grad_clip)
                self.set_lr()
                self.optimizer.step()
            self.step += 1

    def __call__(self, batch: Dict, loss_draws: List[Dict]) -> Tuple[Dict, Dict]:
        with profiling.trace("artiboost/train_step"):
            out = self.forward_backward(batch, loss_draws)
            self.update()
            return out


@torch.no_grad()
def eval_step(model: torch.nn.Module, criterion: Criterion, batch: Dict,
              loss_draws: List[Dict]) -> Tuple[Dict, Dict]:
    """Forward with the running statistics, and the criterion's losses
    (``make_eval_step``, :282-293)."""
    model.eval()
    preds = model(batch)
    _, losses = criterion.compute_losses(preds, batch, loss_draws)
    return preds, losses
