"""The host data pipeline (counterpart of ``artiboost_tpu/utils/prefetch.py``,
which plays the reference's DataLoader workers, ``--workers``).

``Prefetcher`` runs an iterable on one producer thread, ``depth`` items
ahead of the consumer, so the host half of a real batch (geometry and
decode, ``HODataset.host_half``) overlaps the device's step. The producer
never blocks for good on a full queue, stops when the consumer closes the
iteration (including by ``GeneratorExit``), and its exception is raised
again in the consumer: a failed batch is an error of the run.

``HostPipeline`` wires it for a real-data split: the producer draws each
batch's geometry in plan order (every ``RandomState`` draw stays on that one
thread, so the batches equal an unprefetched run's), a pool of ``workers``
threads decodes the images into a ``StagingRing`` buffer, and the main
thread uploads the buffer and warps (``device_half``). Neither the producer
nor the pool makes a CUDA call: the ring's pinned buffers are allocated, and
their copies recorded, on the main thread."""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from artiboost_torch.utils import profiling
from artiboost_torch.utils.misc import logger

_SENTINEL = object()


class Prefetcher:
    """Iterate ``iterable`` through a producer thread, ``depth`` items ahead;
    ``transform`` runs on that thread."""

    def __init__(self, iterable: Iterable, depth: int = 2,
                 transform: Optional[Callable] = None):
        self._it = iter(iterable)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._transform = transform
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Bounded put; False once the consumer has gone."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for item in self._it:
                if self._transform is not None:
                    item = self._transform(item)
                if not self._put(item):
                    return
        except BaseException as e:  # raised again on the consumer's side
            self._err = e
        finally:
            self._put(_SENTINEL)

    def close(self):
        """Stop the producer and join its thread (idempotent)."""
        self._stop.set()
        while True:  # unblock a producer waiting on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)
        if self._thread.is_alive():
            logger.warning("prefetch: producer thread still alive 5 s after close(); "
                           "a transform is blocked")

    def __iter__(self) -> Iterator:
        try:
            while True:
                item = self._q.get()
                if item is _SENTINEL:
                    if self._err is not None:
                        raise self._err
                    return
                yield item
        finally:
            self.close()


class StagingRing:
    """Host buffers for decoded image batches, pinned when the device is
    CUDA. The constructor allocates them on the main thread; a worker ``take``s
    a free one and fills it; ``upload`` (main thread) copies it to the
    device with ``non_blocking=True`` and records an event, and the buffer
    goes back to the free list at the next upload, after that event, so a
    copy in flight is never overwritten."""

    def __init__(self, n_slots: int, shape: Tuple[int, ...], device: torch.device):
        pin = device.type == "cuda"
        self.n_slots, self.shape = n_slots, tuple(shape)
        self.buffers = {i: torch.empty(shape, dtype=torch.uint8, pin_memory=pin)
                        for i in range(n_slots)}
        self.stop = threading.Event()
        self.free: "queue.Queue[int]" = queue.Queue()
        self.pending: Optional[Tuple[int, torch.cuda.Event]] = None
        self.reset()

    def reset(self):
        """Free every buffer for a new iteration, whose predecessor is
        done (its producer joined)."""
        self.release_pending()
        self.stop.clear()
        self.free = queue.Queue()
        for i in range(self.n_slots):
            self.free.put(i)

    def take(self, shape) -> Tuple[int, np.ndarray]:
        """A free buffer of ``shape`` -> (slot, its numpy view); waits for
        one, until the ring is stopped."""
        if tuple(shape) != self.shape:
            raise ValueError(f"staging buffers hold {self.shape}, asked for {tuple(shape)}")
        while not self.stop.is_set():
            try:
                slot = self.free.get(timeout=0.1)
                return slot, self.buffers[slot].numpy()
            except queue.Empty:
                continue
        raise RuntimeError("the staging ring was stopped")

    def give_back(self, slot: Optional[int]):
        if slot is not None:
            self.free.put(slot)

    def release_pending(self):
        if self.pending is not None:
            slot, event = self.pending
            self.pending = None
            if event is not None:
                event.synchronize()
            self.free.put(slot)

    def upload(self, slot: int, device: torch.device) -> torch.Tensor:
        """The buffer of ``slot`` on ``device`` (main thread)."""
        self.release_pending()
        buf = self.buffers[slot]
        if device.type != "cuda":
            out = buf.clone()
            self.free.put(slot)
            return out
        out = buf.to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self.pending = (slot, event)
        return out


class HostPipeline:
    """The decode pool and staging rings of one run. ``host_halves`` walks a
    plan of sample-index lists and yields the host halves of a dataset's
    batches in plan order; the caller runs each one's ``device_half`` on the
    main thread. ``HostPipeline(workers=0, depth=0)`` has no pool and no
    producer: it makes every host half in place, on the calling thread."""

    def __init__(self, workers: int = 20, depth: int = 2):
        self.depth = depth
        self.pool = ThreadPoolExecutor(max_workers=workers,
                                       thread_name_prefix="decode") if workers > 0 else None
        self.rings: Dict[Tuple[int, ...], StagingRing] = {}

    def close(self):
        for ring in self.rings.values():
            ring.stop.set()
        if self.pool is not None:
            self.pool.shutdown(wait=True)

    def host_halves(self, dataset, plan: Iterable, n_per_batch: int) -> Iterator:
        """``plan`` yields (sample indices or None, extra) -> (HostBatch or
        None, extra) per item; None throughout without a ``dataset``. With a
        ``depth``, the host halves of a dataset that decodes on the host are
        made ahead on the producer thread, their images decoded by the pool
        into the staging ring of (``n_per_batch``, H, W, 3). Otherwise they
        are made in place, on the calling thread: so are those of a dataset
        whose images are on the device, which has only the geometry to make
        on the host, Python that would hold the GIL against the main
        thread's dispatch and overlap no device work (it cut the
        synthetic-image train rate by a quarter on the H100, ``PERF.md``)."""
        if dataset is None or not dataset.images_on_host or self.depth <= 0:
            for idx, extra in plan:
                yield (None if dataset is None or idx is None
                       else dataset.host_half(idx, pool=self.pool)), extra
            return
        shape = (n_per_batch, dataset.raw_size[1], dataset.raw_size[0], 3)
        if shape not in self.rings:
            self.rings[shape] = StagingRing(self.depth + 2, shape, dataset.device)
        staging = self.rings[shape]
        staging.reset()

        def host(item):
            idx, extra = item
            if idx is None:
                return None, extra
            return dataset.host_half(idx, pool=self.pool, staging=staging), extra

        it = Prefetcher(plan, depth=self.depth, transform=host)
        try:
            items = iter(it)
            while True:
                with profiling.trace("data/real_wait"):
                    item = next(items, None)
                if item is None:
                    return
                yield item
        finally:
            staging.stop.set()
            it.close()
            staging.release_pending()


IN_PLACE = HostPipeline(workers=0, depth=0)
