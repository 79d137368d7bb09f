"""Host->device input pipeline, the counterpart of
`kagnn_tpu/train/prefetch.py::prefetch_to_device`: batch assembly on a
worker thread overlapped with the host->device copies, `size` batches in
flight.

On the card the worker copies each assembled batch into pinned host
tensors and issues `.to(device, non_blocking=True)` on a CUDA stream of its
own, then records an event there (`stage_batch`). The consumer's current
stream waits on that event before the batch is handed out, and every
tensor of the batch is marked with `record_stream` for the consumer's
stream, so the caching allocator does not reuse its memory while the
consumer's work may still read it. The pinned source of each copy is held
until the copy's event has completed. On the CPU the same worker thread
hands the batches on as they are, with no pinning and no stream.

A worker error is raised at the consumer, after the batches before it.
Closing the consumer's generator stops the worker.
"""
from __future__ import annotations

import collections
import queue
import threading
from typing import Iterable, Iterator

import torch

from kagnn_tpu_torch.utils.device import resolve_device

_DONE = object()


def stage_batch(b, dev: torch.device, stream: "torch.cuda.Stream"):
    """The worker's step for one host batch b on the card: (b on `dev`,
    the copy's event, b's pinned copy). Each field is copied into
    pinned memory and from there to `dev` with a non-blocking copy on
    `stream`, after which the event is recorded."""
    pinned = b.map_tensors(lambda t: t.pin_memory())
    with torch.cuda.stream(stream):
        moved = pinned.to(dev, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return moved, done, pinned


def prefetch_to_device(batches: Iterable, size: int = 2,
                       device=None) -> Iterator:
    """Yield the GraphBatches of `batches` (host batches, as the batchers
    make with device="cpu") on `device` (CUDA unless told otherwise) while
    the next `size` are assembled and copied in the background."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=max(size, 1))
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            stream = torch.cuda.Stream(dev) if on_card else None
            for b in batches:
                if stop.is_set():
                    return
                item = (stage_batch(b, dev, stream) if on_card
                        else (b.to(dev), None, None))
                if not put(item):
                    return
        except BaseException as e:  # surface errors at the consumer
            put(e)
            return
        put(_DONE)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    in_flight: collections.deque = collections.deque()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            moved, done, pinned = item
            if on_card:
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(done)
                for t in moved.tensors():
                    t.record_stream(consumer)
                in_flight.append((done, pinned))
                while in_flight and in_flight[0][0].query():
                    in_flight.popleft()
            yield moved
    finally:
        stop.set()
        thread.join()
        for done, _ in in_flight:
            done.synchronize()
