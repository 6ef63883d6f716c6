"""Device input prefetch: stage host-to-device copies ahead of the step.

Counterpart of ``wavenet_tpu/data/prefetch.py``. ``DevicePrefetcher``
runs ``fill_fn`` (dequeue a batch, copy it from pinned host memory onto
the card with ``non_blocking``) in a daemon thread, a bounded queue
``depth`` deep, so the copy of batch N+1 overlaps step N. The copies go
on the default stream, which the step runs on too, so a step never reads
a batch before its copy has landed.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Optional

import torch

from wavenet_torch.lc import LCFrameChunk

_SENTINEL = object()


def to_device(array, device: torch.device):
    """numpy array -> tensor on ``device``; a CUDA copy starts from pinned
    memory and does not block the calling thread. An ``LCFrameChunk``
    moves field by field."""
    if isinstance(array, LCFrameChunk):
        return LCFrameChunk(*(to_device(f, device) for f in array))
    t = torch.from_numpy(array)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class DevicePrefetcher:
    """Run ``fill_fn`` in a worker, ``depth`` items ahead.

    Exceptions in the worker are raised again from ``get()``.
    ``max_items`` bounds how many items the worker ever produces, so it
    never consumes reader batches that belong to steps run inline after
    it stops (the train loop's remainder steps).
    """

    def __init__(self, fill_fn: Callable[[], Any], depth: int = 2,
                 max_items: Optional[int] = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._fill = fill_fn
        self._max_items = max_items
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="device-prefetch")
        self._thread.start()

    def _run(self) -> None:
        produced = 0
        while not self._stop.is_set():
            if self._max_items is not None and produced >= self._max_items:
                return
            try:
                item = self._fill()
            except BaseException as e:  # noqa: BLE001 - raised by get()
                self._err = e
                item = _SENTINEL
            produced += 1
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if item is _SENTINEL:
                return

    def get(self, timeout: Optional[float] = None) -> Any:
        """Next item (raises the worker's exception)."""
        item = self._q.get(timeout=timeout)
        if item is _SENTINEL:
            raise self._err
        return item

    def stop(self) -> None:
        """Stop the worker and drop any staged items."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
