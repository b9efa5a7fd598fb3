"""The host loader's batches, prepared ahead in a background thread
(``maskplanner_tpu/data/prefetch.py``).

The thread runs the loader (item materialisation and ``collate``) up to
``depth`` batches ahead of the training step and hands over tensors, in
pinned memory when the device is a card; the consumer copies them with
``non_blocking=True``, so the copy overlaps the step queued before it. The
training driver takes this path where the device-resident epoch does not
apply.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import torch


class Prefetcher:
    def __init__(self, loader, device="cuda", depth: int = 2):
        self.loader = loader
        self.device = torch.device(device)
        self.depth = depth

    def _host_tensors(self, batch: dict) -> dict[str, torch.Tensor]:
        tensors = {k: torch.as_tensor(v) for k, v in batch.items()}
        if self.device.type == "cuda":
            tensors = {k: t.pin_memory() for k, t in tensors.items()}
        return tensors

    def epoch(self, epoch: int) -> Iterator[dict[str, torch.Tensor]]:
        """The loader's batches of ``epoch``, in its order, on the device.
        An exception of the loader is raised here, after the batches it
        yielded before it."""
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        sentinel = object()
        stop = threading.Event()
        error: list[BaseException] = []

        def producer():
            try:
                for batch in self.loader.epoch(epoch):
                    if stop.is_set():
                        return
                    q.put(self._host_tensors(batch))
            except BaseException as exc:  # re-raised by the consumer
                error.append(exc)
            finally:
                q.put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield {k: t.to(self.device, non_blocking=True)
                       for k, t in item.items()}
        finally:
            # a consumer that stops early: unblock the producer's put
            stop.set()
            while thread.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            thread.join()
        if error:
            raise error[0]
