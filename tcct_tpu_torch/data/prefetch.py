"""Streaming input for train splits that stay on disk (JAX counterpart
``tcct_tpu/data/prefetch.py``).

A producer thread decodes and geometry-preps batches with the native loader
(``data/native.py``, which drops the interpreter lock while it decodes) and
hands them to the consumer through a bounded queue, while the card
computes.  For a CUDA device each batch is decoded into a pinned host
buffer and copied to the card with ``non_blocking=True``; the copy is
followed by a CUDA event, and the producer waits on that event before it
decodes into the buffer again, so no buffer is overwritten while its copy
may be in flight.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, Optional, Sequence, Tuple

import torch

from tcct_tpu_torch.data.geometry import DatasetGeometry

_DONE = object()


class BatchPrefetcher:
    """Iterate ``(imgs_u8 [n, H, W, 3], labs_u8 [n, H, W])`` tensors on
    ``device`` (numpy arrays for ``device=None``), decoded in the
    background.  ``pairs``: (img_path, lab_path or None), in the order to
    stream them; sampling (shuffle, oversample) is the caller's.  The last
    batch keeps its natural size.  A decode error raises in the consumer.

    Counters, read after an iteration: ``decode_s`` (producer seconds in
    the native loader), ``decoded_bytes``, ``decoded_scans``."""

    def __init__(self, pairs: Sequence[Tuple[str, Optional[str]]], geo: DatasetGeometry,
                 batch_size: int = 8, depth: int = 2, n_threads: int = 0, device="cuda"):
        self.pairs = list(pairs)
        self.geo = geo
        self.bs = batch_size
        self.depth = depth
        self.n_threads = n_threads
        self.device = None if device is None else torch.device(device)
        self.decode_s = 0.0
        self.decoded_bytes = 0
        self.decoded_scans = 0

    def __len__(self) -> int:
        return (len(self.pairs) + self.bs - 1) // self.bs

    def _pinned_buffers(self):
        H, W = self.geo.prep_hw
        return (torch.empty((self.bs, H, W, 3), dtype=torch.uint8, pin_memory=True),
                torch.empty((self.bs, H, W), dtype=torch.uint8, pin_memory=True))

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        from tcct_tpu_torch.data import native

        native._get()  # raises NativeLoaderError here, in the consumer, if it cannot build
        cuda = self.device is not None and self.device.type == "cuda"
        ready: "queue.Queue" = queue.Queue(maxsize=self.depth)
        free: "queue.Queue" = queue.Queue()
        if cuda:  # one buffer per queued batch, one being decoded, one being copied
            for _ in range(self.depth + 2):
                free.put((self._pinned_buffers(), None))
        stop = threading.Event()
        geo = self.geo

        def producer():
            try:
                for i in range(0, len(self.pairs), self.bs):
                    if stop.is_set():
                        return
                    chunk = self.pairs[i: i + self.bs]
                    out, event = free.get() if cuda else (None, None)
                    if event is not None:
                        event.synchronize()  # its last copy to the card is done
                    t0 = time.perf_counter()
                    imgs, labs, _ = native.load_batch(
                        [p[0] for p in chunk], [p[1] for p in chunk], hw=geo.prep_hw,
                        height_stt=geo.height_stt, height_end=geo.height_end,
                        prep_mode=geo.prep_mode, prep_reflect=geo.prep_reflect,
                        divide=geo.divide, n_threads=self.n_threads,
                        out=None if out is None else (out[0].numpy(), out[1].numpy()))
                    self.decode_s += time.perf_counter() - t0
                    self.decoded_bytes += imgs.nbytes + labs.nbytes
                    self.decoded_scans += imgs.shape[0]
                    ready.put((out, imgs, labs))
                ready.put(_DONE)
            except Exception as e:  # handed to the consumer, which raises it
                ready.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = ready.get()
                if item is _DONE:
                    break
                if isinstance(item, Exception):
                    raise item
                out, imgs, labs = item
                if out is not None:
                    n = imgs.shape[0]
                    d_imgs = out[0][:n].to(self.device, non_blocking=True)
                    d_labs = out[1][:n].to(self.device, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record()
                    free.put((out, event))
                    yield d_imgs, d_labs
                elif self.device is None:
                    yield imgs, labs
                else:
                    yield torch.from_numpy(imgs).to(self.device), torch.from_numpy(labs).to(
                        self.device)
        finally:
            stop.set()
            while t.is_alive():  # unblock a producer waiting on a full queue
                try:
                    ready.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()
