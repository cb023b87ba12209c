"""Input pipeline of the port: threaded host decode into fixed-shape NHWC
batches, then the card (counterpart of
``ecologysemanticsegmentation_tpu/data/pipeline.py``).

* :class:`Batcher` is the JAX package's: host threads decode into a bounded
  queue; batches are dense float32 NHWC; a batch of one is dropped; a
  seeded per-epoch shuffle; ``pad_final`` wraps the last batch around to
  the full size and ``n_real`` counts its distinct samples.
* :func:`cuda_prefetch` takes the place of ``device_prefetch``: each batch
  is staged in pinned host memory and copied to the card on a stream of its
  own, one batch ahead; the step's stream waits for the copy before it
  reads the batch.  Augmentation runs on the card (:mod:`.augment`).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch


class Batcher:
    """Shuffling, prefetching batch iterator over an indexable dataset.

    ``dataset[i]`` must return ``(image_HWC, mask_HWC, path)``.  Yields dicts
    ``{"image": (B,H,W,3) f32, "label": (B,H,W,C) f32, "paths": list[str]}``.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last_if_single: bool = True,
        num_threads: int = 4,
        prefetch: int = 2,
        pad_final: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last_if_single = drop_last_if_single
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.epoch = 0
        # pad_final: wrap-around-pad the last batch to the full batch size so
        # every batch has the same shape, divisible over a mesh's data axis.
        # Train loaders enable this; eval loaders keep exact sample counts.
        self.pad_final = pad_final

    def __len__(self) -> int:
        n = len(self.dataset)
        nb, rem = divmod(n, self.batch_size)
        if rem == 1 and self.drop_last_if_single and self.batch_size > 1 and not self.pad_final:
            return nb
        return nb + (1 if rem else 0)

    def _index_batches(self) -> list[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            # Seeded per-epoch shuffle (determinism toggle: SURVEY.md §5 race
            # detection row — seeded RNG replaces the reference's
            # worker_init_fn decorrelation).
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        batches = [
            order[i : i + self.batch_size] for i in range(0, n, self.batch_size)
        ]
        if self.pad_final and batches and len(batches[-1]) < self.batch_size:
            short = batches[-1]
            fill = order[: self.batch_size - len(short)]
            if len(short) + len(fill) == self.batch_size:
                batches[-1] = np.concatenate([short, fill])
            else:  # dataset smaller than one batch: tile
                reps = int(np.ceil(self.batch_size / n))
                batches[-1] = np.tile(order, reps)[: self.batch_size]
        if (
            batches
            and len(batches[-1]) == 1
            and self.drop_last_if_single
            and self.batch_size > 1
        ):
            batches.pop()
        return batches

    def __iter__(self) -> Iterator[dict]:
        batches = self._index_batches()
        self.epoch += 1
        if not batches:
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        n = len(self.dataset)
        seen = 0

        def produce():
            nonlocal seen
            with ThreadPoolExecutor(self.num_threads) as pool:
                for idxs in batches:
                    if stop.is_set():
                        break
                    samples = list(pool.map(self.dataset.__getitem__, idxs))
                    images = np.stack([s[0] for s in samples]).astype(np.float32)
                    labels = np.stack([s[1] for s in samples]).astype(np.float32)
                    paths = [s[2] for s in samples]
                    # n_real: distinct (non-wrap-padded) samples in this batch
                    # — metrics count these, so a padded final batch does not
                    # inflate images/sec or epoch sample counts.
                    n_real = min(len(idxs), n - seen)
                    seen += n_real
                    q.put({"image": images, "label": labels, "paths": paths,
                           "n_real": n_real})
            q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
        finally:
            stop.set()
            t.join(timeout=5)


def cuda_prefetch(iterator: Iterator[dict], device) -> Iterator[dict]:
    """The batches of ``iterator`` with their numpy arrays as tensors on
    ``device``.

    On CUDA each array is staged in pinned host memory and copied with
    ``non_blocking=True`` on a copy stream, one batch ahead of the one
    yielded, so the copy of batch i + 1 overlaps the step on batch i; the
    current stream waits for a batch's copy (an event) before the batch is
    yielded, so the copy is ordered before the step that reads it.  On the
    CPU the arrays become tensors with ``torch.as_tensor`` (the tests)."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
                   for k, v in batch.items()}
        return

    copy_stream = torch.cuda.Stream(device)

    def put(batch):
        out = dict(batch)
        with torch.cuda.stream(copy_stream):
            for k, v in batch.items():
                if isinstance(v, np.ndarray):
                    out[k] = torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
        return out, copy_stream.record_event()

    def ready(staged):
        out, copied = staged
        stream = torch.cuda.current_stream(device)
        stream.wait_event(copied)
        for v in out.values():
            if isinstance(v, torch.Tensor):
                # Allocated on the copy stream, read on this one.
                v.record_stream(stream)
        return out

    pending = None
    for batch in iterator:
        nxt = put(batch)
        if pending is not None:
            yield ready(pending)
        pending = nxt
    if pending is not None:
        yield ready(pending)
