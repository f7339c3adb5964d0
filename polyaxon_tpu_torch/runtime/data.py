"""Synthetic LM streams and the input pipeline (port of
``polyaxon_tpu/runtime/data.py``).

The generators are the JAX package's, copied: batch ``i`` is a pure
function of ``(seed, i)`` and byte-identical to JAX's. Batches leave the
generator as numpy arrays; ``host_batches`` turns them into torch
tensors (pinned when they go to the card), ``PrefetchIterator`` keeps a
few of those ready on a background thread, and ``device_batches`` copies
each to the device with ``non_blocking`` on the consumer's current
stream.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch


def lm_synthetic(batch_size: int, seq_len: int = 2048, vocab_size: int = 32_000,
                 seed: int = 0, start_batch: int = 0,
                 **_) -> Iterator[dict[str, np.ndarray]]:
    """Zipf-ish token stream (inverse-CDF sampling over a cumulative
    table built once per stream)."""
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    cdf = np.cumsum(1.0 / ranks)
    cdf /= cdf[-1]
    i = start_batch
    while True:
        rng = np.random.default_rng((seed, i))
        u = rng.random((batch_size, seq_len))
        yield {"tokens": np.searchsorted(cdf, u, side="right").astype(np.int32)}
        i += 1


def lm_packed_synthetic(batch_size: int, seq_len: int = 2048,
                        vocab_size: int = 32_000, mean_doc_len: int = 256,
                        seed: int = 0, start_batch: int = 0,
                        **_) -> Iterator[dict[str, np.ndarray]]:
    """Packed-document LM stream: each row concatenates documents of
    random length (``mean_doc_len / 2`` to ``2 * mean_doc_len``) with
    per-token ``segments`` ids (segment of position t = number of
    document ends <= t)."""
    low = max(mean_doc_len // 2, 1)
    high = max(mean_doc_len * 2, low + 1)
    n_docs = seq_len // low + 1
    positions = np.arange(seq_len)
    i = start_batch
    while True:
        rng = np.random.default_rng((seed, i))
        tokens = rng.integers(2, vocab_size,
                              size=(batch_size, seq_len)).astype(np.int32)
        ends = np.cumsum(rng.integers(low, high,
                                      size=(batch_size, n_docs)), axis=1)
        segments = (positions[None, :] >= ends[:, :, None]).sum(
            axis=1).astype(np.int32)
        yield {"tokens": tokens, "segments": segments}
        i += 1


DATASETS: dict[str, Callable[..., Iterator[dict[str, np.ndarray]]]] = {
    "lm_synthetic": lm_synthetic,
    "lm_packed_synthetic": lm_packed_synthetic,
}
# The JAX package's other datasets; each raises until it is ported.
UNPORTED = ("lm_file", "lm_text", "lm_text_packed", "seq2seq_synthetic",
            "mlm_synthetic", "imagenet_synthetic", "image_synthetic",
            "mnist_synthetic")


def get_dataset(name: str, **kwargs) -> Iterator[dict[str, np.ndarray]]:
    if name in UNPORTED:
        raise NotImplementedError(
            f"dataset `{name}` is not ported yet: ROADMAP.md, Queue 1 "
            "item 3b")
    if name not in DATASETS:
        raise ValueError(f"Unknown dataset `{name}`. Available: "
                         f"{sorted(DATASETS)}")
    return DATASETS[name](**kwargs)


def dataset_for_model(model_name: str) -> str:
    if model_name.startswith("t5"):
        return "seq2seq_synthetic"
    if model_name.startswith("bert"):
        return "mlm_synthetic"
    if model_name.startswith(("vit", "resnet")):
        return "imagenet_synthetic"
    if model_name.startswith("mnist"):
        return "mnist_synthetic"
    return "lm_synthetic"


def host_batches(it: Iterator[dict[str, np.ndarray]], *, pin: bool
                 ) -> Iterator[dict[str, torch.Tensor]]:
    """numpy batches → CPU tensors, in pinned memory when ``pin`` (so the
    copy to the card can run asynchronously)."""
    for batch in it:
        out = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in batch.items()}
        yield {k: v.pin_memory() for k, v in out.items()} if pin else out


def device_batches(it: Iterator[dict[str, torch.Tensor]], device
                   ) -> Iterator[dict[str, torch.Tensor]]:
    """Host tensors → ``device``, copied ``non_blocking`` on the calling
    thread's current stream (the step that consumes them is queued behind
    the copy on that stream)."""
    for batch in it:
        yield {k: v.to(device, non_blocking=True) for k, v in batch.items()}


class PrefetchIterator:
    """Bounded background prefetch over a batch iterator.

    A producer thread pulls from ``it`` (generating and pinning batch
    ``i+k`` while the device runs step ``i``) and parks up to ``depth``
    ready batches in a queue; order is preserved. A producer exception is
    re-raised on the consumer's next ``__next__``; ``close()`` stops the
    producer, drains the queue and joins the thread, so no thread
    outlives its run.
    """

    _SENTINEL = object()

    def __init__(self, it: Iterator[Any], depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._it = it
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._fill, name="plx-data-prefetch", daemon=True)
        self._thread.start()

    def _put(self, item: Any) -> bool:
        """Put with stop-responsiveness; False once closing."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self) -> None:
        try:
            for batch in self._it:
                if not self._put(batch):
                    return
        except BaseException as exc:  # noqa: BLE001 — surfaced to consumer
            self._error = exc
        self._put(self._SENTINEL)

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self) -> Any:
        item = self._queue.get()
        if item is self._SENTINEL:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()
