"""The synthetic and text streams and the input pipeline (port of
``polyaxon_tpu/runtime/data.py``).

The generators are the JAX package's, copied: batch ``i`` is a pure
function of ``(seed, i)`` and byte-identical to JAX's. The text streams
(``lm_file``, ``lm_text``, ``lm_text_packed``) keep the JAX package's
token caches beside the corpus, under the same names and in the same
format (``.npy`` of int32 ids), so either package reads a cache the
other wrote as its own. Batches leave the generator as numpy arrays;
``host_batches`` turns them into torch tensors (pinned when they go to
the card), ``PrefetchIterator`` keeps a few of those ready on a
background thread, and ``device_batches`` copies each to the device with
``non_blocking`` on the consumer's current stream.
"""

from __future__ import annotations

import os
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


def _crop_stream(tokens: np.ndarray, batch_size: int, seq_len: int,
                 seed: int, start_batch: int,
                 source: str) -> Iterator[dict[str, np.ndarray]]:
    """Resume-exact random crops over a flat token array — the one
    place the (seed, i) keying and crop bound live (lm_file + lm_text)."""
    n = tokens.shape[0] - seq_len - 1
    if n <= 0:
        raise ValueError(
            f"{source} holds {tokens.shape[0]} token ids — needs more "
            f"than seq_len + 1 = {seq_len + 1}; lower seq_len or grow "
            "the corpus")
    i = start_batch
    while True:
        rng = np.random.default_rng((seed, i))
        starts = rng.integers(0, n, size=(batch_size,))
        yield {"tokens": np.stack(
            [tokens[s:s + seq_len] for s in starts]).astype(np.int32)}
        i += 1


def lm_file(batch_size: int, seq_len: int = 2048, path: str = "", seed: int = 0,
            start_batch: int = 0, **_) -> Iterator[dict[str, np.ndarray]]:
    """Memory-mapped token file: flat int32/int16 .npy of token ids.
    Batch ``i`` is a pure function of ``(seed, i)`` (resume-exact)."""
    if not path:
        raise ValueError("lm_file dataset requires `path`")
    tokens = np.load(path, mmap_mode="r")
    return _crop_stream(tokens, batch_size, seq_len, seed, start_batch,
                        source=f"token file {path!r}")


def _cache_path(path: str, tokenizer: str, kind: str) -> str:
    import hashlib
    import re as _re

    # Slug carries a hash of the raw tokenizer string (two strings must
    # never share a cache through sanitization collisions).
    digest = hashlib.sha256(tokenizer.encode()).hexdigest()[:8]
    slug = _re.sub(r"[^A-Za-z0-9_.-]+", "-", tokenizer).strip("-")[:40]
    return f"{path}.{slug}.{digest}.{kind}"


def _source_mtime(path: str, tokenizer: str) -> float:
    """Freshness covers the corpus AND the tokenizer assets: swapping
    tokenizer.json inside the same dir must invalidate the cache."""
    source_mtime = os.path.getmtime(path)
    if os.path.isdir(tokenizer):
        # Recursive walk, directories included: HF tokenizer dirs can
        # nest assets, and a swap inside a subdirectory must invalidate
        # the cache too. Entries that vanish mid-walk are skipped —
        # missing files can't be what the cache was built from.
        for root, dirs, files in os.walk(tokenizer):
            for name in dirs + files:
                try:
                    source_mtime = max(source_mtime, os.path.getmtime(
                        os.path.join(root, name)))
                except OSError:
                    continue
    return source_mtime


def _tokenizer_fn(tokenizer: str):
    """One loaded tokenizer → a str/bytes → int32-ids callable; the
    (expensive) HF load happens ONCE, not per call site."""
    if tokenizer == "bytes":
        def run(text_or_bytes):
            data = (text_or_bytes.encode()
                    if isinstance(text_or_bytes, str) else text_or_bytes)
            return np.frombuffer(data, dtype=np.uint8).astype(np.int32)

        return run
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(tokenizer)
    return lambda text: np.asarray(tok(text)["input_ids"], np.int32)


def _tokenize_text_file(path: str, tokenizer: str) -> np.ndarray:
    """Raw text → int32 token ids, cached next to the source as
    ``<path>.<slug>.tokens.npy`` (stale caches — source newer than
    cache — are rebuilt). ``tokenizer='bytes'`` is the dependency-free
    path: utf-8 bytes as ids (vocab 256); anything else is passed to
    ``transformers.AutoTokenizer.from_pretrained`` (offline, that means a
    local tokenizer directory; without transformers the ImportError
    stands)."""
    cache = _cache_path(path, tokenizer, "tokens.npy")
    if (os.path.exists(cache)
            and os.path.getmtime(cache) >= _source_mtime(path, tokenizer)):
        return np.load(cache, mmap_mode="r")
    tokenize = _tokenizer_fn(tokenizer)
    if tokenizer == "bytes":
        with open(path, "rb") as fh:
            ids = tokenize(fh.read())
    else:
        with open(path, encoding="utf-8") as fh:
            ids = tokenize(fh.read())
    # Atomic publish: a killed run (or a concurrent host on a shared
    # corpus) must never leave a truncated cache that mtime-wins over
    # the source forever.
    tmp = f"{cache}.{os.getpid()}.tmp.npy"  # .npy suffix: np.save keeps it
    np.save(tmp, ids)
    os.replace(tmp, cache)
    return np.load(cache, mmap_mode="r")


def _tokenize_docs(path: str, tokenizer: str,
                   doc_sep: str) -> tuple[np.ndarray, np.ndarray]:
    """Corpus → (flat token ids, parallel per-token document index):
    the source splits on ``doc_sep`` (empty docs dropped), each
    document tokenizes independently — no separator tokens leak into
    the stream — and the doc index is monotone non-decreasing. Cached
    as an mmap-able ``.packed-*.{ids,doc}.npy`` pair next to the
    source (mirroring the flat-token cache's memory story); the
    separator is part of the cache key — changing it must rebuild, not
    silently reuse boundaries cut on the old one."""
    import hashlib

    sep_digest = hashlib.sha256(doc_sep.encode()).hexdigest()[:8]
    base = _cache_path(path, tokenizer, f"packed-{sep_digest}")
    ids_cache, doc_cache = f"{base}.ids.npy", f"{base}.doc.npy"
    fresh = _source_mtime(path, tokenizer)
    if (os.path.exists(ids_cache) and os.path.exists(doc_cache)
            and os.path.getmtime(ids_cache) >= fresh
            and os.path.getmtime(doc_cache) >= fresh):
        return (np.load(ids_cache, mmap_mode="r"),
                np.load(doc_cache, mmap_mode="r"))
    with open(path, encoding="utf-8") as fh:
        docs = [d for d in fh.read().split(doc_sep) if d.strip()]
    if not docs:
        raise ValueError(f"corpus {path!r} holds no documents "
                         f"(separator {doc_sep!r})")
    tokenize = _tokenizer_fn(tokenizer)  # HF load once, outside the loop
    pieces, doc_idx = [], []
    for i, doc in enumerate(docs):
        ids = tokenize(doc)
        if not ids.size:
            continue
        pieces.append(ids)
        doc_idx.append(np.full(ids.size, i, np.int32))
    if not pieces:
        raise ValueError(
            f"corpus {path!r}: every document tokenized to zero ids "
            f"with tokenizer {tokenizer!r}")
    ids = np.concatenate(pieces)
    doc = np.concatenate(doc_idx)
    # Atomic publish, doc first: a reader requires BOTH files fresh,
    # and ids (published last) carries the newest mtime.
    for arr, cache in ((doc, doc_cache), (ids, ids_cache)):
        tmp = f"{cache}.{os.getpid()}.tmp.npy"
        np.save(tmp, arr)
        os.replace(tmp, cache)
    return (np.load(ids_cache, mmap_mode="r"),
            np.load(doc_cache, mmap_mode="r"))


def lm_text(batch_size: int, seq_len: int = 2048, path: str = "",
            tokenizer: str = "bytes", seed: int = 0, start_batch: int = 0,
            vocab_size: Optional[int] = None,
            **_) -> Iterator[dict[str, np.ndarray]]:
    """Real-text LM stream: tokenize ``path`` once (cached), then
    resume-exact random crops like ``lm_file``. The practical input for
    LoRA fine-tunes: point ``dataset: lm_text`` at a corpus file and a
    local tokenizer dir (or ``bytes`` for tokenizer-free runs)."""
    if not path:
        raise ValueError("lm_text dataset requires `path`")
    tokens = _tokenize_text_file(path, tokenizer)
    # The runtime forwards the model's vocab here: an oversized
    # tokenizer would otherwise flow out-of-range ids into the embed
    # gather (which JAX silently clamps, and which on the card is a
    # device-side assert).
    if vocab_size is not None and tokens.size:
        top = int(tokens.max())
        if top >= vocab_size:
            raise ValueError(
                f"tokenizer {tokenizer!r} produced id {top} but the "
                f"model's vocab_size is {vocab_size} — the tokenizer "
                "and model do not share a token space")
    return _crop_stream(tokens, batch_size, seq_len, seed, start_batch,
                        source=f"text file {path!r} ({tokenizer})")


def lm_text_packed(batch_size: int, seq_len: int = 2048, path: str = "",
                   tokenizer: str = "bytes", seed: int = 0,
                   start_batch: int = 0, vocab_size: Optional[int] = None,
                   doc_sep: str = "\n\n",
                   **_) -> Iterator[dict[str, np.ndarray]]:
    """Packed REAL-text LM stream: the corpus splits into documents on
    ``doc_sep``, tokenizes per document, and the continuous stream is
    cut into [seq_len] rows carrying per-token ``segments`` ids — the
    model restricts attention and restarts RoPE at every boundary
    (models/llama.py packed support), so no token ever attends across
    documents and no padding is wasted. A document spanning a row cut
    continues as its own segment in the next row (stream packing, the
    zero-waste tradeoff). Batch ``i`` samples rows as a pure function
    of ``(seed, i)`` — resume-exact like every other stream."""
    if not path:
        raise ValueError("lm_text_packed dataset requires `path`")
    ids, doc = _tokenize_docs(path, tokenizer, doc_sep)
    if vocab_size is not None and ids.size:
        top = int(ids.max())
        if top >= vocab_size:
            raise ValueError(
                f"tokenizer {tokenizer!r} produced id {top} but the "
                f"model's vocab_size is {vocab_size} — the tokenizer "
                "and model do not share a token space")
    R = ids.size // seq_len
    if R < 1:
        raise ValueError(
            f"corpus {path!r} holds {ids.size} token ids — needs at "
            f"least seq_len = {seq_len}; lower seq_len or grow the "
            "corpus")
    tok_rows = ids[:R * seq_len].reshape(R, seq_len)
    # Per-row segment ids relative to the row's first document (doc
    # index is monotone, so subtraction keeps equality structure —
    # the model only reads boundaries/equality, not absolute ids).
    doc_rows = doc[:R * seq_len].reshape(R, seq_len)
    seg_rows = doc_rows - doc_rows[:, :1]
    i = start_batch
    while True:
        rng = np.random.default_rng((seed, i))
        idx = rng.integers(0, R, size=(batch_size,))
        yield {"tokens": tok_rows[idx].astype(np.int32),
               "segments": seg_rows[idx].astype(np.int32)}
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


def seq2seq_synthetic(batch_size: int, seq_len: int = 128,
                      vocab_size: int = 32_000, seed: int = 0,
                      start_batch: int = 0,
                      **_) -> Iterator[dict[str, np.ndarray]]:
    """Copy task (targets == inputs): learnable through cross-attention,
    so seq2seq training curves move."""
    i = start_batch
    while True:
        rng = np.random.default_rng((seed, i))
        tokens = rng.integers(2, vocab_size,
                              size=(batch_size, seq_len)).astype(np.int32)
        yield {"inputs": tokens, "targets": tokens.copy()}
        i += 1


def mlm_synthetic(batch_size: int, seq_len: int = 128,
                  vocab_size: int = 30_522, mask_rate: float = 0.15,
                  mask_id: int = 103, seed: int = 0, start_batch: int = 0,
                  **_) -> Iterator[dict[str, np.ndarray]]:
    """Masked-LM rows: ``mask_rate`` of the positions replaced by
    ``mask_id`` in ``tokens``, their ids in ``labels`` (-1 elsewhere)."""
    i = start_batch
    while True:
        rng = np.random.default_rng((seed, i))
        tokens = rng.integers(5, vocab_size,
                              size=(batch_size, seq_len)).astype(np.int32)
        mask = rng.random((batch_size, seq_len)) < mask_rate
        labels = np.where(mask, tokens, -1).astype(np.int32)
        masked = np.where(mask, mask_id, tokens).astype(np.int32)
        yield {"tokens": masked, "labels": labels}
        i += 1


def image_synthetic(batch_size: int, image_size: int = 224,
                    num_classes: int = 1000, seed: int = 0,
                    start_batch: int = 0,
                    **_) -> Iterator[dict[str, np.ndarray]]:
    """Gaussian NHWC images with uniform labels."""
    i = start_batch
    while True:
        rng = np.random.default_rng((seed, i))
        yield {
            "image": rng.standard_normal(
                (batch_size, image_size, image_size, 3)).astype(np.float32),
            "label": rng.integers(0, num_classes,
                                  size=(batch_size,)).astype(np.int32),
        }
        i += 1


def mnist_synthetic(batch_size: int, seed: int = 0, start_batch: int = 0,
                    **_) -> Iterator[dict[str, np.ndarray]]:
    """Class-conditional blobs (28x28x1): learnable, so the quick-start
    converges."""
    protos = np.random.default_rng(seed).standard_normal(
        (10, 28, 28)).astype(np.float32)
    i = start_batch
    while True:
        rng = np.random.default_rng((seed, i))
        labels = rng.integers(0, 10, size=(batch_size,)).astype(np.int32)
        images = protos[labels] + 0.3 * rng.standard_normal(
            (batch_size, 28, 28)).astype(np.float32)
        yield {"image": images[..., None], "label": labels}
        i += 1


DATASETS: dict[str, Callable[..., Iterator[dict[str, np.ndarray]]]] = {
    "lm_synthetic": lm_synthetic,
    "lm_file": lm_file,
    "lm_text": lm_text,
    "lm_text_packed": lm_text_packed,
    "lm_packed_synthetic": lm_packed_synthetic,
    "seq2seq_synthetic": seq2seq_synthetic,
    "mlm_synthetic": mlm_synthetic,
    "imagenet_synthetic": image_synthetic,
    "image_synthetic": image_synthetic,
    "mnist_synthetic": mnist_synthetic,
}


def get_dataset(name: str, **kwargs) -> Iterator[dict[str, np.ndarray]]:
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
