"""Host-side batch plumbing between datasets and the steps.

The port's own copy of the JAX package's ``utils/data_io.py``:

    * padding of partial batches to the static batch size, the pad pixels
      labelled -1, which the confusion matrix ignores;
    * the training order: a fresh ``RandomState(seed).permutation`` of
      dict data each epoch, so a seed fixes the batches of a fit, and a
      data source's worker pool (``workers``);
    * the prefetching loader: a producer thread assembles the next batches
      and copies them to the device ahead of the step
      (:func:`to_device_prefetched` for ``fit``,
      :func:`prefetch_eval_batches` for ``score``).

Unlike the JAX package's loader, whose producer ends the stream silently
when it raises, the port's re-raises the producer's exception in the
consumer.
"""

import queue
import threading

import numpy as np
import torch


def to_numpy(value):
    """Host numpy copy of a tensor; bfloat16 comes back as float32, which
    numpy has no type for."""
    if not isinstance(value, torch.Tensor):
        return np.asarray(value)
    value = value.detach()
    if value.dtype == torch.bfloat16:
        value = value.float()
    return value.cpu().numpy()


def _pad_batch(batch, batchsize, pad_label=-1):
    """Pad a partial batch to the static batchsize. Returns (batch, valid)."""
    n = next(iter(batch.values())).shape[0]
    if n == batchsize:
        return batch, n
    padded = {}
    for key, value in batch.items():
        pad_width = [(0, batchsize - n)] + [(0, 0)] * (value.ndim - 1)
        fill = pad_label if key == "labels" else 0
        padded[key] = np.pad(value, pad_width, constant_values=fill)
    return padded, n


def _dict_to_batches(data, batchsize, order=None):
    """Slice a dict of stacked arrays into batch dicts (optionally
    permuted)."""
    total = next(iter(data.values())).shape[0]
    for start in range(0, total, batchsize):
        sel = (slice(start, start + batchsize) if order is None
               else order[start:start + batchsize])
        yield {k: np.asarray(v[sel]) for k, v in data.items()}


def _as_batch_iterator(data, batchsize):
    """Normalize the accepted data forms into an iterator of batch dicts:
    a data source with a ``batches`` method, a dict of stacked arrays, or
    any iterator of batch dicts."""
    if hasattr(data, "batches"):
        return data.batches(batchsize, shuffle=False, repeat=False)
    if isinstance(data, dict):
        return _dict_to_batches(data, batchsize)
    return iter(data)


def iterate_batches(data, batchsize):
    """Yield (batch padded to ``batchsize``, number of valid items) over
    the data, once."""
    for batch in _as_batch_iterator(data, batchsize):
        yield _pad_batch(batch, batchsize)


def training_batches(data, batchsize, seed=None, workers=None):
    """Infinite shuffled batch iterator for ``fit``: a data source's
    ``batches(..., shuffle=True, repeat=True, seed=seed, workers=workers)``
    (``workers``: the size of its assembly pool), a dict of stacked arrays
    in a fresh ``RandomState(seed).permutation`` each epoch (the JAX
    package's order), or any iterator of batch dicts as it comes.
    ``seed``: None = fresh entropy."""
    if hasattr(data, "batches"):
        return data.batches(batchsize, shuffle=True, repeat=True, seed=seed,
                            workers=workers)
    if not isinstance(data, dict):
        return iter(data)
    total = next(iter(data.values())).shape[0]
    rng = np.random.RandomState(seed)

    def epochs():
        while True:
            yield from _dict_to_batches(data, batchsize,
                                        rng.permutation(total))
    return epochs()


_END = object()


def _move(batch, device, stream):
    """The batch's arrays as tensors on ``device``. To a card: a pinned
    host copy, then a non-blocking copy on ``stream``, and an event
    recorded there after it."""
    out = {}
    for key, value in batch.items():
        t = (value if isinstance(value, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(value)))
        if stream is None:
            out[key] = t.to(device)
            continue
        if t.device.type == "cpu":
            t = t.pin_memory()
        with torch.cuda.stream(stream):
            out[key] = t.to(device, non_blocking=True)
    if stream is None:
        return out, None
    event = torch.cuda.Event()
    event.record(stream)
    return out, event


class DevicePrefetcher:
    """Iterator over ``items`` moved to ``device`` by a producer thread,
    ``buffer_size`` ahead of the consumer.

    ``items`` yields batch dicts, or (batch dict, extra) pairs when
    ``with_extra``; what comes out has the same form, its arrays tensors
    on ``device``. On a card the copies run on a side stream; before a
    batch is handed out the consumer's current stream waits on its event,
    and each tensor is marked used on that stream (``record_stream``), so
    that the caching allocator does not give its memory to the side stream
    while the consumer's work on it may still be queued.

    An exception in the producer is raised in the consumer at the batch
    where it occurred. ``close()``, which also runs when the iterator is
    dropped, stops the producer and closes ``items``; the thread holds no
    reference to the iterator, so dropping it is enough.
    """

    def __init__(self, items, device, buffer_size=2, with_extra=False):
        self._device = torch.device(device)
        self._queue = queue.Queue(maxsize=buffer_size)
        self._stop = threading.Event()
        self._with_extra = with_extra
        self._done = False
        stream = (torch.cuda.Stream(self._device)
                  if self._device.type == "cuda" else None)
        self._thread = threading.Thread(
            target=_produce, daemon=True,
            args=(items, self._device, stream, with_extra, self._queue,
                  self._stop))
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        payload, event = self._queue.get()
        if payload is _END:
            self._done = True
            raise StopIteration
        if isinstance(payload, BaseException):
            self._done = True
            raise payload
        batch = payload
        if event is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(event)
            for t in (batch[0] if self._with_extra else batch).values():
                t.record_stream(current)
        return batch

    def close(self, timeout=60.0):
        """Stop the producer and wait for it to end."""
        self._done = True
        self._stop.set()
        while self._thread.is_alive():
            try:  # make room for a producer blocked on a full queue
                self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
            timeout -= 0.05
            if timeout <= 0:
                raise RuntimeError("the prefetch producer did not stop")

    def __del__(self):
        if getattr(self, "_thread", None) is not None:
            self.close()


def _produce(items, device, stream, with_extra, out, stop):
    """The producer thread of DevicePrefetcher: move each item and put it
    on ``out`` (with its event) until ``items`` ends, ``stop`` is set or
    an exception occurs, which goes on ``out`` in the item's place."""

    def put(entry):
        while not stop.is_set():
            try:
                out.put(entry, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    try:
        for item in items:
            if stop.is_set():
                return
            if with_extra:
                batch, extra = item
                moved, event = _move(batch, device, stream)
                entry = ((moved, extra), event)
            else:
                entry = _move(item, device, stream)
            if not put(entry):
                return
        put((_END, None))
    except BaseException as error:  # handed to the consumer, re-raised
        put((error, None))
    finally:
        close = getattr(items, "close", None)
        if close is not None:
            close()


def to_device_prefetched(batch_iterator, device, buffer_size=2):
    """``fit``'s loader: the batch dicts of ``batch_iterator`` as tensors
    on ``device``, assembled and copied ``buffer_size`` batches ahead by a
    producer thread (:class:`DevicePrefetcher`)."""
    return DevicePrefetcher(batch_iterator, device, buffer_size)


def prefetch_eval_batches(data, batchsize, device, pad_label=-1,
                          buffer_size=2):
    """``score``'s loader: what ``iterate_batches(data, batchsize)`` yields,
    (batch padded with ``pad_label``, number of valid items), the batch on
    ``device``, assembled and copied ``buffer_size`` batches ahead."""
    items = (_pad_batch(batch, batchsize, pad_label)
             for batch in _as_batch_iterator(data, batchsize))
    return DevicePrefetcher(items, device, buffer_size, with_extra=True)
