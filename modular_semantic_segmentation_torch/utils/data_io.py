"""Host-side batch plumbing between datasets and the steps.

The port's own copy of the JAX package's ``utils/data_io.py`` (pure numpy
there, but in a module that imports JAX):

    * padding of partial batches to the static batch size, the pad pixels
      labelled -1, which the confusion matrix ignores;
    * the training order: a fresh ``RandomState(seed).permutation`` of
      dict data each epoch, so a seed fixes the batches of a fit.
"""

import numpy as np


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


def training_batches(data, batchsize, seed=None):
    """Infinite shuffled batch iterator for ``fit``: a data source's
    ``batches(..., shuffle=True, repeat=True, seed=seed)``, a dict of
    stacked arrays in a fresh ``RandomState(seed).permutation`` each epoch
    (the JAX package's order), or any iterator of batch dicts as it comes.
    ``seed``: None = fresh entropy."""
    if hasattr(data, "batches"):
        return data.batches(batchsize, shuffle=True, repeat=True, seed=seed)
    if not isinstance(data, dict):
        return iter(data)
    total = next(iter(data.values())).shape[0]
    rng = np.random.RandomState(seed)

    def epochs():
        while True:
            yield from _dict_to_batches(data, batchsize,
                                        rng.permutation(total))
    return epochs()
