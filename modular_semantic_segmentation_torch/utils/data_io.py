"""Host-side batch plumbing between datasets and the eval steps.

The port's own copy of the JAX package's ``utils/data_io.py`` batching
(pure numpy there, but in a module that imports JAX): partial batches are
padded to the static batch size with label -1, which the confusion matrix
ignores.
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


def _dict_to_batches(data, batchsize):
    """Slice a dict of stacked arrays into batch dicts."""
    total = next(iter(data.values())).shape[0]
    for start in range(0, total, batchsize):
        yield {k: np.asarray(v[start:start + batchsize])
               for k, v in data.items()}


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
