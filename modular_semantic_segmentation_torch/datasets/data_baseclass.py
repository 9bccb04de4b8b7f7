"""Dataset base class and lazy DataSource (the port's copy of the JAX
package's ``datasets/data_baseclass.py``).

The same splits as the JAX package: trainset, measureset, testset and a
15-item validation split with the reference's fixed seed when the dataset
gives none; a seeded shuffle of the trainset; ``get_data_description()``
usable before a dataset exists; per-modality blob dicts cropped to
multiples of 16. The accessors return a :class:`DataSource`, whose
``batches`` method ``fit``, ``score`` and ``predict`` take as they are.

uint8 frames become float32 in one pass of the native library's pack
over the whole batch, and ``batches(workers=n)`` assembles blobs in a
pool of ``n`` threads, as in the JAX package. The difference from it:
sklearn's ``train_test_split`` is :func:`train_test_split` here (the same
indices).
"""

import math
import random
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from modular_semantic_segmentation_torch.datasets import native_backend
from modular_semantic_segmentation_torch.datasets.augmentation import \
    crop_multiple
from modular_semantic_segmentation_torch.datasets.wrapper import DataWrapper

# the reference's fixed validation-split seed
VALIDATION_SPLIT_SEED = 317243896


def train_test_split(items, test_size, random_state=None):
    """(train, test) lists of ``items``, as sklearn's
    ``train_test_split(items, test_size=..., random_state=...)`` gives
    them: ``RandomState(random_state).permutation(n)``, the first
    ``n_test`` indices the test set and the rest the train set;
    ``n_test`` is ``ceil(test_size * n)`` for a float ``test_size`` in
    (0, 1), else ``test_size`` itself."""
    items = list(items)
    n = len(items)
    if isinstance(test_size, float):
        if not 0 < test_size < 1:
            raise ValueError(f"test_size={test_size} should be in (0, 1)")
        n_test = math.ceil(test_size * n)
    else:
        n_test = int(test_size)
        if not 0 < n_test < n:
            raise ValueError(f"test_size={test_size} should be in "
                             f"(0, {n}) for {n} items")
    if n - n_test <= 0:
        raise ValueError(f"test_size={test_size} leaves no training item "
                         f"of {n}")
    order = np.random.RandomState(random_state).permutation(n)
    return ([items[i] for i in order[n_test:]],
            [items[i] for i in order[:n_test]])


class DataSource:
    """Lazy view over a list of dataset items, yielding batch dicts.

    ``compact_transfer=True`` keeps uint8 modalities uint8 and makes the
    labels int8 (when the classes fit) in the stacked batch, four times
    fewer bytes to copy; ``Estimator._preprocess`` promotes integer frames
    to float32 on the device and kernel A widens int8 labels, so the
    results are the same.
    """

    def __init__(self, dataset, items, training_format=False,
                 compact_transfer=False):
        self._dataset = dataset
        self._items = list(items)
        self._training_format = training_format
        self.compact_transfer = compact_transfer
        self.modalities = dataset.modalities

    def __len__(self):
        return len(self._items)

    def get_blob(self, idx):
        data = self._dataset._get_data(
            training_format=self._training_format, **self._items[idx])
        for m in self.modalities:
            data[m] = crop_multiple(data[m])
        return data

    def __iter__(self):
        for i in range(len(self)):
            yield self.get_blob(i)

    def stack(self, blobs):
        batch = {}
        for m in self.modalities:
            stacked = np.stack([b[m] for b in blobs])
            if m == "labels":
                # every dataset has num_classes <= 127, and its only
                # negative label is the void -1
                dtype = ("int8" if self.compact_transfer
                         and self._dataset.num_classes <= 127 else "int32")
                batch[m] = stacked.astype(dtype)
            elif stacked.dtype == np.uint8 and self.compact_transfer:
                batch[m] = stacked
            elif stacked.dtype == np.uint8:
                # one native pass over the whole batch
                batch[m] = native_backend.pack_normalize(stacked)
            else:
                batch[m] = stacked.astype(np.float32)
        return batch

    def batches(self, batchsize, shuffle=False, repeat=False, seed=None,
                workers=None):
        """Yield stacked batch dicts; ``shuffle`` permutes the items each
        epoch with ``RandomState(seed)``, ``repeat`` cycles forever and
        tops the last batch of an epoch up from the start.

        ``workers > 1`` assembles the blobs (decode, augment, crop) in a
        pool of that many threads, two batches in flight: the PNG inflate,
        numpy and the native ops release the GIL, so assembly runs on
        several host cores while the device computes. The batches are the
        sequential ones; but an augmentation draws from the shared
        ``random`` and numpy generators, so with workers which blob takes
        which draw is not fixed.
        """
        rng = np.random.RandomState(seed)
        indices = self._batch_indices(batchsize, shuffle, repeat, rng)
        if workers and workers > 1:
            return self._batches_pooled(indices, workers)
        return (self.stack([self.get_blob(i) for i in idxs])
                for idxs in indices)

    def _batches_pooled(self, indices, workers):
        with ThreadPoolExecutor(max_workers=workers) as pool:
            pending = []
            try:
                for idxs in indices:
                    pending.append([pool.submit(self.get_blob, i)
                                    for i in idxs])
                    # two batches in flight: one being consumed, one
                    # assembling behind it
                    if len(pending) > 2:
                        yield self.stack([f.result()
                                          for f in pending.pop(0)])
                while pending:
                    yield self.stack([f.result() for f in pending.pop(0)])
            finally:
                # a consumer that stops early leaves futures behind
                for futures in pending:
                    for f in futures:
                        f.cancel()

    def _batch_indices(self, batchsize, shuffle, repeat, rng):
        while True:
            order = np.arange(len(self))
            if shuffle:
                rng.shuffle(order)
            for start in range(0, len(order), batchsize):
                idxs = order[start:start + batchsize]
                if repeat and len(idxs) < batchsize:
                    idxs = np.concatenate([idxs,
                                           order[:batchsize - len(idxs)]])
                yield idxs
            if not repeat:
                return

    def as_dict(self):
        """The whole set as one stacked dict."""
        return self.stack([self.get_blob(i) for i in range(len(self))])


class DataBaseclass(DataWrapper):
    """Splits of a dataset into train, measure, test and validation sets,
    with the DataWrapper interface."""

    def __init__(self, trainset, measureset, testset, labelinfo,
                 validation_set=None, num_classes=None, info=False):
        if validation_set is None and len(trainset) > 15:
            self.trainset, self.validation_set = train_test_split(
                trainset, test_size=15, random_state=VALIDATION_SPLIT_SEED)
        elif validation_set is None:
            self.trainset, self.validation_set = list(trainset), list(trainset)
        else:
            self.trainset = list(trainset)
            self.validation_set = list(validation_set)
        self.measureset = measureset
        self.testset = testset
        self.num_classes = (num_classes if num_classes is not None
                            else self._num_default_classes)
        self.modalities = list(self._data_shape_description.keys())
        self.labelinfo = labelinfo
        self.print_info = info
        # seeded, as in the JAX package (the reference's shuffle here was
        # unseeded), so a dataset and a whole CLI run are reproducible
        random.Random(VALIDATION_SPLIT_SEED).shuffle(self.trainset)

    @classmethod
    def get_data_description(cls, num_classes=None):
        """(dtypes dict, shapes dict, number of classes), before the dataset
        exists."""
        shapes = cls._data_shape_description
        modalities = list(shapes.keys())
        if num_classes is None:
            num_classes = cls._num_default_classes
        dtypes = {"labels": np.int32,
                  **{m: np.float32 for m in modalities if m != "labels"}}
        return (dtypes, shapes, num_classes)

    def _get_data(self, **kwargs):
        """The data blob of one item; kwargs is the unfolded item dict plus
        training_format."""
        raise NotImplementedError

    # -------------------------------------------------------- set accessors
    def _source(self, setlist, training_format=False):
        return DataSource(self, setlist, training_format=training_format)

    def get_trainset(self, tf_dataset=True, training_format=True):
        src = self._source(self.trainset, training_format=training_format)
        return src if tf_dataset else src.as_dict()

    def get_testset(self, num_items=None, tf_dataset=True):
        items = self.testset[:num_items] if num_items else self.testset
        src = self._source(items)
        return src if tf_dataset else src.as_dict()

    def get_measureset(self, tf_dataset=True):
        src = self._source(self.measureset)
        return src if tf_dataset else src.as_dict()

    def get_validation_set(self, num_items=None, tf_dataset=True):
        items = (self.validation_set[:num_items] if num_items
                 else self.validation_set)
        src = self._source(items)
        return src if tf_dataset else src.as_dict()

    def get_set_data(self, setlist, training_format=False):
        """DataSource over an explicit item list (custom splits)."""
        return self._source(setlist, training_format=training_format)

    # older accessor names used by parts of the reference experiment layer
    def get_measure_data(self, *args, **kwargs):
        return self.get_measureset(*args, **kwargs)

    def get_test_data(self, *args, **kwargs):
        return self.get_testset(*args, **kwargs)

    def get_validation_data(self, *args, **kwargs):
        return self.get_validation_set(*args, **kwargs)

    def next(self):
        """DataWrapper interface: a random training batch of one item."""
        src = self.get_trainset()
        return src.stack([src.get_blob(np.random.randint(len(src)))])

    def coloured_labels(self, labels):
        """Colorize a label map through the labelinfo colours."""
        lookup = np.array([self.labelinfo[i]["color"]
                           for i in range(max(self.labelinfo.keys()) + 1)]
                          ).astype(int)
        return np.array(lookup[labels[:]]).astype("uint8")
