"""Multi-dataset training mixer (the port's copy of the JAX package's
``datasets/mixed_data.py``): per-dataset batch quotas, concatenated
batches; evaluation delegates to one of the datasets."""

import numpy as np

from modular_semantic_segmentation_torch.datasets.wrapper import DataWrapper


class MixedData(DataWrapper):
    """Mixes training batches from several datasets.

    Args:
        datasets: list of instantiated dataset objects.
        batch_distr: list of per-dataset items per mixed batch.
        eval_dataset_idx: index of the dataset used for eval accessors.
    """

    def __init__(self, datasets, batch_distr, eval_dataset_idx=0):
        if len(datasets) != len(batch_distr):
            raise ValueError(f"{len(datasets)} datasets but "
                             f"{len(batch_distr)} batch quotas")
        self.datasets = datasets
        self.batch_distr = batch_distr
        self.eval_dataset = datasets[eval_dataset_idx]
        self.modalities = self.eval_dataset.modalities
        self.labelinfo = self.eval_dataset.labelinfo
        self.num_classes = self.eval_dataset.num_classes
        self._iterators = None
        self._iterator_scale = None

    @classmethod
    def get_data_description(cls, num_classes=None):
        raise NotImplementedError(
            "use the description of one of the mixed datasets")

    def next(self, scale=1):
        """A concatenated batch holding the per-dataset quotas, each scaled
        by the integer ``scale``."""
        if self._iterators is None or scale != self._iterator_scale:
            self._iterator_scale = scale
            self._iterators = [
                d.get_trainset().batches(n * scale, shuffle=True, repeat=True)
                for d, n in zip(self.datasets, self.batch_distr)]
        parts = [next(it) for it in self._iterators]
        return {m: np.concatenate([p[m] for p in parts])
                for m in parts[0]}

    def get_trainset(self, *args, **kwargs):
        mixer = self
        quota = sum(self.batch_distr)

        class _MixedSource:
            def batches(self, batchsize, shuffle=False, repeat=False,
                        seed=None, workers=None):
                # the quotas are proportions: the batch size must be a
                # whole multiple of their sum; the datasets' own
                # iterators shuffle (unseeded, as in the JAX package) and
                # assemble, so seed and workers go unused
                if batchsize % quota:
                    raise ValueError(
                        f"batchsize {batchsize} is not a multiple of "
                        f"sum(batch_distr)={quota}; cannot honor the "
                        "per-dataset mixing quotas")
                scale = batchsize // quota
                while True:
                    yield mixer.next(scale)
                    if not repeat:
                        return
        return _MixedSource()

    def get_testset(self, *args, **kwargs):
        return self.eval_dataset.get_testset(*args, **kwargs)

    def get_measureset(self, *args, **kwargs):
        return self.eval_dataset.get_measureset(*args, **kwargs)

    def get_validation_set(self, *args, **kwargs):
        return self.eval_dataset.get_validation_set(*args, **kwargs)
