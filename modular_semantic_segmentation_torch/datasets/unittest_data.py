"""In-repo synthetic RGB-D segmentation dataset (the port's copy of the JAX
package's ``datasets/unittest_data.py``).

Deterministic scenes of class-coloured rectangles with correlated depth,
generated from ``RandomState(idx)`` per item, so a blob equals the JAX
package's bit for bit; tiny models learn them, and fusion statistics on
them mean something. No files, no I/O. ``complementary=True`` makes the
5-class corpus whose ambiguities are complementary across modalities (see
``_generate_complementary``).
"""

import numpy as np

from modular_semantic_segmentation_torch.datasets.data_baseclass import \
    DataBaseclass
from modular_semantic_segmentation_torch.datasets.augmentation import \
    augmentate

# base colors / depths per class (class 0 = void)
_CLASS_COLORS = np.array([
    [0, 0, 0], [200, 40, 40], [40, 200, 40], [40, 40, 200], [200, 200, 40],
    [40, 200, 200], [200, 40, 200], [120, 120, 120]], np.float32)
_CLASS_DEPTHS = np.array([0.0, 0.2, 0.4, 0.6, 0.8, 1.0, 1.2, 1.4], np.float32)


class UnittestData(DataBaseclass):

    _num_default_classes = 4
    _data_shape_description = {
        "rgb": (None, None, 3), "depth": (None, None, 1),
        "labels": (None, None)}

    def __init__(self, num_classes=None, height=48, width=64, num_train=20,
                 num_measure=8, num_test=8, noise=20.0, augmentation=None,
                 complementary=False, **config):
        self.height, self.width = height, width
        self.noise = noise
        self.augmentation = augmentation or {}
        self.complementary = complementary
        if complementary:
            num_classes = num_classes or 5
        k = num_classes or self._num_default_classes

        def items(set_name, count, offset):
            return [{"idx": offset + i} for i in range(count)]

        labelinfo = {
            i: {"name": f"class_{i}" if i else "void",
                "color": _CLASS_COLORS[i % len(_CLASS_COLORS)].astype(int)
                .tolist()}
            for i in range(k)}
        DataBaseclass.__init__(
            self,
            items("train", num_train, 0),
            items("measure", num_measure, 10_000),
            items("test", num_test, 20_000),
            labelinfo,
            validation_set=items("val", 4, 30_000),
            num_classes=num_classes)

    # --- complementary-corruption mode -----------------------------------
    # The corpus that lets the paper's core claim (statistical fusion beats
    # every single-modality expert, reference Tables I-V / Synthia nb cells
    # 17-21) be demonstrated end-to-end without the real corpora: class
    # ambiguity is COMPLEMENTARY across modalities, so each expert has a
    # designed blind spot the other modality resolves.
    #   classes 1, 2: identical RGB color, well-separated depths
    #     -> the RGB expert cannot tell them apart, the depth expert can
    #   classes 3, 4: identical depth, well-separated colors
    #     -> the depth expert cannot tell them apart, the RGB expert can
    # plus per-modality region corruption (gray-noise RGB patches, noise
    # depth patches) so each expert also has localized unreliable regions.
    # A Bayes/Dirichlet fusion fitted on the measure set recovers both
    # blind spots from the other expert's likelihoods.
    _COMP_COLORS = np.array([
        [0, 0, 0],        # void
        [200, 60, 60],    # class 1 ┐ same color
        [200, 60, 60],    # class 2 ┘
        [60, 200, 60],    # class 3 — unique color
        [60, 60, 200],    # class 4 — unique color
    ], np.float32)
    _COMP_DEPTHS = np.array([
        0.0,   # void
        0.3,   # class 1 — unique depth
        1.2,   # class 2 — unique depth
        0.75,  # class 3 ┐ same depth
        0.75,  # class 4 ┘
    ], np.float32)

    def _generate_complementary(self, idx):
        rng = np.random.RandomState(idx)
        h, w = self.height, self.width
        if self.num_classes != 5:
            raise ValueError(
                "complementary mode is defined for exactly 5 classes "
                f"(void + 2 color-ambiguous + 2 depth-ambiguous), got "
                f"{self.num_classes}")
        labels = np.full((h, w), 3, np.int32)  # background = class 3
        for _ in range(8):
            cls = rng.randint(1, 5)
            y, x = rng.randint(0, h - 8), rng.randint(0, w - 8)
            bh, bw = rng.randint(6, h // 2), rng.randint(6, w // 2)
            labels[y:y + bh, x:x + bw] = cls
        void_mask = rng.rand(h, w) < 0.02
        labels[void_mask] = 0
        rgb = (self._COMP_COLORS[labels] +
               rng.randn(h, w, 3) * self.noise)
        depth = (self._COMP_DEPTHS[labels][..., None] +
                 rng.randn(h, w, 1).astype(np.float32) * 0.05)
        # per-modality region corruption: patches where one modality is
        # uninformative (the other expert must carry the region)
        for _ in range(2):
            y, x = rng.randint(0, h - 6), rng.randint(0, w - 6)
            bh = min(rng.randint(6, h // 3), h - y)
            bw = min(rng.randint(6, w // 3), w - x)
            rgb[y:y + bh, x:x + bw] = 127.0 + rng.randn(bh, bw, 3) * 40.0
        for _ in range(2):
            y, x = rng.randint(0, h - 6), rng.randint(0, w - 6)
            bh = min(rng.randint(6, h // 3), h - y)
            bw = min(rng.randint(6, w // 3), w - x)
            depth[y:y + bh, x:x + bw] = rng.rand(bh, bw, 1) * 1.5
        rgb = np.clip(rgb, 0, 255).astype(np.uint8)
        return rgb, depth.astype(np.float32), labels

    def _generate(self, idx):
        if self.complementary:
            return self._generate_complementary(idx)
        rng = np.random.RandomState(idx)
        h, w, k = self.height, self.width, self.num_classes
        labels = np.ones((h, w), np.int32)  # background = class 1
        for _ in range(6):
            cls = rng.randint(1, k)
            y, x = rng.randint(0, h - 8), rng.randint(0, w - 8)
            bh, bw = rng.randint(6, h // 2), rng.randint(6, w // 2)
            labels[y:y + bh, x:x + bw] = cls
        # sprinkle some void pixels
        void_mask = rng.rand(h, w) < 0.02
        labels[void_mask] = 0
        rgb = _CLASS_COLORS[labels] + rng.randn(h, w, 3) * self.noise
        rgb = np.clip(rgb, 0, 255).astype(np.uint8)
        depth = (_CLASS_DEPTHS[labels][..., None] +
                 rng.randn(h, w, 1).astype(np.float32) * 0.05)
        return rgb, depth, labels

    def _get_data(self, idx, training_format=False):
        rgb, depth, labels = self._generate(idx)
        blob = {"rgb": rgb, "depth": depth.astype(np.float32),
                "labels": labels}
        if training_format and self.augmentation:
            blob = augmentate(blob, **self.augmentation)
        blob["rgb"] = blob["rgb"].astype(np.float32)
        blob["labels"] = blob["labels"].astype(np.int32)
        return blob
