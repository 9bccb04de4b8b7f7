"""The out-of-distribution benchmark data (the port's copy of the JAX
package's ``datasets/not_cityscapes.py``): random objects of the Amsterdam
Object Library pasted onto the frames of a base dataset; the labels are
the in (0) / out-of-distribution (1) mask.

As the JAX package's:
  * every draw comes from numpy's global generator, in its order: the
    object, then its top row, then its left column;
  * the object pool is the library's ids that have a ``<id>_c.png``,
    sorted, and the last id is never sampled (the reference's
    ``np.random.randint(251, 1000)`` over 251..1000);
  * ``halfsize`` resizes an object of h x w pixels with the dsize
    ``(h // 2, w // 2)``, which is (width, height): the halved object
    comes out w // 2 rows by h // 2 columns, transposed in size;
  * a pixel of the pasted object darker than 30 in all three channels is
    background and keeps the frame's pixel;
  * the base dataset is any registered dataset with an rgb modality
    (``cityscapes`` by default).

Differences from the JAX package: objects are read with
``datasets/image_io.imread`` (cv2's BGR order, as ``cv2.imread``) and
halved with the native library's bilinear resize, within one uint8 step of
cv2's on under 20% of pixels (ROADMAP.md, section 3); the frame is padded
with ``np.pad``'s zeros where the JAX package calls
``cv2.copyMakeBorder``.
"""

import tarfile
from os import environ, listdir, path

import numpy as np

from modular_semantic_segmentation_torch import settings
from modular_semantic_segmentation_torch.datasets import (
    image_io, native_backend)
from modular_semantic_segmentation_torch.datasets.augmentation import \
    augmentate
from modular_semantic_segmentation_torch.datasets.data_baseclass import \
    DataBaseclass

#: a pasted pixel darker than this in every channel is background
BACKGROUND_BELOW = 30


def _get_dataset(name):
    from modular_semantic_segmentation_torch.datasets import get_dataset
    return get_dataset(name)


class AddRandomObjects(DataBaseclass):

    _data_shape_description = {"rgb": (None, None, 3),
                               "labels": (None, None)}
    _num_default_classes = 2

    def __init__(self, add_to_dataset="cityscapes", halfsize=True,
                 augmentation=False, in_memory=False, **config):
        self.base_path = path.join(settings.DATA_BASEPATH,
                                   "amsterdam_object_lib")
        if not path.exists(self.base_path):
            message = "ERROR: Path to object library does not exist."
            print(message)
            raise IOError(1, message, self.base_path)

        self.config = {"halfsize": halfsize, "augmentation": augmentation,
                       "in_memory": in_memory}
        print("INFO: Loading Base Dataset")
        self.base_dataset = _get_dataset(add_to_dataset)(
            in_memory=in_memory, **config)

        if in_memory and "TMPDIR" in environ:
            print("INFO loading dataset into memory")
            with tarfile.open(path.join(self.base_path,
                                        "amsterdam_lib.tar.gz")) as tar:
                tar.extractall(path=environ["TMPDIR"])
            self.base_path = environ["TMPDIR"]

        self._object_ids = sorted(
            int(d) for d in listdir(self.base_path)
            if d.isdigit() and path.exists(
                path.join(self.base_path, d, f"{d}_c.png")))
        if not self._object_ids:
            raise IOError(1, "object library is empty", self.base_path)
        if in_memory and "TMPDIR" in environ:
            self.objects = {num: self._load_object(num)
                            for num in self._object_ids}

        DataBaseclass.__init__(
            self, self.base_dataset.trainset, self.base_dataset.measureset,
            self.base_dataset.testset,
            {0: {"name": "in-distribution", "color": [0, 0, 0]},
             1: {"name": "out-of-distribution", "color": [255, 0, 0]}},
            validation_set=self.base_dataset.validation_set,
            num_classes=self.base_dataset._num_default_classes)

    def _load_object(self, object_name):
        obj = image_io.imread(path.join(
            self.base_path, f"{object_name}/{object_name}_c.png"))
        if self.config["halfsize"]:
            h, w, _ = obj.shape
            obj = native_backend.resize(obj, dsize=(h // 2, w // 2))
        return obj

    def _get_data(self, training_format=False, **kwargs):
        img = self.base_dataset._get_data(training_format=False,
                                          **kwargs)["rgb"]
        pool = self._object_ids
        num = pool[np.random.randint(max(1, len(pool) - 1))]
        if self.config["in_memory"] and hasattr(self, "objects"):
            obj = self.objects[num].copy()
        else:
            obj = self._load_object(num)
        h, w, _ = obj.shape
        img_h, img_w = img.shape[:2]
        top = np.random.randint(img_h - h)
        left = np.random.randint(img_w - w)
        obj = np.pad(obj, ((top, img_h - top - h), (left, img_w - left - w),
                           (0, 0)))
        background = np.all(obj < BACKGROUND_BELOW, axis=2)
        blob = {
            "rgb": np.where(background[..., None], img, obj),
            "labels": (1 - background).astype(np.int32),
        }
        if training_format and self.config["augmentation"]:
            blob = augmentate(blob, **self.config["augmentation"])
        blob["rgb"] = blob["rgb"].astype(np.float32)
        blob["labels"] = blob["labels"].astype(np.int32)
        return blob
