"""SYNTHIA video-sequences driver (the port's copy of the JAX package's
``datasets/synthia.py``).

Offline preprocessing of each sequence, on first use: rgb resized
1280x760 -> 640x380 bilinear, depth and labels by the upper-left pick of
each 2x2 cell, all cropped to rows 6:374 (640x368, multiples of 16); the
crude label PNGs decoded from their first channel; npy labels, PNG rgb and
depth, and a per-sequence 80/20 train/test split JSON persisted beside the
raw frames. The testset is then split 50/50 into measure and test sets
(seed 1); labels of class 15 become 13.

Differences from the JAX package: images are read and written with
``datasets/image_io`` (no cv2), and the bilinear resize is the native
library's, within one uint8 step of cv2's on under 20% of pixels
(ROADMAP.md, section 3). The split JSON is unseeded in both packages.
"""

import itertools
import json
import shutil
from os import listdir, makedirs, path

import numpy as np

from modular_semantic_segmentation_torch import settings
from modular_semantic_segmentation_torch.datasets import (
    image_io, native_backend)
from modular_semantic_segmentation_torch.datasets.augmentation import \
    augmentate
from modular_semantic_segmentation_torch.datasets.data_baseclass import (
    DataBaseclass, train_test_split)

AVAILABLE_SEQUENCES = [
    "SYNTHIA-SEQS-04-DAWN", "SYNTHIA-SEQS-04-FALL", "SYNTHIA-SEQS-04-FOG",
    "SYNTHIA-SEQS-04-NIGHT", "SYNTHIA-SEQS-04-RAINNIGHT",
    "SYNTHIA-SEQS-04-SOFTRAIN", "SYNTHIA-SEQS-04-SPRING",
    "SYNTHIA-SEQS-04-SUMMER", "SYNTHIA-SEQS-04-SUNSET",
    "SYNTHIA-SEQS-04-WINTER", "SYNTHIA-SEQS-04-WINTERNIGHT"]

# label information according to the SYNTHIA README
LABELINFO = {
    0: {"name": "void", "color": [0, 0, 0]},
    1: {"name": "sky", "color": [128, 128, 128]},
    2: {"name": "building", "color": [128, 0, 0]},
    3: {"name": "road", "color": [128, 64, 128]},
    4: {"name": "sidewalk", "color": [0, 0, 192]},
    5: {"name": "fence", "color": [64, 64, 128]},
    6: {"name": "vegetation", "color": [128, 128, 0]},
    7: {"name": "pole", "color": [192, 192, 128]},
    8: {"name": "car", "color": [64, 0, 128]},
    9: {"name": "traffic sign", "color": [192, 128, 128]},
    10: {"name": "pedestrian", "color": [64, 64, 0]},
    11: {"name": "bicycle", "color": [0, 128, 192]},
    12: {"name": "lanemarking", "color": [0, 192, 0]},
    13: {"name": "traffic light", "color": [0, 128, 128]},
}

# the preprocessed frame: the resize target (width, height) and the rows
# kept of it
RESIZED = (640, 380)
KEPT_ROWS = slice(6, 374)


def synthia_basepath():
    """``<DATA_BASEPATH>/synthia``, read from the settings when called."""
    return path.join(settings.DATA_BASEPATH, "synthia")


def one_channel_image_reader(filepath, datatype,
                             input_has_three_channels=True):
    """Decode the crude label and depth PNG format: only the first channel
    holds the value."""
    array = image_io.imread(filepath, image_io.IMREAD_ANYDEPTH
                            | image_io.IMREAD_ANYCOLOR)
    if array is None:
        raise IOError(f"could not read {filepath}")
    if array.ndim == 3 and input_has_three_channels:
        array = array[:, :, 0]
    return array.astype(datatype)


def crop_resized_image(image):
    """Crop 640x380 -> 640x368 so the sides divide by 16."""
    return image[KEPT_ROWS]


class Synthia(DataBaseclass):
    """SYNTHIA sequences at 640x368 with a per-sequence 80/20 split."""

    _data_shape_description = {
        "rgb": (None, None, 3), "depth": (None, None, 1),
        "labels": (None, None)}
    _num_default_classes = 14

    def __init__(self, seqs=None, base_path=None, force_preprocessing=False,
                 direction="F", num_classes=None, augmentation=None,
                 **config):
        seqs = seqs or AVAILABLE_SEQUENCES
        base_path = base_path or synthia_basepath()
        if not path.exists(base_path):
            message = "ERROR: Path to SYNTHIA dataset does not exist."
            print(message)
            raise IOError(1, message, base_path)
        if not len(seqs) > 0:
            raise UserWarning("ERROR: Need to specify at least one synthia "
                              "set")
        self.base_path = base_path
        self.direction = direction
        self.augmentation = augmentation or {}

        for sequence in seqs:
            if force_preprocessing or not path.exists(
                    path.join(base_path, sequence, "resized_rgb_F")):
                self._preprocessing(sequence)

        trainset, testset = [], []
        for sequence in seqs:
            with open(path.join(self.base_path, sequence,
                                "train_test_split.json")) as f:
                split = json.load(f)
            trainset.extend([{"sequence": sequence, "image_name": name}
                             for name in split["trainset"]])
            testset.extend([{"sequence": sequence, "image_name": name}
                            for name in split["testset"]])
        measureset, testset = train_test_split(testset, test_size=0.5,
                                               random_state=1)
        DataBaseclass.__init__(self, trainset, measureset, testset,
                               LABELINFO, num_classes=num_classes)

    def _preprocessing(self, sequence):
        """Resize, decode and split one sequence."""
        print(f"INFO: Preprocessing started for {sequence}. This may take "
              "a while.")
        seq_base = path.join(self.base_path, sequence)
        for modality, direction in itertools.product(
                ["RGB", "Depth", "labels"], ["F", "B", "L", "R"]):
            out_dir = path.join(
                seq_base, f"resized_{modality.lower()}_{direction}")
            src_dir = (path.join(seq_base, modality, "Stereo_Right",
                                 f"Omni_{direction}")
                       if modality in ("RGB", "Depth") else
                       path.join(seq_base, "GT/LABELS/Stereo_Right",
                                 f"Omni_{direction}"))
            if not path.exists(src_dir):
                continue
            if path.exists(out_dir):
                shutil.rmtree(out_dir)
            makedirs(out_dir)
            for filename in listdir(src_dir):
                filepath = path.join(src_dir, filename)
                if modality == "RGB":
                    image = image_io.imread(filepath)
                    resized = native_backend.resize(
                        image, interpolation=native_backend.INTER_LINEAR,
                        dsize=RESIZED)
                    image_io.imwrite(path.join(out_dir, filename),
                                     crop_resized_image(resized))
                elif modality == "Depth":
                    image = one_channel_image_reader(filepath, np.uint16)
                    resized = image[::2, ::2]  # nearest: upper-left pick
                    image_io.imwrite(path.join(out_dir, filename),
                                     crop_resized_image(resized))
                else:
                    array = one_channel_image_reader(filepath, np.uint8)
                    resized = array[::2, ::2]
                    np.save(path.join(out_dir, filename.split(".")[0]),
                            crop_resized_image(resized))

        filenames = [f.split(".")[0] for f in
                     listdir(path.join(seq_base, "resized_rgb_F"))]
        trainset, testset = train_test_split(filenames, test_size=0.2)
        with open(path.join(seq_base, "train_test_split.json"), "w") as f:
            json.dump({"trainset": trainset, "testset": testset}, f)
        print("INFO: Preprocessing finished.")

    def _get_data(self, sequence, image_name, training_format=False):
        d = self.direction
        rgb = image_io.imread(path.join(
            self.base_path, sequence, f"resized_rgb_{d}", f"{image_name}.png"))
        depth = image_io.imread(path.join(
            self.base_path, sequence, f"resized_depth_{d}",
            f"{image_name}.png"), image_io.IMREAD_ANYDEPTH)
        labels = np.load(path.join(
            self.base_path, sequence, f"resized_labels_{d}",
            f"{image_name}.npy"))
        labels = labels.astype(np.int32)
        labels[labels == 15] = 13  # the reference's fix for class 15
        blob = {"rgb": rgb, "depth": np.expand_dims(depth, -1),
                "labels": labels}
        if training_format and self.augmentation:
            blob = augmentate(blob, **self.augmentation)
        blob["rgb"] = blob["rgb"].astype(np.float32)
        blob["depth"] = blob["depth"].astype(np.float32)
        blob["labels"] = blob["labels"].astype(np.int32)
        return blob
