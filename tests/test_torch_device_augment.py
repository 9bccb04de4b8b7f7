"""On-device augmentation (``ops/device_augment``) against the JAX
package's, on the CPU.

PyTorch cannot replay ``jax.random``, so the port's sampling is split
into uniform draws and the maps built from them; the tests rebuild JAX's
draws from its key (``jax.random.split`` and ``uniform`` as its code
calls them) and feed them to the port. Tolerances:

* the [3, 3] maps from JAX's draws: within float32 rounding (rtol 1e-5 of
  the map's largest entry);
* ``_warp`` given the same map: exact for order 0 (labels), on both paths,
  with coordinates that land exactly on .5 (the separable path rounds
  half to even as ``jnp.round``, the general one half away from zero as
  ``map_coordinates``); order 1 on uint8 exact except rounding ties
  (JAX's float value within 1e-3 of a half-integer), order 1 on float32
  within 1e-3;
* the photometric chain from fixed draws: within 1e-3 of 255;
* whole augmented samples from JAX's draws: labels exact, rgb as the
  warps;
* one SGD(1.0) train step with ``device_augmentation`` whose draws are
  pinned by degenerate ranges: the tolerances of tests/
  test_torch_training.py (loss rtol 1e-5, each delta within 1e-3 of the
  tensor's scale);
* the sampling in distribution (flip rates, gates, ranges) from the
  port's own generator, and ``remat`` with augmentation equal to the plain
  step bit for bit.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from modular_semantic_segmentation_tpu.models import get_model as jax_model
from modular_semantic_segmentation_tpu.ops import device_augment as jda
from modular_semantic_segmentation_tpu.ops.variables import \
    split_trainable as jax_split_trainable
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.models.params import \
    from_jax_variables
from modular_semantic_segmentation_torch.ops import device_augment as da
from modular_semantic_segmentation_torch.ops import optimizers

GEOMETRIES = [
    {"crop": (0.7, 16), "scale": (0.6, 0.7, 1.5), "hflip": 0.5,
     "vflip": 0.5},
    {"crop": (0.8, 16), "rotate": (0.7, -13, 13), "shear": (0.7, 0.05, 0.1)},
    {"rotate": (1.0, -30, 30)},
    {"crop": (1.0, 24), "scale": (1.0, 0.4, 2.0), "rotate": (0.5, -10, 10),
     "shear": (0.5, 0.01, 0.03), "hflip": 0.7, "vflip": 0.3},
    {"hflip": 1.0, "vflip": 1.0},
]
TIE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one intra-op thread while JAX runs in the same process
    (ROADMAP.md section 3, note 2)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_draws(sample_key):
    """The uniforms JAX's augment_sample draws from ``sample_key``:
    (geometry [14], photometric [6], label flip), float32."""
    geometry_key, photo_key, label_key = jax.random.split(sample_key, 3)
    geometry = [jax.random.uniform(k)
                for k in jax.random.split(geometry_key, da.GEOMETRY_DRAWS)]
    photo = [jax.random.uniform(k)
             for k in jax.random.split(photo_key, da.PHOTOMETRIC_DRAWS)]
    return (np.asarray(geometry, np.float32), np.asarray(photo, np.float32),
            np.float32(jax.random.uniform(label_key)))


def _batch_draws(keys):
    draws = [_jax_draws(k) for k in keys]
    return tuple(torch.from_numpy(np.stack([d[i] for d in draws]))
                 for i in range(3))


def _images(seed, n=3, h=32, w=40):
    rng = np.random.RandomState(seed)
    return {"rgb": rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8),
            "depth": rng.rand(n, h, w, 1).astype(np.float32),
            "labels": rng.randint(-1, 5, (n, h, w)).astype(np.int32)}


@pytest.mark.parametrize("config", GEOMETRIES)
def test_geometry_from_jax_draws_matches_jax(config):
    in_h, in_w = 32, 40
    out = (config["crop"][1],) * 2 if "crop" in config else (in_h, in_w)
    names = ("scale", "crop", "hflip", "vflip", "rotate", "shear")
    args = [config.get(k, False) for k in names]
    keys = jax.random.split(jax.random.PRNGKey(3), 16)
    u, _, _ = _batch_draws(keys)
    got = da.geometry_from_draws(u, in_h, in_w, *out, **config).numpy()
    for i, key in enumerate(keys):
        want = np.asarray(jda._sample_geometry(
            jax.random.split(key, 3)[0], in_h, in_w, *out, *args))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-5 * scale,
                                   err_msg=f"sample {i}")


def test_largest_rotated_rect_matches_jax():
    w = torch.tensor([64.0, 48.0, 32.0, 40.0, 40.0])
    h = torch.tensor([48.0, 64.0, 32.0, 40.0, 10.0])
    for deg in (0, 1, 10, 30, 45, 60, 89, -20):
        rad = torch.full_like(w, math.radians(deg))
        got = da.largest_rotated_rect(w, h, rad)
        want = jda.largest_rotated_rect(jnp.asarray(w.numpy()),
                                        jnp.asarray(h.numpy()),
                                        jnp.asarray(rad.numpy()))
        for g, j in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-6)


def _maps():
    """Inverse maps as [3, 3] float32: axis-aligned ones whose source
    coordinates land on exact halves (scale 0.5 and 1.5, offsets of .5 and
    .25), a flip, and a rotation with shear (general path only)."""
    aligned = [[[0.5, 0.0, 0.5], [0.0, 1.5, 0.25], [0.0, 0.0, 1.0]],
               [[-1.0, 0.0, 15.5], [0.0, 0.5, -0.5], [0.0, 0.0, 1.0]],
               [[0.73, 0.0, 1.2], [0.0, 1.31, 0.4], [0.0, 0.0, 1.0]]]
    c, s = math.cos(0.3), math.sin(0.3)
    general = [[[c, -s, 6.5], [s * 1.1, c, -3.25], [0.0, 0.0, 1.0]]]
    return (np.asarray(aligned, np.float32), np.asarray(general, np.float32))


def _ties(float_out):
    """Where JAX's float warp lies within TIE of a half-integer."""
    frac = np.abs(np.asarray(float_out) - np.floor(np.asarray(float_out)))
    return np.abs(frac - 0.5) < TIE


@pytest.mark.parametrize("axis_aligned", [True, False])
def test_warp_matches_jax_given_the_same_map(axis_aligned):
    aligned, general = _maps()
    maps = aligned if axis_aligned else np.concatenate([aligned, general])
    images = _images(5, n=len(maps), h=16, w=20)
    out_h, out_w = 16, 18
    m = torch.from_numpy(maps)
    for name, order in (("labels", 0), ("depth", 1), ("rgb", 1)):
        got = da._warp(torch.from_numpy(images[name]), m, out_h, out_w,
                       order, axis_aligned=axis_aligned).numpy()
        for i in range(len(maps)):
            want = np.asarray(jda._warp(
                jnp.asarray(images[name][i]), jnp.asarray(maps[i]), out_h,
                out_w, order, axis_aligned=axis_aligned))
            assert got[i].dtype == want.dtype
            if name == "labels":
                np.testing.assert_array_equal(got[i], want, err_msg=str(i))
            elif name == "depth":
                np.testing.assert_allclose(got[i], want, atol=1e-3)
            else:
                ties = _ties(jda._warp(
                    jnp.asarray(images[name][i], jnp.float32),
                    jnp.asarray(maps[i]), out_h, out_w, order,
                    axis_aligned=axis_aligned))
                diff = np.abs(got[i].astype(int) - want.astype(int))
                assert diff.max() <= 1
                assert not diff[~ties].any(), f"map {i}"


def test_nearest_rounds_half_to_even_separable_and_away_general():
    """Source rows 0.5, 1.5, 2.5, ...: the separable path takes rows 0, 2,
    2, 4 (half to even, as jnp.round), the general path rows 1, 2, 3, 4
    (half away from zero, as map_coordinates)."""
    labels = torch.arange(8, dtype=torch.int32)[:, None].repeat(1, 4)[None]
    m = torch.tensor([[[1.0, 0.0, 0.5], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]])
    sep = da._warp(labels, m, 4, 4, 0, axis_aligned=True)[0, :, 0]
    gen = da._warp(labels, m, 4, 4, 0, axis_aligned=False)[0, :, 0]
    assert sep.tolist() == [0, 2, 2, 4]
    assert gen.tolist() == [1, 2, 3, 4]
    for axis_aligned, got in ((True, sep), (False, gen)):
        want = jda._warp(jnp.asarray(labels[0].numpy()),
                         jnp.asarray(m[0].numpy()), 4, 4, 0,
                         axis_aligned=axis_aligned)
        assert np.asarray(want)[:, 0].tolist() == got.tolist()


@pytest.mark.parametrize("chain", [
    {"contrast": (1.0, 1.3, 1.3)},
    {"brightness": (1.0, -20.0, -20.0)},
    {"gamma": (1.0, 0.7, 0.7)},
    {"contrast": (0.5, 0.5, 1.5), "brightness": (0.5, -40, 40),
     "gamma": (0.5, 0.3, 1.2)},
])
def test_photometric_matches_jax(chain):
    rng = np.random.RandomState(1)
    rgb = rng.randint(0, 256, (6, 8, 9, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(9), 6)
    photo_keys = [jax.random.split(k, 3)[1] for k in keys]
    _, u, _ = _batch_draws(keys)
    got = da._photometric(u, torch.from_numpy(rgb), **chain).numpy()
    for i, key in enumerate(photo_keys):
        want = np.asarray(jda._photometric(
            key, jnp.asarray(rgb[i]), chain.get("gamma", False),
            chain.get("contrast", False), chain.get("brightness", False)))
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("config", GEOMETRIES[:2] + [
    {"crop": (1.0, 16), "hflip": 0.5, "gamma": (0.5, 0.4, 1.4),
     "contrast": (0.5, 0.5, 1.5), "label_flip": (1, 2),
     "label_merge": (0, 4)}])
def test_augmented_samples_match_jax(config):
    """Whole samples from JAX's draws: labels exact, depth within 1e-3,
    rgb (uint8) exact except rounding ties."""
    images = _images(7, n=4)
    keys = jax.random.split(jax.random.PRNGKey(11), 4)
    got = da.augment_from_draws(
        {k: torch.from_numpy(v) for k, v in images.items()},
        *_batch_draws(keys), **config)
    for i, key in enumerate(keys):
        want = jda.augment_sample(
            key, {k: jnp.asarray(v[i]) for k, v in images.items()},
            **config)
        np.testing.assert_array_equal(got["labels"][i].numpy(),
                                      np.asarray(want["labels"]))
        np.testing.assert_allclose(got["depth"][i].numpy(),
                                   np.asarray(want["depth"]), atol=1e-3)
        diff = np.abs(got["rgb"][i].numpy().astype(int)
                      - np.asarray(want["rgb"]).astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_label_flip_and_merge():
    labels = torch.from_numpy(np.tile([1, 2, 3], (6, 2)).astype(np.int32))
    blob = {"labels": labels[None].repeat(40, 1, 1)}
    gen = torch.Generator().manual_seed(0)
    out = da.augment_batch(gen, blob, label_flip=(1, 2))["labels"]
    directions = set()
    for sample in out:
        values = set(sample.unique().tolist())
        assert not values >= {1, 2}  # one of them got mapped
        directions.add(2 in values)
    assert directions == {True, False}  # both directions occur
    out = da.augment_batch(gen, blob, label_merge=(0, 3))["labels"]
    assert not (out == 3).any() and (out == 0).sum() == 40 * 6 * 2


def test_sampling_in_distribution():
    """The port's own draws: flips at half their probability (the extra
    coin), every flip exact, scale and crop gates at their rates, the crop
    offsets within the scaled frame."""
    n, h, w = 400, 16, 20
    labels = torch.arange(h * w, dtype=torch.int32).reshape(1, h, w)
    blob = {"labels": labels.repeat(n, 1, 1)}
    gen = torch.Generator().manual_seed(1)
    out = da.augment_batch(gen, blob, hflip=1.0)["labels"]
    flipped = (out == labels.flip(1)).all(-1).all(-1)
    same = (out == labels).all(-1).all(-1)
    assert bool((flipped | same).all())
    assert 0.4 < flipped.float().mean() < 0.6
    u = da.draw_uniforms(gen, n, da.GEOMETRY_DRAWS)
    m = da.geometry_from_draws(u, h, w, 8, 8, crop=(0.6, 8),
                               scale=(0.5, 0.7, 1.5))
    k = 1.0 / m[:, 0, 0]
    crop_gate = u[:, 0] < 0.6
    scaled = (k != 1.0)
    assert 0.5 < crop_gate.float().mean() < 0.7
    assert not bool((scaled & ~crop_gate).any())  # scale only with a crop
    assert 0.2 < scaled.float().mean() < 0.4
    assert bool((k[scaled] >= 0.7 - 1e-6).all() & (k[scaled] <= 1.5).all())
    off_y, off_x = m[:, 0, 2] * k, m[:, 1, 2] * k
    assert bool((off_y >= 0).all() & (off_y <= h * k - 8 + 1e-4).all())
    assert bool((off_x >= 0).all() & (off_x <= w * k - 8 + 1e-4).all())
    # without a crop the scale gate never fires (the host quirk)
    m = da.geometry_from_draws(u, h, w, h, w, scale=(1.0, 0.7, 1.5))
    assert bool((m[:, 0, 0] == 1.0).all())


# the train step: pinned draws (probabilities 1, degenerate ranges), a
# rotation on the general path, contrast and brightness; the crop of the
# 32x32 frame is 32, so the inscribed rectangle leaves no offset. Gamma
# is left out: the two packages' float32 powers differ in the last bit
# (test_photometric_matches_jax holds them within 1e-3), and at these
# sizes the first conv's bias gradient, a sum of near-cancelling terms,
# moves by percents for rgb moved by 1e-3
PINNED = {"crop": (1.0, 32), "rotate": (1.0, 10, 10),
          "contrast": (1.0, 1.3, 1.3), "brightness": (1.0, -20, -20),
          "label_merge": (0, 4)}
NUM_CLASSES = 5
SMALL = {"prefix": "rgb", "modality": "rgb", "num_units": 4,
         "channel_factor": 0.25, "batch_normalization": False,
         "data_description": (
             {"labels": np.int32, "rgb": np.float32},
             {"rgb": (None, None, 3), "labels": (None, None)},
             NUM_CLASSES)}


def _batch(seed, n=2, size=32):
    rng = np.random.RandomState(seed)
    return {"rgb": (rng.rand(n, size, size, 3) * 255).astype(np.float32),
            "labels": rng.randint(-1, NUM_CLASSES,
                                  (n, size, size)).astype(np.int32)}


def test_pinned_augmentation_draws_do_not_matter():
    batch = {k: torch.from_numpy(v) for k, v in _batch(3).items()}
    outs = [da.augment_batch(torch.Generator().manual_seed(s), batch,
                             **PINNED) for s in (0, 1)]
    for k in batch:
        torch.testing.assert_close(outs[0][k], outs[1][k], rtol=0, atol=0)


def test_sgd_step_with_device_augmentation_matches_jax():
    jnet = jax_model("simple_fcn")(device_augmentation=PINNED, batchsize=2,
                                   **SMALL)
    tnet = get_model("simple_fcn")(device="cpu", device_augmentation=PINNED,
                                   batchsize=2, **SMALL)
    start = {k: np.asarray(v) for k, v in jnet.variables.items()}
    tnet.variables = from_jax_variables(start, device="cpu")
    tnet.trainable = {k: bool(v) for k, v in jnet.trainable.items()}
    jnet._optimizer = optax.sgd(1.0)
    jnet.opt_state = jnet._optimizer.init(
        jax_split_trainable(jnet.variables, jnet.trainable)[0])
    tnet._optimizer = optimizers.SGD(1.0)
    batch = _batch(2)
    jnew, _, jloss = jnet._train_step(jnet.variables, jnet.opt_state, batch,
                                      jax.random.PRNGKey(0))
    tnew, _, tloss = tnet._train_step(tnet.variables, {}, batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for k, before in start.items():
        jv, tv = np.asarray(jnew[k]), tnew[k].numpy()
        if not jnet.trainable[k]:
            np.testing.assert_array_equal(tv, before, err_msg=k)
            continue
        delta = jv - before
        scale = max(float(np.abs(delta).max()), 1e-3)
        np.testing.assert_allclose((tv - before) / scale, delta / scale,
                                   rtol=0, atol=1e-3, err_msg=k)


def test_remat_with_augmentation_matches_plain():
    """Augmentation draws outside the recomputed region, so remat with
    dropout and augmentation gives the plain step bit for bit."""
    config = dict(SMALL, batch_normalization=True, batchsize=2,
                  device_augmentation={"crop": (0.8, 16),
                                       "scale": (0.8, 0.7, 1.5),
                                       "hflip": 0.5,
                                       "gamma": (0.5, 0.4, 1.4)})
    batch = _batch(4)
    results = []
    for remat in (False, True):
        net = get_model("bayesian_fcn")(device="cpu", remat=remat,
                                        dropout_rate=0.3, **config)
        net._optimizer = optimizers.SGD(1.0)
        results.append(net._train_step(net.variables, {}, batch))
    (plain, _, plain_loss), (remat, _, remat_loss) = results
    assert float(plain_loss) == float(remat_loss)
    for k in plain:
        torch.testing.assert_close(remat[k], plain[k], rtol=0, atol=0)


def test_fit_augments_on_the_device_from_the_model_generator():
    """fit with device_augmentation: a seed fixes the trajectory."""
    config = dict(SMALL, batchsize=2, device_augmentation={
        "crop": (1.0, 16), "hflip": 0.5, "brightness": (0.5, -10, 10)})
    data = _batch(5, n=4)
    trained = []
    for _ in range(2):
        net = get_model("simple_fcn")(device="cpu", seed=3,
                                      loader_workers=2, **config)
        net.fit(data, 3, output=False)
        trained.append(net.variables)
    for k in trained[0]:
        torch.testing.assert_close(trained[0][k], trained[1][k], rtol=0,
                                   atol=0)
