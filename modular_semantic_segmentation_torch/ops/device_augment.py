"""Training augmentation on the device (the port's copy of the JAX
package's ``ops/device_augment.py``).

The same probability-gated op set as ``datasets/augmentation.py``, on
batched tensors on the model's device inside the train step, with its
random draws from an explicit ``torch.Generator`` (the estimator's). The
JAX package's semantics are kept, quirks included:

* the scale and shear gates apply only when a crop is scheduled;
* each flip is gated by its probability AND a further fair coin, and
  'hflip' flips the vertical axis, 'vflip' the horizontal one;
* with a crop configured but its gate not firing, a sample gets the
  deterministic top-left crop (the output shape is fixed);
* out-of-bounds samples clamp to the nearest edge pixel instead of cv2's
  zero fill;
* warped values cast back to an integer image dtype round half to even
  (``_cast_back``);
* geometry (scale, rotation with its largest-inscribed-rectangle crop,
  shear, random crop, flips) composes into one inverse affine map per
  sample, ``[N, 3, 3]``, sampled once: bilinear for rgb, nearest for every
  other modality; gamma uses the continuous power curve.

Sampling is two steps, so that a test can feed JAX's draws to the port:
:func:`draw_uniforms` takes the uniforms in [0, 1) from the generator,
one per key that JAX's code splits (14 for the geometry, 6 for the
photometric chain, 1 for the label flip, per sample), and
:func:`geometry_from_draws` / :func:`_photometric` build the maps and the
colour changes from them with JAX's formulas (a ranged draw is
``max(lo, u * (hi - lo) + lo)``, a coin ``u < 0.5``).

The general warp samples with explicit gathers at pixel coordinates, as
``jax.scipy.ndimage.map_coordinates(mode='nearest')`` does (not
``F.grid_sample``, whose normalised coordinates and nearest rounding
differ): nearest rounds the coordinates half away from zero there, while
the separable path (no rotation or shear) rounds half to even, as
``jnp.round`` does in JAX's. Coordinates and weights are computed with
one rounding per elementwise operation, so a card and the CPU give the
same samples for the same map.
"""

import math

import torch

GEOMETRY_DRAWS = 14
PHOTOMETRIC_DRAWS = 6


def largest_rotated_rect(w, h, angle):
    """Width and height of the largest axis-aligned rectangle inside a
    w x h rectangle rotated by ``angle`` radians; branchless, on float32
    tensors, with JAX's tolerance band near 45 degrees."""
    angle = torch.remainder(torch.abs(angle), math.pi)
    angle = torch.where(angle > math.pi / 2, math.pi - angle, angle)
    sin_a, cos_a = torch.sin(angle), torch.cos(angle)
    side_long = torch.maximum(w, h)
    side_short = torch.minimum(w, h)
    thin = side_short <= (2.0 * sin_a * cos_a * side_long
                          + 1e-4 * side_short)
    x = 0.5 * side_short
    sin_safe = torch.where(sin_a == 0, torch.ones_like(sin_a), sin_a)
    wr_thin = torch.where(w >= h, x / sin_safe, x / cos_a)
    hr_thin = torch.where(w >= h, x / cos_a, x / sin_safe)
    cos_2a = cos_a * cos_a - sin_a * sin_a
    tiny = torch.where(cos_2a < 0, torch.full_like(cos_2a, -1e-8),
                       torch.full_like(cos_2a, 1e-8))
    cos_2a = torch.where(torch.abs(cos_2a) < 1e-8, tiny, cos_2a)
    wr_wide = (w * cos_a - h * sin_a) / cos_2a
    hr_wide = (h * cos_a - w * sin_a) / cos_2a
    wr = torch.where(thin, wr_thin, wr_wide)
    hr = torch.where(thin, hr_thin, hr_wide)
    identity = sin_a == 0
    return torch.where(identity, w, wr), torch.where(identity, h, hr)


def draw_uniforms(generator, n, count):
    """[n, count] float32 uniforms in [0, 1) from ``generator``, on its
    device."""
    return torch.rand((n, count), generator=generator,
                      device=generator.device, dtype=torch.float32)


def _ranged(u, lo, hi):
    """JAX's ``uniform(key, minval=lo, maxval=hi)`` from its unit draw."""
    lo = torch.tensor(lo, dtype=torch.float32, device=u.device)
    hi = torch.tensor(hi, dtype=torch.float32, device=u.device)
    return torch.maximum(lo, u * (hi - lo) + lo)


def _eye(n, device):
    return torch.eye(3, dtype=torch.float32, device=device).repeat(n, 1, 1)


def _translation(ty, tx):
    m = _eye(ty.shape[0], ty.device)
    m[:, 0, 2] = ty
    m[:, 1, 2] = tx
    return m


def geometry_from_draws(u, in_h, in_w, out_h, out_w, scale=False,
                        crop=False, hflip=False, vflip=False, rotate=False,
                        shear=False):
    """The [N, 3, 3] inverse affine maps (output (y, x, 1) -> source
    (y, x, 1)) from the geometry uniforms ``u`` [N, 14], in the host
    pipeline's op order, as JAX's ``_sample_geometry`` builds one."""
    n, device = u.shape[0], u.device
    false = torch.zeros(n, dtype=torch.bool, device=device)
    crop_gate = u[:, 0] < crop[0] if crop else false
    one = torch.ones(n, dtype=torch.float32, device=device)

    if scale and crop:
        min_scale = crop[1] / float(min(in_h, in_w))
        k = _ranged(u[:, 1], max(min_scale, scale[1]), scale[2])
        k = torch.where(crop_gate & (u[:, 2] < scale[0]), k, one)
    else:
        k = one
    cur_h, cur_w = float(in_h) * k, float(in_w) * k
    m = _eye(n, device)
    m[:, 0, 0] = 1.0 / k
    m[:, 1, 1] = 1.0 / k

    if rotate:
        rot_gate = u[:, 3] < rotate[0]
        deg = _ranged(u[:, 4], float(rotate[1]), float(rotate[2]))
        rad = torch.deg2rad(torch.where(rot_gate, deg, torch.zeros_like(deg)))
        wr, hr = largest_rotated_rect(cur_w, cur_h, rad)
        wr = torch.where(rot_gate, wr, cur_w)
        hr = torch.where(rot_gate, hr, cur_h)
        cos, sin = torch.cos(-rad), torch.sin(-rad)
        rot = _eye(n, device)
        rot[:, 0, 0], rot[:, 0, 1] = cos, -sin
        rot[:, 1, 0], rot[:, 1, 1] = sin, cos
        m = m @ (_translation(cur_h / 2.0, cur_w / 2.0)
                 @ (rot @ _translation(-hr / 2.0, -wr / 2.0)))
        cur_h, cur_w = hr, wr

    if shear and crop:
        sh_gate = crop_gate & (u[:, 5] < shear[0])
        mag = _ranged(u[:, 6], float(shear[1]), float(shear[2])) * cur_w
        sign = torch.where(u[:, 7] < 0.5, one, -one)
        sh = torch.where(sh_gate, mag * sign / cur_h, torch.zeros_like(mag))
        shear_m = _eye(n, device)
        shear_m[:, 1, 0] = -sh
        m = m @ shear_m

    if crop:
        zero = torch.zeros_like(cur_h)
        off_y = u[:, 8] * torch.maximum(cur_h - out_h, zero)
        off_x = u[:, 9] * torch.maximum(cur_w - out_w, zero)
        m = m @ _translation(torch.where(crop_gate, off_y, zero),
                             torch.where(crop_gate, off_x, zero))
    else:
        # the output keeps the input's shape: zoom the (rotated) canvas
        # back to it
        zoom = _eye(n, device)
        zoom[:, 0, 0] = cur_h / out_h
        zoom[:, 1, 1] = cur_w / out_w
        m = m @ zoom

    for prob, (gate_i, coin_i), axis, size in (
            (hflip, (10, 11), 0, out_h), (vflip, (12, 13), 1, out_w)):
        if prob:
            do = (u[:, gate_i] < prob) & (u[:, coin_i] < 0.5)
            flip = _eye(n, device)
            flip[:, axis, axis] = torch.where(do, -one, one)
            flip[:, axis, 2] = torch.where(do, one * (size - 1.0),
                                           torch.zeros_like(one))
            m = m @ flip
    return m


def _cast_back(out, dtype):
    """Round half to even (not truncate) when casting interpolated floats
    back to an integer image dtype."""
    if not dtype.is_floating_point:
        out = torch.round(out)
    return out.to(dtype)


def _take(img, index, axis):
    """Per-sample ``img[n].take(index[n], axis)`` of [N, H, W, C] by [N, L]
    along axis 1 (rows) or 2 (columns)."""
    shape = list(img.shape)
    shape[axis] = index.shape[1]
    view = [index.shape[0], 1, 1, 1]
    view[axis] = index.shape[1]
    return torch.gather(img, axis, index.reshape(view).expand(shape))


def _sample_separable(img, src_y, src_x, order):
    """Sample [N, H, W, C] float32 at the per-sample row coordinates
    ``src_y`` [N, out_h] and column coordinates ``src_x`` [N, out_w]:
    whole-row and whole-column gathers, edge clamp, JAX's
    ``_sample_separable``."""
    h, w = img.shape[1], img.shape[2]
    src_y = torch.clamp(src_y, 0.0, h - 1.0)
    src_x = torch.clamp(src_x, 0.0, w - 1.0)
    if order == 0:
        rows = _take(img, torch.round(src_y).long(), 1)
        return _take(rows, torch.round(src_x).long(), 2)
    y0f, x0f = torch.floor(src_y), torch.floor(src_x)
    wy = (src_y - y0f)[:, :, None, None]
    wx = (src_x - x0f)[:, None, :, None]
    y0, x0 = y0f.long(), x0f.long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    rows = _take(img, y0, 1) * (1.0 - wy) + _take(img, y1, 1) * wy
    return _take(rows, x0, 2) * (1.0 - wx) + _take(rows, x1, 2) * wx


def _round_half_away(x):
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


def _sample_general(img, src_y, src_x, order):
    """Sample [N, H, W, C] float32 at per-pixel coordinates [N, P] as
    ``map_coordinates(channel, [src_y, src_x], order, mode='nearest')``
    does for each channel: indices clamped to the image, nearest rounding
    half away from zero, bilinear as the sum of weight products in JAX's
    order (y node, then x node)."""
    n, h, w, c = img.shape
    flat = img.reshape(n, h * w, c)

    def at(yi, xi):
        yi = torch.clamp(yi, 0, h - 1)
        xi = torch.clamp(xi, 0, w - 1)
        index = (yi * w + xi)[:, :, None].expand(-1, -1, c)
        return torch.gather(flat, 1, index)

    if order == 0:
        return at(_round_half_away(src_y).long(),
                  _round_half_away(src_x).long())
    y0f, x0f = torch.floor(src_y), torch.floor(src_x)
    wy1, wx1 = src_y - y0f, src_x - x0f
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    y0, x0 = y0f.long(), x0f.long()
    out = None
    for yi, wy in ((y0, wy0), (y0 + 1, wy1)):
        for xi, wx in ((x0, wx0), (x0 + 1, wx1)):
            term = (wy * wx)[:, :, None] * at(yi, xi)
            out = term if out is None else out + term
    return out


def _warp(image, m, out_h, out_w, order, axis_aligned=False):
    """Resample a batch [N, H, W, C] or [N, H, W] through the per-sample
    inverse affine maps ``m`` [N, 3, 3]; ``order`` 1 = bilinear (rgb), 0 =
    nearest (labels, depth). ``axis_aligned`` (no rotation or shear, so
    the maps' off-diagonals are zero) takes the separable path."""
    squeeze = image.dim() == 3
    img = (image[..., None] if squeeze else image).float()
    m = m.float()
    if axis_aligned:
        ys = torch.arange(out_h, dtype=torch.float32, device=img.device)
        xs = torch.arange(out_w, dtype=torch.float32, device=img.device)
        src_y = m[:, 0, 0, None] * ys + m[:, 0, 2, None]
        src_x = m[:, 1, 1, None] * xs + m[:, 1, 2, None]
        out = _sample_separable(img, src_y, src_x, order)
    else:
        ys, xs = torch.meshgrid(
            torch.arange(out_h, dtype=torch.float32, device=img.device),
            torch.arange(out_w, dtype=torch.float32, device=img.device),
            indexing="ij")
        ys, xs = ys.reshape(1, -1), xs.reshape(1, -1)
        src_y = (m[:, 0, 0, None] * ys + m[:, 0, 1, None] * xs
                 + m[:, 0, 2, None])
        src_x = (m[:, 1, 0, None] * ys + m[:, 1, 1, None] * xs
                 + m[:, 1, 2, None])
        out = _sample_general(img, src_y, src_x, order).reshape(
            img.shape[0], out_h, out_w, img.shape[3])
    if squeeze:
        out = out[..., 0]
    return _cast_back(out, image.dtype)


def _photometric(u, rgb, gamma=False, contrast=False, brightness=False):
    """The host formulas of the photometric chain on [N, H, W, 3] rgb in
    [0, 255], from the uniforms ``u`` [N, 6]; returns float32."""
    rgb = rgb.float()
    one = torch.ones_like(u[:, 0])

    def per_sample(v):
        return v[:, None, None, None]

    if contrast:
        alpha = _ranged(u[:, 0], contrast[1], contrast[2])
        alpha = torch.where(u[:, 1] < contrast[0], alpha, one)
        rgb = torch.clamp((rgb - 128.0) * per_sample(alpha) + 128.0,
                          0.0, 255.0)
    if brightness:
        add = _ranged(u[:, 2], brightness[1], brightness[2])
        add = torch.where(u[:, 3] < brightness[0], add, torch.zeros_like(add))
        rgb = torch.clamp(rgb + per_sample(add), 0.0, 255.0)
    if gamma:
        k = _ranged(u[:, 4], gamma[1], gamma[2])
        k = torch.where(u[:, 5] < gamma[0], k, one)
        rgb = torch.pow(rgb / 255.0, per_sample(1.0 / k)) * 255.0
    return rgb


def augment_from_draws(blob, u_geometry, u_photometric, u_label,
                       scale=False, crop=False, hflip=False, vflip=False,
                       gamma=False, contrast=False, brightness=False,
                       rotate=False, shear=False, label_flip=False,
                       label_merge=False):
    """Augment a batch blob {modality: [N, H, W, ...]} with the given
    uniforms ([N, 14], [N, 6], [N]); see :func:`augment_batch`."""
    modalities = list(blob)
    ref = blob[modalities[0]]
    in_h, in_w = int(ref.shape[1]), int(ref.shape[2])
    out_h, out_w = (int(crop[1]), int(crop[1])) if crop else (in_h, in_w)
    m = geometry_from_draws(u_geometry, in_h, in_w, out_h, out_w,
                            scale=scale, crop=crop, hflip=hflip,
                            vflip=vflip, rotate=rotate, shear=shear)
    axis_aligned = not rotate and not (shear and crop)
    out = {modality: _warp(blob[modality], m, out_h, out_w,
                           1 if modality == "rgb" else 0,
                           axis_aligned=axis_aligned)
           for modality in modalities}

    if "rgb" in out and (gamma or contrast or brightness):
        out["rgb"] = _cast_back(
            _photometric(u_photometric, out["rgb"], gamma, contrast,
                         brightness), out["rgb"].dtype)

    if label_flip and "labels" in out:
        c1, c2 = int(label_flip[0]), int(label_flip[1])
        prob = float(label_flip[2]) if len(label_flip) > 2 else 0.5
        labels = out["labels"]
        forward = (u_label < prob).reshape(-1, *([1] * (labels.dim() - 1)))
        mapped_fwd = torch.where(labels == c1, torch.full_like(labels, c2),
                                 labels)
        mapped_bwd = torch.where(labels == c2, torch.full_like(labels, c1),
                                 labels)
        out["labels"] = torch.where(forward, mapped_fwd, mapped_bwd)

    if label_merge and "labels" in out:
        labels = out["labels"]
        out["labels"] = torch.where(
            labels == label_merge[1],
            torch.full_like(labels, label_merge[0]), labels)
    return out


def augment_batch(generator, blob, **config):
    """Augment a batch blob {modality: [N, H, W, ...]} on its device: each
    sample draws its own gates and parameters from ``generator``.

    Arguments follow the host pipeline: probability-first tuples such as
    ``scale=(p, min, max)``, ``crop=(p, size)``, ``rotate=(p, min_deg,
    max_deg)``, ``shear=(p, min, max)`` (fractions of the width),
    ``gamma`` / ``contrast`` / ``brightness=(p, min, max)``, ``hflip=p``,
    ``label_flip=(c1, c2[, p])``, ``label_merge=(into, from)``.
    """
    n = int(next(iter(blob.values())).shape[0])
    u_geometry = draw_uniforms(generator, n, GEOMETRY_DRAWS)
    u_photometric = draw_uniforms(generator, n, PHOTOMETRIC_DRAWS)
    u_label = draw_uniforms(generator, n, 1)[:, 0]
    return augment_from_draws(blob, u_geometry, u_photometric, u_label,
                              **config)
