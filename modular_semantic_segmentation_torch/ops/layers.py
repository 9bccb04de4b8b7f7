"""Layers in PyTorch, with the JAX package's TF1 semantics.

Counterpart of the JAX package's ``ops/layers.py``:
    * conv2d: TF SAME padding (asymmetric at stride 2: the extra pad goes
      to the trailing side), dilation, bias, and conv -> batch-norm ->
      activation ordering; the PTQ calibration record of its input and the
      int8 serving path (``ops/int8_conv.py``), both keyed by its scope;
    * batch_norm: eps 1e-3, in f32; eval mode from the moving statistics,
      train mode (``ctx.train``) from the batch's, recording the moving
      statistics' momentum-0.99 update in ``ctx.updates``;
    * deconv2d: transposed conv with a kernel stored in the TF
      conv2d_transpose layout [H, W, out, in], frozen or trainable; frozen
      channel-diagonal kernels go through
      ``ops/fast_upsample.diagonal_upsample``, the others through a dense
      ``conv_transpose2d``;
    * max_pool2d (VALID; its gradient goes to the first row-major maximum
      of each window, as the JAX package's mask gradient), softmax (with a
      temperature), log_softmax, entropy;
    * adap_conv: the progressive nets' adapter block;
    * dropout: TF-style MC dropout drawing from ``ctx.next_generator()``.

Tensors are NHWC at every function here. A convolution sees the
``permute(0, 3, 1, 2)`` view: an NCHW tensor in channels-last memory, which
cuDNN and the CPU kernels take without a copy. Kernels are stored HWIO
(the npz contract) and permuted to PyTorch's [out, in, kh, kw] per call.
The plain large convolutions stay ``torch.nn.functional`` calls, as the
JAX package leaves them to XLA. Every float path is differentiable, and
autograd gives its gradients: the JAX package's custom VJPs of these
layers are speed formulations of the same gradients on the TPU.
"""

import torch
import torch.nn.functional as F

from modular_semantic_segmentation_torch.ops import int8_conv
from modular_semantic_segmentation_torch.ops.fast_upsample import (
    diagonal_upsample, same_transpose_crop)

# TF tf.layers.batch_normalization defaults.
BN_MOMENTUM = 0.99
BN_EPSILON = 1e-3


def configure_float32():
    """Run float32 convolutions and matmuls on the card in full float32.

    PyTorch's defaults differ: cuDNN convolutions may use TF32 (about three
    decimal digits), matmuls may not. The float32 path is held against the
    JAX package's float32 numbers, so both switches are set off here,
    explicitly. The bfloat16 path is not affected.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _pair(v):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def _same_pads(size, kernel, stride, dilation):
    """TF SAME padding (leading, trailing) along one axis."""
    reach = dilation * (kernel - 1) + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + reach - size, 0)
    return total // 2, total - total // 2


def _check_shape(value, shape, name):
    if tuple(value.shape) != tuple(shape):
        raise ValueError(f"variable '{name}' has shape {tuple(value.shape)},"
                         f" the layer needs {tuple(shape)}")


def batch_norm(ctx, x, name):
    """TF1 batch normalization over the channel (last) axis.

    Variables ``<name>/{gamma,beta,moving_mean,moving_variance}``. The
    statistics and the affine run in float32 (float64 for a float64
    ``x``, the reference steps of the checks) and the result is cast back
    to ``x.dtype``. In train mode the batch mean and the biased variance
    over every other axis (two passes, as ``tf.nn.moments``; the mean
    inside the variance carries no gradient, as in the JAX package)
    normalize, and ``0.99 * moving + 0.01 * batch`` is recorded for each
    moving statistic. ``torch.nn.functional.batch_norm`` would record the
    unbiased variance instead.
    """
    with ctx.scope(name):
        gamma = ctx.get("gamma")
        beta = ctx.get("beta")
        mean = ctx.get("moving_mean")
        var = ctx.get("moving_variance")
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        if ctx.train:
            axes = tuple(range(x.ndim - 1))
            moving_mean, moving_var = mean, var
            mean = torch.mean(x32, dim=axes)
            var = torch.mean(torch.square(x32 - mean.detach()), dim=axes)
            ctx.record_update("moving_mean", BN_MOMENTUM * moving_mean
                              + (1.0 - BN_MOMENTUM) * mean)
            ctx.record_update("moving_variance", BN_MOMENTUM * moving_var
                              + (1.0 - BN_MOMENTUM) * var)
    inv = torch.rsqrt(var + BN_EPSILON) * gamma
    out = x32 * inv + (beta - mean * inv)
    return out.to(x.dtype)


def _epilogue(ctx, out, name, activation, batch_normalization):
    out = out.to(ctx.compute_dtype)
    if batch_normalization:
        out = batch_norm(ctx, out, name)
    if activation is not None:
        out = activation(out)
    return out


def percentile(x, q):
    """The ``q``-th percentile of all of ``x``, linear interpolation
    between the two nearest ranks, as ``numpy.percentile`` and
    ``jnp.percentile`` compute it. Through a sort of the flattened tensor:
    ``torch.quantile`` refuses inputs above 2**24 elements. The position
    is computed in float64 on the host, the interpolation in float64 of
    the two values; the result is float32 on ``x``'s device."""
    flat = torch.sort(x.reshape(-1)).values
    position = q / 100.0 * (flat.numel() - 1)
    lo = int(position)
    hi = min(lo + 1, flat.numel() - 1)
    low, high = flat[lo].double(), flat[hi].double()
    return (low + (high - low) * (position - lo)).float()


def _calibrate(ctx, x, quant_key):
    """Record the running max (or ``ctx.calibrate_percentile``) of |x| in
    float32 under ``quant_key``, and x's H*W beside it."""
    absx = torch.abs(x.float())
    q = ctx.calibrate_percentile
    amax = torch.amax(absx) if q >= 100.0 else percentile(absx, q)
    if quant_key in ctx.amax:
        amax = torch.maximum(ctx.amax[quant_key], amax)
    ctx.amax[quant_key] = amax
    ctx.amax[ctx.full_name("input_pixels")] = float(x.shape[1] * x.shape[2])


def _int8_operands(ctx, kernel, act_scale):
    """(int8 kernel as [out, kh*kw*in], the float32 activation scale on the
    kernel's device, the float32 dequantization ``ascale * kscale`` per
    output channel), kept in ``ctx.kernel_cache`` beside the kernel and
    the scale they were made from: the serving loop makes them once, and
    no frame copies a scale to the card (a copy from pageable host memory
    would wait for the stream)."""
    key = ctx.full_name("kernel") + ":int8"
    cached = ctx.kernel_cache.get(key)
    if (cached is not None and cached[0] is kernel
            and cached[1] == act_scale):
        return cached[2]
    kq, kscale = int8_conv.quantize_kernel(kernel)
    # the float32 of the stored Python float, as jnp.float32 gives it
    ascale = torch.full((1,), act_scale, dtype=torch.float32,
                        device=kernel.device)
    value = (kq.reshape(-1, kq.shape[-1]).t().contiguous(), ascale,
             ascale * kscale)
    ctx.kernel_cache[key] = (kernel, act_scale, value)
    return value


def conv2d(ctx, x, filters, kernel_size, name, strides=1, dilation_rate=1,
           activation=torch.relu, use_bias=True, batch_normalization=False):
    """2-D convolution, TF SAME padding, with bias and optional
    batch-norm-then-activation.

    Order as in the JAX package: conv + bias (in float32) -> cast to the
    compute dtype -> [BN] -> activation. Kernel layout [H, W, in, out].
    With ``use_bias=False`` there is no ``bias`` variable and no add: the
    conv's output reaches the epilogue in the compute dtype.

    With ``ctx.calibrate`` the input's |max| (or percentile) is recorded
    first (:func:`_calibrate`). When ``ctx.act_scales`` holds this conv's
    ``<scope>/input_amax`` (and the context is not calibrating), the conv
    runs in int8, as the JAX package's int8 branch: per-tensor input
    scale, per-output-channel kernel scale, int32 sums, dequantized to
    float32 by ``ascale * kscale`` before the bias. A conv whose key is
    not there stays on the float path, and so does every conv in train
    mode (``ctx.train``), as in the JAX package.
    """
    kh, kw = _pair(kernel_size)
    sh, sw = _pair(strides)
    dh, dw = _pair(dilation_rate)
    n, h, w, in_ch = x.shape
    dtype = ctx.compute_dtype
    with ctx.scope(name):
        kernel = ctx.get("kernel")
        _check_shape(kernel, (kh, kw, in_ch, int(filters)),
                     ctx.full_name("kernel"))
        quant_key = ctx.full_name("input_amax")
        if ctx.calibrate:
            _calibrate(ctx, x, quant_key)
        ph = _same_pads(h, kh, sh, dh)
        pw = _same_pads(w, kw, sw, dw)
        if (not ctx.train and not ctx.calibrate
                and ctx.act_scales is not None
                and quant_key in ctx.act_scales):
            kq_t, ascale, dequant = _int8_operands(
                ctx, kernel, ctx.act_scales[quant_key])
            acc = int8_conv.int8_conv2d(
                int8_conv.quantize(x, ascale), kq_t, (kh, kw), (sh, sw),
                (dh, dw), (ph, pw))
            # int32 * float32 [out] promotes to float32 in one pass
            out = torch.mul(acc, dequant)
            if use_bias:
                out.add_(ctx.get("bias"))
        else:
            xd = x.to(dtype)
            if ph[0] == ph[1] and pw[0] == pw[1]:
                pad = (ph[0], pw[0])
            else:
                # asymmetric (strided) SAME: pad the NHWC tensor
                # explicitly; PyTorch's padding='same' refuses stride > 1
                xd = F.pad(xd, (0, 0, pw[0], pw[1], ph[0], ph[1]))
                pad = (0, 0)
            out = F.conv2d(xd.permute(0, 3, 1, 2),
                           kernel.permute(3, 2, 0, 1).to(dtype),
                           stride=(sh, sw), padding=pad, dilation=(dh, dw))
            out = out.permute(0, 2, 3, 1)
            if use_bias:
                # float32 promotion, as jnp's bf16 + f32 in the JAX package
                out = out + ctx.get("bias")
    # outside the conv's scope: batch_norm enters <name> itself
    return _epilogue(ctx, out, name, activation, batch_normalization)


def _channel_diagonal(ctx, kernel):
    """True when the [k, k, C, C] kernel has no off-diagonal weight.

    The answer is kept in ``ctx.kernel_cache`` beside the kernel it was
    computed for, so a frame served with the same kernel does not wait for
    the device to check again."""
    key = ctx.full_name("kernel")
    cached = ctx.kernel_cache.get(key)
    if cached is not None and cached[0] is kernel:
        return cached[1]
    idx = torch.arange(kernel.shape[2], device=kernel.device)
    off = kernel.clone()
    off[:, :, idx, idx] = 0.0
    diagonal = not bool(off.any())
    ctx.kernel_cache[key] = (kernel, diagonal)
    return diagonal


def deconv2d(ctx, x, filters, kernel_size, name, strides=1, activation=None,
             use_bias=False, trainable=False, batch_normalization=True):
    """Transposed convolution with a kernel [H, W, out, in].

    TF ``conv2d_transpose`` semantics (the gradient of a forward conv with
    this HWIO kernel), SAME padding giving out = in * stride. A frozen
    (not ``trainable``) square-channel kernel that is channel-diagonal
    (the bilinear initializer) takes the depthwise path, as in the JAX
    package; that path would give the off-diagonal weights of a trainable
    kernel no gradient. Every other kernel takes a dense
    ``conv_transpose2d`` and the SAME crop, whose autograd gives the
    kernel its full gradient. ``use_bias`` adds ``<name>/bias``
    (float32).
    """
    kh, kw = _pair(kernel_size)
    sh, sw = _pair(strides)
    n, h, w, in_ch = x.shape
    dtype = ctx.compute_dtype
    if kh < sh or kw < sw:
        raise NotImplementedError("SAME transposed conv needs kernel >= "
                                  "stride")
    with ctx.scope(name):
        kernel = ctx.get("kernel")
        _check_shape(kernel, (kh, kw, int(filters), in_ch),
                     ctx.full_name("kernel"))
        if (not trainable and int(filters) == in_ch and kh == kw
                and sh == sw and _channel_diagonal(ctx, kernel)):
            idx = torch.arange(in_ch, device=kernel.device)
            diag = kernel[:, :, idx, idx]
            out = diagonal_upsample(x.to(dtype), diag.to(dtype), sh)
        else:
            # PyTorch's conv_transpose2d weight is [in, out, kh, kw], the
            # same gradient-of-conv semantics
            out = F.conv_transpose2d(x.to(dtype).permute(0, 3, 1, 2),
                                     kernel.permute(3, 2, 0, 1).to(dtype),
                                     stride=(sh, sw))
            lo_h = same_transpose_crop(kh, sh)
            lo_w = same_transpose_crop(kw, sw)
            out = out[:, :, lo_h:lo_h + h * sh, lo_w:lo_w + w * sw]
            out = out.permute(0, 2, 3, 1)
        if use_bias:
            out = out + ctx.get("bias")
    return _epilogue(ctx, out, name, activation, batch_normalization)


def max_pool2d(ctx, x, pool_size, strides):
    """Max pooling with TF layers' default VALID padding.

    PyTorch's kernels, on the CPU and on the card, take the first maximum
    of a window in row-major order (a later value must be strictly
    larger), so the gradient of a window whose maximum is tied goes to
    its first one, as the JAX package's mask gradient (``custom_grad``)
    and XLA's SelectAndScatter route it."""
    out = F.max_pool2d(x.permute(0, 3, 1, 2), _pair(pool_size),
                       _pair(strides))
    return out.permute(0, 2, 3, 1)


def adap_conv(ctx, x, adapter_inputs, filters, kernel_size,
              name="adap_conv", extra_convolution=True,
              activation=torch.relu, **conv_kwargs):
    """The progressive nets' adapter block (arXiv 1606.04671 eq. 2), as
    the JAX package's: each lateral input times its scale
    (``<name>/adapter/scale``, one per column), concatenated; an optional
    1x1 conv to x's width (``<name>/adapter/adapter``); concatenated after
    ``x``; then the ``<name>/combination`` conv with ``conv_kwargs``.
    How the scales and the combination kernel start, and what trains, is
    in the variable specs."""
    with ctx.scope(name):
        with ctx.scope("adapter"):
            scale = ctx.get("scale")
            _check_shape(scale, (len(adapter_inputs),),
                         ctx.full_name("scale"))
            scaled = torch.cat([scale[i] * column for i, column
                                in enumerate(adapter_inputs)], dim=-1)
            adapter = (conv2d(ctx, scaled, int(x.shape[-1]), 1, "adapter",
                              activation=activation)
                       if extra_convolution else scaled)
        together = torch.cat([x, adapter], dim=-1)
        return conv2d(ctx, together, filters, kernel_size, "combination",
                      activation=activation, **conv_kwargs)


def log_softmax(x):
    """Numerically stable log-softmax over the last axis, the JAX
    package's formula."""
    m = torch.amax(x, dim=-1, keepdim=True)
    d = x - m
    return d - torch.log(torch.sum(torch.exp(d), dim=-1, keepdim=True))


def softmax(x, temperature=1.0):
    """Temperature-scaled softmax over the last axis, the JAX package's
    formula. At temperature 1 the division, exact there, is skipped."""
    if temperature != 1.0:
        x = x / temperature
    m = torch.amax(x, dim=-1, keepdim=True)
    e = torch.exp(x - m)
    return e / torch.sum(e, dim=-1, keepdim=True)


def entropy(x):
    """Entropy over the last axis normalized by log(num classes), in
    float32 (the JAX package's float32 log(K) promotes bfloat16)."""
    h = -torch.sum(x * torch.log(torch.clamp(x, 1e-10, 1.0)), dim=-1)
    return h.float() / torch.log(torch.tensor(float(x.shape[-1]),
                                              device=h.device))


def dropout(ctx, x, rate, training=True, noise_shape=None):
    """TF-style dropout: zero with probability ``rate``, scale what is kept
    by 1/(1 - rate).

    The reference's MC-dropout models run dropout even at test time; the
    ``training`` flag turns it off. ``noise_shape`` broadcasts the mask
    (e.g. whole-pixel dropout with channel dim 1). The keep mask is
    uniform < 1 - rate, drawn from ``ctx.next_generator()`` on the device
    of ``x``.
    """
    if not training or rate == 0:
        return x
    keep = 1.0 - rate
    uniform = torch.rand(tuple(noise_shape) if noise_shape else x.shape,
                         generator=ctx.next_generator(), device=x.device)
    return torch.where(uniform < keep, x / keep, torch.zeros_like(x))
