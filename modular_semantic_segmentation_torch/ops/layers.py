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
    * dropout: TF-style MC dropout drawing from ``ctx.next_generator()``;
    * max_pool_with_argmax and unpool_2d: max pooling with TF's flattened
      ``[H*W*C]`` argmax indices, and the max unpooling that scatters
      through them.

Tensors are NHWC at every function here. A convolution sees the
``permute(0, 3, 1, 2)`` view: an NCHW tensor in channels-last memory, which
cuDNN and the CPU kernels take without a copy. Kernels are stored HWIO
(the npz contract). Where autograd records nothing and no program is
traced (:func:`_weight_from_cache`), a conv reads its kernel from the
``KernelCache``, cast to the compute dtype once and laid out as PyTorch's
[out, in, kh, kw] in channels-last memory, which cuDNN takes as it is; a
frozen channel-diagonal deconv reads its diagonal there in the same way.
Otherwise both derive their weight for the call alone, which autograd
follows. The plain large convolutions stay
``torch.nn.functional`` calls, as the JAX package leaves them to XLA.

Under the parallel layer (``parallel/``) the context's axes change three
things, as in the JAX package: with ``ctx.spatial_axis`` convs and deconvs
exchange row halos with the neighbouring height shards (a conv whose reach
exceeds the local block gathers the whole feature map), and convs stay off
the int8 path; train-mode batch norm sums its statistics over
``ctx.sharded_axes``; and with ``ctx.tensor_parallel`` a conv whose kernel
this rank holds a channel shard of computes those output channels, its
bias, batch norm and activation on them, and gathers the channels
(``parallel/tensor_parallel.py``). Every float path is differentiable, and
autograd gives its gradients: the JAX package's custom VJPs of these
layers are speed formulations of the same gradients on the TPU.
"""

import numpy as np
import torch
import torch.nn.functional as F

from modular_semantic_segmentation_torch.ops import int8_conv
from modular_semantic_segmentation_torch.ops.cuda import conv_epilogue
from modular_semantic_segmentation_torch.ops.fast_upsample import (
    diagonal_upsample, same_transpose_crop)
from modular_semantic_segmentation_torch.utils import tracing

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
    channels = x.shape[-1]
    with ctx.scope(name):
        gamma = _channels(ctx, ctx.get("gamma"), channels)
        beta = _channels(ctx, ctx.get("beta"), channels)
        mean = _channels(ctx, ctx.get("moving_mean"), channels)
        var = _channels(ctx, ctx.get("moving_variance"), channels)
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        if ctx.train:
            axes = tuple(range(x.ndim - 1))
            moving_mean, moving_var = mean, var
            if ctx.sharded_axes:
                # statistics over the GLOBAL (N, H, W): the shards' sums
                # summed (the JAX package's psum; sync batch norm)
                from modular_semantic_segmentation_torch.parallel import \
                    collectives
                count = float(np.prod([x.shape[i] for i in axes])) * float(
                    np.prod([a.size for a in ctx.sharded_axes]))
                mean = collectives.all_reduce(torch.sum(x32, dim=axes),
                                              ctx.sharded_axes) / count
                var = collectives.all_reduce(
                    torch.sum(torch.square(x32 - mean.detach()), dim=axes),
                    ctx.sharded_axes) / count
            else:
                mean = torch.mean(x32, dim=axes)
                var = torch.mean(torch.square(x32 - mean.detach()),
                                 dim=axes)
            _record_channels(ctx, "moving_mean", BN_MOMENTUM * moving_mean
                             + (1.0 - BN_MOMENTUM) * mean)
            _record_channels(ctx, "moving_variance", BN_MOMENTUM * moving_var
                             + (1.0 - BN_MOMENTUM) * var)
    inv = torch.rsqrt(var + BN_EPSILON) * gamma
    out = x32 * inv + (beta - mean * inv)
    return out.to(x.dtype)


def _channels(ctx, value, channels):
    """A per-channel variable for ``channels`` channels: as stored, or,
    under tensor parallelism, this rank's block of a whole one or the
    gather of a shard."""
    if ctx.tensor_parallel is None or value.shape[-1] == channels:
        return value
    return ctx.tensor_parallel.fit(value, channels)


def _record_channels(ctx, name, value):
    """``ctx.record_update`` of a per-channel update in the stored
    variable's channels (gathered when the variable is stored whole and
    ``value`` holds this rank's block)."""
    stored = ctx.get(name)
    if value.shape[-1] != stored.shape[-1]:
        value = ctx.tensor_parallel.fit(value.detach(), stored.shape[-1])
    ctx.record_update(name, value)


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


class KernelCache:
    """What the layers derive from a kernel, kept for the next call: whether
    a frozen deconv kernel is channel-diagonal, a conv's int8 operands, a
    conv's kernel in the compute dtype and cuDNN's layout, and a frozen
    deconv's diagonal in the compute dtype. An entry is valid while its
    kernel is the same tensor object at the same :meth:`version`, which an
    in-place write moves, and the activation scale or dtype is the same. A
    miss counts in ``layers.kernel_cache_miss`` while a profiler records;
    the channel-diagonal answer's waits for the device.
    ``Estimator._kernel_cache`` keeps one across calls; a captured CUDA
    graph keeps what it :meth:`held` (``serving.InferenceServer``)."""

    def __init__(self):
        self._entries = {}
        self._decided = {}

    @classmethod
    def decided(cls, variables):
        """A cache for a program traced by ``torch.export``, which cannot
        read its weights: whether each [k, k, C, C] variable is
        channel-diagonal is decided now, by name. The int8 operands are
        derived in the program, from its weights input."""
        cache = cls()
        cache._decided = {
            name: cls._diagonal(value) for name, value in variables.items()
            if value.ndim == 4 and value.shape[0] == value.shape[1]
            and value.shape[2] == value.shape[3]}
        return cache

    @staticmethod
    def version(tensor):
        """The tensor's version counter, which an in-place write moves;
        None for an inference tensor, which keeps none, and while a
        program is traced, whose tensors are fakes."""
        if tensor.is_inference() or torch.compiler.is_compiling():
            return None
        return tensor._version

    def _derive(self, form, name, kernel, args, make):
        key = (self.version(kernel),) + args
        entry = self._entries.get((form, name))
        if entry is not None and entry[0] is kernel and entry[1] == key:
            return entry[2]
        tracing.count("layers.kernel_cache_miss")
        value = make(kernel, *args)
        self._entries[(form, name)] = (kernel, key, value)
        return value

    def channel_diagonal(self, name, kernel):
        """True when the [k, k, C, C] ``kernel`` has no off-diagonal
        weight."""
        if name in self._decided:
            return self._decided[name]
        return self._derive("diagonal", name, kernel, (), self._diagonal)

    def int8_operands(self, name, kernel, act_scale):
        """(int8 kernel as [out, kh*kw*in], the float32 activation scale
        on the kernel's device, the float32 dequantization ``ascale *
        kscale`` per output channel)."""
        return self._derive("int8", name, kernel, (act_scale,),
                            self._quantize)

    def conv_weight(self, name, kernel, dtype, x):
        """The HWIO ``kernel`` as ``F.conv2d``'s [out, in, kh, kw] weight in
        ``dtype`` for a conv over ``x``. The entry, where
        :func:`_weight_from_cache` allows it, is in channels-last memory
        (the [out, kh, kw, in] order), which cuDNN takes for a
        channels-last input without a copy. Otherwise the weight is the
        permuted view of the cast kernel, which the conv copies for itself:
        so autograd saves no copy of a float32 kernel, which the cast
        returns as it is. While a profiler records, it adds one to
        ``layers.weight_cached`` where it reads the entry, else one to
        ``layers.weight_per_call``."""
        if not _weight_from_cache(x, kernel):
            tracing.count("layers.weight_per_call")
            return kernel.to(dtype).permute(3, 2, 0, 1)
        tracing.count("layers.weight_cached")
        return self._derive("weight", name, kernel, (dtype,),
                            self._conv_weight)

    def diagonal_weight(self, name, kernel, dtype, x):
        """The diagonal [k, k, C] of the [k, k, C, C] ``kernel`` in
        ``dtype``: the upsample weights of a channel-diagonal deconv over
        ``x``, the entry where :func:`_weight_from_cache` allows it."""
        if not _weight_from_cache(x, kernel):
            return self._diagonal_weight(kernel, dtype)
        return self._derive("diagonal_weight", name, kernel, (dtype,),
                            self._diagonal_weight)

    def quantized(self):
        """``{kernel name: int8 operands}`` of the entries held."""
        return {name: value for (form, name), (_, _, value)
                in self._entries.items() if form == "int8"}

    def held(self):
        """What the entries reference: kernels, scales, derived values."""
        return tuple(self._entries.values())

    @staticmethod
    def _diagonal(kernel):
        idx = torch.arange(kernel.shape[2], device=kernel.device)
        off = kernel.clone()
        off[:, :, idx, idx] = 0.0
        return not bool(off.any())

    @staticmethod
    def _conv_weight(kernel, dtype):
        return kernel.to(dtype).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

    @staticmethod
    def _diagonal_weight(kernel, dtype):
        idx = torch.arange(kernel.shape[2], device=kernel.device)
        return kernel[:, :, idx, idx].to(dtype)

    @staticmethod
    def _quantize(kernel, act_scale):
        kq, kscale = int8_conv.quantize_kernel(kernel)
        # the float32 of the stored Python float, as jnp.float32 gives it
        ascale = torch.full((1,), act_scale, dtype=torch.float32,
                            device=kernel.device)
        return (kq.reshape(-1, kq.shape[-1]).t().contiguous(), ascale,
                ascale * kscale)


def _weight_from_cache(x, kernel):
    """Whether a conv or deconv over ``x`` reads its kernel's derived weight
    from the context's ``KernelCache``: where autograd records nothing (a
    train step makes new trainable leaves every step, and an inference-mode
    tensor cannot be saved for backward) and no program is traced or
    compiled (nothing built as a fake tensor may stay in the cache).
    Decided from the tensors, so every model and mode that meets the
    conditions reads the cache."""
    if torch.is_grad_enabled() and (x.requires_grad or kernel.requires_grad):
        return False
    return not torch.compiler.is_compiling()


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

    On the float path the kernel comes in the compute dtype and cuDNN's
    layout from :meth:`KernelCache.conv_weight`, which reads its entry
    where :func:`_weight_from_cache` allows it and else makes it for this
    call, and counts which in ``layers.weight_cached`` and
    ``layers.weight_per_call``.
    Where :func:`epilogue_chain_reason` finds nothing against it, the
    bias, the rounding to bf16 and the ReLU run as one kernel
    (``ops/cuda/conv_epilogue.py``) over the conv's fresh output, in
    place, bit for bit the chain's values; while a profiler records, such
    a conv adds one to the counter ``layers.epilogue_fused``, and a
    float-path conv with a bias that keeps the chain one to
    ``layers.epilogue_eager``.
    """
    kh, kw = _pair(kernel_size)
    sh, sw = _pair(strides)
    dh, dw = _pair(dilation_rate)
    n, h, w, in_ch = x.shape
    dtype = ctx.compute_dtype
    tp = ctx.tensor_parallel
    fused = False
    with ctx.scope(name):
        kernel = ctx.get("kernel")
        channel_shard = tp is not None and tp.is_sharded(
            ctx.full_name("kernel"))
        _check_shape(kernel, (kh, kw, in_ch, int(filters) // tp.axis.size
                              if channel_shard else int(filters)),
                     ctx.full_name("kernel"))
        if channel_shard:
            x = tp.enter(x)
        quant_key = ctx.full_name("input_amax")
        if ctx.calibrate:
            _calibrate(ctx, x, quant_key)
        ph = _same_pads(h, kh, sh, dh)
        pw = _same_pads(w, kw, sw, dw)
        if (not ctx.train and not ctx.calibrate
                and ctx.act_scales is not None
                and quant_key in ctx.act_scales
                and ctx.spatial_axis is None):
            kq_t, ascale, dequant = ctx.kernel_cache.int8_operands(
                ctx.full_name("kernel"), kernel, ctx.act_scales[quant_key])
            acc = int8_conv.int8_conv2d(
                int8_conv.quantize(x, ascale), kq_t, (kh, kw), (sh, sw),
                (dh, dw), (ph, pw))
            # int32 * float32 [out] promotes to float32 in one pass
            out = torch.mul(acc, dequant)
            if use_bias:
                out.add_(_channels(ctx, ctx.get("bias"), out.shape[-1]))
        else:
            weight = ctx.kernel_cache.conv_weight(ctx.full_name("kernel"),
                                                  kernel, dtype, x)
            if ctx.spatial_axis is not None and kh > 1:
                out = _spatial_conv(ctx.spatial_axis, x.to(dtype), weight,
                                    (kh, kw), (sh, sw), (dh, dw), pw)
            else:
                out = _conv(x.to(dtype), weight, (sh, sw), (dh, dw), ph,
                            pw)
            if use_bias:
                bias = _channels(ctx, ctx.get("bias"), out.shape[-1])
                fused = epilogue_chain_reason(
                    out, bias, dtype, activation,
                    batch_normalization) is None
                if fused:
                    tracing.count("layers.epilogue_fused")
                    out = conv_epilogue.bias_act_(out, bias,
                                                  activation is not None)
                else:
                    tracing.count("layers.epilogue_eager")
                    # float32 promotion, as jnp's bf16 + f32 in the JAX
                    # package
                    out = out + bias
    if not fused:
        # outside the conv's scope: batch_norm enters <name> itself
        out = _epilogue(ctx, out, name, activation, batch_normalization)
    if channel_shard:
        out = tp.gather(out)
    return out


def epilogue_chain_reason(out, bias, compute_dtype, activation,
                          batch_normalization):
    """Why :func:`conv2d` keeps the chain ``out + bias`` (float32), cast,
    [BN], activation for a float-path conv's output ``out`` and ``bias``,
    or None where one pass of ``conv_epilogue.bias_act_`` gives the same
    values: no batch norm, ReLU or no activation, a bf16 output and compute
    dtype with a float32 bias, nothing for autograd to record, no program
    being traced or compiled, and a contiguous output on a CUDA card.
    Decided from the tensors, so every model and mode that meets the
    conditions takes the kernel."""
    if batch_normalization:
        return "batch norm between the bias and the activation"
    if activation is not None and activation is not torch.relu:
        return "an activation other than torch.relu"
    if (compute_dtype != torch.bfloat16 or out.dtype != torch.bfloat16
            or bias.dtype != torch.float32):
        return "not a bf16 output with a float32 bias"
    if torch.is_grad_enabled() and (out.requires_grad
                                    or bias.requires_grad):
        return "autograd records the conv"
    if torch.compiler.is_compiling():
        return "a program being traced or compiled"
    if not out.is_contiguous() or not bias.is_contiguous():
        return "a non-contiguous output or bias"
    if out.device.type != "cuda":
        return "not on a CUDA card"
    return None


def _conv(x, weight, strides, dilation, ph, pw):
    """NHWC conv with an [out, in, kh, kw] ``weight`` and (leading,
    trailing) pads of the height and the width."""
    if ph[0] == ph[1] and pw[0] == pw[1]:
        pad = (ph[0], pw[0])
    else:
        # asymmetric (strided) SAME: pad the NHWC tensor explicitly;
        # PyTorch's padding='same' refuses stride > 1
        x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
        pad = (0, 0)
    out = F.conv2d(x.permute(0, 3, 1, 2), weight, stride=strides,
                   padding=pad, dilation=dilation)
    return out.permute(0, 2, 3, 1)


def _spatial_conv(axis, x, weight, kernel_size, strides, dilation, pw):
    """SAME conv of a block of rows of the frame split over ``axis``, as
    the JAX package's height-sharded path: the SAME pads of the global
    height (stride divides it, so their total is the dilated reach less
    the stride; TF's split, the extra row on the trailing side) come as
    row halos from the neighbouring blocks (zeros at the frame's edges),
    and the height is then VALID. The stride must divide the local
    height. Where the reach exceeds the local block (AdapNet's
    dilation-16 blocks at 1/16 resolution) the whole feature map is
    gathered, convolved, and this block's output rows are kept."""
    from modular_semantic_segmentation_torch.parallel import collectives
    kh, _ = kernel_size
    sh, _ = strides
    h_local = x.shape[1]
    if h_local % sh:
        raise NotImplementedError(
            "spatial sharding needs stride | local block height")
    pad_h = max(dilation[0] * (kh - 1) + 1 - sh, 0)
    halo_top, halo_bottom = pad_h // 2, pad_h - pad_h // 2
    reach = max(halo_top, halo_bottom)
    if reach <= h_local:
        top, bottom = collectives.halo_exchange_rows(x, axis,
                                                     rows=max(reach, 1))
        haloed = torch.cat([top[:, top.shape[1] - halo_top:], x,
                            bottom[:, :halo_bottom]], dim=1)
        return _conv(haloed, weight, strides, dilation, (0, 0), pw)
    whole = collectives.all_gather(x, axis, dim=1)
    out = _conv(whole, weight, strides, dilation, (halo_top, halo_bottom),
                pw)
    rows = h_local // sh
    return out[:, axis.index * rows:(axis.index + 1) * rows]


def deconv2d(ctx, x, filters, kernel_size, name, strides=1, activation=None,
             use_bias=False, trainable=False, batch_normalization=True):
    """Transposed convolution with a kernel [H, W, out, in].

    TF ``conv2d_transpose`` semantics (the gradient of a forward conv with
    this HWIO kernel), SAME padding giving out = in * stride. A frozen
    (not ``trainable``) square-channel kernel that is channel-diagonal
    (the bilinear initializer) takes the depthwise path, as in the JAX
    package, with its diagonal in the compute dtype from
    ``ctx.kernel_cache`` where :func:`_weight_from_cache` allows it; that
    path would give the off-diagonal weights of a trainable kernel no
    gradient. Every other kernel takes a dense
    ``conv_transpose2d`` and the SAME crop, whose autograd gives the
    kernel its full gradient. ``use_bias`` adds ``<name>/bias``
    (float32).
    """
    kh, kw = _pair(kernel_size)
    sh, sw = _pair(strides)
    dtype = ctx.compute_dtype
    if kh < sh or kw < sw:
        raise NotImplementedError("SAME transposed conv needs kernel >= "
                                  "stride")
    spatial = ctx.spatial_axis is not None
    if spatial:
        # one halo row each side covers the kernel's reach when k <=
        # 2 * stride (the reference's 4/2 and 16/8 deconvs); the
        # stride-wide overlap of the output is trimmed below. SAME is
        # translation-covariant, so SAME on the haloed block + trim ==
        # the global SAME.
        from modular_semantic_segmentation_torch.parallel import \
            collectives
        if kh > 2 * sh:
            raise NotImplementedError(
                "spatial sharding needs deconv kernel <= 2*stride")
        top, bottom = collectives.halo_exchange_rows(x, ctx.spatial_axis,
                                                     rows=1)
        x = torch.cat([top, x, bottom], dim=1)
    n, h, w, in_ch = x.shape
    with ctx.scope(name):
        kernel = ctx.get("kernel")
        if ctx.tensor_parallel is not None:
            # the whole kernel: a deconv's channel shards are its input's
            kernel = ctx.tensor_parallel.whole(ctx.full_name("kernel"),
                                               kernel)
        _check_shape(kernel, (kh, kw, int(filters), in_ch),
                     ctx.full_name("kernel"))
        if (not trainable and int(filters) == in_ch and kh == kw
                and sh == sw and ctx.kernel_cache.channel_diagonal(
                    ctx.full_name("kernel"), kernel)):
            diag = ctx.kernel_cache.diagonal_weight(
                ctx.full_name("kernel"), kernel, dtype, x)
            out = diagonal_upsample(x.to(dtype), diag, sh)
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
        if spatial:
            out = out[:, sh:out.shape[1] - sh]
        if use_bias:
            out = out + _channels(ctx, ctx.get("bias"), out.shape[-1])
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


def max_pool_with_argmax(x, pool_size=2, strides=2):
    """VALID max pool of an NHWC tensor and its argmax indices in TF's
    convention: the index into the flattened [H*W*C] tensor of each batch
    item, int32. Of a tied window's maxima the first in row-major order is
    taken."""
    n, h, w, c = x.shape
    pooled, idx = F.max_pool2d(x.permute(0, 3, 1, 2), _pair(pool_size),
                               _pair(strides), return_indices=True)
    # PyTorch's index is h*W + w within each (item, channel) plane
    channel = torch.arange(c, device=x.device).view(1, c, 1, 1)
    tf_idx = idx * c + channel
    return (pooled.permute(0, 2, 3, 1),
            tf_idx.permute(0, 2, 3, 1).to(torch.int32))


def unpool_2d(pool, ind, stride=2):
    """Max unpooling: each pooled value scattered to its flattened
    ``[H*W*C]`` index ``ind`` (as :func:`max_pool_with_argmax` gives it) of
    a zero tensor ``stride`` times the pooled height and width."""
    n, h, w, c = pool.shape
    out = torch.zeros((n, h * stride * w * stride * c), dtype=pool.dtype,
                      device=pool.device)
    out.scatter_(1, ind.reshape(n, -1).long(), pool.reshape(n, -1))
    return out.reshape(n, h * stride, w * stride, c)
