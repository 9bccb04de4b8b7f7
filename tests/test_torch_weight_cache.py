"""The layers' weight cache on the CPU: a conv's kernel in the compute
dtype and cuDNN's layout, and a frozen deconv's diagonal in the compute
dtype, kept in ``ops/layers.KernelCache`` (forms ``weight`` and
``diagonal_weight``) and read where autograd records nothing and no
program is traced (``layers._weight_from_cache``).

The cached weight gives the per-call weight's bits at every stride,
dilation and SAME pad; a second forward reads every weight from the cache
(counters ``layers.weight_cached`` / ``layers.weight_per_call``) and
misses nothing; a replaced kernel misses and its values are used; a train
step, a forward that autograd records and a traced program read nothing
from it; a served fusion's labels and both experts' probabilities equal,
bit for bit, a forward with trainable leaves under ``torch.enable_grad``,
which casts and permutes per call. The card's version of that comparison
is in ``tests/test_torch_gpu.py`` (marked ``gpu``).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.ops import layers
from modular_semantic_segmentation_torch.ops.layers import KernelCache
from modular_semantic_segmentation_torch.ops.variables import (
    Ctx, split_trainable)
from modular_semantic_segmentation_torch.serving import (ExportedServing,
                                                         InferenceServer,
                                                         export_serving)
from modular_semantic_segmentation_torch.utils import tracing

NUM_CLASSES = 6
DESCRIPTION = (
    {"labels": np.int32, "rgb": np.float32, "depth": np.float32},
    {"rgb": (None, None, 3), "depth": (None, None, 1),
     "labels": (None, None)}, NUM_CLASSES)
# float-path convolutions of one SimpleFCN expert: conv1_1 .. conv5_3,
# score_conv4, score_conv5 and the decoder's score
EXPERT_CONVS = 16


@pytest.fixture(autouse=True)
def _fresh_tracer():
    tracing.reset()
    yield
    tracing.reset()


def _bits(t):
    t = t.detach().contiguous()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _counted(fn):
    """(fn's result, the tracer's counters while it ran under a
    profiler)."""
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, tracing.snapshot()["counters"]


def _kernel(kh, cin, cout, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(kh, kh, cin, cout, generator=gen) * 0.3


def _input(shape, seed=1):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _leaf(t):
    return t.detach().clone().requires_grad_()


# (kernel, stride, dilation, height and width): SAME pads symmetric,
# asymmetric at stride 2 (the extra row and column trailing), symmetric at
# stride 2 on odd sizes, dilated, 1x1, and an even kernel, asymmetric at
# stride 1
CONV_CASES = [(3, 1, 1, (7, 9)), (3, 2, 1, (8, 10)), (3, 2, 1, (7, 9)),
              (3, 1, 2, (9, 11)), (1, 1, 1, (5, 6)), (4, 1, 1, (6, 7))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,stride,dilation,size", CONV_CASES)
def test_cached_conv_equals_the_per_call_weight(dtype, k, stride, dilation,
                                                size):
    """``conv2d`` through the cached weight gives the bits of ``F.conv2d``
    on the per-call ``kernel.to(dtype).permute(3, 2, 0, 1)``, and of
    ``conv2d`` where autograd records it; the cached weight is the same
    tensor's values in channels-last memory."""
    kernel = _kernel(k, 5, 12)
    x = _input((2,) + size + (5,))
    cache = KernelCache()
    args = dict(strides=stride, dilation_rate=dilation, activation=None,
                use_bias=False)
    with torch.no_grad():
        got, counters = _counted(lambda: layers.conv2d(
            Ctx({"conv/kernel": kernel}, compute_dtype=dtype,
                kernel_cache=cache), x, 12, k, "conv", **args))
    assert counters["layers.weight_cached"] == 1
    assert "layers.weight_per_call" not in counters
    ph = layers._same_pads(size[0], k, stride, dilation)
    pw = layers._same_pads(size[1], k, stride, dilation)
    want = layers._conv(x.to(dtype), kernel.to(dtype).permute(3, 2, 0, 1),
                        (stride, stride), (dilation, dilation), ph, pw)
    assert got.dtype == dtype
    assert torch.equal(_bits(got), _bits(want))
    with torch.enable_grad():
        recorded, counters = _counted(lambda: layers.conv2d(
            Ctx({"conv/kernel": _leaf(kernel)}, compute_dtype=dtype,
                kernel_cache=cache), x, 12, k, "conv", **args))
    assert counters["layers.weight_per_call"] == 1
    assert "layers.weight_cached" not in counters
    assert torch.equal(_bits(recorded), _bits(got))
    weight = cache.conv_weight("conv/kernel", kernel, dtype, x)
    assert weight.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(_bits(weight),
                       _bits(kernel.to(dtype).permute(3, 2, 0, 1)))


@pytest.mark.parametrize("grad,x_grad,kernel_grad,compiling,cached", [
    (False, False, False, False, True),
    (True, False, False, False, True),
    (False, True, True, False, True),
    (True, True, False, False, False),
    (True, False, True, False, False),
    (False, False, False, True, False)])
def test_rule_reads_the_cache_only_where_nothing_records_or_traces(
        monkeypatch, grad, x_grad, kernel_grad, compiling, cached):
    x = _input((1, 4, 4, 3))
    kernel = _kernel(3, 3, 4)
    x, kernel = (_leaf(x) if x_grad else x,
                 _leaf(kernel) if kernel_grad else kernel)
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: compiling)
    with torch.set_grad_enabled(grad):
        assert layers._weight_from_cache(x, kernel) is cached


def _fusion(compute_dtype="bfloat16"):
    rng = np.random.RandomState(0)
    cms = {m: rng.rand(NUM_CLASSES, NUM_CLASSES)
           + np.eye(NUM_CLASSES) * 5 for m in ("rgb", "depth")}
    return get_model("bayes_mix")(
        data_description=DESCRIPTION, confusion_matrices=cms, device="cpu",
        num_units=4, channel_factor=0.125, expert_model="fcn",
        prefixes={"rgb": "rgb", "depth": "depth"},
        compute_dtype=compute_dtype)


def _frames(n, seed=1):
    rng = np.random.RandomState(seed)
    return [{"rgb": (rng.rand(32, 48, 3) * 255).astype(np.float32),
             "depth": rng.rand(32, 48, 1).astype(np.float32)}
            for _ in range(n)]


def _batch(frames):
    return {k: np.stack([f[k] for f in frames]) for k in frames[0]}


def test_a_second_forward_reads_every_weight_from_the_cache(monkeypatch):
    """A fusion's first forward fills the cache; its second misses nothing
    and reads the weight of every float-path conv (each ``F.conv2d``
    call) from it."""
    net = _fusion()
    batch = net._batch_to_device(_batch(_frames(1)))
    _, first = _counted(lambda: net._forward(batch))
    assert first["layers.kernel_cache_miss"] > 0
    convs = []
    real = F.conv2d
    monkeypatch.setattr(F, "conv2d",
                        lambda *a, **kw: convs.append(1) or real(*a, **kw))
    _, second = _counted(lambda: net._forward(batch))
    assert len(convs) == 2 * EXPERT_CONVS
    assert second.get("layers.kernel_cache_miss", 0) == 0
    assert second["layers.weight_cached"] == len(convs)
    assert "layers.weight_per_call" not in second


@pytest.mark.parametrize("replace", ["negated", "clone", "written",
                                     "dtype"])
def test_a_replaced_kernel_misses_and_its_values_are_used(replace):
    """A kernel that is another tensor object (new values, or the same
    values in a copy), the same object written in place, or the same
    kernel at another compute dtype, misses once; the conv then gives the
    per-call weight's bits for it."""
    kernel = _kernel(3, 4, 8)
    x = _input((1, 6, 5, 4))
    cache = KernelCache()

    def conv(kernel, dtype):
        return layers.conv2d(Ctx({"conv/kernel": kernel},
                                 compute_dtype=dtype, kernel_cache=cache),
                             x, 8, 3, "conv", activation=None,
                             use_bias=False)

    with torch.no_grad():
        first = conv(kernel, torch.bfloat16)
        dtype = torch.float32 if replace == "dtype" else torch.bfloat16
        new = {"negated": lambda: -kernel, "clone": kernel.clone,
               "written": kernel.neg_, "dtype": lambda: kernel}[replace]()
        got, counters = _counted(lambda: conv(new, dtype))
        _, again = _counted(lambda: conv(new, dtype))
    assert counters["layers.kernel_cache_miss"] == 1
    assert again.get("layers.kernel_cache_miss", 0) == 0
    with torch.enable_grad():
        want = conv(_leaf(new), dtype)
    assert torch.equal(_bits(got), _bits(want))
    if replace in ("negated", "written"):
        assert not torch.equal(_bits(got), _bits(first))


def test_a_version_moves_with_an_in_place_write():
    """``KernelCache.version`` moves with an in-place write, and is None
    for an inference tensor, which keeps no version counter: a conv with
    such a kernel reads the cache all the same."""
    kernel = _kernel(3, 4, 8)
    before = KernelCache.version(kernel)
    kernel.add_(1.0)
    assert KernelCache.version(kernel) == before + 1
    with torch.inference_mode():
        frozen = _kernel(3, 4, 8).clone()
        frozen.add_(1.0)
    assert KernelCache.version(frozen) is None
    x = _input((1, 6, 5, 4))
    cache = KernelCache()
    with torch.inference_mode():
        for _ in range(2):
            got, counters = _counted(lambda: layers.conv2d(
                Ctx({"conv/kernel": frozen}, compute_dtype=torch.bfloat16,
                    kernel_cache=cache), x, 8, 3, "conv", activation=None,
                use_bias=False))
    assert counters.get("layers.kernel_cache_miss", 0) == 0
    assert counters["layers.weight_cached"] == 1


def test_frozen_deconv_reads_its_diagonal_from_the_cache():
    """A frozen channel-diagonal deconv reads its bf16 diagonal from the
    cache from the second call on, with the per-call diagonal's bits."""
    gen = torch.Generator().manual_seed(3)
    c = 6
    kernel = torch.zeros(4, 4, c, c)
    idx = torch.arange(c)
    kernel[:, :, idx, idx] = torch.rand(4, 4, c, generator=gen)
    x = _input((1, 5, 7, c))
    cache = KernelCache()

    def deconv(x, kernel):
        return layers.deconv2d(
            Ctx({"up/kernel": kernel}, compute_dtype=torch.bfloat16,
                kernel_cache=cache), x, c, 4, "up", strides=2,
            batch_normalization=False)

    with torch.no_grad():
        deconv(x, kernel)
        got, counters = _counted(lambda: deconv(x, kernel))
    assert counters.get("layers.kernel_cache_miss", 0) == 0
    diag = cache.diagonal_weight("up/kernel", kernel, torch.bfloat16, x)
    assert torch.equal(_bits(diag),
                       _bits(kernel[:, :, idx, idx].to(torch.bfloat16)))
    with torch.enable_grad():
        # x records, so the deconv gathers and casts its diagonal per call
        want = deconv(_leaf(x), kernel)
    assert torch.equal(_bits(got), _bits(want))


def test_a_train_step_casts_every_weight_per_call():
    """``fit`` makes new trainable leaves every step: no conv reads the
    cache, each casts and permutes its kernel per call."""
    description = ({"labels": np.int32, "rgb": np.float32},
                   {"rgb": (None, None, 3), "labels": (None, None)},
                   NUM_CLASSES)
    net = get_model("simple_fcn")(
        prefix="rgb", modality="rgb", data_description=description,
        num_units=4, channel_factor=0.125, batchsize=2, loader_workers=1,
        compute_dtype="bfloat16", device="cpu")
    rng = np.random.RandomState(2)
    data = {"rgb": (rng.rand(4, 32, 32, 3) * 255).astype(np.float32),
            "labels": rng.randint(0, NUM_CLASSES, (4, 32, 32)).astype(
                np.int32)}
    _, counters = _counted(lambda: net.fit(data, 2))
    assert "layers.weight_cached" not in counters
    assert counters["layers.weight_per_call"] == 2 * EXPERT_CONVS


def _recorded_outputs(net, frames, attr):
    """Each frame's ``attr`` from a forward whose trainable variables are
    new leaves that require grad, under ``torch.enable_grad``: the
    per-call weights and PyTorch's epilogue chain at every conv."""
    trainable, frozen = split_trainable(net.variables, net.trainable)
    assert trainable
    leaves = {**frozen, **{k: _leaf(v) for k, v in trainable.items()}}
    outs = []
    with torch.enable_grad():
        for frame in frames:
            batch = net._batch_to_device(_batch([frame]))
            ctx = Ctx(leaves, compute_dtype=net.compute_dtype,
                      kernel_cache=KernelCache())
            outs.append(net._test_outputs(ctx, net._preprocess(batch))[attr]
                        .detach())
    return torch.cat(outs)


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_served_outputs_equal_a_forward_that_autograd_records(
        compute_dtype):
    """The fusion's served labels and both experts' probabilities, after a
    warm-up has filled the cache, equal bit for bit the same frames'
    forward with trainable leaves under ``torch.enable_grad``, which reads
    no weight from the cache."""
    net = _fusion(compute_dtype)
    frames = _frames(3, seed=4)
    for attr in ("prediction", "rgb_prob", "depth_prob"):
        server = InferenceServer(net, unroll=2, output_attr=attr)
        server.predict(frames[:1])
        (served, cached) = _counted(lambda: server.predict(frames))
        assert cached["layers.weight_cached"] == 2 * EXPERT_CONVS * 4
        assert cached.get("layers.kernel_cache_miss", 0) == 0
        want, counters = _counted(
            lambda: _recorded_outputs(net, frames, attr))
        assert "layers.weight_cached" not in counters
        assert counters["layers.weight_per_call"] == \
            2 * EXPERT_CONVS * len(frames)
        got = torch.from_numpy(np.asarray(served))
        assert torch.equal(_bits(got), _bits(want.to(got.dtype)))


def test_a_model_that_has_served_exports_and_keeps_serving(tmp_path):
    """A bf16 fusion whose cache holds its weights exports: the traced
    program reads nothing from the cache, its labels equal ``predict``,
    and the model serves on from the cache it had, as does a second
    export."""
    net = _fusion()
    frames = _frames(2, seed=6)
    batch = _batch(frames)
    served = InferenceServer(net, unroll=1).predict(frames)
    held = net._kernel_cache.held()
    art = export_serving(net, str(tmp_path / "first"), batch)
    assert [id(e[2]) for e in net._kernel_cache.held()] == \
        [id(e[2]) for e in held]
    want = net.predict(batch)
    np.testing.assert_array_equal(np.stack(served), want)
    np.testing.assert_array_equal(ExportedServing(art).predict(batch), want)
    again = export_serving(net, str(tmp_path / "second"), batch)
    np.testing.assert_array_equal(ExportedServing(again).predict(batch),
                                  want)
    _, counters = _counted(lambda: net._forward(net._batch_to_device(
        batch)))
    assert counters.get("layers.kernel_cache_miss", 0) == 0
    assert counters["layers.weight_cached"] == 2 * EXPERT_CONVS
