"""The served convolutions' epilogue on the CPU: the plain twin of
``ops/cuda/conv_epilogue.py`` against the chain of ``ops/layers.conv2d``
that it replaces (bit for bit), the wrapper's refusals, the rule by which
``conv2d`` keeps the chain (:func:`layers.epilogue_chain_reason`), the
grid the wrapper hands the kernel, and the counters
``layers.epilogue_fused`` and ``layers.epilogue_eager`` on a fused forward
and a train step. The rule's last condition is the CUDA card; tests that
follow a model through the kernel's branch here drop that condition alone,
so that the branch runs the plain twin. The kernel itself is held against
the chain on the card (``tests/test_torch_gpu.py``, marked ``gpu``).
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.ops import layers
from modular_semantic_segmentation_torch.ops.cuda import conv_epilogue
from modular_semantic_segmentation_torch.ops.variables import Ctx
from modular_semantic_segmentation_torch.utils import tracing

NUM_CLASSES = 6
DESCRIPTION = (
    {"labels": np.int32, "rgb": np.float32, "depth": np.float32},
    {"rgb": (None, None, 3), "depth": (None, None, 1),
     "labels": (None, None)}, NUM_CLASSES)
# convolutions with a bias in one SimpleFCN expert: conv1_1 .. conv5_3,
# score_conv4, score_conv5 and the decoder's score
BIAS_CONVS = 16
CARD = "not on a CUDA card"


@pytest.fixture(autouse=True)
def _fresh_tracer():
    tracing.reset()
    yield
    tracing.reset()


def _bits(t):
    return t.contiguous().view(torch.int16)


def _special_inputs(c, seed=0):
    """bf16 x [2, 5, 3, c] and float32 bias [c] with NaN, +-0, infinities,
    subnormal biases, sums that fall on a tie between two bf16 values, and
    random values of both signs."""
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(2, 5, 3, c, generator=gen) * 3).to(torch.bfloat16)
    bias = torch.randn(c, generator=gen) * 2
    flat = x.view(-1)
    flat[0], flat[1], flat[2] = float("nan"), -0.0, 0.0
    flat[3], flat[4] = float("inf"), -float("inf")
    # 1 + 2**-8 lies halfway between the bf16 values 1 and 1 + 2**-7:
    # x = 1 and bias 2**-8 (and 3 * 2**-8, the tie that rounds up) at the
    # channels of elements 5 and 6
    flat[5 * c: 6 * c] = 1.0
    bias[0] = 2.0 ** -8
    if c > 1:
        bias[1] = 3 * 2.0 ** -8
    if c > 2:
        bias[2] = -0.0
    if c > 3:
        bias[3] = -1e-45  # a float32 subnormal, -0 in bf16
    if c > 4:
        bias[4] = float("nan")
    flat[7 * c + min(2, c - 1)] = -0.0
    return x, bias


def _chain(x, bias, activation):
    """What ``conv2d`` runs without the kernel: the float32 sum, then
    ``_epilogue`` (the cast to the compute dtype and the activation)."""
    ctx = Ctx({}, compute_dtype=torch.bfloat16)
    return layers._epilogue(ctx, x + bias, "conv", activation, False)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("c", [14, 64, 3, 1])
def test_plain_twin_equals_the_chain(c, relu):
    """The plain twin, and the wrapper on CPU tensors (in place, x
    returned), give the chain's bits."""
    x, bias = _special_inputs(c)
    want = _chain(x, bias, torch.relu if relu else None)
    assert torch.equal(_bits(conv_epilogue.bias_act_plain(x, bias, relu)),
                       _bits(want))
    got = conv_epilogue.bias_act_(x, bias, relu)
    assert got is x and got.dtype == torch.bfloat16
    assert torch.equal(_bits(x), _bits(want))


def _refusal(case):
    x = torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16)
    bias = torch.zeros(8)
    if case == "float32 x":
        x = x.float()
    elif case == "bf16 bias":
        bias = bias.to(torch.bfloat16)
    elif case == "bias of other width":
        bias = torch.zeros(9)
    elif case == "bias of two dims":
        bias = torch.zeros(1, 8)
    elif case == "non-contiguous x":
        x = torch.zeros(1, 8, 4, 4, dtype=torch.bfloat16).permute(0, 2, 3, 1)
    elif case == "non-contiguous bias":
        bias = torch.zeros(16)[::2]
    elif case == "meta x":
        x, bias = x.to("meta"), bias.to("meta")
    elif case == "bias on another device":
        bias = bias.to("meta")
    return x, bias


@pytest.mark.parametrize("case", [
    "float32 x", "bf16 bias", "bias of other width", "bias of two dims",
    "non-contiguous x", "non-contiguous bias", "meta x",
    "bias on another device"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError):
        conv_epilogue.bias_act_(*_refusal(case), True)


def _rule_case(case):
    """(out, bias, compute dtype, activation, batch norm) of a conv that
    meets every condition of the rule but the card and ``case``'s."""
    out = torch.zeros(1, 4, 6, 8, dtype=torch.bfloat16)
    bias = torch.zeros(8)
    dtype, activation, bn = torch.bfloat16, torch.relu, False
    if case == "float32 compute":
        out, dtype = out.float(), torch.float32
    elif case == "bf16 bias":
        bias = bias.to(torch.bfloat16)
    elif case == "batch norm":
        bn = True
    elif case == "sigmoid":
        activation = torch.sigmoid
    elif case == "functional relu":
        activation = torch.nn.functional.relu
    elif case == "bias requires grad":
        bias.requires_grad_()
    elif case == "output requires grad":
        out.requires_grad_()
    elif case == "non-contiguous output":
        out = torch.zeros(1, 8, 4, 6, dtype=torch.bfloat16).permute(
            0, 2, 3, 1)
    elif case == "no activation":
        activation = None
    return out, bias, dtype, activation, bn


@pytest.mark.parametrize("case,reason", [
    ("cpu", CARD), ("no activation", CARD),
    ("float32 compute", "bf16"), ("bf16 bias", "float32 bias"),
    ("batch norm", "batch norm"), ("sigmoid", "activation"),
    ("functional relu", "activation"),
    ("bias requires grad", "autograd"), ("output requires grad", "autograd"),
    ("non-contiguous output", "non-contiguous")])
def test_rule_keeps_the_chain(case, reason):
    got = layers.epilogue_chain_reason(*_rule_case(case))
    assert got is not None and reason in got, got


def test_rule_lets_no_grad_take_the_kernel_on_the_card():
    """A bias that requires a gradient is no reason under ``no_grad``:
    autograd records nothing, and only the card is missing."""
    out, bias, dtype, activation, bn = _rule_case("bias requires grad")
    with torch.no_grad():
        assert layers.epilogue_chain_reason(out, bias, dtype, activation,
                                            bn) == CARD


def test_rule_keeps_the_chain_in_a_program_that_export_traces():
    reasons = []

    class Epilogue(torch.nn.Module):
        def forward(self, out, bias):
            reasons.append(layers.epilogue_chain_reason(
                out, bias, torch.bfloat16, torch.relu, False))
            return torch.relu((out + bias).to(torch.bfloat16))

    torch.export.export(Epilogue(), (torch.zeros(1, 2, 3, 8,
                                                 dtype=torch.bfloat16),
                                     torch.zeros(8)))
    assert reasons and all("traced" in r for r in reasons)


@pytest.fixture
def card_free_rule(monkeypatch):
    """The rule without its last condition, the card: the kernel's branch
    runs the plain twin on CPU tensors."""
    real = layers.epilogue_chain_reason

    def rule(*args):
        reason = real(*args)
        return None if reason == CARD else reason

    monkeypatch.setattr(layers, "epilogue_chain_reason", rule)


def _conv_variables(cin, cout, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"conv/kernel": torch.randn(3, 3, cin, cout, generator=gen) * 0.3,
            "conv/bias": torch.randn(cout, generator=gen)}


@pytest.mark.parametrize("activation", [torch.relu, None])
@pytest.mark.parametrize("cout", [16, 14])
def test_conv2d_through_the_kernels_branch_equals_the_chain(
        monkeypatch, activation, cout):
    """A bf16 conv2d whose epilogue takes the kernel's branch (the plain
    twin, in place over the conv's output) gives the chain's bits and
    counts ``layers.epilogue_fused``; the chain counts
    ``layers.epilogue_eager``."""
    variables = _conv_variables(5, cout)
    x = torch.randn(2, 7, 9, 5, generator=torch.Generator().manual_seed(1))
    outs = {}
    for branch in ("chain", "kernel"):
        if branch == "kernel":
            real = layers.epilogue_chain_reason
            monkeypatch.setattr(
                layers, "epilogue_chain_reason",
                lambda *a: None if real(*a) == CARD else real(*a))
        tracing.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            outs[branch] = layers.conv2d(
                Ctx(variables, compute_dtype=torch.bfloat16), x, cout, 3,
                "conv", activation=activation)
        counters = tracing.snapshot()["counters"]
        fused = branch == "kernel"
        assert counters.get("layers.epilogue_fused", 0) == int(fused)
        assert counters.get("layers.epilogue_eager", 0) == int(not fused)
    assert outs["kernel"].dtype == torch.bfloat16
    assert torch.equal(_bits(outs["kernel"]), _bits(outs["chain"]))


def test_conv2d_without_a_bias_counts_neither(card_free_rule):
    variables = {"conv/kernel": _conv_variables(3, 8)["conv/kernel"]}
    with profile(activities=[ProfilerActivity.CPU]):
        layers.conv2d(Ctx(variables, compute_dtype=torch.bfloat16),
                      torch.randn(1, 4, 4, 3), 8, 3, "conv", use_bias=False)
    counters = tracing.snapshot()["counters"]
    assert "layers.epilogue_fused" not in counters
    assert "layers.epilogue_eager" not in counters


def _fusion(compute_dtype="bfloat16"):
    rng = np.random.RandomState(0)
    cms = {m: rng.rand(NUM_CLASSES, NUM_CLASSES)
           + np.eye(NUM_CLASSES) * 5 for m in ("rgb", "depth")}
    return get_model("bayes_mix")(
        data_description=DESCRIPTION, confusion_matrices=cms, device="cpu",
        num_units=4, channel_factor=0.125, expert_model="fcn",
        prefixes={"rgb": "rgb", "depth": "depth"},
        compute_dtype=compute_dtype)


def _batch(n, seed=1):
    rng = np.random.RandomState(seed)
    return {"rgb": (rng.rand(n, 32, 48, 3) * 255).astype(np.float32),
            "depth": rng.rand(n, 32, 48, 1).astype(np.float32)}


def _counted_forward(net, batch, attr="prediction"):
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = net._forward(net._batch_to_device(batch))[attr]
    counters = tracing.snapshot()["counters"]
    return out, (counters.get("layers.epilogue_fused", 0),
                 counters.get("layers.epilogue_eager", 0))


@pytest.mark.parametrize("frames", [1, 3])
def test_fused_forward_takes_the_kernel_at_every_bias_conv(monkeypatch,
                                                           frames):
    """A bf16 Bayes fusion of two SimpleFCN experts: every one of the 16
    bias convolutions of each expert takes the kernel's branch once a
    forward, whatever the batch, and the labels and both experts'
    probabilities are the chain's, bit for bit."""
    net = _fusion()
    batch = _batch(frames)
    want = {attr: _counted_forward(net, batch, attr)
            for attr in ("prediction", "rgb_prob", "depth_prob")}
    real = layers.epilogue_chain_reason
    monkeypatch.setattr(layers, "epilogue_chain_reason",
                        lambda *a: None if real(*a) == CARD else real(*a))
    for attr, (chain_out, chain_counts) in want.items():
        assert chain_counts == (0, 2 * BIAS_CONVS)
        out, counts = _counted_forward(net, batch, attr)
        assert counts == (2 * BIAS_CONVS, 0)
        assert torch.equal(out, chain_out) if out.dtype != torch.bfloat16 \
            else torch.equal(_bits(out), _bits(chain_out))


def test_float32_forward_keeps_the_chain(card_free_rule):
    _, counts = _counted_forward(_fusion("float32"), _batch(1))
    assert counts == (0, 2 * BIAS_CONVS)


def test_train_step_keeps_the_chain(card_free_rule):
    """A bf16 train step records its convs for autograd, with batch norm
    between bias and activation: none takes the kernel."""
    description = ({"labels": np.int32, "rgb": np.float32},
                   {"rgb": (None, None, 3), "labels": (None, None)},
                   NUM_CLASSES)
    net = get_model("simple_fcn")(
        prefix="rgb", modality="rgb", data_description=description,
        num_units=4, channel_factor=0.125, batchsize=2, loader_workers=1,
        compute_dtype="bfloat16", device="cpu")
    rng = np.random.RandomState(2)
    data = {"rgb": (rng.rand(4, 32, 48, 3) * 255).astype(np.float32),
            "labels": rng.randint(0, NUM_CLASSES, (4, 32, 48)).astype(
                np.int32)}
    with profile(activities=[ProfilerActivity.CPU]):
        net.fit(data, 2)
    counters = tracing.snapshot()["counters"]
    assert counters.get("layers.epilogue_fused", 0) == 0
    assert counters["layers.epilogue_eager"] == 2 * BIAS_CONVS


@pytest.mark.parametrize("vec", [8, 1])
@pytest.mark.parametrize("channels", [64, 128, 512, 14, 7, 24, 3, 1001])
@pytest.mark.parametrize("vectors", [1, 5000, 73728, 2359296])
def test_grid_keeps_each_value_on_one_channel(vectors, channels, vec):
    """The grid's stride in values is a multiple of C, so each value a
    thread moves keeps its channel at every step; at most BLOCKS_PER_SM
    blocks an SM unless that multiple needs more, and no more blocks than
    the work (rounded to that multiple) fills."""
    sm_count = 132
    blocks = conv_epilogue.grid_blocks(vectors, channels, vec, sm_count)
    threads = blocks * conv_epilogue.THREADS
    assert blocks >= 1 and threads * vec % channels == 0
    step = channels // np.gcd(channels, conv_epilogue.THREADS * vec)
    assert blocks <= max(step, -(-conv_epilogue.BLOCKS_PER_SM * sm_count
                                 // step) * step)
    needed = -(-vectors // (conv_epilogue.THREADS * 2))
    assert blocks < max(needed, 1) + step


@pytest.mark.parametrize("numel,offset,width", [
    (8 * 1000, 0, 8), (14 * 768, 0, 8), (7 * 9, 0, 1), (64, 2, 1),
    (64, 16, 8), (64, 8, 1)])
def test_vector_width(numel, offset, width):
    """16-byte vectors where the count allows and the pointer is 16-byte
    aligned, whatever C (a vector may span two pixels)."""
    assert conv_epilogue.vector_width(numel, 256 + offset) == width
