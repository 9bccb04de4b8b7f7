"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked ``gpu``: without a card each test skips. This file imports neither
JAX nor the JAX package, so it also runs where JAX is not installed:

    CUDA_VISIBLE_DEVICES=0 python -m pytest --noconftest -m gpu \
        tests/test_torch_gpu.py

(``tests/conftest.py`` imports JAX and hides CUDA devices from the CPU
suite; ``--noconftest`` skips it.) Confusion counts must be exact;
Dirichlet labels may differ from the plain version only where the plain
scores of the two labels are within 1e-5 relative (argmax ties); the stem
conv, bfloat16 out, within 1e-2 of the largest plain value; the Dirichlet
sufficient statistics on the card within rtol 1e-4 of the CPU's (float32
sums in another order); the int8 product of the int8 serving path exact
(int32) against its plain version, and an int8 model's labels on the
card equal to the CPU's.
"""

import numpy as np
import pytest
import torch

from modular_semantic_segmentation_torch.ops.cuda import build
from modular_semantic_segmentation_torch.ops.cuda import confusion
from modular_semantic_segmentation_torch.ops.cuda import dirichlet
from modular_semantic_segmentation_torch.ops.cuda import stem_conv
from modular_semantic_segmentation_torch.ops import int8_conv
from modular_semantic_segmentation_torch.ops.variables import Ctx


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    build.build()
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("k,shape", [(14, (2, 96, 48)), (3, (1, 1000)),
                                     (40, (5, 333))])
def test_confusion_kernel_matches_plain(cuda, k, shape):
    gen = torch.Generator(device=cuda).manual_seed(k)
    preds = torch.randint(-1, k + 2, shape, generator=gen, device=cuda)
    labels = torch.randint(-2, k + 3, shape, generator=gen, device=cuda,
                           dtype=torch.int32)
    before = confusion.KERNEL.launches
    got = confusion.confusion_matrix(preds, labels, k)
    torch.cuda.synchronize()
    assert confusion.KERNEL.launches == before + 1
    assert torch.equal(got.cpu(), confusion.confusion_matrix_plain(
        preds.cpu(), labels.cpu(), k))


def _confusion_pairs(kind, n, k, device):
    """(predictions, labels), int32: 'uniform' pairs with values outside
    [0, K); 'runs', labels in runs of 1..400 pixels of one class (some
    -1) and predictions equal to them except for 1 in 10; 'one_bin',
    every pixel label 3 and prediction 3."""
    gen = torch.Generator().manual_seed(n + k)
    if kind == "uniform":
        preds = torch.randint(-1, k + 2, (n,), generator=gen)
        labels = torch.randint(-2, k + 3, (n,), generator=gen)
    elif kind == "runs":
        lengths = torch.randint(1, 401, (n,), generator=gen)
        classes = torch.randint(-1, k, (n,), generator=gen)
        labels = torch.repeat_interleave(classes, lengths)[:n]
        noise = torch.randint(0, k, (n,), generator=gen)
        flip = torch.rand((n,), generator=gen) < 0.1
        preds = torch.where(flip, noise, labels.clamp_min(0))
    else:
        preds = torch.full((n,), 3)
        labels = torch.full((n,), 3)
    return (preds.to(device, torch.int32), labels.to(device, torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["aligned", "offset", "misaligned"])
@pytest.mark.parametrize("n", [294913, 1003])
@pytest.mark.parametrize("kind", ["uniform", "runs", "one_bin"])
def test_confusion_entry_points_match_plain(cuda, kind, n, layout):
    """Both entry points exact on the three distributions, with n % 4 != 0
    and with pointers offset by one element: both ('offset', the scalar
    head then 16-byte loads) or only the predictions ('misaligned', all
    scalar). The accumulator adds to what it holds."""
    k = 14
    preds, labels = _confusion_pairs(kind, n + 1, k, cuda)
    if layout == "offset":
        preds, labels = preds[1:], labels[1:]
    elif layout == "misaligned":
        preds, labels = preds[1:], labels[:-1]
    else:
        preds, labels = preds[:-1], labels[:-1]
    want = confusion.confusion_counts_plain(preds.cpu(), labels.cpu(), k)
    assert torch.equal(want.float(), confusion.confusion_matrix_plain(
        preds.cpu(), labels.cpu(), k))
    before = confusion.KERNEL.launches
    got = confusion.confusion_matrix(preds, labels, k)
    start = torch.arange(k * k, device=cuda).reshape(k, k)
    total = confusion.confusion_accumulate(preds, labels, k, start.clone())
    torch.cuda.synchronize()
    assert confusion.KERNEL.launches == before + 2
    assert torch.equal(got.cpu(), want.float())
    assert total.dtype == torch.int64
    assert torch.equal((total - start).cpu(), want)


@pytest.mark.gpu
def test_confusion_accumulate_counts_past_32_bits(cuda):
    """The 64-bit accumulator carries counts above 2**32 exactly."""
    k = 14
    preds, labels = _confusion_pairs("one_bin", 1 << 20, k, cuda)
    total = torch.zeros((k, k), dtype=torch.int64, device=cuda)
    total[3, 3] = (1 << 32) - 5
    confusion.confusion_accumulate(preds, labels, k, total)
    torch.cuda.synchronize()
    assert int(total[3, 3]) == (1 << 32) - 5 + (1 << 20)
    assert int(total.sum()) == int(total[3, 3])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("experts,k,pixels", [(2, 14, 5000), (3, 20, 777)])
def test_dirichlet_kernel_matches_plain(cuda, dtype, experts, k, pixels):
    rng = np.random.RandomState(k)
    probs = np.stack([rng.dirichlet(np.ones(k), size=pixels)
                      for _ in range(experts)]).astype(np.float32)
    alphas = [rng.rand(k, k) * 4 + 0.5 for _ in range(experts)]
    coeffs, bias = dirichlet.dirichlet_tables(
        alphas, rng.dirichlet(np.ones(k)), 0.7, k)
    stacked = torch.from_numpy(probs).to(cuda, dtype)
    coeffs = torch.from_numpy(coeffs).to(cuda)
    bias = torch.from_numpy(bias).to(cuda)
    before = dirichlet.KERNEL.launches
    got = dirichlet.dirichlet_label(stacked, coeffs, bias)
    torch.cuda.synchronize()
    assert dirichlet.KERNEL.launches == before + 1
    scores = dirichlet.dirichlet_scores_plain(stacked, coeffs, bias)
    best = scores.max(dim=-1).values
    picked = scores.gather(1, got.long()[:, None])[:, 0]
    assert bool(((best - picked) <= 1e-5 * best.abs()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("experts,k,pixels", [(2, 14, 5000), (3, 14, 777),
                                              (2, 20, 1234), (3, 20, 300)])
def test_dirichlet_kernel_reads_experts_in_place(cuda, dtype, experts, k,
                                                 pixels):
    """Each expert's probabilities in its own tensor, as the model passes
    them; P is not a multiple of the kernel's 256-pixel slab. Labels may
    differ from the plain version's only at ties within 1e-5 relative,
    the rule of chip_smoke.check_dirichlet."""
    rng = np.random.RandomState(k + experts)
    probs = [torch.from_numpy(rng.dirichlet(np.ones(k), size=pixels).astype(
        np.float32)).to(cuda, dtype) for _ in range(experts)]
    alphas = [rng.rand(k, k) * 4 + 0.5 for _ in range(experts)]
    coeffs, bias = dirichlet.dirichlet_tables(
        alphas, rng.dirichlet(np.ones(k)), 0.7, k)
    coeffs = torch.from_numpy(coeffs).to(cuda)
    bias = torch.from_numpy(bias).to(cuda)
    before = dirichlet.KERNEL.launches
    got = dirichlet.dirichlet_label(probs, coeffs, bias)
    torch.cuda.synchronize()
    assert dirichlet.KERNEL.launches == before + 1
    assert got.dtype == torch.int32 and tuple(got.shape) == (pixels,)
    stacked = torch.stack(probs)
    scores = dirichlet.dirichlet_scores_plain(stacked, coeffs, bias)
    want = dirichlet.dirichlet_label_plain(stacked, coeffs, bias)
    best = scores.max(dim=-1).values
    picked = scores.gather(1, got.long()[:, None])[:, 0]
    differ = got != want
    rel = (best - picked) / best.abs().clamp_min(1e-30)
    assert bool((rel[differ] <= 1e-5).all())
    assert int(differ.sum()) <= pixels // 100


@pytest.mark.gpu
@pytest.mark.parametrize("batch,height,width,cin,cout",
                         [(1, 768, 384, 64, 64), (2, 37, 53, 16, 24),
                          (1, 9, 130, 128, 136), (1, 384, 192, 64, 128),
                          (1, 384, 192, 128, 128), (1, 21, 100, 32, 24),
                          (3, 6, 70, 48, 8)])
def test_stem_conv_kernel_matches_plain(cuda, batch, height, width, cin,
                                        cout):
    before = stem_conv.KERNEL.launches
    out = stem_conv.probe(height, width, cin, cout, batch=batch,
                          timings=False)
    torch.cuda.synchronize()
    assert stem_conv.KERNEL.launches == before + 1
    assert out["max_abs_err"] <= 1e-2 * out["scale"]


@pytest.mark.gpu
@pytest.mark.parametrize("cin,error,match", [
    (8, ValueError, "multiple of 16"),
    (144, RuntimeError, "failed to launch")])
def test_stem_conv_raises_on_unsupported_cin(cuda, cin, error, match):
    """Cin 8 fails the wrapper's check; Cin 144 passes it, but its weights
    do not fit a block's shared memory and the launcher refuses it. A
    launch after the refusal still succeeds."""
    x = torch.zeros((1, 8, 8, cin), dtype=torch.bfloat16, device=cuda)
    kernel = torch.zeros((3, 3, cin, 16), dtype=torch.bfloat16, device=cuda)
    bias = torch.zeros(16, device=cuda)
    with pytest.raises(error, match=match):
        stem_conv.stem_conv_nhwc(x, kernel, bias)
    out = stem_conv.probe(8, 24, 16, 8, device=cuda, timings=False)
    assert out["max_abs_err"] <= 1e-2 * out["scale"]


@pytest.mark.gpu
def test_trace_writes_a_chrome_trace_with_the_kernel(cuda, tmp_path):
    from modular_semantic_segmentation_torch.utils.profiling import trace
    x = torch.randn((1, 16, 32, 16), device=cuda, dtype=torch.bfloat16)
    kernel = torch.randn((3, 3, 16, 8), device=cuda, dtype=torch.bfloat16)
    with trace(str(tmp_path)) as prof:
        stem_conv.stem_conv_nhwc(x, kernel, torch.zeros(8, device=cuda))
    assert any("stem_conv_kernel" in e.key for e in prof.key_averages())
    with open(tmp_path / "trace.json") as f:
        assert "stem_conv_kernel" in f.read()


@pytest.mark.gpu
def test_trace_writes_the_spans_of_served_frames(cuda, tmp_path):
    """``trace`` writes ``spans.json`` beside ``trace.json``: the served
    groups' spans with their stream time, the counters and the records;
    the Chrome trace holds the spans as ``mss.*`` ranges. The Bayes
    fusion's groups replay a graph captured before the trace, so they run
    none of the forward's spans; the plain Dirichlet fusion is served
    eagerly in the same trace, and its forward's spans nest inside its
    ``serve.launch`` spans, by parent and on the stream."""
    import json
    from modular_semantic_segmentation_torch.serving import InferenceServer
    from modular_semantic_segmentation_torch.utils import tracing
    from modular_semantic_segmentation_torch.utils.profiling import trace
    rng = np.random.RandomState(1)
    cms = {m: rng.rand(6, 6) + np.eye(6) * 5 for m in ("rgb", "depth")}
    params = {m: rng.rand(6, 6) * 4 + 0.5 for m in ("rgb", "depth")}
    params["class_counts"] = rng.randint(100, 1000, 6)
    net = _small_fusion("bayes_mix", cuda, confusion_matrices=cms,
                        compute_dtype="bfloat16")
    data = _frames()
    frames = [{"rgb": data["rgb"][i], "depth": data["depth"][i]}
              for i in range(3)]
    server = InferenceServer(net, unroll=2)
    server.predict(frames)
    eager = InferenceServer(_small_fusion("dirichlet_mix", cuda,
                                          dirichlet_params=params), unroll=2)
    eager.predict(frames)
    with trace(str(tmp_path)):
        served = server.predict(frames)
        torch.cuda.synchronize()
        replayed = tracing.snapshot()["spans"]
        eager_served = eager.predict(frames)
    assert served.shape == eager_served.shape == (3, 64, 96)
    assert not any(name.startswith("fusion.") for name in replayed)
    with open(tmp_path / "spans.json") as f:
        spans = json.load(f)
    assert spans["counters"]["serve.frames"] == 2 * 3
    assert spans["counters"]["serve.frames_read"] == 2 * 3
    assert spans["counters"]["serve.padded_frames"] == 2 * 1
    assert spans["counters"]["serve.readback_bytes"] == 2 * 3 * 64 * 96 * 4
    assert spans["counters"]["serve.graph_replays"] == 2
    assert spans["counters"]["serve.eager_groups"] == 2
    assert "serve.graph_captures" not in spans["counters"]
    assert spans["counters"].get("layers.kernel_cache_miss", 0) == 0
    for name in ("serve.launch", "fusion.expert.rgb", "fusion.expert.depth",
                 "fusion.epilogue"):
        assert spans["spans"][name]["stream_s"] > 0, name
    assert spans["spans"]["serve.upload"]["stream_s"] is None
    assert spans["spans"]["serve.launch"]["calls"] == 2 + 2
    # the eager server's forwards, one a frame of its two groups
    assert spans["spans"]["fusion.epilogue"]["calls"] == 2 * 2
    records = {r["id"]: r for r in spans["records"]}
    assert len(records) == sum(s["calls"] for s in spans["spans"].values())
    for record in records.values():
        if record["name"].startswith("fusion."):
            parent = records[record["parent"]]
            assert parent["name"] == "serve.launch", record
            assert parent["request"] == record["request"]
    experts = sum(spans["spans"][n]["stream_s"] for n in (
        "fusion.expert.rgb", "fusion.expert.depth", "fusion.epilogue"))
    eager_launches = (spans["spans"]["serve.launch"]["stream_s"]
                      - replayed["serve.launch"]["stream_s"])
    # nested inside the eager launches on one stream (events resolve
    # ~0.5 us)
    assert experts <= eager_launches + 1e-5
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"mss.serve.launch", "mss.serve.wait",
            "mss.fusion.epilogue"} <= names


@pytest.mark.gpu
def test_device_spans_fold_as_they_complete(cuda):
    """More stream spans than the tracer keeps pending: the completed
    ones are folded into the totals while the profiler records, their
    events reused, and every span's stream time is counted."""
    from torch.profiler import ProfilerActivity, profile
    from modular_semantic_segmentation_torch.utils import tracing
    tracer = tracing.Tracer()
    x = torch.ones((256, 256), device=cuda)
    n = 3 * tracing._FOLD_AT
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(n):
            with tracer.span("work", device=cuda):
                x = x * 1.0
            torch.cuda.synchronize()
        assert len(tracer._pending) <= tracing._FOLD_AT + 1
    snap = tracer.snapshot()
    assert snap["spans"]["work"]["calls"] == n
    assert snap["spans"]["work"]["stream_s"] > 0
    # every pair back in the pool, and no more made than were pending
    assert len(tracer._pool[torch.cuda.current_device()]) <= \
        tracing._FOLD_AT + 1


@pytest.mark.gpu
def test_dirichlet_statistics_on_the_card_match_the_cpu(cuda):
    from modular_semantic_segmentation_torch.ops import fusion_math as fm
    rng = np.random.RandomState(5)
    probs = torch.from_numpy(rng.dirichlet(
        np.ones(14), size=(2, 64, 96)).astype(np.float32))
    labels = torch.from_numpy(rng.randint(-1, 16, (2, 64, 96)).astype(
        np.int32))
    ss, counts = fm.dirichlet_sufficient_statistics(probs.to(cuda),
                                                    labels.to(cuda), 14)
    want_ss, want_counts = fm.dirichlet_sufficient_statistics(probs, labels,
                                                              14)
    np.testing.assert_allclose(ss.cpu().numpy(), want_ss.numpy(), rtol=1e-4)
    assert torch.equal(counts.cpu(), want_counts)


def _small_fusion(name, device, **config):
    from modular_semantic_segmentation_torch.models import get_model
    description = (
        {"labels": np.int32, "rgb": np.float32, "depth": np.float32},
        {"rgb": (None, None, 3), "depth": (None, None, 1),
         "labels": (None, None)}, 6)
    return get_model(name)(
        data_description=description, num_units=4, channel_factor=0.25,
        expert_model="fcn", prefixes={"rgb": "rgb", "depth": "depth"},
        device=device, **config)


def _frames(n=3):
    rng = np.random.RandomState(0)
    return {"rgb": (rng.rand(n, 64, 96, 3) * 255).astype(np.float32),
            "depth": rng.rand(n, 64, 96, 1).astype(np.float32),
            "labels": rng.randint(-1, 6, (n, 64, 96)).astype(np.int32)}


@pytest.fixture
def deterministic_cudnn():
    """cuDNN restricted to deterministic algorithms, so two forwards of
    the same frame give the same labels."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = saved


@pytest.mark.gpu
def test_score_and_serving_on_the_card(cuda, deterministic_cudnn):
    """The confusion kernel counts in ``score`` exactly what the plain
    version counts for the same forward; the server's pinned,
    event-ordered readback gives the model's own outputs, in order, with
    a padded tail group; the Dirichlet model launches its kernel."""
    from modular_semantic_segmentation_torch.serving import InferenceServer
    rng = np.random.RandomState(1)
    cms = {m: rng.rand(6, 6) + np.eye(6) * 5 for m in ("rgb", "depth")}
    params = {m: rng.rand(6, 6) * 4 + 0.5 for m in ("rgb", "depth")}
    params["class_counts"] = rng.randint(100, 1000, 6)
    data = _frames()
    for net in (_small_fusion("bayes_mix", cuda, confusion_matrices=cms,
                              compute_dtype="bfloat16"),
                _small_fusion("dirichlet_mix", cuda, dirichlet_params=params,
                              use_pallas=True)):
        before = (confusion.KERNEL.launches, dirichlet.KERNEL.launches)
        out = net._eval_step(net._batch_to_device(data))
        want = confusion.confusion_matrix_plain(
            out["prediction"].cpu(), torch.from_numpy(data["labels"]), 6)
        assert torch.equal(out["confusion_matrix"].cpu(), want)
        _, cm = net.score(data)
        assert cm.sum() == (data["labels"] >= 0).sum()
        predictions = net.predict(data)
        frames = [{"rgb": data["rgb"][i], "depth": data["depth"][i]}
                  for i in range(3)]
        served = InferenceServer(net, unroll=2).predict(frames)
        np.testing.assert_array_equal(served, predictions)
        assert confusion.KERNEL.launches - before[0] == 1 + 3
        if net.config.get("use_pallas"):
            # the eval step, score, predict, and the server's warm-up group
            # and captured group of two frames each (replays run no Python)
            assert dirichlet.KERNEL.launches - before[1] == 1 + 3 + 3 + 4


@pytest.mark.gpu
@pytest.mark.parametrize("name,config", [
    ("average", {}),
    ("variance", {"dropout_rate": 0.5, "num_samples": 3}),
    ("uncertainty_dirichlet_mix", {"dropout_rate": 0.2, "num_samples": 3}),
    ("bayesian_fcn", {"dropout_rate": 0.5, "num_samples": 3})])
def test_fusion_family_score_on_the_card(cuda, deterministic_cudnn, name,
                                         config):
    """Each model of the family scores through kernel A, one launch a
    batch, and its matrix equals the plain version's counts of the same
    predictions (the model's generator re-seeded before each pass, so
    both see the same dropout draws)."""
    if name == "bayesian_fcn":
        from modular_semantic_segmentation_torch.models import get_model
        net = get_model(name)(
            prefix="rgb", modality="rgb", num_units=4, channel_factor=0.25,
            data_description=(
                {"labels": np.int32, "rgb": np.float32},
                {"rgb": (None, None, 3), "labels": (None, None)}, 6),
            device=cuda, **config)
    else:
        if name == "uncertainty_dirichlet_mix":
            rng = np.random.RandomState(1)
            config = dict(config, dirichlet_params={
                "rgb": rng.rand(6, 6) * 4 + 0.5,
                "depth": rng.rand(6, 6) * 4 + 0.5,
                "class_counts": rng.randint(100, 1000, 6)})
        net = _small_fusion(name, cuda, **config)
    data = _frames()
    net._generator.manual_seed(11)
    before = confusion.KERNEL.launches
    _, got = net.score(data)
    assert confusion.KERNEL.launches - before == 3
    net._generator.manual_seed(11)
    predictions = torch.from_numpy(net.predict(data))
    want = confusion.confusion_matrix_plain(
        predictions, torch.from_numpy(data["labels"]), 6)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("shape,cout", [
    ((1, 96, 48, 512), 512),    # conv4_2 of the flagship expert
    ((1, 384, 192, 128), 128),  # conv2_2
    ((1, 48, 24, 512), 64)])    # score_conv5 (1x1 below)
def test_int8_product_matches_plain(cuda, shape, cout):
    """torch._int_mm on im2col patches at the flagship's shapes, exact
    against the plain int32 product of the same patches."""
    gen = torch.Generator(device=cuda).manual_seed(cout)
    kernel = 1 if cout == 64 else 3
    xq = torch.randint(-127, 128, shape, generator=gen, device=cuda,
                       dtype=torch.int8)
    kq_t = torch.randint(-127, 128, (cout, kernel * kernel * shape[-1]),
                         generator=gen, device=cuda, dtype=torch.int8)
    pad = kernel // 2
    pads = ((pad, pad), (pad, pad))
    before = int8_conv.INT_MM.launches
    got = int8_conv.int8_conv2d(xq, kq_t, (kernel, kernel), (1, 1), (1, 1),
                                pads)
    assert int8_conv.INT_MM.launches == before + 1
    patches, _ = int8_conv.im2col(xq, (kernel, kernel), (1, 1), (1, 1), pads)
    want = int8_conv.int8_matmul_plain(patches, kq_t)
    assert got.dtype == torch.int32
    assert torch.equal(got.reshape(want.shape), want)
    # im2col on the card equals its plain CPU run
    assert torch.equal(patches.cpu(), int8_conv.im2col(
        xq.cpu(), (kernel, kernel), (1, 1), (1, 1), pads)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(16, 576, 64), (4, 4608, 512),
                                   (64, 28, 64), (64, 576, 14)])
def test_int8_product_raises_on_shapes_int_mm_refuses(cuda, m, k, n):
    a = torch.ones((m, k), dtype=torch.int8, device=cuda)
    b_t = torch.ones((n, k), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="_int_mm needs"):
        int8_conv.int8_matmul(a, b_t)


@pytest.mark.gpu
def test_int8_serving_on_the_card_matches_the_cpu(cuda, deterministic_cudnn):
    """A Bayes model quantized on the card: the same scales as on the CPU
    (rtol 1e-5), its int8 scores through kernel A, and the int8 expert
    classifications equal to the CPU's except where the CPU's
    probabilities of the two classes are within 2**-5 relative."""
    from modular_semantic_segmentation_torch.models import get_model
    rng = np.random.RandomState(1)
    cms = {m: rng.rand(6, 6) + np.eye(6) * 5 for m in ("rgb", "depth")}
    data = _frames()
    # num_units 8: the score convs' n must be a multiple of 8 for _int_mm
    nets = {d: get_model("bayes_mix")(
        data_description=(
            {"labels": np.int32, "rgb": np.float32, "depth": np.float32},
            {"rgb": (None, None, 3), "depth": (None, None, 1),
             "labels": (None, None)}, 6),
        num_units=8, channel_factor=0.25, expert_model="fcn",
        prefixes={"rgb": "rgb", "depth": "depth"}, confusion_matrices=cms,
        device=d) for d in ("cpu", cuda)}
    nets[cuda].variables = {k: v.to(cuda)
                            for k, v in nets["cpu"].variables.items()}
    scales = {d: net.quantize_for_serving(data, num_batches=3,
                                          min_channels=16)
              for d, net in nets.items()}
    assert set(scales[cuda]) == set(scales["cpu"])
    assert any(k.startswith("packed:") for k in scales[cuda])
    for key, value in scales["cpu"].items():
        np.testing.assert_allclose(scales[cuda][key], value, rtol=1e-5)
    before = (confusion.KERNEL.launches, int8_conv.INT_MM.launches)
    nets[cuda].score(data)
    assert confusion.KERNEL.launches - before[0] == 3
    assert int8_conv.INT_MM.launches > before[1]
    for m in ("rgb", "depth"):
        attr = f"{m}_classification"
        got = nets[cuda].predict(data, output_attr=attr)
        want = nets["cpu"].predict(data, output_attr=attr)
        prob = nets["cpu"].predict(data, output_attr=f"{m}_prob")
        differ = got != want
        assert differ.mean() <= 0.02
        own = np.take_along_axis(prob[differ], want[differ][:, None], 1)
        other = np.take_along_axis(prob[differ], got[differ][:, None], 1)
        assert np.all(own - other <= 2.0 ** -5 * own)


@pytest.mark.gpu
def test_bf16_training_on_the_card(cuda):
    """Three bf16 train steps of a small SimpleFCN (``train_encoder``
    False) on the card: finite losses; the conv kernels and biases and the
    frozen deconv kernels unchanged bit for bit; BN's gamma and beta and
    its moving statistics moved."""
    from modular_semantic_segmentation_torch.models import get_model
    rng = np.random.RandomState(2)
    data = {"rgb": (rng.rand(4, 64, 32, 3) * 255).astype(np.float32),
            "labels": rng.randint(-1, 6, (4, 64, 32)).astype(np.int32)}
    net = get_model("simple_fcn")(
        prefix="rgb", modality="rgb",
        data_description=({"labels": np.int32, "rgb": np.float32},
                          {"rgb": (None, None, 3), "labels": (None, None)},
                          6),
        num_units=8, channel_factor=0.25, batchsize=2, learning_rate=0.01,
        train_encoder=False, compute_dtype="bfloat16", device=cuda)
    before = {k: v.clone() for k, v in net.variables.items()}
    losses = []
    step = net._train_step

    def recorded(*args):
        out = step(*args)
        losses.append(float(out[2]))
        return out
    net._train_step = recorded
    net.fit(data, 3, output=False)
    assert len(losses) == 3 and np.isfinite(losses).all()
    for k, v in net.variables.items():
        assert v.device.type == "cuda" and v.dtype == torch.float32
        moved = not torch.equal(v, before[k])
        assert moved == k.endswith(("gamma", "beta", "moving_mean",
                                    "moving_variance")), k


@pytest.mark.gpu
@pytest.mark.parametrize("k,s,cin,cout,shape", [
    (4, 2, 2048, 64, (1, 48, 24)), (16, 8, 64, 14, (1, 96, 48))])
def test_trainable_deconv_on_the_card_matches_the_cpu(cuda, k, s, cin, cout,
                                                      shape):
    """AdapNet's two trainable upconvs at 768x384 (``deconv2d``'s dense
    ``conv_transpose2d``, float32, TF32 off): output and both gradients
    within 1e-4 of the largest |value| of the CPU's. The kernel gradient
    sums 1,152 to 4,608 positions a weight, in cuDNN's order on the card
    (float32 worst case N * eps: 2.7e-4)."""
    from modular_semantic_segmentation_torch.ops import layers as ll
    ll.configure_float32()
    gen = torch.Generator().manual_seed(k)
    x = torch.randn(*shape, cin, generator=gen)
    kernel = torch.randn(k, k, cout, cin, generator=gen) * 0.05
    ct = torch.randn(shape[0], shape[1] * s, shape[2] * s, cout,
                     generator=gen)
    results = []
    for device in ("cpu", cuda):
        xd = x.to(device).requires_grad_()
        kd = kernel.to(device).requires_grad_()
        out = ll.deconv2d(Ctx({"d/kernel": kd}), xd, cout, k, "d",
                          strides=s, batch_normalization=False,
                          trainable=True)
        grads = torch.autograd.grad((out * ct.to(device)).sum(), (xd, kd))
        results.append([t.detach().cpu() for t in (out, *grads)])
    errors = [float((got - want).abs().max() / want.abs().max())
              for want, got in zip(*results)]
    assert max(errors) <= 1e-4, errors


@pytest.mark.gpu
def test_max_pool_routes_ties_on_the_card_like_the_cpu(cuda):
    """2x2/s2 max pool on channels-last NHWC (the layers' layout) with
    all-zero windows and tied maxima: the card's gradient goes to the
    same (first row-major) input as the CPU's."""
    from modular_semantic_segmentation_torch.ops import layers as ll
    gen = torch.Generator().manual_seed(3)
    x = torch.randint(0, 3, (2, 64, 96, 64), generator=gen).float() * 0.5
    x[0, :8, :8] = 0.0
    ct = torch.randn(2, 32, 48, 64, generator=gen)
    grads = []
    for device in ("cpu", cuda):
        xd = x.to(device).requires_grad_()
        out = ll.max_pool2d(None, xd, 2, 2)
        (grad,) = torch.autograd.grad((out * ct.to(device)).sum(), xd)
        grads.append(grad.cpu())
    assert torch.equal(grads[0], grads[1])


def _training_run(device, store, monkeypatch):
    """The port's training CLI, in-process, in the experiment store
    ``store``: SimpleFCN rgb (num_units 4, batch norm off) on 32x32
    UnittestData, 2 adam steps. Returns (record, summaries, weights)."""
    import json
    import os
    from modular_semantic_segmentation_torch import settings
    from modular_semantic_segmentation_torch.experiments import training
    from modular_semantic_segmentation_torch.utils.experiment import \
        ExperimentData
    monkeypatch.setattr(settings, "EXPERIMENT_STORAGE_FOLDER",
                        os.path.join(store, "experiments"))
    monkeypatch.setattr(settings, "EXP_OUT", os.path.join(store, "exp"))
    training.ex.run(config_updates={
        "modelname": "simple_fcn", "num_iterations": 2, "seed": 3,
        "starting_weights": False, "device": str(device),
        "dataset": {"name": "unittest", "height": 32, "width": 32,
                    "num_train": 6, "num_measure": 2, "num_test": 2},
        "net_config": {"prefix": "rgb", "modality": "rgb", "num_units": 4,
                       "batchsize": 2, "learning_rate": 1e-3,
                       "batch_normalization": False}})
    exp = ExperimentData(training.ex.current_run._id)
    with open(exp.get_artifact("summaries.jsonl")) as f:
        summaries = [json.loads(line) for line in f]
    with np.load(exp.get_weights()) as npz:
        weights = {k: npz[k] for k in npz.files}
    return exp.get_record(), summaries, weights


@pytest.mark.gpu
def test_training_cli_on_the_card_matches_the_cpu(cuda, tmp_path,
                                                  monkeypatch):
    """The training CLI on the card and on the CPU, from the same seed:
    both records complete with the same artifacts; the first step's loss
    within rtol 1e-5; adam's first steps move each weight by about the
    learning rate times the sign of its gradient, so the card's trained
    weights may part from the CPU's only where a gradient is near 0 and
    its sign flips: 99% of the entries within 1% of the learning rate,
    all within two steps; the test set's counts sum alike."""
    (card, card_sums, card_w), (cpu, cpu_sums, cpu_w) = (
        _training_run(device, str(tmp_path / str(device)), monkeypatch)
        for device in (cuda, "cpu"))
    for record in (card, cpu):
        assert record["status"] == "COMPLETED"
    names = [sorted(a["name"] for a in r["artifacts"]
                    if "events" not in a["name"]) for r in (card, cpu)]
    assert names[0] == names[1]
    np.testing.assert_allclose(card_sums[0]["loss"], cpu_sums[0]["loss"],
                               rtol=1e-5)
    assert sorted(card_w) == sorted(cpu_w)
    deltas = np.concatenate([np.abs(card_w[k] - cpu_w[k]).ravel()
                             for k in card_w])
    assert np.mean(deltas <= 1e-5) >= 0.99
    assert deltas.max() <= 2 * 2e-3
    cms = [np.asarray(r["info"]["measurements"]["confusion_matrix"])
           for r in (card, cpu)]
    assert cms[0].sum() == cms[1].sum()


@pytest.mark.gpu
def test_dirichlet_from_measurement_exp_serves_on_the_card(
        cuda, tmp_path, monkeypatch, deterministic_cudnn):
    """DirichletFusion(measurement_exp=..., use_pallas=True) loads its
    parameters from a run's counts.npz and serves on the card through
    kernel B; its labels equal the same model's on the CPU up to argmax
    ties of the CPU's scores (1e-5 relative)."""
    import json
    import os
    from modular_semantic_segmentation_torch import settings
    from modular_semantic_segmentation_torch.serving import InferenceServer
    store = tmp_path / "experiments"
    run_dir = store / "5"
    os.makedirs(run_dir)
    for name, content in (("run.json", {"_id": 5, "status": "COMPLETED",
                                        "artifacts": [{"name":
                                                       "counts.npz"}]}),
                          ("config.json", {}), ("info.json", {})):
        with open(run_dir / name, "w") as f:
            json.dump(content, f)
    rng = np.random.RandomState(4)
    params = {m: rng.rand(6, 6) * 4 + 0.5 for m in ("rgb", "depth")}
    params["class_counts"] = rng.randint(100, 1000, 6)
    np.savez(run_dir / "counts.npz", **params)
    monkeypatch.setattr(settings, "EXPERIMENT_STORAGE_FOLDER", str(store))
    nets = {device: _small_fusion("dirichlet_mix", device, measurement_exp=5,
                                  use_pallas=True)
            for device in (cuda, "cpu")}
    data = _frames()
    frames = [{"rgb": data["rgb"][i], "depth": data["depth"][i]}
              for i in range(3)]
    before = dirichlet.KERNEL.launches
    got = InferenceServer(nets[cuda], unroll=2).predict(frames)
    assert dirichlet.KERNEL.launches - before == 4
    cpu = nets["cpu"]
    want = cpu.predict(data)
    probs = torch.stack([torch.from_numpy(cpu.predict(
        data, output_attr=f"{m}_norm_prob")).reshape(-1, 6)
        for m in ("rgb", "depth")])
    coeffs, bias = cpu._kernel_tables(6)
    scores = dirichlet.dirichlet_scores_plain(probs, coeffs, bias)
    got_t = torch.from_numpy(got.reshape(-1)).long()
    gap = scores.max(-1).values - scores.gather(1, got_t[:, None])[:, 0]
    assert bool((gap <= 1e-5 * scores.max(-1).values.abs()).all())
    assert np.mean(got == want) >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("axis_aligned", [True, False])
def test_device_augment_warp_on_the_card_matches_cpu(cuda, axis_aligned):
    """The same maps warp on the card as on the CPU: nearest exact,
    bilinear uint8 exact except rounding ties (the CPU's float value
    within 1e-3 of a half-integer)."""
    from modular_semantic_segmentation_torch.ops import device_augment as da
    gen = torch.Generator().manual_seed(3)
    rgb = torch.randint(0, 256, (4, 40, 56, 3), generator=gen,
                        dtype=torch.uint8)
    labels = torch.randint(-1, 14, (4, 40, 56), generator=gen,
                           dtype=torch.int32)
    config = ({"crop": (1.0, 32), "scale": (1.0, 0.7, 1.5), "hflip": 0.5}
              if axis_aligned else
              {"crop": (1.0, 32), "rotate": (1.0, -10, 10),
               "shear": (1.0, 0.05, 0.1)})
    m = da.geometry_from_draws(da.draw_uniforms(gen, 4, da.GEOMETRY_DRAWS),
                               40, 56, 32, 32, **config)
    got = da._warp(labels.to(cuda), m.to(cuda), 32, 32, 0, axis_aligned)
    assert torch.equal(got.cpu(), da._warp(labels, m, 32, 32, 0,
                                           axis_aligned))
    got = da._warp(rgb.to(cuda), m.to(cuda), 32, 32, 1, axis_aligned).cpu()
    want = da._warp(rgb, m, 32, 32, 1, axis_aligned)
    exact = da._warp(rgb.float(), m, 32, 32, 1, axis_aligned)
    tie = ((exact - exact.floor()) - 0.5).abs() < 1e-3
    diff = (got.int() - want.int()).abs()
    assert int(diff.max()) <= 1 and not bool(diff[~tie].any())


@pytest.mark.gpu
def test_prefetcher_copies_to_the_card_and_reraises(cuda):
    from modular_semantic_segmentation_torch.utils.data_io import (
        prefetch_eval_batches, to_device_prefetched)

    def producer():
        for i in range(4):
            yield {"x": np.full((2, 3), i, np.float32)}
        raise KeyError("producer failed")

    seen = []
    with pytest.raises(KeyError, match="producer failed"):
        for batch in to_device_prefetched(producer(), cuda):
            assert batch["x"].is_cuda
            seen.append(float(batch["x"].sum()))
    assert seen == [0.0, 6.0, 12.0, 18.0]
    data = {"rgb": np.arange(5 * 6, dtype=np.float32).reshape(5, 6),
            "labels": np.arange(5, dtype=np.int32)}
    got = [(b["labels"].cpu().tolist(), valid)
           for b, valid in prefetch_eval_batches(data, 2, cuda)]
    assert got == [([0, 1], 2), ([2, 3], 2), ([4, -1], 1)]


@pytest.mark.gpu
def test_fit_with_device_augmentation_and_workers_on_the_card(cuda):
    """``fit`` with the loader's pool, the prefetcher and on-device
    augmentation on the card; its validation through kernel A."""
    from modular_semantic_segmentation_torch.datasets import get_dataset
    from modular_semantic_segmentation_torch.models import get_model
    data = get_dataset("unittest")(height=64, width=64, num_train=8)
    net = get_model("simple_fcn")(
        prefix="rgb", modality="rgb",
        data_description=data.get_data_description(), num_units=8,
        batchsize=2, loader_workers=3, device_augmentation={
            "crop": (1.0, 48), "scale": (0.5, 0.7, 1.5), "hflip": 0.5,
            "rotate": (0.5, -10, 10), "gamma": (0.5, 0.4, 1.4)})
    before = confusion.KERNEL.launches
    net.fit(data.get_trainset(), 4, output=False,
            validation_dataset=data.get_validation_set(),
            validation_interval=2)
    assert confusion.KERNEL.launches > before
    measures, _ = net.score(data.get_testset())
    assert np.isfinite(measures["total_accuracy"])


# kernel D, the frozen upsample: (dtype, [N, H, W, C], k, s)
UPSAMPLE_CASES = [
    # the flagship's two bf16 serving calls at 768x384
    (torch.bfloat16, (1, 48, 24, 64), 4, 2),
    (torch.bfloat16, (1, 96, 48, 64), 16, 8),
    # the training batch's two float32 calls: 4 frames of 368x640
    (torch.float32, (4, 23, 40, 64), 4, 2),
    (torch.float32, (4, 46, 80, 64), 16, 8),
    # ragged: C not a multiple of 8, k not a multiple of s, odd sizes,
    # more than two taps a dimension, k == s
    (torch.bfloat16, (2, 7, 13, 14), 3, 2),
    (torch.float32, (1, 5, 9, 1), 5, 2),
    (torch.bfloat16, (3, 6, 11, 12), 16, 8),
    (torch.float32, (2, 9, 4, 14), 9, 2),
    (torch.bfloat16, (1, 4, 5, 6), 2, 2),
    # float64, as the float64 reference steps on the card run it
    (torch.float64, (2, 12, 10, 4), 16, 8),
    (torch.float64, (1, 7, 9, 3), 4, 2),
]


def _bf16_error(got, want, magnitude, terms):
    """max |got - want| over what one bf16 rounding of the float32 result
    allows: a bf16 step of ``want``, plus the float32 sums' own rounding
    (``terms`` products, each to 2**-24 of the sum of |products|,
    ``magnitude``), by which two float32 orders of the same sum differ
    where it cancels."""
    step = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(
        torch.finfo(torch.bfloat16).tiny))) - 7)
    allowed = step + terms * 2.0 ** -24 * magnitude
    return float(((got.float() - want).abs() / allowed).max())


def _off_alignment(t, offset):
    """A copy of ``t`` that starts ``offset`` elements past an allocation's
    (256-byte aligned) start."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype,shape,k,s", UPSAMPLE_CASES)
def test_upsample_kernels_match_the_twins(cuda, dtype, shape, k, s, offset):
    """The forward and the adjoint kernel against the plain twins in
    float32 on the card, on the same (bf16-rounded) values: float32 within
    1e-5 of the largest value (FMAs, and another order of the adjoint's
    sums), bf16 within one bf16 rounding of the float32 result
    (:func:`_bf16_error`), float64 against the float64 twins within 1e-12.
    Offset 1: the input and the gradient start one element past a 16-byte
    boundary, so the wrapper narrows its vectors."""
    from modular_semantic_segmentation_torch.ops.cuda import upsample
    gen = torch.Generator(device=cuda).manual_seed(k * 100 + s)
    n, h, w, c = shape
    x = _off_alignment(torch.randn(shape, generator=gen, device=cuda).to(
        dtype), offset)
    g = _off_alignment(torch.randn((n, h * s, w * s, c), generator=gen,
                                   device=cuda).to(dtype), offset)
    diag = torch.randn((k, k, c), generator=gen, device=cuda).to(dtype)
    before = (upsample.KERNEL.launches, upsample.ADJOINT.launches)
    got = upsample.diagonal_upsample(x, diag, s)
    got_adj = upsample.diagonal_upsample_adjoint(g, diag, s)
    torch.cuda.synchronize()
    assert (upsample.KERNEL.launches, upsample.ADJOINT.launches) == (
        before[0] + 1, before[1] + 1)
    assert got.dtype == got_adj.dtype == dtype
    plain = upsample.diagonal_upsample_plain
    adjoint = upsample.diagonal_upsample_adjoint_plain
    taps = (-(-k // s)) ** 2
    wide = torch.float64 if dtype == torch.float64 else torch.float32
    for out, fn, src, terms in ((got, plain, x, taps),
                                (got_adj, adjoint, g, taps * s * s)):
        ref = fn(src.to(wide), diag.to(wide), s)
        if dtype == torch.bfloat16:
            magnitude = fn(src.float().abs(), diag.float().abs(), s)
            assert _bf16_error(out, ref, magnitude, terms) <= 1.0
        else:
            rtol = 1e-12 if dtype == torch.float64 else 1e-5
            assert float((out - ref).abs().max()) <= rtol * float(
                ref.abs().max())


@pytest.mark.gpu
def test_upsample_gradient_on_the_card_matches_the_cpu(cuda):
    """Autograd through ``diagonal_upsample`` launches the adjoint kernel,
    and its input gradient equals the CPU's (the plain twins)."""
    from modular_semantic_segmentation_torch.ops.cuda import upsample
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 23, 40, 16, generator=gen)
    diag = torch.randn(4, 4, 16, generator=gen)
    ct = torch.randn(2, 46, 80, 16, generator=gen)
    grads = []
    for device in ("cpu", cuda):
        xd = x.to(device).requires_grad_()
        before = upsample.ADJOINT.launches
        out = upsample.diagonal_upsample(xd, diag.to(device), 2)
        (grad,) = torch.autograd.grad((out * ct.to(device)).sum(), xd)
        grads.append(grad.cpu())
        assert upsample.ADJOINT.launches == before + (device == cuda)
    assert float((grads[1] - grads[0]).abs().max()) <= 1e-5 * float(
        grads[0].abs().max())


@pytest.mark.gpu
def test_served_frames_launch_the_upsample_four_times(cuda):
    """Each served frame of a two-expert fusion runs the forward kernel
    four times (two deconvs an expert), and no adjoint. The first group
    launches it from the wrapper, counted there and, while a profiler
    records, by ``upsample.forward``; the second is captured (the wrapper
    counts; the counter, off during a capture, does not); later groups
    replay the graph, which the profiler's device trace shows: one graph
    launch a group, four kernels a frame, no wrapper call."""
    from torch.profiler import ProfilerActivity, profile
    from modular_semantic_segmentation_torch.ops.cuda import upsample
    from modular_semantic_segmentation_torch.serving import InferenceServer
    from modular_semantic_segmentation_torch.utils import tracing
    rng = np.random.RandomState(1)
    cms = {m: rng.rand(6, 6) + np.eye(6) * 5 for m in ("rgb", "depth")}
    net = _small_fusion("bayes_mix", cuda, confusion_matrices=cms,
                        compute_dtype="bfloat16")
    data = _frames(4)
    frames = [{"rgb": data["rgb"][i], "depth": data["depth"][i]}
              for i in range(4)]
    server = InferenceServer(net, unroll=2)
    before = upsample.KERNEL.launches
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        server.predict(frames)
        torch.cuda.synchronize()
    counters = tracing.snapshot()["counters"]
    assert upsample.KERNEL.launches - before == 2 * 4 + 2 * 4
    assert counters["upsample.forward"] == 2 * 4
    assert "upsample.adjoint" not in counters
    before = upsample.KERNEL.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        server.predict(frames)
        torch.cuda.synchronize()
    assert upsample.KERNEL.launches == before
    events = prof.events()
    kernels = [e for e in events if "upsample_forward_kernel" in e.name
               and e.device_type == torch.autograd.DeviceType.CUDA]
    graphs = [e for e in events if "GraphLaunch" in e.name]
    assert len(kernels) == 4 * 4
    assert len(graphs) == 2
    assert not any("upsample_adjoint" in e.name for e in events)


@pytest.mark.gpu
def test_exported_program_reaches_the_upsample_kernel(cuda, tmp_path,
                                                      deterministic_cudnn):
    """``export_serving`` records ``msstorch::diagonal_upsample``; the
    artifact launches the kernel and serves the labels of
    ``InferenceServer``."""
    from modular_semantic_segmentation_torch.ops.cuda import upsample
    from modular_semantic_segmentation_torch.serving import (
        ExportedServing, InferenceServer, export_serving)
    rng = np.random.RandomState(2)
    cms = {m: rng.rand(6, 6) + np.eye(6) * 5 for m in ("rgb", "depth")}
    net = _small_fusion("bayes_mix", cuda, confusion_matrices=cms,
                        compute_dtype="bfloat16")
    data = _frames(2)
    frames = [{"rgb": data["rgb"][i], "depth": data["depth"][i]}
              for i in range(2)]
    want = InferenceServer(net, unroll=1).predict(frames)
    art = export_serving(net, str(tmp_path / "artifact"),
                         {m: data[m][:1] for m in ("rgb", "depth")})
    program = torch.export.load(str(tmp_path / "artifact" / "program.pt2"))
    targets = [str(node.target) for node in program.graph.nodes]
    assert targets.count("msstorch.diagonal_upsample.default") == 4
    served = ExportedServing(art)
    before = upsample.KERNEL.launches
    got = np.stack([served.predict({m: data[m][i:i + 1]
                                    for m in ("rgb", "depth")})[0]
                    for i in range(2)])
    assert upsample.KERNEL.launches - before == 2 * 4
    np.testing.assert_array_equal(got, want)


def _flagship(device, expert_model="fcn", num_classes=14, **config):
    """The benchmark's fcn_rgbd fusion at its widths (64 units, 14
    classes, no batch norm), Bayes-fused, bf16; AdapNet experts with
    ``expert_model='adapnet'``."""
    from modular_semantic_segmentation_torch.models import get_model
    rng = np.random.RandomState(3)
    cms = {m: rng.rand(num_classes, num_classes) + np.eye(num_classes) * 5
           for m in ("rgb", "depth")}
    return get_model("bayes_mix")(
        data_description=(
            {"labels": np.int32, "rgb": np.float32, "depth": np.float32},
            {"rgb": (None, None, 3), "depth": (None, None, 1),
             "labels": (None, None)}, num_classes),
        num_units=64, expert_model=expert_model,
        prefixes={"rgb": "rgb", "depth": "depth"}, confusion_matrices=cms,
        compute_dtype="bfloat16", device=device, **config)


def _distinct_frames(n, height, width, seed=0):
    rng = np.random.RandomState(seed)
    return [{"rgb": (rng.rand(height, width, 3) * 255).astype(np.float32),
             "depth": rng.rand(height, width, 1).astype(np.float32)}
            for _ in range(n)]


def _eager_outputs(net, frames, attr):
    """Each frame's ``attr`` from the model's eager forward, one by one,
    the frame uploaded as the server uploads it: a batch of one with the
    batch's stride (numpy's ``v[None]`` has a zero stride there, which
    sends every convolution down cuDNN's NCHW path)."""
    from modular_semantic_segmentation_torch.utils.data_io import to_numpy
    return np.stack([
        to_numpy(net._forward(net._batch_to_device(
            {k: np.stack([v]) for k, v in frame.items()}))[attr])[0]
        for frame in frames])


@pytest.mark.gpu
@pytest.mark.parametrize("case,size,unroll,in_flight,n", [
    ("fcn", (768, 384), 4, 2, 11),
    ("fcn", (768, 384), 1, 1, 4),
    ("fcn_int8", (768, 384), 4, 2, 11),
    ("adapnet", (384, 192), 2, 2, 5)])
def test_graph_served_outputs_equal_the_eager_forward(
        cuda, deterministic_cudnn, case, size, unroll, in_flight, n):
    """Labels and each expert's probabilities served from a captured graph
    equal the eager forward's bit for bit, with distinct frames in every
    group (a staging buffer reused too early would show) and a padded
    tail; the server replays one graph."""
    from modular_semantic_segmentation_torch.serving import InferenceServer
    net = _flagship(cuda, expert_model="adapnet" if case == "adapnet"
                    else "fcn")
    frames = _distinct_frames(n, *size, seed=unroll)
    if case == "fcn_int8":
        measure = _distinct_frames(2, *size, seed=99)
        scales = net.quantize_for_serving(
            {k: np.stack([f[k] for f in measure]) for k in ("rgb", "depth")},
            num_batches=1)
        assert scales
    for attr in ("prediction", "rgb_prob", "depth_prob"):
        server = InferenceServer(net, unroll=unroll, max_in_flight=in_flight,
                                 output_attr=attr)
        got = server.predict(frames)
        (entry,) = server._graphs.values()
        assert entry.graph is not None
        np.testing.assert_array_equal(got, _eager_outputs(net, frames, attr))


@pytest.mark.gpu
def test_graph_served_int8_labels_outlast_a_forward_at_other_scales(
        cuda, deterministic_cudnn):
    """A forward at other int8 scales replaces the model's cached int8
    kernels and scales; a server that captured at the first scales keeps
    the ones its graph reads, and still serves the eager labels at its
    own scales, though the freed memory is written over meanwhile."""
    from modular_semantic_segmentation_torch.serving import InferenceServer
    net = _flagship(cuda)
    frames = _distinct_frames(6, 384, 192, seed=5)
    measure = _distinct_frames(2, 384, 192, seed=98)
    scales = net.quantize_for_serving(
        {k: np.stack([f[k] for f in measure]) for k in ("rgb", "depth")},
        num_batches=1)
    want = _eager_outputs(net, frames, "prediction")
    server = InferenceServer(net, unroll=2)
    np.testing.assert_array_equal(server.predict(frames), want)
    net.quantize_for_serving({k: 0.25 * v for k, v in scales.items()})
    other = _eager_outputs(net, frames, "prediction")
    assert (other != want).any()
    scrawl = [torch.full((1 << 20,), 77, dtype=torch.int8, device=cuda)
              for _ in range(256)]
    got = server.predict(frames)
    del scrawl
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_mc_dropout_fusion_is_served_eagerly_on_the_card(
        cuda, deterministic_cudnn):
    """The MC-dropout Variance fusion draws from the model's generator, so
    the server runs it eagerly: no graph, and its labels are the eager
    forward's from the same generator state."""
    from modular_semantic_segmentation_torch.serving import (
        InferenceServer, eager_reason)
    net = _small_fusion("variance", cuda, dropout_rate=0.5, num_samples=3,
                        compute_dtype="bfloat16")
    assert "generator" in eager_reason(net)
    frames = _distinct_frames(3, 64, 96)
    state = net._generator.get_state()
    server = InferenceServer(net, unroll=1, max_in_flight=1)
    got = server.predict(frames)
    assert server._backend is None and not server._graphs
    net._generator.set_state(state)
    np.testing.assert_array_equal(got,
                                  _eager_outputs(net, frames, "prediction"))


# the epilogue kernel at the flagship's outputs ([N, H, W, C] of conv1_2,
# conv2_2, conv3_3, conv4_3 and the decoder's score at 768x384), odd
# widths (16-byte vectors across pixels, and a count that is no multiple
# of 8) and a small tensor
EPILOGUE_SHAPES = [(1, 768, 384, 64), (1, 384, 192, 128), (1, 192, 96, 256),
                   (1, 96, 48, 512), (1, 768, 384, 14), (2, 4, 6, 7),
                   (2, 17, 23, 7), (3, 5, 9, 24)]


def _epilogue_inputs(shape, cuda, seed=0):
    """bf16 x and float32 bias with NaN, +-0, infinities, a float32
    subnormal bias (-0 in bf16) and sums on a tie between two bf16
    values, among random values of both signs."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device=cuda) * 3).to(
        torch.bfloat16)
    bias = torch.randn(c, generator=gen, device=cuda) * 2
    flat = x.view(-1)
    flat[:5] = torch.tensor([float("nan"), -0.0, 0.0, float("inf"),
                             -float("inf")], device=cuda)
    flat[5 * c:6 * c] = 1.0
    specials = [2.0 ** -8, 3 * 2.0 ** -8, -0.0, -1e-45, float("nan")]
    bias[:len(specials)] = torch.tensor(specials[:c], device=cuda)
    flat[7 * c + min(2, c - 1)] = -0.0
    return x, bias


def _assert_epilogue_equal(got, want):
    """Bit for bit where the chain's value is a number (so +0 and -0 are
    told apart), NaN where it is NaN."""
    nan = torch.isnan(want.float())
    assert torch.equal(torch.isnan(got.float()), nan)
    assert torch.equal(got.view(torch.int16)[~nan],
                       want.view(torch.int16)[~nan])


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["aligned", "offset"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", EPILOGUE_SHAPES)
def test_conv_epilogue_kernel_equals_the_chain(cuda, shape, relu, layout):
    """The epilogue kernel, in place, against the chain it replaces
    (``x + bias`` in float32, the cast to bf16, ``torch.relu``) on the
    card; offset: x starts one element past a 16-byte boundary, so the
    kernel takes its one-value path, as it does where the count is no
    multiple of 8."""
    from modular_semantic_segmentation_torch.ops.cuda import conv_epilogue
    x, bias = _epilogue_inputs(shape, cuda, seed=shape[-1])
    want = conv_epilogue.bias_act_plain(x, bias, relu)
    got = _off_alignment(x, 1 if layout == "offset" else 0)
    before = conv_epilogue.KERNEL.launches
    assert conv_epilogue.bias_act_(got, bias, relu) is got
    torch.cuda.synchronize()
    assert conv_epilogue.KERNEL.launches == before + 1
    _assert_epilogue_equal(got, want)


def _chain_kept(monkeypatch):
    """``conv2d`` keeps the PyTorch chain at every conv."""
    from modular_semantic_segmentation_torch.ops import layers
    monkeypatch.setattr(layers, "epilogue_chain_reason",
                        lambda *args: "kept for the comparison")


@pytest.mark.gpu
@pytest.mark.parametrize("unroll,in_flight,n", [(4, 2, 9), (1, 1, 3)])
def test_graph_served_epilogue_equals_the_chain(
        cuda, deterministic_cudnn, monkeypatch, unroll, in_flight, n):
    """Labels and both experts' probabilities served from a captured graph
    whose convolutions end in the epilogue kernel equal, bit for bit, an
    eager forward that keeps the PyTorch chain."""
    from modular_semantic_segmentation_torch.ops.cuda import conv_epilogue
    from modular_semantic_segmentation_torch.serving import InferenceServer
    net = _flagship(cuda)
    frames = _distinct_frames(n, 768, 384, seed=10 + unroll)
    served = {}
    for attr in ("prediction", "rgb_prob", "depth_prob"):
        before = conv_epilogue.KERNEL.launches
        server = InferenceServer(net, unroll=unroll, max_in_flight=in_flight,
                                 output_attr=attr)
        served[attr] = server.predict(frames)
        (entry,) = server._graphs.values()
        assert entry.graph is not None
        # the warm-up and the capture, 32 bias convs a frame each
        assert conv_epilogue.KERNEL.launches - before == 2 * 32 * unroll
    _chain_kept(monkeypatch)
    before = conv_epilogue.KERNEL.launches
    for attr, got in served.items():
        np.testing.assert_array_equal(got, _eager_outputs(net, frames, attr))
    assert conv_epilogue.KERNEL.launches == before


@pytest.mark.gpu
def test_eager_forward_counts_the_epilogue_kernel(cuda):
    """An eager forward of the flagship fusion takes the kernel at all 32
    bias convs a frame (16 an expert) and keeps the chain at none; a
    train-mode step (batch norm, autograd) the opposite. A replayed group
    runs the kernel 32 times a frame on the card (device trace)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from modular_semantic_segmentation_torch.models import get_model
    from modular_semantic_segmentation_torch.serving import InferenceServer
    from modular_semantic_segmentation_torch.utils import tracing
    net = _flagship(cuda)
    frames = _distinct_frames(2, 384, 192, seed=7)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for frame in frames:
            net._forward(net._batch_to_device(
                {k: np.stack([v]) for k, v in frame.items()}))
        torch.cuda.synchronize()
    counters = tracing.snapshot()["counters"]
    assert counters.get("layers.epilogue_fused", 0) == 32 * len(frames)
    assert counters.get("layers.epilogue_eager", 0) == 0
    server = InferenceServer(net, unroll=2)
    server.predict(frames)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        server.predict(frames)
        torch.cuda.synchronize()
    runs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and "conv_epilogue_kernel" in e.name]
    assert len(runs) == 32 * len(frames)
    rng = np.random.RandomState(3)
    trainer = get_model("simple_fcn")(
        prefix="rgb", modality="rgb",
        data_description=({"labels": np.int32, "rgb": np.float32},
                          {"rgb": (None, None, 3), "labels": (None, None)},
                          6),
        num_units=8, channel_factor=0.25, batchsize=2,
        compute_dtype="bfloat16", device=cuda)
    data = {"rgb": (rng.rand(2, 64, 32, 3) * 255).astype(np.float32),
            "labels": rng.randint(-1, 6, (2, 64, 32)).astype(np.int32)}
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.fit(data, 1, output=False)
        torch.cuda.synchronize()
    counters = tracing.snapshot()["counters"]
    assert counters.get("layers.epilogue_fused", 0) == 0
    assert counters["layers.epilogue_eager"] == 16


@pytest.mark.gpu
@pytest.mark.parametrize("unroll,in_flight,n", [(4, 2, 9), (1, 1, 3)])
def test_graph_served_cached_weights_equal_the_per_call_forward(
        cuda, deterministic_cudnn, unroll, in_flight, n):
    """Labels and both experts' probabilities served from a captured graph
    that reads every conv's bf16 channels-last weight and every frozen
    deconv's diagonal from the kernel cache equal, bit for bit, a forward
    that autograd records, which reads none of them there. An eager
    forward reads all 32 conv weights a frame from the cache and misses
    none. A variable written in place is served from a graph captured
    anew, with the new values."""
    from torch.profiler import ProfilerActivity, profile
    from modular_semantic_segmentation_torch.serving import InferenceServer
    from modular_semantic_segmentation_torch.utils import tracing
    from modular_semantic_segmentation_torch.utils.data_io import to_numpy
    from test_torch_weight_cache import _recorded_outputs
    net = _flagship(cuda)
    frames = _distinct_frames(n, 768, 384, seed=20 + unroll)
    for attr in ("prediction", "rgb_prob", "depth_prob"):
        server = InferenceServer(net, unroll=unroll, max_in_flight=in_flight,
                                 output_attr=attr)
        got = server.predict(frames)
        (entry,) = server._graphs.values()
        assert entry.graph is not None
        tracing.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            want = to_numpy(_recorded_outputs(net, frames, attr))
            torch.cuda.synchronize()
        counters = tracing.snapshot()["counters"]
        assert counters.get("layers.weight_cached", 0) == 0
        assert counters["layers.weight_per_call"] == 32 * n
        np.testing.assert_array_equal(got, want)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _eager_outputs(net, frames[:1], "prediction")
        torch.cuda.synchronize()
    counters = tracing.snapshot()["counters"]
    assert counters["layers.weight_cached"] == 32
    assert "layers.weight_per_call" not in counters
    assert counters.get("layers.kernel_cache_miss", 0) == 0
    (captured,) = server._graphs.values()
    net.variables["depth/score/kernel"].mul_(-1.0)
    got = server.predict(frames)
    (entry,) = server._graphs.values()
    assert entry is not captured and entry.graph is not None
    np.testing.assert_array_equal(
        got, to_numpy(_recorded_outputs(net, frames, "depth_prob")))
