"""The benchmark's families and plain reference against the port, at tiny
sizes on the CPU: variable names and shapes, expert scores, Bayes labels,
a training step, and the FLOP counts (against ``bench.py``'s count and
against the convolutions the port really runs)."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.harness import compare
from benchmark.harness.weights import make_confusion_matrices, make_weights
from benchmark.models import adapnet as adapnet_family
from benchmark.models import simple_fcn as fcn_family
from benchmark.reference import bayes
from benchmark.reference.train import run_steps

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")


def _config(name, **serve):
    config = json.loads((ROOT / "benchmark" / "configs" /
                         f"{name}.json").read_text())
    config["serve"].update(serve)
    config["serve"]["dtype"] = "float32"
    return config


def _specs(family, config, batchnorm):
    return [s for m, ch in config["modalities"].items()
            for s in family.variable_specs(config, m, ch, batchnorm)]


def _fusion(family, config, batchnorm, seed=3):
    config["serve"]["batch_normalization"] = batchnorm
    mats = make_confusion_matrices(list(config["modalities"]),
                                   config["num_classes"], seed)
    net = family.build_fusion(config, mats, CPU, seed)
    weights = make_weights(_specs(family, config, batchnorm), seed, CPU)
    return net, weights, mats


@pytest.mark.parametrize("name,family,batchnorm", [
    ("fcn_rgbd", fcn_family, False), ("fcn_rgbd", fcn_family, True),
    ("adapnet_rgbd", adapnet_family, True)])
def test_specs_are_the_programs_variables(name, family, batchnorm):
    config = _config(name, height=32, width=32)
    config["serve"]["batch_normalization"] = batchnorm
    net = family.build_fusion(config, make_confusion_matrices(
        list(config["modalities"]), 14, 0), CPU, 0)
    specs = {n: tuple(s) for n, s, _ in _specs(family, config, batchnorm)}
    assert specs == {n: tuple(v.shape) for n, v in net.variables.items()}


def test_trainer_specs_and_trainable_are_the_programs():
    config = _config("fcn_rgbd")
    net = fcn_family.build_trainer(config, CPU, 0)
    train = config["train"]
    specs = fcn_family.variable_specs(config, "rgb", 3,
                                      train["batch_normalization"])
    assert {n: tuple(s) for n, s, _ in specs} == {
        n: tuple(v.shape) for n, v in net.variables.items()}
    assert set(fcn_family.trainable(specs)) == {
        n for n, t in net.trainable.items() if t}


@pytest.mark.parametrize("name,family,batchnorm,size", [
    ("fcn_rgbd", fcn_family, False, (64, 32)),
    ("fcn_rgbd", fcn_family, True, (64, 32)),
    ("adapnet_rgbd", adapnet_family, True, (64, 48))])
def test_expert_scores_and_fused_labels(name, family, batchnorm, size):
    config = _config(name, height=size[0], width=size[1])
    net, weights, mats = _fusion(family, config, batchnorm)
    net.variables.update(weights)
    rng = np.random.RandomState(0)
    frame = {"rgb": (rng.rand(1, *size, 3) * 255).astype(np.float32),
             "depth": rng.rand(1, *size, 1).astype(np.float32)}
    scores, margins = [], 0
    for m in config["modalities"]:
        prob = net.predict(frame, output_attr=f"{m}_prob")
        x = torch.from_numpy(frame[m]).permute(0, 3, 1, 2)
        s, _ = family.reference_scores(weights, m, x, batchnorm)
        scores.append(s[0])
        ref = torch.softmax(s, dim=1).permute(0, 2, 3, 1).numpy()
        # float32 on both sides, the order of sums differing: a few ulps of
        # the scores, which softmax turns into up to 1e-4 near 1, and more
        # where two classes nearly tie at scores of thousands (AdapNet)
        off = np.abs(prob - ref)
        assert off.max() < 1e-2 and np.mean(off > 2e-4) < 1e-3
        off, counted = compare.expert_readings(torch.from_numpy(prob[0]),
                                               s[0])
        assert off == 0
        margins += counted
    assert margins > 0
    table = torch.from_numpy(bayes.decision_table(list(mats.values())))
    label = torch.from_numpy(net.predict(frame)[0])
    gap, mismatched, _ = compare.label_readings(label, scores, table)
    assert gap < 1e-4 and mismatched == 0


def test_expert_readings_count_margins_off_by_more_than_the_tolerance():
    gen = torch.Generator().manual_seed(0)
    scores = torch.randn((14, 32, 16), generator=gen)
    exact = torch.softmax(scores, 0).permute(1, 2, 0)
    off, counted = compare.expert_readings(exact, scores)
    assert off == 0 and counted == 13 * 32 * 16
    # each margin moves by the difference of two draws of noise: with a
    # draw's width a quarter of the tolerance, a margin's is sqrt(2) times
    # that, and 0.5% of them lie beyond 2.83 of their widths
    width = 0.25 * compare.SCORE_TOL * scores.pow(2).mean().sqrt()
    noisy = scores + width * torch.randn(scores.shape, generator=gen)
    off, counted = compare.expert_readings(
        torch.softmax(noisy, 0).permute(1, 2, 0), scores)
    assert 0.002 < off / counted < 0.01
    # a constant shift of every class leaves the margins as they were
    shifted = torch.softmax(scores + 5.0, 0).permute(1, 2, 0)
    assert compare.expert_readings(shifted, scores)[0] == 0


def test_bayes_table_is_the_programs_fusion():
    from modular_semantic_segmentation_torch.ops import fusion_math
    mats = make_confusion_matrices(["rgb", "depth"], 14, 5)
    table = bayes.decision_table(list(mats.values()))
    program = fusion_math.bayes_decision_matrix(
        [m.T for m in mats.values()])
    np.testing.assert_array_equal(table, program)
    assert bayes.decision_margin(list(mats.values())) > 1e-3


def test_train_steps_match_the_programs():
    config = _config("fcn_rgbd")
    config["train"].update(height=64, width=96, batch=2)
    train = config["train"]
    net = fcn_family.build_trainer(config, CPU, 7)
    specs = fcn_family.variable_specs(config, "rgb", 3, True)
    weights = make_weights(specs, 7, CPU)
    net.variables.update(weights)
    rng = np.random.RandomState(1)
    x = (rng.rand(2, 64, 96, 3) * 255).astype(np.float32)
    y = rng.randint(-1, 14, (2, 64, 96)).astype(np.int32)
    start = dict(net.variables)
    variables, state, loss = net._train_step(net.variables, net.opt_state,
                                             {"rgb": x, "labels": y})
    trainable = fcn_family.trainable(specs)

    def forward(w, xb):
        return fcn_family.reference_scores(w, "rgb", xb, True, train=True)

    losses, grads, after = run_steps(
        weights, trainable, [(torch.from_numpy(x).permute(0, 3, 1, 2),
                              torch.from_numpy(y))], forward,
        train["learning_rate"])
    assert abs(float(loss) - losses[0]) < 1e-4 * abs(losses[0])
    program = {"losses": [float(loss)],
               "grad_norms": compare.norms(
                   {k: state["mu"][k] / 0.1 for k in trainable}),
               "change_norms": compare.norms(
                   {k: variables[k] - start[k] for k in trainable})}
    reference = {"losses": losses, "grad_norms": compare.norms(grads),
                 "change_norms": compare.norms(
                     {k: after[k] - weights[k] for k in trainable})}
    readings, leaves = compare.training_readings(program, reference)
    assert readings["grad_gap"] < 1e-3
    # the conv biases under batch norm have a gradient of rounding only
    assert len(leaves) < len(trainable)


def _bench_py():
    spec = importlib.util.spec_from_file_location("bench_flops",
                                                  ROOT / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_encoder_flops_equal_bench_py():
    assert fcn_family.encoder_flops(768, 384, 3) == \
        _bench_py().conv_flops_per_expert(768, 384)
    assert round(fcn_family.encoder_flops(768, 384, 3) / 1e9, 1) == 180.4


class _CountConvs:
    """Counts 2 per multiply-add of every conv2d and conv_transpose2d the
    code inside runs."""

    def __init__(self):
        self.flops = 0

    def __enter__(self):
        self._conv, self._deconv = F.conv2d, F.conv_transpose2d

        def conv(x, w, *args, **kwargs):
            out = self._conv(x, w, *args, **kwargs)
            # w[0]: the (in / groups) * kh * kw weights of one output
            self.flops += 2 * w[0].numel() * out.numel()
            return out

        def deconv(x, w, *args, **kwargs):
            # each input element meets (out / groups) * kh * kw weights
            self.flops += 2 * x.numel() * w[0].numel()
            return self._deconv(x, w, *args, **kwargs)

        F.conv2d, F.conv_transpose2d = conv, deconv
        return self

    def __exit__(self, *exc):
        F.conv2d, F.conv_transpose2d = self._conv, self._deconv


@pytest.mark.parametrize("name,family,batchnorm", [
    ("fcn_rgbd", fcn_family, False), ("adapnet_rgbd", adapnet_family, True)])
def test_expert_flops_count_the_programs_convolutions(name, family,
                                                      batchnorm):
    config = _config(name, height=64, width=48)
    config["serve"]["batch_normalization"] = batchnorm
    net = family.build_fusion(config, make_confusion_matrices(
        list(config["modalities"]), 14, 0), CPU, 0)
    frame = {"rgb": np.zeros((1, 64, 48, 3), np.float32),
             "depth": np.zeros((1, 64, 48, 1), np.float32)}
    with _CountConvs() as counted:
        net.predict(frame)
    fused = family.fused_frame_flops(config)
    classes = config["num_classes"]
    assert counted.flops == fused - 2 * classes * 64 * 48
