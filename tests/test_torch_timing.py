"""The port's timing CLI (``experiments/timing.py``) and timing functions
(``utils/profiling.py``) against the JAX package's, on the CPU.

Every command of the port runs in-process with ``device=cpu`` at 32x32,
``num_units`` 2, 4 classes, float32, one repetition; meanwhile one
subprocess runs the JAX package's ``time_rgb_fcn`` (which shares
``_time``, and so its record's keys, with every other single-model
command), ``time_serving``, ``time_train_step`` and ``time_offline_eval``
at the same size into a store of its own. Held: each port record has the
keys of JAX's record of the same command (``_time``'s for the
single-model commands); each package's ``report.build_timing_table``
reads the other's run, rows, columns and values equal to the other
package's reading of it. ``time_adapnet`` and ``main`` time 768x384
whatever they are given, as JAX's do, so the port's ``DEFAULTS`` frame
is set to 32x32 while its commands run.

The models: each command's construction (model name, every keyword, the
seeded confusion matrices and Dirichlet parameters) equals JAX's, read by
a recording ``get_model`` in both modules; the SimpleFCN-family models
(the Table V sweep) give JAX's labels (op by op, float32) on JAX's weights
carried across with ``params.from_jax_variables``, the Variance fusion at
dropout 0; a label may differ only where an expert's two best
probabilities, or the port's two best fused scores, lie within 1e-5
relative (the SimpleFCN tests' near ties). The AdapNet models' classes
are held against JAX in tests/test_torch_adapnet*.py.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import experiments.report as jax_report
import experiments.timing as jax_timing
import modular_semantic_segmentation_tpu.settings as jax_settings
from modular_semantic_segmentation_tpu.ops.variables import Ctx as JCtx
from modular_semantic_segmentation_torch import settings
from modular_semantic_segmentation_torch.experiments import report, timing
from modular_semantic_segmentation_torch.models.params import \
    from_jax_variables
from modular_semantic_segmentation_torch.utils import profiling

SMALL = {"num_units": 2, "num_classes": 4, "repetitions": 1,
         "compute_dtype": "float32", "height": 32, "width": 32}
TIE = 1e-5
# the single-model commands: (command, the name it records)
SINGLE = [("time_rgb_fcn", "rgb_fcn"), ("time_depth_fcn", "depth_fcn"),
          ("time_fusion_fcn", "fusion_fcn"),
          ("time_average_fcn", "average_fcn"),
          ("time_bayes_fcn", "bayes_fcn"),
          ("time_bayes_adapnet", "bayes_adapnet"),
          ("time_bayes_lookup_fcn", "bayes_lookup_fcn"),
          ("time_dirichlet_fcn", "dirichlet_fcn"),
          ("time_variance_fcn", "variance_fcn"),
          ("time_adapnet", "adapnet_rgb")]
OTHER = {
    "time_serving": ({"model": "bayes_fcn", "unroll": 2},
                     "serving_bayes_fcn"),
    "time_train_step": ({"height": 32, "width": 32, "augment": True},
                        "train_step"),
    "time_offline_eval": ({"num_frames": 3, "batchsize": 2,
                           "height": 32, "width": 32}, "offline_eval"),
}
SWEEP = ["rgb_fcn", "depth_fcn", "average_fcn", "bayes_fcn",
         "bayes_lookup_fcn", "dirichlet_fcn", "fusion_fcn", "variance_fcn"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one intra-op thread while JAX runs in the same process
    (ROADMAP.md section 3, note 2)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(command, device=True):
    extra, _ = OTHER.get(command, ({}, None))
    config = dict(SMALL, **extra, seed=1)
    if device:
        config["device"] = "cpu"
    return config


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package's timing commands, one after the other in one process;
# prints {command: [run id, info]} as one JSON line
JAX_RUNS = """
import json, sys
from experiments import timing
out = {}
for command, config in json.loads(sys.argv[1]):
    timing.ex.run(command, config_updates=config)
    out[command] = [timing.ex.current_run._id, timing.ex.current_run.info]
print("RUNS " + json.dumps(out))
"""


def _store(store):
    """Both packages' settings pointed at the store ``store``."""
    patch = pytest.MonkeyPatch()
    for module in (settings, jax_settings):
        patch.setattr(module, "EXPERIMENT_STORAGE_FOLDER", str(store))
        patch.setattr(module, "EXPERIMENT_DB_HOST", None)
    return patch


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(package, command): (run id, its info)}, and the two stores."""
    stores = {p: tmp_path_factory.mktemp(p) for p in ("port", "jax")}
    jobs = [(c, _config(c, device=False))
            for c in ["time_rgb_fcn"] + list(OTHER)]
    jax_process = subprocess.Popen(
        [sys.executable, "-c", JAX_RUNS, json.dumps(jobs)], cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu",
                 EXPERIMENT_STORAGE_FOLDER=str(stores["jax"])),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {"stores": stores}
    try:
        patch = _store(stores["port"])
        patch.setitem(timing.DEFAULTS, "height", SMALL["height"])
        patch.setitem(timing.DEFAULTS, "width", SMALL["width"])
        try:
            for command in [c for c, _ in SINGLE] + list(OTHER):
                timing.ex.run(command, config_updates=_config(command))
                out["port", command] = (timing.ex.current_run._id,
                                        timing.ex.current_run.info)
            timing.ex.run("main", config_updates=dict(SMALL, device="cpu"))
            out["port", "main"] = (timing.ex.current_run._id,
                                   timing.ex.current_run.info)
        finally:
            patch.undo()
        stdout, stderr = jax_process.communicate(timeout=600)
    finally:
        jax_process.kill()
    assert jax_process.returncode == 0, stderr[-3000:]
    line = next(x for x in stdout.splitlines() if x.startswith("RUNS "))
    for command, (run_id, info) in json.loads(line[len("RUNS "):]).items():
        out["jax", command] = (run_id, info)
    return out


@pytest.mark.parametrize("command,name", SINGLE)
def test_single_model_commands_record_jax_keys(runs, command, name):
    timings = runs["port", command][1]["timings"]
    assert list(timings) == [name]
    want = runs["jax", "time_rgb_fcn"][1]["timings"]["rgb_fcn"]
    assert set(timings[name]) == set(want)
    assert timings[name]["pipelined_mean_s"] > 0


@pytest.mark.parametrize("command", list(OTHER))
def test_other_commands_record_jax_keys(runs, command):
    name = OTHER[command][1]
    got = runs["port", command][1]["timings"]
    want = runs["jax", command][1]["timings"]
    assert list(got) == list(want) == [name]
    assert set(got[name]) == set(want[name])
    if command != "time_offline_eval":
        assert {k: v for k, v in got[name].items() if not
                isinstance(v, float)} == {k: v for k, v in want[name].items()
                                           if not isinstance(v, float)}


def test_main_times_the_table_v_sweep(runs):
    assert list(runs["port", "main"][1]["timings"]) == SWEEP


@pytest.mark.parametrize("package,command", [
    ("port", "main"), ("jax", "time_serving"), ("jax", "time_rgb_fcn")])
def test_timing_tables_read_the_other_package(runs, package, command):
    patch = _store(runs["stores"][package])
    try:
        run_id = runs[package, command][0]
        ours = report.build_timing_table(run_id)
        theirs = jax_report.build_timing_table(run_id)
    finally:
        patch.undo()
    assert ours.index == list(theirs.index)
    assert ours.columns == list(theirs.columns)
    np.testing.assert_array_equal(ours.values,
                                  theirs.values.astype(np.float64))
    if command == "main":
        assert ours.index == SWEEP
        assert ours.column("reference s/frame")["bayes_fcn"] == 0.0461


class _Recorder:
    """A ``get_model`` that records (name, keywords) instead of building."""

    def __init__(self):
        self.calls = []

    def __call__(self, name):
        def build(**kwargs):
            self.calls.append((name, kwargs))
            return name
        return build


def _recording(module, monkeypatch):
    recorder = _Recorder()
    monkeypatch.setattr(module, "get_model", recorder)
    return recorder


def _same(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, (np.ndarray, list, tuple)):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def test_constructions_match_jax(monkeypatch):
    """Every model of the port's BUILDERS is built with JAX's arguments
    (the port's ``device`` aside)."""
    cfg = timing._cfg(SMALL)
    ours = _recording(timing, monkeypatch)
    theirs = _recording(jax_timing, monkeypatch)
    builders = jax_timing._serving_builders()
    for name, (build, modalities) in timing.BUILDERS.items():
        build(cfg)
        if name == "bayes_lookup_fcn":  # JAX's time_bayes_lookup_fcn
            theirs.calls.append(("bayes_mix", jax_timing._fusion_config(
                cfg, confusion_matrices=jax_timing._random_cms(
                    cfg["num_classes"]), use_decision_matrix=True)))
        else:
            build_jax, jax_modalities = builders[name]
            build_jax(cfg)
            assert modalities == jax_modalities
    assert len(ours.calls) == len(theirs.calls) == len(timing.BUILDERS)
    for (name, kwargs), (jname, jkwargs) in zip(ours.calls, theirs.calls):
        assert name == jname
        assert kwargs.pop("device") == "cuda"
        assert _same(kwargs, jkwargs), name


def _near_ties(out):
    """Pixels where an expert's or the fused two best scores lie within
    TIE relative."""
    mask = None
    for key in ("prob", "fused_score", "rgb_prob", "depth_prob"):
        if key in out:
            top = np.sort(out[key], -1)
            tie = top[..., -1] - top[..., -2] <= TIE * np.abs(top[..., -1])
            mask = tie if mask is None else mask | tie
    return mask


@pytest.mark.parametrize("name", SWEEP)
def test_sweep_models_give_jax_labels(name):
    cfg = timing._cfg(dict(SMALL, dropout_rate=0.0, device="cpu"))
    jcfg = jax_timing._cfg(dict(SMALL, dropout_rate=0.0))
    if name == "bayes_lookup_fcn":
        jnet = jax_timing.get_model("bayes_mix")(**jax_timing._fusion_config(
            jcfg, confusion_matrices=jax_timing._random_cms(4),
            use_decision_matrix=True))
    else:
        jnet = jax_timing._serving_builders()[name][0](jcfg)
    build, modalities = timing.BUILDERS[name]
    net = build(cfg)
    net.variables = from_jax_variables(
        {k: np.asarray(v) for k, v in jnet.variables.items()}, device="cpu")
    rng = np.random.RandomState(4)
    batch = {"rgb": (rng.rand(1, 32, 32, 3) * 255).astype(np.float32),
             "depth": (rng.rand(1, 32, 32, 1) * 10).astype(np.float32)}
    batch = {m: batch[m] for m in modalities}
    want = np.asarray(jnet._test_outputs(JCtx(
        jnet.variables, rng=jax.random.PRNGKey(0)), batch)["prediction"])
    out = {k: v.numpy() for k, v in net._forward(
        net._batch_to_device(batch)).items()}
    assert out["prediction"].dtype == np.int32
    differ = out["prediction"] != want
    assert not (differ & ~_near_ties(out)).any()


def test_time_fn_keys_and_device_time_fn():
    x = torch.ones(4)
    result = profiling.time_fn(lambda a: a * 2, x, repetitions=2)
    assert set(result) == {"sync_mean_s", "sync_std_s", "pipelined_mean_s",
                           "pipelined_fps"}
    assert all(isinstance(v, float) for v in result.values())
    seconds, out = profiling.log_compile_time(lambda a: a + 1, x)
    assert seconds >= 0 and torch.equal(out, x + 1)
    calls = []
    profiling.device_time_fn(lambda a: calls.append(a) or a, x, iters=2,
                             repetitions=3)
    # a warm-up call, then 3 runs of 2 and 3 of the default 4 * 2 calls
    assert len(calls) == 1 + 3 * 2 + 3 * 8
    assert all(a is x for a in calls)
    for n2 in (2, 1):
        with pytest.raises(ValueError, match="must exceed"):
            profiling.device_time_fn(lambda a: a, x, iters=2, n2=n2)
