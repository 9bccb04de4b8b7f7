"""The port's experiment records against the JAX package's, on the CPU.

``ExperimentData`` of either package on the same store (the demo runs in
``notebooks/demo_storage``, runs in the reference's published layout,
runs written by either package's shim) must give equal records,
weights, artifacts and summaries (the port's ``get_summary`` gives numpy
``index`` and ``values`` where JAX's gives a pandas Series). The fusions
load their statistics from records of either backend (directory, zip)
and then fuse as models built from the same arrays do (labels equal).
The event-file reader reads what either package writes; the shim's
yaml-free ``_parse_value`` gives ``yaml.safe_load``'s value for every
entry of ``VALUES``; the port's JSON example config equals JAX's YAML.
"""

import json
import math
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

import modular_semantic_segmentation_tpu.settings as jax_settings
from modular_semantic_segmentation_tpu.models import get_model as jax_model
from modular_semantic_segmentation_tpu.utils import experiment as jax_exp
from modular_semantic_segmentation_tpu.utils import sacred_shim as jax_shim
from modular_semantic_segmentation_tpu.utils import tfevents as jax_events
from modular_semantic_segmentation_torch import settings
from modular_semantic_segmentation_torch.models import get_model
from modular_semantic_segmentation_torch.utils import experiment as port_exp
from modular_semantic_segmentation_torch.utils import sacred_shim as shim
from modular_semantic_segmentation_torch.utils import tfevents

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "notebooks", "demo_storage", "experiments")
K = 4
DESCRIPTION = ({"labels": np.int32, "rgb": np.float32, "depth": np.float32},
               {"rgb": (None, None, 3), "depth": (None, None, 1),
                "labels": (None, None)}, K)
FUSION = {"num_units": 4, "channel_factor": 0.125, "expert_model": "fcn",
          "batchsize": 1, "prefixes": {"rgb": "rgb", "depth": "depth"}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one intra-op thread while JAX runs in the same process
    (ROADMAP.md section 3, note 2)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _use_store(monkeypatch, folder):
    """Point both packages' settings at one experiment store."""
    for module in (settings, jax_settings):
        monkeypatch.setattr(module, "EXPERIMENT_STORAGE_FOLDER", str(folder))
        monkeypatch.setattr(module, "EXPERIMENT_DB_HOST", None)


@pytest.fixture()
def store(tmp_path, monkeypatch):
    folder = tmp_path / "experiments"
    os.makedirs(folder)
    _use_store(monkeypatch, folder)
    return folder


def _assert_deep_equal(got, want, where="record"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for key in want:
            _assert_deep_equal(got[key], want[key], f"{where}.{key}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_deep_equal(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want or (got != got and want != want), where


def _load(source):
    with np.load(source) as npz:
        return {k: npz[k] for k in npz.files}


def _write_run(folder, run_id, info, artifacts=None, config=None):
    run_dir = folder / str(run_id)
    os.makedirs(run_dir)
    with open(run_dir / "run.json", "w") as f:
        json.dump({"_id": run_id, "status": "COMPLETED", "command": "main",
                   "artifacts": [{"name": n} for n in artifacts or {}],
                   "experiment": {"name": "x", "mainfile": "training.py"}},
                  f)
    with open(run_dir / "config.json", "w") as f:
        json.dump(config or {}, f)
    with open(run_dir / "info.json", "w") as f:
        json.dump(info, f)
    for name, arrays in (artifacts or {}).items():
        np.savez(run_dir / name, **arrays)
    return run_dir


def _as_zip(folder, run_id, zip_id):
    """Dump a run with the port, as ``<zip_id>.zip`` of the store."""
    out = port_exp.ExperimentData(run_id).dump(str(folder / "dumped"))
    shutil.move(out, folder / f"{zip_id}.zip")
    return zip_id


def _frames():
    rng = np.random.RandomState(3)
    return {"rgb": (rng.rand(2, 32, 32, 3) * 255).astype(np.float32),
            "depth": rng.rand(2, 32, 32, 1).astype(np.float32),
            "labels": rng.randint(-1, K, (2, 32, 32)).astype(np.int32)}


# ------------------------------------------------------------ demo records
@pytest.mark.parametrize("exp_id", [1, 2, 3, 4, 5, 6, "demo_dump"])
def test_demo_records_equal_jax(monkeypatch, exp_id):
    """The demo store's training (1, 2), Bayes (3), Average, Dirichlet and
    grid runs (4-6) and the zip of run 1: records, artifacts, weights and
    summaries equal to what the JAX package reads."""
    _use_store(monkeypatch, DEMO)
    ours = port_exp.ExperimentData(exp_id)
    theirs = jax_exp.ExperimentData(exp_id)
    _assert_deep_equal(ours.get_record(), theirs.get_record())
    assert sorted(ours.artifacts) == sorted(theirs.artifacts)
    if not any("weights" in a for a in theirs.artifacts):
        return
    _assert_deep_equal(_load(ours.get_weights()),
                       _load(theirs.get_weights()), "weights")
    for tag in ("loss", "accuracy", "IoU"):
        got, want = ours.get_summary(tag), theirs.get_summary(tag)
        np.testing.assert_array_equal(got.index, np.asarray(want.index))
        np.testing.assert_array_equal(got.values, want.values)
        assert isinstance(got.index, np.ndarray) and len(got.values)


# ------------------------------------------------- fusions from the records
@pytest.mark.parametrize("backend", ["directory", "zip"])
@pytest.mark.parametrize("form", ["encoded", "undecoded"])
def test_bayes_fusion_from_eval_experiments(store, backend, form):
    """BayesFusion(eval_experiments=...) loads each run's confusion matrix
    (transposed, float32) as JAX's does, and fuses as a BayesFusion built
    from the same matrices."""
    rng = np.random.RandomState(0)
    cms, ids = {}, {}
    for i, modality in enumerate(["rgb", "depth"], start=1):
        cm = rng.randint(1, 30, (K, K)).astype(float)
        cms[modality] = cm
        stored = {"values": cm.tolist(), "dtype": "float64"}
        if form == "encoded":
            stored["py/object"] = "numpy.ndarray"
        _write_run(store, i, {"confusion_matrix": stored})
        ids[modality] = (i if backend == "directory"
                         else _as_zip(store, i, 10 + i))
    net = get_model("bayes_mix")(data_description=DESCRIPTION,
                                 eval_experiments=ids, device="cpu",
                                 **FUSION)
    jnet = jax_model("bayes_mix")(data_description=DESCRIPTION,
                                  eval_experiments=ids, **FUSION)
    for m in ["rgb", "depth"]:
        np.testing.assert_array_equal(net.confusion_matrices[m],
                                      cms[m].astype("float32").T)
        np.testing.assert_array_equal(net.confusion_matrices[m],
                                      jnet.confusion_matrices[m])
    by_hand = get_model("bayes_mix")(data_description=DESCRIPTION,
                                     confusion_matrices=cms, device="cpu",
                                     **FUSION)
    by_hand.variables = net.variables
    np.testing.assert_array_equal(net.predict(_frames()),
                                  by_hand.predict(_frames()))


@pytest.mark.parametrize("backend", ["directory", "zip"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_dirichlet_fusion_from_measurement_exp(store, backend, use_pallas):
    """DirichletFusion(measurement_exp=...) loads the run's counts.npz (a
    path from a directory, a file object from a zip) as JAX's does, and
    fuses as a DirichletFusion built from the same parameters."""
    rng = np.random.RandomState(1)
    params = {m: rng.rand(K, K).astype("float32") + 0.5
              for m in ["rgb", "depth"]}
    params["class_counts"] = np.arange(1, K + 1).astype("float32")
    _write_run(store, 7, {}, artifacts={"counts.npz": params})
    exp_id = 7 if backend == "directory" else _as_zip(store, 7, 70)
    config = dict(FUSION, sigma=0.5, use_pallas=use_pallas)
    net = get_model("dirichlet_mix")(data_description=DESCRIPTION,
                                     measurement_exp=exp_id, device="cpu",
                                     **config)
    jnet = jax_model("dirichlet_mix")(data_description=DESCRIPTION,
                                      measurement_exp=exp_id, **config)
    for m in ["rgb", "depth"]:
        np.testing.assert_array_equal(net.dirichlet_params[m], params[m])
        np.testing.assert_array_equal(net.dirichlet_params[m],
                                      jnet.dirichlet_params[m])
    np.testing.assert_array_equal(net.class_counts, jnet.class_counts)
    by_hand = get_model("dirichlet_mix")(data_description=DESCRIPTION,
                                         dirichlet_params=params,
                                         device="cpu", **config)
    by_hand.variables = net.variables
    preds = net.predict(_frames())
    assert preds.shape == (2, 32, 32) and preds.dtype == np.int32
    np.testing.assert_array_equal(preds, by_hand.predict(_frames()))


# ------------------------------------------- the reference's record layout
def _write_reference_layout_run(folder, run_id, writer):
    """A run in the reference's published layout: no info.json and no
    summaries.jsonl, scalar summaries in an event file (written by
    ``writer``, either package's EventWriter), npz weights."""
    run_dir = folder / str(run_id)
    os.makedirs(run_dir)
    steps = [0, 100, 200, 300]
    losses = [2.0, 1.2, 0.7, 0.4]
    with writer(str(run_dir), wall_time=1520000000.0) as events:
        for step, loss in zip(steps, losses):
            events.add_scalars(step, {"loss": loss,
                                      "accuracy": 1.0 - loss / 4},
                               wall_time=1520000000.0 + step)
    events_file = os.path.basename(events.path)
    np.savez(run_dir / "SimpleFCN_weights_40000.npz",
             **{"rgb/conv1_1/kernel": np.zeros((3, 3, 3, 4), np.float32)})
    with open(run_dir / "run.json", "w") as f:
        json.dump({"artifacts": [events_file, "SimpleFCN_weights_40000.npz"],
                   "command": "main", "status": "COMPLETED",
                   "experiment": {"name": "training",
                                  "mainfile": "experiments/training.py"},
                   "start_time": "2018-03-02T10:00:00",
                   "host": {"hostname": "ref-host"}}, f)
    with open(run_dir / "config.json", "w") as f:
        json.dump({"modelname": "simple_fcn", "num_iterations": 40000,
                   "dataset": {"name": "synthia", "batchsize": 4},
                   "net_config": {"num_units": 64, "modality": "rgb",
                                  "prefix": "rgb"}, "seed": 42}, f)
    with open(run_dir / "cout.txt", "w") as f:
        f.write("INFO: Start training\n")
    return steps, losses


@pytest.mark.parametrize("writer", [tfevents.EventWriter,
                                    jax_events.EventWriter])
def test_reference_layout_record_loads(store, writer):
    """get_record / get_summary (from the event file) / get_weights of a
    run in the reference's layout, as JAX's loader reads them."""
    steps, losses = _write_reference_layout_run(store, 11, writer)
    exp = port_exp.ExperimentData(11)
    record = exp.get_record()
    assert record["status"] == "COMPLETED"
    assert record["config"]["modelname"] == "simple_fcn"
    assert record["info"] == {}
    assert record["captured_out"].startswith("INFO")
    _assert_deep_equal(record, jax_exp.ExperimentData(11).get_record())
    series = exp.get_summary("loss")
    np.testing.assert_array_equal(series.index, steps)
    np.testing.assert_allclose(series.values, losses, rtol=1e-6)
    np.testing.assert_allclose(exp.get_summary("accuracy").values,
                               [1.0 - x / 4 for x in losses], rtol=1e-6)
    want = jax_exp.ExperimentData(11).get_summary("accuracy")
    np.testing.assert_array_equal(exp.get_summary("accuracy").values,
                                  want.values)
    weights_path = exp.get_weights()
    assert "SimpleFCN_weights_40000.npz" in weights_path
    assert "rgb/conv1_1/kernel" in _load(weights_path)


def test_reference_layout_zip_roundtrip(store, tmp_path):
    """dump() of a reference-layout run gives a zip that the zip backend
    of both packages reads back, summaries from the event file too."""
    steps, losses = _write_reference_layout_run(store, 12,
                                                tfevents.EventWriter)
    out = port_exp.ExperimentData(12).dump(str(tmp_path / "dumped"))
    shutil.copy(out, store / "99.zip")
    exp = port_exp.ExperimentData(99)
    assert exp.get_record()["config"]["num_iterations"] == 40000
    _assert_deep_equal(exp.get_record(),
                       jax_exp.ExperimentData(99).get_record())
    series = exp.get_summary("loss")
    np.testing.assert_array_equal(series.index, steps)
    np.testing.assert_allclose(series.values, losses, rtol=1e-6)
    _assert_deep_equal(_load(exp.get_weights()),
                       _load(jax_exp.ExperimentData(99).get_weights()))


def test_update_record(store):
    _write_run(store, 3, {"measurements": {"mean_IoU": 0.5}})
    exp = port_exp.ExperimentData(3)
    exp.update_record({"info": {"measurements": {"mean_IoU": 0.8}}})
    assert jax_exp.ExperimentData(3).get_record()["info"] == {
        "measurements": {"mean_IoU": 0.8}}
    _as_zip(store, 3, 30)
    with pytest.raises(UserWarning, match="directory"):
        port_exp.ExperimentData(30).update_record({"info": {}})
    with pytest.raises(UserWarning, match="not found"):
        port_exp.ExperimentData(12345)


def test_mongo_settings_fall_back_to_files(store, monkeypatch, capsys):
    """With EXPERIMENT_DB_HOST set the port, which has no Mongo backend,
    warns as the JAX package does without pymongo and uses the files."""
    _write_run(store, 1, {"x": 1})
    monkeypatch.setattr(settings, "EXPERIMENT_DB_HOST", "somewhere")
    assert port_exp.ExperimentData(1).get_record()["info"] == {"x": 1}
    observer = port_exp.get_observer()
    assert observer.basedir == str(store)
    assert capsys.readouterr().out.count(port_exp.NO_MONGO_WARNING) == 2


# ------------------------------------------------------------ event files
@pytest.mark.parametrize("writer", [tfevents.EventWriter,
                                    jax_events.EventWriter])
def test_iter_scalar_events_matches_jax(tmp_path, writer):
    """Both readers give the same events from a file either package
    wrote, a negative step (an int64 varint of 10 bytes, written here as
    its unsigned form) and a truncated last record among them."""
    with writer(str(tmp_path), wall_time=1.5e9) as events:
        for step, value in ((2 ** 64 - 3, 0.25), (0, 1.5), (7, -2.0),
                            (2 ** 40, 3.0)):
            events.add_scalars(step, {"loss": value, "IoU": value / 3},
                               wall_time=1.5e9 + step % 97)
    with open(events.path, "rb") as f:
        data = f.read()
    for source in (events.path, data, data[:-7]):
        got = list(tfevents.iter_scalar_events(source))
        want = list(jax_events.iter_scalar_events(source))
        assert [tuple(e) for e in got] == [tuple(e) for e in want]
        assert len(got) >= 6
    assert got[0].step == -3


# ------------------------------------------------------------------ shim
VALUES = ["3", "-7", "+5", "0", "017", "0x1F", "0b101", "1_000", "1:30",
          "0.01", "1e-4", "1.0e-4", "1.5E+3", "-2.5", ".5", "1.", ".inf",
          "-.inf", ".nan", "1e4", "3.0", "true", "false", "True", "TRUE",
          "yes", "no", "on", "off", "null", "~", "", "Null", "abc",
          "hello world", "simple_fcn", "/tmp/some/path", '"quoted"',
          "'single'", "'it''s'", '"a\\nb"', '"3"', "[1, 2, 3]", "[]", "{}",
          '{"a": 1}', '{"rgb": "rgb", "depth": "depth"}',
          '{"rgb": 3, "depth": 4}', "[0.1, 1.0]",
          '["entropy", "variance"]', "{a: 1, b: [1, 2]}",
          "[1e-4, 0.5, true, null, abc]", '{"x": {"y": [1, {"z": false}]}}',
          "a:b", "http://x", "1.2.3", "[a, b c]"]


@pytest.mark.parametrize("text", VALUES)
def test_parse_value_matches_yaml(text):
    want = yaml.safe_load(text)
    got = shim._parse_value(text)
    assert type(got) is type(want)
    assert got == want or (isinstance(want, float) and math.isnan(want)
                           and math.isnan(got))


def test_sacred_shim_parsing():
    assert shim._parse_value("3") == 3
    assert shim._parse_value("false") is False
    assert shim._parse_value('{"a": 1}') == {"a": 1}
    assert shim._parse_value("{a: [1, 2") == "{a: [1, 2"
    cfg = {}
    shim._set_dotted(cfg, "a.b.c", 5)
    assert cfg == {"a": {"b": {"c": 5}}}
    assert shim.apply_backspaces_and_linefeeds("abc\rdef") == "def"
    assert shim.apply_backspaces_and_linefeeds("ab\bc") == "ac"
    values = {"a": np.arange(3, dtype=np.int16), "b": (np.float32(1.5),),
              3: np.int64(4)}
    assert shim._jsonable(values) == jax_shim._jsonable(values)


def test_example_config_equals_jax_yaml():
    with open(os.path.join(REPO, "modular_semantic_segmentation_torch",
                           "experiments", "example_config.json")) as f:
        ours = json.load(f)
    with open(os.path.join(REPO, "experiments", "example_config.yaml")) as f:
        assert ours == yaml.safe_load(f)


def _record_layout(run_dir):
    """What a run directory holds, ids and times aside."""
    out = {"files": sorted(os.listdir(run_dir))}
    for name in ("run.json", "config.json", "info.json"):
        with open(os.path.join(run_dir, name)) as f:
            out[name] = json.load(f)
    out["run.json"].pop("_id")
    with open(os.path.join(run_dir, "cout.txt")) as f:
        out["cout.txt"] = f.read()
    return out


def test_shim_runs_write_jax_layout(store, tmp_path):
    """One command run through each package's shim, with a JSON config
    file and k=v overrides: the same files and records; ids from one
    store never clash; a YAML config file is refused by the port."""
    def work(alpha, nested, _run, extra=None):
        print("abc\rvalue", alpha, nested["b"])
        _run.info["result"] = np.arange(3) * alpha
        artifact = tmp_path / "artifact.txt"
        artifact.write_text("payload")
        experiment.add_artifact(str(artifact))
        return alpha

    config_file = tmp_path / "cfg.json"
    config_file.write_text(json.dumps({"alpha": 1, "nested": {"b": "x"}}))
    argv = ["work", "with", str(config_file), "alpha=2", "nested.b=[1, 2]",
            "seed=5"]
    ids = []
    for module in (shim, jax_shim, shim):
        experiment = module.Experiment("demo")
        experiment.captured_out_filter = module.apply_backspaces_and_linefeeds
        experiment.observers.append(module.FileStorageObserver.create(
            str(store)))
        experiment.command(work)
        assert experiment.run_commandline(argv) == 2
        ids.append(experiment.current_run._id)
    assert ids == [1, 2, 3]
    layouts = [_record_layout(store / str(i)) for i in ids]
    assert layouts[0] == layouts[1] == layouts[2]
    assert layouts[0]["config.json"]["nested"] == {"b": [1, 2]}
    assert layouts[0]["cout.txt"] == "value 2 [1, 2]\n"
    experiment = shim.Experiment("demo")
    experiment.command(work)
    (tmp_path / "cfg.yaml").write_text("alpha: 1\n")
    with pytest.raises(ValueError, match="JSON"):
        experiment.run_commandline(["work", "with",
                                    str(tmp_path / "cfg.yaml")])


def test_observer_skips_an_id_taken_meanwhile(store):
    """The port's observer claims an id by creating its directory: an id
    another process took first is passed over."""
    observer = shim.FileStorageObserver()
    assert observer.basedir == str(store)
    assert observer.next_id() == 1
    assert observer.next_id() == 2
    real_mkdir, taken = os.mkdir, []

    def racing_mkdir(path, *args):
        if not taken and os.path.basename(path).isdigit():
            taken.append(path)
            real_mkdir(path, *args)  # the other process wins
        return real_mkdir(path, *args)

    os.mkdir = racing_mkdir
    try:
        assert observer.next_id() == 4
    finally:
        os.mkdir = real_mkdir
    assert sorted(os.listdir(store)) == ["1", "2", "3", "4"]
