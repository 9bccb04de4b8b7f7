"""Experiment records (the port's copy of the JAX package's
``utils/experiment.py``).

``ExperimentData`` loads a past run's config, info, artifacts, weights and
training curves from the FileStorage layout that the JAX package and the
port both write (``run.json``, ``config.json``, ``info.json``,
``cout.txt`` and the artifacts, in a directory ``<id>`` or an archive
``<id>.zip`` of the experiment store), so that models compose across
runs and across the two packages: a fusion loads its experts' weights and
confusion matrices or its Dirichlet parameters by experiment id.

Differences from the JAX package:

* no MongoDB backend (the port has no pymongo): with
  ``EXPERIMENT_DB_HOST`` set, ``get_observer`` and ``ExperimentData``
  print the JAX package's "no mongo support" warning and use the files,
  as the JAX package does without pymongo;
* ``get_summary`` returns a :class:`Summary` (numpy ``index`` of steps and
  ``values``) where the JAX package returns a pandas Series: those are the
  two attributes its callers read, and the GPU machine has no pandas;
* a zip artifact comes back as an in-memory file object, so no archive
  stays open behind it.
"""

import io
import json
import zipfile
from collections import namedtuple
from copy import deepcopy
from os import listdir, path

import numpy as np

from modular_semantic_segmentation_torch import settings

NO_MONGO_WARNING = ("WARNING: DB settings found but no mongo support; "
                    "falling back to file storage")

#: a scalar training curve: ``index`` (steps) and ``values``, numpy arrays
Summary = namedtuple("Summary", ["index", "values"])


def get_observer():
    """The observer of the CLIs: file storage in the experiment store that
    ``settings.EXPERIMENT_STORAGE_FOLDER`` names when a run starts."""
    if settings.EXPERIMENT_DB_HOST:
        print(NO_MONGO_WARNING)
    from modular_semantic_segmentation_torch.utils.sacred_shim import \
        FileStorageObserver
    return FileStorageObserver.create()


def load_data(data_config):
    """Instantiate the dataset described by a data_config dict."""
    from modular_semantic_segmentation_torch.datasets import get_dataset
    params = {key: val for key, val in data_config.items()
              if key not in ["dataset", "name", "use_trainset"]}
    name = data_config.get("dataset", data_config.get("name"))
    return get_dataset(name)(**params)


def data_description(data_config):
    """Data description of the dataset named in a data_config dict, with
    its optional ``num_classes`` override (as the JAX package's CLIs take
    it)."""
    from modular_semantic_segmentation_torch.datasets import get_dataset
    name = data_config.get("dataset", data_config.get("name"))
    return get_dataset(name).get_data_description(
        num_classes=data_config.get("num_classes"))


def reverse_convert_datatypes(data):
    """Undo the JSON encoding of numpy values in stored records."""
    if isinstance(data, dict):
        if "values" in data and len(data) == 1:
            return reverse_convert_datatypes(data["values"])
        if "py/tuple" in data and len(data) == 1:
            return reverse_convert_datatypes(data["py/tuple"])
        if data.get("py/object") == "numpy.ndarray":
            if "dtype" in data:
                return np.array(data["values"], dtype=data["dtype"])
            return np.array(data["values"])
        return {key: reverse_convert_datatypes(val)
                for key, val in data.items()}
    if isinstance(data, list):
        return [reverse_convert_datatypes(item) for item in data]
    return data


class ExperimentData:
    """A past run's record and artifacts, from the directory ``<id>`` or
    the archive ``<id>.zip`` of the experiment store (in that order)."""

    def __init__(self, exp_id):
        if settings.EXPERIMENT_DB_HOST:
            print(NO_MONGO_WARNING)
        folder = settings.EXPERIMENT_STORAGE_FOLDER
        names = listdir(folder)
        if str(exp_id) in names:
            self.exp_path = path.join(folder, str(exp_id))
            with open(path.join(self.exp_path, "run.json")) as f:
                record = json.load(f)
            # sacred's own FileStorageObserver writes info.json only when
            # the run set info; keep what run.json carries otherwise
            info_path = path.join(self.exp_path, "info.json")
            if path.exists(info_path):
                with open(info_path) as f:
                    record["info"] = json.load(f)
            else:
                record.setdefault("info", {})
            with open(path.join(self.exp_path, "config.json")) as f:
                record["config"] = json.load(f)
            cout = path.join(self.exp_path, "cout.txt")
            record["captured_out"] = ""
            if path.exists(cout):
                with open(cout) as f:
                    record["captured_out"] = f.read()
            self.artifacts = listdir(self.exp_path)
        elif f"{exp_id}.zip" in names:
            self.zipfile = path.join(folder, f"{exp_id}.zip")
            with zipfile.ZipFile(self.zipfile) as archive:
                members = archive.namelist()
                record = json.loads(archive.read("run.json").decode("utf8"))
                if "info.json" in members:
                    record["info"] = json.loads(
                        archive.read("info.json").decode("utf8"))
                else:
                    record.setdefault("info", {})
                record["config"] = json.loads(
                    archive.read("config.json").decode("utf8"))
                if "cout.txt" in members:
                    record["captured_out"] = archive.read(
                        "cout.txt").decode("utf8", errors="replace")
            self.artifacts = members
        else:
            raise UserWarning(f"Specified experiment {exp_id} not found.")
        self.record = record

    def get_record(self):
        return reverse_convert_datatypes(deepcopy(self.record))

    def get_artifact(self, name):
        """The artifact ``name``: a file path (directory backend) or a
        file object holding its bytes (zip backend)."""
        if name not in self.artifacts:
            raise UserWarning(f"ERROR: Artifact {name} not found")
        if hasattr(self, "exp_path"):
            return path.join(self.exp_path, name)
        with zipfile.ZipFile(self.zipfile) as archive:
            return io.BytesIO(archive.read(name))

    def get_summary(self, tag):
        """The scalar curve ``tag`` of the run's training, as a
        :class:`Summary`: from ``summaries.jsonl`` where the run has one,
        else from its TF event file (the reference's published runs)."""
        search = [a for a in self.artifacts if "summaries" in a]
        steps, values = [], []
        if search:
            source = self.get_artifact(search[0])
            if isinstance(source, str):
                with open(source) as f:
                    lines = f.read().splitlines()
            else:
                lines = source.read().decode("utf8").splitlines()
            for line in lines:
                if not line.strip():
                    continue
                record = json.loads(line)
                if tag in record:
                    steps.append(record["step"])
                    values.append(record[tag])
            return Summary(np.asarray(steps), np.asarray(values))
        events = [a for a in self.artifacts if "events" in a]
        if not events:
            raise UserWarning("ERROR: Could not find summary file")
        from modular_semantic_segmentation_torch.utils.tfevents import \
            iter_scalar_events
        for event in iter_scalar_events(self.get_artifact(events[0])):
            if event.tag == tag:
                steps.append(event.step)
                values.append(event.simple_value)
        return Summary(np.asarray(steps), np.asarray(values))

    def get_weights(self):
        """Path or file object of the first stored weights artifact."""
        filename = next(a for a in self.artifacts if "weights" in a)
        return self.get_artifact(filename)

    def dump(self, out_path):
        """Write the record and artifacts as a zip archive; returns its
        path (``.zip`` appended where missing)."""
        if not out_path.endswith(".zip"):
            out_path = out_path + ".zip"
        with zipfile.ZipFile(out_path, "w") as archive:
            record = deepcopy(self.record)
            for name in self.artifacts:
                if name.endswith((".json", ".txt")):
                    continue
                source = self.get_artifact(name)
                if isinstance(source, str):
                    archive.write(source, name)
                else:
                    archive.writestr(name, source.read())
            archive.writestr("config.json", json.dumps(record["config"],
                                                       default=str))
            archive.writestr("cout.txt", record.get("captured_out", ""))
            archive.writestr("info.json", json.dumps(record["info"],
                                                     default=str))
            record.pop("config", None)
            record.pop("captured_out", None)
            record.pop("info", None)
            archive.writestr("run.json", json.dumps(record, default=str))
        return out_path

    def update_record(self, changes):
        """Apply ``changes`` to the record and write its info back
        (directory backend only)."""
        if not hasattr(self, "exp_path"):
            raise UserWarning("update_record needs a run stored as a "
                              "directory, not as a zip archive")
        self.record.update(changes)
        with open(path.join(self.exp_path, "info.json"), "w") as f:
            json.dump(self.record["info"], f, indent=2, default=str)
