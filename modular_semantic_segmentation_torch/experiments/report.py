"""Rebuild the paper's tables from stored experiment records (the port's
counterpart of the JAX package's ``experiments/report.py``, without
pandas).

    python -m modular_semantic_segmentation_torch.experiments.report \\
        with 'experiments={"bayes": 2, "average": 3}'
    python -m modular_semantic_segmentation_torch.experiments.report \\
        timing_table with experiment_id=4

``quality`` prints the per-class IoU table of the runs (Tables I-IV) with
its void-excluded mean row, ``timing_table`` the inference timings of a
``timing`` run (Table V) beside the paper's GTX 1080 Ti figures, both as
Markdown tables in BASELINE.md's format. Runs of either package's CLIs are
read alike.
"""

import sys

import numpy as np

from modular_semantic_segmentation_torch.utils.sacred_shim import (
    Experiment, apply_backspaces_and_linefeeds)
from modular_semantic_segmentation_torch.experiments.utils import (
    ExperimentData, get_observer, load_data, reverse_convert_datatypes)

ex = Experiment()
ex.captured_out_filter = apply_backspaces_and_linefeeds
ex.observers.append(get_observer())

#: column order of the paper's quality tables
TABLE_COLUMN_ORDER = ["Fusion_Fcn", "Dirichlet", "Bayes", "Average",
                      "Variance", "RGB", "Depth"]

#: the paper's Table V, seconds per frame on one NVIDIA GTX 1080 Ti
#: (BASELINE.md), keyed by the names ``timing`` records in
#: ``info["timings"]``; the comparison column of ``build_timing_table``,
#: not a measurement of this package
REFERENCE_TIMINGS_S = {
    "rgb_fcn": 0.0219, "depth_fcn": 0.0218, "average_fcn": 0.0432,
    "bayes_fcn": 0.0461, "bayes_lookup_fcn": 0.0461,
    "dirichlet_fcn": 0.0517, "fusion_fcn": 0.0720,
    "variance_fcn": 0.3064,
}


class Table:
    """Rows ``index`` by columns ``columns`` of float ``values`` (a numpy
    array [rows, columns], NaN where a row has no entry): the port's
    stand-in for the pandas DataFrame that the JAX package's report
    builds, with its row and column order."""

    def __init__(self, index, columns, values):
        self.index = list(index)
        self.columns = list(columns)
        self.values = np.asarray(values, np.float64).reshape(
            len(self.index), len(self.columns))

    @classmethod
    def from_rows(cls, rows):
        """From {row: {column: value}}; the columns in the order of their
        first appearance, as ``pandas.DataFrame(rows).T`` orders them."""
        columns = []
        for row in rows.values():
            columns += [c for c in row if c not in columns]
        values = [[row.get(c, np.nan) for c in columns]
                  for row in rows.values()]
        return cls(list(rows), columns, values)

    def column(self, name):
        """{row: value} of one column."""
        j = self.columns.index(name)
        return {row: float(v) for row, v in zip(self.index,
                                                self.values[:, j])}

    def to_markdown(self, precision=4):
        lines = ["| | " + " | ".join(map(str, self.columns)) + " |",
                 "|---" * (len(self.columns) + 1) + "|"]
        for row, values in zip(self.index, self.values):
            cells = ["" if np.isnan(v) else f"{v:.{precision}f}"
                     for v in values]
            lines.append(f"| {row} | " + " | ".join(cells) + " |")
        return "\n".join(lines)

    __str__ = to_markdown


def _column_title(key):
    return {"rgb": "RGB", "depth": "Depth",
            "fusion_fcn": "Fusion_Fcn"}.get(key.lower(), key.title())


def build_quality_table(experiments, class_names=None):
    """Per-class IoU table of stored runs, with a first row 'mean' (class
    0, void, left out of it).

    Args:
        experiments: {column name: experiment id}. A fusion run whose
            measurements hold a 'fusion' entry (bayes_fusion) adds a
            column for each of its experts too.
        class_names: row labels in the dataset's labelinfo order;
            ``class_<i>`` without them.
    Returns:
        a :class:`Table`, its columns in the paper's order first.
    """
    table = {}
    for key, experiment_id in experiments.items():
        info = ExperimentData(experiment_id).get_record()["info"]
        measurements = reverse_convert_datatypes(info["measurements"])
        if "fusion" in measurements:
            table[_column_title(key)] = np.asarray(
                measurements["fusion"]["IoU"])
            for modality, m in measurements.items():
                if modality != "fusion":
                    table[_column_title(modality)] = np.asarray(m["IoU"])
        else:
            table[_column_title(key)] = np.asarray(measurements["IoU"])

    num_classes = len(next(iter(table.values())))
    index = (list(class_names) if class_names is not None
             else [f"class_{i}" for i in range(num_classes)])
    ordered = [c for c in TABLE_COLUMN_ORDER if c in table]
    ordered += [c for c in table if c not in ordered]
    classes = np.stack([np.asarray(table[c], np.float64) for c in ordered],
                       axis=1)
    # NaN IoUs (a class absent from prediction and labels) are skipped,
    # as pandas' mean skips them
    seen = ~np.isnan(classes[1:])
    with np.errstate(invalid="ignore"):
        mean = (np.where(seen, classes[1:], 0.0).sum(0, keepdims=True)
                / seen.sum(0, keepdims=True))
    return Table(["mean"] + index, ordered,
                 np.concatenate([mean, classes], axis=0))


def build_timing_table(experiment_id):
    """Table V from a stored ``timing`` run: seconds and frames per second
    per model, with the paper's GTX 1080 Ti seconds per frame and the
    ratio to them where the paper has the model."""
    info = ExperimentData(experiment_id).get_record()["info"]
    timings = reverse_convert_datatypes(info["timings"])
    rows = {}
    for name, result in timings.items():
        spf = result.get("pipelined_mean_s", result.get("sync_mean_s"))
        if spf is None:
            continue  # a train step or offline evaluation record
        row = {
            "s/frame": spf,
            "fps": 1.0 / spf,
            "sync s/frame": result.get("sync_mean_s", float("nan")),
            "±std": result.get("sync_std_s", float("nan")),
        }
        ref = REFERENCE_TIMINGS_S.get(name)
        if ref is not None:
            row["reference s/frame"] = ref
            row["speedup"] = ref / spf
        rows[name] = row
    return Table.from_rows(rows)


def _resolve_class_names(experiments, evaluation_data):
    """Row labels from an explicit dataset config or the first run's
    recorded one; None (numeric labels) where the dataset cannot be
    built (its data not on disk, say)."""
    candidates = []
    if evaluation_data:
        candidates.append(evaluation_data)
    for experiment_id in experiments.values():
        config = ExperimentData(experiment_id).get_record()["config"]
        recorded = config.get("evaluation_data") or config.get("dataset")
        if recorded:
            candidates.append(recorded)
            break
    for data_config in candidates:
        try:
            data = load_data(data_config)
            return [info["name"] for info in data.labelinfo.values()]
        except Exception as err:  # data folder absent etc.
            print(f"could not load dataset for class names ({err}); "
                  "falling back")
    return None


@ex.command
def timing_table(experiment_id, _run):
    table = build_timing_table(experiment_id)
    print(table)
    _run.info["table"] = {c: table.column(c) for c in table.columns}
    sys.stdout.flush()


@ex.main
def quality(experiments, _run, evaluation_data=None):
    """The quality table (Tables I-IV) of runs, ``experiments`` mapping
    column names to run ids, e.g.
    with 'experiments={"bayes": 2, "dirichlet": 5, "average": 7}'."""
    class_names = _resolve_class_names(experiments, evaluation_data)
    table = build_quality_table(experiments, class_names)
    print(table)
    _run.info["table"] = {c: table.column(c) for c in table.columns}
    sys.stdout.flush()


if __name__ == "__main__":
    ex.run_commandline()
    sys.stdout.flush()
