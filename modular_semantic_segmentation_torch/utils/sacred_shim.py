"""A minimal sacred-compatible experiment runner (the port's copy of the
JAX package's ``utils/sacred_shim.py``).

The subset of ``sacred`` that the CLIs use: ``Experiment`` (``main``,
``command``, ``capture``, ``add_artifact``, ``run``,
``run_commandline``), the ``FileStorageObserver`` with sacred's on-disk
layout (``run.json``, ``config.json``, ``info.json``, ``cout.txt``,
artifacts), so that ``ExperimentData`` of either package reads the runs
of both.

CLI grammar: ``python -m modular_semantic_segmentation_torch.experiments.
<module> [command] with <config>.json key=value ...``.

Differences from the JAX package:

* config files are JSON (the JAX package reads YAML too; the GPU machine
  has no yaml). A ``key=value`` value goes through :func:`_parse_value`,
  which gives what ``yaml.safe_load`` gives for plain and quoted scalars
  and flow lists and dicts (dates excepted: they stay strings);
* the observer made without a folder stores into
  ``settings.EXPERIMENT_STORAGE_FOLDER`` as it is when a run starts, and
  claims a run's id by creating its directory, so that runs of several
  processes in one store never share an id.
"""

import inspect
import io
import json
import math
import os
import random
import re
import secrets
import shutil
import sys

import numpy as np

from modular_semantic_segmentation_torch import settings

# ---------------------------------------------------------------- values
# YAML 1.1's implicit scalar types, as PyYAML's resolver matches them
_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE",
                              "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE",
                               "off", "Off", "OFF")}}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)


def _sexagesimal(sign, text, cast):
    value, base = 0, 1
    for part in reversed(text.split(":")):
        value += cast(part) * base
        base *= 60
    return sign * value


def _plain_scalar(text):
    """A plain (unquoted) scalar, resolved as PyYAML's safe loader does."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        digits = text.replace("_", "")
        sign = -1 if digits[0] == "-" else 1
        digits = digits.lstrip("+-")
        if digits == "0":
            return 0
        if digits.startswith("0b"):
            return sign * int(digits[2:], 2)
        if digits.startswith("0x"):
            return sign * int(digits[2:], 16)
        if digits.startswith("0"):
            return sign * int(digits, 8)
        if ":" in digits:
            return _sexagesimal(sign, digits, int)
        return sign * int(digits)
    if _FLOAT.match(text):
        digits = text.replace("_", "").lower()
        sign = -1 if digits[0] == "-" else 1
        digits = digits.lstrip("+-")
        if digits == ".inf":
            return sign * math.inf
        if digits == ".nan":
            return math.nan
        if ":" in digits:
            return _sexagesimal(sign, digits, float)
        return sign * float(digits)
    return text


class _FlowParser:
    """Recursive descent over one YAML flow value: ``[...]``, ``{...}``,
    quoted and plain scalars."""

    def __init__(self, text):
        self.text, self.pos = text, 0

    def _skip(self):
        while self.pos < len(self.text) and self.text[self.pos] in " \t":
            self.pos += 1

    def _peek(self):
        self._skip()
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def _expect(self, char):
        if self._peek() != char:
            raise ValueError(f"expected {char!r} at {self.pos}")
        self.pos += 1

    def value(self, stops):
        char = self._peek()
        if char == "[":
            return self._sequence()
        if char == "{":
            return self._mapping()
        if char == '"':
            return self._double_quoted()
        if char == "'":
            return self._single_quoted()
        return self._plain(stops)

    def _sequence(self):
        self._expect("[")
        items = []
        while self._peek() != "]":
            items.append(self.value(",]"))
            if self._peek() == ",":
                self.pos += 1
            elif self._peek() != "]":
                raise ValueError(f"expected ',' or ']' at {self.pos}")
        self.pos += 1
        return items

    def _mapping(self):
        self._expect("{")
        items = {}
        while self._peek() != "}":
            key = self.value(":,}")
            value = None
            if self._peek() == ":":
                self.pos += 1
                value = self.value(",}")
            items[key] = value
            if self._peek() == ",":
                self.pos += 1
            elif self._peek() != "}":
                raise ValueError(f"expected ',' or '}}' at {self.pos}")
        self.pos += 1
        return items

    def _double_quoted(self):
        match = re.compile(r'"(?:[^"\\]|\\.)*"').match(self.text, self.pos)
        if match is None:
            raise ValueError("unterminated double-quoted string")
        self.pos = match.end()
        return json.loads(match.group(0))

    def _single_quoted(self):
        match = re.compile(r"'(?:[^']|'')*'").match(self.text, self.pos)
        if match is None:
            raise ValueError("unterminated single-quoted string")
        self.pos = match.end()
        return match.group(0)[1:-1].replace("''", "'")

    def _plain(self, stops):
        start = self.pos
        while self.pos < len(self.text):
            char = self.text[self.pos]
            if char in stops and (char != ":" or self.pos + 1 == len(
                    self.text) or self.text[self.pos + 1] in " ,}"):
                break
            self.pos += 1
        return _plain_scalar(self.text[start:self.pos].strip())


def _parse_value(text):
    """A ``key=value`` value as ``yaml.safe_load`` reads it; the text
    itself where it is no single YAML value the parser knows."""
    parser = _FlowParser(text.strip())
    try:
        value = parser.value("")
        if parser._peek():
            raise ValueError(f"trailing text at {parser.pos}")
    except (ValueError, IndexError):
        return text
    return value


def _set_dotted(config, key, value):
    parts = key.split(".")
    node = config
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = value


def _jsonable(obj):
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return {"py/object": "numpy.ndarray", "values": obj.tolist(),
                "dtype": str(obj.dtype)}
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return obj


# ------------------------------------------------------------- observers
class FileStorageObserver:
    """Writes sacred-layout run directories into ``basedir``, or, where
    it is None, into ``settings.EXPERIMENT_STORAGE_FOLDER`` as it is when
    a run starts."""

    def __init__(self, basedir=None):
        self._basedir = basedir

    @classmethod
    def create(cls, basedir=None):
        return cls(basedir)

    @property
    def basedir(self):
        return (self._basedir if self._basedir is not None
                else settings.EXPERIMENT_STORAGE_FOLDER)

    def next_id(self):
        """Claim the next free id (one above the largest in the store) by
        creating its directory."""
        os.makedirs(self.basedir, exist_ok=True)
        while True:
            existing = [int(d) for d in os.listdir(self.basedir)
                        if d.isdigit()]
            run_id = max(existing, default=0) + 1
            try:
                os.mkdir(os.path.join(self.basedir, str(run_id)))
            except FileExistsError:
                continue  # another process took it: look again
            return run_id

    def _record(self, run, status):
        return {"_id": run._id, "status": status, "command": run.command,
                "artifacts": run.artifacts,
                "experiment": {"name": run.experiment_name,
                               "mainfile": run.mainfile}}

    def start_run(self, run):
        run_dir = os.path.join(self.basedir, str(run._id))
        os.makedirs(run_dir, exist_ok=True)
        run._dir = run_dir
        with open(os.path.join(run_dir, "config.json"), "w") as f:
            json.dump(_jsonable(run.config), f, indent=2, default=str)
        # the record of a RUNNING run, so that one killed mid-fit still
        # loads and ``training resume`` finds it; finish_run overwrites it
        with open(os.path.join(run_dir, "run.json"), "w") as f:
            json.dump(_jsonable(self._record(run, "RUNNING")), f, indent=2,
                      default=str)
        with open(os.path.join(run_dir, "info.json"), "w") as f:
            json.dump({}, f)

    def save_artifact(self, run, filepath, name=None):
        name = name or os.path.basename(filepath)
        shutil.copy(filepath, os.path.join(run._dir, name))
        run.artifacts.append({"name": name})

    def finish_run(self, run, status="COMPLETED"):
        with open(os.path.join(run._dir, "info.json"), "w") as f:
            json.dump(_jsonable(run.info), f, indent=2, default=str)
        with open(os.path.join(run._dir, "cout.txt"), "w") as f:
            f.write(run.captured_out)
        with open(os.path.join(run._dir, "run.json"), "w") as f:
            json.dump(_jsonable(self._record(run, status)), f, indent=2,
                      default=str)


class Run:
    def __init__(self, run_id, config, command, experiment_name, mainfile):
        self._id = run_id
        self.config = config
        self.info = {}
        self.command = command
        self.experiment_name = experiment_name
        self.mainfile = mainfile
        self.artifacts = []
        self.captured_out = ""
        self._dir = None


class _Tee(io.TextIOBase):
    def __init__(self, stream, buffer):
        self.stream = stream
        self.buffer = buffer

    def write(self, text):
        self.stream.write(text)
        self.buffer.write(text)
        return len(text)

    def flush(self):
        self.stream.flush()


class Experiment:
    def __init__(self, name=None):
        caller = inspect.currentframe().f_back.f_code.co_filename
        self.mainfile = os.path.basename(caller)
        self.name = name or os.path.splitext(self.mainfile)[0]
        self.observers = []
        self.captured_out_filter = None
        self.commands = {}
        self.main_fn = None
        self.info = {}
        self.current_run = None

    # ------------------------------------------------------------ decorators
    def main(self, fn):
        self.main_fn = fn
        self.commands["main"] = fn
        return fn

    def automain(self, fn):
        return self.main(fn)

    def command(self, fn):
        self.commands[fn.__name__] = fn
        return fn

    def capture(self, fn):
        """A captured function takes its missing arguments from the config
        of the current run."""
        def wrapper(*args, **kwargs):
            return self._call_with_config(fn, self.current_run, args, kwargs)
        wrapper.__name__ = fn.__name__
        wrapper._wrapped = fn
        return wrapper

    # -------------------------------------------------------------- plumbing
    def _call_with_config(self, fn, run, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        sig = inspect.signature(fn)
        for name in list(sig.parameters)[len(args):]:
            if name in kwargs:
                continue
            if name == "_run":
                kwargs["_run"] = run
            elif run is not None and name in run.config:
                kwargs[name] = run.config[name]
            elif sig.parameters[name].default is inspect.Parameter.empty:
                raise TypeError(
                    f"config value '{name}' required by {fn.__name__} not "
                    "found (provide it via 'with cfg.json key=value')")
        return fn(*args, **kwargs)

    def add_artifact(self, filepath, name=None):
        for observer in self.observers:
            observer.save_artifact(self.current_run, filepath, name)

    # ------------------------------------------------------------------ runs
    def run(self, command_name="main", config_updates=None):
        """Run a command with the given config, observed.

        As in sacred, every run has a seed: drawn when the config gives
        none, recorded in ``config.json``, and seeding Python's and
        numpy's global random generators at the start of the run (host
        augmentation draws from them)."""
        config = dict(config_updates or {})
        if "seed" not in config:
            config["seed"] = secrets.randbelow(2 ** 31)
        random.seed(config["seed"])
        np.random.seed(config["seed"] % 2 ** 32)
        fn = self.commands[command_name]
        run_id = None
        for observer in self.observers:
            run_id = observer.next_id()
        run = Run(run_id, config, command_name, self.name, self.mainfile)
        self.current_run = run
        for observer in self.observers:
            observer.start_run(run)

        buffer = io.StringIO()
        old_stdout = sys.stdout
        sys.stdout = _Tee(old_stdout, buffer)
        status = "COMPLETED"
        try:
            result = self._call_with_config(fn, run)
        except BaseException:
            status = "FAILED"
            raise
        finally:
            sys.stdout = old_stdout
            run.captured_out = buffer.getvalue()
            if self.captured_out_filter:
                run.captured_out = self.captured_out_filter(run.captured_out)
            for observer in self.observers:
                observer.finish_run(run, status)
        return result

    def run_commandline(self, argv=None):
        argv = list(sys.argv[1:] if argv is None else argv)
        command = "main"
        config = {}
        i = 0
        if argv and argv[0] != "with" and not argv[0].startswith("-"):
            command = argv[0]
            i = 1
        while i < len(argv):
            arg = argv[i]
            if arg == "with":
                i += 1
                continue
            if arg in ("-u", "--unobserved"):
                self.observers = []
                i += 1
                continue
            if "=" in arg:
                key, _, value = arg.partition("=")
                _set_dotted(config, key, _parse_value(value))
            elif arg.endswith(".json"):
                with open(arg) as f:
                    loaded = json.load(f)
                for key, value in (loaded or {}).items():
                    config.setdefault(key, value)
            elif arg.endswith((".yaml", ".yml")):
                raise ValueError(
                    f"{arg}: the port's config files are JSON (see "
                    "experiments/example_config.json)")
            i += 1
        return self.run(command, config)


def apply_backspaces_and_linefeeds(text):
    """Collapse progress-bar control characters (sacred.utils)."""
    lines = []
    for raw in text.split("\n"):
        line = []
        for ch in raw.split("\r")[-1]:
            if ch == "\b":
                if line:
                    line.pop()
            else:
                line.append(ch)
        lines.append("".join(line))
    return "\n".join(lines)
