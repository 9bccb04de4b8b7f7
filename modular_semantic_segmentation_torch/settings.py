"""Machine-local settings (the port's copy of the JAX package's
``settings.py``, with the same names and the same resolution, so that both
packages read and write one experiment store):

1. a user module ``msstpu_settings`` on the import path,
2. environment variables of the same names,
3. defaults under ``~/.msstpu``.

Code that reads a setting reads the module attribute when it runs, never a
copy taken at import, so a test can set it with ``monkeypatch.setattr``.
"""

import os

_DEFAULT_ROOT = os.path.expanduser("~/.msstpu")

try:
    import msstpu_settings as _user  # type: ignore
except ImportError:
    _user = None


def _resolve(name, default):
    if _user is not None and hasattr(_user, name):
        return getattr(_user, name)
    return os.environ.get(name, default)


DATA_BASEPATH = _resolve("DATA_BASEPATH", os.path.join(_DEFAULT_ROOT, "data"))
EXP_OUT = _resolve("EXP_OUT", os.path.join(_DEFAULT_ROOT, "exp"))
EXPERIMENT_STORAGE_FOLDER = _resolve(
    "EXPERIMENT_STORAGE_FOLDER", os.path.join(_DEFAULT_ROOT, "experiments"))

# MongoDB observer settings: the port has no Mongo backend, and prints a
# warning and stores files when EXPERIMENT_DB_HOST is set
# (utils/experiment.py)
EXPERIMENT_DB_HOST = _resolve("EXPERIMENT_DB_HOST", None)
EXPERIMENT_DB_USER = _resolve("EXPERIMENT_DB_USER", None)
EXPERIMENT_DB_PWD = _resolve("EXPERIMENT_DB_PWD", None)
EXPERIMENT_DB_NAME = _resolve("EXPERIMENT_DB_NAME", None)
