"""Build the kernels in ``csrc/`` with nvcc and call them through ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
into its own shared library,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so
         csrc/<name>.cu

under ``modular_semantic_segmentation_torch/_build/`` (listed in
``.gitignore``), with nvcc's output (ptxas's registers, shared memory and
spills per kernel) in ``_build/<name>-<hash>.log``. The file name carries
a hash of the source and the flags, so an edited source is rebuilt. No
PyTorch header is compiled, which keeps a build to seconds. ``build()``
starts one nvcc per source, all at once. ``build_in_background(name)``
starts one source's build in a thread, so that it runs under a process's
other set-up; ``build()`` and the first launch wait for it.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL_SOURCES = ("confusion", "dirichlet", "stem_conv", "upsample",
                  "upsample_adjoint", "conv_epilogue")

# source name -> the thread building it in the background
_BACKGROUND = {}
_BACKGROUND_LOCK = threading.Lock()


def find_nvcc():
    """nvcc from ``CUDA_HOME``, else from ``PATH``, else the toolkit's
    default location; raises if none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin",
                                       "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for candidate in candidates:
        if os.path.isfile(candidate) and os.access(candidate, os.X_OK):
            return candidate
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, on PATH and in "
        "/usr/local/cuda/bin): the CUDA kernels of this package are built "
        "with the CUDA toolkit's nvcc on first use")


def library_path(name):
    """(source path, shared-library path) of kernel source ``name``; the
    hash covers the source, the flags and every shared header
    (``csrc/*.cuh``), which a source may include."""
    source = os.path.join(CSRC_DIR, f"{name}.cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [source] + [os.path.join(CSRC_DIR, f) for f in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return source, os.path.join(BUILD_DIR,
                                f"{name}-{digest.hexdigest()[:16]}.so")


def build(names=KERNEL_SOURCES, timeout=600):
    """Compile the named sources that are not built yet, one nvcc each, in
    parallel, after any background build of them has ended. Raises with
    nvcc's output if any build fails."""
    with _BACKGROUND_LOCK:
        pending = [_BACKGROUND.pop(name) for name in names
                   if name in _BACKGROUND]
    for thread in pending:
        thread.join()
    _compile(names, timeout)


def build_in_background(name):
    """Start compiling source ``name`` in a daemon thread, unless it is
    built or being built. A failed build is left to the next ``build()``
    of the source, which compiles it again and raises with nvcc's
    output."""
    with _BACKGROUND_LOCK:
        if name in _BACKGROUND or os.path.exists(library_path(name)[1]):
            return
        thread = threading.Thread(target=_compile_quietly, args=(name,),
                                  name=f"nvcc {name}", daemon=True)
        _BACKGROUND[name] = thread
        thread.start()


def _compile_quietly(name):
    try:
        _compile((name,))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        pass


def _compile(names, timeout=600):
    jobs = []
    try:
        for name in names:
            source, target = library_path(name)
            if os.path.exists(target):
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            partial = (f"{target}.{os.getpid()}."
                       f"{threading.get_ident()}.part")
            proc = subprocess.Popen(
                [find_nvcc(), *NVCC_FLAGS, "-o", partial, source],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((name, proc, partial, target))
        errors = []
        for name, proc, partial, target in jobs:
            log, _ = proc.communicate(timeout=timeout)
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {name}.cu "
                              f"(exit {proc.returncode}):\n{log}")
            else:
                with open(f"{target[:-3]}.log", "w") as f:
                    f.write(log)
                os.replace(partial, target)
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for _, proc, partial, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(partial):
                os.remove(partial)


def build_log(name):
    """nvcc's output for the built library of source ``name``."""
    with open(f"{library_path(name)[1][:-3]}.log") as f:
        return f.read()


class Kernel:
    """One C entry point of a kernel library, with its launch count.

    ``kernel(*args)`` builds and loads the library on first use, calls the
    entry point (which launches on the stream passed to it and returns
    ``cudaGetLastError()``), raises if that is not 0, and adds one to
    ``launches``.
    """

    def __init__(self, source, symbol, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._error_string = None

    def _load(self):
        build((self.source,))
        lib = ctypes.CDLL(library_path(self.source)[1])
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{self.source}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._error_string = fn, err

    def __call__(self, *args):
        if self._fn is None:
            self._load()
        status = self._fn(*args)
        if status != 0:
            raise RuntimeError(
                f"{self.symbol} failed to launch: CUDA error {status} "
                f"({self._error_string(status).decode()})")
        self.launches += 1
