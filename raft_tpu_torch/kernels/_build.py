"""Build of the port's CUDA kernels: ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.

Each kernel module builds its own source (plus the headers it includes)
into ``build/raft_tpu_torch/``, once per content of those files and the
flags.  :func:`start` runs ``nvcc`` in the background, so several
kernels build at once; :func:`finish` waits for it and loads the
library.  A failed build raises ``RuntimeError``; there is no fallback.

``counters`` counts, in this process, the ``nvcc`` builds started and
the libraries loaded (the serving engine's first-touch accounting,
serve/cache.py ``CompileWatcher``); :func:`library_digests` names each
kernel library by the digest that keys it (the serving cache's flag
surface).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "raft_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
TIMEOUT_S = 600

#: the kernel sources and the headers each includes, by library name
LIBRARIES = {
    "gj_solve": ("gj_solve.cu", ("gj_elim.cuh",)),
    "fused_block": ("fused_block.cu", ("gj_elim.cuh",)),
    "tile_inv": ("tile_inv.cu", ("gj_elim.cuh",)),
    "mm": ("mm.cu", ()),
}

counters = {"nvcc_builds": 0, "libraries_loaded": 0}
# held while a library is built and loaded: the shard workers of one
# process may first reach a kernel together, and build it once
lock = threading.RLock()
# held while a launch counter is incremented from a shard worker
count_lock = threading.Lock()


def digest(source, headers):
    """The key of a library: the flags and the content of its source and
    headers."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in (source, *headers):
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:12]


def library_digests():
    """{library name: digest} of every kernel library of the port."""
    return {name: digest(os.path.join(CSRC, src),
                         [os.path.join(CSRC, h) for h in hdrs])
            for name, (src, hdrs) in LIBRARIES.items()}


def nvcc():
    """Path of the CUDA compiler: ``nvcc`` on PATH, else the toolkit's
    default location."""
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


class Job:
    """One library build: the target path and, while it compiles, the
    ``nvcc`` process (``None`` when the library was already built)."""

    def __init__(self, source, lib_path, proc, tmp):
        self.source = source
        self.lib_path = lib_path
        self.proc = proc
        self.tmp = tmp


def start(source, headers, build_dir, compiler, verbose=False):
    """Start building ``source`` (its content and that of ``headers``
    key the library) unless the library exists; ``verbose`` always
    compiles, with ``-Xptxas -v``."""
    name = os.path.splitext(os.path.basename(source))[0]
    lib_path = os.path.join(build_dir,
                            f"lib{name}_{digest(source, headers)}.so")
    if os.path.exists(lib_path) and not verbose:
        return Job(source, lib_path, None, None)
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [compiler, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-I", CSRC, "-o", tmp, source]
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {cmd[0]}: {e}") from e
    counters["nvcc_builds"] += 1
    return Job(source, lib_path, proc, tmp)


def finish(job, verbose=False):
    """Wait for ``job`` and load its library (``ctypes.CDLL``).  With
    ``verbose`` the compiler's report of registers and spills is
    printed."""
    if job.proc is not None:
        try:
            _, err = job.proc.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            job.proc.kill()
            job.proc.communicate()
            raise RuntimeError(
                f"nvcc took over {TIMEOUT_S} s on {job.source}") from None
        if job.proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({job.proc.returncode}) building "
                f"{job.source}:\n{err}")
        if verbose:
            print(err, end="")
        os.replace(job.tmp, job.lib_path)
    counters["libraries_loaded"] += 1
    return ctypes.CDLL(job.lib_path)
