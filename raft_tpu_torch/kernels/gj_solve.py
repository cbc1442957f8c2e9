"""Batched Gauss–Jordan elimination: the CUDA kernel of the RAO hot loop
and its plain PyTorch version.

:func:`gj_solve` runs n steps of partial-pivot Gauss–Jordan elimination
on every augmented system of ``M [B, n, m]`` and returns the eliminated
``M`` (its ``[..., n:]`` columns are the solution) and ``|pivot|`` of
every step, ``[B, n]``.  It replaces the TPU kernel
``raft_tpu/pallas_kernels.py:128-179`` (``gauss_solve_pallas``).

- A tensor on the card goes to the kernel in ``csrc/gj_solve.cu`` (its
  elimination is ``csrc/gj_elim.cuh``: a lane per column, one division
  per lane and step; :func:`launch_shape` gives its grid), built with
  ``nvcc`` for ``sm_90a`` at first use into ``build/raft_tpu_torch/``
  and loaded with ``ctypes`` (kernels/_build.py).  A failed build or
  launch raises; there is no fallback.
- A tensor on the CPU goes to :func:`gj_solve_reference`, the plain
  version of the same steps (the mirror of ``raft_tpu.dynamics._gj_step``).

``launches`` counts the kernel's launches in this process and
``launches_backward`` those made for a backward pass
(:class:`raft_tpu_torch.dynamics.GaussSolve`: the transposed systems
``[A^T | g]`` go through the same kernel).
"""

import ctypes
import os

import torch

from raft_tpu_torch.kernels import _build
from raft_tpu_torch.kernels._build import BUILD_DIR, nvcc

SOURCES = (os.path.join(_build.CSRC, "gj_solve.cu"),)
HEADERS = (os.path.join(_build.CSRC, "gj_elim.cuh"),)
MAX_N = 16
MAX_M = 32

launches = 0
launches_backward = 0
_lib = None
_INT = ctypes.c_int


def start_build(verbose=False):
    """Start compiling ``csrc/gj_solve.cu`` (see :func:`build`)."""
    return _build.start(SOURCES[0], HEADERS, BUILD_DIR, nvcc(), verbose)


def build(verbose=False, job=None):
    """Compile ``csrc/gj_solve.cu`` (once per content of it and of
    ``csrc/gj_elim.cuh``) and load it; ``job`` is a build already started
    by :func:`start_build`.  Returns the ``ctypes`` library; raises
    ``RuntimeError`` when the build fails.  ``verbose`` adds ``-Xptxas -v``
    and prints the compiler's report of registers and spills."""
    global _lib
    if _lib is not None and not verbose and job is None:
        return _lib
    with _build.lock:
        if _lib is not None and not verbose and job is None:
            return _lib
        lib = _build.finish(job or start_build(verbose), verbose)
        for name in ("gj_solve_f64", "gj_solve_f32"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           _INT, _INT, _INT, ctypes.c_void_p]
            fn.restype = _INT
        lib.gj_solve_shape.argtypes = [_INT, _INT, ctypes.POINTER(_INT),
                                       ctypes.POINTER(_INT)]
        lib.gj_solve_shape.restype = _INT
        _lib = lib
        return lib


def launch_shape(B, m=13):
    """``(CTAs, threads per CTA)`` of the kernel's launch for ``B``
    systems of ``m`` columns (builds the kernel): a half-warp per system
    up to 16 columns, a warp beyond."""
    ctas, threads = _INT(), _INT()
    rc = build().gj_solve_shape(B, m, ctypes.byref(ctas),
                                ctypes.byref(threads))
    if rc != 0:
        raise ValueError(f"gj_solve takes B >= 0 and 1 <= m <= {MAX_M}, "
                         f"got B={B}, m={m}")
    return ctas.value, threads.value


def _check(M):
    if M.dim() != 3:
        raise ValueError(f"gj_solve expects M [B, n, m], got {tuple(M.shape)}")
    if M.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"gj_solve takes float32 or float64, got {M.dtype}")
    _, n, m = M.shape
    if not (1 <= n <= MAX_N and n <= m <= MAX_M):
        raise ValueError(
            f"gj_solve takes 1 <= n <= {MAX_N} and n <= m <= {MAX_M}, got "
            f"n={n}, m={m}")


def gj_solve(M, backward=False):
    """Eliminate every system of ``M [B, n, m]``; returns
    ``(M_out [B, n, m], |pivot| [B, n])``.  CPU tensors take the plain
    version, CUDA tensors the kernel; ``backward`` counts the launch in
    ``launches_backward`` instead of ``launches``."""
    global launches, launches_backward
    _check(M)
    if M.device.type == "cpu":
        return gj_solve_reference(M)
    if M.device.type != "cuda":
        raise ValueError(f"gj_solve runs on cuda or cpu, not {M.device}")
    if not M.is_contiguous():
        raise ValueError("gj_solve needs a contiguous M")
    lib = build()
    B, n, m = M.shape
    out = torch.empty_like(M)
    piv = torch.empty((B, n), dtype=M.dtype, device=M.device)
    fn = lib.gj_solve_f64 if M.dtype == torch.float64 else lib.gj_solve_f32
    stream = torch.cuda.current_stream(M.device).cuda_stream
    with torch.cuda.device(M.device):
        rc = fn(M.data_ptr(), out.data_ptr(), piv.data_ptr(), B, n, m,
                stream)
    if rc != 0:
        raise RuntimeError(f"gj_solve kernel launch failed: CUDA error {rc}")
    with _build.count_lock:
        if backward:
            launches_backward += 1
        else:
            launches += 1
    return out, piv


def _gj_step(M, i, idx):
    """One Gauss–Jordan step on ``M [B, n, m]``; returns the updated
    matrix and ``|pivot|`` [B]."""
    col = torch.abs(M[..., i])
    col = torch.where(idx < i, torch.full_like(col, -torch.inf), col)
    p = torch.argmax(col, dim=-1)                   # NaN counts as largest
    rp = torch.take_along_dim(M, p[:, None, None], dim=-2)[:, 0, :]
    ri = M[:, i, :]
    is_i = (idx == i)[:, None]
    is_p = (idx == p[:, None])[..., None]
    M = torch.where(is_i, rp[:, None, :],
                    torch.where(is_p, ri[:, None, :], M))
    piv = rp[:, i:i + 1]
    row = rp / piv
    fac = M[:, :, i:i + 1]
    M = torch.where(is_i, row[:, None, :], M - fac * row[:, None, :])
    return M, torch.abs(piv[:, 0])


def gj_solve_reference(M):
    """The plain PyTorch version of :func:`gj_solve` (any device)."""
    _check(M)
    n = M.shape[1]
    idx = torch.arange(n, device=M.device)
    pivs = []
    for i in range(n):
        M, pa = _gj_step(M, i, idx)
        pivs.append(pa)
    return M, torch.stack(pivs, dim=-1)
