"""The blocked Gauss–Jordan elimination of the BEM solve: CUDA kernels for
the pivot-tile inverse and the matrix products, their plain PyTorch
versions, and the staged composition.

- :func:`tile_inv` — Gauss–Jordan inverse with partial pivoting of one
  [n, n] pivot tile (n steps on ``[A | I]``), n <= ``MAX_TILE``; replaces
  the TPU kernel ``raft_tpu/pallas_kernels.py:208`` (``tile_inv_pallas``,
  with ``_tile_inv_kernel`` :184).  Kernel: ``csrc/tile_inv.cu``, one
  launch of one thread-block cluster holding the tile in place in its
  registers, factored panel by panel (``sm_90a``); plain version:
  :func:`tile_inv_reference`
  (the arithmetic of ``kernels/gj_solve.py``'s ``_gj_step`` on
  ``[A | I]``), bit for bit the same.
- :func:`mm` / :func:`mm_sub` — ``L @ R`` and the fused ``X - L @ R``;
  replace ``mm_pallas`` :253 and ``mm_sub_pallas`` :263 (``_mm_call``
  :235).  Kernel: ``csrc/mm.cu``, tensor-core products (three TF32
  passes for full float32 accuracy, DMMA in float64); plain versions:
  ``L @ R`` and ``X - L @ R``.
- :func:`gj_stage` — the mirror of ``gj_stage_pallas`` :498: ``nblk``
  elimination steps of ``block`` rows from block row ``kb0``, no pivoting
  between blocks; :func:`gj_stage_buffer` runs the same steps on an
  ``[A | b]`` buffer the caller holds (the streamed BEM solve's stages).
  A PyTorch loop over pivot blocks on one ``[A | b]`` buffer that calls
  the three functions above, one of each per step;
  apart from them it only slices, masks with ``torch.where`` and assigns
  slices.

A tensor on the card goes to the kernel, built with ``nvcc`` for
``sm_90a`` at first use into ``build/raft_tpu_torch/`` and loaded with
``ctypes``; a failed build or launch raises, there is no fallback.  A
tensor on the CPU goes to the plain version.

``launches`` counts each wrapper's kernel calls in this process: one per
tile inverted, one per product.
"""

import ctypes
import os
import threading

import torch

from raft_tpu_torch.kernels import _build
from raft_tpu_torch.kernels._build import BUILD_DIR, nvcc

TILE_INV_SOURCE = os.path.join(_build.CSRC, "tile_inv.cu")
MM_SOURCE = os.path.join(_build.CSRC, "mm.cu")
SOURCES = (TILE_INV_SOURCE, MM_SOURCE)
_HEADERS = {TILE_INV_SOURCE: (os.path.join(_build.CSRC, "gj_elim.cuh"),),
            MM_SOURCE: ()}
# the largest tile one thread-block cluster holds (csrc/tile_inv.cu); the
# BEM path's pivot block (bem_solver.GJ_BLOCK) is 512
MAX_TILE = 512
# gj_stage pads the right-hand sides of [A | b] to a multiple of this many
# columns, so every row is a multiple of 16 bytes (mm.cu's 16-byte copies)
RHS_ALIGN = 8

launches = {"tile_inv": 0, "mm": 0, "mm_sub": 0}
_local = threading.local()
_libs = {}

_VP, _INT, _LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_SIGNATURES = {
    "tile_inv": [_VP, _LONG, _VP, _VP, _VP, _INT, _VP],
    "mm": [_VP, _VP, _VP, _INT, _INT, _INT, _VP],
    "mm_sub": [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP],
}


def thread_launches():
    """This thread's share of ``launches``: the kernel calls made from
    the calling thread (a shard worker's own count)."""
    return dict(_local.__dict__.get("launches", dict.fromkeys(launches, 0)))


def reset_launches():
    """Set every kernel's launch count to 0."""
    for k in launches:
        launches[k] = 0


def start_build(verbose=False):
    """Start compiling ``csrc/tile_inv.cu`` and ``csrc/mm.cu`` together
    (see :func:`build`); returns the two jobs."""
    return [_build.start(src, _HEADERS[src], BUILD_DIR, nvcc(), verbose)
            for src in SOURCES]


def build(verbose=False, job=None):
    """Compile both sources (once per content of each and its headers)
    and load them; ``job`` is the pair started by :func:`start_build`.
    Returns ``{source: ctypes library}``; raises ``RuntimeError`` when a
    build fails.  ``verbose`` adds ``-Xptxas -v`` and prints the
    compiler's report of registers and spills."""
    if len(_libs) == len(SOURCES) and not verbose and job is None:
        return _libs
    with _build.lock:
        if len(_libs) == len(SOURCES) and not verbose and job is None:
            return _libs
        return _build_locked(verbose, job)


def _build_locked(verbose, job):
    jobs = job or start_build(verbose)
    libs = {j.source: _build.finish(j, verbose) for j in jobs}
    for src, names in ((TILE_INV_SOURCE, ("tile_inv",)),
                       (MM_SOURCE, ("mm", "mm_sub"))):
        for name in names:
            for suffix in ("f64", "f32"):
                fn = getattr(libs[src], f"{name}_{suffix}")
                fn.argtypes = _SIGNATURES[name]
                fn.restype = ctypes.c_int
    shape = libs[TILE_INV_SOURCE].tile_inv_shape
    shape.argtypes = [_INT, _INT, ctypes.POINTER(_INT), ctypes.POINTER(_INT)]
    shape.restype = ctypes.c_int
    _libs.update(libs)
    return _libs


def _kernel(source, name, dtype):
    lib = build()[source]
    return getattr(lib, f"{name}_{'f64' if dtype == torch.float64 else 'f32'}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_float(name, *ts):
    t0 = ts[0]
    for t in ts:
        if t.dim() != 2:
            raise ValueError(f"{name} takes 2-D tensors, got {tuple(t.shape)}")
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name} takes float32 or float64, got {t.dtype}")
        if t.dtype != t0.dtype or t.device != t0.device:
            raise ValueError(f"{name}: operands differ in dtype or device")
    if t0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {t0.device}")


def _launched(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    with _build.count_lock:
        launches[name] += 1
        mine = _local.__dict__.setdefault("launches",
                                          dict.fromkeys(launches, 0))
        mine[name] += 1


# ------------------------------------------------------------ tile inverse

def tile_inv(A):
    """Inverse of the square tile ``A [n, n]`` by Gauss–Jordan elimination
    with partial pivoting.  ``A`` may be a row-strided view (a block of a
    larger row-major matrix): its columns must be contiguous.  CPU tensors
    take the plain version, CUDA tensors the kernel, which raises when the
    card refuses its cluster launch."""
    _check_float("tile_inv", A)
    n = A.shape[0]
    if A.shape[1] != n or not 1 <= n <= MAX_TILE:
        raise ValueError(f"tile_inv takes a square tile of at most "
                         f"{MAX_TILE}, got {tuple(A.shape)}")
    if A.device.type == "cpu":
        return tile_inv_reference(A)
    if A.stride(1) != 1 or A.stride(0) < n:
        raise ValueError("tile_inv needs unit column stride")
    fn = _kernel(TILE_INV_SOURCE, "tile_inv", A.dtype)
    out = torch.empty((n, n), dtype=A.dtype, device=A.device)
    # the multipliers and pivot rows the panels publish, and their flags
    fac = torch.empty((n, n), dtype=A.dtype, device=A.device)
    ints = torch.empty(2 * MAX_TILE, dtype=torch.int32, device=A.device)
    with torch.cuda.device(A.device):
        rc = fn(A.data_ptr(), A.stride(0), out.data_ptr(), fac.data_ptr(),
                ints.data_ptr(), n, _stream(A))
    _launched("tile_inv", rc)
    return out


def tile_inv_launch_shape(n, dtype):
    """``(cluster size, dynamic shared memory bytes per CTA)`` of the
    kernel's launch for an [n, n] tile of ``dtype`` (builds the kernel)."""
    cluster, smem = _INT(), _INT()
    rc = build()[TILE_INV_SOURCE].tile_inv_shape(
        n, int(dtype == torch.float64), ctypes.byref(cluster),
        ctypes.byref(smem))
    if rc != 0:
        raise ValueError(f"tile_inv takes 1 <= n <= {MAX_TILE}, got {n}")
    return cluster.value, smem.value


def tile_inv_reference(A):
    """The plain PyTorch version of :func:`tile_inv`: n Gauss–Jordan steps
    on ``[A | I]``, returning the right half.

    It is ``kernels/gj_solve.py``'s plain elimination
    (:func:`~raft_tpu_torch.kernels.gj_solve.gj_solve_reference`, which
    only takes n <= 16) on ``[1, n, 2n]``, with the same arithmetic: pivot
    by ``torch.argmax`` of the column's magnitudes, NaN largest and first
    index on ties; IEEE division; the update rounded as a product and then
    a difference.  It differs in one way, for speed on the CPU, where the
    tests run it on 512-row tiles: step i updates only the columns from i
    on and swaps rows in place, instead of masking every column with
    ``torch.where`` (several times slower there).  The columns left of i
    hold unit columns that no later step reads, so for finite input the
    result has the same bits
    (``tests/test_torch_bem_kernels.py`` pins that)."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    M = torch.cat([A, eye], dim=1)
    for i in range(n):
        p = i + int(torch.argmax(torch.abs(M[i:, i])))
        if p != i:
            M[[i, p]] = M[[p, i]]
        row = M[i, i:] / M[i, i]
        fac = M[:, i].clone()
        M[:, i:] -= torch.outer(fac, row)
        M[i, i:] = row
    return M[:, n:].contiguous()


# ---------------------------------------------------------------- products

def _check_mm(name, L, R, X=None):
    ops = (L, R) if X is None else (X, L, R)
    _check_float(name, *ops)
    M, K = L.shape
    if R.shape[0] != K:
        raise ValueError(f"{name}: L {tuple(L.shape)} @ R {tuple(R.shape)}")
    if X is not None and X.shape != (M, R.shape[1]):
        raise ValueError(f"{name}: X {tuple(X.shape)} is not "
                         f"{(M, R.shape[1])}")
    if L.device.type == "cuda" and not all(t.is_contiguous() for t in ops):
        raise ValueError(f"{name} needs contiguous operands")


def mm(L, R):
    """``L [M, K] @ R [K, N]``.  CPU tensors take the plain version, CUDA
    tensors the kernel."""
    _check_mm("mm", L, R)
    if L.device.type == "cpu":
        return mm_reference(L, R)
    M, K = L.shape
    N = R.shape[1]
    fn = _kernel(MM_SOURCE, "mm", L.dtype)
    out = torch.empty((M, N), dtype=L.dtype, device=L.device)
    with torch.cuda.device(L.device):
        rc = fn(L.data_ptr(), R.data_ptr(), out.data_ptr(), M, N, K,
                _stream(L))
    _launched("mm", rc)
    return out


def mm_sub(X, L, R):
    """``X [M, N] - L [M, K] @ R [K, N]``, the product never stored.  CPU
    tensors take the plain version, CUDA tensors the kernel."""
    _check_mm("mm_sub", L, R, X)
    if L.device.type == "cpu":
        return mm_sub_reference(X, L, R)
    M, K = L.shape
    N = R.shape[1]
    fn = _kernel(MM_SOURCE, "mm_sub", L.dtype)
    out = torch.empty((M, N), dtype=L.dtype, device=L.device)
    with torch.cuda.device(L.device):
        rc = fn(X.data_ptr(), L.data_ptr(), R.data_ptr(), out.data_ptr(), M,
                N, K, _stream(L))
    _launched("mm_sub", rc)
    return out


def mm_reference(L, R):
    """The plain version of :func:`mm` (any device)."""
    return L @ R


def mm_sub_reference(X, L, R):
    """The plain version of :func:`mm_sub` (any device)."""
    return X - L @ R


# ----------------------------------------------------------- blocked stage

def gj_stage(A, b, kb0, nblk, block=512):
    """``nblk`` consecutive steps, from block row ``kb0``, of the blocked
    Gauss–Jordan elimination of ``(A [n, n], b [n, m])``, ``n`` a multiple
    of ``block``.  Each step inverts the pivot tile, scales the pivot
    block row by it and eliminates the block column from every other row;
    rows pivot only inside each tile (the BEM boundary operator keeps
    every leading Schur complement invertible).  Returns the new
    ``(A, b)``; after all ``n / block`` steps ``b`` holds the solution.
    Two stages ``(0, k)`` then ``(k, n/block - k)`` compose to the whole
    elimination.  The inputs are not modified.

    The stage holds ``[A | b]`` as one ``[n, n + m_pad]`` buffer
    (:func:`gj_buffer`) and runs :func:`gj_stage_buffer` on it.  ``A`` and
    ``b`` come back as views of the buffer."""
    n, m = A.shape[0], b.shape[1]
    Ab = gj_stage_buffer(gj_buffer(A, b), n, kb0, nblk, block)
    return Ab[:, :n], Ab[:, n:n + m]


def gj_buffer(A, b):
    """``[A | b | 0]``: ``b`` zero-padded to a multiple of ``RHS_ALIGN``
    columns (zero columns stay zero through every step)."""
    m = b.shape[1]
    pad = torch.zeros((A.shape[0], -m % RHS_ALIGN), dtype=A.dtype,
                      device=A.device)
    return torch.cat([A, b, pad], dim=1)                   # [n, n + m_pad]


def gj_stage_buffer(Ab, n, kb0, nblk, block=512):
    """The steps of :func:`gj_stage` on a buffer ``Ab [n, n + m_pad]`` the
    caller already holds, so a staged elimination builds ``[A | b]`` once
    rather than once per stage.  Returns the buffer after the steps (each
    step's ``mm_sub`` writes a new one; ``Ab`` itself is not modified).

    Each step makes one ``mm`` (``Dinv @ [D | Db]``) and one ``mm_sub``
    where ``gj_stage_pallas`` makes two of each.  A kernel sums each
    output element in the same order whatever the width, so on the card
    the bits are those of the separate products; on the CPU the BLAS may
    block a wider product otherwise (round-off)."""
    if n % block or Ab.shape[0] != n:
        raise ValueError(f"gj_stage: n = {n} is not a multiple of {block} "
                         f"rows of a {tuple(Ab.shape)} buffer")
    rowidx = torch.arange(n, device=Ab.device)
    for kb in range(int(kb0), int(kb0) + int(nblk)):
        k0 = kb * block
        Dinv = tile_inv(Ab[k0:k0 + block, k0:k0 + block])
        row = mm(Dinv, Ab[k0:k0 + block])                   # [block, n + m_pad]
        mask = ((rowidx >= k0) & (rowidx < k0 + block))[:, None]
        C = torch.where(mask, 0.0, Ab[:, k0:k0 + block])    # [n, block]
        Ab = mm_sub(Ab, C, row)
        Ab[k0:k0 + block] = row
    return Ab
