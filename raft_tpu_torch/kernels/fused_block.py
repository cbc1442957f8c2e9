"""One fused block of the drag-linearization fixed point: the CUDA kernel
of the waterfall's ``fused`` mode and its plain PyTorch version.

:func:`fused_block` runs K gated fixed-point trips of every (design x
case) lane, with the signature and the state of the waterfall's torch
block program (raft_tpu_torch/waterfall.py), so the waterfall drives
either one unchanged:

    fused_block(nodes, u, C, M, B, Fr, Fi, state, *, w, dw, rho, relax,
                nIter, K) -> state

nodes : HydroNodes, shared [N, ...] or per-lane [L, N, ...]
u     : [L, N, 3, W] complex wave velocity at the nodes
C     : [L, 6, 6];  M, B : [L, W, 6, 6];  Fr, Fi : [L, W, 6]
state : (i [L] int64, XiNext, XiPoint, Xi_lastfinite [L, 6, W] complex,
         done [L] bool, froze [L] bool)

It replaces the TPU kernel ``raft_tpu/pallas_kernels.py:428``
(``fused_block_fn``, with ``_fused_fp_kernel`` :275 and ``_lane_spec``
:420).

- A tensor on the card goes to the kernel in ``csrc/fused_block.cu``,
  built with ``nvcc`` for ``sm_90a`` at first use into
  ``build/raft_tpu_torch/`` and loaded with ``ctypes``.  Each lane is one
  thread-block cluster whose CTAs split the frequencies
  (:func:`launch_shape`), so the launch needs ``sm_90a`` (an H100 or
  later).  A failed build or launch raises; there is no fallback.  The
  kernel takes N <= 512 nodes and W <= 256 frequencies in float32 or
  float64; anything else raises ``ValueError``.
- A tensor on the CPU goes to :func:`fused_block_reference`, the plain
  version of the same K trips in the same split real/imaginary form.

The arithmetic is the full-precision baseline only: the waterfall
refuses the fused mode under mixed precision.

``launches`` counts the kernel's launches in this process.
"""

import ctypes
import math
import os

import torch

from raft_tpu_torch.dynamics import TOL
from raft_tpu_torch.kernels import _build
from raft_tpu_torch.kernels._build import BUILD_DIR, nvcc
from raft_tpu_torch.kernels.gj_solve import gj_solve_reference
from raft_tpu_torch.utils.frames import cross, translate_matrix_3to6

SOURCES = (os.path.join(_build.CSRC, "fused_block.cu"),)
HEADERS = (os.path.join(_build.CSRC, "gj_elim.cuh"),)
MAX_NODES = 512
MAX_W = 256

launches = 0
_lib = None
_INT = ctypes.c_int

_NODE_FIELDS = ("r", "q", "qMat", "p1Mat", "p2Mat", "a_q", "a_p1", "a_p2",
                "a_end_abs", "Cd_q", "Cd_p1", "Cd_p2", "Cd_End",
                "submerged")


def lane_iteration_flops(n_submerged, nw):
    """Operations of one fixed-point trip of one lane with ``n_submerged``
    submerged strip nodes (the only ones drag acts on; the kernel skips
    the others) and ``nw`` frequencies, counted from the algorithm (each
    addition, multiplication, division and square root is one):

    - 135 per submerged node and frequency: node motion, relative
      velocity and the three RMS sums (75), the drag force and its moment
      (60);
    - 240 per submerged node: the RMS roots, the drag coefficients, Bmat
      and its 3->6 transform into B_drag;
    - 3745 per frequency: the impedance (145), the right-hand side (12)
      and the 12x13 Gauss-Jordan elimination (12 steps of 13 divisions
      and 11 x 13 multiply-subtracts: 3588);
    - 90 per frequency: the convergence test and the relaxed update of
      the 6 amplitudes.
    """
    return 135 * n_submerged * nw + 240 * n_submerged + 3835 * nw


def start_build(verbose=False):
    """Start compiling ``csrc/fused_block.cu`` (see :func:`build`)."""
    return _build.start(SOURCES[0], HEADERS, BUILD_DIR, nvcc(), verbose)


def build(verbose=False, job=None):
    """Compile ``csrc/fused_block.cu`` (once per content of it and of
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
        for name in ("fused_block_f64", "fused_block_f32"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                           ctypes.POINTER(ctypes.c_void_p),
                           _INT, _INT, _INT, _INT, ctypes.c_double,
                           ctypes.c_double, ctypes.c_double, ctypes.c_double,
                           ctypes.c_double, _INT, _INT, ctypes.c_void_p]
            fn.restype = _INT
        lib.fused_block_shape.argtypes = [_INT, _INT, _INT,
                                          *(ctypes.POINTER(_INT),) * 3]
        lib.fused_block_shape.restype = _INT
        _lib = lib
        return lib


def launch_shape(N, W, dtype):
    """``(cluster size G, frequencies per CTA, dynamic shared memory bytes
    per CTA)`` of the kernel's launch for ``N`` nodes and ``W``
    frequencies in ``dtype`` (builds the kernel); a call launches G CTAs
    per lane."""
    g, f, smem = _INT(), _INT(), _INT()
    rc = build().fused_block_shape(N, W, int(dtype == torch.float64),
                                   ctypes.byref(g), ctypes.byref(f),
                                   ctypes.byref(smem))
    if rc != 0:
        raise ValueError(f"the fused kernel takes 1 <= N <= {MAX_NODES} and "
                         f"1 <= W <= {MAX_W}, got N={N}, W={W}")
    return g.value, f.value, smem.value


def _shared_nodes(nodes, L):
    """True for a bundle shared by every lane ([N, ...]), False for a
    per-lane one ([L, N, ...]); raises for anything else."""
    if nodes.r.dim() == 2:
        return True
    if nodes.r.dim() == 3 and nodes.r.shape[0] == L:
        return False
    raise ValueError(
        f"nodes.r must be [N, 3] or [{L}, N, 3], got {tuple(nodes.r.shape)}")


def _check(nodes, u, C, M, B, Fr, Fi, state, w):
    """Shapes and dtypes of one block call; returns whether the node
    bundle is shared."""
    if u.dim() != 4 or u.shape[2] != 3 or not u.is_complex():
        raise ValueError(f"u must be complex [L, N, 3, W], got "
                         f"{tuple(u.shape)} {u.dtype}")
    L, N, _, W = u.shape
    real = u.real.dtype
    if real not in (torch.float32, torch.float64):
        raise ValueError(f"fused_block takes float32 or float64, got {real}")
    shapes = {"C": (C, (L, 6, 6)), "M": (M, (L, W, 6, 6)),
              "B": (B, (L, W, 6, 6)), "Fr": (Fr, (L, W, 6)),
              "Fi": (Fi, (L, W, 6)), "w": (w, (W,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != real:
            raise ValueError(f"{name} must be {real} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    it, xn, xp, xf, dn, fz = state
    for name, t, shape, dtype in (
            ("i", it, (L,), torch.int64), ("XiNext", xn, (L, 6, W), u.dtype),
            ("XiPoint", xp, (L, 6, W), u.dtype),
            ("Xi", xf, (L, 6, W), u.dtype), ("done", dn, (L,), torch.bool),
            ("froze", fz, (L,), torch.bool)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"state {name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    shared = _shared_nodes(nodes, L)
    lead = (N,) if shared else (L, N)
    for name in _NODE_FIELDS:
        t = getattr(nodes, name)
        if tuple(t.shape[:len(lead)]) != lead:
            raise ValueError(f"nodes.{name} must lead with {lead}, got "
                             f"{tuple(t.shape)}")
        want = torch.bool if name == "submerged" else real
        if t.dtype != want:
            raise ValueError(f"nodes.{name} must be {want}, got {t.dtype}")
    return shared


def fused_block(nodes, u, C, M, B, Fr, Fi, state, *, w, dw, rho, relax,
                nIter, K):
    """K gated fixed-point trips of every lane (see the module
    docstring).  CPU tensors take the plain version, CUDA tensors the
    kernel.  ``w`` is the [W] frequency grid in the working dtype, ``dw``
    its spacing, ``rho`` the water density, ``relax`` the new-iterate
    weight of the relaxed update, ``nIter`` the iteration limit (a lane
    runs while ``i < nIter + 1``); the convergence tolerance is
    ``dynamics.TOL``."""
    global launches
    if u.device.type == "cpu":
        return fused_block_reference(nodes, u, C, M, B, Fr, Fi, state, w=w,
                                     dw=dw, rho=rho, relax=relax,
                                     nIter=nIter, K=K)
    if u.device.type != "cuda":
        raise ValueError(f"fused_block runs on cuda or cpu, not {u.device}")
    shared = _check(nodes, u, C, M, B, Fr, Fi, state, w)
    L, N, _, W = u.shape
    if N > MAX_NODES or W > MAX_W:
        raise ValueError(
            f"the fused kernel was built for N <= {MAX_NODES} nodes and "
            f"W <= {MAX_W} frequencies, got N={N}, W={W}")
    ins = (w, *(getattr(nodes, f) for f in _NODE_FIELDS), u, C, M, B, Fr,
           Fi, *state)
    for t in ins:
        if t.device != u.device or not t.is_contiguous():
            raise ValueError("fused_block needs contiguous operands on "
                             f"{u.device}")
    lib = build()
    outs = tuple(torch.empty_like(t) for t in state)
    in_ptrs = (ctypes.c_void_p * len(ins))(*(t.data_ptr() for t in ins))
    out_ptrs = (ctypes.c_void_p * len(outs))(*(t.data_ptr() for t in outs))
    fn = lib.fused_block_f64 if u.dtype == torch.complex128 \
        else lib.fused_block_f32
    stream = torch.cuda.current_stream(u.device).cuda_stream
    with torch.cuda.device(u.device):
        rc = fn(in_ptrs, out_ptrs, L, N, W, int(not shared), float(dw),
                _c_drag(rho), TOL, float(relax),
                round(1.0 - float(relax), 12), int(nIter), int(K), stream)
    if rc != 0:
        raise RuntimeError(f"fused_block kernel launch failed: CUDA error "
                           f"{rc}")
    with _build.count_lock:
        launches += 1
    return outs


def _c_drag(rho):
    return math.sqrt(8.0 / math.pi) * 0.5 * float(rho)


def _rms_sums(*terms):
    """Each [..., N, 3, W] term summed over its components and frequencies:
    the three per-node sums under the RMS velocities."""
    return tuple(torch.sum(t, dim=(-2, -1)) for t in terms)


def _fp_step(nodes, ur, ui, C, M, B, Flr, Fli, w, dw, c_drag, XLr, XLi):
    """One fixed-point solve at the linearization point XL [L, 6, W] in
    split real/imaginary arithmetic; returns the new iterate (re, im)."""
    r = nodes.r                                 # [(L,) N, 3]
    q = nodes.q
    m3 = nodes.submerged[..., None, None]       # [(L,) N, 1, 1]
    p1_sq = torch.diagonal(nodes.p1Mat, dim1=-2, dim2=-1)
    p2_sq = torch.diagonal(nodes.p2Mat, dim1=-2, dim2=-1)
    r0, r1, r2 = (r[..., i, None] for i in range(3))    # [(L,) N, 1]

    def cross_rth(th):                          # [L, 3, W] -> [L, N, 3, W]
        t0, t1, t2 = (th[:, None, i] for i in range(3))
        return torch.stack([t2 * (-r1) + t1 * r2, t2 * r0 - t0 * r2,
                            -t1 * r0 + t0 * r1], dim=-2)

    zero = torch.zeros((), dtype=ur.dtype, device=ur.device)
    drr = XLr[:, None, :3] + cross_rth(XLr[:, 3:])
    dri = XLi[:, None, :3] + cross_rth(XLi[:, 3:])
    # v = u - i w dr on submerged nodes
    vrr = torch.where(m3, ur - (-w * dri), zero)
    vri = torch.where(m3, ui - (w * drr), zero)
    cq_r = vrr * q[..., None]
    cq_i = vri * q[..., None]
    abs2 = vrr * vrr + vri * vri
    sq, s1, s2 = _rms_sums(cq_r * cq_r + cq_i * cq_i,
                           abs2 * p1_sq[..., None], abs2 * p2_sq[..., None])
    vRMS_q = torch.sqrt(sq * dw)
    vRMS_p1 = torch.sqrt(s1 * dw)
    vRMS_p2 = torch.sqrt(s2 * dw)
    Bq = c_drag * vRMS_q * nodes.a_q * nodes.Cd_q
    Bp1 = c_drag * vRMS_p1 * nodes.a_p1 * nodes.Cd_p1
    Bp2 = c_drag * vRMS_p2 * nodes.a_p2 * nodes.Cd_p2
    Bend = c_drag * vRMS_q * nodes.a_end_abs * nodes.Cd_End
    Bmat = ((Bq + Bend)[..., None, None] * nodes.qMat
            + Bp1[..., None, None] * nodes.p1Mat
            + Bp2[..., None, None] * nodes.p2Mat)         # [L, N, 3, 3]
    B_drag = torch.sum(torch.where(m3, translate_matrix_3to6(Bmat, r), zero),
                       dim=-3)                             # [L, 6, 6]

    def sum_force(u_part):
        f3 = torch.einsum("...nij,...njw->...niw", Bmat, u_part)
        fw = torch.where(m3, f3, zero).movedim(-1, -2)   # [L, N, W, 3]
        mom = cross(r[..., None, :], fw)
        return torch.cat([fw.sum(dim=-3), mom.sum(dim=-3)], dim=-1)

    w2 = (w * w)[:, None, None]
    Zr = -w2 * M + C[:, None]
    Zi = w[:, None, None] * (B + B_drag[:, None])
    FR = sum_force(ur) + Flr
    FI = sum_force(ui) + Fli
    A = torch.cat([torch.cat([Zr, -Zi], dim=-1),
                   torch.cat([Zi, Zr], dim=-1)], dim=-2)   # [L, W, 12, 12]
    rhs = torch.cat([FR, FI], dim=-1)[..., None]
    Maug = torch.cat([A, rhs], dim=-1)                     # [L, W, 12, 13]
    L, W = Maug.shape[:2]
    x = gj_solve_reference(Maug.reshape(L * W, 12, 13))[0][:, :, 12]
    x = x.reshape(L, W, 12)
    return x[..., :6].transpose(-1, -2), x[..., 6:].transpose(-1, -2)


def fused_block_reference(nodes, u, C, M, B, Fr, Fi, state, *, w, dw, rho,
                          relax, nIter, K):
    """The plain PyTorch version of :func:`fused_block` (any device): the
    same K gated trips in split real/imaginary arithmetic."""
    _check(nodes, u, C, M, B, Fr, Fi, state, w)
    c_drag = _c_drag(rho)
    w_old = round(1.0 - float(relax), 12)
    it, xn, xp, xf, dn, fz = state
    s = [it, xn.real, xn.imag, xp.real, xp.imag, xf.real, xf.imag, dn, fz]
    ur, ui = u.real, u.imag
    for _ in range(int(K)):
        it, xnr, xni, _, _, xfr, xfi, dn, fz = s
        run = (it < nIter + 1) & ~dn
        Xr, Xj = _fp_step(nodes, ur, ui, C, M, B, Fr, Fi, w, dw, c_drag,
                          xnr, xni)
        finite = (torch.isfinite(Xr).all(-1).all(-1)
                  & torch.isfinite(Xj).all(-1).all(-1))
        num = torch.sqrt((Xr - xnr) * (Xr - xnr) + (Xj - xni) * (Xj - xni))
        den = torch.sqrt(Xr * Xr + Xj * Xj) + TOL
        conv = (num / den < TOL).all(-1).all(-1)          # NaN compares False
        newdone = conv | ~finite
        nd3, fin3 = newdone[:, None, None], finite[:, None, None]
        new = (it + 1,
               torch.where(nd3, xnr, w_old * xnr + relax * Xr),
               torch.where(nd3, xni, w_old * xni + relax * Xj),
               xnr, xni,
               torch.where(fin3, Xr, xfr), torch.where(fin3, Xj, xfi),
               dn | newdone, fz | ~finite)
        s = [torch.where(run.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)
             for n, o in zip(new, s)]
    it, xnr, xni, xpr, xpi, xfr, xfi, dn, fz = s
    # contiguous, like the kernel's outputs, so either can feed the other
    return (it, torch.complex(xnr, xni).contiguous(),
            torch.complex(xpr, xpi).contiguous(),
            torch.complex(xfr, xfi).contiguous(), dn, fz)
