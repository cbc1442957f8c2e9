"""Native first-order radiation/diffraction panel solver (HAMS equivalent)
— the port of ``raft_tpu/bem_solver.py``.

  * constant-strength source panels on the wetted hull (meshed by
    raft_tpu_torch/mesh.py),
  * free-surface Green function G = 1/r + 1/r' + Gw: the Rankine part
    1/r + 1/r' (+ the seabed image at finite depth) once per mesh on the
    host in float64 (:func:`_rankine`), the wave term Gw per frequency on
    the solve's device (raft_tpu_torch/greens.py),
  * body boundary condition  sigma/2 + K sigma = v_n,
  * added mass A(w), radiation damping B(w) about the PRP from the
    radiation potentials, and wave excitation X(w, beta) from the
    diffraction solve.

Two forms of the solve, chosen by ``backend``, and a device, chosen by
``device`` (the JAX package's ``backend`` mixes the two):

  * ``backend="cuda"`` — the card form (the JAX package's ``"tpu"``
    form): the mesh is padded to a multiple of 256 panels, the wave term
    is the table-free Chebyshev evaluation assembled in row blocks, and
    the dense complex system is solved as the real 2N x 2N block system,
    by the blocked Gauss–Jordan elimination of
    raft_tpu_torch/kernels/bem_gj.py above ``BLOCKED_GJ_MIN_PANELS``
    panels (its pivot-tile inverse and matrix products are hand-written
    CUDA kernels on the card, their plain versions on the CPU), else by a
    dense real solve;
  * ``backend="cpu"`` — the CPU form: bilinear wave-term tables and the
    complex LU solve.

``device`` defaults to ``cuda`` for the card form and ``cpu`` for the CPU
form; ``backend=None`` is the card form on the card.  The working dtype
is float32 / complex64, as in the JAX package; the Rankine part is
float64 on the host, cast once.

Irregular frequencies are removed by the extended-boundary-condition
method (interior waterplane lid panels at z = 0 joining the system with
the ``LID_JUMP`` diagonal).  Finite water depth is deep water + John's
finite-depth difference: a seabed-image Rankine term plus the
pole-subtracted quadrature correction of the wave term
(greens.finite_depth_correction) and the cosh-profile incident wave.

Card-form meshes above ``STREAM_PANEL_LIMIT`` panels take the streamed
out-of-core path (:func:`_run_streamed`): per frequency the assembly in
row bands and the elimination in stages, with a host sync after each,
bit for bit the direct path's result.  ``report_cost=True`` adds
``flops``, the operation count of :func:`solve_cost` (the JAX package
reads XLA's compiled cost; the port counts its own).

Over a device list (``devices=`` or ``n_devices=`` > 1) the frequency
batch is sharded (:func:`_run_sharded`), one worker per entry
(``utils.placement.DeviceWorkers``), by the JAX package's rule: the
frequencies (``freq``), or when they alone underfill the list the
flattened frequency x heading pairs (``freqbeta``); each shard runs the
single-device solve of its frequencies, so ``freq`` gives the
single-device bits.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

from raft_tpu_torch import greens
from raft_tpu_torch.kernels.bem_gj import (
    RHS_ALIGN,
    gj_buffer,
    gj_stage,
    gj_stage_buffer,
    thread_launches,
)
from raft_tpu_torch.trace import maybe_span
from raft_tpu_torch.utils.placement import (
    DeviceWorkers,
    resolve_device,
    resolve_devices,
)
from raft_tpu_torch.utils.profiling import logger

_G_GAUSS = np.array([-1.0 / np.sqrt(3.0), 1.0 / np.sqrt(3.0)])
_PI = math.pi
_F32 = torch.float32
_C64 = torch.complex64

# The blocked Gauss-Jordan takes over from the dense solve for card-form
# systems of more than BLOCKED_GJ_MIN_PANELS panels whose 2N rows are a
# multiple of GJ_BLOCK (the padding to 256 panels guarantees it), as in
# the JAX package's device form.
BLOCKED_GJ_MIN_PANELS = 1024
GJ_BLOCK = 512

# Card-form meshes above this many panels (before padding) take the
# streamed out-of-core path (_run_streamed).  The limit is the JAX
# package's, so both packages take the same path on the same mesh.  On
# this card it is not a memory bound: the direct path at 10496 padded
# panels peaked at 9.94 GiB of the card's 80 GB, and the streamed path
# was no faster there (chip_smoke.py phase 36, NVIDIA H100 80GB HBM3,
# 700.00 W).  ROADMAP.md queue 3 item 35: derive the limit from the
# direct path's ~96 N^2 bytes against the card's memory.
STREAM_PANEL_LIMIT = 10240

# The streamed path's plan, in this card's numbers (NVIDIA H100 80GB HBM3,
# 700.00 W).  The wave-term assembly of one frequency at 2560 panels took
# 1.6-2.2 s at 200 m depth (chip_smoke.py phase 13, the run_bem table of
# docs/torch_port.md section 5); the plan takes the upper end and scales
# it as N^2.  The elimination rate is the f32 mm + mm_sub of one step at
# 2N = 5120 (2.69e9 + 2.69e10 operations in 0.06621 + 0.49014 ms,
# chip_smoke.py phase 12, the kernel table of docs/torch_port.md section
# 6): 53 TFLOP/s.
_ASSEMBLY_S_AT_2560 = 2.2
_GJ_FLOPS_PER_S = 53e12
# Device seconds between two host syncs of the streamed path: one band of
# the assembly, or one stage of the elimination, per sync.  The card has
# no watchdog; the bands bound how long the host waits on the card before
# it runs again (a timer reads, a signal handler runs, a fault shows in
# the band that caused it).  They do not bound the peak device memory:
# every band writes into the preallocated [N, N] matrices, and the
# assembly's temporaries are one row block's (_ROW_BLOCK_POINTS) whatever
# the band.  At 10496 panels in deep water (chip_smoke.py phase 36, its
# first run in docs/torch_port.md section 6, NVIDIA H100 80GB HBM3,
# 700.00 W) the plan gives 41 bands and the frequency took 4.59 s of
# device time (the plan's N^2 scaling of a finite-depth figure expects
# 37 s), so a sync came every ~0.1 s; the peak was 6.65 GiB against the
# direct path's 9.94 GiB.  Tests shrink the budget to force many bands
# and stages.
STREAM_BAND_BUDGET_S = 5.0

# Row block of the card form's assembly: the Chebyshev basis temporaries
# are [rows * N * Q, deg + 1]; rows are chosen so rows * N * Q stays under
# this many pair points (~1 GB per float32 basis at degree 56).
_ROW_BLOCK_POINTS = 4.5e6


@dataclass
class PanelArrays:
    """Static panel geometry staged for device assembly."""

    cen: np.ndarray    # [N,3] collocation points (centroids)
    nrm: np.ndarray    # [N,3] outward normals (into fluid)
    area: np.ndarray   # [N]
    qpts: np.ndarray   # [N,Q,3] source-panel quadrature points
    qwts: np.ndarray   # [N,Q] quadrature weights (sum = area)

    @property
    def n(self):
        return len(self.area)


def panel_arrays(panels, quad="gauss"):
    """Build PanelArrays from [npan,4,3] vertex panels with 2x2 Gauss
    quadrature on the bilinear patch (exact for planar quads; robust for
    the clip-degenerate triangles).

    quad="centroid" builds single-point (centroid x area) quadrature;
    solve_bem uses it only for the smooth per-frequency wave term (the
    near-singular Rankine assembly always keeps the 2x2 Gauss points).
    """
    from raft_tpu_torch.mesh import panel_geometry

    p = np.asarray(panels, float)
    cen, nrm, area = panel_geometry(p)
    if quad == "centroid":
        return PanelArrays(cen=cen, nrm=nrm, area=area,
                           qpts=cen[:, None, :], qwts=area[:, None])
    if quad != "gauss":
        raise ValueError(f"unknown quad {quad!r} (use 'gauss' or 'centroid')")
    a, b, c, d = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    qpts = np.empty((len(p), 4, 3))
    qwts = np.empty((len(p), 4))
    k = 0
    for u in _G_GAUSS:
        for v in _G_GAUSS:
            Nu = np.array([(1 - u) * (1 - v), (1 + u) * (1 - v),
                           (1 + u) * (1 + v), (1 - u) * (1 + v)]) / 4.0
            pt = (Nu[0, None] * a.T + Nu[1, None] * b.T
                  + Nu[2, None] * c.T + Nu[3, None] * d.T).T
            # Jacobian of the bilinear map at (u, v)
            dPu = ((-(1 - v)) * a + (1 - v) * b + (1 + v) * c
                   - (1 + v) * d) / 4.0
            dPv = ((-(1 - u)) * a - (1 + u) * b + (1 + u) * c
                   + (1 - u) * d) / 4.0
            J = np.linalg.norm(np.cross(dPu, dPv), axis=1)
            qpts[:, k] = pt
            qwts[:, k] = J  # Gauss weight 1x1 per point in 2x2 rule
            k += 1
    # normalize so weights sum exactly to the panel area
    scale = area / np.maximum(qwts.sum(axis=1), 1e-30)
    qwts *= scale[:, None]
    return PanelArrays(cen=cen, nrm=nrm, area=area, qpts=qpts, qwts=qwts)


def _concat_panel_arrays(pa, pb):
    """Concatenate two PanelArrays along the panel axis."""
    return PanelArrays(
        cen=np.concatenate([pa.cen, pb.cen]),
        nrm=np.concatenate([pa.nrm, pb.nrm]),
        area=np.concatenate([pa.area, pb.area]),
        qpts=np.concatenate([pa.qpts, pb.qpts]),
        qwts=np.concatenate([pa.qwts, pb.qwts]),
    )


def pad_panel_arrays(pa, multiple=256):
    """Pad a PanelArrays to the next multiple of ``multiple`` with exactly
    inert dummy entries: zero area, zero quadrature weight, zero normal,
    collocation/quadrature points parked far from the hull at mid-draft.

    Zero normals null the dummy rows' influence integrals and radiation /
    diffraction right-hand sides (their equations reduce to
    -sigma/2 = 0), zero weights null their columns, and zero areas null
    their contribution to every output integral — so padding changes the
    coefficients only through floating-point summation of explicit
    zeros.  The card form pads to give the blocked solve its 512-row
    block multiple."""
    n = pa.n
    nb = -(-n // multiple) * multiple
    if nb == n:
        return pa
    pad = nb - n
    span = float(np.max(np.abs(pa.cen[:, :2]))) if n else 1.0
    z_mid = min(-1.0, 0.5 * float(np.min(pa.cen[:, 2])))
    far = np.array([50.0 * max(span, 1.0), 0.0, z_mid])
    Q = pa.qpts.shape[1]
    return PanelArrays(
        cen=np.concatenate([pa.cen, np.tile(far, (pad, 1))]),
        nrm=np.concatenate([pa.nrm, np.zeros((pad, 3))]),
        area=np.concatenate([pa.area, np.zeros(pad)]),
        qpts=np.concatenate([pa.qpts, np.tile(far, (pad, Q, 1))]),
        qwts=np.concatenate([pa.qwts, np.zeros((pad, Q))]),
    )


def _rankine(pa, dtype=np.float64, depth=np.inf, lid_mask=None):
    """Frequency-independent Rankine + image influence matrices (host,
    once per mesh).

    S0[i,j] = int_j (1/r + 1/r') dS,   K0[i,j] = int_j d/dn_i (1/r + 1/r') dS

    Off-diagonal by source-panel quadrature; the self 1/r potential uses
    the equivalent-disc closed form int 1/r dS = 2 sqrt(pi A), and the
    flat-panel self normal-gradient principal value is zero (the 1/2 jump
    term appears explicitly in the boundary condition).

    At finite ``depth`` the seabed image 1/r2 (source mirrored across
    z = -h) joins the static part.
    """
    x = pa.cen.astype(dtype)
    n = pa.nrm.astype(dtype)
    y = pa.qpts.astype(dtype)
    w = pa.qwts.astype(dtype)
    N = pa.n

    # row-chunked assembly: the [chunk,N,Q,3] pairwise temp stays bounded
    # (~0.8 GB at f64) however large the mesh gets
    Q = y.shape[1]
    chunk = max(1, int(3.2e7 // max(N * Q, 1)))

    def img(yq):
        S = np.empty((N, N), dtype)
        K = np.empty((N, N), dtype)
        for i0 in range(0, N, chunk):
            i1 = min(i0 + chunk, N)
            dxi = x[i0:i1, None, None, :] - yq[None, :, :, :]  # [c,N,Q,3]
            ri = np.maximum(np.sqrt(np.sum(dxi * dxi, axis=-1)), 1e-9)
            S[i0:i1] = np.sum(w[None] / ri, axis=-1)
            K[i0:i1] = -np.sum(
                w[None] * np.einsum("ijqk,ik->ijq", dxi, n[i0:i1]) / ri**3,
                axis=-1,
            )
        return S, K

    S_r, K_r = img(y)
    yi = y.copy()
    yi[:, :, 2] *= -1.0                                   # free-surface image
    S_i, K_i = img(yi)

    idx = np.arange(N)
    S_r[idx, idx] = 2.0 * np.sqrt(np.pi * pa.area)
    K_r[idx, idx] = 0.0
    if lid_mask is not None and np.any(lid_mask):
        # the free-surface image of a z=0 lid panel IS the panel: its
        # image-self entry takes the same closed-form potential and the
        # flat-panel zero PV
        li = np.where(lid_mask)[0]
        S_i[li, li] = 2.0 * np.sqrt(np.pi * pa.area[li])
        K_i[li, li] = 0.0
    S0, K0 = S_r + S_i, K_r + K_i
    if np.isfinite(depth):
        yb = y.copy()
        yb[:, :, 2] = -2.0 * depth - yb[:, :, 2]          # seabed image
        S_b, K_b = img(yb)
        S0 += S_b
        K0 += K_b
    return S0, K0


def _radiation_normals(pa):
    """v[k, i]: normal velocity on panel i for unit velocity in DOF k
    about the PRP (origin): n for surge/sway/heave, (r x n) for
    roll/pitch/yaw."""
    rxn = np.cross(pa.cen, pa.nrm)
    return np.concatenate([pa.nrm.T, rxn.T], axis=0)  # [6, N]


def _blocked_gj(A, b, block=GJ_BLOCK):
    """Solve ``A x = b`` for a well-conditioned dense real system by
    blocked Gauss-Jordan elimination: per-step pivot-tile inversion and
    full-matrix product updates, no pivoting between blocks (valid
    because the BEM boundary operator -1/2 I + K/4pi is a compact
    perturbation of -1/2 I, so every leading Schur complement stays
    uniformly invertible at practical mesh densities).

    A : [n, n] with n a multiple of ``block``; b : [n, m].  Returns x.
    Every step goes through :func:`raft_tpu_torch.kernels.bem_gj.gj_stage`
    (the hand-written kernels on the card, their plain versions on the
    CPU).
    """
    _, x = gj_stage(A, b, 0, A.shape[0] // block, block=block)
    return x


def _wave_rows(nu, k0, xc, nc_, y, w_q, tables, depth, kmax_geom, finite,
               tracer=None):
    """Wave-term influence rows for a collocation chunk: [RB,3]
    collocation points/normals against the full quadrature set
    -> (Sw, Kw) [RB,N] complex.  ``tracer`` records the wave term and the
    finite-depth correction as spans."""
    cheb = isinstance(tables, dict)
    dx = xc[:, None, None, 0] - y[None, :, :, 0]
    dy = xc[:, None, None, 1] - y[None, :, :, 1]
    Rh = torch.sqrt(dx ** 2 + dy ** 2)
    zz = xc[:, None, None, 2] + y[None, :, :, 2]
    Rs = torch.clamp(Rh, min=1e-9)
    ex = dx / Rs
    ey = dy / Rs
    with maybe_span(tracer, "bem.assembly.wave_term", device=xc.device):
        if cheb:
            Gw, dGw_dR, dGw_dz = greens.wave_term_cheb(nu, Rh, zz, tables)
        else:
            Gw, dGw_dR, dGw_dz = greens.wave_term(nu, Rh, zz, *tables)
    if finite:
        # finite-depth wave-term difference (John's G minus the deep
        # part; the seabed-image Rankine term is already in S0/K0)
        with maybe_span(tracer, "bem.assembly.finite_depth",
                        device=xc.device):
            dGc, dRc, dzc = greens.finite_depth_correction(
                nu, k0, depth, Rh, xc[:, None, None, 2], y[None, :, :, 2],
                kmax_geom,
            )
        Gw = Gw + dGc
        dGw_dR = dGw_dR + dRc
        dGw_dz = dGw_dz + dzc
    # e^{+iwt} convention: conjugate branch (outgoing waves)
    Gw = torch.conj(Gw)
    dGw_dR = torch.conj(dGw_dR)
    dGw_dz = torch.conj(dGw_dz)
    Sw = torch.sum(w_q[None] * Gw, dim=-1)
    Kw = torch.sum(
        w_q[None] * (dGw_dR * (ex * nc_[:, None, None, 0]
                               + ey * nc_[:, None, None, 1])
                     + dGw_dz * nc_[:, None, None, 2]),
        dim=-1,
    )
    return Sw, Kw


def _row_block(N, Q, cheb):
    """Collocation rows per assembly block: the whole mesh for the table
    form; for the Chebyshev form the largest of 512..32 rows that divides
    N and keeps the block's pair points under ``_ROW_BLOCK_POINTS``."""
    if cheb:
        for rb in (512, 256, 128, 64, 32):
            if N % rb == 0 and rb * N * Q <= _ROW_BLOCK_POINTS:
                return rb
    return N


def _solve_all(omegas, betas, x, nrm, area, y, w_q, S0, K0, vmodes, jump,
               tables, g, rho, real_block, depth, kmax_geom, finite,
               traces=None):
    """The solve over all frequencies, one after another, on the device
    of the tensors (float32 / complex64): per frequency the wave-term
    assembly in row blocks, the boundary-condition solve and the
    pressure integrals.  ``traces``, where given, holds one tracer per
    frequency for the stages' spans.  Returns [(A [6,6], B, Xr [nb,6],
    Xi)] per frequency (:func:`_fetch` stacks them)."""
    N = x.shape[0]
    RB = _row_block(N, y.shape[1], isinstance(tables, dict))
    S0c = S0.to(_C64)
    K0c = K0.to(_C64)
    out = []
    for i, omega in enumerate(omegas):
        tr = None if traces is None else traces[i]
        with maybe_span(tr, "bem.assembly", device=x.device):
            nu = omega * omega / g
            k0 = greens.dispersion_k0(nu, depth) if finite else nu
            Sw = torch.empty((N, N), dtype=_C64, device=x.device)
            Kw = torch.empty((N, N), dtype=_C64, device=x.device)
            for r0 in range(0, N, RB):
                Sw[r0:r0 + RB], Kw[r0:r0 + RB] = _wave_rows(
                    nu, k0, x[r0:r0 + RB], nrm[r0:r0 + RB], y, w_q, tables,
                    depth, kmax_geom, finite, tr)
            S = S0c + Sw
            K = K0c + Kw
            del Sw, Kw
        out.append(_post_assembly(omega, nu, k0, S, K, betas, x, nrm, area,
                                  vmodes, jump, g, rho, real_block, depth,
                                  finite, tr))
    return out


def _fetch(out, tracer=None):
    """Per-frequency outputs [(A, B, Xr, Xi)] stacked and copied to the
    host as float64 NumPy, in a ``bem.fetch`` span (its host seconds are
    the wait for the device)."""
    with maybe_span(tracer, "bem.fetch"):
        res = [torch.stack([o[j] for o in out]).cpu() for j in range(4)]
    return tuple(t.numpy().astype(np.float64) for t in res)


def _incident_wave(omega, nu, k0, betas, x, nrm, g, depth, finite):
    """Incident-wave potential phiI [nb, N] and its normal derivative
    dphiIdn [nb, N] at the collocation points; finite depth uses the
    cosh-profile incident wave at wavenumber k0 (written in decaying
    exponentials; reduces to e^{nu z} as k0 h -> inf)."""
    cosb = torch.cos(betas)[:, None]
    sinb = torch.sin(betas)[:, None]
    kx = x[None, :, 0] * cosb + x[None, :, 1] * sinb          # [nb,N]
    if finite:
        Eh = torch.exp(-2.0 * k0 * depth)
        e2z = torch.exp(-2.0 * k0 * (x[None, :, 2] + depth))
        amp = torch.exp(k0 * x[None, :, 2]) / (1.0 + Eh)
        phiI = ((1j * g / omega) * amp * (1.0 + e2z)
                * torch.exp(-1j * k0 * kx))
        phiIz = ((1j * g / omega) * k0 * amp * (1.0 - e2z)
                 * torch.exp(-1j * k0 * kx))
    else:
        phiI = ((1j * g / omega) * torch.exp(nu * x[None, :, 2])
                * torch.exp(-1j * nu * kx))
        phiIz = nu * phiI
    dphiIdn = (-1j * k0 * cosb * phiI * nrm[None, :, 0]
               - 1j * k0 * sinb * phiI * nrm[None, :, 1]
               + phiIz * nrm[None, :, 2])
    return phiI, dphiIdn


def _real_block_system(lhs, rhs):
    """The equivalent real 2N x 2N block system of the dense complex
    system lhs sigma = rhs: [[Kr, -Ki], [Ki, Kr]] [sr; si] = [br; bi]."""
    Ar, Ai = lhs.real, lhs.imag
    A2 = torch.cat([torch.cat([Ar, -Ai], dim=1),
                    torch.cat([Ai, Ar], dim=1)], dim=0)        # [2N,2N]
    b2 = torch.cat([rhs.real, rhs.imag], dim=1).T.contiguous()
    return A2, b2


def _integrate_outputs(omega, sigma, S, phiI, area, vmodes, rho):
    """Pressure-integral tail: source strengths sigma [6+nb, N]
    -> (A, B, Xr, Xi) float32 for one frequency."""
    phi = sigma @ (S.T / (4 * _PI))                            # [6+nb,N]
    vm = vmodes.to(_C64).T

    # radiation coefficients: rho int phi_k n_i dS = -A_ik + i B_ik / w
    P = rho * (phi[:6] * area[None]) @ vm                      # [6k,6i]
    A = -P.real.T
    B = omega * P.imag.T

    # excitation per unit amplitude: F_i = i w rho int (phiI+phiS) n_i dS
    phiT = phi[6:] + phiI
    X = 1j * omega * rho * (phiT * area[None]) @ vm
    return A.to(_F32), B.to(_F32), X.real.to(_F32), X.imag.to(_F32)


def _post_assembly(omega, nu, k0, S, K, betas, x, nrm, area, vmodes, jump,
                   g, rho, real_block, depth, finite, tracer=None):
    """From assembled influence matrices to (A, B, Xr, Xi) for one
    frequency: the boundary-condition solve (the ``bem.elimination``
    span) and the pressure integrals (``bem.integrals``)."""
    N = x.shape[0]
    with maybe_span(tracer, "bem.elimination", device=x.device):
        # exterior (fluid-side) limit of the single-layer normal
        # derivative: dphi/dn = jump*sigma + K' sigma with jump = -1/2 on
        # body rows and LID_JUMP on interior free-surface rows
        lhs = K / (4 * _PI) + torch.diag(jump).to(_C64)

        # radiation RHS (unit velocity) + diffraction RHS per heading
        phiI, dphiIdn = _incident_wave(omega, nu, k0, betas, x, nrm, g,
                                       depth, finite)
        rhs = torch.cat([vmodes.to(_C64), -dphiIdn], dim=0)    # [6+nb,N]
        if real_block:
            A2, b2 = _real_block_system(lhs, rhs)
            if N > BLOCKED_GJ_MIN_PANELS and (2 * N) % GJ_BLOCK == 0:
                sol = _blocked_gj(A2, b2, block=GJ_BLOCK)      # [2N,6+nb]
            else:
                sol = torch.linalg.solve(A2, b2)               # [2N,6+nb]
            sigma = torch.complex(sol[:N], sol[N:]).T          # [6+nb,N]
        else:
            sigma = torch.linalg.solve(lhs, rhs.T).T           # [6+nb,N]
    with maybe_span(tracer, "bem.integrals", device=x.device):
        return _integrate_outputs(omega, sigma, S, phiI, area, vmodes, rho)


def _stream_plan(n, band_budget_s=None):
    """The streamed path's plan for a padded mesh of ``n`` panels:
    ``(D, steps)`` — ``D`` row bands of the assembly (they tile the mesh's
    ``n // 256`` units of 256 rows) and the block steps of each
    elimination stage (at least 2 stages where there are 2 steps).  The
    JAX package's formulas with this card's constants; at a budget of
    1e-4 s both give one band per unit and one stage per step."""
    budget = STREAM_BAND_BUDGET_S if band_budget_s is None else band_budget_s
    per_freq_s = _ASSEMBLY_S_AT_2560 * (n / 2560.0) ** 2
    units = n // 256
    D = min(units, max(1, math.ceil(per_freq_s / budget)))
    while units % D:                  # bands tile the padded mesh
        D += 1
    nblk_total = (2 * n) // GJ_BLOCK
    t_gj = 2.0 * (2.0 * n) ** 3 / _GJ_FLOPS_PER_S
    n_stages = min(nblk_total, max(2, math.ceil(t_gj / budget)))
    steps = [nblk_total // n_stages + (1 if s < nblk_total % n_stages
                                       else 0) for s in range(n_stages)]
    return D, steps


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_streamed(omegas, betas, x, nrm, area, y, w_q, S0, K0, vmodes, jump,
                  tables, g, rho, depth, kmax_geom, finite, traces=None):
    """The streamed out-of-core card-form solve, one frequency after
    another, with a host sync after each band and each stage:

      * bands: the wave-term rows of ``D`` row bands, each written
        straight into preallocated [N, N] complex matrices, in the direct
        path's row blocks where they divide the band (on every mesh above
        ``STREAM_PANEL_LIMIT``: its blocks are at most 64 rows, its bands
        whole 256-row units), else in blocks of their greatest common
        divisor;
      * system: ``S0``/``K0`` added in place, ``lhs`` and the incident
        wave, and the real 2N x 2N block system, copied once into the
        ``[A | b]`` buffer of the elimination;
      * stages: the blocked Gauss–Jordan in stages of consecutive block
        steps (:func:`gj_stage_buffer` on that one buffer; the stages
        compose to the whole elimination);
      * integrals: the pressure integrals (:func:`_integrate_outputs`).

    Every operation is the direct path's on the same operands, so the
    result is the direct card-form solve's, bit for bit.  ``traces``, as
    in :func:`_solve_all`, records one ``bem.assembly`` span per band,
    one ``bem.elimination`` span for the system and one per stage, and
    ``bem.integrals``.  The live set while a stage runs is ``S0``,
    ``K0`` (f32), ``S`` (c64), ``[A | b]`` and the step's new buffer
    (f32, 2N x (2N + m_pad) each): about 48 N^2 bytes, against about
    96 N^2 for the direct path (which also holds ``S0``/``K0`` as c64,
    ``K``, ``lhs`` and the block matrix).
    During the assembly it is 24 N^2 bytes and one row block's
    temporaries, which set the peak at 10496 panels: 6.65 GiB against
    4.93 GiB counted for a stage (chip_smoke.py phase 36, its first run
    in docs/torch_port.md section 6; NVIDIA H100 80GB HBM3, 700.00 W).
    Returns ([(A, B, Xr, Xi)] per frequency, {"bands": D,
    "solve_stages": S})."""
    N = x.shape[0]
    dev = x.device
    D, steps = _stream_plan(N)
    rows = N // D
    RB = math.gcd(_row_block(N, y.shape[1], True), rows)
    m = 6 + betas.shape[0]
    out = []
    for i, omega in enumerate(omegas):
        tr = None if traces is None else traces[i]
        nu = omega * omega / g
        k0 = greens.dispersion_k0(nu, depth) if finite else nu
        S = torch.empty((N, N), dtype=_C64, device=dev)
        K = torch.empty((N, N), dtype=_C64, device=dev)
        for band, b0 in enumerate(range(0, N, rows)):
            with maybe_span(tr, "bem.assembly", device=dev, band=band):
                for r0 in range(b0, b0 + rows, RB):
                    S[r0:r0 + RB], K[r0:r0 + RB] = _wave_rows(
                        nu, k0, x[r0:r0 + RB], nrm[r0:r0 + RB], y, w_q,
                        tables, depth, kmax_geom, finite, tr)
                _sync(dev)
        with maybe_span(tr, "bem.elimination", device=dev, stage="system"):
            # the direct path's S0 + Sw, K0 + Kw and K / 4 pi + diag(jump)
            S.add_(S0)
            K.add_(K0)
            K.div_(4 * _PI)
            K.add_(torch.diag(jump).to(_C64))
            phiI, dphiIdn = _incident_wave(omega, nu, k0, betas, x, nrm, g,
                                           depth, finite)
            rhs = torch.cat([vmodes.to(_C64), -dphiIdn], dim=0)  # [6+nb,N]
            A2, b2 = _real_block_system(K, rhs)
            del K, rhs
            Ab = gj_buffer(A2, b2)
            del A2, b2
            _sync(dev)
        kb0 = 0
        for stage, ns in enumerate(steps):
            with maybe_span(tr, "bem.elimination", device=dev,
                            stage=stage):
                Ab = gj_stage_buffer(Ab, 2 * N, kb0, ns, GJ_BLOCK)
                _sync(dev)
            kb0 += ns
        with maybe_span(tr, "bem.integrals", device=dev):
            sol = Ab[:, 2 * N:2 * N + m]
            del Ab
            sigma = torch.complex(sol[:N], sol[N:]).T          # [6+nb,N]
            out.append(_integrate_outputs(omega, sigma, S, phiI, area,
                                          vmodes, rho))
            del S, sol, sigma
            _sync(dev)
    return out, {"bands": D, "solve_stages": len(steps)}


# Device seconds of one sharded dispatch per worker: each of the workers
# solves chunk_dev items per dispatch, chunk_dev bounded so that
# chunk_dev items of the card form's assembly (_ASSEMBLY_S_AT_2560,
# scaled as N^2) fit the budget.  The JAX package's 45 s, with this
# card's per-frequency time.
SHARD_DISPATCH_BUDGET_S = 45.0


def _solve_devices(device, n_devices, devices, backend):
    """The device list of a solve: ``devices`` (capped at ``n_devices``),
    else ``n_devices`` entries (``cpu`` repeated on the CPU, the first
    cards on the card), else the one ``device``."""
    if devices is not None:
        devs = resolve_devices(devices)
        if n_devices is not None:
            if int(n_devices) > len(devs):
                raise ValueError(f"n_devices={n_devices} exceeds the "
                                 f"{len(devs)} entries of devices")
            devs = devs[:max(1, int(n_devices))]
        return devs
    dev = resolve_device(device if device is not None else backend)
    n = 1 if n_devices is None else max(1, int(n_devices))
    if n == 1:
        return (dev,)
    return resolve_devices([dev] * n if dev.type == "cpu" else n)


def _shard_mode(n_dev, nw, nb, streamed):
    """The JAX package's sharding rule: ``freq`` when the frequencies fill
    the list, ``freqbeta`` when only the frequency x heading pairs do,
    else None (the single-device solve, as on the streamed path)."""
    if streamed or n_dev < 2:
        return None
    if nw >= n_dev:
        return "freq"
    if nb > 1 and nw * nb >= n_dev:
        return "freqbeta"
    return None


def _run_sharded(omegas, betas, host_ops, devs, mode, n, real_block,
                 tracer=None):
    """The solve over the device list ``devs``: the items (frequencies,
    or in ``freqbeta`` mode the flattened (frequency, heading) pairs with
    one heading each) are repeat-padded to whole dispatches of
    ``chunk_dev`` items per worker and dealt out in order, worker d
    taking items [d * chunk_dev, (d + 1) * chunk_dev) of each dispatch.
    Each worker runs :func:`_solve_all` on its items, one frequency after
    another as the single-device solve does, on its own copy of the
    frequency-independent operands (placed once per distinct device).

    ``host_ops`` is ``(x, nrm, area, y, w_q, S0, K0, vmodes, jump, tables,
    g, rho, depth, kmax_geom, finite)`` with the arrays as host NumPy and
    ``tables`` a dict or tuple of them.  ``tracer`` records each device's
    upload and each worker's stages with ``backend`` the device's name.
    Returns ``((A, B, Xr, Xi) host NumPy float64 in the caller's layout,
    info)``, ``info`` holding ``chunk_total``, ``n_items`` and
    ``shard_launches`` (each worker's BEM kernel launches)."""
    (x, nrm, area, y, w_q, S0, K0, vmodes, jump, tables, g, rho, depth,
     kmax_geom, finite) = host_ops
    n_dev = len(devs)
    nw, nb = len(omegas), len(betas)
    if mode == "freqbeta":
        items_om = np.repeat(omegas, nb)
        items_bet = np.tile(betas, nw)[:, None]
    else:
        items_om = omegas
        items_bet = np.broadcast_to(betas, (nw, nb))
    n_items = len(items_om)
    chunk_dev = -(-n_items // n_dev)
    if real_block:
        per_freq_s = max(_ASSEMBLY_S_AT_2560 * (n / 2560.0) ** 2, 1e-3)
        if chunk_dev * per_freq_s > SHARD_DISPATCH_BUDGET_S:
            chunk_dev = max(1, int(SHARD_DISPATCH_BUDGET_S / per_freq_s))
    chunk_total = chunk_dev * n_dev
    n_pad = -(-n_items // chunk_total) * chunk_total
    pad = np.concatenate([np.arange(n_items),
                          np.full(n_pad - n_items, n_items - 1, int)])
    items_om, items_bet = items_om[pad], items_bet[pad]

    def put(a, dev):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    placed = {}
    for dev in devs:
        if dev not in placed:
            with maybe_span(tracer, "bem.upload", backend=str(dev)) as h:
                tabs = ({k: put(v, dev) for k, v in tables.items()}
                        if isinstance(tables, dict)
                        else tuple(put(t, dev) for t in tables))
                placed[dev] = (tuple(put(a, dev) for a in (
                    x, nrm, area, y, w_q, S0, K0, vmodes, jump)), tabs,
                    put(depth, dev), put(kmax_geom, dev))
                h["meta"]["bytes"] = _nbytes(placed[dev])

    def shard(dev, idx):
        """Items ``idx`` on ``dev``: one _solve_all over their frequencies
        and every heading, or in ``freqbeta`` mode one per item over its
        one heading."""
        arrs, tabs, depth_t, kmax_t = placed[dev]
        on = None if tracer is None else tracer.bind(backend=str(dev))
        traces = None if on is None else [
            on.bind(omega=float(items_om[i])) for i in idx]
        before = thread_launches()
        if mode == "freqbeta":
            out = [o for j, i in enumerate(idx) for o in _solve_all(
                put(items_om[i:i + 1], dev), put(items_bet[i], dev), *arrs,
                tabs, g, rho, real_block, depth_t, kmax_t, finite,
                None if traces is None else traces[j:j + 1])]
        else:
            out = _solve_all(put(items_om[idx], dev), put(betas, dev), *arrs,
                             tabs, g, rho, real_block, depth_t, kmax_t,
                             finite, traces)
        after = thread_launches()
        return _fetch(out, on), {k: after[k] - before[k] for k in after}

    with DeviceWorkers(devs, name="raft-bem-shard") as workers:
        futs = [workers.submit(d, shard, devs[d], np.arange(
                    i + d * chunk_dev, i + (d + 1) * chunk_dev))
                for i in range(0, n_pad, chunk_total) for d in range(n_dev)]
        outs = [f.result() for f in futs]
    A, B, Xr, Xi = (np.concatenate([o[0][j] for o in outs])[:n_items]
                    for j in range(4))
    if mode == "freqbeta":
        A = A[::nb]                     # radiation: one copy per omega
        B = B[::nb]
        Xr = Xr[:, 0, :].reshape(nw, nb, 6)
        Xi = Xi[:, 0, :].reshape(nw, nb, 6)
    launches = [dict.fromkeys(outs[0][1], 0) for _ in range(n_dev)]
    for j, (_, counts) in enumerate(outs):
        for k, v in counts.items():
            launches[j % n_dev][k] += v
    return (A, B, Xr, Xi), {"chunk_total": chunk_total, "n_items": n_items,
                            "shard_launches": launches}


def _nbytes(*trees):
    """Bytes of the tensors in nested tuples, lists and dicts."""
    n = 0
    for t in trees:
        if isinstance(t, torch.Tensor):
            n += t.nbytes
        elif isinstance(t, dict):
            n += _nbytes(*t.values())
        elif isinstance(t, (tuple, list)):
            n += _nbytes(*t)
    return n


# frequency-independent Rankine matrices keyed by (mesh bytes, depth) —
# raw bytes, so distinct meshes can never collide; FIFO bound by total
# byte budget (each entry is two [N,N] f32 matrices)
_rankine_cache = {}
_RANKINE_CACHE_BYTES = 256 * 1024 * 1024


# lid-row jump coefficient of the extended integral equation: the
# free-surface image of a z=0 panel coincides with the panel (doubling
# the effective layer) and the collocation limit approaches from the
# interior side, flipping the sign relative to a body row's -1/2
# (selected by the JAX package's truncated-cylinder irregular-frequency
# scan).
LID_JUMP = 1.0


def _cached_rankine(pa, panels, lid_panels, has_lid, depth, lid_mask):
    """(S0, K0) float32 of the mesh from the cache, computed on a miss;
    and whether it was a hit."""
    key = (
        np.asarray(panels, float).tobytes(), depth, pa.n,
        np.asarray(lid_panels, float).tobytes() if has_lid else b"",
    )
    cached = _rankine_cache.get(key)
    hit = cached is not None
    if not hit:
        S0f, K0f = _rankine(pa, depth=depth, lid_mask=lid_mask)
        # cache in f32 — the solver consumes f32 anyway
        cached = (S0f.astype(np.float32), K0f.astype(np.float32))
        new_bytes = cached[0].nbytes + cached[1].nbytes
        if new_bytes <= _RANKINE_CACHE_BYTES:  # else: too big, don't evict
            held = sum(v[0].nbytes + v[1].nbytes
                       for v in _rankine_cache.values())
            while _rankine_cache and held + new_bytes > _RANKINE_CACHE_BYTES:
                old = _rankine_cache.pop(next(iter(_rankine_cache)))
                held -= old[0].nbytes + old[1].nbytes
            _rankine_cache[key] = cached
    return cached, hit


def solve_bem(panels, omegas, betas=(0.0,), rho=1025.0, g=9.81,
              quad="gauss", backend=None, depth=np.inf, lid_panels=None,
              report_cost=False, n_devices=None, device=None, devices=None,
              tracer=None):
    """Radiation + diffraction solve over frequencies.

    panels : [npan,4,3] wetted-hull panels (outward normals)
    lid_panels : optional [nlid,4,3] interior free-surface panels at z=0
        (mesh.lid_panels_from_mesh): they join the system as rigid
        extensions (zero radiation normal velocity, diffraction forced
        like body panels) but are excluded from the pressure-force
        integrals (irregular-frequency removal).
    omegas : [nw] rad/s;  betas : wave headings [rad]
    depth : water depth [m] (np.inf = deep water); finite depth requires
        the hull to float clear of the seabed.
    backend : 'cuda' (the card form) | 'cpu' (the CPU form) | None (the
        card form).
    device : where the solve's tensors live; defaults to 'cuda' for the
        card form and 'cpu' for the CPU form.  The card form on the CPU
        runs the blocked Gauss–Jordan through the kernels' plain versions.
    devices : a device list (``utils.placement.resolve_devices``: names,
        a comma-separated string, repeats allowed, or N for the first N
        cards) the solve is sharded over; replaces ``device``.
    n_devices : without ``devices``, the number of workers: ``cpu``
        repeated on the CPU, the first N cards on the card (a card the
        host lacks raises); with ``devices``, a cap on its entries.  None
        or 1 is the single-device solve (the JAX package's None is every
        local device).  With more than one, the solve is sharded when the
        items fill the list (:func:`_shard_mode`, :func:`_run_sharded`),
        and the output adds ``sharded`` (``"freq"``/``"freqbeta"``),
        ``n_devices`` and ``shard_launches`` (each worker's BEM kernel
        launches); else (too few items, or the streamed path) it is the
        single-device solve on the list's first entry.
    report_cost : add ``flops``, :func:`solve_cost` times the number of
        items solved (frequencies; frequency x heading pairs of one heading
        each in ``freqbeta`` mode), not on the streamed path, as in the
        JAX package.
    tracer : a :class:`raft_tpu_torch.trace.Tracer` (or a view of one)
        that records the solve's stages as spans: ``bem.prep`` (host work
        before the Rankine part), ``bem.rankine`` (``meta["hit"]``: the
        cache held it), ``bem.upload`` (``meta["bytes"]`` copied to the
        device), per frequency (``meta["omega"]``) ``bem.assembly`` with
        ``bem.assembly.wave_term`` and ``bem.assembly.finite_depth`` per
        row block, ``bem.elimination`` and ``bem.integrals``, then
        ``bem.fetch`` (the copy back).  The per-frequency spans also record the device's time
        (``meta["device_s"]``) on a card.  None records nothing.
    Returns dict with A [nw,6,6], B [nw,6,6] and X [nw, nbeta, 6] complex
    (excitation per unit wave amplitude, e^{+iwt} convention,
    PRP-referenced), plus the panel counts; a card-form mesh above
    ``STREAM_PANEL_LIMIT`` panels takes the streamed path and adds
    ``streamed`` (True), ``stream_bands`` and ``stream_solve_dispatches``
    (the bands and elimination stages per frequency).
    """
    backend = "cuda" if backend is None else backend
    if backend not in ("cuda", "cpu"):
        raise ValueError(f"backend must be 'cuda' or 'cpu', got {backend!r}")
    real_block = backend == "cuda"
    with maybe_span(tracer, "bem.prep"):
        devs = _solve_devices(device, n_devices, devices, backend)
        device = devs[0]
        prep = _prepare(panels, omegas, betas, quad, depth, lid_panels,
                        real_block)
    pa, pa_wave = prep["pa"], prep["pa_wave"]
    depth, kmax_geom = prep["depth"], prep["kmax_geom"]
    omegas, betas_a = prep["omegas"], prep["betas"]
    finite = bool(np.isfinite(depth))
    streamed = real_block and pa.n > STREAM_PANEL_LIMIT
    if streamed:
        logger.info(
            "solve_bem: %d panels exceeds %d; using the streamed "
            "out-of-core path (band assembly and staged elimination per "
            "frequency)", pa.n, STREAM_PANEL_LIMIT)
    with maybe_span(tracer, "bem.rankine") as h:
        (S0, K0), h["meta"]["hit"] = _cached_rankine(
            pa, panels, lid_panels, prep["has_lid"], depth, prep["lid_mask"])
    tables = prep["tables"]
    mode = _shard_mode(len(devs), len(omegas), len(betas_a), streamed)
    if mode:
        (A, B, Xr, Xi), info = _run_sharded(
            omegas, betas_a, (pa.cen, pa.nrm, pa.area, pa_wave.qpts,
                              pa_wave.qwts, S0, K0, prep["vmodes"],
                              prep["jump"], tables, float(g), float(rho),
                              depth if finite else 0.0, kmax_geom, finite),
            devs, mode, pa.n, real_block, tracer)
        out = {
            "w": omegas, "A": A, "B": B, "X": Xr + 1j * Xi,
            "betas": np.asarray(betas, float), "npanels": prep["n_real"],
            "npanels_solved": pa.n, "sharded": mode,
            "n_devices": len(devs),
            "shard_launches": info["shard_launches"],
        }
        if report_cost:
            nb_item = 1 if mode == "freqbeta" else len(betas_a)
            per_item = solve_cost(pa.n, nb_item, real_block, finite,
                                  pa_wave.qpts.shape[1])["total"]
            # one dispatch's count, scaled by items / chunk_total as the
            # JAX package scales its compiled dispatch's count
            out["flops"] = per_item * info["chunk_total"] * (
                info["n_items"] / info["chunk_total"])
        return out

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    with maybe_span(tracer, "bem.upload") as h:
        if real_block:
            tables = {k: put(v) for k, v in tables.items()}
        else:
            tables = tuple(put(t) for t in tables)
        ops = (put(omegas), put(betas_a), put(pa.cen), put(pa.nrm),
               put(pa.area), put(pa_wave.qpts), put(pa_wave.qwts), put(S0),
               put(K0), put(prep["vmodes"]), put(prep["jump"]), tables,
               float(g), float(rho))
        depth_ops = (put(depth if finite else 0.0), put(kmax_geom), finite)
        h["meta"]["bytes"] = _nbytes(ops, depth_ops)
    traces = None if tracer is None else [
        tracer.bind(omega=float(w)) for w in omegas]
    if streamed:
        res, plan = _run_streamed(*ops, *depth_ops, traces)
    else:
        res = _solve_all(*ops, real_block, *depth_ops, traces)
    A, B, Xr, Xi = _fetch(res, tracer)
    out = {
        "w": omegas,
        "A": A,
        "B": B,
        "X": Xr + 1j * Xi,
        "betas": np.asarray(betas, float),
        "npanels": prep["n_real"],
        "npanels_solved": pa.n,   # incl. inert padding in the card form
    }
    if streamed:
        # as in the JAX package, the streamed path reports no cost
        out.update(streamed=True, stream_bands=plan["bands"],
                   stream_solve_dispatches=plan["solve_stages"])
    elif report_cost:
        out["flops"] = len(omegas) * solve_cost(
            pa.n, len(betas_a), real_block, finite,
            pa_wave.qpts.shape[1])["total"]
    return out


def _prepare(panels, omegas, betas, quad, depth, lid_panels, real_block):
    """The host work of :func:`solve_bem` before the Rankine part: the
    panel arrays (lids joined, padded in the card form), the lid mask and
    jumps, the radiation normals, the wave term's quadrature and tables,
    the depth's quadrature limit, the frequencies and headings."""
    pa = panel_arrays(panels)        # 2x2 Gauss for the singular Rankine part
    n_body = pa.n
    has_lid = lid_panels is not None and len(lid_panels) > 0
    if has_lid:
        pa = _concat_panel_arrays(pa, panel_arrays(lid_panels))
    n_real = pa.n
    depth = float(depth)
    # keel depth from panel VERTICES — centroids sit up to half a panel
    # above the keel
    draft = float(-np.min(np.asarray(panels, float)[:, :, 2]))
    if np.isfinite(depth):
        if depth <= draft * 1.02:
            raise ValueError(
                f"solve_bem: water depth {depth} m does not clear the hull "
                f"draft {draft} m (bottom-sitting structures are out of "
                "scope for the finite-depth wave correction)"
            )
        kmax_geom = 15.0 / (depth - draft)
    else:
        kmax_geom = 0.0
    if real_block:
        # the blocked solve's 512-row block multiple
        pa = pad_panel_arrays(pa)
    # lid rows: everything past the body panels, up to the padding
    lid_mask = np.zeros(pa.n, bool)
    lid_mask[n_body:n_real] = True
    # the per-frequency wave term is smooth: "centroid" swaps only its
    # quadrature for a faster assembly
    if quad == "gauss":
        pa_wave = pa
    else:
        pa_wave = panel_arrays(panels, quad=quad)
        if has_lid:
            pa_wave = _concat_panel_arrays(
                pa_wave, panel_arrays(lid_panels, quad=quad))
        if real_block:
            pa_wave = pad_panel_arrays(pa_wave)
    vmodes = _radiation_normals(pa)                     # [6, N]
    # lids are rigid extensions: zero radiation normal velocity AND zero
    # weight in the pressure-force integrals (both flow through vmodes)
    vmodes[:, lid_mask] = 0.0
    return {
        "pa": pa, "pa_wave": pa_wave, "n_real": n_real, "has_lid": has_lid,
        "lid_mask": lid_mask, "jump": np.where(lid_mask, LID_JUMP, -0.5),
        "vmodes": vmodes, "depth": depth, "kmax_geom": kmax_geom,
        "omegas": np.atleast_1d(np.asarray(omegas, float)),
        "betas": np.atleast_1d(np.asarray(betas, float)),
        "tables": (greens.load_cheb_tables() if real_block
                   else tuple(greens.load_tables())),
    }


# Operations per pair-quadrature point of the wave-term assembly, counted
# from the code: one per element of every elementwise operation (a
# comparison or a select counts one, a complex add 2, a complex-by-real
# product 2, a complex product 6), the Q-sums as adds.
# tests/test_torch_bem_solver.py recounts them under a dispatch mode.
_OPS_ROWS = 26         # _wave_rows: distances, directions, the two Q-sums
_OPS_CHEB = 1415       # wave_term_cheb without its patch (region masks,
#                        the special functions, _combine_wave_outputs)
_OPS_TABLE = 435       # wave_term (bilinear tables, _combine_wave_outputs)
_OPS_FD_PAIR = 257     # finite_depth_correction: poles, residues, tails
_OPS_FD_NODE = 148     # ... and per quadrature node
_FD_NODES = 80         # its n1 + n2 + n3 nodes
_CHEB_D_PATCH = (48, 40)


def _patch_ops(na, nb):
    """Operations of one Chebyshev patch of degrees (na, nb) at one pair
    (greens._cheb_patch): the two bases, then for F and F1 the
    [nb+1, na+1] @ [na+1] product and the dot with the b-basis."""
    return (2 * (na + nb) + 2 * 2 * (na + 1) * (nb + 1)
            + 2 * (2 * nb + 1))


def solve_cost(n, nbeta, real_block=True, finite=False, Q=4,
               cheb_degree=_CHEB_D_PATCH):
    """Operations of the direct solve of one frequency over a mesh of
    ``n`` panels (padded, in the card form) with ``nbeta`` headings and
    ``Q`` quadrature points per source panel, as a sum of per-stage closed
    forms (``m = 6 + nbeta`` right-hand sides, ``P = n^2 Q`` pair points):

      assembly     P (_OPS_ROWS + w + f)     w = _OPS_CHEB + patch(na, nb)
                                             in the card form (every pair
                                             charged the patch of degrees
                                             ``cheb_degree``, by default
                                             the near-field D patch),
                                             _OPS_TABLE in the CPU form;
                                             f = _OPS_FD_PAIR + 80
                                             _OPS_FD_NODE at finite depth
      patch(a, b)  2 (a + b) + 4 (a+1)(b+1) + 2 (2b + 1)
      system       8 n^2                     S0 + Sw, K0 + Kw, K / 4 pi,
                                             + diag(jump), as complex
      elimination  card form, blocked (n > BLOCKED_GJ_MIN_PANELS): with
                   r = 2n rows, b = GJ_BLOCK, c = r + m_pad columns
                   (m_pad = m rounded up to RHS_ALIGN), r / b steps of
                   2 b^3 (the pivot tile) + 2 b b c (Dinv @ [D | Db])
                   + 2 r b c (the update) — what chip_smoke.py's bounds
                   charge the kernels with;
                   card form, dense: 2/3 r^3 + 2 r^2 m (LU and solves);
                   CPU form: 4 (2/3 n^3 + 2 n^2 m) (complex LU)
      integrals    8 m n^2 + 2 n^2 + 24 m n  sigma @ S^T / 4 pi and the
                                             pressure integrals

    The incident wave (O(nbeta n)) is left out.  Returns a dict of the
    stages and their ``total``."""
    P = n * n * Q
    if real_block:
        wave = _OPS_CHEB + _patch_ops(*cheb_degree)
    else:
        wave = _OPS_TABLE
    fd = _OPS_FD_PAIR + _FD_NODES * _OPS_FD_NODE if finite else 0
    m = 6 + nbeta
    if real_block and n > BLOCKED_GJ_MIN_PANELS and (2 * n) % GJ_BLOCK == 0:
        r, b = 2 * n, GJ_BLOCK
        c = r + m + (-m % RHS_ALIGN)
        elim = (r // b) * (2 * b ** 3 + 2 * b * b * c + 2 * r * b * c)
    elif real_block:
        r = 2 * n
        elim = 2 * r ** 3 // 3 + 2 * r * r * m
    else:
        elim = 4 * (2 * n ** 3 // 3 + 2 * n * n * m)
    out = {
        "assembly": P * (_OPS_ROWS + wave + fd),
        "system": 8 * n * n,
        "elimination": elim,
        "integrals": 8 * m * n * n + 2 * n * n + 24 * m * n,
    }
    out["total"] = sum(out.values())
    return out


def max_resolved_omega(panel_size, g=9.81, panels_per_wavelength=7.0):
    """Highest frequency the mesh resolves: wave length 2 pi g / w^2 must
    span >= panels_per_wavelength panels (accuracy collapses once
    nu * panel_size ~ 1)."""
    return float(np.sqrt(2.0 * np.pi * g
                         / (panels_per_wavelength * panel_size)))


def coeffs_from_members(members, omegas, headings_deg=(0.0,), rho=1025.0,
                        g=9.81, dz_max=0.0, da_max=0.0, panels=None,
                        quad="gauss", backend=None, depth=np.inf,
                        irr_removal=True, n_devices=None, device=None,
                        devices=None, tracer=None):
    """Mesh all potMod members, run the native solver, return a
    HydroCoeffs set (the container the WAMIT-file import path produces,
    so the Model pipeline is agnostic to where coefficients came from).

    A pre-built panel array can be passed to skip the meshing step.

    irr_removal : generate interior free-surface lids from the mesh's
        waterline loops and solve the extended system (irregular-frequency
        removal, on by default).

    tracer : records the meshing and the lids as the span ``bem.mesh``
        and passes on to :func:`solve_bem`; None records nothing.

    Frequencies above what the mesh resolves are clamped to the solve cap
    and de-duplicated (the interpolation onto the model grid clamps
    there, like the reference's interp-with-clamp semantics).
    """
    from raft_tpu_torch.bem import HydroCoeffs
    from raft_tpu_torch.mesh import (
        lid_panels_from_mesh,
        mesh_platform,
        panel_geometry,
    )

    omegas = np.sort(np.asarray(omegas, float))
    with maybe_span(tracer, "bem.mesh"):
        if panels is None:
            panels = mesh_platform(members, dz_max=dz_max, da_max=da_max)
        if len(panels) == 0:
            raise ValueError("no potMod members to mesh for the BEM solve")
        lids = lid_panels_from_mesh(panels) if irr_removal else None
    size = float(np.sqrt(np.median(panel_geometry(panels)[2])))
    w_cap = max_resolved_omega(size, g=g)
    w_solve = np.unique(np.minimum(omegas, w_cap))
    betas = np.deg2rad(np.asarray(headings_deg, float))
    out = solve_bem(panels, w_solve, betas=betas, rho=rho, g=g, quad=quad,
                    backend=backend, depth=depth, lid_panels=lids,
                    n_devices=n_devices, device=device, devices=devices,
                    tracer=tracer)
    return HydroCoeffs(
        w=out["w"], A=out["A"], B=out["B"],
        headings=np.asarray(headings_deg, float), X=out["X"],
        solver_info={k: out[k] for k in ("npanels", "npanels_solved")},
    )
