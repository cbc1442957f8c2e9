"""Native first-order radiation/diffraction panel solver (HAMS equivalent)
— the port of ``raft_tpu/bem_solver.py``'s single-device solve.

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

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP.md
step): the streamed out-of-core path for card-form meshes above
``STREAM_PANEL_LIMIT`` panels, the multi-device path (``n_devices`` > 1)
and ``report_cost=True``.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

from raft_tpu_torch import greens
from raft_tpu_torch.kernels.bem_gj import gj_stage
from raft_tpu_torch.utils.placement import resolve_device
from raft_tpu_torch.utils.profiling import timer

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

# Card-form meshes above this many panels take the JAX package's streamed
# out-of-core path, which is not ported yet.
STREAM_PANEL_LIMIT = 10240

# Row block of the card form's assembly: the Chebyshev basis temporaries
# are [rows * N * Q, deg + 1]; rows are chosen so rows * N * Q stays under
# this many pair points (~1 GB per float32 basis at degree 56).
_ROW_BLOCK_POINTS = 4.5e6


def _not_ported(what, step):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, queue 1 step {step})")


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


def _wave_rows(nu, k0, xc, nc_, y, w_q, tables, depth, kmax_geom, finite):
    """Wave-term influence rows for a collocation chunk: [RB,3]
    collocation points/normals against the full quadrature set
    -> (Sw, Kw) [RB,N] complex."""
    cheb = isinstance(tables, dict)
    dx = xc[:, None, None, 0] - y[None, :, :, 0]
    dy = xc[:, None, None, 1] - y[None, :, :, 1]
    Rh = torch.sqrt(dx ** 2 + dy ** 2)
    zz = xc[:, None, None, 2] + y[None, :, :, 2]
    Rs = torch.clamp(Rh, min=1e-9)
    ex = dx / Rs
    ey = dy / Rs
    if cheb:
        Gw, dGw_dR, dGw_dz = greens.wave_term_cheb(nu, Rh, zz, tables)
    else:
        Gw, dGw_dR, dGw_dz = greens.wave_term(nu, Rh, zz, *tables)
    if finite:
        # finite-depth wave-term difference (John's G minus the deep
        # part; the seabed-image Rankine term is already in S0/K0)
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
               tables, g, rho, real_block, depth, kmax_geom, finite):
    """The solve over all frequencies, one after another, on the device
    of the tensors (float32 / complex64): per frequency the wave-term
    assembly in row blocks, the boundary-condition solve and the
    pressure integrals.  Returns (A [nw,6,6], B, Xr [nw,nb,6], Xi)."""
    N = x.shape[0]
    RB = _row_block(N, y.shape[1], isinstance(tables, dict))
    S0c = S0.to(_C64)
    K0c = K0.to(_C64)
    out = []
    for omega in omegas:
        nu = omega * omega / g
        k0 = greens.dispersion_k0(nu, depth) if finite else nu
        Sw = torch.empty((N, N), dtype=_C64, device=x.device)
        Kw = torch.empty((N, N), dtype=_C64, device=x.device)
        for r0 in range(0, N, RB):
            Sw[r0:r0 + RB], Kw[r0:r0 + RB] = _wave_rows(
                nu, k0, x[r0:r0 + RB], nrm[r0:r0 + RB], y, w_q, tables,
                depth, kmax_geom, finite)
        S = S0c + Sw
        K = K0c + Kw
        del Sw, Kw
        out.append(_post_assembly(omega, nu, k0, S, K, betas, x, nrm, area,
                                  vmodes, jump, g, rho, real_block, depth,
                                  finite))
    return tuple(torch.stack([o[j] for o in out]) for j in range(4))


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
                   g, rho, real_block, depth, finite):
    """From assembled influence matrices to (A, B, Xr, Xi) for one
    frequency: the boundary-condition solve and the pressure integrals."""
    N = x.shape[0]
    # exterior (fluid-side) limit of the single-layer normal derivative:
    # dphi/dn = jump*sigma + K' sigma with jump = -1/2 on body rows and
    # LID_JUMP on interior free-surface rows
    lhs = K / (4 * _PI) + torch.diag(jump).to(_C64)

    # radiation RHS (unit velocity) + diffraction RHS per heading
    phiI, dphiIdn = _incident_wave(omega, nu, k0, betas, x, nrm, g,
                                   depth, finite)
    rhs = torch.cat([vmodes.to(_C64), -dphiIdn], dim=0)        # [6+nb,N]
    if real_block:
        A2, b2 = _real_block_system(lhs, rhs)
        if N > BLOCKED_GJ_MIN_PANELS and (2 * N) % GJ_BLOCK == 0:
            sol = _blocked_gj(A2, b2, block=GJ_BLOCK)          # [2N,6+nb]
        else:
            sol = torch.linalg.solve(A2, b2)                   # [2N,6+nb]
        sigma = torch.complex(sol[:N], sol[N:]).T              # [6+nb,N]
    else:
        sigma = torch.linalg.solve(lhs, rhs.T).T               # [6+nb,N]
    return _integrate_outputs(omega, sigma, S, phiI, area, vmodes, rho)


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
    key = (
        np.asarray(panels, float).tobytes(), depth, pa.n,
        np.asarray(lid_panels, float).tobytes() if has_lid else b"",
    )
    cached = _rankine_cache.get(key)
    if cached is None:
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
    return cached


def solve_bem(panels, omegas, betas=(0.0,), rho=1025.0, g=9.81,
              quad="gauss", backend=None, depth=np.inf, lid_panels=None,
              report_cost=False, n_devices=None, device=None):
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
    n_devices : None or 1 (the single-device solve).
    Returns dict with A [nw,6,6], B [nw,6,6] and X [nw, nbeta, 6] complex
    (excitation per unit wave amplitude, e^{+iwt} convention,
    PRP-referenced), plus the panel counts.
    """
    if report_cost:
        raise _not_ported("solve_bem(report_cost=True)", 9)
    if n_devices is not None and int(n_devices) > 1:
        raise _not_ported("the multi-device BEM solve (n_devices > 1)", 9)
    backend = "cuda" if backend is None else backend
    if backend not in ("cuda", "cpu"):
        raise ValueError(f"backend must be 'cuda' or 'cpu', got {backend!r}")
    real_block = backend == "cuda"
    device = resolve_device(device if device is not None else backend)

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
    if real_block and pa.n > STREAM_PANEL_LIMIT:
        raise _not_ported(
            f"the streamed out-of-core BEM solve ({pa.n} panels > "
            f"{STREAM_PANEL_LIMIT})", 9)
    if real_block:
        # the blocked solve's 512-row block multiple
        pa = pad_panel_arrays(pa)
    # lid rows: everything past the body panels, up to the padding
    lid_mask = np.zeros(pa.n, bool)
    lid_mask[n_body:n_real] = True
    jump = np.where(lid_mask, LID_JUMP, -0.5)
    with timer("bem_rankine"):
        S0, K0 = _cached_rankine(pa, panels, lid_panels, has_lid, depth,
                                 lid_mask)
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

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    if real_block:
        tables = {k: put(v) for k, v in greens.load_cheb_tables().items()}
    else:
        tables = tuple(put(t) for t in greens.load_tables())
    omegas = np.atleast_1d(np.asarray(omegas, float))
    with timer("bem_device"):
        A, B, Xr, Xi = _solve_all(
            put(omegas), put(np.atleast_1d(np.asarray(betas, float))),
            put(pa.cen), put(pa.nrm), put(pa.area), put(pa_wave.qpts),
            put(pa_wave.qwts), put(S0), put(K0), put(vmodes), put(jump),
            tables, float(g), float(rho), real_block,
            put(depth if np.isfinite(depth) else 0.0), put(kmax_geom),
            bool(np.isfinite(depth)))
        A, B, Xr, Xi = (t.cpu().numpy().astype(np.float64)
                        for t in (A, B, Xr, Xi))
    return {
        "w": omegas,
        "A": A,
        "B": B,
        "X": Xr + 1j * Xi,
        "betas": np.asarray(betas, float),
        "npanels": n_real,
        "npanels_solved": pa.n,   # incl. inert padding in the card form
    }


def max_resolved_omega(panel_size, g=9.81, panels_per_wavelength=7.0):
    """Highest frequency the mesh resolves: wave length 2 pi g / w^2 must
    span >= panels_per_wavelength panels (accuracy collapses once
    nu * panel_size ~ 1)."""
    return float(np.sqrt(2.0 * np.pi * g
                         / (panels_per_wavelength * panel_size)))


def coeffs_from_members(members, omegas, headings_deg=(0.0,), rho=1025.0,
                        g=9.81, dz_max=0.0, da_max=0.0, panels=None,
                        quad="gauss", backend=None, depth=np.inf,
                        irr_removal=True, n_devices=None, device=None):
    """Mesh all potMod members, run the native solver, return a
    HydroCoeffs set (the container the WAMIT-file import path produces,
    so the Model pipeline is agnostic to where coefficients came from).

    A pre-built panel array can be passed to skip the meshing step.

    irr_removal : generate interior free-surface lids from the mesh's
        waterline loops and solve the extended system (irregular-frequency
        removal, on by default).

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
    with timer("bem_mesh"):
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
                    n_devices=n_devices, device=device)
    return HydroCoeffs(
        w=out["w"], A=out["A"], B=out["B"],
        headings=np.asarray(headings_deg, float), X=out["X"],
        solver_info={k: out[k] for k in ("npanels", "npanels_solved")},
    )
