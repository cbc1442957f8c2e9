"""The hull's panels, worked out again from the design dict.

A frozen copy of the port's panel mesher (profile subdivision, revolve,
transition rings, waterplane clipping, lid panels for irregular-frequency
removal) and of the member placement it needs, so that the reference
meshes the hull itself and takes no panel from the program.  NumPy only.
"""

import numpy as np


def _rotation_z(deg):
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


class HullMember:
    """One potential-flow member as the mesher needs it: its ends after
    the heading rotation, its stations along the axis, and its diameters
    (circular) or side lengths (rectangular)."""

    def __init__(self, mi, heading):
        rA = np.array(mi["rA"], float)
        rB = np.array(mi["rB"], float)
        if heading != 0.0:
            rot = _rotation_z(heading)
            rA, rB = rot @ rA, rot @ rB
        self.rA, self.rB = rA, rB
        length = float(np.linalg.norm(rB - rA))
        st = np.array(mi["stations"], float)
        n = len(st)
        self.stations = (st - st[0]) / (st[-1] - st[0]) * length
        self.circular = str(mi["shape"])[0].lower() == "c"
        d = mi["d"]
        if self.circular:
            self.d = np.tile(float(d), n) if np.isscalar(d) else np.array(d, float)
        else:
            sl = np.array(d, float)
            self.sl = np.tile(sl, (n, 1)) if sl.ndim == 1 else sl
        self.gamma = float(mi.get("gamma", 0.0) or 0.0)


def hull_members(design):
    """The platform's members, replicated over their headings, that the
    BEM solve meshes: all of them under ``potModMaster`` 2, none under 1,
    else those marked ``potMod``."""
    master = int(design["platform"].get("potModMaster", 0) or 0)
    out = []
    for mi in design["platform"]["members"]:
        pot = bool(mi.get("potMod", False))
        if master == 1:
            pot = False
        elif master == 2:
            pot = True
        if not pot:
            continue
        heads = mi.get("heading", 0.0)
        for h in np.atleast_1d(np.asarray(heads, float)):
            out.append(HullMember(mi, float(h)))
    return out


def hull_panels(design, dz_max, da_max):
    """(hull panels [n, 4, 3], lid panels [m, 4, 3]) of the design."""
    panels = mesh_platform(hull_members(design), dz_max, da_max)
    return panels, lid_panels_from_mesh(panels)


def max_resolved_omega(panel_size, g=9.81, panels_per_wavelength=7.0):
    """Highest frequency a mesh of this panel size resolves (seven panels
    to a wave length)."""
    return float(np.sqrt(2.0 * np.pi * g
                         / (panels_per_wavelength * panel_size)))


def resolved_band_top(panels, g=9.81):
    """The highest frequency the BEM solve takes on this mesh."""
    return max_resolved_omega(
        float(np.sqrt(np.median(panel_geometry(panels)[2]))), g=g)


# ---------------------------------------------------------------- profile ---

def profile_points(stations, radii, dz_max=0.0, da_max=0.0, end_a=True,
                   end_b=True):
    """Discretize the member generator curve (radius vs axial coordinate).

    Subdivision rule (reference member2pnl.py:115-165): vertical segments are
    split by ``dz_max``; horizontal (flat) segments by ``0.6*da_max``; sloped
    segments by a slope-angle-weighted blend of the two.  End caps are filled
    with concentric rings down to r=0.

    Returns (r, z) profile arrays ordered from end A to end B.
    """
    stations = np.asarray(stations, float)
    radii = np.asarray(radii, float)
    if dz_max <= 0.0:
        dz_max = float(stations[-1]) / 20.0
    if da_max <= 0.0:
        da_max = float(np.max(radii)) / 8.0

    r_rp = [float(radii[0])]
    z_rp = [float(stations[0])]
    for i in range(1, len(radii)):
        dr = float(radii[i] - radii[i - 1])
        dz = float(stations[i] - stations[i - 1])
        hyp = np.hypot(dr, dz)
        if hyp == 0.0:
            continue
        if dr == 0.0:
            target = dz_max
        elif dz == 0.0:
            target = 0.6 * da_max
        else:
            # blend by the segment's inclination angle
            a_r = np.arctan(abs(dr / dz)) * 2.0 / np.pi
            a_z = np.arctan(abs(dz / dr)) * 2.0 / np.pi
            target = a_r * 0.6 * da_max + a_z * dz_max
        n = max(1, int(np.ceil(hyp / target)))
        for j in range(1, n + 1):
            frac = j / n
            r_rp.append(float(radii[i - 1]) + frac * dr)
            z_rp.append(float(stations[i - 1]) + frac * dz)

    # end-cap rings: concentric circles shrinking to the axis
    if end_b and radii[-1] > 0.0:
        n = max(1, int(np.ceil(radii[-1] / (0.6 * da_max))))
        for j in range(1, n + 1):
            r_rp.append(float(radii[-1]) * (1.0 - j / n))
            z_rp.append(float(stations[-1]))
    if end_a and radii[0] > 0.0:
        n = max(1, int(np.ceil(radii[0] / (0.6 * da_max))))
        head_r = [float(radii[0]) * (1.0 - j / n) for j in range(n, 0, -1)]
        head_z = [float(stations[0])] * n
        r_rp = head_r + r_rp
        z_rp = head_z + z_rp
    return np.array(r_rp), np.array(z_rp)


def _ring_quads(r1, z1, r2, z2, naz):
    """One ring of naz quads between profile points (r1,z1)-(r2,z2),
    vectorized over azimuth.  Winding matches the reference's so that panel
    normals point out of the body (reference member2pnl.py:233-241)."""
    th = np.linspace(0.0, 2.0 * np.pi, naz + 1)
    c, s = np.cos(th), np.sin(th)
    quads = np.empty((naz, 4, 3))
    quads[:, 0, 0] = r1 * c[1:]
    quads[:, 0, 1] = r1 * s[1:]
    quads[:, 0, 2] = z1
    quads[:, 1, 0] = r2 * c[1:]
    quads[:, 1, 1] = r2 * s[1:]
    quads[:, 1, 2] = z2
    quads[:, 2, 0] = r2 * c[:-1]
    quads[:, 2, 1] = r2 * s[:-1]
    quads[:, 2, 2] = z2
    quads[:, 3, 0] = r1 * c[:-1]
    quads[:, 3, 1] = r1 * s[:-1]
    quads[:, 3, 2] = z1
    return quads


def _transition_ring(r1, z1, r2, z2, naz, refine_bottom):
    """2:1 transition ring: naz/2 coarse cells each split into two panels.

    ``refine_bottom``: the (r2,z2) edge is the finer one (reference's
    'increase azimuthal discretization' branch, member2pnl.py:194-210);
    otherwise the (r1,z1) edge is finer (member2pnl.py:213-229).
    """
    panels = []
    for ia in range(1, naz // 2 + 1):
        th1 = (ia - 1.0) * 2.0 * np.pi / naz * 2.0
        th2 = (ia - 0.5) * 2.0 * np.pi / naz * 2.0
        th3 = (ia - 0.0) * 2.0 * np.pi / naz * 2.0
        c1_, s1_ = np.cos(th1), np.sin(th1)
        c2_, s2_ = np.cos(th2), np.sin(th2)
        c3_, s3_ = np.cos(th3), np.sin(th3)
        if refine_bottom:
            mid = ((r1 * c1_ + r1 * c3_) / 2.0, (r1 * s1_ + r1 * s3_) / 2.0)
            panels.append([[mid[0], mid[1], z1],
                           [r2 * c2_, r2 * s2_, z2],
                           [r2 * c1_, r2 * s1_, z2],
                           [r1 * c1_, r1 * s1_, z1]])
            panels.append([[r1 * c3_, r1 * s3_, z1],
                           [r2 * c3_, r2 * s3_, z2],
                           [r2 * c2_, r2 * s2_, z2],
                           [mid[0], mid[1], z1]])
        else:
            mid = ((r2 * c1_ + r2 * c3_) / 2.0, (r2 * s1_ + r2 * s3_) / 2.0)
            panels.append([[r1 * c2_, r1 * s2_, z1],
                           [mid[0], mid[1], z2],
                           [r2 * c1_, r2 * s1_, z2],
                           [r1 * c1_, r1 * s1_, z1]])
            panels.append([[r1 * c3_, r1 * s3_, z1],
                           [r2 * c3_, r2 * s3_, z2],
                           [mid[0], mid[1], z2],
                           [r1 * c2_, r1 * s2_, z1]])
    return np.array(panels)


def revolve_profile(r_rp, z_rp, da_max):
    """Revolve the profile into panels with adaptive azimuthal refinement.

    The azimuth count follows the reference's hysteresis state machine
    (member2pnl.py:188-191): starting from 8, double while both edge widths
    are >= da_max/2, halve while both are < da_max/2; mixed edges emit a 2:1
    transition ring.  Returns [npan, 4, 3] panel vertices (local frame).
    """
    panels = []
    naz = 8
    for i in range(len(z_rp) - 1):
        r1, z1 = r_rp[i], z_rp[i]
        r2, z2 = r_rp[i + 1], z_rp[i + 1]
        while (r1 * 2 * np.pi / naz >= da_max / 2
               and r2 * 2 * np.pi / naz >= da_max / 2):
            naz *= 2
        while (naz > 2 and r1 * 2 * np.pi / naz < da_max / 2
               and r2 * 2 * np.pi / naz < da_max / 2):
            naz //= 2
        w1 = r1 * 2 * np.pi / naz
        w2 = r2 * 2 * np.pi / naz
        if w1 < da_max / 2 <= w2:
            panels.append(_transition_ring(r1, z1, r2, z2, naz,
                                           refine_bottom=True))
        elif w2 < da_max / 2 <= w1:
            panels.append(_transition_ring(r1, z1, r2, z2, naz,
                                           refine_bottom=False))
        else:
            panels.append(_ring_quads(r1, z1, r2, z2, naz))
    return np.concatenate(panels, axis=0) if panels else np.zeros((0, 4, 3))


def member_pose_matrix(rA, rB, gamma=0.0):
    """Z1Y2Z3 member pose rotation (reference member2pnl.py:245-260)."""
    rAB = np.asarray(rB, float) - np.asarray(rA, float)
    beta = np.arctan2(rAB[1], rAB[0])
    phi = np.arctan2(np.hypot(rAB[0], rAB[1]), rAB[2])
    s1, c1 = np.sin(beta), np.cos(beta)
    s2, c2 = np.sin(phi), np.cos(phi)
    s3, c3 = np.sin(np.deg2rad(gamma)), np.cos(np.deg2rad(gamma))
    return np.array([
        [c1 * c2 * c3 - s1 * s3, -c3 * s1 - c1 * c2 * s3, c1 * s2],
        [c1 * s3 + c2 * c3 * s1, c1 * c3 - c2 * s1 * s3, s1 * s2],
        [-c3 * s2, s2 * s3, c2],
    ])


def waterline_station(stations, vals, rA, rB):
    """Insert an interpolated profile station EXACTLY where the member
    axis crosses the free surface (z = 0), so revolved rings align with
    the waterline on every refinement.

    Without it, the clip leaves a sliver row whose height is the accident
    of where the dz_max grid lands relative to z = 0 — measured on the
    VolturnUS full hull as a ±2.4% surge/heave added-mass scatter between
    refinements while pitch/roll converged cleanly (docs/parity.md study;
    VERDICT r4 #3).  With an aligned ring the sub-surface row heights are
    draft/n for every n and the scatter collapses to ordinary p≈2 mesh
    convergence.

    Returns (stations, vals) unchanged when the axis does not cross, or
    with one inserted row (``vals`` interpolated per column) when it does.
    """
    rA = np.asarray(rA, float)
    rB = np.asarray(rB, float)
    stations = np.asarray(stations, float)
    vals = np.asarray(vals, float)
    dzg = rB[2] - rA[2]
    if dzg == 0.0:
        return stations, vals
    t = -rA[2] / dzg                      # axis fraction where z = 0
    if not 0.0 < t < 1.0:
        return stations, vals
    span = stations[-1] - stations[0]
    s_wl = stations[0] + t * span
    if np.min(np.abs(stations - s_wl)) < 1e-9 * max(abs(span), 1.0):
        return stations, vals
    i = int(np.searchsorted(stations, s_wl))
    v_wl = vals[i - 1] + (vals[i] - vals[i - 1]) * (
        (s_wl - stations[i - 1]) / (stations[i] - stations[i - 1]))
    return (np.insert(stations, i, s_wl),
            np.insert(vals, i, v_wl, axis=0))


def _graded_waterline_stations(stations, vals, rA, rB, dz_max):
    """Waterline-aligned AND surface-graded profile stations.

    Inserts a station exactly at the z = 0 crossing (see
    :func:`waterline_station`) and replaces the uniform subdivision of
    the submerged segment adjacent to it with sine-clustered stations —
    spacing shrinks quadratically toward the free surface (finest row
    ~ L*(pi/2n)^2/2 where n = ceil(L/dz_max)), where the velocity
    potential varies fastest.  Both effects remove the
    refinement-to-refinement layout accidents of clip-based waterline
    handling: every mesh in a refinement sequence has the same smooth
    row-height profile, just scaled (VERDICT r4 #3; the unaligned clip
    left a sliver row whose height was the accident of where the dz grid
    landed, measured as a ±2.4% surge/heave scatter on the VolturnUS
    hull while pitch/roll converged cleanly).
    """
    st, vv = waterline_station(stations, vals, rA, rB)
    if len(st) == len(np.asarray(stations)):          # no crossing
        return st, vv
    rA = np.asarray(rA, float)
    rB = np.asarray(rB, float)
    # index of the inserted waterline station
    span = st[-1] - st[0]
    t = -rA[2] / (rB[2] - rA[2])
    s_wl = st[0] + t * span
    i = int(np.argmin(np.abs(st - s_wl)))
    # submerged side: stations where global z < 0, i.e. toward rA if
    # rA[2] < 0 else toward rB
    below_first = rA[2] < 0.0
    j = i - 1 if below_first else i + 1
    if j < 0 or j >= len(st):
        return st, vv
    s_edge = st[j]
    L = abs(s_wl - s_edge)
    if dz_max <= 0.0:
        dz_max = span / 20.0
    n = max(1, int(np.ceil(L / dz_max)))
    if n < 2:
        return st, vv
    # stations spanning (s_wl, s_edge) clustered quadratically at s_wl
    k = np.arange(1, n)
    s_new = np.sort(
        s_wl + (s_edge - s_wl) * (1.0 - np.cos(k * np.pi / (2 * n))))
    lo, hi = (j, i) if below_first else (i, j)
    f = (s_new - st[lo]) / (st[hi] - st[lo])
    if vv.ndim == 2:
        v_new = vv[lo][None, :] + (vv[hi] - vv[lo])[None, :] * f[:, None]
    else:
        v_new = vv[lo] + (vv[hi] - vv[lo]) * f
    return np.insert(st, lo + 1, s_new), np.insert(vv, lo + 1, v_new,
                                                   axis=0)


def mesh_member(stations, diameters, rA, rB, dz_max=0.0, da_max=0.0,
                align_waterline=True):
    """Mesh one axisymmetric member: profile → revolve → pose transform.

    ``stations`` are axial coordinates from end A; ``rA``/``rB`` global end
    positions.  Returns [npan, 4, 3] global-frame panel vertices (unclipped).
    ``align_waterline`` inserts a profile ring exactly at z = 0 (see
    :func:`waterline_station`; the reference mesher has no equivalent and
    relies on the clip, reference member2pnl.py:23-30).
    """
    rA = np.asarray(rA, float)
    rB = np.asarray(rB, float)
    stations = np.asarray(stations, float)
    diameters = np.asarray(diameters, float)
    if align_waterline:
        stations, diameters = _graded_waterline_stations(
            stations, diameters, rA, rB, dz_max)
    radii = 0.5 * diameters
    # profile z measured from end A along the member axis
    r_rp, z_rp = profile_points(stations - stations[0], radii, dz_max, da_max)
    panels = revolve_profile(r_rp, z_rp, da_max)
    R = member_pose_matrix(rA, rB)
    return panels @ R.T + rA[None, None, :]


def clip_waterplane(panels, z_max=0.0):
    """Drop panels fully above the waterline and clamp remaining vertices to
    the free surface (reference member2pnl.py:23-30).  Panels squashed to
    zero area by the clamp are also dropped."""
    if len(panels) == 0:
        return panels
    keep = ~np.all(panels[:, :, 2] > z_max, axis=1)
    out = panels[keep].copy()
    out[:, :, 2] = np.minimum(out[:, :, 2], z_max)
    areas = panel_geometry(out)[2]
    return out[areas > 1e-10]


def panel_geometry(panels):
    """Centroids, normals, areas of quad/tri panels [npan,4,3].

    Each quad is split into two triangles; the panel normal is the
    area-weighted triangle normal (robust for clip-degenerate quads), the
    centroid the area-weighted triangle centroid.  Returns
    (centroids [n,3], normals [n,3], areas [n]).
    """
    p = np.asarray(panels, float)
    a, b, c, d = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    n1 = 0.5 * np.cross(b - a, c - a)
    n2 = 0.5 * np.cross(c - a, d - a)
    c1 = (a + b + c) / 3.0
    c2 = (a + c + d) / 3.0
    A1 = np.linalg.norm(n1, axis=1)
    A2 = np.linalg.norm(n2, axis=1)
    areas = A1 + A2
    nvec = n1 + n2
    norm = np.linalg.norm(nvec, axis=1)
    normals = nvec / np.where(norm > 0, norm, 1.0)[:, None]
    w = np.where(areas > 0, areas, 1.0)
    centroids = (c1 * A1[:, None] + c2 * A2[:, None]) / w[:, None]
    return centroids, normals, areas


def mesh_volume(panels):
    """Signed enclosed volume by the divergence theorem (positive when panel
    normals point out of the body) — used to sanity-check orientation."""
    cen, nrm, areas = panel_geometry(panels)
    return float(np.sum(areas * np.einsum("ij,ij->i", cen, nrm)) / 3.0)


# -------------------------------------------------------------- file I/O ----

def _grid_quads(P00, P10, P01, P11, n_u, n_v):
    """Panel a bilinear patch defined by its 4 corners into n_u x n_v quads.
    Winding (u x v right-handed) chosen by the caller via corner order."""
    u = np.linspace(0.0, 1.0, n_u + 1)
    v = np.linspace(0.0, 1.0, n_v + 1)
    U, V = np.meshgrid(u, v, indexing="ij")
    pts = ((1 - U)[:, :, None] * (1 - V)[:, :, None] * P00
           + U[:, :, None] * (1 - V)[:, :, None] * P10
           + (1 - U)[:, :, None] * V[:, :, None] * P01
           + U[:, :, None] * V[:, :, None] * P11)
    quads = np.empty((n_u, n_v, 4, 3))
    quads[:, :, 0] = pts[:-1, :-1]
    quads[:, :, 1] = pts[1:, :-1]
    quads[:, :, 2] = pts[1:, 1:]
    quads[:, :, 3] = pts[:-1, 1:]
    return quads.reshape(-1, 4, 3)


def mesh_rect_member(stations, side_lengths, rA, rB, dz_max=0.0, da_max=0.0,
                     gamma=0.0, align_waterline=True):
    """Mesh a rectangular member as a (tapered) box: four side faces plus end
    caps.  ``side_lengths`` is [n,2] per station.  This extends the reference
    mesher, which only handles axisymmetric members (member2pnl.py:73).
    Returns [npan,4,3] global-frame panels with outward normals."""
    stations = np.asarray(stations, float) - float(np.asarray(stations)[0])
    sl = np.asarray(side_lengths, float).reshape(len(stations), 2)
    if align_waterline:
        stations, sl = _graded_waterline_stations(
            stations, sl, rA, rB, dz_max)
        sl = sl.reshape(len(stations), 2)
    if dz_max <= 0.0:
        dz_max = float(stations[-1]) / 20.0
    if da_max <= 0.0:
        da_max = float(np.max(sl)) / 8.0

    # subdivide the axial profile (same rule as circular: straight segments
    # split by dz_max)
    zs = [0.0]
    sls = [sl[0]]
    for i in range(1, len(stations)):
        dz = stations[i] - stations[i - 1]
        if dz <= 0.0:
            continue
        n = max(1, int(np.ceil(dz / dz_max)))
        for j in range(1, n + 1):
            f = j / n
            zs.append(stations[i - 1] + f * dz)
            sls.append(sl[i - 1] + f * (sl[i] - sl[i - 1]))
    zs = np.array(zs)
    sls = np.array(sls)

    def corners(i):
        a, b = 0.5 * sls[i]
        z = zs[i]
        return np.array([[+a, +b, z], [-a, +b, z], [-a, -b, z], [+a, -b, z]])

    chunks = []
    n_a = max(1, int(np.ceil(float(np.max(sls[:, 0])) / da_max)))
    n_b = max(1, int(np.ceil(float(np.max(sls[:, 1])) / da_max)))
    # edges 0/2 run corner->corner along the x side (length sl[:,0]),
    # edges 1/3 along the y side (length sl[:,1])
    n_per = [n_a, n_b, n_a, n_b]  # panels along each perimeter edge
    for i in range(len(zs) - 1):
        c1 = corners(i)
        c2 = corners(i + 1)
        for e in range(4):
            j = (e + 1) % 4
            # outward-facing side patch between axial rings i and i+1
            chunks.append(_grid_quads(c1[e], c1[j], c2[e], c2[j],
                                      n_per[e], 1))
    # end caps (normals along -z at end A, +z at end B in local frame)
    cA = corners(0)  # u: c0->c3 runs along the y side, v along the x side
    chunks.append(_grid_quads(cA[0], cA[3], cA[1], cA[2], n_b, n_a))
    cB = corners(len(zs) - 1)
    chunks.append(_grid_quads(cB[0], cB[1], cB[3], cB[2], n_a, n_b))

    panels = np.concatenate(chunks, axis=0)
    R = member_pose_matrix(rA, rB, gamma=gamma)
    panels = panels @ R.T + np.asarray(rA, float)[None, None, :]
    # ensure outward orientation (flip all if the enclosed volume is negative)
    if mesh_volume(panels) < 0:
        panels = panels[:, ::-1, :]
    return panels


# -------------------------------------------------- platform-level helper ---

def mesh_platform(members, dz_max=0.0, da_max=0.0, clip=True):
    """Mesh every potential-flow member of a platform into one panel set.

    ``members`` are :class:`HullMember` objects of the potential-flow
    members (reference
    raft_fowt.py:349-357).  Returns [npan,4,3] waterplane-clipped panels
    for the wetted hull.
    """
    chunks = []
    for mem in members:
        if mem.circular:
            chunks.append(
                mesh_member(mem.stations, mem.d, mem.rA, mem.rB, dz_max, da_max)
            )
        else:
            # rectangular members: box mesh (beyond the reference mesher,
            # which is axisymmetric-only, member2pnl.py:73)
            chunks.append(
                mesh_rect_member(mem.stations, mem.sl, mem.rA, mem.rB,
                                 dz_max, da_max, gamma=mem.gamma)
            )
    if not chunks:
        return np.zeros((0, 4, 3))
    panels = np.concatenate(chunks, axis=0)
    return clip_waterplane(panels) if clip else panels


def lid_panels_from_mesh(panels, nr=2, z_tol=1e-6):
    """Interior free-surface ("lid") panels for irregular-frequency removal:
    extract the waterline loop(s) of a clipped hull mesh and fill each with
    ``nr`` concentric rings of quads collapsing to the loop centroid.

    This is the geometric half of the extended-boundary-condition method
    (the reference's external solver exposes it as HAMS
    If_remove_irr_freq, consumed at reference raft/raft_fowt.py:381): the
    interior waterplane is panelled AT z = 0 and joins the body surface as
    a rigid extension (v_n = 0), displacing the interior-problem
    eigenfrequencies out of the wave band.  Works for any surface-piercing
    waterline whose loop is star-shaped about its centroid (circular and
    rectangular columns included).

    Keep ``nr`` SMALL: the lid only needs to represent the interior
    waterplane approximately, and refining it degrades the source-system
    conditioning through near-singular lid<->waterline-panel interactions
    (measured on the truncated cylinder: nr=2 biases the valid band
    <= 0.3%, nr=8 up to 4%).

    Returns [nlid, 4, 3] panels lying exactly at z = 0 (normals +z).
    """
    p = np.asarray(panels, float)
    # collect panel edges with both endpoints on the waterplane
    edges = {}
    for quad in p:
        for k in range(4):
            a, b = quad[k], quad[(k + 1) % 4]
            if abs(a[2]) < z_tol and abs(b[2]) < z_tol:
                ka = (round(a[0], 6), round(a[1], 6))
                kb = (round(b[0], 6), round(b[1], 6))
                if ka != kb:
                    edges.setdefault(ka, []).append(kb)
    loops = []
    visited = set()
    for start in list(edges):
        if start in visited:
            continue
        loop = [start]
        visited.add(start)
        cur = start
        while True:
            nxts = [v for v in edges.get(cur, []) if v not in visited]
            if not nxts:
                break
            cur = nxts[0]
            visited.add(cur)
            loop.append(cur)
        if len(loop) >= 3:
            loops.append(np.array(loop, float))
    out = []
    for loop in loops:
        c = loop.mean(axis=0)
        ts = np.linspace(1.0, 0.0, nr + 1)
        nv = len(loop)
        for k in range(nr):
            P1 = c + ts[k] * (loop - c)          # outer ring [nv, 2]
            P2 = c + ts[k + 1] * (loop - c)      # inner ring
            for i in range(nv):
                j = (i + 1) % nv
                quad = np.zeros((4, 3))
                # wind so the +z normal comes out of panel_geometry for a
                # counter-clockwise waterline loop; orientation is fixed
                # below regardless of loop direction
                quad[0, :2] = P1[i]
                quad[1, :2] = P1[j]
                quad[2, :2] = P2[j]
                quad[3, :2] = P2[i]
                out.append(quad)
    if not out:
        return np.zeros((0, 4, 3))
    lids = np.asarray(out)
    # enforce +z normals panel-by-panel (loop direction may be either way)
    _, nrm, _ = panel_geometry(lids)
    flip = nrm[:, 2] < 0.0
    lids[flip] = lids[flip, ::-1]
    return lids
