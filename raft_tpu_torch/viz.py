"""Visualization: 3-D system geometry and response-spectrum plots (the
port's ``raft_tpu/viz.py``).

Re-provides the reference's plotting surface (reference
raft/raft_model.py:730-765 plotResponses, :792-823 plot;
raft/raft_member.py:801-873 member wireframes; mooring-line profiles drawn
by MoorPy's ms.plot) on top of matplotlib.  All functions are host-side and
optional — nothing in the numeric path imports this module.  The
mooring lines are drawn from the port's own ``mooring.line_forces`` on
CPU tensors.
"""

import numpy as np
import torch


def _require_mpl():
    import os

    import matplotlib

    # only force the headless backend when there is no display to attach to
    # (leave interactive sessions on whatever backend the user has)
    if not os.environ.get("DISPLAY") and not os.environ.get("MPLBACKEND"):
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt  # noqa: F401

    return plt


# ------------------------------------------------------------------ members

def member_wireframe(mem, n_az=12):
    """Line segments ([n, 2, 3] arrays) tracing one member: longitudinal
    edges at n_az azimuths plus a ring/rectangle at each station
    (the reference draws the same station-ring + edge wireframe,
    raft_member.py:801-873)."""
    lines = []
    stations = np.asarray(mem.stations, float)
    if mem.circular:
        radii = 0.5 * np.asarray(mem.d, float)
        az = np.linspace(0, 2 * np.pi, n_az, endpoint=False)
        # longitudinal edges
        for a in az[:: max(1, n_az // 6)]:
            pts = [
                mem.rA + mem.q * s
                + r * (np.cos(a) * mem.p1 + np.sin(a) * mem.p2)
                for s, r in zip(stations, radii)
            ]
            lines.extend(
                np.stack([p0, p1]) for p0, p1 in zip(pts[:-1], pts[1:])
            )
        # station rings
        ring_az = np.linspace(0, 2 * np.pi, 24)
        for s, r in zip(stations, radii):
            ring = np.stack(
                [
                    mem.rA + mem.q * s
                    + r * (np.cos(a) * mem.p1 + np.sin(a) * mem.p2)
                    for a in ring_az
                ]
            )
            lines.extend(
                np.stack([p0, p1]) for p0, p1 in zip(ring[:-1], ring[1:])
            )
    else:
        sl = np.asarray(mem.sl, float)  # [n, 2]
        corners = np.array([[1, 1], [1, -1], [-1, -1], [-1, 1]]) * 0.5
        ringpts = []
        for s, (s1, s2) in zip(stations, sl):
            ring = np.stack(
                [
                    mem.rA + mem.q * s + c1 * s1 * mem.p1 + c2 * s2 * mem.p2
                    for c1, c2 in corners
                ]
            )
            ringpts.append(ring)
            closed = np.vstack([ring, ring[:1]])
            lines.extend(
                np.stack([p0, p1]) for p0, p1 in zip(closed[:-1], closed[1:])
            )
        for r0, r1 in zip(ringpts[:-1], ringpts[1:]):
            lines.extend(np.stack([p0, p1]) for p0, p1 in zip(r0, r1))
    return lines


# ------------------------------------------------------------- mooring lines

def segment_top_tensions_np(V, L, w, Wp):
    """Vertical tension at the top of each segment (anchor(0)->fairlead)
    of a composite line whose fairlead carries ``V``: the line weight
    and the clump weights above each segment's top come off ``V``."""
    c = np.asarray(w, float) * np.asarray(L, float)
    Wp = np.asarray(Wp, float)
    return V - (np.sum(c) - np.cumsum(c)) - (np.sum(Wp) - np.cumsum(Wp) + Wp)


def line_profile(anchor, fairlead, HF, VF, L, EA, w, n=40, touchdown=True):
    """Sampled 3-D shape of one catenary mooring line from the converged
    fairlead tension components (the same elastic-catenary branches as
    mooring._profile, evaluated at n arc-length stations from the anchor).

    touchdown=False forces the suspended expressions even for VA < 0 —
    an upper segment of a composite line sagging below its junction,
    which must not be drawn as seabed contact."""
    anchor = np.asarray(anchor, float)
    fairlead = np.asarray(fairlead, float)
    dxy = fairlead[:2] - anchor[:2]
    XF = max(float(np.hypot(*dxy)), 1e-9)
    u = dxy / XF
    s = np.linspace(0.0, L, n)
    VA = VF - w * L
    if HF <= 0.0 and touchdown:
        # fully-slack closed form (catenary_solve's H = 0 regime): the
        # line runs along the seabed then hangs vertically below the
        # fairlead — the catenary expressions divide by HF
        ZF = fairlead[2] - anchor[2]
        LB = max(L - max(ZF, 0.0), 0.0)
        x = np.minimum(s, LB) / max(LB, 1e-9) * XF
        z = np.maximum(s - LB, 0.0)
        pts = np.zeros((n, 3))
        pts[:, 0] = anchor[0] + u[0] * x
        pts[:, 1] = anchor[1] + u[1] * x
        pts[:, 2] = anchor[2] + z
        return pts
    if VA >= 0 or not touchdown:  # suspended (incl. sagging segments)
        Vs = VA + w * s
        x = HF / w * (np.arcsinh(Vs / HF) - np.arcsinh(VA / HF)) + HF * s / EA
        z = (
            HF / w * (np.sqrt(1 + (Vs / HF) ** 2) - np.sqrt(1 + (VA / HF) ** 2))
            + (VA * s + 0.5 * w * s**2) / EA
        )
    else:  # touchdown: seabed segment of length LB, then catenary
        LB = np.clip(L - VF / w, 0.0, L)
        sp = np.maximum(s - LB, 0.0)
        x = np.where(
            s <= LB,
            s + HF * s / EA,
            LB + HF / w * np.arcsinh(w * sp / HF) + HF * s / EA,
        )
        z = np.where(
            s <= LB,
            0.0,
            HF / w * (np.sqrt(1 + (w * sp / HF) ** 2) - 1.0)
            + w * sp**2 / (2 * EA),
        )
    pts = np.zeros((n, 3))
    pts[:, 0] = anchor[0] + u[0] * x
    pts[:, 1] = anchor[1] + u[1] * x
    pts[:, 2] = anchor[2] + z
    return pts


def composite_line_profile(anchor, fairlead, HF, VF, L, EA, w, Wp=None,
                           n=40):
    """Sampled 3-D shape of a composite (multi-segment) line: per-segment
    catenary profiles stacked anchor->fairlead, each drawn with its own
    top tension (:func:`segment_top_tensions_np`)."""
    L = np.atleast_1d(np.asarray(L, float))
    EA = np.atleast_1d(np.asarray(EA, float))
    w = np.atleast_1d(np.asarray(w, float))
    Wp = np.zeros_like(L) if Wp is None else np.atleast_1d(np.asarray(Wp))
    Vtop = segment_top_tensions_np(VF, L, w, Wp)
    start = np.asarray(anchor, float)
    out = []
    for k in range(len(L)):
        if L[k] == 0.0:
            continue
        pts = line_profile(start, fairlead, HF, float(Vtop[k]),
                           float(L[k]), float(EA[k]), float(w[k]), n=n,
                           touchdown=(k == 0))
        out.append(pts)
        start = pts[-1]
    return np.concatenate(out) if out else np.asarray([anchor, fairlead])


# --------------------------------------------------------------------- rotor

def rotor_wireframe(rotor, hub_pos, azimuth0=0.0):
    """Blade outline segments for the rotor at ``hub_pos``
    (the reference draws blade surfaces at raft_rotor.py:492-548; here each
    blade is its pitch axis plus leading/trailing edge chord outline)."""
    g = rotor.geom
    r = np.asarray(g["r"], float)
    chord = np.asarray(g["chord"], float)
    precurve = np.asarray(g["precurve"], float)
    presweep = np.asarray(g["presweep"], float)
    cone, tilt = g["precone"], g["tilt"]
    lines = []
    for ib in range(g["B"]):
        az = azimuth0 + 2 * np.pi * ib / g["B"]
        # blade-frame coordinates: x downwind (precurve), z spanwise
        xb = precurve * np.cos(cone) - r * np.sin(cone)
        zb = r * np.cos(cone) + precurve * np.sin(cone)
        yb = presweep
        for off in (-0.25, 0.75):  # leading/trailing edge at quarter chord
            ye = yb + off * chord
            # rotate about the shaft (x) axis by azimuth, then tilt about y
            Y = ye * np.cos(az) - zb * np.sin(az)
            Z = ye * np.sin(az) + zb * np.cos(az)
            X = xb * np.cos(tilt) + Z * np.sin(tilt)
            Zt = -xb * np.sin(tilt) + Z * np.cos(tilt)
            pts = np.stack(
                [hub_pos[0] + X, hub_pos[1] + Y, hub_pos[2] + Zt], axis=1
            )
            lines.extend(
                np.stack([p0, p1]) for p0, p1 in zip(pts[:-1], pts[1:])
            )
    return lines


# ------------------------------------------------------------------- figures

def plot_model(model, ax=None, color="k", nodes=False, station_plot=None):
    """3-D wireframe of platform + tower members and mooring lines
    (reference raft/raft_model.py:792-823)."""
    plt = _require_mpl()
    from mpl_toolkits.mplot3d.art3d import Line3DCollection

    if ax is None:
        fig = plt.figure(figsize=(8, 8))
        ax = fig.add_subplot(projection="3d")
    else:
        fig = ax.get_figure()

    segs = []
    for mem in model.members:
        segs.extend(member_wireframe(mem))
    if getattr(model, "rotor", None) is not None:
        hub = np.array([-model.rotor.overhang, 0.0, model.hHub])
        segs.extend(rotor_wireframe(model.rotor, hub))
    ax.add_collection3d(
        Line3DCollection(segs, colors=color, linewidths=0.5, alpha=0.8)
    )
    if nodes:
        r = model.nodes.r
        ax.scatter(r[:, 0], r[:, 1], r[:, 2], s=4, c="r")

    # mooring lines at the unloaded mean position
    from raft_tpu_torch.mooring import line_forces

    arr = model._moor_arrays
    r6 = np.asarray(getattr(model, "Xi0_unloaded", np.zeros(6)), float)
    _, HF, VF = line_forces(torch.as_tensor(r6, dtype=torch.float64), *arr)
    ms = model.ms
    for i in range(ms.n_lines):
        fair = np.asarray(ms.rFair[i]) + np.asarray(r6[:3])
        pts = composite_line_profile(
            ms.anchors[i], fair, float(HF[i]), float(VF[i]),
            ms.L[i], ms.EA[i], ms.w[i], ms.Wp[i],
        )
        ax.plot(pts[:, 0], pts[:, 1], pts[:, 2], color="b", lw=1.0)

    # bridle groups: draw straight chords junction-terminal per leg
    if ms.bridles is not None:
        for ib in range(ms.bridles.n):
            p0 = np.asarray(ms.bridles.p0[ib])
            for ik in range(ms.bridles.kind.shape[1]):
                kd = ms.bridles.kind[ib, ik]
                if kd < 0:
                    continue
                end = np.asarray(ms.bridles.ends[ib, ik], float)
                if kd == 1:
                    end = end + np.asarray(r6[:3])
                seg = np.stack([p0, end])
                ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], color="b",
                        lw=1.0, ls="--")

    # free surface
    ext = [20.0]
    if ms.n_lines:
        ext.append(float(np.abs(ms.anchors[:, :2]).max()))
    if ms.bridles is not None:
        ext.append(float(np.abs(ms.bridles.ends[..., :2]).max()))
    lim = max(ext)
    xs = np.linspace(-lim, lim, 2)
    X, Y = np.meshgrid(xs, xs)
    ax.plot_surface(X, Y, 0 * X, alpha=0.1, color="c")

    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    ax.set_zlabel("z (m)")
    zs = []
    if ms.n_lines:
        zs.append(float(ms.anchors[:, 2].min()))
    if ms.bridles is not None:
        zs.append(float(ms.bridles.ends[..., 2].min()))
    zmin = min(zs) if zs else -1.0
    ax.set_zlim(min(zmin, -1.0), max(float(model.hHub) + 10.0, 10.0))
    return fig, ax


_PSD_CHANNELS = [
    ("wave_PSD", "wave elevation (m²/(rad/s))"),
    ("surge_PSD", "surge (m²/(rad/s))"),
    ("heave_PSD", "heave (m²/(rad/s))"),
    ("pitch_PSD", "pitch (deg²/(rad/s))"),
    ("AxRNA_PSD", "nacelle accel. ((m/s²)²/(rad/s))"),
    ("Mbase_PSD", "tower base moment ((Nm)²/(rad/s))"),
]


def plot_responses(model, channels=None):
    """Response power-spectral-density subplot grid, one line per case
    (reference raft/raft_model.py:730-765)."""
    plt = _require_mpl()
    metrics = model.results.get("case_metrics")
    if metrics is None:
        raise RuntimeError("run analyze_cases() before plot_responses()")
    channels = channels or _PSD_CHANNELS
    freqs = model.w / (2 * np.pi)

    fig, axes = plt.subplots(
        len(channels), 1, sharex=True, figsize=(8, 2.2 * len(channels))
    )
    axes = np.atleast_1d(axes)
    ncase = metrics[channels[0][0]].shape[0]
    for ax, (key, label) in zip(axes, channels):
        for i in range(ncase):
            ax.plot(freqs, metrics[key][i], label=f"case {i+1}")
        ax.set_ylabel(label, fontsize=8)
        ax.grid(alpha=0.3)
    axes[0].legend(fontsize=8)
    axes[-1].set_xlabel("frequency (Hz)")
    fig.tight_layout()
    return fig, axes


def plot_sweep_contours(results, axes_dict, keys, case_index=0):
    """Contour-plot matrix over a 2-D design sweep — the reference's
    parametersweep figure style (reference raft/parametersweep.py:122-561
    draws 4x4 matrices of contour plots over pairs of design variables).

    results : dict from sweep.run_sweep (flat leading design axis)
    axes_dict : {param_name: values} with exactly two parameters (the grid
        the points were built from, as passed to sweep.grid_points)
    keys : list of scalar result keys to draw, one contour panel each
        (extra trailing axes, e.g. a case axis, are selected with
        ``case_index``)

    Returns (fig, axes array).
    """
    from raft_tpu_torch.sweep import results_to_grid

    plt = _require_mpl()
    if len(axes_dict) != 2:
        raise ValueError(
            f"plot_sweep_contours needs exactly two swept parameters, "
            f"got {list(axes_dict)}"
        )
    (nx_name, xs), (ny_name, ys) = axes_dict.items()
    n = len(keys)
    ncols = int(np.ceil(np.sqrt(n)))
    nrows = int(np.ceil(n / ncols))
    fig, axs = plt.subplots(
        nrows, ncols, figsize=(4.2 * ncols, 3.4 * nrows), squeeze=False
    )
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    for k, key in enumerate(keys):
        ax = axs[k // ncols][k % ncols]
        Z = np.asarray(results_to_grid(results, axes_dict, key))
        if Z.ndim > 2:
            # select case_index on the LAST extra axis (the case axis by
            # results layout), index 0 on any others; out-of-range raises
            # rather than silently plotting a different slice
            if case_index >= Z.shape[-1]:
                raise IndexError(
                    f"case_index {case_index} out of range for '{key}' "
                    f"(last axis has {Z.shape[-1]} entries)"
                )
            Z = Z[..., case_index]
            while Z.ndim > 2:
                Z = Z[..., 0]
        cs = ax.contourf(X, Y, Z, levels=12)
        fig.colorbar(cs, ax=ax, shrink=0.9)
        ax.set_title(key, fontsize=9)
        ax.set_xlabel(nx_name, fontsize=8)
        ax.set_ylabel(ny_name, fontsize=8)
    for k in range(n, nrows * ncols):
        axs[k // ncols][k % ncols].axis("off")
    fig.tight_layout()
    return fig, axs
