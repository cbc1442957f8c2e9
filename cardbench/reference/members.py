"""The members of a design, worked out again from the design dict: a
frozen NumPy copy of the port's member parsing (heading replication,
orientation, strip discretization) and of its packing of the strip-theory
nodes, for the reference analysis (reference/fowt.py)."""

from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np

_NO_DEFAULT = object()


def get_from_dict(d, key, shape=0, dtype=float, default=_NO_DEFAULT):
    """Fetch ``d[key]`` with scalar/array shape coercion and defaults.

    Semantics match the reference helper (raft/helpers.py:456-516):

    - shape == 0: scalar expected, returned as ``dtype``
    - shape == -1: any shape accepted (scalar stays scalar)
    - shape == n (int): 1-D array of length n; scalars are tiled
    - shape == [m, n]: 2-D; a length-n 1-D input is tiled m times
    - missing key: return (possibly tiled) default, or raise if no default
    """
    if key in d and d[key] is not None:
        val = d[key]
        if shape == 0:
            if np.isscalar(val):
                return dtype(val)
            raise ValueError(f"Value for key '{key}' should be scalar but is: {val}")
        if shape == -1:
            if np.isscalar(val):
                return dtype(val)
            return np.array(val, dtype=dtype)
        if np.isscalar(val):
            return np.tile(dtype(val), shape)
        if np.isscalar(shape):
            if len(val) == shape:
                return np.array([dtype(v) for v in val])
            raise ValueError(
                f"Value for key '{key}' is not the expected size {shape}: {val}"
            )
        vala = np.array(val, dtype=dtype)
        if list(vala.shape) == list(shape):
            return vala
        if len(shape) > 2:
            raise ValueError("get_from_dict supports at most 2-D shapes")
        if vala.ndim == 1 and len(vala) == shape[1]:
            return np.tile(vala, [shape[0], 1])
        raise ValueError(
            f"Value for key '{key}' is not compatible with shape {shape}: {val}"
        )
    if default is _NO_DEFAULT or default is None:
        # (the reference treats default=None as "no default"; we keep that)
        raise ValueError(f"Key '{key}' not found in input file...")
    if shape == 0 or shape == -1:
        return default
    return np.tile(default, shape)


def _rotation_z(deg):
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


@dataclass
class Member:
    """One rigid cylindrical/rectangular member, preprocessed.

    Mirrors the reference Member's parsed state (reference
    raft/raft_member.py:13-200) plus its orientation products
    (raft/raft_member.py:204-241), computed eagerly.
    """

    name: str
    type: int
    shape: str              # 'circular' | 'rectangular'
    rA: np.ndarray          # end A position after heading rotation [3]
    rB: np.ndarray
    l: float                # member length
    stations: np.ndarray    # [n] normalized to 0..l
    d: np.ndarray           # [n] diameters (circular) — or None
    sl: np.ndarray          # [n, 2] side lengths (rectangular) — or None
    t: np.ndarray           # [n] shell thickness
    l_fill: np.ndarray      # scalar or [n-1] ballast fill lengths
    rho_fill: np.ndarray    # scalar or [n-1] ballast densities
    rho_shell: float
    gamma: float
    potMod: bool
    heading: float
    headings: np.ndarray    # the full headings entry (scalar or list)
    cap_stations: np.ndarray
    cap_t: np.ndarray
    cap_d_in: np.ndarray
    # hydro coefficients per station
    Cd_q: np.ndarray
    Cd_p1: np.ndarray
    Cd_p2: np.ndarray
    Cd_End: np.ndarray
    Ca_q: np.ndarray
    Ca_p1: np.ndarray
    Ca_p2: np.ndarray
    Ca_End: np.ndarray
    # orientation
    q: np.ndarray = field(default=None)
    p1: np.ndarray = field(default=None)
    p2: np.ndarray = field(default=None)
    R: np.ndarray = field(default=None)
    # strip discretization
    ns: int = 0
    ls: np.ndarray = field(default=None)    # [ns] node stations along axis
    dls: np.ndarray = field(default=None)   # [ns] strip lengths (0 = flat plate)
    ds: np.ndarray = field(default=None)    # [ns] (circ) or [ns,2] (rect) sizes
    drs: np.ndarray = field(default=None)   # [ns] (circ) or [ns,2] radius change
    r: np.ndarray = field(default=None)     # [ns, 3] node positions

    @property
    def circular(self):
        return self.shape == "circular"

    def dorsl(self):
        """Diameter (circ) or side-length-pair (rect) per station."""
        return self.d if self.circular else self.sl


def parse_member(mi, heading=0.0):
    """Build one Member from its design-dict entry with a given heading
    rotation (reference raft/raft_member.py:13-200)."""
    rA = np.array(mi["rA"], dtype=float)
    rB = np.array(mi["rB"], dtype=float)
    if heading != 0.0:
        rot = _rotation_z(heading)
        rA = rot @ rA
        rB = rot @ rB

    rAB = rB - rA
    l = float(np.linalg.norm(rAB))

    A = np.array(mi["stations"], dtype=float)
    n = len(A)
    if n < 2:
        raise ValueError("At least two stations entries must be provided")
    stations = (A - A[0]) / (A[-1] - A[0]) * l

    shape_str = str(mi["shape"])
    if shape_str[0].lower() == "c":
        shape = "circular"
        d = get_from_dict(mi, "d", shape=n)
        sl = None
        gamma = 0.0
    elif shape_str[0].lower() == "r":
        shape = "rectangular"
        d = None
        sl = get_from_dict(mi, "d", shape=[n, 2])
        gamma = get_from_dict(mi, "gamma", default=0.0)
    else:
        raise ValueError("Member shape must be circular or rectangular")

    t = get_from_dict(mi, "t", shape=n)
    l_fill = get_from_dict(mi, "l_fill", shape=-1, default=0.0)
    rho_fill = get_from_dict(mi, "rho_fill", shape=-1, default=0.0)
    if isinstance(l_fill, np.ndarray) and (
        len(l_fill) != n - 1 or len(np.atleast_1d(rho_fill)) != n - 1
    ):
        raise ValueError(
            f"Member '{mi.get('name','?')}': number of stations ({n}) must be one "
            f"more than the number of ballast sections"
        )
    rho_shell = get_from_dict(mi, "rho_shell", default=8500.0)

    cap_stations = get_from_dict(mi, "cap_stations", shape=-1, default=[])
    if isinstance(cap_stations, list) or np.size(cap_stations) == 0:
        cap_t = np.array([])
        cap_d_in = np.array([])
        cap_stations = np.array([])
    else:
        cap_stations = np.atleast_1d(cap_stations)
        cap_t = np.atleast_1d(get_from_dict(mi, "cap_t", shape=cap_stations.shape[0]))
        cap_d_in = np.atleast_1d(
            get_from_dict(mi, "cap_d_in", shape=cap_stations.shape[0])
        )
        cap_stations = (cap_stations - A[0]) / (A[-1] - A[0]) * l

    # drag/added-mass coefficients (reference defaults, raft_member.py:116-132)
    Cd_q = get_from_dict(mi, "Cd_q", shape=n, default=0.0)
    if "Cd" in mi and not np.isscalar(mi["Cd"]) and len(mi["Cd"]) == 2:
        Cd_p1 = np.tile(float(mi["Cd"][0]), n)
        Cd_p2 = np.tile(float(mi["Cd"][1]), n)
    else:
        Cd_p1 = get_from_dict(mi, "Cd", shape=n, default=0.6)
        Cd_p2 = get_from_dict(mi, "Cd", shape=n, default=0.6)
    Cd_End = get_from_dict(mi, "CdEnd", shape=n, default=0.6)
    Ca_q = get_from_dict(mi, "Ca_q", shape=n, default=0.0)
    if "Ca" in mi and not np.isscalar(mi["Ca"]) and len(mi["Ca"]) == 2:
        Ca_p1 = np.tile(float(mi["Ca"][0]), n)
        Ca_p2 = np.tile(float(mi["Ca"][1]), n)
    else:
        Ca_p1 = get_from_dict(mi, "Ca", shape=n, default=0.97)
        Ca_p2 = get_from_dict(mi, "Ca", shape=n, default=0.97)
    Ca_End = get_from_dict(mi, "CaEnd", shape=n, default=0.6)

    mem = Member(
        name=str(mi.get("name", "")),
        type=int(mi["type"]),
        shape=shape,
        rA=rA,
        rB=rB,
        l=l,
        stations=stations,
        d=d,
        sl=sl,
        t=t,
        l_fill=l_fill,
        rho_fill=rho_fill,
        rho_shell=float(rho_shell),
        gamma=float(gamma),
        potMod=bool(get_from_dict(mi, "potMod", dtype=bool, default=False)),
        heading=float(heading),
        headings=get_from_dict(mi, "headings", shape=-1, default=0.0),
        cap_stations=cap_stations,
        cap_t=cap_t,
        cap_d_in=cap_d_in,
        Cd_q=Cd_q,
        Cd_p1=Cd_p1,
        Cd_p2=Cd_p2,
        Cd_End=Cd_End,
        Ca_q=Ca_q,
        Ca_p1=Ca_p1,
        Ca_p2=Ca_p2,
        Ca_End=Ca_End,
    )
    _calc_orientation(mem)
    _discretize(mem, dlsMax=float(mi["dlsMax"]))
    return mem


def _calc_orientation(mem):
    """Direction vectors q, p1, p2 and rotation matrix R from end positions and
    twist gamma (reference raft/raft_member.py:204-241, Z1Y2Z3 Euler)."""
    rAB = mem.rB - mem.rA
    q = rAB / np.linalg.norm(rAB)
    beta = np.arctan2(q[1], q[0])
    phi = np.arctan2(np.sqrt(q[0] ** 2 + q[1] ** 2), q[2])
    s1, c1 = np.sin(beta), np.cos(beta)
    s2, c2 = np.sin(phi), np.cos(phi)
    s3, c3 = np.sin(np.deg2rad(mem.gamma)), np.cos(np.deg2rad(mem.gamma))
    R = np.array(
        [
            [c1 * c2 * c3 - s1 * s3, -c3 * s1 - c1 * c2 * s3, c1 * s2],
            [c1 * s3 + c2 * c3 * s1, c1 * c3 - c2 * s1 * s3, s1 * s2],
            [-c3 * s2, s2 * s3, c2],
        ]
    )
    p1 = R @ np.array([1.0, 0.0, 0.0])
    p2 = np.cross(q, p1)
    mem.R, mem.q, mem.p1, mem.p2 = R, q, p1, p2


def _discretize(mem, dlsMax):
    """Strip discretization with a node at each strip midpoint; flat surfaces
    (taper breaks and member ends) get zero-length strips.

    This reproduces the reference algorithm exactly — including its quirk of
    appending the end-B plate strip once per station segment rather than once
    per member (the block at reference raft/raft_member.py:165-170 is inside
    the segment loop), because the duplicated end strips contribute axial
    added mass / dynamic pressure terms for submerged member ends and the
    reference's validated behavior depends on them.
    """
    dorsl = list(mem.d) if mem.circular else [np.array(p) for p in mem.sl]
    n = len(mem.stations)

    ls = [0.0]
    dls = [0.0]
    ds = [0.5 * np.asarray(dorsl[0])]
    drs = [0.5 * np.asarray(dorsl[0])]

    for i in range(1, n):
        lstrip = mem.stations[i] - mem.stations[i - 1]
        if lstrip > 0.0:
            ns_seg = int(np.ceil(lstrip / dlsMax))
            dlstrip = lstrip / ns_seg
            m = 0.5 * (np.asarray(dorsl[i]) - np.asarray(dorsl[i - 1])) / lstrip
            ls += [mem.stations[i - 1] + dlstrip * (0.5 + j) for j in range(ns_seg)]
            dls += [dlstrip] * ns_seg
            ds += [
                np.asarray(dorsl[i - 1]) + dlstrip * 2 * m * (0.5 + j)
                for j in range(ns_seg)
            ]
            drs += [dlstrip * m] * ns_seg
        elif lstrip == 0.0:
            ls += [mem.stations[i - 1]]
            dls += [0.0]
            ds += [0.5 * (np.asarray(dorsl[i - 1]) + np.asarray(dorsl[i]))]
            drs += [0.5 * (np.asarray(dorsl[i]) - np.asarray(dorsl[i - 1]))]

        # end-B plate strip — appended per segment (see docstring)
        ls += [mem.stations[-1]]
        dls += [0.0]
        ds += [0.5 * np.asarray(dorsl[-1])]
        drs += [-0.5 * np.asarray(dorsl[-1])]

    mem.ns = len(ls)
    mem.ls = np.array(ls, dtype=float)
    mem.dls = np.array(dls, dtype=float)
    mem.ds = np.array(ds, dtype=float)
    mem.drs = np.array(drs, dtype=float)
    rAB = mem.rB - mem.rA
    mem.r = mem.rA[None, :] + (mem.ls[:, None] / mem.l) * rAB[None, :]


def process_members(design):
    """Expand the platform member list (with heading replication and
    potModMaster override) plus the tower into Member objects
    (reference raft/raft_fowt.py:54-91)."""
    potModMaster = get_from_dict(design["platform"], "potModMaster", dtype=int, default=0)
    dlsMax = get_from_dict(design["platform"], "dlsMax", default=5.0)

    members = []
    for mi in design["platform"]["members"]:
        mi = dict(mi)  # do not mutate the user's design dict
        if potModMaster == 1:
            mi["potMod"] = False
        elif potModMaster == 2:
            mi["potMod"] = True
        mi["dlsMax"] = dlsMax

        headings = get_from_dict(mi, "heading", shape=-1, default=0.0)
        mi["headings"] = headings
        if np.isscalar(headings):
            members.append(parse_member(mi, heading=float(headings)))
        else:
            for h in headings:
                members.append(parse_member(mi, heading=float(h)))

    tower = dict(design["turbine"]["tower"])
    tower["dlsMax"] = get_from_dict(
        design["turbine"]["tower"], "dlsMax", default=5.0
    )
    tower["headings"] = 0.0
    members.append(parse_member(tower, heading=0.0))
    return members


def pack_nodes(members):
    """Flatten all members' nodes into one namespace of float64 arrays
    ([N], [N, 3], [N, 3, 3]) and the masks ``submerged`` and
    ``strip_mask``.

    Per-node static quantities follow reference raft/raft_fowt.py:466-695:
      side volume  v_i = pi/4 d^2 dl (circ) or sl0 sl1 dl (rect), scaled by the
                   submerged fraction when the strip pokes out of the water
                   (raft_fowt.py:532-537)
      end volume   v_i = pi/12 |(d+dr)^3 - (d-dr)^3|        (raft_fowt.py:562-566)
      end area     a_i = pi d dr (circ), signed              (raft_fowt.py:563)
      drag areas   a_q = pi d dl, a_p = d dl (circ)          (raft_fowt.py:638-640)
                   (rect: a_q = 2(sl0+sl0) dl — reference quirk kept, sl1 is
                   never used in the axial area — a_p1 = sl0 dl, a_p2 = sl1 dl)
    """
    rs, qs, qM, p1M, p2M = [], [], [], [], []
    v_side, v_end, a_end, a_q, a_p1, a_p2, a_end_abs = [], [], [], [], [], [], []
    Ca_p1l, Ca_p2l, Ca_Endl = [], [], []
    Cd_ql, Cd_p1l, Cd_p2l, Cd_Endl = [], [], [], []
    submerged, strip_mask = [], []

    for mem in members:
        circ = mem.circular
        for il in range(mem.ns):
            rs.append(mem.r[il])
            qs.append(mem.q)
            qM.append(np.outer(mem.q, mem.q))
            p1M.append(np.outer(mem.p1, mem.p1))
            p2M.append(np.outer(mem.p2, mem.p2))

            dl = mem.dls[il]
            if circ:
                d = mem.ds[il]
                dr = mem.drs[il]
                v = 0.25 * np.pi * d**2 * dl
                ve = np.pi / 12.0 * abs((d + dr) ** 3 - (d - dr) ** 3)
                ae = np.pi * d * dr
                aq = np.pi * d * dl
                ap1 = d * dl
                ap2 = d * dl
                ae_abs = abs(np.pi * d * dr)
            else:
                d0, d1 = mem.ds[il]
                dr0, dr1 = mem.drs[il]
                v = d0 * d1 * dl
                dmean = np.mean(mem.ds[il] + mem.drs[il])
                dmean2 = np.mean(mem.ds[il] - mem.drs[il])
                ve = np.pi / 12.0 * (dmean**3 - dmean2**3)
                ae = (d0 + dr0) * (d1 + dr1) - (d0 - dr0) * (d1 - dr1)
                aq = 2 * (d0 + d0) * dl  # reference quirk: uses ds[il,0] twice
                ap1 = d0 * dl
                ap2 = d1 * dl
                ae_abs = abs(ae)

            z = mem.r[il, 2]
            # waterline clipping of the side volume (raft_fowt.py:536-537);
            # only submerged nodes are ever used, so clip only those (an
            # above-water node would get a meaningless negative factor)
            if z < 0 and z + 0.5 * dl > 0 and dl > 0:
                v = v * (0.5 * dl - z) / dl
            v_side.append(v)
            v_end.append(ve)
            a_end.append(ae)
            a_q.append(aq)
            a_p1.append(ap1)
            a_p2.append(ap2)
            a_end_abs.append(ae_abs)

            # station-interpolated coefficients (raft_fowt.py:523-526, :629-632)
            st = mem.stations
            Ca_p1l.append(np.interp(mem.ls[il], st, mem.Ca_p1))
            Ca_p2l.append(np.interp(mem.ls[il], st, mem.Ca_p2))
            Ca_Endl.append(np.interp(mem.ls[il], st, mem.Ca_End))
            Cd_ql.append(np.interp(mem.ls[il], st, mem.Cd_q))
            Cd_p1l.append(np.interp(mem.ls[il], st, mem.Cd_p1))
            Cd_p2l.append(np.interp(mem.ls[il], st, mem.Cd_p2))
            Cd_Endl.append(np.interp(mem.ls[il], st, mem.Cd_End))

            sub = z < 0
            submerged.append(sub)
            strip_mask.append(sub and not mem.potMod)

    fields = dict(
        r=rs, q=qs, qMat=qM, p1Mat=p1M, p2Mat=p2M, v_side=v_side,
        v_end=v_end, a_end=a_end, a_q=a_q, a_p1=a_p1, a_p2=a_p2,
        a_end_abs=a_end_abs, Ca_p1=Ca_p1l, Ca_p2=Ca_p2l, Ca_End=Ca_Endl,
        Cd_q=Cd_ql, Cd_p1=Cd_p1l, Cd_p2=Cd_p2l, Cd_End=Cd_Endl,
    )
    out = {k: np.array(v, dtype=np.float64) for k, v in fields.items()}
    out["submerged"] = np.array(submerged, dtype=bool)
    out["strip_mask"] = np.array(strip_mask, dtype=bool)
    return SimpleNamespace(**out)
