"""Potential-flow (BEM) coefficient interop: WAMIT-format readers, writers,
and interpolation onto the model frequency grid — the port's NumPy copy
of ``raft_tpu/bem.py``.

Replaces the pyHAMS reader path the reference consumes
(reference raft/raft_fowt.py:394-420 calcBEM reading WAMIT `.1`/`.3` output
and interpolating onto the RAFT grid; tests/verification.py:240-254 reading
the OC3/OC4 golden files) so externally computed radiation/diffraction
coefficients — from WAMIT, HAMS, Capytaine, or our native solver — flow into
the batched dynamics pipeline as frequency-dependent A(w), B(w) and
excitation X(w).

File conventions (WAMIT v6+ numeric output, ULEN = 1):
  `.1` rows:  PER  I  J  Abar(I,J)  [Bbar(I,J)]
      PER > 0: A = rho * Abar,  B = rho * omega * Bbar
      PER = 0 (omega = inf) and PER < 0 (omega = 0): added mass only.
  `.3` rows:  PER  BETA  I  MOD  PHA  RE  IM  ->  X = rho * g * (RE + i IM)

Pure NumPy, host side; the outputs are plain arrays fed into
raft_tpu_torch.Model.prepare_case_inputs.
"""

from dataclasses import dataclass

import numpy as np


@dataclass
class HydroCoeffs:
    """Radiation/diffraction coefficient set on its native frequency grid.

    A [nw, 6, 6]  : added mass (dimensional, kg / kg m / kg m^2)
    B [nw, 6, 6]  : radiation damping
    w [nw]        : rad/s, ascending
    A0, Ainf      : zero-/infinite-frequency added mass if present, else None
    headings [nh] : wave headings (deg) of the excitation data
    X [nw, nh, 6] : complex excitation force per unit amplitude
    """

    w: np.ndarray
    A: np.ndarray
    B: np.ndarray
    headings: np.ndarray = None
    X: np.ndarray = None
    A0: np.ndarray = None
    Ainf: np.ndarray = None
    # native-solver provenance (None for imported WAMIT/Capytaine data):
    # panel counts plus the execution route the coefficients took —
    # {"npanels", "npanels_solved", "sharded", "n_devices", "streamed"}
    solver_info: dict = None


def read_wamit_1(path, rho=1025.0):
    """Read a WAMIT `.1` added-mass/damping file -> (w, A, B, A0, Ainf).

    Accepts both 4-column (A only, zero/infinite frequency) and 5-column
    rows; damping is dimensionalized with the rho*omega WAMIT convention.
    """
    per, ij, vals = [], [], []
    with open(path) as f:
        rows = [ln.split() for ln in f if ln.strip()]
    A0 = np.zeros((6, 6))
    Ainf = np.zeros((6, 6))
    has_A0 = has_Ainf = False
    finite = {}
    for row in rows:
        T = float(row[0])
        i, j = int(row[1]) - 1, int(row[2]) - 1
        a = float(row[3])
        if T == 0.0:            # omega = infinity
            Ainf[i, j] = rho * a
            has_Ainf = True
        elif T < 0.0:           # omega = 0
            A0[i, j] = rho * a
            has_A0 = True
        else:
            b = float(row[4]) if len(row) > 4 else 0.0
            finite.setdefault(T, []).append((i, j, a, b))
    periods = sorted(finite.keys(), reverse=True)      # ascending omega
    w = 2.0 * np.pi / np.array(periods)
    nw = len(w)
    A = np.zeros((nw, 6, 6))
    B = np.zeros((nw, 6, 6))
    for iw, T in enumerate(periods):
        for i, j, a, b in finite[T]:
            A[iw, i, j] = rho * a
            B[iw, i, j] = rho * w[iw] * b
    return w, A, B, (A0 if has_A0 else None), (Ainf if has_Ainf else None)


def read_wamit_3(path, rho=1025.0, g=9.81):
    """Read a WAMIT `.3` excitation file -> (w, headings_deg, X[nw, nh, 6])."""
    data = {}
    heads = set()
    with open(path) as f:
        for ln in f:
            row = ln.split()
            if not row:
                continue
            T = float(row[0])
            beta = float(row[1])
            i = int(row[2]) - 1
            re, im = float(row[5]), float(row[6])
            data[(T, beta, i)] = re + 1j * im
            heads.add(beta)
    periods = sorted({k[0] for k in data}, reverse=True)
    headings = np.array(sorted(heads))
    w = 2.0 * np.pi / np.array(periods)
    X = np.zeros((len(w), len(headings), 6), complex)
    for iw, T in enumerate(periods):
        for ih, beta in enumerate(headings):
            for i in range(6):
                X[iw, ih, i] = rho * g * data.get((T, beta, i), 0.0)
    return w, headings, X


def read_coeffs(file1, file3=None, rho=1025.0, g=9.81):
    """Load a coefficient set from WAMIT-format files."""
    w, A, B, A0, Ainf = read_wamit_1(file1, rho=rho)
    headings = X = None
    if file3 is not None:
        w3, headings, X3 = read_wamit_3(file3, rho=rho, g=g)
        if len(w3) != len(w) or not np.allclose(w3, w, rtol=1e-6):
            # re-interpolate excitation onto the .1 grid
            X = np.empty((len(w), len(headings), 6), complex)
            for ih in range(len(headings)):
                for i in range(6):
                    X[:, ih, i] = np.interp(w, w3, X3[:, ih, i].real) + 1j * np.interp(
                        w, w3, X3[:, ih, i].imag
                    )
        else:
            X = X3
    return HydroCoeffs(w=w, A=A, B=B, headings=headings, X=X, A0=A0, Ainf=Ainf)


def write_wamit_1(path, coeffs, rho=1025.0):
    """Write the `.1` format (round-trip/interop; inverse of read_wamit_1)."""
    with open(path, "w") as f:
        if coeffs.A0 is not None:
            for i in range(6):
                for j in range(6):
                    if coeffs.A0[i, j] != 0.0:
                        f.write(
                            f"{-1.0:14.6E} {i+1:5d} {j+1:5d} "
                            f"{coeffs.A0[i, j] / rho:13.6E}\n"
                        )
        if coeffs.Ainf is not None:
            for i in range(6):
                for j in range(6):
                    if coeffs.Ainf[i, j] != 0.0:
                        f.write(
                            f"{0.0:14.6E} {i+1:5d} {j+1:5d} "
                            f"{coeffs.Ainf[i, j] / rho:13.6E}\n"
                        )
        for iw, wi in enumerate(coeffs.w):
            T = 2.0 * np.pi / wi
            for i in range(6):
                for j in range(6):
                    a = coeffs.A[iw, i, j] / rho
                    b = coeffs.B[iw, i, j] / (rho * wi)
                    if a != 0.0 or b != 0.0:
                        f.write(
                            f"{T:14.6E} {i+1:5d} {j+1:5d} {a:13.6E} {b:13.6E}\n"
                        )


def write_wamit_3(path, coeffs, rho=1025.0, g=9.81):
    """Write the `.3` excitation format (inverse of read_wamit_3)."""
    if coeffs.X is None:
        raise ValueError("coefficient set has no excitation data to write")
    if coeffs.headings is None:
        if coeffs.X.ndim == 3 and coeffs.X.shape[1] == 1:
            import warnings

            warnings.warn(
                "write_wamit_3: coefficient set has a single-heading "
                "excitation column but no headings array; labeling it "
                "0.0 deg — set coeffs.headings explicitly if the data "
                "was solved at a different heading",
                stacklevel=2,
            )
            headings = np.array([0.0])
        else:
            raise ValueError(
                "coefficient set has excitation data but no headings; "
                "set coeffs.headings to the wave-heading array (deg)"
            )
    else:
        headings = np.atleast_1d(coeffs.headings)
    with open(path, "w") as f:
        for iw, wi in enumerate(coeffs.w):
            T = 2.0 * np.pi / wi
            for ih, beta in enumerate(headings):
                for i in range(6):
                    x = coeffs.X[iw, ih, i] / (rho * g)
                    f.write(
                        f"{T:14.6E} {beta:10.3f} {i+1:5d} "
                        f"{abs(x):13.6E} {np.degrees(np.angle(x)):10.3f} "
                        f"{x.real:13.6E} {x.imag:13.6E}\n"
                    )


def write_wamit_hst(path, C_hydro, rho=1025.0, g=9.81, ulen=1.0):
    """Write the WAMIT `.hst` hydrostatic-stiffness format (the third file
    of the reference's OpenFAST-handoff tree, e.g.
    reference raft/data/cylinder/Output/Wamit_format/Buoy.hst): rows
    ``i j C(i,j)`` with the standard nondimensionalization
    C(i,j) / (rho g ULEN^k), k = 2 for i,j <= 3, 3 for mixed, 4 for
    rotation-rotation."""
    C = np.asarray(C_hydro, float)
    with open(path, "w") as f:
        for i in range(6):
            for j in range(6):
                k = 2 + (i >= 3) + (j >= 3)
                val = C[i, j] / (rho * g * ulen**k)
                f.write(f"{i+1:6d}{j+1:6d}    {val:.6E}\n")
    return path


def read_wamit_hst(path, rho=1025.0, g=9.81, ulen=1.0):
    """Read a WAMIT `.hst` file back into a dimensional 6x6 matrix."""
    C = np.zeros((6, 6))
    for line in open(path):
        parts = line.split()
        if len(parts) != 3:
            continue
        i, j = int(parts[0]) - 1, int(parts[1]) - 1
        k = 2 + (i >= 3) + (j >= 3)
        C[i, j] = float(parts[2]) * rho * g * ulen**k
    return C


def read_capytaine_nc(path, w_des=None, excitation="total"):
    """Read a Capytaine radiation/diffraction NetCDF dataset into a
    HydroCoeffs set (the BEM-import route the reference validated before
    moving to HAMS — reference tests/test_capytaine_integration.py).

    The classic-NetCDF3 files Capytaine writes are read with
    scipy.io.netcdf_file (no netCDF4/xarray dependency).

    w_des : optional target grid [rad/s]; coefficients are linearly
        interpolated onto it, raising ValueError if it extends outside
        the tabulated range (the reference integration's contract,
        reference tests/test_capytaine_integration.py:31-34).
    excitation : 'total' (Froude-Krylov + diffraction, the physical
        excitation in current Capytaine datasets — **conjugated on
        import** from Capytaine's e^{-i w t} time convention to this
        package's e^{+i w t} convention so phases feed the complex
        impedance solve Z = -w^2 M + i w B + C correctly) or
        'diffraction' (the raw diffraction_force field alone, passed
        through unconjugated — reference-compat ONLY: what the
        reference's removed integration consumed as fEx; its golden
        arrays match this raw field bit-exactly, so this path exists to
        reproduce them, not to drive response solves).
    """
    from scipy.io import netcdf_file

    with netcdf_file(path, "r", mmap=False) as f:
        w = np.asarray(f.variables["omega"][:], float)
        # dims (omega, radiating_dof, influenced_dof) -> A[w, i, j] with
        # i the force DOF (influenced) and j the motion DOF (radiating)
        A = np.transpose(np.asarray(f.variables["added_mass"][:], float),
                         (0, 2, 1))
        B = np.transpose(
            np.asarray(f.variables["radiation_damping"][:], float), (0, 2, 1)
        )
        diff = np.asarray(f.variables["diffraction_force"][:], float)
        fk = np.asarray(f.variables["Froude_Krylov_force"][:], float)
        if excitation == "total":
            # conjugate: Capytaine e^{-iwt} -> package e^{+iwt}
            X = (diff[0] + fk[0]) - 1j * (diff[1] + fk[1])  # [w, ndir, 6]
        elif excitation == "diffraction":
            X = diff[0] + 1j * diff[1]
        else:
            raise ValueError(
                f"excitation must be 'total' or 'diffraction', "
                f"got {excitation!r}"
            )
        headings = np.degrees(
            np.asarray(f.variables["wave_direction"][:], float)
        )

    order = np.argsort(w)
    w, A, B, X = w[order], A[order], B[order], X[order]
    if w_des is not None:
        w_des = np.asarray(w_des, float)
        if w_des.min() < w.min() - 1e-12 or w_des.max() > w.max() + 1e-12:
            raise ValueError(
                f"requested frequency range [{w_des.min():.3f}, "
                f"{w_des.max():.3f}] rad/s extends outside the Capytaine "
                f"data range [{w.min():.3f}, {w.max():.3f}]"
            )
        interp = lambda col: np.interp(w_des, w, col)   # noqa: E731
        A = np.stack([
            np.stack([interp(A[:, i, j]) for j in range(6)], -1)
            for i in range(6)
        ], -2)
        B = np.stack([
            np.stack([interp(B[:, i, j]) for j in range(6)], -1)
            for i in range(6)
        ], -2)
        X = np.stack([
            np.stack([
                interp(X[:, h, i].real) + 1j * interp(X[:, h, i].imag)
                for i in range(6)
            ], -1)
            for h in range(X.shape[1])
        ], -2)
        w = w_des
    return HydroCoeffs(w=w, A=A, B=B, headings=headings, X=X)


def interp_to_grid(coeffs, w, beta=0.0):
    """Interpolate a HydroCoeffs set onto the model grid `w` [rad/s].

    Mirrors the reference's semantics (raft/raft_fowt.py:398-406): added
    mass is extended toward omega=0 with the zero-frequency value when
    available (else the lowest-frequency value), damping tends to zero at
    omega=0, excitation is linearly interpolated; out-of-range frequencies
    clamp to the nearest data (np.interp semantics).  NaNs raise, matching
    the reference's guards (raft_fowt.py:409-420).

    beta : wave heading (deg) — the excitation is linearly interpolated
    between the two bracketing tabulated headings (clamped outside the
    tabulated range; the reference supports only one heading,
    per-case selection + interpolation are extensions here).

    Returns (A[nw,6,6], B[nw,6,6], X[nw,6] complex).
    """
    wB = coeffs.w
    nw = len(w)
    A = np.empty((nw, 6, 6))
    B = np.empty((nw, 6, 6))
    A_lo = coeffs.A0 if coeffs.A0 is not None else coeffs.A[0]
    wA = np.concatenate([[0.0], wB])
    if coeffs.Ainf is not None:
        # anchor the high-frequency end at the tabulated omega=inf limit
        # (placed just past the model grid so in-range data is untouched)
        w_hi = max(wB[-1], np.max(w)) * 2.0
        wA = np.concatenate([wA, [w_hi]])
    for i in range(6):
        for j in range(6):
            col = np.concatenate([[A_lo[i, j]], coeffs.A[:, i, j]])
            if coeffs.Ainf is not None:
                col = np.concatenate([col, [coeffs.Ainf[i, j]]])
            A[:, i, j] = np.interp(w, wA, col)
            B[:, i, j] = np.interp(
                w, np.concatenate([[0.0], wB]),
                np.concatenate([[0.0], coeffs.B[:, i, j]]),
            )
    X = np.zeros((nw, 6), complex)
    if coeffs.X is not None:
        hs = np.asarray(coeffs.headings, float)
        order = np.argsort(hs)
        hs_s = hs[order]
        if len(hs_s) == 1 or beta <= hs_s[0]:
            Xh = coeffs.X[:, order[0], :]
        elif beta >= hs_s[-1]:
            Xh = coeffs.X[:, order[-1], :]
        else:
            j = int(np.searchsorted(hs_s, beta))
            t = (beta - hs_s[j - 1]) / (hs_s[j] - hs_s[j - 1])
            Xh = ((1.0 - t) * coeffs.X[:, order[j - 1], :]
                  + t * coeffs.X[:, order[j], :])
        for i in range(6):
            X[:, i] = np.interp(w, wB, Xh[:, i].real) + 1j * np.interp(
                w, wB, Xh[:, i].imag
            )
    for name, arr in (("added mass", A), ("damping", B), ("excitation", X)):
        if np.isnan(arr).any():
            raise Exception(
                f"NaN values detected in BEM {name} coefficients. "
                f"Check the input data."
            )
    return A, B, X
