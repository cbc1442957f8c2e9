"""IEA Wind Task 37 ontology ("windIO") turbine YAML -> RAFT design schema.

Re-provides the reference's converter (reference
raft/helpers.py:518-663 convertIEAturbineYAML2RAFT) without the WISDEM
dependency: the ontology file is parsed directly with PyYAML and the
blade reference-axis arc length is computed in-line.

The returned dict plugs straight into a design's ``turbine`` section
(the format consumed by raft_tpu_torch.aero.Rotor: ``blade.geometry``
columns [r, chord, theta, precurve, presweep], ``blade.airfoils`` as
(position, name) pairs, ``airfoils`` as name/relative_thickness/data
polar tables in degrees).

PyYAML is imported only where a YAML file is read or written, so the
converter runs on a parsed dict without it.
"""

import numpy as np


def _interp_axis(grid, entry):
    return np.interp(grid, entry["grid"], entry["values"])


def _arc_length(points):
    """Cumulative arc length along a polyline [n,3]
    (WISDEM's commonse.utilities.arc_length equivalent)."""
    seg = np.linalg.norm(np.diff(points, axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(seg)])


def convert_iea_turbine(source, n_span=30, out_path=None):
    """Convert an IEA-ontology turbine description (YAML path or parsed
    dict) to the RAFT ``turbine`` schema.

    Parameters
    ----------
    source : str | dict
        Path to a windIO geometry YAML (e.g. IEA-15-240-RWT.yaml) or the
        already-parsed dict.
    n_span : int
        Number of equally spaced blade stations (interior stations carry
        the distributed geometry; the tip sets Rtip/precurveTip).
    out_path : str | None
        Optionally also write the result as a RAFT-style YAML file.
    """
    if isinstance(source, dict):
        wt = source
    else:
        import yaml

        with open(source) as f:
            wt = yaml.safe_load(f)

    hub = wt["components"]["hub"]
    drivetrain = wt["components"]["nacelle"]["drivetrain"]
    assembly = wt["assembly"]
    Rhub = 0.5 * hub["diameter"]

    out = {
        "nBlades": int(assembly["number_of_blades"]),
        "precone": float(np.rad2deg(hub["cone_angle"])),
        "shaft_tilt": float(np.rad2deg(drivetrain["uptilt"])),
        "overhang": float(drivetrain["overhang"]),
        "Rhub": float(Rhub),
    }

    grid = np.linspace(0.0, 1.0, n_span)
    blade = wt["components"]["blade"]["outer_shape_bem"]
    axis = np.column_stack(
        [_interp_axis(grid, blade["reference_axis"][c]) for c in "xyz"]
    )
    # rescale the z axis so the swept radius matches the stated rotor
    # diameter (the ontology's reference axis is along the curved blade)
    rotor_diameter = assembly.get("rotor_diameter", 0.0)
    if rotor_diameter:
        axis[:, 2] *= rotor_diameter / (2.0 * (_arc_length(axis)[-1] + Rhub))

    r = axis[1:-1, 2] + Rhub
    chord = _interp_axis(grid[1:-1], blade["chord"])
    theta = np.rad2deg(_interp_axis(grid[1:-1], blade["twist"]))
    geometry = np.column_stack(
        [r, chord, theta, axis[1:-1, 0], axis[1:-1, 1]]
    )
    out["blade"] = {
        "geometry": geometry,
        "Rtip": float(axis[-1, 2] + Rhub),
        "precurveTip": float(axis[-1, 0]),
        "presweepTip": float(axis[-1, 1]),
        "airfoils": list(zip(
            blade["airfoil_position"]["grid"],
            blade["airfoil_position"]["labels"],
        )),
    }

    if assembly.get("hub_height", 0.0):
        out["Zhub"] = float(assembly["hub_height"])
    else:
        tower_z = wt["components"]["tower"]["outer_shape_bem"][
            "reference_axis"]["z"]["values"]
        out["Zhub"] = float(tower_z[-1] + drivetrain["distance_tt_hub"])

    env = wt.get("environment", {})
    out["env"] = {
        "rho": env.get("air_density", 1.225),
        "mu": env.get("air_dyn_viscosity", 1.81e-5),
        "shearExp": env.get("shear_exp", 0.12),
    }

    out["airfoils"] = []
    for af in wt["airfoils"]:
        polar = af["polars"][0]
        if len(af["polars"]) > 1:
            print(f"Warning for airfoil {af['name']}, only the first polar "
                  "entry is used.")
        aoa = np.asarray(polar["c_l"]["grid"], float)
        for coeff in ("c_d", "c_m"):
            if not np.array_equal(aoa, np.asarray(polar[coeff]["grid"], float)):
                raise ValueError(
                    f"AOA grids for airfoil {af['name']} are not consistent "
                    f"between c_l and {coeff}."
                )
        out["airfoils"].append({
            "name": af["name"],
            "relative_thickness": af["relative_thickness"],
            "data": np.column_stack([
                np.rad2deg(aoa),
                polar["c_l"]["values"],
                polar["c_d"]["values"],
                polar["c_m"]["values"],
            ]),
        })

    if out_path:
        write_raft_turbine_yaml(out_path, out)
    return out


def write_raft_turbine_yaml(path, turbine):
    """Write the converted turbine as a RAFT-style YAML file (the reference
    hand-formats this output, helpers.py:616-663)."""
    import yaml

    d = dict(turbine)
    blade = dict(d["blade"])
    blade["geometry"] = [[round(float(v), 4) for v in row]
                         for row in np.asarray(blade["geometry"])]
    blade["airfoils"] = [[float(p), str(n)] for p, n in blade["airfoils"]]
    d["blade"] = blade
    d["airfoils"] = [
        {
            "name": af["name"],
            "relative_thickness": af["relative_thickness"],
            "key": ["alpha", "c_l", "c_d", "c_m"],
            "data": [[round(float(v), 6) for v in row]
                     for row in np.asarray(af["data"])],
        }
        for af in d["airfoils"]
    ]
    with open(path, "w") as f:
        f.write("# RAFT-style YAML inputs for turbine\n")
        yaml.safe_dump({"turbine": d}, f, sort_keys=False,
                       default_flow_style=None)
    return path
