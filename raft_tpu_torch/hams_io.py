"""HAMS interop: the input-file tree the Fortran HAMS BEM solver consumes —
the port's NumPy copy of ``raft_tpu/hams_io.py``.

The reference shells out to HAMS through pyHAMS (reference
raft/raft_fowt.py:363-391: create_hams_dirs, write_hydrostatic_file,
write_control_file, run_hams), and its ``preprocess_HAMS`` path exists to
produce WAMIT-format `.1`/`.3`/`.hst` files for OpenFAST.  Here the same
file surface is generated natively so that

 - an external HAMS/WAMIT run can still be used as the hydrodynamics source
   (drop-in directory layout, then ``Model.import_bem`` on its output), and
 - ``Model.preprocess_hams`` produces the OpenFAST-handoff files from the
   in-package panel solver with no Fortran dependency.

Formats follow the published HAMS v3 input conventions (ControlFile.in,
Hydrostatic.in, Input/HullMesh.pnl).
"""

import os

import numpy as np


def create_hams_dirs(mesh_dir):
    """Create the HAMS working tree (Input/, Output/{Wamit,Hams}_format)."""
    for sub in ("Input", os.path.join("Output", "Wamit_format"),
                os.path.join("Output", "Hams_format")):
        os.makedirs(os.path.join(mesh_dir, sub), exist_ok=True)
    return mesh_dir


def _mat6(f, M):
    for row in np.asarray(M, float):
        f.write("   " + "  ".join(f"{v: .6E}" for v in row) + "\n")


def write_hydrostatic_file(mesh_dir, k_hydro=None, center=(0.0, 0.0, 0.0),
                           mass=None, damping_lin=None, damping_quad=None,
                           k_ext=None):
    """Write Hydrostatic.in: body center + the stacked 6x6 matrices HAMS
    expects (only the restoring matrix matters for the .1/.3 path; the rest
    default to zero, matching the reference's usage where the file is
    'unused for .1 and .3' — raft/raft_fowt.py:371-373)."""
    z6 = np.zeros((6, 6))
    path = os.path.join(mesh_dir, "Hydrostatic.in")
    with open(path, "w") as f:
        f.write(" Center of Gravity:\n")
        f.write("   " + "  ".join(f"{v: .6E}" for v in center) + "\n")
        f.write(" Body Mass Matrix:\n")
        _mat6(f, mass if mass is not None else z6)
        f.write(" External Linear Damping Matrix:\n")
        _mat6(f, damping_lin if damping_lin is not None else z6)
        f.write(" External Quadratic Damping Matrix:\n")
        _mat6(f, damping_quad if damping_quad is not None else z6)
        f.write(" Hydrostatic Restoring Matrix:\n")
        _mat6(f, k_hydro if k_hydro is not None else z6)
        f.write(" External Restoring Matrix:\n")
        _mat6(f, k_ext if k_ext is not None else z6)
    return path


def write_control_file(mesh_dir, water_depth=50.0, inc_f_lim=1, i_f_type=3,
                       o_f_type=4, num_freqs=-100, min_freq=0.01,
                       d_freq=0.01, num_headings=1, min_heading=0.0,
                       d_heading=0.0, ref_center=(0.0, 0.0, 0.0),
                       n_threads=4, note=None):
    """Write ControlFile.in (frequency/heading schedule; negative
    Number_of_frequencies means an evenly spaced grid, HAMS convention —
    the reference passes numFreqs=-nw, raft/raft_fowt.py:381-382).

    ``note``, when given, is appended after the end-of-file marker (so
    the fixed line layout an external HAMS parser expects is untouched) —
    used to flag when the emitted Buoy.1/.3 deviate from this schedule
    (e.g. mesh-resolution frequency clamping)."""
    path = os.path.join(mesh_dir, "ControlFile.in")
    with open(path, "w") as f:
        f.write("   --------------HAMS Control file---------------\n\n")
        f.write(f"   Waterdepth  {float(water_depth):.4f}\n\n")
        f.write("   #Start Definition of Wave Frequencies\n")
        f.write(f"    0_inf_frequency_limits  {inc_f_lim}\n")
        f.write(f"    Input_frequency_type    {i_f_type}\n")
        f.write(f"    Output_frequency_type   {o_f_type}\n")
        f.write(f"    Number_of_frequencies  {num_freqs}\n")
        f.write(f"    Minimum_frequency_Wmin  {min_freq:.6f}\n")
        f.write(f"    Frequency_step          {d_freq:.6f}\n")
        f.write("   #End Definition of Wave Frequencies\n\n")
        f.write("   #Start Definition of Wave Headings\n")
        f.write(f"    Number_of_headings      {num_headings}\n")
        f.write(f"    Minimum_heading         {min_heading:.4f}\n")
        f.write(f"    Heading_step            {d_heading:.4f}\n")
        f.write("   #End Definition of Wave Headings\n\n")
        f.write("    Reference_body_center   "
                + "  ".join(f"{v:.4f}" for v in ref_center) + "\n")
        f.write("    Reference_body_length   1.0\n")
        f.write("    Wave-diffrac-solution   2\n")
        f.write("    If_remove_irr_freq      0\n")
        f.write(f"    Number of threads       {n_threads}\n\n")
        f.write("    ----------End HAMS Control file---------------\n")
        if note:
            f.write(f"    NOTE: {note}\n")
    return path


def read_control_file(path):
    """Parse the frequency/heading schedule back out of a ControlFile.in
    (round-trip check + interop with externally prepared HAMS cases)."""
    out = {}
    key_map = {
        "Waterdepth": ("water_depth", float),
        "Number_of_frequencies": ("num_freqs", int),
        "Minimum_frequency_Wmin": ("min_freq", float),
        "Frequency_step": ("d_freq", float),
        "Number_of_headings": ("num_headings", int),
        "Minimum_heading": ("min_heading", float),
        "Heading_step": ("d_heading", float),
    }
    with open(path) as f:
        for ln in f:
            parts = ln.split()
            if len(parts) >= 2 and parts[0] in key_map:
                name, cast = key_map[parts[0]]
                out[name] = cast(float(parts[1]))
    return out
