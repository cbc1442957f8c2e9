"""Design-dictionary schema handling: YAML loading and defaulted, shape-checked
value extraction (the reference's de-facto config system,
raft/helpers.py:456-516 getFromDict; YAML surface documented by
examples/VolturnUS-S_example.yaml and designs/*.yaml).

Host-side, plain Python/NumPy — this runs once per design.  PyYAML is
imported only when a YAML path is loaded, so dict designs need no PyYAML.
"""

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


def load_design(source):
    """Load a design dict from a YAML path, pickle path, or pass a dict through
    (reference raft/raft_model.py:1098-1108)."""
    if isinstance(source, dict):
        return source
    s = str(source)
    if s.endswith(".pkl") or s.endswith(".pickle"):
        import pickle

        with open(s, "rb") as f:
            return pickle.load(f)
    import yaml

    with open(s) as f:
        return yaml.load(f, Loader=yaml.FullLoader)


def cases_as_dicts(design):
    """Expand the DLC table (keys + data rows, reference
    examples/VolturnUS-S_example.yaml:21-24) into per-case dicts
    (reference raft/raft_model.py:245)."""
    if "cases" not in design or design["cases"] is None:
        return []
    keys = design["cases"]["keys"]
    return [dict(zip(keys, row)) for row in design["cases"]["data"]]
