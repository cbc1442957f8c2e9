"""The port's windIO turbine converter (raft_tpu_torch/io/iea.py)
against raft_tpu's on tests/test_iea_convert.py's synthetic windIO
description: equal outputs, the same mismatched-AoA error, and the same
YAML file written."""

import numpy as np
import pytest
import yaml

from raft_tpu.io import iea as ji
from raft_tpu_torch.io import iea as ti
from tests.test_iea_convert import _synthetic_windio


def _plain(obj):
    """NumPy scalars -> Python floats, for yaml.safe_dump."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_plain(v) for v in obj]
    return obj.item() if isinstance(obj, np.generic) else obj


def _equal(a, b, path="turbine"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        assert np.array_equal(a, b), path
    else:
        assert type(a) is type(b) and a == b, path


@pytest.mark.parametrize("n_span", [30, 7])
def test_convert_equals_raft_tpu(n_span):
    _equal(ji.convert_iea_turbine(_synthetic_windio(), n_span=n_span),
           ti.convert_iea_turbine(_synthetic_windio(), n_span=n_span))


def test_hub_height_from_the_tower_when_not_stated():
    wt = _synthetic_windio()
    del wt["assembly"]["rotor_diameter"]
    del wt["environment"]
    out = ti.convert_iea_turbine(wt)
    _equal(ji.convert_iea_turbine(_synthetic_windio() | {
        "assembly": wt["assembly"], "environment": {}}), out)
    assert out["Zhub"] == 144.0
    assert out["env"] == {"rho": 1.225, "mu": 1.81e-5, "shearExp": 0.12}


@pytest.mark.parametrize("coeff", ["c_d", "c_m"])
def test_mismatched_aoa_grids_raise_raft_tpu_message(coeff):
    msgs = []
    for mod in (ji, ti):
        wt = _synthetic_windio()
        wt["airfoils"][0]["polars"][0][coeff]["grid"] = [-3.0, 0.0, 3.0]
        with pytest.raises(ValueError, match="not consistent") as e:
            mod.convert_iea_turbine(wt)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_yaml_round_trip_writes_raft_tpu_file(tmp_path):
    src = tmp_path / "windio.yaml"
    src.write_text(yaml.safe_dump(_plain(_synthetic_windio())))
    out_j, out_t = tmp_path / "jax.yaml", tmp_path / "port.yaml"
    ji.convert_iea_turbine(str(src), out_path=str(out_j))
    t = ti.convert_iea_turbine(str(src), out_path=str(out_t))
    assert out_t.read_text() == out_j.read_text()
    loaded = yaml.safe_load(out_t.read_text())["turbine"]
    np.testing.assert_allclose(np.asarray(loaded["blade"]["geometry"]),
                               t["blade"]["geometry"], atol=1e-4)
    assert loaded["airfoils"][0]["key"] == ["alpha", "c_l", "c_d", "c_m"]
