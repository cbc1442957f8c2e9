"""The port's wind module (raft_tpu_torch/wind.py) against raft_tpu.wind:
the IEC turbulence models, the case turbulence parser, the rotor-averaged
Kaimal spectrum, and the IEC transient events of
tests/test_wind_transients.py (the same closed-form checks on the port's
copy, and every table equal to raft_tpu's)."""

import numpy as np
import pytest

from raft_tpu import wind as jw
from raft_tpu_torch import wind as tw

W = np.linspace(0.01, 6.0, 128)


@pytest.mark.parametrize("turbulence", [0.14, "IB_NTM", "IIA_ETM",
                                        "IIIC_EWM", "IVA+_NTM"])
@pytest.mark.parametrize("V_ref,HH,R", [(8.0, 140.0, 60.0),
                                        (18.0, 55.0, 40.0)])
def test_kaimal_rotor_spectrum_matches(turbulence, V_ref, HH, R):
    out_t = tw.kaimal_rotor_spectrum(W, V_ref, HH, R, turbulence)
    out_j = jw.kaimal_rotor_spectrum(W, V_ref, HH, R, turbulence)
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a, b)
    assert np.isfinite(out_t[3]).all() and (out_t[3] >= 0).all()


@pytest.mark.parametrize("turbulence", [0.1, "IB_NTM", "IIA_ETM",
                                        "IVC_EWM"])
def test_parse_turbulence_and_iec_models_match(turbulence):
    assert tw.parse_turbulence(turbulence) == jw.parse_turbulence(turbulence)
    _, cls, categ, _ = tw.parse_turbulence(turbulence)
    it, ij = tw.IECWind(cls, categ, 90.0), jw.IECWind(cls, categ, 90.0)
    for V in (4.0, 11.0, 25.0):
        for model in ("NTM", "ETM", "EWM"):
            assert getattr(it, model)(V) == getattr(ij, model)(V)
    assert it.EWM_speeds() == ij.EWM_speeds()


@pytest.mark.parametrize("bad", ["XB_NTM", "IB"])
def test_parse_turbulence_rejects_like_raft_tpu(bad):
    with pytest.raises(ValueError):
        jw.parse_turbulence(bad)
    with pytest.raises(ValueError):
        tw.parse_turbulence(bad)


@pytest.fixture
def gen():
    return tw.IECTransients(turbine_class="I", turbulence_class="B",
                            z_hub=90.0, D=126.0)


@pytest.mark.parametrize("event,V_hub", [("EOG", 12.0), ("EDC", 10.0),
                                         ("ECD", 3.0), ("ECD", 12.0),
                                         ("EWS", 11.0)])
def test_transient_tables_match_raft_tpu(gen, event, V_hub):
    ref = jw.IECTransients(turbine_class="I", turbulence_class="B",
                           z_hub=90.0, D=126.0)
    (ev_t, s_t), (ev_j, s_j) = (getattr(g, event)(V_hub)
                                for g in (gen, ref))
    assert s_t == s_j
    assert [lbl for lbl, _ in ev_t] == [lbl for lbl, _ in ev_j]
    for (_, a), (_, b) in zip(ev_t, ev_j):
        np.testing.assert_array_equal(a, b)


def test_eog_amplitude_and_shape(gen):
    V_hub = 12.0
    events, sigma_1 = gen.EOG(V_hub)
    label, table = events[0]
    assert len(events) == 1 and label == "EOG"
    t, gust = table[:, 0], table[:, 7]
    iec = tw.IECWind("I", "B", z_hub=90.0)
    expect = min(1.35 * (0.8 * 1.4 * 50.0 - V_hub),
                 3.3 * iec.NTM(V_hub) / (1 + 0.1 * 126.0 / 42.0))
    assert np.isclose(sigma_1, iec.NTM(V_hub))
    assert np.isclose(-gust.min(), 0.37 * expect * np.nanmax(
        np.sin(3 * np.pi * t / 10.5) * (1 - np.cos(2 * np.pi * t / 10.5))
    ), rtol=1e-6)
    assert gust[0] == 0.0 and abs(gust[-1]) < 1e-9
    np.testing.assert_allclose(table[:, 1], V_hub)


def test_edc_direction_ramp_and_clamp(gen):
    V_hub = 10.0
    events, sigma_1 = gen.EDC(V_hub)
    assert [lbl for lbl, _ in events] == ["EDC_P", "EDC_N"]
    theta_e = np.rad2deg(
        4 * np.arctan(sigma_1 / (V_hub * (1 + 0.01 * 126.0 / 42.0))))
    for sign, (_, table) in zip([1, -1], events):
        d = table[:, 2]
        assert d[0] == 0.0
        np.testing.assert_allclose(d[-1], sign * theta_e, rtol=1e-9)
        assert (np.sign(np.diff(d)) == sign)[1:-1].all()
    wide = tw.IECTransients(z_hub=90.0, D=1e5, dir_change="+")
    assert np.abs(wide.EDC(0.5)[0][0][1][:, 2]).max() <= 180.0


def test_ecd_speed_rise_and_low_wind_theta(gen):
    _, table = gen.ECD(3.0)[0][0]
    np.testing.assert_allclose(table[-1, 2], 180.0)
    np.testing.assert_allclose(table[-1, 1], 3.0 + 15.0, rtol=1e-9)
    np.testing.assert_allclose(gen.ECD(12.0)[0][0][1][-1, 2], 720.0 / 12.0)


def test_ews_variants_and_columns(gen):
    events, sigma_1 = gen.EWS(11.0)
    assert [lbl for lbl, _ in events] == ["EWS_V_P", "EWS_H_P", "EWS_V_N",
                                          "EWS_H_N"]
    amp = (2.5 + 0.2 * 6.4 * sigma_1 * (126.0 / 42.0) ** 0.25) * 2 / 11.0
    for lbl, table in events:
        col, other = (6, 4) if "_V_" in lbl else (4, 6)
        assert np.isclose(np.abs(table[:, col]).max(), amp, rtol=1e-9)
        assert np.abs(table[:, other]).max() == 0.0
        assert abs(table[-1, col]) < 1e-9


def test_write_wnd_matches_raft_tpu_rows(gen, tmp_path):
    ref = jw.IECTransients(turbine_class="I", turbulence_class="B",
                           z_hub=90.0, D=126.0)
    paths = gen.execute(["EOG", "EDC"], 12.0, outdir=str(tmp_path / "t"),
                        case_name="dlc")
    ref_paths = ref.execute(["EOG", "EDC"], 12.0,
                            outdir=str(tmp_path / "j"), case_name="dlc")
    assert len(paths) == 3
    for p, q in zip(paths, ref_paths):
        rows = [[ln for ln in open(f).read().splitlines()
                 if not ln.startswith("!")] for f in (p, q)]
        assert rows[0] == rows[1]
        data = np.array([[float(x) for x in ln.split()] for ln in rows[0]])
        assert data[0, 0] == gen.T0 and data[-1, 0] == gen.TF
        assert data[1, 0] == gen.T_start and data.shape[1] == 9
