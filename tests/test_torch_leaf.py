"""The port's leaf numerics (raft_tpu_torch.utils.frames, .waves, .hydro)
against raft_tpu on the same seeded inputs, at the tolerances of
tests/test_kernels.py (1e-10 on the wave kinematics)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import hydro as jh
from raft_tpu import waves as jw
from raft_tpu.designs import demo_semi
from raft_tpu.geometry import pack_nodes, process_members
from raft_tpu.utils import frames as jf
from raft_tpu_torch import hydro as th
from raft_tpu_torch import waves as tw
from raft_tpu_torch.convert import nodes_from_numpy
from raft_tpu_torch.utils import frames as tf

rng = np.random.default_rng(7)


def T(a):
    return torch.as_tensor(np.array(a))


# ---------------- frames ----------------

def test_frames_match():
    F = rng.normal(size=(5, 3))
    r = rng.normal(size=(5, 3))
    M3 = rng.normal(size=(5, 3, 3))
    M6 = rng.normal(size=(5, 6, 6))
    f6 = rng.normal(size=(5, 6))
    ang = rng.normal(size=(3, 4))
    np.testing.assert_allclose(tf.translate_force_3to6(T(F), T(r)),
                               jf.translate_force_3to6(F, r), rtol=1e-14)
    np.testing.assert_allclose(tf.transform_force(T(f6), offset=T(r[0])),
                               jf.transform_force(f6, offset=r[0]),
                               rtol=1e-13, atol=1e-14)
    R = tf.rotation_matrix(*(T(a) for a in ang))
    np.testing.assert_allclose(R, jf.rotation_matrix(*ang), rtol=1e-14,
                               atol=1e-15)
    np.testing.assert_allclose(
        tf.transform_force(T(f6[:4]), rot=R),
        jf.transform_force(f6[:4], rot=jf.rotation_matrix(*ang)),
        rtol=1e-13, atol=1e-14)
    np.testing.assert_allclose(tf.translate_matrix_3to6(T(M3), T(r)),
                               jf.translate_matrix_3to6(M3, r),
                               rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(tf.translate_matrix_6to6(T(M6), T(r)),
                               jf.translate_matrix_6to6(M6, r),
                               rtol=1e-13, atol=1e-13)


def test_rotation_matrix_derivatives_match_jacfwd():
    """The written-out d R / d (roll, pitch, yaw) the mooring tangents use
    against jax.jacfwd of raft_tpu's rotation_matrix."""
    for ang in rng.normal(size=(4, 3)):
        J = jax.jacfwd(lambda a: jf.rotation_matrix(a[0], a[1], a[2]))(
            jnp.asarray(ang))
        np.testing.assert_allclose(
            tf.rotation_matrix_derivatives(*(T(a) for a in ang)), J,
            rtol=1e-14, atol=1e-15)


# ---------------- waves ----------------

def test_wave_number_and_spectra_match():
    w = np.linspace(0.05, 4.0, 80)
    for h in (20.0, 200.0, 3000.0):
        np.testing.assert_allclose(tw.wave_number(T(w), h),
                                   jw.wave_number(w, h), rtol=1e-13)
    ws = np.arange(0.01, 6.0, 0.01)
    for Hs, Tp, gam in [(2.0, 8.0, 1.0), (6.0, 12.0, 3.3)]:
        np.testing.assert_allclose(tw.jonswap(T(ws), Hs, Tp, gam),
                                   jw.jonswap(ws, Hs, Tp, gam), rtol=1e-12,
                                   atol=1e-300)   # subnormal far tail
    xi = rng.normal(size=(4, 12)) + 1j * rng.normal(size=(4, 12))
    np.testing.assert_allclose(tw.get_rms(T(xi), 0.05),
                               jw.get_rms(xi, 0.05), rtol=1e-14)
    np.testing.assert_allclose(tw.get_psd(T(xi)), jw.get_psd(xi),
                               rtol=1e-14)


@pytest.mark.parametrize("h", [50.0, 320.0])
def test_wave_kinematics_match(h):
    nw = 40
    w = np.linspace(0.03, 2.5, nw)
    k = np.asarray(jw.wave_number(w, h))
    r = np.array([[3.0, -2.0, -10.0], [0.0, 0.0, -45.0], [1.0, 1.0, 2.0]])
    # two cases at once in the port: its leading case axis
    zeta = np.stack([np.sqrt(np.linspace(0.1, 2.0, nw)) * np.exp(1j * 0.3),
                     rng.normal(size=nw) + 1j * rng.normal(size=nw)])
    beta = np.array([0.4, -1.1])
    u, ud, p = tw.wave_kinematics(T(zeta), T(beta), T(w), T(k), h, T(r))
    assert u.shape == (2, 3, 3, nw)
    for c in range(2):
        uj, udj, pj = jw.wave_kinematics(zeta[c], beta[c], w, k, h, r)
        np.testing.assert_allclose(u[c], uj, atol=1e-10, rtol=0)
        np.testing.assert_allclose(ud[c], udj, atol=1e-10, rtol=0)
        np.testing.assert_allclose(p[c], pj, atol=1e-6, rtol=1e-12)
    assert (u[:, 2] == 0).all()          # the node above the surface


# ---------------- hydro ----------------

@pytest.fixture(scope="module")
def nodes():
    jn = pack_nodes(process_members(demo_semi()))
    return jn, nodes_from_numpy(dataclasses.asdict(jn), "cpu", torch.float64)


def test_added_mass_and_spectrum_match(nodes):
    jn, tn = nodes
    np.testing.assert_allclose(th.added_mass_morison(tn, 1025.0),
                               jh.added_mass_morison(jn, 1025.0),
                               rtol=1e-12, atol=1e-6)
    w = np.linspace(0.05, 3.0, 30)
    spec = np.array([0, 1, 2])
    Hs = np.array([1.0, 2.0, 6.0])
    Tp = np.array([5.0, 8.0, 12.0])
    np.testing.assert_allclose(
        th.make_wave_spectrum(T(w)[None], T(spec)[:, None], T(Hs)[:, None],
                              T(Tp)[:, None]),
        jh.make_wave_spectrum(w[None], spec[:, None], Hs[:, None],
                              Tp[:, None]), rtol=1e-13)


def test_excitation_and_drag_match(nodes):
    """Two cases through the port's batched hydro against raft_tpu one
    case at a time."""
    jn, tn = nodes
    nw, h = 24, 200.0
    w = np.linspace(0.1, 2.0, nw)
    k = np.asarray(jw.wave_number(w, h))
    zeta = np.sqrt(np.linspace(0.2, 1.5, nw))[None] * np.array([[1.0], [0.7]])
    beta = np.array([0.0, 0.6])
    Xi = (rng.normal(size=(2, 6, nw)) + 1j * rng.normal(size=(2, 6, nw))) \
        * 0.1
    u, ud, p = tw.wave_kinematics(T(zeta).to(torch.complex128), T(beta),
                                  T(w), T(k), h, tn.r)
    F = th.excitation_froude_krylov(tn, u, ud, p, 1025.0)
    B, Fd = th.linearized_drag(tn, T(Xi), u, T(w), w[1] - w[0], 1025.0)
    for c in range(2):
        uj, udj, pj = jw.wave_kinematics(zeta[c], beta[c], w, k, h, jn.r)
        Fj = jh.excitation_froude_krylov(jn, uj, udj, pj, 1025.0)
        Bj, Fdj = jh.linearized_drag(jn, jnp.asarray(Xi[c]), uj, w,
                                     w[1] - w[0], 1025.0)
        for a, b in ((F[c], Fj), (B[c], Bj), (Fd[c], Fdj)):
            b = np.asarray(b)
            assert np.abs(a.numpy() - b).max() <= 1e-12 * np.abs(b).max()
