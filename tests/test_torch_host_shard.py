"""The rotor's host workers (raft_tpu_torch/aero.py
``Rotor.run_bem_batch(n_devices=...)``) against themselves bit for bit
and against raft_tpu's host mesh on its 8 virtual CPU devices
(tests/test_host_shard.py's cases).

The lanes are cut into fixed 64-lane blocks (the last lane repeated to
fill whole super-blocks of 64 x n) and the blocks dealt to n worker
threads, each block one program on one intra-op thread, so every width
gives the same bits, on the plain (bracketed) path and the guided one.
"""

import numpy as np
import pytest

from raft_tpu_torch.aero import _LANE_BLOCK, Rotor
from raft_tpu_torch.designs import demo_rotor_turbine

W = np.arange(0.02, 0.6, 0.02) * 2 * np.pi


@pytest.fixture(scope="module")
def rotor():
    return Rotor(demo_rotor_turbine(), W)


def _lanes(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(5.0, 20.0, n), rng.uniform(-0.05, 0.10, n),
            rng.uniform(-0.15, 0.15, n))


def test_widths_are_bit_identical(rotor):
    """96 lanes (ragged: each width pads differently) and 200 lanes over
    1, 2 and 4 workers; never more workers than 64-lane blocks."""
    for n in (96, 200):
        U, pitch, yaw = _lanes(n)
        v1, J1 = rotor.run_bem_batch(U, pitch, yaw, n_devices=1)
        assert rotor.last_batch_info == {
            "lanes": n, "lanes_padded": -(-n // 64) * 64, "n_devices": 1,
            "dispatches": -(-n // 64), "guided": False}
        for k in (2, 4):
            vk, Jk = rotor.run_bem_batch(U, pitch, yaw, n_devices=k)
            info = rotor.last_batch_info
            assert info["n_devices"] == min(k, -(-n // _LANE_BLOCK))
            assert info["lanes_padded"] % (64 * info["n_devices"]) == 0
            assert np.array_equal(vk, v1) and np.array_equal(Jk, J1)


def test_guided_widths_are_bit_identical(rotor):
    """The guided path (phi0): vals, J, phi and the per-lane residual."""
    U, pitch, yaw = _lanes(96, seed=1)
    _, _, phi = rotor.run_bem_batch(U, pitch, yaw, return_phi=True,
                                    n_devices=1)
    args = dict(phi0=phi, return_phi=True, return_resid=True)
    out1 = rotor.run_bem_batch(U, pitch + 1e-4, yaw, n_devices=1, **args)
    for k in (2, 4):
        outk = rotor.run_bem_batch(U, pitch + 1e-4, yaw, n_devices=k,
                                   **args)
        assert rotor.last_batch_info["guided"] is True
        for a1, ak in zip(out1, outk):
            assert np.array_equal(ak, a1)
    assert float(np.max(out1[3])) <= 1e-8


def test_host_devices_is_the_default_width():
    """Rotor(host_devices=2) deals blocks to two workers when not given
    n_devices; the default evaluates a batch as one program."""
    U, pitch, yaw = _lanes(130, seed=2)
    r2 = Rotor(demo_rotor_turbine(), W, host_devices=2)
    v2, J2 = r2.run_bem_batch(U, pitch, yaw)
    assert r2.last_batch_info["n_devices"] == 2
    r1 = Rotor(demo_rotor_turbine(), W)
    v1, J1 = r1.run_bem_batch(U, pitch, yaw, n_devices=1)
    assert np.array_equal(v2, v1) and np.array_equal(J2, J1)
    v, J = r1.run_bem_batch(U, pitch, yaw)
    assert r1.last_batch_info == {"lanes": 130, "lanes_padded": 130,
                                  "n_devices": 1, "dispatches": 1,
                                  "guided": False}
    assert np.abs(v - v1).max() <= 1e-12 * np.abs(v1).max()
    with pytest.raises(ValueError):
        Rotor(demo_rotor_turbine(), W, host_devices=0)


@pytest.mark.parametrize("guided", [False, True], ids=["plain", "guided"])
def test_matches_raft_tpu_host_mesh(rotor, guided):
    """raft_tpu's run_bem_batch over 2 of its host devices and the port's
    over 2 workers: vals and J within 1e-8 of the largest value of each
    output, the same batch info."""
    from raft_tpu.aero import Rotor as JRotor
    from raft_tpu.designs import demo_rotor_turbine as jturbine

    jr = JRotor(jturbine(), W)
    U, pitch, yaw = _lanes(96, seed=3)
    kw = {}
    if guided:
        _, _, phi = rotor.run_bem_batch(U, pitch, yaw, return_phi=True,
                                        n_devices=1)
        kw = dict(phi0=phi)
        pitch = pitch + 1e-4
    jv, jJ = jr.run_bem_batch(U, pitch, yaw, n_devices=2, **kw)[:2]
    v, J = rotor.run_bem_batch(U, pitch, yaw, n_devices=2, **kw)[:2]
    assert rotor.last_batch_info == jr.last_batch_info
    scale_v = np.abs(jv).max(axis=0) + 1e-30
    scale_J = np.abs(jJ).max(axis=0) + 1e-30
    assert (np.abs(v - jv) / scale_v).max() <= 1e-8
    assert (np.abs(J - jJ) / scale_J).max() <= 1e-8
