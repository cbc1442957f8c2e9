"""The mixed-precision policy's own RAO error on the flagship problem, in
raft_tpu and in its port, on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_mp_policy_linf.py

Runs the flagship (``designs.flagship(0.00625, 0.8, 12)``: 128
frequencies x 12 JONSWAP cases) through ``analyze_cases`` in float64
without the policy, then with it (raft_tpu: ``RAFT_TPU_MIXED_PRECISION=1``
set before each Model traces its pipeline; the port:
``Model(..., mixed_precision=True)``) in float64 and in float32 working
dtype, and prints each run's RAO L-inf against the float64 run without
the policy, relative to the peak RAO (the measure chip_smoke.py prints
for its card run), and the port's against raft_tpu's in the same
configuration.
"""

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import raft_tpu  # noqa: E402
import raft_tpu_torch  # noqa: E402


def rao(Xi, zeta):
    mask = np.abs(zeta) > 1e-3
    return np.abs(Xi) / np.where(mask, np.abs(zeta), np.inf)[:, None]


def linf_rel(a, ref):
    return float(np.abs(a - ref).max() / ref.max())


def run_raft_tpu(precision, mixed):
    os.environ.pop("RAFT_TPU_MIXED_PRECISION", None)
    if mixed:
        os.environ["RAFT_TPU_MIXED_PRECISION"] = "1"
    m = raft_tpu.Model(raft_tpu_torch.designs.flagship(0.00625, 0.8, 12),
                       precision=precision)
    m.analyze_unloaded()
    m.analyze_cases()
    os.environ.pop("RAFT_TPU_MIXED_PRECISION", None)
    return rao(m.Xi, m.zeta)


def run_port(precision, mixed):
    m = raft_tpu_torch.Model(
        raft_tpu_torch.designs.flagship(0.00625, 0.8, 12), device="cpu",
        precision=precision, mixed_precision=mixed)
    m.analyze_unloaded()
    m.analyze_cases()
    return rao(m.Xi, m.zeta)


def main():
    ref = {"raft_tpu": run_raft_tpu("float64", False),
           "port": run_port("float64", False)}
    print(f"float64 without the policy: port vs raft_tpu "
          f"{linf_rel(ref['port'], ref['raft_tpu']):.4e}", flush=True)
    for precision in ("float64", "float32"):
        jx = run_raft_tpu(precision, True)
        tx = run_port(precision, True)
        print(f"mixed precision, {precision} working dtype: RAO L-inf vs "
              f"float64 raft_tpu {linf_rel(jx, ref['raft_tpu']):.4e} port "
              f"{linf_rel(tx, ref['port']):.4e}; port vs raft_tpu "
              f"{linf_rel(tx, jx):.4e}", flush=True)


if __name__ == "__main__":
    main()
