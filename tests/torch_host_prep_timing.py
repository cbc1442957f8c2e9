"""Warm host prep and warm ``analyze_cases`` of raft_tpu and of its port
on the CPU, for the flagship and the aero design.

    JAX_PLATFORMS=cpu python tests/torch_host_prep_timing.py [--port-only]

The flagship is ``designs.flagship(0.00625, 0.8, 12)`` (128 frequencies
x 12 JONSWAP cases, aero off); the aero design
``designs.demo_semi_aero(n_cases=12, n_wind=6, nw_settings=(0.00625,
0.8))`` (the same grid and cases, six of them with wind at 8..18 m/s,
aeroServoMod 2).  Each package's Model runs float64 on the CPU; after
one cold call, ``prepare_case_inputs`` and ``analyze_cases`` are each
timed over five warm calls, and the script prints one JSON line per
package and design with the times in seconds, the torch thread count
and the host's CPU count.  ``--port-only`` skips raft_tpu (and jax).

``--ops`` instead times the single PyTorch ops behind two design
choices of the port's host prep, in microseconds per call on tensors of
the host prep's sizes: each op on plain tensors and on
``torch.autograd.forward_ad`` dual tensors (why the rotor carries its
own forward-mode numbers), and ``searchsorted``, ``bucketize`` and
``linalg.solve`` on the default thread pool and on one thread (why host
prep runs on one thread).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PORT_ONLY = "--port-only" in sys.argv
REPS = 5


def designs():
    """The design dicts, from the port's copy of the designs module (the
    flagship is not in raft_tpu.designs; the dicts are the same data for
    both packages)."""
    from raft_tpu_torch import designs as mod

    return {
        "flagship": mod.flagship(0.00625, 0.8, 12),
        "aero": mod.demo_semi_aero(n_cases=12, n_wind=6,
                                   nw_settings=(0.00625, 0.8)),
    }


def warm_times(model):
    model.analyze_unloaded()
    model.analyze_cases()
    out = {}
    for name, call in (
            ("prepare_case_inputs",
             lambda: model.prepare_case_inputs(verbose=False)),
            ("analyze_cases", model.analyze_cases)):
        ts = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            call()
            ts.append(time.perf_counter() - t0)
        out[name] = [round(t, 4) for t in ts]
    return out


def op_costs():
    import torch
    import torch.autograd.forward_ad as fwAD

    def us(fn, n=50):
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return round((time.perf_counter() - t0) / n * 1e6, 1)

    x = torch.rand(3, 6, 4, 10, dtype=torch.float64) + 0.5
    grid = torch.linspace(-180.0, 180.0, 202, dtype=torch.float64)
    ops = {
        "mul": lambda t: t * t,
        "sin": torch.sin,
        "arccos": lambda t: torch.arccos(0.5 * t),
        "maximum": lambda t: torch.maximum(t, t.new_full((), 0.7)),
        "where": lambda t: torch.where(t > 1.0, t, 2.0 * t),
        "rdiv": lambda t: 1.0 / t,
        "searchsorted": lambda t: torch.searchsorted(grid, t.contiguous()),
    }
    plain = {k: us(lambda f=f: f(x)) for k, f in ops.items()}
    with fwAD.dual_level():
        d = fwAD.make_dual(x, torch.ones_like(x))
        dual = {k: us(lambda f=f: f(d)) for k, f in ops.items()}
    print(json.dumps(dict(ops_us=dict(plain=plain, forward_ad=dual))),
          flush=True)
    ang = (torch.rand(6, 4, 10, dtype=torch.float64) - 0.5) * 400.0
    A = torch.rand(12, 6, 6, dtype=torch.float64) \
        + 6.0 * torch.eye(6, dtype=torch.float64)
    b = torch.rand(12, 6, dtype=torch.float64)
    calls = {"searchsorted": lambda: torch.searchsorted(grid, ang,
                                                        right=True),
             "bucketize": lambda: torch.bucketize(ang, grid, right=True),
             "linalg_solve": lambda: torch.linalg.solve(A, b)}
    n = torch.get_num_threads()
    pool = {k: us(f, 200) for k, f in calls.items()}
    torch.set_num_threads(1)
    one = {k: us(f, 200) for k, f in calls.items()}
    torch.set_num_threads(n)
    print(json.dumps({f"threads_{n}_us": pool, "threads_1_us": one,
                      "cpus": os.cpu_count()}), flush=True)


def main():
    if "--ops" in sys.argv:
        return op_costs()
    import contextlib
    import io

    import torch

    import raft_tpu_torch

    packages = [("raft_tpu_torch", lambda d: raft_tpu_torch.Model(
        d, device="cpu"))]
    if not PORT_ONLY:
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import raft_tpu

        packages.insert(0, ("raft_tpu", lambda d: raft_tpu.Model(
            d, precision="float64")))
    for pkg, make in packages:
        for name, design in designs().items():
            with contextlib.redirect_stdout(io.StringIO()):
                times = warm_times(make(design))
            print(json.dumps(dict(package=pkg, design=name,
                                  torch_threads=torch.get_num_threads(),
                                  cpus=os.cpu_count(), **times)),
                  flush=True)


if __name__ == "__main__":
    main()
