"""The exact partials of RAFT_OMDAO on the flagship against central
differences of compute(), on the CPU:

    JAX_PLATFORMS=cpu python tests/torch_omdao_partials_fd.py [--port-only]

For each design scale (ballast, line length, column diameter) and each
differentiated output it prints the port's adjoint partial, the central
differences at eps 2e-3, 1e-3 and 5e-4, and the derivative of the
unrolled fixed point (``parametric.design_gradients``); then, unless
``--port-only``, raft_tpu's adjoint gradient of ``offset_max`` on the
same design (about a minute of JAX compile).  The differences converge
to the unrolled derivative; the adjoint is the derivative of the exact
fixed point, which compute() stops short of at a 1 % tolerance.  ~3 min
on one CPU core.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from raft_tpu_torch import omdao  # noqa: E402
from raft_tpu_torch.designs import flagship  # noqa: E402
from raft_tpu_torch.parametric import design_gradients  # noqa: E402


def main(port_only):
    design = cs.component_design(flagship(0.00625, 0.8, 12))
    comp = cs.omdao_component(omdao, design, derivatives=True, device="cpu")
    cs.quiet(comp.run)
    partials = {}
    cs.quiet(comp.compute_partials, comp._inputs, partials)
    rebuilt, _ = comp._rebuild_design(comp._inputs, comp._discrete_inputs)
    _, jac = design_gradients(rebuilt,
                              metrics=tuple(omdao._PARTIAL_OUTPUTS.values()),
                              device="cpu")

    def values_at(name, s):
        comp.set_val(name, s)
        cs.quiet(comp.run)
        comp.set_val(name, 1.0)
        return {k: float(comp.get_val(k)) for k in omdao._PARTIAL_OUTPUTS}

    for name in ("design_scale_ballast", "design_scale_line_length",
                 "design_scale_col_diam"):
        fds = {}
        for eps in (2e-3, 1e-3, 5e-4):
            vp, vm = values_at(name, 1 + eps), values_at(name, 1 - eps)
            fds[eps] = {k: (vp[k] - vm[k]) / (2 * eps) for k in vp}
        for out, metric in omdao._PARTIAL_OUTPUTS.items():
            adj = float(partials[out, name])
            unrolled = jac[metric][omdao._SCALE_INPUTS[name]]
            print(f"{name} {out}: adjoint {adj:.8g} central differences "
                  + " ".join(f"(eps {e:g}) {f[out]:.8g}"
                             for e, f in fds.items())
                  + f" unrolled {unrolled:.8g} adjoint_rel_to_differences"
                  f"(eps 2e-3) {abs(adj / fds[2e-3][out] - 1):.3e}")
    if not port_only:
        import jax

        jax.config.update("jax_platforms", "cpu")
        from raft_tpu.grad.response import build_value_and_grad

        fn, _ = build_value_and_grad(rebuilt, "offset_max")
        value, grad = fn(jax.device_put(np.ones(4), jax.devices("cpu")[0]))
        print(f"raft_tpu adjoint offset_max {float(value):.8g} gradient "
              f"(draft, ballast, col_diam, line_length) "
              f"{np.asarray(grad).tolist()}")


if __name__ == "__main__":
    main("--port-only" in sys.argv[1:])
