"""raft_tpu_torch — the PyTorch/CUDA port of raft_tpu.

Frequency-domain dynamics of a moored floating wind turbine, with the
batched case dynamics on an NVIDIA card.  ``Model(design)``,
``analyze_unloaded()``, ``analyze_cases()``, ``solve_eigen()`` and
``run_raft(design)`` follow the JAX package's API and ``results`` keys.

Device and dtype policy:

- The batched case dynamics (wave kinematics, excitation, the
  drag-linearization fixed point and its Gauss–Jordan solves) runs on
  ``cuda`` unless the caller passes ``device="cpu"``.  On a machine
  without CUDA, ``Model(design)`` raises instead of falling back.
- On the card every Gauss–Jordan solve is a launch of the hand-written
  CUDA kernel ``kernels.gj_solve``; on the CPU the same function runs as
  its plain PyTorch version.
- ``Model.run_bem()`` runs the native BEM solve on the Model's device;
  on the card its blocked Gauss–Jordan goes through the hand-written
  kernels of ``kernels.bem_gj`` (pivot-tile inverse, products).
- Host stages — statics, the mooring Newton, the BEM mesh and Rankine
  part, the response metrics — run in float64 on the CPU.
- The working dtype of the dynamics is float64 by default;
  ``precision="float32"`` is accepted.  TF32 is off on the card.

The package imports torch, NumPy and the standard library only.
"""

from raft_tpu_torch import designs
from raft_tpu_torch.kernels import gj_solve
from raft_tpu_torch.model import Model, run_raft

__all__ = ["Model", "run_raft", "designs", "gj_solve"]
