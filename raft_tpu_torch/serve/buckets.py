"""Slot physics: the scalars and frequency grid of one physics
configuration (the port's copy of ``SlotPhysics`` from
``raft_tpu/serve/buckets.py``).

It keys the waterfall's phase programs (raft_tpu_torch/waterfall.py).
Hashable, and JSON-serializable through :meth:`SlotPhysics.as_dict`.
The dtype names are torch dtype names (``"float64"``, ``"complex128"``).
"""

from typing import NamedTuple

import numpy as np
import torch

from raft_tpu_torch.utils.placement import complex_dtype


def _dtype_name(dtype):
    return str(dtype).removeprefix("torch.")


class SlotPhysics(NamedTuple):
    """Everything the case dynamics closes over besides its operands."""

    w_bytes: bytes
    k_bytes: bytes
    nw: int
    depth: float
    rho: float
    g: float
    XiStart: float
    nIter: int
    dtype_name: str
    cdtype_name: str

    @classmethod
    def from_model(cls, model):
        return cls(
            w_bytes=np.asarray(model.w, np.float64).tobytes(),
            k_bytes=np.asarray(model.k, np.float64).tobytes(),
            nw=int(model.nw),
            depth=float(model.depth),
            rho=float(model.rho_water),
            g=float(model.g),
            XiStart=float(model.XiStart),
            nIter=int(model.nIter),
            dtype_name=_dtype_name(model.dtype),
            cdtype_name=_dtype_name(complex_dtype(model.dtype)),
        )

    @property
    def w(self):
        return np.frombuffer(self.w_bytes, np.float64, count=self.nw)

    @property
    def k(self):
        return np.frombuffer(self.k_bytes, np.float64, count=self.nw)

    @property
    def dtype(self):
        """The working dtype as a ``torch.dtype``."""
        return getattr(torch, self.dtype_name)

    def as_dict(self):
        d = self._asdict()
        d["w"] = self.w.tolist()
        d["k"] = self.k.tolist()
        del d["w_bytes"], d["k_bytes"]
        return d

    @classmethod
    def from_dict(cls, d):
        d = dict(d)
        w = np.asarray(d.pop("w"), np.float64)
        k = np.asarray(d.pop("k"), np.float64)
        return cls(w_bytes=w.tobytes(), k_bytes=k.tobytes(), **d)
