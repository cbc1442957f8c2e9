"""Device and dtype policy of the port.

- The batched case dynamics runs on ``cuda`` unless the caller asks for
  ``device="cpu"``.  Asking for the default on a machine without CUDA
  raises; nothing carries on quietly on the CPU.
- Host stages (statics, the mooring Newton, the response metrics) run
  on the CPU in float64, as in the JAX package.
- The working dtype of the dynamics defaults to float64;
  ``precision="float32"`` is accepted too.  ``precision`` names the
  working dtype only: mixed precision is ``Model(...,
  mixed_precision=True)``.  Float32 products on the card
  run in full float32: TF32 is switched off whenever the card is chosen
  (the JAX package pins ``jax.default_matmul_precision("highest")`` for
  the same reason).
"""

import torch

HOST = torch.device("cpu")
HOST_DTYPE = torch.float64

_PRECISIONS = {None: torch.float64, "float64": torch.float64,
               "float32": torch.float32}


def resolve_device(device=None):
    """The device the case dynamics runs on: ``cuda`` by default, or the
    caller's choice of ``"cpu"``/``"cuda"``/``"cuda:N"``.  Raises when CUDA
    is asked for (explicitly or by default) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "case dynamics on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def resolve_dtype(precision=None):
    """Working dtype of the case dynamics: float64 unless
    ``precision="float32"``."""
    if precision not in _PRECISIONS:
        raise ValueError(
            f"precision must be 'float64' or 'float32', got {precision!r} "
            "(mixed precision is Model(..., mixed_precision=True))")
    return _PRECISIONS[precision]


def complex_dtype(dtype):
    """The complex dtype whose parts are ``dtype``."""
    return torch.complex64 if dtype == torch.float32 else torch.complex128
