"""Device and dtype policy of the port.

- The batched case dynamics runs on ``cuda`` unless the caller asks for
  ``device="cpu"``.  Asking for the default on a machine without CUDA
  raises; nothing carries on quietly on the CPU.
- Host stages (statics, the rotor, the mooring Newton, the response
  metrics) run on the CPU in float64, as in the JAX package; the case
  prep runs them on one CPU thread (:func:`host_threads`).
- The working dtype of the dynamics defaults to float64;
  ``precision="float32"`` is accepted too.  ``precision`` names the
  working dtype only: mixed precision is ``Model(...,
  mixed_precision=True)``.  Float32 products on the card
  run in full float32: TF32 is switched off whenever the card is chosen
  (the JAX package pins ``jax.default_matmul_precision("highest")`` for
  the same reason).
"""

import contextlib

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


@contextlib.contextmanager
def host_threads():
    """Run the enclosed host stage on one intra-op CPU thread.

    The host stages work on tiny tensors (cases x lines, cases x blade
    sections): a multi-threaded CPU pool does not make them faster, and
    on a shared host a call can stall on a pool thread that is not
    scheduled (``tests/torch_host_prep_timing.py --ops`` times both
    thread counts).  The thread count is global to the process, so CPU
    work of other Python threads runs on one thread meanwhile; it is
    restored on exit."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)
