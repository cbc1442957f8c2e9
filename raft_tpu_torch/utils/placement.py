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
import threading

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


# host_threads() bookkeeping: the thread count to restore, recorded by
# the first entry of any Python thread, how many callers are inside, and
# each Python thread's own nesting depth
_host_lock = threading.Lock()
_host_state = {"depth": 0, "prev": None}
_host_local = threading.local()


@contextlib.contextmanager
def host_threads():
    """Run the enclosed host stage on one intra-op CPU thread.

    The host stages work on tiny tensors (cases x lines, cases x blade
    sections): a multi-threaded CPU pool does not make them faster, and
    on a shared host a call can stall on a pool thread that is not
    scheduled (``tests/torch_host_prep_timing.py --ops`` times both
    thread counts).

    Safe under concurrent callers (the serving engine's prep workers).
    With PyTorch's OpenMP backend the count is a setting of each Python
    thread, seeded for new threads from a process-wide value that
    ``torch.set_num_threads`` also writes.  So the count to restore is
    recorded once, under a lock, by the first entry while no caller is
    inside (a thread that starts while another is inside reads the
    one-thread seed, and must not take that for the count to restore);
    each Python thread sets one thread on its outermost entry and
    restores the recorded count on its outermost exit, and the last exit
    of all clears the record."""
    with _host_lock:
        if _host_state["depth"] == 0:
            _host_state["prev"] = torch.get_num_threads()
        _host_state["depth"] += 1
        prev = _host_state["prev"]
    mine = getattr(_host_local, "depth", 0)
    _host_local.depth = mine + 1
    if mine == 0:
        torch.set_num_threads(1)
    try:
        yield
    finally:
        _host_local.depth = mine
        with _host_lock:
            if mine == 0:
                torch.set_num_threads(prev)
            _host_state["depth"] -= 1
            if _host_state["depth"] == 0:
                _host_state["prev"] = None
