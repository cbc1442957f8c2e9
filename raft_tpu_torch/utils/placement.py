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
- A device list (:func:`resolve_devices`) may repeat a device:
  ``["cpu"] * 4`` is four CPU workers, ``["cuda:0"] * 2`` two streams on
  one card.  :class:`DeviceWorkers` runs one host thread per entry, on
  a stream of its own for each repeat of a card; every multi-device
  path of the port (the sharded BEM solve, the sweeps' device lists,
  the served lane mesh, the rotor's host workers) shards through it.
"""

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor

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


def _checked_device(device):
    """:func:`resolve_device` of one list entry; a CUDA entry is given
    its index and must name a card this host has."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        index = torch.cuda.current_device() if dev.index is None \
            else dev.index
        have = torch.cuda.device_count()
        if index >= have:
            raise RuntimeError(
                f"device {device!r} names cuda:{index}, but this host has "
                f"{have} CUDA device(s)")
        dev = torch.device("cuda", index)
    return dev


def resolve_devices(devices=None):
    """A device list: a tuple of ``torch.device``, each checked by
    :func:`resolve_device`.

    ``devices`` is a device or a name (a list of one), a comma-separated
    string of names, a sequence of devices or names, or an int N (the
    first N cards).  Entries may repeat: ``["cpu"] * 4`` is four CPU
    workers and ``["cuda:0"] * 2`` two streams on one card.  A list
    naming a card this host lacks raises; nothing is dropped quietly.
    ``None`` is the default device, ``cuda``."""
    if isinstance(devices, bool):
        raise TypeError(f"devices must not be a bool, got {devices!r}")
    if devices is None or isinstance(devices, torch.device):
        names = [devices]
    elif isinstance(devices, int):
        if devices < 1:
            raise ValueError(f"a device count must be >= 1, got {devices}")
        names = [f"cuda:{i}" for i in range(devices)]
    elif isinstance(devices, str):
        names = [s.strip() for s in devices.split(",") if s.strip()]
    else:
        names = list(devices)
    if not names:
        raise ValueError(f"empty device list {devices!r}")
    return tuple(_checked_device(d) for d in names)


class DeviceWorkers:
    """One host thread per entry of a device list (:func:`resolve_devices`).

    ``submit(i, fn, *args)`` runs ``fn`` on entry ``i``'s thread and
    returns a future.  On a CUDA entry the thread works inside a stream
    of that card (entered with ``torch.cuda.stream``): the card's current
    stream for the first entry naming the card, a ``torch.cuda.Stream``
    of its own for each repeat.  The caching allocator keeps its blocks
    per stream, so a one-entry list works on the memory the caller's
    stream has cached, as the caller itself would.  The kernel wrappers
    launch on the current stream, so a shard's work stays on its
    stream.  The stream first waits for the work the
    submitting thread had queued on that card (the shard's inputs), and
    is synchronized before the future resolves; a task returns host data
    (or device tensors the caller reads at once), and the caller keeps its
    inputs alive until the future resolves, so no memory crosses streams
    while in use.  On a CPU entry the thread runs with the intra-op thread
    count of the thread that made the workers, so a shard computes the
    bits the single-device run computes.  Autograd's mode is carried
    over from the submitting thread.

    One thread per entry: the sharded paths sync with the host every
    trip (the fixed point's convergence mask, the sweeps' chunk results),
    so one dispatching thread would serialise them."""

    def __init__(self, devices, name="raft-shard"):
        self.devices = resolve_devices(devices)
        self._threads = torch.get_num_threads()
        self._pools = [ThreadPoolExecutor(1, thread_name_prefix=f"{name}{i}")
                       for i in range(len(self.devices))]
        self._streams = [
            None if d.type != "cuda"
            else torch.cuda.Stream(device=d) if d in self.devices[:i]
            else torch.cuda.current_stream(d)
            for i, d in enumerate(self.devices)]

    def __len__(self):
        return len(self.devices)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self, wait=True):
        for pool in self._pools:
            pool.shutdown(wait=wait)

    def submit(self, i, fn, *args, **kwargs):
        dev = self.devices[i]
        ready = None
        if dev.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
        return self._pools[i].submit(self._run, i, ready,
                                     torch.is_grad_enabled(), fn, args,
                                     kwargs)

    def map(self, fn, items):
        """``[fn(item) for item in items]``, item j on entry j mod n."""
        futs = [self.submit(j % len(self), fn, item)
                for j, item in enumerate(items)]
        return [f.result() for f in futs]

    def _run(self, i, ready, grad, fn, args, kwargs):
        stream = self._streams[i]
        with torch.set_grad_enabled(grad):
            if stream is None:
                if torch.get_num_threads() != self._threads:
                    torch.set_num_threads(self._threads)
                return fn(*args, **kwargs)
            with torch.cuda.device(self.devices[i]), \
                    torch.cuda.stream(stream):
                stream.wait_event(ready)
                try:
                    return fn(*args, **kwargs)
                finally:
                    stream.synchronize()


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
