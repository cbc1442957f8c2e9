"""Command-line entry point (the port's ``raft_tpu/__main__.py``).

``python -m raft_tpu_torch design.yaml [options]`` — one-shot full
analysis (the reference's ``python raft_model.py`` __main__ path,
reference raft/raft_model.py:1140-1147, as a proper CLI).  The case
dynamics runs on ``cuda`` unless ``--device cpu`` is given; without a
card the default raises.

``python -m raft_tpu_torch warmup [designs...]`` warms the buckets of
the serve warm-up manifest (and of the given designs) and prints the
report as one JSON line; ``python -m raft_tpu_torch serve`` is the
serving engine's stdin JSON-line loop: design requests (``{"design":
<path | dict>, "cases": [...]?, "deadline_s": s?}``) and sweep requests
(``{"sweep": {"designs": [...], "cases": [...]?, "chunk": n?}}``), one
result line each (a sweep streams a line per chunk, then its result
line), in the wire schema of serve/wire.py.  SIGTERM and SIGINT shut it
down gracefully: in-flight batches finish and every outstanding handle
resolves (``shutdown`` at worst).

``serve --http PORT`` serves the wire protocol over HTTP instead
(serve/transport.py; port 0 binds an OS-assigned port, printed on the
ready line): one in-process engine, or with ``--replicas N`` a router
over N spawned replica processes on the same card (serve/router.py),
with ``--autoscale`` its autoscaler (serve/autoscale.py).  Every knob is
a flag; none is read from the environment.
"""

import argparse
import json
import sys


def _device(text):
    """``cuda``, ``cuda:N`` or ``cpu``."""
    head, _, index = text.partition(":")
    if head == "cpu" and not index or head == "cuda" and (
            not index or index.isdigit()):
        return text
    raise argparse.ArgumentTypeError(
        f"device must be 'cuda', 'cuda:N' or 'cpu', got {text!r}")


def _devices(text):
    """The serve commands' device: one device, or with ``--replicas`` a
    comma-separated list of them, replica i on entry i mod n."""
    for part in text.split(","):
        _device(part.strip())
    return text


def _serve_devices(text):
    """``--serve-devices``: a lane-mesh width k, or a comma-separated
    device list (``cuda:0,cuda:0``; repeats allowed)."""
    if text.isdigit():
        return int(text)
    return [_device(part.strip()) for part in text.split(",")]


def _analyze_main(argv):
    p = argparse.ArgumentParser(
        prog="raft_tpu_torch",
        description="Frequency-domain FOWT analysis (RAFT on PyTorch and "
                    "CUDA)",
    )
    p.add_argument("design", help="design YAML/pickle path")
    p.add_argument("--plot", action="store_true",
                   help="save geometry + response-PSD figures")
    p.add_argument("--ballast", type=int, default=0, choices=[0, 1, 2],
                   help="ballast trim mode (1=fill levels, 2=densities)")
    p.add_argument("--precision", choices=["float32", "float64"],
                   default=None, help="working precision of the dynamics")
    p.add_argument("--device", type=_device, default="cuda",
                   help="device of the batched case solve: cuda (the "
                        "default), cuda:N or cpu")
    p.add_argument("--bem", action="store_true",
                   help="run the native BEM solver on potMod members")
    args = p.parse_args(argv)

    from raft_tpu_torch.model import run_raft

    return run_raft(
        args.design, plot=int(args.plot), ballast=args.ballast,
        precision=args.precision, run_native_bem=args.bem,
        device=args.device,
    )


def _serve_parser(prog, description):
    p = argparse.ArgumentParser(prog=prog, description=description)
    p.add_argument("designs", nargs="*",
                   help="design YAML paths to seed and warm buckets from")
    p.add_argument("--precision", choices=["float32", "float64"],
                   default=None)
    p.add_argument("--device", type=_devices, default="cuda",
                   help="device of the dispatches: cuda (the default), "
                        "cuda:N or cpu; with --replicas a comma-separated "
                        "list places replica i on entry i mod n")
    p.add_argument("--serve-devices", type=_serve_devices, default=None,
                   metavar="K|LIST",
                   help="the engine's lane mesh: K workers (K CPU workers, "
                        "or the first K cards) or a device list, repeats "
                        "allowed; every replica's own with --replicas "
                        "(default: one dispatch per bucket)")
    p.add_argument("--fixed-point", choices=["legacy", "waterfall", "fused"],
                   default="legacy", help="the dispatch engine")
    p.add_argument("--cache-dir", default=None,
                   help="serve cache root (default: build/raft_tpu_torch "
                        "of the checkout; the result cache is on only "
                        "with an explicit directory)")
    return p


def _warmup_main(argv):
    p = _serve_parser(
        "raft_tpu_torch warmup",
        "Warm the serving buckets recorded in the warm-up manifest (plus "
        "the buckets of any designs given) on the device.")
    args = p.parse_args(argv)

    from raft_tpu_torch.io.schema import load_design
    from raft_tpu_torch.serve import warmup

    if "," in args.device:
        p.error("a device list places --replicas; one engine's lane mesh "
                "is --serve-devices")
    designs = [load_design(path) for path in args.designs]
    report = warmup(designs=designs or None, precision=args.precision,
                    cache_dir=args.cache_dir, device=args.device,
                    fixed_point=args.fixed_point,
                    devices=args.serve_devices)
    print(json.dumps(report, default=str), flush=True)
    return report


class _SignalShutdown(BaseException):
    """Raised by the SIGTERM/SIGINT handlers to unblock the stdin read
    so the serve loop can drain; a BaseException so the per-line
    ``except Exception`` never swallows it."""

    def __init__(self, signum):
        super().__init__(f"signal {signum}")
        self.signum = signum


def _scalars(snapshot):
    return {k: v for k, v in snapshot.items()
            if not isinstance(v, (list, dict))}


def _ready(eng, report):
    """An engine's ready line: its scalar stats and the warm-up report."""
    ready = {"event": "ready", **_scalars(eng.snapshot())}
    if report is not None:
        ready["warmup"] = {k: v for k, v in report.items()
                           if k not in ("flags", "rejected")}
    return ready


def _result_line(res, include_xi=False):
    """RequestResult -> its stdin-loop line: the wire document plus the
    request's queue wait."""
    from raft_tpu_torch.serve import wire

    doc = wire.result_doc(res, include_xi=include_xi)
    doc["queue_s"] = round(res.queue_s, 4)
    return doc


def _emit(doc):
    print(json.dumps(doc), flush=True)


def _emit_sweep(eng, doc, load_design, pending, include_xi):
    """A sweep line of the stdin loop: an accepted line, a wire chunk
    line per finished chunk, then the terminal ``sweep_result`` line
    (meta only: the arrays rode the chunk lines).  Interactive results
    that finish meanwhile are emitted between chunk lines."""
    from raft_tpu_torch.serve import wire

    designs, cases, chunk = wire.parse_sweep_request(doc)
    designs = [load_design(d) if isinstance(d, str) else d
               for d in designs]
    handle = eng.submit_sweep(designs, cases=cases, chunk=chunk)
    _emit({"event": "sweep_accepted", "rid": handle.rid,
           "n_designs": handle.n_designs, "n_chunks": handle.n_chunks})
    for ch in handle.chunks():
        _emit(wire.sweep_chunk_doc(ch))
        while pending and pending[0].done():
            _emit(_result_line(pending.pop(0).result(0), include_xi))
    _emit(wire.sweep_result_doc(handle.result(600)))


#: the autoscaler's thresholds as flags: (suffix, type, default, what)
_AUTOSCALE_FLAGS = (
    ("high", float, 4.0, "high-water pressure per replica"),
    ("low", float, 0.5, "low-water pressure per replica"),
    ("min", int, 1, "floor replica count"),
    ("max", int, 4, "ceiling replica count"),
    ("sustain", float, 2.0, "hysteresis window in seconds"),
    ("cooldown", float, 5.0, "hold after an action in seconds"),
    ("interval", float, 1.0, "policy tick period in seconds"),
)


def _engine_config(args):
    from raft_tpu_torch.serve import EngineConfig

    cfg = EngineConfig(precision=args.precision, device=args.device,
                       cache_dir=args.cache_dir,
                       fixed_point=args.fixed_point, preempt=args.preempt,
                       warm_handoff=args.warm_handoff, chaos=args.chaos,
                       serve_devices=args.serve_devices)
    if args.window_ms is not None:
        cfg.window_ms = args.window_ms
    return cfg


def _router(args):
    """The ``--replicas`` backend: a router over spawned replicas."""
    from raft_tpu_torch.serve import AutoscaleConfig, Router

    scale = AutoscaleConfig(**{
        f: getattr(args, f"autoscale_{name}") for name, f in (
            ("high", "high_water"), ("low", "low_water"),
            ("min", "min_replicas"), ("max", "max_replicas"),
            ("sustain", "sustain_s"), ("cooldown", "cooldown_s"),
            ("interval", "interval_s"))})
    return Router(
        n_replicas=args.replicas, cache_dir=args.cache_dir,
        precision=args.precision, device=args.device,
        fixed_point=args.fixed_point, window_ms=args.window_ms,
        warmup=not args.no_warmup, preempt=args.preempt,
        autoscale=args.autoscale, autoscale_config=scale,
        coalesce=args.coalesce, chaos=args.chaos,
        replica_argv=() if args.serve_devices is None else (
            "--serve-devices", _serve_devices_text(args.serve_devices)))


def _serve_devices_text(serve_devices):
    return str(serve_devices) if isinstance(serve_devices, int) \
        else ",".join(serve_devices)


def _serve_http_main(args, backend, ready):
    """The ``--http`` serve path: ``backend`` (an engine, or a router over
    ``--replicas`` processes) fronted by serve/transport.py.  stdout
    carries only the ready and shutdown lines; requests ride the wire.
    SIGTERM/SIGINT drain: every accepted request gets its terminal line
    before the listener closes."""
    import signal
    import threading

    from raft_tpu_torch.serve import serve_http

    stop = threading.Event()
    sig_caught = []

    def _on_signal(signum, frame):
        sig_caught.append(signum)
        stop.set()

    old_handlers = {s: signal.signal(s, _on_signal)
                    for s in (signal.SIGTERM, signal.SIGINT)}
    # with --replicas the router's faults fire in the router
    transport = serve_http(backend, port=args.http,
                           chaos=None if args.replicas else args.chaos,
                           profile_dir=args.profile_dir)
    try:
        _emit({**ready, "port": transport.port,
               "replicas": args.replicas or 0,
               "backend": backend.flags.get("backend")})
        # a timed wait: the signal may land on another of the process's
        # threads (the CUDA runtime's), and the handler only runs once
        # the main thread executes bytecode again
        while not stop.wait(0.5):
            pass
    finally:
        for s, h in old_handlers.items():
            signal.signal(s, h)
        report = transport.drain(drain_queue=not sig_caught)
        _emit({"event": "shutdown",
               "signal": sig_caught[0] if sig_caught else None, **report})
    return backend


def _serve_main(argv):
    import queue
    import signal
    import threading

    p = _serve_parser(
        "raft_tpu_torch serve",
        "Long-lived serving engine: JSON-line requests on stdin "
        '({"design": "path.yaml", "cases": [...], "deadline_s": 10}, or '
        '{"sweep": {"designs": [...], "chunk": N}}), JSON-line results '
        "on stdout.  SIGTERM/SIGINT shut down gracefully.")
    p.add_argument("--window-ms", type=float, default=None,
                   help="micro-batching window (default 5 ms)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the manifest warm-up at startup")
    p.add_argument("--xi", action="store_true",
                   help="include the complex response amplitudes in each "
                        "result line")
    p.add_argument("--preempt", action="store_true",
                   help="preempt sweep chunks at waterfall block "
                        "boundaries for interactive requests")
    p.add_argument("--warm-handoff", default=None, metavar="PATH",
                   help="a warm-handoff manifest whose result-cache "
                        "entries the engine preloads before its ready line")
    p.add_argument("--chaos", default=None, metavar="SPEC",
                   help="a fault-injection spec (chaos.py); with "
                        "--replicas the router's faults, never passed on "
                        "to the replicas")
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve the wire protocol over HTTP on PORT (0 = "
                        "OS-assigned, printed on the ready line) instead "
                        "of the stdin loop")
    p.add_argument("--replicas", type=int, default=None, metavar="N",
                   help="with --http: a consistent-hash router over N "
                        "spawned engine replicas on the card")
    p.add_argument("--coalesce", action="store_true",
                   help="with --replicas: single-flight identical "
                        "requests and sweep chunks at the router")
    p.add_argument("--profile-dir", default=None,
                   help="default directory of POST /profilez captures")
    p.add_argument("--autoscale", action="store_true",
                   help="with --replicas: grow and shrink the fleet "
                        "against per-replica pressure")
    for name, typ, default, what in _AUTOSCALE_FLAGS:
        p.add_argument(f"--autoscale-{name}", type=typ, default=default,
                       help=f"autoscaler {what} (default {default})")
    args = p.parse_args(argv)
    if args.replicas and args.http is None:
        p.error("--replicas needs --http")
    if args.autoscale and not args.replicas:
        p.error("--autoscale needs --replicas")
    if "," in args.device and not args.replicas:
        p.error("a device list places --replicas; one engine's lane mesh "
                "is --serve-devices")
    if args.replicas:
        router = _router(args)
        return _serve_http_main(args, router, {"event": "ready", "spawn_s": {
            r.id: r.spawn_s for r in router.replicas.values()}})

    from raft_tpu_torch.io.schema import load_design
    from raft_tpu_torch.serve import Engine, warmup

    cfg = _engine_config(args)
    designs = [load_design(path) for path in args.designs]
    report = None
    if not args.no_warmup:
        report = warmup(designs=designs or None, precision=args.precision,
                        cache_dir=args.cache_dir, device=args.device,
                        fixed_point=args.fixed_point,
                        devices=args.serve_devices)
    if args.http is not None:
        eng = Engine(cfg)
        return _serve_http_main(args, eng, _ready(eng, report))

    def _on_signal(signum, frame):
        raise _SignalShutdown(signum)

    old_handlers = {s: signal.signal(s, _on_signal)
                    for s in (signal.SIGTERM, signal.SIGINT)}
    eng = Engine(cfg)
    sig = None
    pending = []
    # stdin is read on a daemon thread that feeds a queue (None at EOF),
    # and the main thread waits on the queue in timed slices: the signal
    # may land on another of the process's threads (the CUDA runtime's),
    # and the handler only runs once the main thread executes bytecode
    # again, which a blocking read of stdin would never let it do
    lines = queue.Queue()

    def _read_stdin():
        for ln in sys.stdin:
            lines.put(ln)
        lines.put(None)

    try:
        _emit(_ready(eng, report))
        threading.Thread(target=_read_stdin, name="serve-stdin",
                         daemon=True).start()
        while True:
            try:
                line = lines.get(timeout=0.5)
            except queue.Empty:
                line = ""
            if line is None:
                break
            line = line.strip()
            if line:
                try:
                    req = json.loads(line)
                    if "sweep" in req:
                        _emit_sweep(eng, req["sweep"], load_design, pending,
                                    args.xi)
                    else:
                        design = req["design"]
                        if isinstance(design, str):
                            design = load_design(design)
                        pending.append(eng.submit(
                            design, cases=req.get("cases"),
                            deadline_s=req.get("deadline_s")))
                # a bad line gets an error line; the loop keeps serving
                except Exception as e:  # noqa: BLE001
                    _emit({"event": "error",
                           "error": f"{type(e).__name__}: {e}"})
            while pending and pending[0].done():
                _emit(_result_line(pending.pop(0).result(0), args.xi))
    except _SignalShutdown as e:
        sig = e.signum
    finally:
        for s, h in old_handlers.items():
            signal.signal(s, h)
        # EOF drains the queue; a signal finishes the in-flight dispatch
        # and resolves everything queued with status "shutdown"
        eng.shutdown(wait=True, drain=(sig is None))
        for h in pending:
            try:
                _emit(_result_line(h.result(timeout=30), args.xi))
            except TimeoutError:
                _emit({"event": "result", "rid": h.rid,
                       "status": "shutdown",
                       "error": "unresolved at shutdown"})
        _emit({"event": "shutdown", "signal": sig,
               **_scalars(eng.snapshot())})
    return eng


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "warmup":
        return _warmup_main(argv[1:])
    if argv and argv[0] == "serve":
        return _serve_main(argv[1:])
    return _analyze_main(argv)


if __name__ == "__main__":
    main()
