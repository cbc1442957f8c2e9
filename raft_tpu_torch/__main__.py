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
line).  SIGTERM and SIGINT shut it down gracefully: in-flight batches
finish and every outstanding handle resolves (``shutdown`` at worst).
``--http``, ``--replicas`` and ``--autoscale`` (the network tier) exit
naming ROADMAP.md queue 1 step 12b.
"""

import argparse
import json
import sys

import numpy as np


def _device(text):
    """``cuda``, ``cuda:N`` or ``cpu``."""
    head, _, index = text.partition(":")
    if head == "cpu" and not index or head == "cuda" and (
            not index or index.isdigit()):
        return text
    raise argparse.ArgumentTypeError(
        f"device must be 'cuda', 'cuda:N' or 'cpu', got {text!r}")


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
    p.add_argument("--device", type=_device, default="cuda",
                   help="device of the dispatches: cuda (the default), "
                        "cuda:N or cpu")
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

    designs = [load_design(path) for path in args.designs]
    report = warmup(designs=designs or None, precision=args.precision,
                    cache_dir=args.cache_dir, device=args.device,
                    fixed_point=args.fixed_point)
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


def _result_doc(res, include_xi=False):
    """RequestResult -> its result line (the JAX package's wire fields,
    without the payload checksum of the network tier)."""
    doc = {"event": "result", "rid": res.rid, "status": res.status,
           "latency_s": res.latency_s, "queue_s": res.queue_s,
           "batch_requests": res.batch_requests,
           "batch_occupancy": res.batch_occupancy}
    if res.error:
        doc["error"] = res.error
    if res.backend:
        doc["backend"] = res.backend
    if res.bucket is not None:
        doc["bucket"] = res.bucket.as_dict()
    if res.trace_id:
        doc["trace_id"] = res.trace_id
    if res.status == "ok":
        doc["std"] = np.asarray(res.std).tolist()
        doc["std_dtype"] = str(np.asarray(res.std).dtype)
        for key, val in (res.solve_report or {}).items():
            doc[key] = np.asarray(val).tolist()
        if include_xi and res.Xi is not None:
            doc["Xi_re"] = res.Xi.real.tolist()
            doc["Xi_im"] = res.Xi.imag.tolist()
            doc["Xi_dtype"] = str(res.Xi.dtype)
    return doc


def _emit(doc):
    print(json.dumps(doc), flush=True)


_SWEEP_META = ("event", "rid", "chunk", "n_chunks", "designs", "wall_s",
               "suspend_s", "preemptions", "mode", "failed_idx",
               "failed_msg")


def _emit_sweep(eng, doc, load_design, pending, include_xi):
    """A sweep line of the stdin loop: an accepted line, a line per
    finished chunk (the sweeps' checkpoint schema keys), then the
    terminal ``sweep_result`` line (meta only: the arrays rode the chunk
    lines).  Interactive results that finish meanwhile are emitted
    between chunk lines."""
    if not isinstance(doc, dict) or not isinstance(doc.get("designs"),
                                                   list):
        raise ValueError("sweep request needs a 'designs' list")
    designs = [load_design(d) if isinstance(d, str) else d
               for d in doc["designs"]]
    handle = eng.submit_sweep(designs, cases=doc.get("cases"),
                              chunk=doc.get("chunk"))
    _emit({"event": "sweep_accepted", "rid": handle.rid,
           "n_designs": handle.n_designs, "n_chunks": handle.n_chunks})
    for ch in handle.chunks():
        line = {k: ch[k] for k in _SWEEP_META if k in ch}
        for key in ("Xi_r", "Xi_i", "converged", "iters", "nonfinite",
                    "recovery_tier", "residual", "cond"):
            if key in ch:
                line[key] = np.asarray(ch[key]).tolist()
        _emit(line)
        while pending and pending[0].done():
            _emit(_result_doc(pending.pop(0).result(0), include_xi))
    res = handle.result(600)
    _emit({"event": "sweep_result", "rid": res.rid, "status": res.status,
           "n_designs": res.n_designs, "n_chunks": res.n_chunks,
           "chunks_done": res.chunks_done, "error": res.error,
           "failed_idx": res.failed_idx, "failed_msg": res.failed_msg,
           "preemptions": res.preemptions, "mode": res.mode,
           "latency_s": res.latency_s, "suspend_s": res.suspend_s})


def _serve_main(argv):
    import signal

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
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="the HTTP transport (not ported yet)")
    p.add_argument("--replicas", type=int, default=None, metavar="N",
                   help="a router over N replicas (not ported yet)")
    p.add_argument("--autoscale", action="store_true",
                   help="the router's autoscaler (not ported yet)")
    args = p.parse_args(argv)
    if args.http is not None or args.replicas or args.autoscale:
        from raft_tpu_torch.model import _not_ported

        raise _not_ported("the serve network tier (--http, --replicas, "
                          "--autoscale)", "12b")

    from raft_tpu_torch.io.schema import load_design
    from raft_tpu_torch.serve import Engine, EngineConfig, warmup

    cfg = EngineConfig(precision=args.precision, device=args.device,
                       cache_dir=args.cache_dir,
                       fixed_point=args.fixed_point)
    if args.window_ms is not None:
        cfg.window_ms = args.window_ms
    designs = [load_design(path) for path in args.designs]
    report = None
    if not args.no_warmup:
        report = warmup(designs=designs or None, precision=args.precision,
                        cache_dir=args.cache_dir, device=args.device,
                        fixed_point=args.fixed_point)

    def _on_signal(signum, frame):
        raise _SignalShutdown(signum)

    old_handlers = {s: signal.signal(s, _on_signal)
                    for s in (signal.SIGTERM, signal.SIGINT)}
    eng = Engine(cfg)
    sig = None
    pending = []
    try:
        ready = {"event": "ready", **_scalars(eng.snapshot())}
        if report is not None:
            ready["warmup"] = {k: v for k, v in report.items()
                               if k not in ("flags", "rejected")}
        _emit(ready)
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
                if "sweep" in req:
                    _emit_sweep(eng, req["sweep"], load_design, pending,
                                args.xi)
                    continue
                design = req["design"]
                if isinstance(design, str):
                    design = load_design(design)
                pending.append(eng.submit(
                    design, cases=req.get("cases"),
                    deadline_s=req.get("deadline_s")))
            except Exception as e:  # noqa: BLE001 — bad line, keep serving
                _emit({"event": "error",
                       "error": f"{type(e).__name__}: {e}"})
                continue
            while pending and pending[0].done():
                _emit(_result_doc(pending.pop(0).result(0), args.xi))
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
                _emit(_result_doc(h.result(timeout=30), args.xi))
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
