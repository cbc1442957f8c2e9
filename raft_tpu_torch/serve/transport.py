"""HTTP/1.1 JSON transport over the serve engine, stdlib only (the port's
``raft_tpu/serve/transport.py``).

``serve_http(backend)`` wraps anything with the engine's front surface
(``submit``/``probe``/``snapshot``/``shutdown``: both ``Engine`` and
``router.Router``) in a threaded ``http.server`` front end:

* ``POST /v1/solve`` — a wire request document (serve/wire.py).  The
  response is chunked NDJSON: an ``accepted`` line with the rid as soon
  as admission takes the request, then exactly one terminal result line.
  The HTTP status is committed at the accepted chunk (200); the terminal
  status rides in the body.  ``?stream=0`` buffers instead and maps the
  terminal status to an HTTP code (``wire.HTTP_STATUS``).
* ``POST /v1/sweep`` — a sweep request document, always streamed:
  ``accepted``, one ``sweep_chunk`` line per finished chunk, then exactly
  one terminal ``sweep_result`` line.
* ``POST /v1/grad`` — a grad request document; one buffered
  ``grad_result`` document whose status maps to an HTTP code.
* ``POST /profilez`` — arm the backend's one-shot ``torch.profiler``
  capture (obs/profiler.py) of its next dispatch window.
* ``POST /v1/cache/preload`` — one chunk of a shared-nothing warm
  transfer (``Engine.preload_wire``).
* ``GET /healthz`` (liveness), ``/readyz`` (``backend.probe()``: 503
  while draining, stopped, shedding, or with every breaker open),
  ``/statz`` (``snapshot()``), ``/metricz`` (Prometheus text),
  ``/tracez`` (the span ring) and ``/versionz`` (the attach handshake:
  wire version, the port's flag surface — card, torch and CUDA, dtype,
  fixed-point mode, kernel library digests, code version — and the
  flags' values).

The handler threads only parse, enqueue and serialize host arrays: the
engine's batcher owns the card, so no CUDA work runs on them.

Drain (``HttpTransport.drain``): stop admitting (503), shut the backend
down (which resolves every in-flight handle with a terminal status and so
unblocks every waiting handler), wait for the handlers to flush their
terminal line, then close the listener.  Every accepted rid gets its
terminal line before its socket closes.

Faults (chaos.py, a spec given as ``chaos=``): ``conn_drop`` closes the
client connection after the accepted chunk and before the terminal line;
the client surfaces ``ConnectionDropped`` while the engine handle still
resolves.  At the client, ``wire_corrupt`` flips a payload value of a
decoded response before the checksum check (``WireChecksumError``), and
``net_partition`` drops a ``/v1/*`` POST to one port.

No fixed ports: ``port=0`` binds an OS-assigned port, read back from the
listening socket (``HttpTransport.port``).
"""

import http.client
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qsl

from raft_tpu_torch.chaos import ChaosInjector, get_injector
from raft_tpu_torch.resilience import TransientError
from raft_tpu_torch.serve import wire
from raft_tpu_torch.utils.profiling import logger

#: upper bound on one handler's wait for a terminal result; past it the
#: transport writes a terminal "failed" line itself
DEFAULT_RESULT_WAIT_S = 600.0

MAX_BODY_BYTES = 64 * 1024 * 1024


class ConnectionDropped(TransientError):
    """The server closed the stream before the terminal result line —
    retry-eligible (a solve is pure; re-submitting cannot apply twice)."""


class WireChecksumError(ConnectionDropped):
    """A response payload failed its embedded checksum (serve/wire.py):
    in-flight corruption.  A ConnectionDropped, so the router retries
    instead of ever decoding the wrong bits."""


def _flip_first_leaf(value):
    """First numeric leaf of a nested list/dict flipped to another value;
    everything else untouched."""
    if isinstance(value, list) and value:
        return [_flip_first_leaf(value[0])] + value[1:]
    if isinstance(value, dict) and value:
        key = next(iter(value))
        return {**value, key: _flip_first_leaf(value[key])}
    if isinstance(value, (int, float)):
        return -float(value) - 1.0
    return value


def _corrupt_payload(doc):
    """The wire_corrupt mutation: one payload value of a decoded response
    flipped — a still-valid-JSON corruption, the kind only a payload
    checksum catches."""
    out = dict(doc)
    for key in ("Xi_re", "Xi_r", "std", "gradient", "value", "theta"):
        if key in out:
            out[key] = _flip_first_leaf(out[key])
            return out
    return out


def injector(chaos):
    """A chaos injector from a spec string (chaos.py), or the injector
    itself when one is given (a router shares its own with its
    clients)."""
    if isinstance(chaos, ChaosInjector):
        return chaos
    return get_injector(chaos)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "raft-tpu-torch-serve"

    def log_message(self, fmt, *args):  # stdout belongs to the CLI lines
        logger.debug("http: " + fmt % args)

    # -- plumbing ---------------------------------------------------

    @property
    def transport(self):
        return self.server.transport

    def _send_json(self, code, doc):
        payload = (wire.dumps(doc) + "\n").encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _send_text(self, code, text,
                   content_type="text/plain; version=0.0.4"):
        payload = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _chunk(self, doc):
        data = (wire.dumps(doc) + "\n").encode()
        self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
        self.wfile.flush()

    def _end_chunks(self):
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()

    def _read_body(self, required=True):
        """The request's JSON body (``{}`` when empty and not required);
        raises OverflowError for a body over MAX_BODY_BYTES."""
        length = int(self.headers.get("Content-Length", 0))
        if length > MAX_BODY_BYTES:
            raise OverflowError("body too large")
        if not length and not required:
            return {}
        return json.loads(self.rfile.read(length))

    # -- routes -----------------------------------------------------

    def do_GET(self):
        path, _, query = self.path.partition("?")
        backend = self.transport.backend
        if path == "/healthz":
            return self._send_json(200, {"status": "alive",
                                         "uptime_s": round(
                                             self.transport.uptime_s, 3)})
        if path == "/readyz":
            ready, probe = self.transport.readiness()
            return self._send_json(200 if ready else 503, probe)
        if path == "/statz":
            doc = backend.snapshot()
            registry = getattr(backend, "metrics", None)
            if registry is not None:
                doc = dict(doc)
                doc["metrics"] = registry.to_doc()
            return self._send_json(200, doc)
        if path == "/metricz":
            registry = getattr(backend, "metrics", None)
            if registry is None:
                return self._send_json(
                    404, {"error": "backend has no metrics registry"})
            return self._send_text(200, registry.render_prometheus())
        if path == "/tracez":
            ring = getattr(backend, "trace_ring", None)
            if ring is None:
                return self._send_json(
                    404, {"error": "backend has no trace ring"})
            params = dict(parse_qsl(query))
            try:
                limit = int(params["limit"]) if "limit" in params \
                    else None
            except ValueError:
                return self._send_json(
                    400, {"error": f"bad limit {params['limit']!r}"})
            spans = ring.spans(limit=limit,
                               trace_id=params.get("trace_id"))
            doc = {"spans": spans, "n_spans": len(spans)}
            doc.update(ring.snapshot())
            return self._send_json(200, doc)
        if path == "/versionz":
            # the attach handshake surface (Router.attach_remote): a peer
            # compares the wire version, the flag surface and the flags'
            # values before routing any work here
            from raft_tpu_torch.serve.cache import FLAG_SURFACE

            return self._send_json(200, {
                "wire_version": wire.WIRE_VERSION,
                "flags": dict(getattr(backend, "flags", None) or {}),
                "flag_surface": list(FLAG_SURFACE),
                "uptime_s": round(self.transport.uptime_s, 3)})
        return self._send_json(404, {"error": f"no route {path}"})

    def do_POST(self):
        path, _, query = self.path.partition("?")
        if path == "/v1/sweep":
            return self._post_sweep()
        if path == "/v1/grad":
            return self._post_grad()
        if path == "/profilez":
            return self._post_profilez()
        if path == "/v1/cache/preload":
            return self._post_cache_preload()
        if path != "/v1/solve":
            return self._send_json(404, {"error": f"no route {path}"})
        if self.transport.draining:
            return self._send_json(503, {"error": "draining"})
        try:
            doc = self._read_body()
            design, cases, deadline_s, _xi = wire.parse_request(doc)
            if isinstance(design, str):
                from raft_tpu_torch.io.schema import load_design
                design = load_design(design)
        except OverflowError as e:
            return self._send_json(413, {"error": str(e)})
        except wire.WireError as e:
            return self._send_json(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — bad body, keep serving
            return self._send_json(
                400, {"error": f"{type(e).__name__}: {e}"})

        stream = "stream=0" not in query
        try:
            handle = self.transport.backend.submit(
                design, cases=cases, deadline_s=deadline_s,
                trace=wire.parse_trace(doc))
        except RuntimeError as e:           # backend already stopped
            return self._send_json(503, {"error": str(e)})

        self.transport.note_accept(handle.rid)
        try:
            if stream:
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                self._chunk({"event": "accepted", "rid": handle.rid})
            inj = self.transport.chaos
            if inj is not None and inj.should("conn_drop",
                                              handle.rid) is not None:
                # drop the client mid-stream; the engine handle resolves
                # on its own
                logger.warning("chaos conn_drop: closing rid=%d stream",
                               handle.rid)
                self.close_connection = True
                self.connection.close()
                return
            doc = self.transport.wait_terminal(handle)
            if stream:
                self._chunk(doc)
                self._end_chunks()
            else:
                self._send_json(wire.HTTP_STATUS.get(doc["status"], 500),
                                doc)
        except (BrokenPipeError, ConnectionResetError):
            # the client went away mid-wait; the engine still resolves
            # the handle
            self.close_connection = True

    def _post_profilez(self):
        """``POST /profilez`` — arm a one-shot ``torch.profiler`` capture
        around the backend's next dispatch window.  Body: optional JSON
        ``{"log_dir": ...}``; without one the transport's
        ``profile_dir``."""
        backend = self.transport.backend
        capture = getattr(backend, "capture_profile", None)
        if capture is None:
            return self._send_json(
                404, {"error": "backend has no profiler hook"})
        try:
            body = self._read_body(required=False)
        except OverflowError as e:
            return self._send_json(413, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — bad body, keep serving
            return self._send_json(
                400, {"error": f"{type(e).__name__}: {e}"})
        log_dir = body.get("log_dir") or self.transport.profile_dir
        if not log_dir:
            return self._send_json(400, {
                "armed": False,
                "error": "no log_dir in the body and no profile_dir"})
        doc = capture(log_dir=log_dir)
        code = 200 if doc.get("armed", True) else 409
        return self._send_json(code, doc)

    def _post_cache_preload(self):
        """``POST /v1/cache/preload`` — one chunk of a shared-nothing warm
        transfer (a checksummed result-cache entry's raw npz bytes, the
        warm-handoff manifest or the warm-up bucket manifest), through
        ``backend.preload_wire``; a torn or corrupt chunk is refused,
        never served."""
        if self.transport.draining:
            return self._send_json(503, {"error": "draining"})
        preload = getattr(self.transport.backend, "preload_wire", None)
        if preload is None:
            return self._send_json(
                404, {"error": "backend has no wire-preload surface"})
        try:
            body = self._read_body(required=False)
        except OverflowError as e:
            return self._send_json(413, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — bad body, keep serving
            return self._send_json(
                400, {"error": f"{type(e).__name__}: {e}"})
        try:
            doc = preload(body)
        except ValueError as e:
            return self._send_json(400, {"error": str(e)})
        code = 200 if not doc.get("error") else 409
        return self._send_json(code, doc)

    def _post_grad(self):
        """``POST /v1/grad`` — one objective and its exact adjoint
        gradient (``submit_grad``), one buffered JSON document."""
        if self.transport.draining:
            return self._send_json(503, {"error": "draining"})
        try:
            doc = self._read_body()
            design, objective = wire.parse_grad_request(doc)
            if isinstance(design, str):
                from raft_tpu_torch.io.schema import load_design
                design = load_design(design)
        except OverflowError as e:
            return self._send_json(413, {"error": str(e)})
        except wire.WireError as e:
            return self._send_json(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — bad body, keep serving
            return self._send_json(
                400, {"error": f"{type(e).__name__}: {e}"})
        try:
            handle = self.transport.backend.submit_grad(
                design, objective, trace=wire.parse_trace(doc))
        except RuntimeError as e:           # backend already stopped
            return self._send_json(503, {"error": str(e)})
        except ValueError as e:             # objective refused upstream
            return self._send_json(400, {"error": str(e)})
        self.transport.note_accept(handle.rid)
        self.transport.enter()
        try:
            wait = self.transport.result_wait_s
            try:
                res = handle.result(timeout=wait)
                out = wire.grad_result_doc(res)
            except TimeoutError:
                out = {"event": "grad_result", "rid": handle.rid,
                       "status": "failed",
                       "error": f"transport result wait exceeded "
                                f"{wait:.0f}s"}
            self._send_json(wire.HTTP_STATUS.get(out["status"], 500),
                            out)
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True
        finally:
            self.transport.leave()

    def _post_sweep(self):
        """``POST /v1/sweep`` — streamed NDJSON: ``accepted`` (rid,
        n_designs, n_chunks), one ``sweep_chunk`` line per chunk as the
        batcher finishes it, then exactly one terminal ``sweep_result``
        line without the aggregate arrays (``wire.sweep_result_from_doc``
        reassembles them client-side)."""
        if self.transport.draining:
            return self._send_json(503, {"error": "draining"})
        try:
            doc = self._read_body()
            designs, cases, chunk = wire.parse_sweep_request(doc)
            if any(isinstance(d, str) for d in designs):
                from raft_tpu_torch.io.schema import load_design
                designs = [load_design(d) if isinstance(d, str) else d
                           for d in designs]
        except OverflowError as e:
            return self._send_json(413, {"error": str(e)})
        except wire.WireError as e:
            return self._send_json(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — bad body, keep serving
            return self._send_json(
                400, {"error": f"{type(e).__name__}: {e}"})
        try:
            handle = self.transport.backend.submit_sweep(
                designs, cases=cases, chunk=chunk,
                trace=wire.parse_trace(doc))
        except (RuntimeError, ValueError) as e:   # stopped / empty sweep
            return self._send_json(503, {"error": str(e)})
        self.transport.note_accept(handle.rid)
        self.transport.enter()
        try:
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            self._chunk({"event": "accepted", "rid": handle.rid,
                         "n_designs": handle.n_designs,
                         "n_chunks": handle.n_chunks})
            wait = self.transport.result_wait_s
            try:
                for ch in handle.chunks(timeout=wait):
                    self._chunk(wire.sweep_chunk_doc(ch))
                res = handle.result(timeout=wait)
                self._chunk(wire.sweep_result_doc(res))
            except (queue.Empty, TimeoutError):
                self._chunk({"event": "sweep_result", "rid": handle.rid,
                             "status": "failed",
                             "error": f"transport result wait exceeded "
                                      f"{wait:.0f}s"})
            self._end_chunks()
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True
        finally:
            self.transport.leave()


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


class HttpTransport:
    """Owns the listener socket and its serve thread; see the module
    docstring."""

    _GUARDED_BY = {"_active": "_lock", "_accepted": "_lock"}

    def __init__(self, backend, host="127.0.0.1", port=0,
                 result_wait_s=DEFAULT_RESULT_WAIT_S, chaos=None,
                 profile_dir=None):
        self.backend = backend
        self.result_wait_s = result_wait_s
        self.chaos = injector(chaos)
        self.profile_dir = profile_dir
        self.draining = False
        self._t0 = time.monotonic()
        self._active = 0                  # handlers mid-request
        self._accepted = 0
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._server = _Server((host, port), _Handler)
        self._server.transport = self
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="raft-http",
            daemon=True)
        self._thread.start()
        logger.info("http transport listening on %s:%d", self.host,
                    self.port)

    @property
    def uptime_s(self):
        return time.monotonic() - self._t0

    def note_accept(self, rid):
        with self._lock:
            self._accepted += 1

    def enter(self):
        with self._lock:
            self._active += 1

    def leave(self):
        with self._idle:
            self._active -= 1
            self._idle.notify_all()

    def readiness(self):
        probe = dict(self.backend.probe())
        probe["draining"] = self.draining
        probe["accepted"] = self._accepted
        breakers = probe.get("breaker_states") or {}
        all_open = bool(breakers) and probe.get("breakers_open", 0) >= len(
            breakers)
        ready = (probe.get("accepting", False) and not self.draining
                 and not all_open)
        probe["ready"] = ready
        return ready, probe

    def wait_terminal(self, handle):
        """Block a handler thread for the terminal result document."""
        self.enter()
        try:
            try:
                res = handle.result(timeout=self.result_wait_s)
            except TimeoutError:
                return {"event": "result", "rid": handle.rid,
                        "status": "failed",
                        "error": f"transport result wait exceeded "
                                 f"{self.result_wait_s:.0f}s"}
            return wire.result_doc(res, include_xi=True)
        finally:
            self.leave()

    def drain(self, drain_queue=False, timeout=30.0):
        """Graceful shutdown: refuse new work, resolve ALL in-flight
        requests to terminal lines, then close the listener."""
        self.draining = True
        # resolves every outstanding handle, which unblocks every handler
        # sitting in wait_terminal()
        self.backend.shutdown(wait=True, drain=drain_queue,
                              timeout=timeout)
        deadline = time.monotonic() + timeout
        with self._idle:
            while self._active and time.monotonic() < deadline:
                self._idle.wait(0.1)
            leftover = self._active
        if leftover:
            logger.warning("drain: %d handler(s) still active at close",
                           leftover)
        self.close()
        return {"accepted": self._accepted, "active_at_close": leftover}

    def close(self):
        self._server.shutdown()
        self._server.server_close()


def serve_http(backend, host="127.0.0.1", port=0, **kw):
    """Start an HTTP front end on ``backend``; returns the transport
    (read ``.port`` back: port 0 asks for an OS-assigned one)."""
    return HttpTransport(backend, host=host, port=port, **kw)


class WireClient:
    """Minimal stdlib HTTP client of the wire protocol (the router's
    forwarding tier, the tests, chip_smoke.py and ``RAFT_OMDAO``'s
    endpoint mode).

    ``solve`` returns the terminal result document; any transport-level
    failure (refused connection, dropped stream, premature EOF) raises
    ``ConnectionDropped``, a TransientError, so the router may re-attempt
    on another replica.  ``chaos`` (a spec string or an injector) holds
    the ``net_partition`` and ``wire_corrupt`` faults that fire here."""

    def __init__(self, host, port, timeout=DEFAULT_RESULT_WAIT_S,
                 chaos=None):
        self.host, self.port, self.timeout = host, port, timeout
        self.chaos = injector(chaos)

    def _conn(self, timeout=None):
        return http.client.HTTPConnection(
            self.host, self.port,
            timeout=self.timeout if timeout is None else timeout)

    def _chaos_partition(self):
        """net_partition: drop this endpoint's /v1/* POST traffic (GET
        health probes still answer), the gray failure of a partitioned
        host; ``@PORT`` in the spec targets one endpoint."""
        inj = self.chaos
        if inj is not None and inj.should("net_partition",
                                          self.port) is not None:
            raise ConnectionDropped(
                f"chaos net_partition: {self.host}:{self.port} dropped "
                f"the /v1/* request (health probes still answer)")

    def _verify(self, doc):
        """Refuse a response whose embedded payload checksum does not
        match its payload: raises WireChecksumError.  The wire_corrupt
        mutation lands here, before verification, so a test proves the
        detection."""
        inj = self.chaos
        if inj is not None and inj.should("wire_corrupt",
                                          self.port) is not None:
            logger.warning(
                "chaos wire_corrupt: flipping payload bits of %s "
                "rid=%s from %s:%d", doc.get("event"), doc.get("rid"),
                self.host, self.port)
            doc = _corrupt_payload(doc)
        reason = wire.checksum_mismatch(doc)
        if reason:
            raise WireChecksumError(f"{self.host}:{self.port}: {reason}")
        return doc

    def get(self, path, timeout=10.0):
        """GET a JSON endpoint -> (status_code, doc)."""
        conn = self._conn(timeout)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    def get_text(self, path, timeout=10.0):
        """GET a text endpoint (``/metricz``) -> (status_code, str)."""
        conn = self._conn(timeout)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.status, resp.read().decode()
        finally:
            conn.close()

    def post_json(self, path, doc, timeout=30.0):
        """POST a small JSON document (``/profilez``,
        ``/v1/cache/preload``) -> response doc."""
        self._chaos_partition()
        body = wire.dumps(doc or {}).encode()
        conn = self._conn(timeout)
        try:
            try:
                conn.request("POST", path, body=body, headers={
                    "Content-Type": "application/json"})
                resp = conn.getresponse()
                return json.loads(resp.read())
            except (ConnectionError, http.client.HTTPException,
                    TimeoutError, OSError, ValueError) as e:
                raise ConnectionDropped(
                    f"{self.host}:{self.port}: "
                    f"{type(e).__name__}: {e}") from e
        finally:
            conn.close()

    def _refused(self, resp, what):
        """The error document of a non-200 streamed response; a 503 (the
        drain gate, or a submit racing the engine's shutdown) was refused
        before admission, so it raises ConnectionDropped: safe to
        re-attempt elsewhere."""
        try:
            err = json.loads(resp.read())
        except (ValueError, OSError, http.client.HTTPException):
            err = {"error": f"HTTP {resp.status} (unparseable error body)"}
        if resp.status == 503:
            raise ConnectionDropped(
                f"{self.host}:{self.port} is draining; {what} refused "
                f"before admission ({err.get('error', 'unavailable')})")
        return err

    def solve(self, doc, on_sent=None, slow_s=None):
        """POST a request document, stream the response, return the
        terminal result document.  ``on_sent`` fires once the request is
        on the wire (the replica_kill hook); ``slow_s`` (the replica_slow
        hook) stalls that long, then gives up on the reply as a socket
        timeout would, with ``ConnectionDropped``."""
        self._chaos_partition()
        body = wire.dumps(doc).encode()
        conn = self._conn()
        try:
            try:
                conn.request("POST", "/v1/solve", body=body, headers={
                    "Content-Type": "application/json"})
                if on_sent is not None:
                    on_sent()
                if slow_s is not None:
                    time.sleep(float(slow_s))
                    raise ConnectionDropped(
                        f"chaos replica_slow: gave up on "
                        f"{self.host}:{self.port} after {slow_s:.3f}s")
                resp = conn.getresponse()
                if resp.status != 200:
                    err = self._refused(resp, "request")
                    return {"event": "result", "rid": err.get("rid", -1),
                            "status": err.get("status", "failed"),
                            "http_status": resp.status,
                            "error": err.get("error",
                                             f"HTTP {resp.status}")}
                terminal = None
                while True:
                    line = resp.readline()
                    if not line:
                        break
                    event = json.loads(line)
                    if event.get("event") == "result":
                        terminal = event
                if terminal is None:
                    raise ConnectionDropped(
                        f"stream from {self.host}:{self.port} ended "
                        f"before a terminal result line")
                return self._verify(terminal)
            except (ConnectionError, http.client.HTTPException,
                    TimeoutError, OSError) as e:
                raise ConnectionDropped(
                    f"{self.host}:{self.port}: "
                    f"{type(e).__name__}: {e}") from e
        finally:
            conn.close()

    def grad(self, doc, timeout=None):
        """POST a grad request document to ``/v1/grad``; returns the
        terminal ``grad_result`` document.  A 503 raises
        ``ConnectionDropped`` (refused before admission, or resolved
        ``shutdown`` by a retiring replica: either way safe to retry)."""
        self._chaos_partition()
        body = wire.dumps(doc).encode()
        conn = self._conn(timeout)
        try:
            try:
                conn.request("POST", "/v1/grad", body=body, headers={
                    "Content-Type": "application/json"})
                resp = conn.getresponse()
                raw = resp.read()
                try:
                    out = json.loads(raw)
                except ValueError:
                    out = {}
                if resp.status == 503:
                    raise ConnectionDropped(
                        f"{self.host}:{self.port} is draining; grad "
                        f"request not served "
                        f"({out.get('error', 'unavailable')})")
                if out.get("event") == "grad_result":
                    return self._verify(out)
                return {"event": "grad_result",
                        "rid": out.get("rid", -1),
                        "status": out.get("status", "failed"),
                        "http_status": resp.status,
                        "error": out.get("error",
                                         f"HTTP {resp.status}")}
            except (ConnectionError, http.client.HTTPException,
                    TimeoutError, OSError) as e:
                raise ConnectionDropped(
                    f"{self.host}:{self.port}: "
                    f"{type(e).__name__}: {e}") from e
        finally:
            conn.close()

    def sweep(self, doc, on_chunk=None, on_sent=None):
        """POST a sweep request document to ``/v1/sweep`` and stream the
        response.  Returns ``(terminal_doc, chunk_docs)``: the terminal
        ``sweep_result`` line and the decoded chunk docs, ready for
        ``wire.sweep_result_from_doc(terminal, chunks=chunk_docs)``.
        ``on_chunk`` fires per decoded chunk."""
        self._chaos_partition()
        body = wire.dumps(doc).encode()
        conn = self._conn()
        try:
            try:
                conn.request("POST", "/v1/sweep", body=body, headers={
                    "Content-Type": "application/json"})
                if on_sent is not None:
                    on_sent()
                resp = conn.getresponse()
                if resp.status != 200:
                    err = self._refused(resp, "sweep")
                    return ({"event": "sweep_result",
                             "rid": err.get("rid", -1),
                             "status": err.get("status", "failed"),
                             "http_status": resp.status,
                             "error": err.get("error",
                                              f"HTTP {resp.status}")},
                            [])
                terminal, chunks = None, []
                while True:
                    line = resp.readline()
                    if not line:
                        break
                    event = json.loads(line)
                    kind = event.get("event")
                    if kind == "sweep_chunk":
                        ch = wire.sweep_chunk_from_doc(
                            self._verify(event))
                        chunks.append(ch)
                        if on_chunk is not None:
                            on_chunk(ch)
                    elif kind == "sweep_result":
                        terminal = event
                if terminal is None:
                    raise ConnectionDropped(
                        f"sweep stream from {self.host}:{self.port} "
                        f"ended before a terminal sweep_result line")
                return terminal, chunks
            except (ConnectionError, http.client.HTTPException,
                    TimeoutError, OSError) as e:
                raise ConnectionDropped(
                    f"{self.host}:{self.port}: "
                    f"{type(e).__name__}: {e}") from e
        finally:
            conn.close()
