"""Wire schema of the served solve (the port's ``raft_tpu/serve/wire.py``):
the ONE encoding shared by the stdin JSON-line loop (``__main__``), the
HTTP transport (serve/transport.py) and the replica router
(serve/router.py).  A document written here equals the one the JAX
package writes for the same arrays and fields, checksum included, so a
client of either package reads the other's documents.

Request document::

    {"design": <design dict | path str>,   # required
     "cases":  [...],                      # optional case rows
     "deadline_s": 10.0,                   # optional admission deadline
     "xi": true,                           # include complex amplitudes
     "trace": {"trace_id": "...",          # optional trace context
               "parent_span_id": "..."}}

Terminal result document (one per request: every accepted rid gets
exactly one)::

    {"event": "result", "rid": 3, "status": "ok", ...,
     "std": [[...]], "converged": [...], "nonfinite": [...],
     "Xi_re": [[[...]]], "Xi_im": [[[...]]], "Xi_dtype": "complex128",
     "bucket": {"nw": 40, "n_nodes": 80, "n_slots": 8}}

Bits over the wire: ``json`` writes a Python float through ``repr``,
which round-trips float64 exactly, and every float32 value is exactly a
double, so the decoded arrays are ``np.array_equal`` to the originals in
both precisions.  The dtypes ride along (``std_dtype``, ``Xi_dtype``,
``xi_dtype``) so the decoder rebuilds the engine's exact dtype.  A NaN
(a quarantined lane) is written as the bare token ``NaN``, as Python's
``json`` writes and reads it; both packages encode it so.
"""

import hashlib
import json

import numpy as np

from raft_tpu_torch.serve.buckets import BucketSpec
from raft_tpu_torch.serve.engine import GradResult, RequestResult, \
    SweepResult

WIRE_VERSION = 1

#: payload keys folded into the per-document checksum, by event: exactly
#: the numeric payload a consumer decodes into arrays.  Metadata (rid,
#: status, latency) stays outside: it is diagnostic, not answer bits.
_CHECKSUM_KEYS = {
    "result": ("std", "Xi_re", "Xi_im", "converged", "nonfinite",
               "iters", "recovery_tier", "residual", "cond"),
    "sweep_chunk": ("Xi_r", "Xi_i", "designs", "converged", "iters",
                    "nonfinite", "recovery_tier", "residual", "cond"),
    "grad_result": ("value", "gradient", "theta"),
}


def payload_checksum(doc):
    """Checksum (16 hex chars) of a result document's numeric payload,
    or None when the document carries none (errors, rejections).

    Computed over ``json.dumps(..., sort_keys=True)`` of the payload
    keys; float repr round-trips f64, so the receiver re-checksums the
    decoded document and gets the same digest."""
    keys = _CHECKSUM_KEYS.get(doc.get("event"))
    if not keys:
        return None
    body = {k: doc[k] for k in keys if k in doc}
    if not body:
        return None
    blob = json.dumps(body, sort_keys=True).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()[:16]


def checksum_mismatch(doc):
    """Reason string when ``doc`` embeds a payload checksum that does
    not match its payload; None when it matches or when the document
    carries no checksum (absence is not corruption)."""
    want = doc.get("checksum")
    if not want:
        return None
    got = payload_checksum(doc)
    if got != want:
        return (f"payload checksum mismatch on {doc.get('event')} "
                f"rid={doc.get('rid')} (want {want}, got {got})")
    return None


#: HTTP status of a terminal result that is NOT streamed (a streamed
#: response commits 200 at its accepted chunk; the terminal status then
#: rides in the body)
HTTP_STATUS = {
    "ok": 200,
    "failed": 500,
    "rejected_deadline": 504,
    "rejected_overload": 503,
    "rejected_circuit": 503,
    "watchdog_timeout": 504,
    "shutdown": 503,
}


class WireError(ValueError):
    """A malformed request document (HTTP 400)."""


def jsonable(obj):
    """Recursively convert numpy scalars and arrays so ``json.dumps``
    accepts the value (the stats and snapshot endpoints)."""
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, dict):
        return {str(k): jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


def parse_request(doc):
    """Validate a request document -> (design, cases, deadline_s, xi).
    ``design`` may still be a path string: the transport loads it, the
    router forwards it verbatim."""
    if not isinstance(doc, dict):
        raise WireError("request must be a JSON object")
    if "design" not in doc:
        raise WireError("request missing 'design'")
    design = doc["design"]
    if not isinstance(design, (dict, str)):
        raise WireError("'design' must be a design dict or a path string")
    cases = doc.get("cases")
    if cases is not None and not isinstance(cases, list):
        raise WireError("'cases' must be a list of case rows")
    deadline_s = doc.get("deadline_s")
    if deadline_s is not None:
        try:
            deadline_s = float(deadline_s)
        except (TypeError, ValueError):
            raise WireError("'deadline_s' must be a number") from None
    return design, cases, deadline_s, bool(doc.get("xi", False))


def parse_trace(doc):
    """The request document's trace context, or None (a malformed trace
    section downgrades to untraced, it never fails the request)."""
    from raft_tpu_torch.obs.tracing import TraceContext

    return TraceContext.from_doc(doc.get("trace"))


def result_doc(res, include_xi=False):
    """RequestResult -> terminal result document."""
    doc = {
        "event": "result", "rid": res.rid, "status": res.status,
        "latency_s": round(res.latency_s, 4),
        "batch_requests": res.batch_requests,
        "batch_occupancy": round(res.batch_occupancy, 3),
    }
    if res.error:
        doc["error"] = res.error
    if res.backend:
        doc["backend"] = res.backend
    if res.bucket is not None:
        doc["bucket"] = res.bucket.as_dict()
    if res.replica is not None:
        doc["replica"] = res.replica
    if getattr(res, "trace_id", None):
        doc["trace_id"] = res.trace_id
    if res.status == "ok":
        std = np.asarray(res.std)
        doc["std"] = std.tolist()
        doc["std_dtype"] = str(std.dtype)
        rep = res.solve_report or {}
        for key in ("converged", "nonfinite", "iters", "recovery_tier",
                    "residual", "cond"):
            if key in rep:
                doc[key] = np.asarray(rep[key]).tolist()
        if include_xi and res.Xi is not None:
            doc["Xi_re"] = res.Xi.real.tolist()
            doc["Xi_im"] = res.Xi.imag.tolist()
            doc["Xi_dtype"] = str(res.Xi.dtype)
    cs = payload_checksum(doc)
    if cs:
        doc["checksum"] = cs
    return doc


def result_from_doc(doc, rid=None):
    """Terminal result document -> RequestResult, the arrays rebuilt
    bit for bit in their recorded dtypes."""
    Xi = None
    if "Xi_re" in doc:
        cdt = np.dtype(doc.get("Xi_dtype", "complex128"))
        fdt = np.float32 if cdt == np.complex64 else np.float64
        re = np.asarray(doc["Xi_re"], dtype=fdt)
        Xi = np.empty(re.shape, dtype=cdt)
        Xi.real = re
        Xi.imag = np.asarray(doc["Xi_im"], dtype=fdt)
    std = None
    if "std" in doc:
        std = np.asarray(doc["std"],
                         dtype=np.dtype(doc.get("std_dtype", "float64")))
    report = {k: np.asarray(doc[k], dtype=dt) for k, dt in (
        ("converged", np.bool_), ("nonfinite", np.bool_),
        ("iters", None), ("recovery_tier", None),
        ("residual", np.float64), ("cond", np.float64)) if k in doc}
    bucket = BucketSpec(**doc["bucket"]) if doc.get("bucket") else None
    return RequestResult(
        rid=doc["rid"] if rid is None else rid,
        status=doc["status"],
        error=doc.get("error"),
        Xi=Xi, std=std,
        solve_report=report or None,
        bucket=bucket,
        latency_s=float(doc.get("latency_s", 0.0)),
        batch_requests=int(doc.get("batch_requests", 0)),
        batch_occupancy=float(doc.get("batch_occupancy", 0.0)),
        backend=doc.get("backend"),
        replica=doc.get("replica"),
        trace_id=doc.get("trace_id"),
    )


# ------------------------------------------------------------- sweeps

#: scalar metadata keys of a sweep chunk line
SWEEP_CHUNK_META = ("event", "rid", "chunk", "n_chunks", "designs",
                    "wall_s", "suspend_s", "preemptions", "mode",
                    "failed_idx", "failed_msg")

#: per-design report arrays riding each chunk, with the exact dtypes the
#: engine aggregates under
_SWEEP_ARRAY_DTYPES = (
    ("converged", np.bool_), ("iters", np.int64),
    ("nonfinite", np.bool_), ("recovery_tier", np.int64),
    ("residual", np.float64), ("cond", np.float64),
)


def parse_sweep_request(doc):
    """Validate a sweep request document -> (designs, cases, chunk)::

        {"designs": [<design dict | path str>, ...],  # required
         "cases":  [...],                             # optional rows
         "chunk": 8}                                  # optional
    """
    if not isinstance(doc, dict):
        raise WireError("sweep request must be a JSON object")
    designs = doc.get("designs")
    if not isinstance(designs, list) or not designs:
        raise WireError("sweep request needs a non-empty 'designs' list")
    for d in designs:
        if not isinstance(d, (dict, str)):
            raise WireError(
                "every sweep design must be a design dict or a path "
                "string")
    cases = doc.get("cases")
    if cases is not None and not isinstance(cases, list):
        raise WireError("'cases' must be a list of case rows")
    chunk = doc.get("chunk")
    if chunk is not None:
        try:
            chunk = int(chunk)
        except (TypeError, ValueError):
            raise WireError("'chunk' must be an integer") from None
    return designs, cases, chunk


def sweep_chunk_doc(chunk):
    """Engine chunk doc (numpy arrays, ``SweepHandle.chunks()``) -> wire
    line, under the same bits contract as ``result_doc``."""
    doc = {k: chunk[k] for k in SWEEP_CHUNK_META if k in chunk}
    if "Xi_r" in chunk:
        Xi_r = np.asarray(chunk["Xi_r"])
        doc["Xi_r"] = Xi_r.tolist()
        doc["Xi_i"] = np.asarray(chunk["Xi_i"]).tolist()
        doc["xi_dtype"] = str(Xi_r.dtype)
        for key, _dt in _SWEEP_ARRAY_DTYPES:
            doc[key] = np.asarray(chunk[key]).tolist()
    cs = payload_checksum(doc)
    if cs:
        doc["checksum"] = cs
    return doc


def sweep_chunk_from_doc(doc):
    """Wire chunk line -> chunk doc with numpy arrays in their exact
    dtypes (the engine's ``SweepHandle.chunks()`` shape)."""
    out = {k: doc[k] for k in SWEEP_CHUNK_META if k in doc}
    if "Xi_r" in doc:
        fdt = np.dtype(doc.get("xi_dtype", "float64"))
        out["Xi_r"] = np.asarray(doc["Xi_r"], dtype=fdt)
        out["Xi_i"] = np.asarray(doc["Xi_i"], dtype=fdt)
        for key, dt in _SWEEP_ARRAY_DTYPES:
            out[key] = np.asarray(doc[key], dtype=dt)
    return out


def sweep_result_doc(res):
    """Terminal SweepResult -> wire line WITHOUT the aggregate arrays:
    the chunk lines carried them, and the client reassembles
    (``sweep_result_from_doc(doc, chunks=...)``)."""
    doc = {
        "event": "sweep_result", "rid": res.rid, "status": res.status,
        "n_designs": res.n_designs, "n_chunks": res.n_chunks,
        "chunks_done": res.chunks_done,
        "preemptions": res.preemptions,
        "latency_s": round(res.latency_s, 4),
        "suspend_s": round(res.suspend_s, 4),
        "failed_idx": list(res.failed_idx),
        "failed_msg": list(res.failed_msg),
    }
    if res.mode:
        doc["mode"] = res.mode
    if res.error:
        doc["error"] = res.error
    if res.replica is not None:
        doc["replica"] = res.replica
    if getattr(res, "trace_id", None):
        doc["trace_id"] = res.trace_id
    return doc


def sweep_result_from_doc(doc, chunks=None, rid=None):
    """Terminal sweep line (+ the decoded chunk docs) -> SweepResult,
    each chunk's slice scattered back into design order (rows no chunk
    covered keep the sweep quarantine fills)."""
    Xi_r = Xi_i = report = None
    nd = int(doc.get("n_designs", 0))
    for ch in chunks or []:
        if "Xi_r" not in ch:
            continue
        arr_r = np.asarray(ch["Xi_r"])
        if Xi_r is None:
            shape = (nd,) + arr_r.shape[1:]
            Xi_r = np.full(shape, np.nan, arr_r.dtype)
            Xi_i = np.full(shape, np.nan, arr_r.dtype)
            report = {
                "converged": np.zeros(shape[:2], bool),
                "iters": np.zeros(shape[:2], np.int64),
                "nonfinite": np.zeros(shape[:2], bool),
                "recovery_tier": np.zeros(shape[:2], np.int64),
                "residual": np.full(shape[:2], np.nan, np.float64),
                "cond": np.full(shape[:2], np.nan, np.float64),
            }
        sel = np.asarray(ch["designs"], int)
        Xi_r[sel] = arr_r
        Xi_i[sel] = np.asarray(ch["Xi_i"])
        for key in report:
            report[key][sel] = np.asarray(ch[key])
    return SweepResult(
        rid=doc["rid"] if rid is None else rid,
        status=doc["status"],
        n_designs=nd,
        n_chunks=int(doc.get("n_chunks", 0)),
        chunks_done=int(doc.get("chunks_done", 0)),
        error=doc.get("error"),
        Xi_r=Xi_r, Xi_i=Xi_i, report=report,
        failed_idx=list(doc.get("failed_idx", [])),
        failed_msg=list(doc.get("failed_msg", [])),
        preemptions=int(doc.get("preemptions", 0)),
        mode=doc.get("mode"),
        latency_s=float(doc.get("latency_s", 0.0)),
        suspend_s=float(doc.get("suspend_s", 0.0)),
        replica=doc.get("replica"),
        trace_id=doc.get("trace_id"),
    )


# --------------------------------------------------------------- grad

def parse_grad_request(doc):
    """Validate a grad request document -> (design, objective dict)::

        {"design": <design dict | path str>,       # required
         "objective": {"metric": "rao_pitch_peak",  # required
                       "knobs": ["draft", ...],     # optional subset
                       "theta": [1.0, 1.0, 1.0, 1.0]},  # optional
         "trace": {...}}                            # optional

    A refused objective (``grad.response.parse_objective``) is a
    :class:`WireError` (HTTP 400)."""
    from raft_tpu_torch.grad.response import parse_objective

    if not isinstance(doc, dict):
        raise WireError("grad request must be a JSON object")
    if "design" not in doc:
        raise WireError("grad request missing 'design'")
    design = doc["design"]
    if not isinstance(design, (dict, str)):
        raise WireError("'design' must be a design dict or a path string")
    objective = doc.get("objective")
    try:
        parse_objective(objective)
    except ValueError as e:
        raise WireError(str(e)) from None
    return design, objective


def grad_result_doc(res):
    """GradResult -> terminal grad result document (exact f64 bits)."""
    doc = {
        "event": "grad_result", "rid": res.rid, "status": res.status,
        "latency_s": round(res.latency_s, 4),
        "cache_hit": bool(res.cache_hit),
    }
    if res.error:
        doc["error"] = res.error
    if res.backend:
        doc["backend"] = res.backend
    if res.replica is not None:
        doc["replica"] = res.replica
    if getattr(res, "trace_id", None):
        doc["trace_id"] = res.trace_id
    if res.metric:
        doc["metric"] = res.metric
    if res.theta is not None:
        doc["theta"] = [float(t) for t in res.theta]
    if res.status == "ok":
        doc["value"] = float(res.value)
        doc["knobs"] = list(res.knobs or ())
        doc["gradient"] = {k: float(v)
                           for k, v in (res.gradient or {}).items()}
    cs = payload_checksum(doc)
    if cs:
        doc["checksum"] = cs
    return doc


def grad_result_from_doc(doc, rid=None):
    """Terminal grad result document -> GradResult (exact f64 bits)."""
    gradient = doc.get("gradient")
    if gradient is not None:
        gradient = {str(k): float(v) for k, v in gradient.items()}
    knobs = doc.get("knobs")
    return GradResult(
        rid=doc["rid"] if rid is None else rid,
        status=doc["status"],
        metric=doc.get("metric"),
        knobs=tuple(knobs) if knobs is not None else None,
        value=(float(doc["value"]) if "value" in doc else None),
        gradient=gradient,
        theta=([float(t) for t in doc["theta"]]
               if doc.get("theta") is not None else None),
        error=doc.get("error"),
        latency_s=float(doc.get("latency_s", 0.0)),
        cache_hit=bool(doc.get("cache_hit", False)),
        backend=doc.get("backend"),
        replica=doc.get("replica"),
        trace_id=doc.get("trace_id"),
    )


def dumps(doc):
    """One wire line (no trailing newline); anything that is not plain
    JSON (stats, snapshots) goes through :func:`jsonable`."""
    try:
        return json.dumps(doc)
    except TypeError:
        return json.dumps(jsonable(doc))
