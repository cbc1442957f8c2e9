"""Content-addressed solve-result cache: exact whole-answer memoization
(the port's ``raft_tpu/serve/result_cache.py``).

Every request for one (design, cases, precision) dispatches through the
same fixed-shape bucket, so the served ``Xi``/``std``/report bits do not
depend on batch composition or preemption (the engine's bit-identity
contract).  A hit therefore returns the SAME bits a cold solve would.

The module is integrity-first:

 - **Keying** — ``result_key`` = sha256 over ``routing_key(design)``,
   the full design + case table + precision, and the engine's flag
   surface (serve/cache.py ``current_flags``: card, dtype, fixed-point
   mode, kernel library digests, code version, topology).  A flag
   mismatch is a different key.
 - **Atomic writes** — one ``.npz`` per key, written to a unique tmp
   name and ``os.replace``d into place.
 - **Verified reads** — every ``get`` re-derives the payload checksum,
   re-checks the flag surface and the schema; a corrupt, torn, stale or
   foreign entry is deleted with a logged reason and counted, never
   served.
 - **LRU-by-bytes eviction** — ``cap_mb`` caps the directory; over the
   cap the least recently read entries are removed.
 - **Warm handoff** — a decayed popularity ledger and ``handoff_<tag>``
   manifests (checksummed, atomic, refused and deleted when corrupt)
   name the hot entries a fresh engine preloads.

The chaos faults ``corrupt_result_cache``, ``corrupt_manifest`` and
``stale_handoff`` hook here through the injector given to
:class:`ResultCache`.  ``read_entry_bytes`` / ``receive_entry`` are the
two ends of the shared-nothing wire transfer of entries (``POST
/v1/cache/preload``, serve/transport.py).
"""

import hashlib
import itertools
import json
import os
import threading
import time
from zipfile import BadZipFile

import numpy as np

from raft_tpu_torch.serve.buckets import BucketSpec
from raft_tpu_torch.serve.cache import (
    current_flags,
    flags_mismatch,
    json_default,
    serve_cache_dir,
)
from raft_tpu_torch.utils.profiling import logger

#: bump when the entry layout changes — an old-schema entry must be
#: refused (deleted + recomputed), never reinterpreted
RESULT_SCHEMA = 1

#: popularity-ledger / warm-handoff manifest schema (same bump rule)
MANIFEST_SCHEMA = 1

#: hit-score half-life (seconds): a burst of hits an hour ago should
#: not outrank steady traffic now.  A module constant, not an env knob —
#: the warm-handoff contract only needs "recently popular", not tuning.
POP_HALF_LIFE_S = 600.0

#: ledger auto-persist cadence (hits between flushes); shutdown and
#: ``write_handoff`` flush unconditionally
POP_PERSIST_EVERY = 32

#: entries a warm-handoff manifest ships by default
HANDOFF_TOP_K = 16

#: default byte cap of the result cache (the JAX package's default)
DEFAULT_CAP_MB = 256.0

#: per-process tmp-file sequence: the pid alone is NOT a unique writer
#: id — two dispatch threads storing the same key would share one tmp
#: path and interleave their writes into a garbage file that the rename
#: then publishes (caught by the checksum gate, but a refusal where
#: there should be a clean last-writer-wins overwrite)
_tmp_seq = itertools.count()


def _manifest_checksum(entries):
    return hashlib.sha256(
        json.dumps(entries, sort_keys=True).encode()).hexdigest()


def _write_manifest(path, entries, chaos=None):
    """Atomically persist one checksummed manifest document (the
    popularity ledger or a warm-handoff manifest): tmp + ``os.replace``
    exactly like the entry files, so concurrent ledger writers on a
    shared cache dir interleave freely and a reader can never open a
    half-written document.  Returns True on success; a failed write
    degrades (the ledger is advisory), never raises."""
    doc = {"schema": MANIFEST_SCHEMA, "entries": entries,
           "checksum": _manifest_checksum(entries)}
    tmp = f"{path}.tmp.{os.getpid()}.{next(_tmp_seq)}"
    try:
        with open(tmp, "w") as fh:
            json.dump(doc, fh)
        os.replace(tmp, path)
    except OSError as e:
        logger.warning("result cache: manifest write %s failed (%s: %s)",
                       path, type(e).__name__, e)
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False
    if chaos is not None:
        chaos.corrupt_if("corrupt_manifest", path)
    return True


def load_manifest(path, what="manifest"):
    """Refusing manifest load: -> the entries list, or ``[]`` after
    DELETING the file when it is missing the schema, torn, truncated,
    or fails its checksum — a corrupt ledger/handoff is rebuilt empty,
    it never crashes a spawn (the ``corrupt_manifest`` chaos fault's
    contract)."""
    if not os.path.exists(path):
        return []
    try:
        with open(path) as fh:
            doc = json.load(fh)
        if not isinstance(doc, dict):
            raise ValueError("not a JSON object")
        if int(doc.get("schema", -1)) != MANIFEST_SCHEMA:
            raise ValueError(f"schema {doc.get('schema')!r} != "
                             f"{MANIFEST_SCHEMA}")
        entries = doc.get("entries")
        if not isinstance(entries, list):
            raise ValueError("'entries' is not a list")
        if _manifest_checksum(entries) != doc.get("checksum"):
            raise ValueError("checksum mismatch")
        return entries
    except (OSError, ValueError, TypeError, KeyError,
            UnicodeDecodeError) as e:
        logger.warning(
            "result cache: %s %s refused and deleted (%s: %s) — "
            "rebuilding empty", what, path, type(e).__name__, e)
        try:
            os.remove(path)
        except OSError:
            pass
        return []


def _jsonable_design(obj):
    if hasattr(obj, "tolist"):
        return obj.tolist()
    if hasattr(obj, "item"):
        return obj.item()
    if isinstance(obj, dict):
        return {str(k): _jsonable_design(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable_design(v) for v in obj]
    return obj


# member fields that determine physics/bucket identity; fills and
# densities (l_fill, rho_fill, rho_shell) are ballast knobs that leave
# the bucket untouched, so variants share a routing key
_ROUTING_MEMBER_KEYS = ("name", "type", "shape", "rA", "rB", "gamma",
                        "potMod", "stations", "d", "t", "Cd", "Ca",
                        "CdEnd", "CaEnd")


def routing_key(design, cases=None):
    """Stable physics/bucket placement key of a request (the port's copy
    of ``raft_tpu/serve/router.py``'s ``routing_key``, the same string
    for the same design): the frequency settings, the site, the member
    geometry and the case count, not the full design, so a ballast sweep
    over one hull shares one key."""
    if cases is not None:
        n_cases = len(cases)
    else:
        n_cases = len(design.get("cases", {}).get("data", []) or [])
    doc = {
        "settings": design.get("settings"),
        "site": design.get("site"),
        "dlsMax": design.get("platform", {}).get("dlsMax"),
        "members": [
            {k: m.get(k) for k in _ROUTING_MEMBER_KEYS if k in m}
            for m in design.get("platform", {}).get("members", [])
        ],
        "n_cases": int(n_cases),
    }
    payload = json.dumps(_jsonable_design(doc), sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _flags_blob(flags):
    return json.dumps(flags, sort_keys=True, default=str).encode()


def result_key(design, cases, precision, flags=None):
    """Content address of one solo request's exact answer.

    ``routing_key`` pins the physics/bucket identity, the full
    design/cases/precision json pins every remaining knob (ballast
    fills included — they change bits, unlike the routing key's view),
    and the flag surface pins the dispatch configuration.  Mirrors
    ``cache.design_prep_key``'s json discipline so the key is stable
    across processes."""
    payload = json.dumps([design, cases, precision], sort_keys=True,
                         default=json_default)
    h = hashlib.sha256(b"result|")
    h.update(routing_key(design, cases).encode())
    h.update(payload.encode())
    h.update(_flags_blob(flags or current_flags()))
    return h.hexdigest()[:32]


def sweep_chunk_key(designs, cases, precision, flags=None):
    """Content address of one sweep chunk's aggregate slice (the sweeps'
    checkpoint schema arrays).  Keyed on the chunk's EXACT design list,
    so overlapping sweeps share work only when their chunking lines up
    on identical designs — never on a near-miss."""
    payload = json.dumps([designs, cases, precision], sort_keys=True,
                         default=json_default)
    h = hashlib.sha256(b"sweep-chunk|")
    h.update(payload.encode())
    h.update(_flags_blob(flags or current_flags()))
    return h.hexdigest()[:32]


def grad_key(design, objective, precision, flags=None):
    """Content address of one served grad answer (value + adjoint
    gradient of one objective at one evaluation point).

    ``objective`` must be the CANONICAL parsed form — the dict
    ``{"metric", "knobs", "theta"}`` built from
    :func:`raft_tpu_torch.grad.response.parse_objective`'s output — so the
    engine and the router derive identical keys from one wire doc.
    The flag surface (which carries the ``grad`` axis: adjoint rule
    revision + iteration cap) pins the adjoint configuration, so a gradient
    computed under one adjoint configuration is never served under
    another."""
    payload = json.dumps([design, objective, precision], sort_keys=True,
                         default=json_default)
    h = hashlib.sha256(b"grad|")
    h.update(routing_key(design, None).encode())
    h.update(payload.encode())
    h.update(_flags_blob(flags or current_flags()))
    return h.hexdigest()[:32]


def coalesce_key(design, cases=None):
    """Single-flight identity for router-level in-flight coalescing:
    two requests with this key equal are guaranteed identical bits
    (same full design + case table), so the second can ride the first's
    dispatch.  Flags are deliberately absent — every replica of one
    deployment shares them, and the router never serves bytes itself;
    it only shares a *dispatch*."""
    payload = json.dumps([design, cases], sort_keys=True, default=json_default)
    h = hashlib.sha256(b"single-flight|")
    h.update(routing_key(design, cases).encode())
    h.update(payload.encode())
    return h.hexdigest()[:32]


def sweep_coalesce_key(designs, cases=None):
    """Single-flight identity of one sweep CHUNK (router chunk-level
    coalescing): the chunk's exact ordered design list + case table.
    Flags are deliberately absent, exactly as in ``coalesce_key`` — a
    matching key guarantees identical bits from any replica of the
    deployment, so a second sweep's chunk can ride the first's relayed
    chunk doc."""
    payload = json.dumps([designs, cases], sort_keys=True,
                         default=json_default)
    h = hashlib.sha256(b"sweep-chunk-flight|")
    h.update(payload.encode())
    return h.hexdigest()[:32]


def _payload_checksum(arrays):
    """sha256 over the raw bytes (+ dtype/shape) of every payload array
    in name order — the embedded integrity witness ``get`` re-derives."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


class ResultCache:
    """One ``result_<key>.npz`` per exact answer under
    ``<cache_dir>/serve/results/``; see module docstring for the
    integrity contract.  ``get_*`` returns ``(payload | None,
    n_refused)`` so the caller can count corrupt-entry quarantines
    without racing another thread's refusals."""

    def __init__(self, cache_dir=None, cap_mb=DEFAULT_CAP_MB, flags=None,
                 chaos=None):
        self.dir = os.path.join(serve_cache_dir(cache_dir), "results")
        os.makedirs(self.dir, exist_ok=True)
        self.cap_bytes = int(float(cap_mb) * 1e6)
        self._lock = threading.Lock()
        self._chaos = chaos
        # the engine's flag surface, frozen once so the hot submit path
        # never re-hashes the code-version file set
        self.flags = flags if flags is not None else current_flags()
        self.bytes_total = self._scan_bytes()
        # popularity ledger: key -> [kind, score, t_last] with the score
        # hit-count-decayed (half-life POP_HALF_LIFE_S).  Loaded with
        # the refusing loader, persisted atomically beside the entries;
        # each process persists its own view (last writer wins) — the
        # ledger is advisory warm-handoff input, never a bits input.
        self.pop_path = os.path.join(self.dir, "popularity.json")
        self._pop = {}
        self._pop_dirty = 0
        for ent in load_manifest(self.pop_path, "popularity ledger"):
            try:
                key, kind, score, t_last = ent
                self._pop[str(key)] = [str(kind), float(score),
                                       float(t_last)]
            except (TypeError, ValueError):
                continue               # malformed row: skip, keep rest

    # ------------------------------------------------------------ paths

    def _path(self, key):
        return os.path.join(self.dir, f"result_{key}.npz")

    def _entries(self):
        out = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for name in names:
            if not (name.startswith("result_") and name.endswith(".npz")):
                continue
            if ".tmp." in name:            # in-flight write, not an entry
                continue
            path = os.path.join(self.dir, name)
            try:
                st = os.stat(path)
            except OSError:
                continue                   # concurrently evicted: fine
            out.append((st.st_mtime, st.st_size, path))
        return out

    def _scan_bytes(self):
        return sum(size for _mtime, size, _path in self._entries())

    # ------------------------------------------------------------ solo

    def put_result(self, key, res):
        """Store an ``ok`` RequestResult's answer arrays.  Returns the
        number of LRU evictions the store forced (-1 when the write
        itself failed — the cache degrades, the request already has its
        answer)."""
        Xi = np.asarray(res.Xi)
        std = np.asarray(res.std)
        arrays = {
            "Xi_re": np.ascontiguousarray(Xi.real),
            "Xi_im": np.ascontiguousarray(Xi.imag),
            "std": std,
        }
        rep = res.solve_report or {}
        for name in rep:
            arrays[f"rep_{name}"] = np.asarray(rep[name])
        meta = {
            "kind": "result",
            "xi_dtype": str(Xi.dtype),
            "report_keys": sorted(rep),
            "bucket": (res.bucket.as_dict()
                       if res.bucket is not None else None),
            "backend": res.backend,
        }
        return self._put(key, arrays, meta)

    def get_result(self, key):
        """-> (payload dict | None, n_refused).  The payload's ``Xi``/
        ``std``/``solve_report`` arrays carry the exact stored bits
        (npz round-trips dtypes; the complex Xi is rebuilt from its
        re/im planes)."""
        hit, refused = self._get(key, "result")
        if hit is None:
            return None, refused
        arrays, meta = hit
        re = arrays["Xi_re"]
        Xi = np.empty(re.shape, dtype=np.dtype(
            meta.get("xi_dtype", "complex128")))
        Xi.real = re
        Xi.imag = arrays["Xi_im"]
        report = {name: arrays[f"rep_{name}"]
                  for name in meta.get("report_keys", [])}
        bucket = (BucketSpec(**meta["bucket"])
                  if meta.get("bucket") else None)
        return {"Xi": Xi, "std": arrays["std"],
                "solve_report": report or None, "bucket": bucket,
                "backend": meta.get("backend")}, refused

    # ------------------------------------------------------------- grad

    def put_grad(self, key, res):
        """Store an ``ok`` GradResult's value + adjoint gradient (all
        f64 scalars — npz round-trips the exact bits).  Same return
        contract as ``put_result``."""
        knobs = sorted(res.gradient)
        arrays = {
            "value": np.asarray(res.value, np.float64),
            "gradient": np.asarray([res.gradient[k] for k in knobs],
                                   np.float64),
            "theta": np.asarray(res.theta, np.float64),
        }
        meta = {
            "kind": "grad",
            "metric": res.metric,
            "knobs": knobs,
            "backend": res.backend,
        }
        return self._put(key, arrays, meta)

    def get_grad(self, key):
        """-> (payload dict | None, n_refused): value / gradient /
        theta / metric / backend, bit-exact as stored."""
        hit, refused = self._get(key, "grad")
        if hit is None:
            return None, refused
        arrays, meta = hit
        knobs = list(meta.get("knobs", []))
        g = arrays["gradient"]
        return {"value": float(arrays["value"]),
                "gradient": {k: float(g[i])
                             for i, k in enumerate(knobs)},
                "theta": [float(t) for t in arrays["theta"]],
                "metric": meta.get("metric"),
                "backend": meta.get("backend")}, refused

    # ----------------------------------------------------------- sweeps

    def put_chunk(self, key, arrays):
        """Store one sweep chunk's aggregate arrays (``Xi_r``/``Xi_i``
        + the sweeps' checkpoint report keys), already in their exact
        engine dtypes.  Same return contract as ``put_result``."""
        return self._put(
            key, {name: np.asarray(a) for name, a in arrays.items()},
            {"kind": "sweep_chunk"})

    def get_chunk(self, key):
        """-> (array dict | None, n_refused)."""
        hit, refused = self._get(key, "sweep_chunk")
        if hit is None:
            return None, refused
        arrays, _meta = hit
        return dict(arrays), refused

    # ------------------------------------------------------------- core

    def _put(self, key, arrays, meta):
        meta = dict(meta)
        meta["schema"] = RESULT_SCHEMA
        meta["flags"] = self.flags
        meta["checksum"] = _payload_checksum(arrays)
        meta["created"] = time.time()
        payload = dict(arrays)
        payload["meta"] = np.array(json.dumps(meta, default=str))
        path = self._path(key)
        tmp = path + f".tmp.{os.getpid()}.{next(_tmp_seq)}"
        try:
            np.savez(tmp, **payload)
            # np.savez appends .npz to the tmp name; the rename is the
            # commit point — readers only ever see whole files
            os.replace(tmp + ".npz", path)
        except OSError as e:
            logger.warning(
                "result cache: store %s failed (%s: %s); serving "
                "uncached", key, type(e).__name__, e)
            try:
                os.remove(tmp + ".npz")
            except OSError:
                pass
            return -1
        if self._chaos is not None:
            self._chaos.corrupt_if("corrupt_result_cache", path)
        with self._lock:
            try:
                self.bytes_total += os.path.getsize(path)
            except OSError:
                pass                       # already evicted by a peer
            return self._evict_locked(exclude=path)

    def _get(self, key, kind):
        """-> ((arrays, meta) | None, n_refused) with every integrity
        gate applied; an entry failing ANY gate is deleted + counted."""
        path = self._path(key)
        if not os.path.exists(path):
            return None, 0
        try:
            with np.load(path, allow_pickle=False) as z:
                meta = json.loads(str(z["meta"]))
                if int(meta.get("schema", -1)) != RESULT_SCHEMA:
                    return None, self._refuse(
                        key, path, f"schema {meta.get('schema')!r} != "
                                   f"{RESULT_SCHEMA}")
                if meta.get("kind") != kind:
                    return None, self._refuse(
                        key, path,
                        f"foreign kind {meta.get('kind')!r}")
                reason = flags_mismatch(meta.get("flags", {}),
                                        self.flags)
                if reason:
                    return None, self._refuse(key, path, reason)
                arrays = {name: z[name] for name in z.files
                          if name != "meta"}
            if _payload_checksum(arrays) != meta.get("checksum"):
                return None, self._refuse(
                    key, path, "payload checksum mismatch")
        except (OSError, ValueError, KeyError, BadZipFile) as e:
            # np.load raises zipfile.BadZipFile on truncated archives
            return None, self._refuse(
                key, path, f"unreadable ({type(e).__name__}: {e})")
        try:
            os.utime(path)                 # LRU recency touch
        except OSError:
            pass
        self._note_hit(key, kind)
        return (arrays, meta), 0

    # ------------------------------------------- popularity / handoff

    def _note_hit(self, key, kind):
        """Bump one entry's decayed hit score and auto-persist the
        ledger every POP_PERSIST_EVERY hits (the flush itself is atomic
        and off the hot path's critical section)."""
        now = time.time()
        with self._lock:
            ent = self._pop.get(key)
            if ent is None:
                self._pop[key] = [kind, 1.0, now]
            else:
                ent[1] = ent[1] * 2.0 ** (
                    -max(0.0, now - ent[2]) / POP_HALF_LIFE_S) + 1.0
                ent[2] = now
            self._pop_dirty += 1
            flush = self._pop_dirty >= POP_PERSIST_EVERY
            if flush:
                self._pop_dirty = 0
        if flush:
            self.flush_popularity()

    def flush_popularity(self):
        """Persist the popularity ledger now (atomic, checksummed).
        Returns True on success."""
        with self._lock:
            entries = [[key, e[0], round(float(e[1]), 6), e[2]]
                       for key, e in self._pop.items()]
        return _write_manifest(self.pop_path, entries, self._chaos)

    def top_entries(self, k=HANDOFF_TOP_K):
        """The ledger head: up to ``k`` ``(key, kind)`` pairs, hottest
        first by decayed score as of now."""
        now = time.time()
        with self._lock:
            scored = sorted(
                ((e[1] * 2.0 ** (-max(0.0, now - e[2]) / POP_HALF_LIFE_S),
                  key, e[0]) for key, e in self._pop.items()),
                reverse=True)
        return [(key, kind) for _s, key, kind in scored[:max(0, int(k))]]

    def write_handoff(self, tag, top_k=HANDOFF_TOP_K):
        """Ship the popularity head to a spawning replica: persist the
        ledger, then write ``handoff_<tag>.json`` naming the top-K
        hottest entries (atomic + checksummed like everything else
        here).  Returns ``(path, n_entries)``, or ``(None, 0)`` when the
        ledger is empty or the write failed — a spawn without a handoff
        is just a cold replica, never an error.

        The ``stale_handoff`` chaos fault prepends ``value`` bogus keys
        that name no entry on disk: the receiving replica's preload must
        count them as plain misses and keep going."""
        self.flush_popularity()
        entries = [[key, kind] for key, kind in self.top_entries(top_k)]
        if self._chaos is not None:
            rule = self._chaos.should("stale_handoff")
            if rule is not None:
                n = int(rule.value if rule.value is not None else 3)
                entries = [[f"stale{i:03d}".ljust(32, "0"), "result"]
                           for i in range(n)] + entries
        if not entries:
            return None, 0
        path = os.path.join(self.dir, f"handoff_{tag}.json")
        if not _write_manifest(path, entries, self._chaos):
            return None, 0
        return path, len(entries)

    def preload(self, entries):
        """Warm-handoff preload: one fully-verified read per named
        entry (checksum + flag surface + schema — the standard gates),
        which LRU-touches it, seeds this process's popularity view and
        pulls the bytes through the OS page cache before the first
        request lands.  Entries that are missing, evicted, or refused
        count as plain misses.  Returns ``(n_loaded, n_missing)``."""
        loaded = missing = 0
        for ent in entries:
            try:
                key, kind = str(ent[0]), str(ent[1])
            except (TypeError, IndexError):
                missing += 1
                continue
            if kind == "sweep_chunk":
                hit, _refused = self.get_chunk(key)
            elif kind == "grad":
                hit, _refused = self.get_grad(key)
            else:
                hit, _refused = self.get_result(key)
            if hit is None:
                missing += 1
            else:
                loaded += 1
        return loaded, missing

    # ------------------------------------- shared-nothing wire transfer

    def read_entry_bytes(self, key):
        """Raw npz bytes of one stored entry, the payload unit of the
        shared-nothing warm transfer (``POST /v1/cache/preload``); None
        when the entry is missing or unreadable (evicted since
        ``top_entries``: skip it, never an error)."""
        try:
            with open(self._path(key), "rb") as fh:
                return fh.read()
        except OSError:
            return None

    def receive_entry(self, key, kind, data, sha256hex):
        """Commit one checksummed chunk of a wire warm transfer.

        Gates, in order: the TRANSFER checksum (a torn or truncated chunk
        is refused before any bytes touch the cache dir), an atomic
        tmp+rename commit, then the standard fully verified read (schema,
        kind, flag surface, payload checksum), so a chunk that survives
        transit but carries corrupt or foreign bits is refused and
        deleted like a shared-dir entry.  Returns ``"loaded"`` or
        ``"refused"``."""
        if (not isinstance(key, str) or not key or len(key) > 64
                or not key.isalnum()):
            logger.warning("wire preload: malformed entry key %r "
                           "refused", key)
            return "refused"
        if hashlib.sha256(data).hexdigest() != sha256hex:
            logger.warning(
                "wire preload: entry %s transfer checksum mismatch (torn "
                "or corrupt chunk) — refused, nothing written", key)
            return "refused"
        path = self._path(key)
        tmp = path + f".tmp.{os.getpid()}.{next(_tmp_seq)}"
        try:
            with open(tmp, "wb") as fh:
                fh.write(data)
            os.replace(tmp, path)
        except OSError as e:
            logger.warning("wire preload: entry %s write failed (%s: %s)",
                           key, type(e).__name__, e)
            try:
                os.remove(tmp)
            except OSError:
                pass
            return "refused"
        with self._lock:
            self.bytes_total += len(data)
        if kind == "sweep_chunk":
            hit, _refused = self.get_chunk(key)
        elif kind == "grad":
            hit, _refused = self.get_grad(key)
        else:
            hit, _refused = self.get_result(key)
        if hit is None:
            return "refused"
        with self._lock:
            self._evict_locked(exclude=path)
        return "loaded"

    def _refuse(self, key, path, reason):
        """Quarantine one entry: log why, delete it, shrink the byte
        ledger.  Returns 1 (the refusal count the caller reports)."""
        logger.warning(
            "result cache: entry %s refused and deleted (%s) — "
            "recomputing instead of serving suspect bits", key, reason)
        size = 0
        try:
            size = os.path.getsize(path)
        except OSError:
            pass
        try:
            os.remove(path)
        except OSError:
            pass
        with self._lock:
            self.bytes_total = max(0, self.bytes_total - size)
        return 1

    def _evict_locked(self, exclude=None):
        """LRU-by-bytes: while over the cap, remove the least-recently
        read entries (never the one just written).  Rescans the dir so
        the ledger self-corrects against concurrent writers sharing the
        cache dir.  Returns the number of entries evicted."""
        if self.cap_bytes <= 0 or self.bytes_total <= self.cap_bytes:
            return 0
        entries = sorted(self._entries())
        total = sum(size for _m, size, _p in entries)
        evicted = 0
        for _mtime, size, path in entries:
            if total <= self.cap_bytes:
                break
            if path == exclude:
                continue
            try:
                os.remove(path)
            except OSError:
                continue                   # a peer evicted it first
            total -= size
            evicted += 1
        if evicted:
            logger.info(
                "result cache: evicted %d LRU entr%s (%d bytes / cap "
                "%d)", evicted, "y" if evicted == 1 else "ies", total,
                self.cap_bytes)
        self.bytes_total = total
        return evicted
