"""Warm-up and prep-cache layer of the serving engine (the port's
``raft_tpu/serve/cache.py``).

The port compiles nothing per request: its first-touch costs are the
``nvcc`` build of a kernel library (once per content of the sources, on
disk under ``build/raft_tpu_torch/``), loading it, the CUDA context and
the caching allocator's growth, and building the slot and phase programs
of a physics configuration.  Three mechanisms move those costs ahead of
the first request:

 1. **A warm-up manifest**: a JSON record, checksummed and written
    atomically, of every bucket the deployment has served — the
    canonical shape plus the physics scalars and frequency grid — with
    the flag surface it was recorded under.  :func:`warmup` replays it:
    each bucket runs once on padding lanes (buckets.compile_bucket), so
    the kernel libraries are loaded, the programs built and the
    allocator grown.  An entry recorded under other flags (card, dtype,
    fixed-point mode, kernel library digests, code version, ...) is
    REFUSED with a logged reason; a corrupt manifest is refused and
    deleted.
 2. **A host-prep cache**: each design's host preparation (nodes and
    the 7 case-input arrays, everything ``Model.prepare_case_inputs``
    produces) as one ``.npz`` per design key, checksummed, written
    atomically, refused and deleted when corrupt, refused when recorded
    under other flags.  The stored arrays are the exact bits, so a
    restarted server answers with the same bits.
 3. :class:`CompileWatcher` counts the first-touch costs around a
    region: ``nvcc`` builds started, kernel libraries loaded, slot and
    phase programs built.

The cache directory is explicit (``cache_dir``); its default is the
port's own ``build/raft_tpu_torch/serve/``.
"""

import dataclasses
import functools
import hashlib
import json
import os
import threading
import time
from zipfile import BadZipFile

import numpy as np
import torch

from raft_tpu_torch.geometry import HydroNodes
from raft_tpu_torch.kernels import _build
from raft_tpu_torch.serve import buckets as _buckets
from raft_tpu_torch.serve.buckets import (
    BucketSpec,
    SlotPhysics,
    compile_bucket,
)
from raft_tpu_torch.utils.profiling import logger

MANIFEST_NAME = "serve_manifest.json"
MANIFEST_SCHEMA = 1
PREP_SCHEMA = 1

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_ROOT = os.path.join(os.path.dirname(_PKG), "build",
                                  "raft_tpu_torch")
_NODE_FIELDS = tuple(f.name for f in dataclasses.fields(HydroNodes))


# ------------------------------------------------------------ counters

def compile_counters():
    """The process's first-touch counters: ``nvcc_builds``,
    ``libraries_loaded`` (kernels/_build.py) and ``programs_built`` (the
    slot programs of serve/buckets.py and the phase programs of
    waterfall.py)."""
    from raft_tpu_torch import waterfall

    out = dict(_build.counters)
    out["programs_built"] = _buckets.programs_built \
        + waterfall.programs_built
    return out


class CompileWatcher:
    """Snapshot the first-touch counters around a region::

        with CompileWatcher() as w:
            compile_bucket(...)
        w.delta   # {"nvcc_builds", "libraries_loaded", "programs_built"}
        w.wall_s
    """

    def __enter__(self):
        self._t0 = time.perf_counter()
        self._before = compile_counters()
        return self

    def __exit__(self, *exc):
        after = compile_counters()
        self.delta = {k: after[k] - self._before[k] for k in after}
        self.wall_s = time.perf_counter() - self._t0
        return False


# ---------------------------------------------------------- cache dirs

def serve_cache_dir(cache_dir=None):
    """``<cache_dir>/serve`` (default ``build/raft_tpu_torch/serve`` of
    the checkout), created if absent."""
    path = os.path.join(cache_dir or DEFAULT_CACHE_ROOT, "serve")
    os.makedirs(path, exist_ok=True)
    return path


# ---------------------------------------------------------- flags / keys

@functools.lru_cache(maxsize=1)
def code_version():
    """Hash of the port's sources (every ``.py`` of the package and the
    CUDA sources of ``csrc/``): part of every manifest, prep and result
    key, so an upgrade refuses stale caches instead of serving them."""
    h = hashlib.sha256()
    for dirpath, dirnames, files in sorted(os.walk(_PKG)):
        dirnames.sort()
        for name in sorted(files):
            if name.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(dirpath, name)
                h.update(os.path.relpath(path, _PKG).encode())
                with open(path, "rb") as fh:
                    h.update(fh.read())
    return h.hexdigest()[:12]


def backend_name(device):
    """``cpu``, or the card's name and compute capability."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    major, minor = torch.cuda.get_device_capability(idx)
    return f"{torch.cuda.get_device_name(idx)} sm_{major}{minor}"


def topology_flags(devices=None, lane_block=None):
    """The lane-topology keys: ``devices=None`` is one dispatch per
    bucket; ``1`` the fixed-block super-blocks on one card."""
    if not devices:
        return {"n_devices": 1, "mesh": None, "lane_block": None}
    return {"n_devices": int(devices), "mesh": "lane",
            "lane_block": int(lane_block) if lane_block
            else _buckets.DEFAULT_LANE_BLOCK}


def current_flags(device="cpu", precision=None, mixed_precision=False,
                  fixed_point="legacy", block=None, devices=None,
                  lane_block=None):
    """The flag surface of one engine configuration: what a manifest,
    prep or result entry must have been recorded under to be reused."""
    from raft_tpu_torch.grad.fixed_point import grad_axis
    from raft_tpu_torch.waterfall import DEFAULT_BLOCK_ITERS

    flags = {
        "backend": backend_name(device),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "code_version": code_version(),
        "dtype": precision or "float64",
        "mixed_precision": bool(mixed_precision),
        "fixed_point": fixed_point,
        "fixed_point_block": None if fixed_point == "legacy"
        else int(block or DEFAULT_BLOCK_ITERS),
        "grad": grad_axis(),
        "kernels": _build.library_digests(),
    }
    flags.update(topology_flags(devices, lane_block))
    return flags


#: flag keys every reuse decision compares
_FLAG_KEYS = ("backend", "torch", "cuda", "code_version", "dtype",
              "mixed_precision", "grad", "kernels")
#: the keys of the dispatch: compared for manifests and results, not for
#: host prep (prep bits depend on neither the lane topology nor the
#: fixed-point engine)
_DISPATCH_KEYS = ("fixed_point", "fixed_point_block", "n_devices", "mesh",
                  "lane_block")


def flags_mismatch(entry_flags, flags, topology=True):
    """A readable reason an entry's flags refuse reuse, or None.
    ``topology=False`` (host prep) skips the dispatch keys."""
    keys = _FLAG_KEYS + (_DISPATCH_KEYS if topology else ())
    for key in keys:
        if entry_flags.get(key) != flags.get(key):
            return (f"{key}={entry_flags.get(key)!r} recorded but "
                    f"{flags.get(key)!r} running")
    return None


def json_default(obj):
    """``json.dumps`` fallback of the cache keys: arrays as lists (a
    design rebuilt by ``RAFT_OMDAO`` holds them), other numbers as floats
    (the JAX package's rule, so the keys of a plain design are its
    strings)."""
    if isinstance(obj, np.ndarray) and obj.ndim:
        return obj.tolist()
    return float(obj)


def design_prep_key(design, cases, precision):
    """Prep-cache key: the full design, case table and working precision,
    and the code version."""
    payload = json.dumps([design, cases, precision], sort_keys=True,
                         default=json_default)
    h = hashlib.sha256(payload.encode())
    h.update(code_version().encode())
    return h.hexdigest()[:24]


def _doc_checksum(entries):
    return hashlib.sha256(
        json.dumps(entries, sort_keys=True).encode()).hexdigest()


def _payload_checksum(arrays):
    """sha256 over every array's name, dtype, shape and bytes, in name
    order."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _remove(path):
    try:
        os.remove(path)
    except OSError:
        pass


# ------------------------------------------------------------- manifest

class WarmupManifest:
    """The on-disk record of buckets to warm: one JSON document
    ``{"schema", "entries", "checksum"}``, rewritten atomically, whose
    entries are ``{"spec", "physics", "flags", "created"}``, one per
    (spec, physics, backend, dtype).  A corrupt or torn document is
    refused and deleted; a malformed entry is skipped; flags decide reuse
    at warm-up."""

    def __init__(self, path=None, cache_dir=None, chaos=None):
        self.path = path or os.path.join(serve_cache_dir(cache_dir),
                                         MANIFEST_NAME)
        self._lock = threading.Lock()
        self._chaos = chaos

    def load(self):
        if not os.path.exists(self.path):
            return []
        try:
            with open(self.path) as fh:
                doc = json.load(fh)
            if not isinstance(doc, dict):
                raise ValueError("not a JSON object")
            if doc.get("schema") != MANIFEST_SCHEMA:
                raise ValueError(f"schema {doc.get('schema')!r} != "
                                 f"{MANIFEST_SCHEMA}")
            entries = doc.get("entries")
            if not isinstance(entries, list):
                raise ValueError("'entries' is not a list")
            if _doc_checksum(entries) != doc.get("checksum"):
                raise ValueError("checksum mismatch")
        except (OSError, ValueError, UnicodeDecodeError) as e:
            logger.warning(
                "serve manifest %s refused and deleted (%s: %s); warming "
                "nothing from it", self.path, type(e).__name__, e)
            _remove(self.path)
            return []
        good = []
        for i, entry in enumerate(entries):
            if (isinstance(entry, dict)
                    and isinstance(entry.get("spec"), dict)
                    and isinstance(entry.get("physics"), dict)
                    and isinstance(entry.get("flags"), dict)):
                good.append(entry)
            else:
                logger.warning(
                    "serve manifest %s: entry %d refused (missing or "
                    "malformed spec/physics/flags); skipped", self.path, i)
        return good

    @staticmethod
    def _entry_key(entry):
        f = entry.get("flags", {})
        return json.dumps([entry.get("spec"), entry.get("physics"),
                           f.get("backend"), f.get("dtype")],
                          sort_keys=True)

    def _write(self, entries):
        doc = {"schema": MANIFEST_SCHEMA, "entries": entries,
               "checksum": _doc_checksum(entries)}
        tmp = f"{self.path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as fh:
            json.dump(doc, fh, indent=1)
        os.replace(tmp, self.path)
        if self._chaos is not None:
            self._chaos.corrupt_if("corrupt_manifest", self.path)

    def record(self, physics, spec, flags):
        """Add (or refresh) one bucket entry; True when the manifest
        gained an entry."""
        entry = {"spec": spec.as_dict(), "physics": physics.as_dict(),
                 "flags": flags, "created": time.time()}
        with self._lock:
            entries = self.load()
            key = self._entry_key(entry)
            fresh = [e for e in entries if self._entry_key(e) != key]
            changed = len(fresh) == len(entries)
            fresh.append(entry)
            self._write(fresh)
        return changed

    def merge(self, entries):
        """Merge raw entries (schema-checked, deduplicated); returns the
        number added."""
        incoming = [
            e for e in (entries or [])
            if (isinstance(e, dict) and isinstance(e.get("spec"), dict)
                and isinstance(e.get("physics"), dict)
                and isinstance(e.get("flags"), dict))]
        if not incoming:
            return 0
        with self._lock:
            have = self.load()
            keys = {self._entry_key(e) for e in have}
            added = 0
            for entry in incoming:
                key = self._entry_key(entry)
                if key not in keys:
                    keys.add(key)
                    have.append(entry)
                    added += 1
            if added:
                self._write(have)
        return added


def warmup(manifest=None, designs=None, cases=None, precision=None,
           cache_dir=None, device=None, fixed_point="legacy",
           block=None, mixed_precision=False, devices=None, lane_block=None):
    """Warm every admissible bucket of the manifest (plus the buckets of
    ``designs``, recorded into it) on ``device`` (``cuda`` by default).

    Each bucket runs once on padding lanes in the ``fixed_point`` mode,
    so the first real request pays neither a program build, a library
    load nor the CUDA context and allocator growth.  Entries recorded
    under other flags are refused with their reasons.  Returns a report: per-bucket wall seconds and
    first-touch counts (nvcc builds, libraries loaded, programs built),
    the refused entries, and the totals."""
    from raft_tpu_torch.io.schema import cases_as_dicts
    from raft_tpu_torch.model import Model
    from raft_tpu_torch.serve.buckets import choose_bucket
    from raft_tpu_torch.utils.placement import resolve_device

    dev = resolve_device(device)
    if manifest is None or isinstance(manifest, str):
        manifest = WarmupManifest(manifest, cache_dir=cache_dir)
    flags = current_flags(dev, precision, mixed_precision, fixed_point,
                          block, devices, lane_block)

    jobs = []
    for design in designs or []:
        model = Model(design, precision=precision, device=dev)
        n_cases = len(cases if cases is not None
                      else cases_as_dicts(model.design))
        spec = choose_bucket(model.nw, model.nodes.r.shape[0], n_cases)
        physics = SlotPhysics.from_model(model)
        manifest.record(physics, spec, flags)
        jobs.append((physics, spec))

    rejected = []
    for entry in manifest.load():
        reason = flags_mismatch(entry.get("flags", {}), flags)
        if reason:
            rejected.append({"spec": entry.get("spec"), "reason": reason})
            logger.warning(
                "serve warmup: manifest entry refused (%s); it warms when "
                "its bucket is next served", reason)
            continue
        try:
            physics = SlotPhysics.from_dict(entry["physics"])
            spec = BucketSpec(**entry["spec"])
        except (TypeError, KeyError, ValueError) as e:
            reason = f"unparseable entry ({type(e).__name__}: {e})"
            rejected.append({"spec": entry.get("spec"), "reason": reason})
            logger.warning("serve warmup: manifest entry refused (%s)",
                           reason)
            continue
        if (physics, spec) not in jobs:
            jobs.append((physics, spec))

    warmed = []
    t0 = time.perf_counter()
    with CompileWatcher() as total:
        for physics, spec in jobs:
            with CompileWatcher() as w:
                compile_bucket(physics, spec, dev, mode=fixed_point,
                               block=block, mixed_precision=mixed_precision,
                               devices=devices, lane_block=lane_block)
            warmed.append({"spec": spec.as_dict(),
                           "wall_s": round(w.wall_s, 6), **w.delta})
    return {
        "flags": flags,
        "manifest": manifest.path,
        "warmed": warmed,
        "rejected": rejected,
        "n_warmed": len(warmed),
        "n_rejected": len(rejected),
        "wall_s": round(time.perf_counter() - t0, 6),
        **total.delta,
    }


# ------------------------------------------------------------ prep cache

class PrepCache:
    """Each design's host preparation (node bundle, the 7 case-input
    arrays, the physics scalars) as ``prep_<key>.npz``: written
    atomically, checksummed, refused and deleted when unreadable or
    failing its checksum, refused when written under other flags (the
    lane topology aside).  ``chaos``'s ``corrupt_cache`` fault overwrites
    a just-written entry."""

    def __init__(self, cache_dir=None, flags=None, chaos=None):
        self.dir = os.path.join(serve_cache_dir(cache_dir), "prep")
        os.makedirs(self.dir, exist_ok=True)
        self.flags = flags if flags is not None else current_flags()
        self._chaos = chaos

    def _path(self, key):
        return os.path.join(self.dir, f"prep_{key}.npz")

    def save(self, key, nodes, args, physics):
        arrays = {f"node_{name}": getattr(nodes, name).numpy()
                  for name in _NODE_FIELDS}
        for i, a in enumerate(args):
            arrays[f"arg_{i}"] = np.asarray(a)
        meta = {"schema": PREP_SCHEMA, "physics": physics.as_dict(),
                "flags": self.flags, "created": time.time(),
                "checksum": _payload_checksum(arrays)}
        payload = dict(arrays, meta=np.array(json.dumps(meta)))
        path = self._path(key)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        np.savez(tmp, **payload)
        os.replace(tmp + ".npz", path)     # np.savez appends .npz
        if self._chaos is not None:
            self._chaos.corrupt_if("corrupt_cache", path)

    def load(self, key):
        """-> (nodes, args, physics) or None (absent, corrupt or
        stale)."""
        path = self._path(key)
        if not os.path.exists(path):
            return None
        try:
            with np.load(path, allow_pickle=False) as z:
                meta = json.loads(str(z["meta"]))
                if meta.get("schema") != PREP_SCHEMA:
                    raise ValueError(f"schema {meta.get('schema')!r}")
                arrays = {name: z[name] for name in z.files
                          if name != "meta"}
            if _payload_checksum(arrays) != meta.get("checksum"):
                raise ValueError("payload checksum mismatch")
            reason = flags_mismatch(meta.get("flags", {}), self.flags,
                                    topology=False)
            if reason:
                logger.warning("serve prep cache: entry %s refused (%s)",
                               key, reason)
                return None
            nodes = HydroNodes(**{
                name: torch.as_tensor(arrays[f"node_{name}"])
                for name in _NODE_FIELDS})
            args = tuple(arrays[f"arg_{i}"] for i in range(7))
            physics = SlotPhysics.from_dict(meta["physics"])
            return nodes, args, physics
        except (OSError, ValueError, KeyError, TypeError,
                BadZipFile) as e:
            logger.warning(
                "serve prep cache: entry %s refused and deleted (%s: %s)",
                key, type(e).__name__, e)
            _remove(path)
            return None
