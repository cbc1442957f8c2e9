"""The port's HTTP transport (raft_tpu_torch/serve/transport.py) on the
CPU.  One module-scoped ``python -m raft_tpu_torch serve --http 0
--device cpu`` process (``OMP_NUM_THREADS=2``) and one in-process
engine:

* a solve, a streamed sweep and a grad over HTTP equal the in-process
  engine's answers bit for bit (``np.array_equal``), checksums verified;
* raft_tpu's own ``WireClient`` gets the same answers from the port's
  server (the protocol is the same), while the two packages' attach
  handshakes refuse each other (their flag surfaces differ);
* the GET endpoints, the buffered route's status codes, 400/404, the
  profiler hook, and the shared-nothing entry transfer
  (``/v1/cache/preload``: a checksummed entry loads, a torn one is
  refused);
* the faults: ``conn_drop`` (server), ``wire_corrupt`` and
  ``net_partition`` (client);
* SIGTERM drain: every accepted rid gets a terminal line and the
  process exits 0.
"""

import base64
import hashlib
import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

from raft_tpu_torch.designs import deep_spar
from raft_tpu_torch.serve import (ConnectionDropped, Engine, EngineConfig,
                                  WireChecksumError, WireClient, serve_http,
                                  wire)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBJECTIVE = {"metric": "rao_pitch_peak"}


def _design(i=None):
    d = wire.jsonable(deep_spar(n_cases=2, nw_settings=(0.05, 0.5)))
    if i is not None:
        fill = d["platform"]["members"][0].get("rho_fill")
        d["platform"]["members"][0]["rho_fill"] = [
            float(f) + 5.0 * (i + 1) for f in fill]
    return d


def _start_server(extra=(), cwd=None):
    proc = subprocess.Popen(
        [sys.executable, "-m", "raft_tpu_torch", "serve", "--http", "0",
         "--device", "cpu", "--no-warmup", "--window-ms", "1", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=cwd or REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
    ready = json.loads(proc.stdout.readline())
    assert ready["event"] == "ready" and ready["port"] > 0, ready
    return proc, ready


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The subprocess server and the in-process reference engine."""
    cache = str(tmp_path_factory.mktemp("srv"))
    proc, ready = _start_server(["--cache-dir", cache])
    eng = Engine(EngineConfig(device="cpu", window_ms=1.0))
    try:
        yield proc, ready, WireClient("127.0.0.1", ready["port"]), eng
    finally:
        eng.shutdown()
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)


def test_solve_sweep_grad_over_http_equal_the_engine(served):
    _proc, ready, client, eng = served
    assert ready["backend"] == "cpu" and ready["replicas"] == 0
    d = _design()
    doc = client.solve({"design": d, "xi": True})
    assert doc["status"] == "ok" and doc["backend"] == "cpu"
    assert wire.checksum_mismatch(doc) is None and doc["checksum"]
    res = wire.result_from_doc(doc)
    ref = eng.evaluate(d, timeout=120)
    assert np.array_equal(res.Xi, ref.Xi) and np.array_equal(res.std,
                                                              ref.std)
    for key, val in ref.solve_report.items():
        assert np.array_equal(res.solve_report[key], val), key
    designs = [_design(i) for i in range(3)]
    term, chunks = client.sweep({"designs": designs, "chunk": 2})
    assert term["status"] == "ok" and len(chunks) == 2
    got = wire.sweep_result_from_doc(term, chunks=chunks)
    want = eng.submit_sweep(designs, chunk=2).result(120)
    assert np.array_equal(got.Xi_r, want.Xi_r)
    assert np.array_equal(got.Xi_i, want.Xi_i)
    for key, val in want.report.items():
        assert np.array_equal(got.report[key], val), key
    gdoc = client.grad({"design": d, "objective": OBJECTIVE})
    assert gdoc["status"] == "ok" and wire.checksum_mismatch(gdoc) is None
    gres = wire.grad_result_from_doc(gdoc)
    gref = eng.evaluate_grad(d, OBJECTIVE, timeout=120)
    assert gres.value == gref.value and gres.gradient == gref.gradient


def test_raft_tpu_wire_client_reads_the_port_server(served):
    """raft_tpu's client and decoders on the port's server: the same
    protocol, so the same bits."""
    from raft_tpu.serve import wire as jw
    from raft_tpu.serve.transport import WireClient as JClient

    _proc, ready, client, _eng = served
    jc = JClient("127.0.0.1", ready["port"])
    d = _design()
    ours = wire.result_from_doc(client.solve({"design": d, "xi": True}))
    theirs = jw.result_from_doc(jc.solve({"design": d, "xi": True}))
    assert np.array_equal(theirs.Xi, ours.Xi)
    assert np.array_equal(theirs.std, ours.std)
    term, chunks = jc.sweep({"designs": [_design(0), _design(1)]})
    assert term["status"] == "ok"
    assert np.array_equal(
        jw.sweep_result_from_doc(term, chunks=chunks).Xi_r[1],
        chunks[-1]["Xi_r"][-1])
    assert jc.grad({"design": d, "objective": OBJECTIVE})["status"] == "ok"
    code, health = jc.get("/healthz")
    assert code == 200 and health["status"] == "alive"


def test_handshakes_refuse_the_other_package(served):
    """A raft_tpu router refuses the port's replica and the port's
    router refuses a raft_tpu replica: their flag surfaces differ, so a
    mixed fleet is never formed."""
    from raft_tpu.serve.router import HandshakeRefused as JRefused
    from raft_tpu.serve.router import Router as JRouter
    from raft_tpu.serve.transport import serve_http as jserve
    from raft_tpu_torch.serve import HandshakeRefused, Router

    _proc, ready, _client, _eng = served
    jrouter = JRouter(endpoints=[])
    with pytest.raises(JRefused, match="env flag surface"):
        jrouter.attach_remote("127.0.0.1", ready["port"])
    jrouter.shutdown()

    class _Idle:
        def probe(self):
            return {"accepting": True}

    jsrv = jserve(_Idle())
    try:
        with Router(endpoints=[], device="cpu") as router:
            with pytest.raises(HandshakeRefused, match="flag surface"):
                router.attach_remote(jsrv.host, jsrv.port)
            assert router.stats["handshake_refusals"] == 1
    finally:
        jsrv.close()


def test_endpoints_codes_and_preload(served, tmp_path):
    _proc, ready, client, _eng = served
    code, ver = client.get("/versionz")
    assert code == 200 and ver["wire_version"] == wire.WIRE_VERSION
    assert ver["flags"]["backend"] == "cpu" and "kernels" in ver["flags"]
    assert "code_version" in ver["flag_surface"]
    code, probe = client.get("/readyz")
    assert code == 200 and probe["ready"] is True
    code, stats = client.get("/statz")
    assert code == 200 and stats["requests"] >= 1 and "metrics" in stats
    code, text = client.get_text("/metricz")
    assert code == 200 and "raft_tpu_torch_engine_requests_total" in text
    code, tz = client.get("/tracez?limit=5")
    assert code == 200 and len(tz["spans"]) <= 5
    assert client.get("/nope")[0] == 404
    assert client.get("/tracez?limit=x")[0] == 400
    out = client.post_json("/profilez", {"log_dir": str(tmp_path / "p")})
    assert out["armed"] is True
    assert client.post_json("/profilez", {"log_dir": "x"})["armed"] is False
    bad = client.solve({"design": 3})
    assert bad["status"] == "failed" and bad["http_status"] == 400
    late = WireClient("127.0.0.1", ready["port"])
    conn = late._conn(30)
    conn.request("POST", "/v1/solve?stream=0", body=wire.dumps(
        {"design": _design(50), "deadline_s": 0}).encode())
    resp = conn.getresponse()
    assert resp.status == 504
    assert json.loads(resp.read())["status"] == "rejected_deadline"
    conn.close()
    # the shared-nothing transfer: an entry of another cache dir loads,
    # a torn copy of it is refused
    from raft_tpu_torch.serve.result_cache import result_key

    d = _design(9)
    with Engine(EngineConfig(device="cpu", window_ms=1.0,
                             cache_dir=str(tmp_path / "a"))) as src:
        ref = src.evaluate(d, timeout=120)
        src.shutdown()
        key = result_key(d, None, None, flags=src.flags)
        data = src._result_cache.read_entry_bytes(key)
    assert data is not None
    doc = {"kind": "entry", "key": key, "cache_kind": "result",
           "sha256": hashlib.sha256(data).hexdigest(),
           "data_b64": base64.b64encode(data[:-7]).decode()}
    assert client.post_json("/v1/cache/preload", doc)["refused"] == 1
    doc["data_b64"] = base64.b64encode(data).decode()
    assert client.post_json("/v1/cache/preload", doc)["loaded"] == 1
    hit = wire.result_from_doc(client.solve({"design": d, "xi": True}))
    assert np.array_equal(hit.Xi, ref.Xi)
    code, stats = client.get("/statz")
    assert stats["wire_preload_loaded"] == 1
    assert stats["wire_preload_refused"] == 1
    assert stats["result_cache_hits"] >= 1
    assert client.post_json("/v1/cache/preload",
                            {"kind": "bogus"})["error"].startswith(
        "unknown preload kind")


def test_wire_faults(served):
    _proc, ready, client, eng = served
    d = _design()
    corrupt = WireClient("127.0.0.1", ready["port"],
                         chaos="wire_corrupt*1:3")
    with pytest.raises(WireChecksumError, match="checksum mismatch"):
        corrupt.solve({"design": d, "xi": True})
    assert corrupt.solve({"design": d, "xi": True})["status"] == "ok"
    part = WireClient("127.0.0.1", ready["port"],
                      chaos=f"net_partition@{ready['port']}:1")
    with pytest.raises(ConnectionDropped, match="net_partition"):
        part.solve({"design": d})
    assert part.get("/healthz")[0] == 200
    srv = serve_http(eng, chaos="conn_drop*1:5")
    try:
        c = WireClient(srv.host, srv.port)
        with pytest.raises(ConnectionDropped):
            c.solve({"design": d, "xi": True})
        doc = c.solve({"design": d, "xi": True})
        assert doc["status"] == "ok"
        assert srv.chaos.snapshot()["fires"] == {"conn_drop": 1}
    finally:
        srv.close()


def test_sigterm_drains_every_accepted_request(tmp_path):
    proc, ready = _start_server(cwd=str(tmp_path))
    client = WireClient("127.0.0.1", ready["port"], timeout=120)
    docs = {}

    def run(i):
        try:
            docs[i] = client.solve({"design": _design(20 + i), "xi": True})
        except ConnectionDropped as e:       # refused at the drain gate
            docs[i] = {"status": "refused", "error": str(e)}

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for _ in range(200):
        if client.get("/statz")[1]["requests"] >= 4:
            break
        threading.Event().wait(0.05)
    proc.send_signal(signal.SIGTERM)
    for t in threads:
        t.join(120)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-2000:]
    last = json.loads(out.strip().splitlines()[-1])
    assert last["event"] == "shutdown" and last["signal"] == signal.SIGTERM
    assert last["accepted"] == 4 and last["active_at_close"] == 0
    statuses = sorted(d["status"] for d in docs.values())
    assert len(statuses) == 4
    assert set(statuses) <= {"ok", "shutdown"}, statuses
    for d in docs.values():
        if d["status"] == "ok":
            assert wire.checksum_mismatch(d) is None
