"""Port parity of pgr-server (pgrtk_tpu_torch/server/): the websocket
ROI autocomplete (the JAX package's test_websocket_* tests on the
port's handler); the 6-haplotype decomposition through both packages'
handlers (pgrtk_tpu/server and the port's, device="cpu"): the same JSON,
the same HTML and the same 400 replies on bad specs, the port's version
header; and concurrent requests and /ws sessions against one shared
facade over an FRG index written by the port's pgr-make-frgdb, each
reply byte-equal to its serial answer."""

import base64
import hashlib
import http.server
import json
import os
import socket
import struct
import threading
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

import pgrtk_tpu
from pgrtk_tpu.server import main as jsm
from pgrtk_tpu_torch.api import SeqIndexDB
from pgrtk_tpu_torch.cli import pgr_make_frgdb
from pgrtk_tpu_torch.server import main as tsm
from pgrtk_tpu_torch.server import ws
from pgrtk_tpu_torch.server.bundle_processing import SequenceQuerySpec

# one torch thread: the suite runs several workers on a few cores
torch.set_num_threads(1)

ROIS = {
    "AMY1A": {"source": "s", "ctg": "c1", "bgn": 1, "end": 2},
    "AMY2B": {"source": "s", "ctg": "c2", "bgn": 3, "end": 4},
    "TBC1D3": {"source": "s", "ctg": "c3", "bgn": 5, "end": 6},
}


@pytest.fixture
def serve():
    """serve(handler_class) -> its port, on 127.0.0.1 in a thread; every
    server is shut down and the class's ROIs reset after the test."""
    servers = []

    def start(handler):
        srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append((srv, handler))
        return srv.server_address[1]

    yield start
    for srv, handler in servers:
        srv.shutdown()
        srv.server_close()
        handler.rois = []


def _ws_connect(port, key=b"0123456789abcdef"):
    sock = socket.create_connection(("127.0.0.1", port), timeout=30)
    k = base64.b64encode(key).decode()
    sock.sendall((
        "GET /ws HTTP/1.1\r\n"
        f"Host: 127.0.0.1:{port}\r\n"
        "Upgrade: websocket\r\nConnection: Upgrade\r\n"
        f"Sec-WebSocket-Key: {k}\r\n"
        "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    f = sock.makefile("rb")
    status = f.readline()
    headers = []
    while True:
        line = f.readline().strip()
        if not line:
            break
        headers.append(line)
    return sock, f, status, headers, k


def _masked(txt, fin=True, opcode=1, mask=b"\x11\x22\x33\x44"):
    payload = txt.encode()
    body = bytes(c ^ mask[i & 3] for i, c in enumerate(payload))
    assert len(payload) < 126
    return bytes([(0x80 if fin else 0) | opcode,
                  0x80 | len(payload)]) + mask + body


def _recv_text(f):
    b0, b1 = f.read(2)
    assert b0 & 0x0F == 1
    ln = b1 & 0x7F
    if ln == 126:
        ln = struct.unpack(">H", f.read(2))[0]
    return f.read(ln).decode()


def test_websocket_roi_autocomplete(serve):
    """/ws mirrors the reference protocol (pgr-server/src/main.rs:
    209-255): text prefix in, JSON map of matching ROI presets out."""
    tsm.Handler.rois = ROIS
    port = serve(tsm.Handler)
    sock, f, status, headers, key = _ws_connect(port)
    assert b"101" in status
    accept = [h.split(b":", 1)[1].strip().decode() for h in headers
              if h.lower().startswith(b"sec-websocket-accept:")]
    assert accept == [base64.b64encode(
        hashlib.sha1((key + ws.GUID).encode()).digest()).decode()]
    sock.sendall(_masked("AMY"))
    res = json.loads(_recv_text(f))
    assert sorted(res) == ["AMY1A", "AMY2B"] and res["AMY1A"]["ctg"] == "c1"
    sock.sendall(_masked("TBC"))
    assert list(json.loads(_recv_text(f))) == ["TBC1D3"]
    for empty in ("", "ZZZ"):
        sock.sendall(_masked(empty))
        assert json.loads(_recv_text(f)) == {}
    sock.sendall(bytes([0x88, 0x80]) + b"\x00\x00\x00\x00")  # clean close
    sock.close()


def test_websocket_fragmentation_and_length_cap(serve):
    """FIN=0 text + continuation frames reassemble into one prefix
    query; a frame claiming an abusive length drops the connection
    instead of buffering it."""
    tsm.Handler.rois = {"AMY1A": {"ctg": "c1"}, "AMY2B": {"ctg": "c2"}}
    port = serve(tsm.Handler)
    sock, f, *_ = _ws_connect(port)
    sock.sendall(_masked("AM", fin=False, opcode=1, mask=b"\x01\x02\x03\x04"))
    sock.sendall(_masked("Y1", fin=True, opcode=0, mask=b"\x01\x02\x03\x04"))
    assert list(json.loads(_recv_text(f))) == ["AMY1A"]
    sock.close()
    sock, f, *_ = _ws_connect(port)
    sock.sendall(bytes([0x81, 0x80 | 127]) + struct.pack(">Q", 1 << 40)
                 + b"\x00\x00\x00\x00")
    assert f.read(2) == b""  # connection closed
    sock.close()


def _post(port, spec):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/post_query_for_json_data",
        data=json.dumps(spec).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.headers, r.read()


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post_status(port, spec):
    try:
        return _post(port, spec)[0], None
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _pangenome(path):
    """The JAX server test's 6-haplotype pangenome (tests/
    test_facade_server.py:305): 100 kb at 2e-4 substitutions, a 5 kb
    deletion in hap_3."""
    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", np.uint8)
    L = 100_000
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    with open(path, "w") as f:
        for h in range(6):
            s = base.copy()
            pos = rng.choice(L, size=int(L * 2e-4), replace=False)
            s[pos] = (s[pos] + rng.integers(1, 4, size=len(pos))) % 4
            if h == 3:
                s = np.concatenate([s[:40_000], s[45_000:]])
            f.write(f">hap_{h}\n{bases[s].tobytes().decode()}\n")


def test_server_decomposition_matches_jax(serve, tmp_path):
    fa = str(tmp_path / "pan.fa")
    _pangenome(fa)
    jd = pgrtk_tpu.SeqIndexDB()
    jd.load_from_fastx(fa)
    jsm.Handler.seq_db = jd
    td = SeqIndexDB(device="cpu")
    td.load_from_fastx(fa)
    tsm.Handler.seq_db, tsm.Handler.device = td, "cpu"
    jport, tport = serve(jsm.Handler), serve(tsm.Handler)

    spec = dict(source=fa, ctg="hap_0", bgn=20_000, end=80_000, padding=0,
                merge_range_tol=100_000, w=48, k=56, r=4, min_span=12,
                sketch=True, min_cov=2, min_branch_size=8,
                bundle_length_cutoff=500, bundle_merge_distance=10_000)
    specs = [spec, dict(spec, ctg="hap_3", bgn=30_000, end=60_000,
                        padding=5_000, merge_range_tol=1_000),
             dict(source=fa, ctg="hap_5", bgn=0, end=400, padding=100,
                  merge_range_tol=100)]  # too short to reach the bundles
    for s in specs:
        js, _jh, jbody = _post(jport, s)
        ts, th, tbody = _post(tport, s)
        assert js == ts == 200
        assert tbody == jbody
        assert th["X-Pgrtk-Version"].startswith("pgrtk_tpu_torch ")
        q = urllib.parse.quote(json.dumps(s))
        jhtml = _get(jport, f"/api/get_html_by_query?{q}")
        assert _get(tport, f"/api/get_html_by_query?{q}") == jhtml
        assert jhtml[0] == 200
    out = json.loads(tbody)
    assert out["bundle_bed_records"] == []
    first = json.loads(_post(tport, spec)[2])
    assert len({sid for sid, v in first["match_summary"] if v}) == 6
    assert len(first["bundle_bed_records"]) == 6
    assert _get(tport, "/api/get_number_of_ctgs") == (200, b"6")
    assert _get(tport, "/api/version")[1] == json.dumps(
        tsm.pgr_lib_version()).encode()

    bad = [{k: v for k, v in spec.items() if k != "padding"},
           dict(spec, ctg="no_such_ctg"), dict(spec, w=2**40)]
    for b in bad:
        want = _post_status(jport, b)
        assert want[0] == 400
        assert _post_status(tport, b) == want
        q = urllib.parse.quote(json.dumps(b))
        assert (_get(tport, f"/api/get_html_by_query?{q}")
                == _get(jport, f"/api/get_html_by_query?{q}"))
    assert _get(tport, "/api/nothing_here") == _get(jport,
                                                    "/api/nothing_here")


@pytest.fixture(scope="module")
def frg_index(tmp_path_factory):
    """An FRG index of the 6-haplotype pangenome and a 3-haplotype set of
    another seed, written by the port's pgr-make-frgdb."""
    d = tmp_path_factory.mktemp("frgsrv")
    fa = str(d / "pan.fa")
    _pangenome(fa)
    lst = d / "paths.txt"
    lst.write_text(fa + "\n")
    prefix = str(d / "db")
    assert pgr_make_frgdb.main([str(lst), prefix], device="cpu") == 0
    return prefix, fa


def test_server_concurrent_queries_and_ws(serve, frg_index):
    """One facade shared by the handler threads: 6 concurrent POSTs of
    three regions and 3 parallel /ws sessions, each reply byte-equal to
    its serial answer."""
    prefix, fa = frg_index
    d = SeqIndexDB(device="cpu")
    d.load_from_frg_index(prefix)
    tsm.Handler.seq_db, tsm.Handler.device = d, "cpu"
    tsm.Handler.rois = ROIS
    port = serve(tsm.Handler)
    specs = [SequenceQuerySpec(source=src, ctg=name, bgn=b, end=b + 60_000,
                               padding=2_000, merge_range_tol=10_000).__dict__
             for (name, src, _l), b in zip(
                 (d.seq_info[s] for s in (0, 2, 5)), (5_000, 20_000, 38_000))]
    goldens = [_post(port, s)[2] for s in specs]
    assert len(set(goldens)) == 3
    assert all(json.loads(g)["bundle_bed_records"] for g in goldens)

    def ws_roundtrips():
        sock, f, status, *_ = _ws_connect(port, os.urandom(16))
        assert b"101" in status
        out = []
        for prefix_, expect in (("AMY", ["AMY1A", "AMY2B"]),
                                ("TBC", ["TBC1D3"]),
                                ("AMY1", ["AMY1A"])) * 3:
            sock.sendall(_masked(prefix_, mask=b"\x51\x62\x73\x84"))
            out.append((sorted(json.loads(_recv_text(f))), expect))
        sock.close()
        return out

    results, ws_results, errors = {}, {}, []

    def worker(i):
        try:
            results[i] = _post(port, specs[i % 3])[2]
        except Exception as e:  # pragma: no cover
            errors.append((i, repr(e)))

    def ws_worker(i):
        try:
            ws_results[i] = ws_roundtrips()
        except Exception as e:  # pragma: no cover
            errors.append(("ws", i, repr(e)))

    threads = ([threading.Thread(target=worker, args=(i,))
                for i in range(6)]
               + [threading.Thread(target=ws_worker, args=(i,))
                  for i in range(3)])
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    assert len(results) == 6 and len(ws_results) == 3
    for i, body in results.items():
        assert body == goldens[i % 3], f"response {i} diverged"
    for rts in ws_results.values():
        for got, expect in rts:
            assert got == expect


def test_query_at_span_zero_matches_jax(tmp_path):
    """The server queries with max_aln_span 0, which the JAX facade's
    scalar DP scans as 1 (it stops after its first counted predecessor):
    the port's facade gives the JAX facade's chains at 0 and 1."""
    fa = str(tmp_path / "pan.fa")
    _pangenome(fa)
    jd = pgrtk_tpu.SeqIndexDB()
    jd.load_from_fastx(fa)
    td = SeqIndexDB(device="cpu")
    td.load_from_fastx(fa)
    sub = td.get_sub_seq(fa, "hap_2", 10_000, 70_000)
    for span in (0, 1, 2):
        args = (sub, 0.25, 128, 128, 128, span, None, False)
        want = jd.query_fragment_to_hps(*args)
        assert td.query_fragment_to_hps(*args) == want
        assert len(want) == 6


def test_make_server_loads_the_index_on_the_handler(frg_index):
    """pgr-server's options: --frg-file, port 0 and --device reach the
    handler class; the probe table of the shared store is built once."""
    prefix, _fa = frg_index
    srv = tsm.make_server([prefix, "--frg-file", "--port", "0", "--device",
                           "cpu"])
    try:
        assert tsm.Handler.device == "cpu"
        assert tsm.Handler.seq_db.device == "cpu"
        assert len(tsm.Handler.seq_db.seq_info) == 6
        assert srv.server_address[1] != 0
    finally:
        srv.server_close()
