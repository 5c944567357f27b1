"""uvltrack_tpu_torch's HTTP tracking service (cli/serve.py): the cases of
tests/test_serve.py on the port, over loopback HTTP with the real server,
handler and trackers, on the tiny fp32 model of
tests/test_torch_port_model.py (the JAX package's weights through
from_jax_variables). Not slow: on the CPU the port's step is eager.

Served boxes are held to a direct port Tracker or StreamPool on the same
JitTracker bit for bit, and to the JAX Tracker on the same frames and
weights at tests/test_torch_port_tracker.py's tolerance: boxes within 1e-3
px, scores within 1e-4. The per-stream and lockstep servers run twice: on
the eager step, and on the graph driver with the CPU's stand-in capture
(tests/test_torch_port_compiled.py), so the shared graphs are driven from
the handler threads. build_tracker loads a reference-style .pth.tar
('net' key) the test writes from from_jax_variables. The JAX file's
test_lockstep_mesh_matches_standalone has no counterpart: the port has no
device mesh yet.
"""

import base64
import io
import json
import pathlib
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from test_torch_port_compiled import _eager_capture
from uvltrack_tpu_torch import native
from uvltrack_tpu_torch.cli.serve import _StreamReaper, make_server
from uvltrack_tpu_torch.config import CfgNode
from uvltrack_tpu_torch.track.pool import StreamPool
from uvltrack_tpu_torch.track.tracker import Tracker

BOX_TOL = dict(atol=1e-3, rtol=0)
SCORE_TOL = dict(atol=1e-4, rtol=1e-4)
BOXES0 = {"a": [30, 20, 20, 24], "b": [10, 10, 30, 30]}


def _frame(rng, h=80, w=100):
    return rng.integers(0, 255, size=(h, w, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its variables, the port model on the same weights, the
    JAX config): BBOX mode, re-mines every 2 frames."""
    from test_torch_port_model import make_pair
    from test_tracker import tiny_cfg

    jm, v, tm = make_pair(seed=3)
    jcfg = tiny_cfg()
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    return jm, v, tm, jcfg


def _proto(pair, graphs: bool) -> Tracker:
    """The server's prototype Tracker; with graphs, its JitTracker (which
    every served stream and the pool share) captures with the stand-in."""
    proto = Tracker(CfgNode(pair[3].to_dict()), pair[2])
    proto.graphs = graphs
    if graphs:
        proto.jt._capture = types.MethodType(_eager_capture, proto.jt)
    return proto


def _start(proto, **kw):
    server = make_server(proto, port=0, **kw)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}", server


def _stop(server):
    if server.reaper is not None:
        server.reaper.stop()
    if server.dispatcher is not None:
        server.dispatcher.stop()
    server.shutdown()
    server.server_close()


@pytest.fixture(scope="module", params=["eager", "graphs"])
def served(request, pair):
    """A per-stream server; under "graphs" its trackers step through the
    graph driver (the stand-in capture)."""
    proto = _proto(pair, request.param == "graphs")
    url, server = _start(proto)
    yield url, server, proto
    _stop(server)


def _post(url, route, payload):
    req = urllib.request.Request(url + route, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _status_of(url, route, payload):
    try:
        return 200, _post(url, route, payload)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, route):
    return json.loads(urllib.request.urlopen(url + route, timeout=60).read())


def _npy_b64(img):
    buf = io.BytesIO()
    np.save(buf, img)
    return base64.b64encode(buf.getvalue()).decode()


def _jpeg_bytes(img):
    import cv2

    ok, enc = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    assert ok
    return enc.tobytes()


def _jax_boxes(pair, first, box, frames):
    from uvltrack_tpu.track.tracker import Tracker as JTracker

    jm, v, _, jcfg = pair
    jt = JTracker(jcfg, jm, v)
    jt.initialize(first, {"init_bbox": list(box)})
    return [jt.track(f) for f in frames]


# -------------------------------------------------------------- per-stream
def test_two_streams_share_one_jit_tracker(served, pair):
    """Two streams tracked from two client threads: independent state, one
    JitTracker behind both, /health and /stats, /close; each stream's
    served boxes equal a direct Tracker's on the same JitTracker exactly,
    and the JAX Tracker's within the tolerance."""
    url, server, proto = served
    rng = np.random.default_rng(0)
    first = _frame(rng)
    frames = {s: [_frame(rng) for _ in range(4)] for s in BOXES0}
    for s, box in BOXES0.items():
        out = _post(url, "/initialize", {"stream": s, "image": _npy_b64(first), "bbox": box,
                                         "format": "npy"})
        assert out["bbox"] == [float(v) for v in box]
    results, errs = {s: [] for s in BOXES0}, []

    def client(s):
        try:
            for f in frames[s]:
                results[s].append(_post(url, "/track", {"stream": s, "image": _npy_b64(f),
                                                        "format": "npy"}))
        except Exception as e:  # surface thread failures in the test
            errs.append((s, e))

    threads = [threading.Thread(target=client, args=(s,)) for s in BOXES0]
    [t.start() for t in threads]
    [t.join(timeout=600) for t in threads]
    assert not errs, errs
    assert {id(t.jt) for t in server.streams.values()} == {id(proto.jt)}
    assert results["a"][-1]["bbox"] != results["b"][-1]["bbox"]
    for s, box in BOXES0.items():
        direct = Tracker(proto.cfg, jit_tracker=proto.jt)
        direct.graphs = proto.graphs
        direct.initialize(first, {"init_bbox": box})
        ref = _jax_boxes(pair, first, box, frames[s])
        for got, f, r in zip(results[s], frames[s], ref):
            want = direct.track(f)
            assert got["bbox"] == want["target_bbox"] and got["score"] == want["score"]
            np.testing.assert_allclose(got["bbox"], r["target_bbox"], **BOX_TOL)
            np.testing.assert_allclose(got["score"], r["score"], **SCORE_TOL)
    health = _get(url, "/health")
    assert health == {"streams": 2, "mode": "per-stream", "platform": "cpu"}
    stats = _get(url, "/stats")["streams"]
    for s in BOXES0:
        assert stats[s]["frames"] == 4 and stats[s]["fps"] > 0
        assert np.isfinite(stats[s]["last_score"])
    assert _post(url, "/close", {"stream": "a"})["closed"] is True
    assert _post(url, "/close", {"stream": "b"})["closed"] is True
    assert _get(url, "/health")["streams"] == 0


def test_jpeg_roundtrip_through_native(served, monkeypatch):
    """A JPEG body is decoded by the port's libjpeg decoder (native/), with
    cv2 unimportable in the process: the served box equals a direct
    Tracker's on the natively decoded frames."""
    url, _, proto = served
    rng = np.random.default_rng(3)
    first, nxt = _frame(rng), _frame(rng)
    raw0, raw1 = _jpeg_bytes(first), _jpeg_bytes(nxt)
    dec0, dec1 = native.decode_jpeg_bytes(raw0), native.decode_jpeg_bytes(raw1)
    import cv2

    assert dec0.shape == first.shape and dec0.dtype == np.uint8
    # cv2's libjpeg decodes the same bytes to the same pixels
    np.testing.assert_array_equal(dec0, cv2.cvtColor(
        cv2.imdecode(np.frombuffer(raw0, np.uint8), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB))
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    _post(url, "/initialize", {"stream": "j", "image": base64.b64encode(raw0).decode(),
                               "bbox": [30, 20, 20, 24]})
    out = _post(url, "/track", {"stream": "j", "image": base64.b64encode(raw1).decode()})
    direct = Tracker(proto.cfg, jit_tracker=proto.jt)
    direct.graphs = proto.graphs
    direct.initialize(dec0, {"init_bbox": [30, 20, 20, 24]})
    assert out["bbox"] == direct.track(dec1)["target_bbox"]
    _post(url, "/close", {"stream": "j"})


def test_error_surfaces(served):
    url, _, _ = served
    img = np.zeros((40, 60, 3), np.uint8)
    cases = [
        ("/track", {"stream": "ghost", "image": _npy_b64(img), "format": "npy"}, 404),
        # missing bbox in BBOX mode -> 400 (KeyError init_bbox inside the tracker)
        ("/initialize", {"stream": "x", "image": _npy_b64(img), "format": "npy"}, 400),
        # undecodable JPEG bytes -> 400
        ("/initialize", {"stream": "x", "image": base64.b64encode(b"junk").decode(),
                         "bbox": [1, 1, 5, 5]}, 400),
        # not HxWx3 uint8 -> 400
        ("/initialize", {"stream": "x", "image": _npy_b64(np.zeros((4, 4), np.float32)),
                         "format": "npy", "bbox": [1, 1, 2, 2]}, 400),
        ("/nope", {}, 404),
        ("/close", {"stream": "ghost"}, 404),
    ]
    for route, payload, code in cases:
        got, body = _status_of(url, route, payload)
        assert got == code and "error" in body, (route, payload, got, body)
    req = urllib.request.Request(url + "/track", data=b"{not json",
                                 headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url + "/nowhere", timeout=60)
    assert e.value.code == 404


# --------------------------------------------------------------- lockstep
@pytest.fixture(scope="module", params=["eager", "graphs"])
def lockstep(request, pair):
    proto = _proto(pair, request.param == "graphs")
    url, server = _start(proto, lockstep=2, batch_window=10.0)
    yield url, server, proto
    _stop(server)


def test_lockstep_coalesces_and_matches_standalone(lockstep, pair):
    """Two streams post concurrently each round; the dispatcher coalesces a
    round into one pool.submit (the 10 s window would stall a lone request,
    so passing fast shows the all-pending barrier fired). The served boxes
    equal a standalone StreamPool's on the same JitTracker exactly and the
    JAX Tracker's within the tolerance; then close, a lone stream, a full
    pool (503) and a closed stream (404)."""
    url, server, proto = lockstep
    assert server.pool.bt.jt is proto.jt
    rng = np.random.default_rng(5)
    first = _frame(rng)
    frames = {s: [_frame(rng) for _ in range(3)] for s in BOXES0}
    for s in BOXES0:
        _post(url, "/initialize", {"stream": s, "image": _npy_b64(first), "bbox": BOXES0[s],
                                   "format": "npy"})
    assert _get(url, "/health") == {"streams": 2, "mode": "lockstep", "platform": "cpu"}
    results = {s: [] for s in BOXES0}
    t0 = time.monotonic()
    for i in range(3):
        errs = []

        def go(s, i=i):
            try:
                results[s].append(_post(url, "/track", {"stream": s,
                                                        "image": _npy_b64(frames[s][i]),
                                                        "format": "npy"}))
            except Exception as e:  # surface thread failures in the test
                errs.append((s, e))

        ts = [threading.Thread(target=go, args=(s,)) for s in BOXES0]
        [t.start() for t in ts]
        [t.join(timeout=600) for t in ts]
        assert not errs, errs
    assert time.monotonic() - t0 < 10.0  # no round waited out the window
    pool = StreamPool(proto.cfg, None, 2, jit_tracker=proto.jt, graphs=proto.graphs)
    for s in BOXES0:
        pool.open(s, first, {"init_bbox": BOXES0[s]})
    for i in range(3):
        want = pool.submit({s: frames[s][i] for s in BOXES0})
        for s in BOXES0:
            assert results[s][i]["bbox"] == want[s]["bbox"]
            assert results[s][i]["score"] == want[s]["score"]
    for s in BOXES0:
        ref = _jax_boxes(pair, first, BOXES0[s], frames[s])
        for got, r in zip(results[s], ref):
            np.testing.assert_allclose(got["bbox"], r["target_bbox"], **BOX_TOL)
            np.testing.assert_allclose(got["score"], r["score"], **SCORE_TOL)
    # close a: b alone dispatches at once (every open stream pending)
    _post(url, "/close", {"stream": "a"})
    t0 = time.monotonic()
    out = _post(url, "/track", {"stream": "b", "image": _npy_b64(frames["b"][0]),
                                "format": "npy"})
    assert np.isfinite(out["score"]) and time.monotonic() - t0 < 10.0
    _post(url, "/initialize", {"stream": "c", "image": _npy_b64(first),
                               "bbox": [5, 5, 10, 10], "format": "npy"})
    code, _ = _status_of(url, "/initialize", {"stream": "d", "image": _npy_b64(first),
                                              "bbox": [5, 5, 10, 10], "format": "npy"})
    assert code == 503  # capacity 2: b and c hold it
    code, _ = _status_of(url, "/track", {"stream": "a", "image": _npy_b64(first),
                                         "format": "npy"})
    assert code == 404
    for s in ("b", "c"):
        _post(url, "/close", {"stream": s})


# --------------------------------------------------- admission + eviction
@pytest.fixture(scope="module")
def limited(pair):
    url, server = _start(_proto(pair, False), max_streams=2, stream_ttl=1.5)
    yield url, server
    _stop(server)


def _init(url, s, img):
    return _status_of(url, "/initialize", {"stream": s, "image": _npy_b64(img),
                                           "format": "npy", "bbox": [10, 10, 20, 20]})


def test_max_streams_admission(limited):
    """--max_streams: the third new stream gets 429; re-initializing an
    open stream and an admission after a close both succeed."""
    url, _ = limited
    img = _frame(np.random.default_rng(31), 60, 80)
    assert _init(url, "m1", img)[0] == 200 and _init(url, "m2", img)[0] == 200
    code, body = _init(url, "m3", img)
    assert code == 429 and "max_streams" in body["error"]
    assert _init(url, "m1", img)[0] == 200
    _post(url, "/close", {"stream": "m2"})
    assert _init(url, "m3", img)[0] == 200
    for s in ("m1", "m3"):
        _post(url, "/close", {"stream": s})


def test_stream_ttl_evicts_idle(limited):
    """--stream_ttl: an idle stream is reaped (404 on its next /track); a
    stream that keeps sending survives."""
    url, _ = limited
    img = _frame(np.random.default_rng(32), 60, 80)
    track = {"image": _npy_b64(img), "format": "npy"}
    for s in ("t1", "t2"):
        assert _init(url, s, img)[0] == 200
    deadline = time.monotonic() + 3.2  # past the 1.5 s ttl
    while time.monotonic() < deadline:
        _post(url, "/track", dict(track, stream="t1"))
        time.sleep(0.3)
    assert _status_of(url, "/track", dict(track, stream="t1"))[0] == 200
    assert _status_of(url, "/track", dict(track, stream="t2"))[0] == 404
    _post(url, "/close", {"stream": "t1"})


def test_reaper_spares_in_flight_and_drops_counters():
    """_StreamReaper._evict_idle on a stub server: a stream waiting in the
    lockstep dispatcher is mid-request and stays; an idle one is closed in
    the pool and forgotten by /stats."""
    class _Pool:
        def __init__(self):
            self.closed = []

        def close(self, s):
            self.closed.append(s)

    srv = types.SimpleNamespace(
        # far older than the ttl (the monotonic clock may start near 0)
        lock=threading.Lock(), last_seen={"busy": -1e9, "idle": -1e9},
        counters={"busy": {"frames": 1}, "idle": {"frames": 1}},
        dispatcher=types.SimpleNamespace(pending={"busy": object()}),
        pool=_Pool(), streams={}, verbose=False)
    reaper = _StreamReaper(srv, ttl_s=3600.0)  # its thread idles; called directly
    try:
        evicted = reaper._evict_idle()
    finally:
        reaper.stop()
    assert evicted == ["idle"] and srv.pool.closed == ["idle"]
    assert "busy" in srv.last_seen and "busy" in srv.counters
    assert "idle" not in srv.counters and "idle" not in srv.last_seen


# ------------------------------------------------------------ build_tracker
def test_build_tracker_loads_a_reference_checkpoint(tmp_path, capsys, monkeypatch):
    """UVLTrack-B (the 32/64 px smoke config) from a .pth.tar whose 'net'
    entry the test writes from from_jax_variables over a seeded flax
    variable tree of the JAX model's shapes: every weight of the built
    tracker's model is the file's (stored bf16, the compute dtype); the
    missing vocab is warned about in NLBBOX mode; the tracker tracks."""
    import jax
    import jax.numpy as jnp

    from uvltrack_tpu.config import load_cfg as jload_cfg
    from uvltrack_tpu.models.uvltrack import build_model as jbuild
    from uvltrack_tpu_torch.cli.test import build_tracker
    from uvltrack_tpu_torch.config import load_cfg
    from uvltrack_tpu_torch.models.convert import from_jax_variables

    path = str(pathlib.Path(__file__).resolve().parent.parent
               / "experiments/uvltrack/_smoke_cpu.yaml")
    jcfg = jload_cfg(path)
    jm = jbuild(jcfg)
    tz, sx, nt = (jcfg.DATA.TEMPLATE.SIZE, jcfg.DATA.SEARCH.SIZE,
                  jcfg.MODEL.BACKBONE.LANGUAGE.BERT.MAX_QUERY_LEN)
    args = (jnp.zeros((1, tz, tz, 3)), jnp.zeros((1, sx, sx, 3)),
            jnp.zeros((1, nt), jnp.int32), jnp.ones((1, nt), jnp.int32),
            jnp.zeros((1, (tz // 16) ** 2), bool), jnp.zeros((1, (sx // 16) ** 2), bool),
            jnp.zeros((1,), jnp.int32))
    shapes = jax.eval_shape(lambda r: jm.init(r, *args, train=False), jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)

    def leaf(path, s):
        name = path[-1].key
        if name in ("var", "scale"):  # BN variances, LayerNorm scales
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.02 * rng.standard_normal(s.shape)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    state = from_jax_variables(tree["params"], tree["batch_stats"])
    del tree
    for k in list(state):
        state[k] = state[k].to(torch.bfloat16) if state[k].is_floating_point() else state[k]
    ckpt = tmp_path / "UVLTrack_ep0300.pth.tar"
    torch.save({"net": state, "epoch": 300}, ckpt)
    del state
    monkeypatch.setenv("UVLTRACK_PRETRAINED_PATH", str(tmp_path))  # no vocab there
    from uvltrack_tpu_torch.eval import environment

    environment.reset_env_cache()
    try:
        tracker = build_tracker(load_cfg(path), str(ckpt), device="cpu")
    finally:
        environment.reset_env_cache()
    assert "WARNING: vocab not found" in capsys.readouterr().out
    assert tracker.tokenizer is None and tracker.device.type == "cpu"
    saved = torch.load(ckpt, weights_only=False)["net"]
    own = tracker.model.state_dict()
    checked = 0
    for k, v in saved.items():
        if k in own and own[k].is_floating_point():
            assert torch.equal(own[k].float(), v.float()), k
            checked += 1
    assert checked > 300
    rng = np.random.default_rng(8)
    tracker.initialize(_frame(rng, 120, 160), {"init_bbox": [40, 30, 30, 20],
                                               "language": "a box"})
    out = tracker.track(_frame(rng, 120, 160))
    assert np.isfinite(out["target_bbox"]).all() and np.isfinite(out["score"])
