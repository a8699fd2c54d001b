"""The port's serving export and HTTP front end against the JAX package's
(tools/export_model.py, tools/serve.py), on the CPU at tiny size.

* the port's manifest against the JAX manifest: the same keys and values
  apart from `platforms` and `size_bytes` (and the port's own
  `cfg_options`), for the plain, `--streaming`, `--uint8-input`, a
  camera-aware and a PETRv2 (`mean_time_stamp` among the extras) `--tiny
  --cfg-options` export;
* the port's server answers against the JAX Engine on the JAX artifact of
  the same weights (the JAX export's init at PRNGKey(0), carried over by
  weights.state_dict_from_jax into a reference-layout .pth): labels equal,
  boxes and scores within 2e-4, the top scores more than 1e-3 apart so
  that the tolerance cannot reorder them;
* every error route's status code and error text against the JAX
  handler's, and the server keeps serving after a 500;
* /infer_stream bootstrap, LRU eviction and /reset_stream;
* 4 concurrent clients answer as serial ones, bit for bit;
* the bench client's JSON keys.
"""

import os
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools import serve as jax_serve  # noqa: E402

from graph_detr4d_tpu import config as jax_config  # noqa: E402
from graph_detr4d_tpu.data.synthetic import synthetic_batch  # noqa: E402
from graph_detr4d_tpu.models import GraphDETR4D as JaxGraphDETR4D  # noqa: E402
from graph_detr4d_tpu_torch.tools import export_model, serve  # noqa: E402
from graph_detr4d_tpu_torch.weights import state_dict_from_jax  # noqa: E402

ATOL, TOP_GAP = 2e-4, 1e-3
EXPORTS = {  # export flags of each manifest case
    "plain": ["--tiny"],
    "streaming": ["--tiny", "--streaming"],
    "uint8": ["--tiny", "--uint8-input"],
    "camaware": ["--tiny", "--cfg-options", "head.cam_aware=true",
                 "head.scale_pred=true"],
    "petrv2": ["--tiny", "--cfg-options", "head_type=petrv2"],
}


@pytest.fixture(scope="module", autouse=True)
def cpu_platform():
    os.environ["GRD4D_PLATFORM"] = "cpu"
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def jax_exports(root):
    """The JAX export CLI for every case, in parallel processes (lowering
    is most of this file's time); {name: artifact dir}."""
    env = dict(os.environ, GRD4D_PLATFORM="cpu", JAX_PLATFORMS="cpu")
    procs = {}
    for name, flags in EXPORTS.items():
        out = str(root / f"jax_{name}")
        procs[name] = (out, subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tools", "export_model.py"),
             *flags, "--no-verify", "--platforms", "cpu", "--out", out],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True))
    for name, (out, proc) in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, (name, err[-2000:])
    return {name: out for name, (out, _) in procs.items()}


def port_export_dir(out, flags, verify=False):
    export_model.main([*flags, "--device", "cpu", "--out", out]
                      + ([] if verify else ["--no-verify"]))
    return out


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """JAX and port artifacts of the four cases; the port's plain and
    streaming ones carry the JAX export's own weights (init at PRNGKey(0))
    and are verified on the CPU."""
    root = tmp_path_factory.mktemp("artifacts")
    cfg = jax_config.tiny_test_config()
    batch = synthetic_batch(cfg, batch_size=1)
    v = jax.jit(JaxGraphDETR4D(cfg).init)(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(batch["images"]),
        jnp.asarray(batch["lidar2img"]))
    pth = str(root / "jax_init.pth")
    torch.save({"state_dict": state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, v))}, pth)
    jdirs, out = jax_exports(root), {}
    for name, flags in EXPORTS.items():
        ckpt = ["--checkpoint", pth] if name not in ("camaware", "petrv2") else []
        pdir = port_export_dir(str(root / f"port_{name}"), flags + ckpt,
                               verify=name in ("plain", "streaming"))
        out[name] = (jdirs[name], pdir)
    return out


def _manifest(d):
    import json

    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", list(EXPORTS))
def test_manifest_matches_jax(artifacts, name):
    jdir, pdir = artifacts[name]
    want, got = _manifest(jdir), _manifest(pdir)
    assert set(got) == set(want) | {"cfg_options"}
    for k in set(want) - {"platforms", "size_bytes"}:
        assert got[k] == want[k], k
    assert got["platforms"] == (["cpu"] if name in ("plain", "streaming")
                                else [])
    assert got["size_bytes"] == os.path.getsize(os.path.join(pdir,
                                                             "weights.pth"))
    if name == "petrv2":  # PETRv2's velocity needs the frames' time delta
        assert got["extras"] == ["mean_time_stamp"]
    # the manifest rebuilds the model: the artifact runs
    r = export_model.main(["--run", pdir, "--device", "cpu"])
    assert r["detections_shape"][0] == 1


class _Server:
    """A handler's ThreadingHTTPServer on port 0, on a thread."""

    def __init__(self, handler):
        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        self.srv.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


@pytest.fixture(scope="module")
def servers(artifacts, tmp_path_factory):
    """The JAX and the port server of the plain artifact, and the port's
    streaming server (max_streams 2, started through its CLI with
    --ready-file)."""
    jdir, pdir = artifacts["plain"]
    jengine = jax_serve.Engine(jdir)
    jsrv = _Server(jax_serve.make_handler(jengine))
    ready = str(tmp_path_factory.mktemp("ready") / "port")
    psrv, pengine, _ = serve.serve_in_thread(
        ["--artifact", pdir, "--port", "0", "--device", "cpu",
         "--ready-file", ready])
    with open(ready) as f:
        assert int(f.read()) == psrv.server_address[1]
    ssrv, sengine, _ = serve.serve_in_thread(
        ["--artifact", artifacts["streaming"][1], "--port", "0",
         "--device", "cpu", "--max-streams", "2"])
    urls = {"jax": jsrv.url,
            "port": f"http://127.0.0.1:{psrv.server_address[1]}",
            "stream": f"http://127.0.0.1:{ssrv.server_address[1]}"}
    yield urls, jengine, pengine, sengine
    jsrv.close()
    for s in (psrv, ssrv):
        s.shutdown()


def request(seed, n_cams=None, **extra):
    cfg = jax_config.tiny_test_config()
    b = synthetic_batch(cfg, batch_size=1, seed=seed)
    images = b["images"] if n_cams is None else b["images"][:, :n_cams]
    return serve.npz_body(images=images, lidar2img=b["lidar2img"], **extra), b


def test_port_server_answers_as_the_jax_engine(servers):
    urls, jengine, pengine, _ = servers
    body, b = request(seed=3)
    status, got = serve.post(urls["port"] + "/infer", body)
    assert status == 200
    want = jengine.infer(b["images"], b["lidar2img"])
    keep = want["valid"][0].astype(bool)
    assert keep.sum() >= 4
    det = got["detections"][0]
    scores = np.asarray(want["scores"][0][keep])
    assert np.all(-np.diff(scores[:4]) > TOP_GAP), scores
    np.testing.assert_array_equal(det["labels"], want["labels"][0][keep])
    np.testing.assert_allclose(det["scores"], scores, rtol=0, atol=ATOL)
    np.testing.assert_allclose(det["bboxes"], want["bboxes"][0][keep], rtol=0,
                               atol=ATOL)
    # the JSON floats are the engine's float32 answer, exactly
    direct = pengine.infer(b["images"], b["lidar2img"])
    np.testing.assert_array_equal(np.asarray(det["scores"], np.float32),
                                  direct["scores"][0][direct["valid"][0]])


def test_error_routes_match_the_jax_handler(servers):
    urls, *_ = servers
    good, b = request(seed=4)
    # the routes refused before the body is read get a short body: a long
    # one could still be in flight when the server closes the connection
    cases = [
        ("GET", "/nowhere", None),
        ("POST", "/nowhere", b"x"),
        ("POST", "/infer", serve.npz_body(images=b["images"])),
        ("POST", "/infer", serve.npz_body(
            images=(b["images"] * 50).astype(np.uint8),
            lidar2img=b["lidar2img"])),
        ("POST", "/infer", serve.npz_body(images=b["images"][:, :3],
                                          lidar2img=b["lidar2img"][:, :2])),
        ("POST", "/infer_stream?stream=a", b"x"),
        ("POST", "/reset_stream?stream=a", b""),
        ("POST", "/infer", b"not an npz"),
    ]
    for method, route, body in cases:
        answers = [serve.get(u + route) if method == "GET"
                   else serve.post(u + route, body)
                   for u in (urls["jax"], urls["port"])]
        assert answers[0] == answers[1], (route, answers)
        assert answers[0][0] in (400, 404, 500), (route, answers)
    assert [serve.post(urls["port"] + "/infer", good)[0]] == [200]


def test_stream_bootstrap_lru_and_reset(servers):
    urls, _, _, sengine = servers
    url = urls["stream"]
    a, ba = request(seed=5, n_cams=3)
    full, _ = request(seed=5)
    # the first request of a stream reuses its own frame as the previous
    # one: /infer on [frame | frame] (encoded in halves) answers the same
    both = serve.npz_body(images=np.concatenate([ba["images"][:, :3]] * 2, 1),
                          lidar2img=ba["lidar2img"])
    s1 = serve.post(url + "/infer_stream?stream=x", a)
    assert s1 == serve.post(url + "/infer", both)
    assert s1[0] == 200
    serve.post(url + "/infer_stream?stream=y", a)
    serve.post(url + "/infer_stream?stream=x", a)  # x used last
    serve.post(url + "/infer_stream?stream=z", a)  # max 2: y evicted
    assert list(sengine._streams) == ["x", "z"]
    assert serve.post(url + "/reset_stream?stream=y", b"") == (
        200, {"reset": False})
    assert serve.post(url + "/reset_stream?stream=x", b"") == (
        200, {"reset": True})
    assert list(sengine._streams) == ["z"]
    assert serve.post(url + "/infer", full)[0] == 200
    status, health = serve.get(url + "/healthz")
    assert status == 200 and health == {"ok": True, "served": 6}


def test_concurrent_clients_answer_as_serial_ones(servers):
    urls, *_ = servers
    bodies = [request(seed=10 + i)[0] for i in range(4)]
    serial = [serve.post(urls["port"] + "/infer", b) for b in bodies]
    with ThreadPoolExecutor(4) as pool:
        parallel = list(pool.map(
            lambda b: serve.post(urls["port"] + "/infer", b), bodies * 2))
    assert parallel == serial * 2
    assert len({str(a) for a in serial}) == 4


def test_bench_client_keys(servers, capsys):
    urls, *_ = servers
    for extra in ([], ["--concurrency", "2"]):
        out = serve.main(["--bench", urls["port"], "--requests", "2", *extra])
        assert set(out) == {"requests", "route", "concurrency", "payload_mb",
                            "p50_ms", "p90_ms", "p95_ms", "p99_ms", "mean_ms",
                            "throughput_rps"}
        assert out["requests"] == 2 and out["route"] == "/infer"
    assert serve.main(["--bench", urls["stream"], "--requests", "1",
                       "--stream"])["route"] == "/infer_stream"


def test_engine_lock_under_thread_stress(servers):
    """More threads than cores mutate one engine's stream cache and served
    counter at a short switch interval: no update is lost, the LRU bound
    holds, and every thread's answers equal a serial call's."""
    _, _, _, sengine = servers
    _, b = request(seed=6)
    frame, l2i = b["images"][:, :3], b["lidar2img"]
    want = sengine.infer_stream(frame, l2i, stream="ref")
    before = sengine.served
    threads = 2 * (os.cpu_count() or 4)
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            out = [sengine.infer_stream(frame, l2i, stream=f"t{i % 5}")
                   for _ in range(2)]
            sengine.reset_stream(f"t{(i + 1) % 5}")
            return out
        with ThreadPoolExecutor(threads) as pool:
            answers = [a for f in [pool.submit(work, i) for i in range(threads)]
                       for a in f.result(timeout=600)]
    finally:
        sys.setswitchinterval(saved)
    assert sengine.served == before + 2 * threads
    assert len(sengine._streams) <= sengine.max_streams
    # a stream's second request may see another thread's frame as its
    # previous one: the same frame, so every answer is the bootstrap's
    for a in answers:
        for k in ("bboxes", "scores", "labels", "valid"):
            np.testing.assert_array_equal(a[k], want[k], err_msg=k)


def test_clis_need_cuda_unless_cpu_is_asked_for(artifacts, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is available")
    out = tmp_path / "export"
    with pytest.raises(RuntimeError, match="CUDA"):
        export_model.main(["--tiny", "--out", str(out)])
    assert not out.exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--artifact", artifacts["plain"][1], "--port", "0"])
