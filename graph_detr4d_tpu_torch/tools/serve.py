"""HTTP serving of an exported artifact (counterpart of tools/serve.py;
artifacts from graph_detr4d_tpu_torch/tools/export_model.py).

  POST /infer     body: .npz with 'images' (B, N, H, W, 3) (float32
                  normalized, or uint8 raw pixels for --uint8-input
                  artifacts), 'lidar2img' (B, N, 4, 4) float32 and the
                  manifest's extras -> JSON {"detections": [{bboxes,
                  scores, labels} per image, valid detections only]}
  POST /infer_stream?stream=ID   streaming artifacts only: 'images' holds
                  the NEW frame's cameras (B, num_frame_cams, H, W, 3); the
                  previous frame's features stay on the device per stream
                  id (serve.Engine.infer_stream); 'lidar2img' stays
                  (B, num_cams, 4, 4)
  POST /reset_stream?stream=ID   drop a stream's cached state (the
                  previous frame's features; BEVFormer's BEV and pose)
  GET  /manifest  the artifact's manifest
  GET  /healthz   liveness and the served-request counter
  GET  /stats     every counter of the serving path (Engine.counters():
                  requests, the stream cache's hits, misses and
                  evictions, kernel builds and launches, the head's
                  CUDA-graph captures and replays, MP's query graphs
                  built and neighbour rows sampled, BEVFormer's SCA rows
                  sampled and in-view BEV queries its capacity dropped)

Status codes and error texts are the JAX handler's: 404 for an unknown
path; 400 for a missing npz key, an images dtype of another kind than the
manifest's, a shape mismatch, or a streaming route on a non-streaming
artifact; 500 for an exception, after which the server keeps serving.
Request decoding and the JSON answer run on the server's threads; the
Engine's lock serializes the device work.

    python -m graph_detr4d_tpu_torch.tools.serve --artifact work_dirs/export
    python -m graph_detr4d_tpu_torch.tools.serve --bench http://localhost:8471 \\
        --requests 32 [--concurrency 2] [--stream]

`--device` defaults to cuda (without CUDA it raises); `--device cpu` serves
from the host. The bench client prints one JSON line with the JAX keys.
"""

import argparse
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="graph_detr4d_tpu_torch.tools.serve")
    p.add_argument("--artifact", default=None, help="export dir to serve")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8471)
    p.add_argument("--bench", default=None, metavar="URL",
                   help="client mode: POST synthetic requests to URL and "
                   "report latency")
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--concurrency", type=int, default=1,
                   help="bench mode: parallel client threads")
    p.add_argument("--stream", action="store_true",
                   help="bench mode: hit /infer_stream (streaming artifacts)")
    p.add_argument("--ready-file", default=None,
                   help="write the bound port to this file once listening")
    p.add_argument("--max-streams", type=int, default=16,
                   help="streaming artifacts: cached stream ids, least "
                   "recently used evicted first")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def detections_json(det) -> dict:
    """The JSON answer: per image, the valid detections' boxes, scores and
    labels (float32 tolist() gives doubles that convert back exactly)."""
    out = []
    for b in range(det["bboxes"].shape[0]):
        keep = det["valid"][b].astype(bool)
        out.append({"bboxes": det["bboxes"][b][keep].tolist(),
                    "scores": det["scores"][b][keep].tolist(),
                    "labels": det["labels"][b][keep].tolist()})
    return {"detections": out}


def make_handler(engine):
    from http.server import BaseHTTPRequestHandler
    from urllib.parse import parse_qs, urlparse

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True, "served": engine.served})
            elif self.path == "/manifest":
                self._send(200, engine.manifest)
            elif self.path == "/stats":
                self._send(200, engine.counters())
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            parsed = urlparse(self.path)
            route = parsed.path
            stream = parse_qs(parsed.query).get("stream", ["default"])[0]
            if route == "/reset_stream":
                if not engine.streaming:
                    self._send(400, {"error": "not a streaming artifact"})
                    return
                self._send(200, {"reset": engine.reset_stream(stream)})
                return
            if route not in ("/infer", "/infer_stream"):
                self._send(404, {"error": "unknown path"})
                return
            if route == "/infer_stream" and not engine.streaming:
                self._send(400, {"error": "not a streaming artifact; export "
                                 "with --streaming"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                data = np.load(io.BytesIO(self.rfile.read(n)))
                required = ["images", "lidar2img"] + [
                    name for name, _ in engine.extras_spec]
                missing = [k for k in required if k not in data]
                if missing:
                    self._send(400, {"error": f"missing npz key(s) {missing}; "
                                     f"this artifact requires {required}"})
                    return
                m = engine.manifest
                img_dtype = np.dtype(m["inputs"]["images"][1])
                sent = np.asarray(data["images"])
                # a cast across float / integer kinds would turn normalized
                # pixels into garbage detections with HTTP 200
                if sent.dtype.kind != img_dtype.kind:
                    self._send(400, {"error": (
                        f"images dtype {sent.dtype.name} does not match this "
                        f"artifact's input dtype {img_dtype.name} "
                        "(uint8-ingest artifacts take RAW pixels 0-255; "
                        "float artifacts take normalized pixels — see "
                        "/manifest)")})
                    return
                images = sent.astype(img_dtype, copy=False)
                l2i = np.asarray(data["lidar2img"], np.float32)
                want_i = tuple(m["inputs"]["images"][0])
                if route == "/infer_stream":
                    want_i = (want_i[0], engine.streaming["num_frame_cams"]) \
                        + want_i[2:]
                want_l = tuple(m["inputs"]["lidar2img"][0])
                extras, shape_errs = [], []
                if images.shape != want_i:
                    shape_errs.append(
                        f"images {list(images.shape)} != {list(want_i)}")
                if l2i.shape != want_l:
                    shape_errs.append(
                        f"lidar2img {list(l2i.shape)} != {list(want_l)}")
                for name, want_e in engine.extras_spec:
                    v = np.asarray(data[name], np.float32)
                    if v.shape != want_e:
                        shape_errs.append(
                            f"{name} {list(v.shape)} != {list(want_e)}")
                    extras.append(v)
                if shape_errs:
                    self._send(400, {"error": "input shape mismatch vs "
                                     "artifact: " + "; ".join(shape_errs)})
                    return
                if route == "/infer_stream":
                    det = engine.infer_stream(images, l2i, extras,
                                              stream=stream)
                else:
                    det = engine.infer(images, l2i, extras)
                self._send(200, detections_json(det))
            except Exception as e:  # surface to the client, keep serving
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, *a):  # quiet
            pass

    return Handler


def run_server(args, on_ready=None):
    """Load the artifact, bind, print the start line, write --ready-file,
    then serve until shut down. on_ready(server, engine), when given, is
    called once the server listens (an in-process caller's handle)."""
    from http.server import ThreadingHTTPServer

    from ..serve import Engine

    engine = Engine.from_artifact(args.artifact, device=args.device,
                                  max_streams=args.max_streams)
    srv = ThreadingHTTPServer((args.host, args.port), make_handler(engine))
    srv.daemon_threads = True
    print(json.dumps({"serving": f"http://{args.host}:{srv.server_address[1]}",
                      "artifact": args.artifact,
                      "config": engine.manifest.get("config")}), flush=True)
    if args.ready_file:
        with open(args.ready_file, "w") as f:
            f.write(str(srv.server_address[1]))
    if on_ready is not None:
        on_ready(srv, engine)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


def post(url, body: bytes, timeout=600.0):
    """POST body to url; (status, decoded JSON answer)."""
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def get(url, timeout=60.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def npz_body(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def bench_body(manifest, seed, stream=False) -> bytes:
    """A synthetic request for an artifact (tools/serve.py::run_bench's):
    seeded random pixels of the artifact's dtype, identity lidar2img, the
    placeholder extras."""
    from ..serve import synth_extra

    B, N = manifest["batch_size"], manifest["num_cams"]
    H, W = manifest["img_size"]
    n_img = manifest["streaming"]["num_frame_cams"] if stream else N
    rng = np.random.RandomState(seed)
    if manifest["inputs"]["images"][1] == "uint8":
        images = rng.randint(0, 256, (B, n_img, H, W, 3), np.uint8)
    else:
        images = rng.randn(B, n_img, H, W, 3).astype(np.float32)
    extras = {name: synth_extra(name, tuple(manifest["inputs"][name][0]))
              for name in manifest.get("extras", [])}
    return npz_body(images=images, lidar2img=np.tile(
        np.eye(4, dtype=np.float32), (B, N, 1, 1)), **extras)


def run_bench(args) -> dict:
    """POST --requests synthetic requests from --concurrency threads (the
    serial client repeats one body; concurrent clients each send their
    own) and print the latency summary with the JAX client's keys."""
    _, manifest = get(args.bench + "/manifest")
    route = "/infer"
    if args.stream:
        if not manifest.get("streaming"):
            raise SystemExit("--stream needs a --streaming artifact")
        route = "/infer_stream?stream=bench"

    def one(body):
        t0 = time.perf_counter()
        status, resp = post(args.bench + route, body)
        if status != 200 or "detections" not in resp:
            raise RuntimeError(f"bench request failed: {status} {resp}")
        return time.perf_counter() - t0

    wall0 = time.perf_counter()
    if args.concurrency > 1:
        from concurrent.futures import ThreadPoolExecutor

        bodies = [bench_body(manifest, i, args.stream)
                  for i in range(args.concurrency)]
        with ThreadPoolExecutor(args.concurrency) as pool:
            lat = list(pool.map(lambda i: one(bodies[i % len(bodies)]),
                                range(args.requests)))
        payload_bytes = len(bodies[0])
    else:
        body = bench_body(manifest, 0, args.stream)
        lat = [one(body) for _ in range(args.requests)]
        payload_bytes = len(body)
    wall = time.perf_counter() - wall0
    lat_ms = sorted(x * 1e3 for x in lat)
    n = len(lat_ms)

    def pct(p):
        return round(lat_ms[min(n - 1, int(n * p))], 1)

    out = {"requests": n, "route": route.split("?")[0],
           "concurrency": args.concurrency,
           "payload_mb": round(payload_bytes / 1e6, 1),
           "p50_ms": pct(0.50), "p90_ms": pct(0.90), "p95_ms": pct(0.95),
           "p99_ms": pct(0.99), "mean_ms": round(sum(lat_ms) / n, 1),
           "throughput_rps": round(n / wall, 2)}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None, on_ready=None):
    args = parse_args(argv)
    if args.bench:
        return run_bench(args)
    if not args.artifact:
        raise SystemExit("--artifact or --bench required")
    return run_server(args, on_ready)


def serve_in_thread(argv, timeout=600.0):
    """Run main(argv) on a daemon thread until the server listens; returns
    (server, engine, thread). server.shutdown() ends it."""
    ready, handle = threading.Event(), {}

    def on_ready(srv, engine):
        handle.update(srv=srv, engine=engine)
        ready.set()

    def run():
        try:
            main(argv, on_ready)
        except Exception as e:  # handed to the caller below
            handle["error"] = e
        finally:
            ready.set()

    thread = threading.Thread(target=run, name="serve", daemon=True)
    thread.start()
    if not ready.wait(timeout) or "srv" not in handle:
        raise RuntimeError("the server did not start") from handle.get("error")
    return handle["srv"], handle["engine"], thread
