"""Live map + frame viewer over HTTP (port of `corbslam_tpu/apps/live_viewer.py`;
publishers hand in the port's tensors, copied to the host with `.cpu()`) —
the reference's Pangolin windows
(`Viewer::Run` ref: corbslam_client/src/Viewer.cc:52, the FrameDrawer
overlay FrameDrawer.cc, and the server-side global-map window
ServerMapView.cpp:34) re-imagined for headless deployments: instead of
an OpenGL context on the robot, a tiny stdlib HTTP server publishes the
annotated current frame, the rendered map, and live stats; any browser on
the network is the display.

Design: publishers hand in HOST snapshots (numpy) and return immediately;
one render thread rasterizes the newest snapshot at a bounded rate
(matplotlib map renders cost ~300 ms — never on the tracking thread).

Endpoints:
    /            HTML page (auto-refreshing images + stats)
    /frame.png   latest annotated camera frame
    /map.png     latest rendered map (top-down + side)
    /stats.json  latest stats dict

Usage:
    viewer = LiveViewer(port=8642)          # 0 = ephemeral port
    viewer.publish_frame(img_gray, tracker) # cheap (host annotate + png)
    viewer.publish_map(tracker.map)         # snapshot; rendered async
    viewer.publish_stats({...})
    print(viewer.url)
    viewer.close()
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = b"""<!doctype html>
<html><head><title>corbslam_tpu_torch live</title>
<style>
body { background:#111; color:#ddd; font-family:monospace; margin:1em; }
img { max-width:100%%; border:1px solid #333; margin-top:0.5em; }
pre { color:#8c8; }
</style></head>
<body>
<h3>corbslam_tpu_torch live viewer</h3>
<pre id="stats">...</pre>
<img id="frame" src="/frame.png">
<img id="map" src="/map.png">
<script>
setInterval(() => {
  document.getElementById('frame').src = '/frame.png?' + Date.now();
  document.getElementById('map').src = '/map.png?' + Date.now();
  fetch('/stats.json').then(r => r.json()).then(s => {
    document.getElementById('stats').textContent = JSON.stringify(s, null, 1);
  });
}, 700);
</script>
</body></html>
"""

_EMPTY_PNG = None


def _empty_png() -> bytes:
    global _EMPTY_PNG
    if _EMPTY_PNG is None:
        from .frame_drawer import png_bytes

        _EMPTY_PNG = png_bytes(np.zeros((8, 8, 3), np.uint8))
    return _EMPTY_PNG


class LiveViewer:
    def __init__(self, port: int = 0, map_render_hz: float = 1.0,
                 title: str = "corbslam_tpu_torch map", host: str = "127.0.0.1"):
        self._lock = threading.Lock()
        self._frame_png: bytes = _empty_png()
        self._map_png: bytes = _empty_png()
        self._stats: dict = {}
        self._map_snapshot = None  # newest host copy awaiting render
        self._title = title
        self._min_render_dt = 1.0 / max(map_render_hz, 1e-3)
        self._closed = threading.Event()
        self._wake = threading.Event()

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/frame.png":
                    body, ctype = viewer._frame_png, "image/png"
                elif path == "/map.png":
                    body, ctype = viewer._map_png, "image/png"
                elif path == "/stats.json":
                    with viewer._lock:
                        body = json.dumps(viewer._stats).encode()
                    ctype = "application/json"
                elif path == "/":
                    body, ctype = _PAGE, "text/html"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

        # Loopback by default: the viewer serves live camera frames and the
        # map with no authentication, so network-wide exposure must be an
        # explicit opt-in (pass host="0.0.0.0").
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._http_thread.start()
        self._render_thread = threading.Thread(
            target=self._render_loop, daemon=True)
        self._render_thread.start()

    # ------------------------------------------------------------------
    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}/"

    def publish_frame(self, img_gray, tracker) -> None:
        """Annotate + encode the current frame (host work, ~few ms)."""
        from .frame_drawer import FrameDrawer, host, png_bytes

        rgb = FrameDrawer().draw(host(img_gray), tracker)
        png = png_bytes(rgb)
        with self._lock:
            self._frame_png = png

    def publish_map(self, m, stats: dict | None = None) -> None:
        """Snapshot the map for the async render thread (returns fast)."""
        from .frame_drawer import host

        snap = {
            "kf_Tcw": host(m.kf.Tcw), "kf_valid": host(m.kf.valid),
            "kf_client": host(m.kf.client),
            "mp_pos": host(m.mp.pos), "mp_valid": host(m.mp.valid),
            "mp_client": host(m.mp.client),
        }
        with self._lock:
            self._map_snapshot = snap
            if stats:
                self._stats.update(stats)
        self._wake.set()

    def publish_stats(self, stats: dict) -> None:
        with self._lock:
            self._stats.update(stats)

    # ------------------------------------------------------------------
    def _render_loop(self):
        import time

        from .render_map import render_map

        while not self._closed.is_set():
            self._wake.wait(timeout=0.5)
            self._wake.clear()
            with self._lock:
                snap, self._map_snapshot = self._map_snapshot, None
            if snap is None:
                continue
            t0 = time.time()
            try:
                buf = io.BytesIO()
                render_map(
                    snap["kf_Tcw"], snap["kf_valid"], snap["kf_client"],
                    snap["mp_pos"], snap["mp_valid"], snap["mp_client"],
                    buf, title=self._title, draw_covis=False,
                )
                with self._lock:
                    self._map_png = buf.getvalue()
            except Exception as e:  # pragma: no cover - viz resilience
                with self._lock:
                    self._stats["render_error"] = repr(e)[:120]
            # Bound the render rate.
            dt = time.time() - t0
            if dt < self._min_render_dt:
                self._closed.wait(timeout=self._min_render_dt - dt)

    def close(self):
        self._closed.set()
        self._wake.set()
        self._httpd.shutdown()
        self._http_thread.join(timeout=5)
        self._render_thread.join(timeout=5)
