"""Interactive viewer over HTTP: an orbit camera and a train / view loop
(port of ``trinerflet_tpu/utils/gui.py``).

A single-threaded stdlib server renders orbit-camera frames (JPEG) on
demand while the train loop handles requests between bursts of steps.
Open ``http://host:port/`` for a drag-to-orbit page (plain JS);
``/frame?theta=..&phi=..&radius=..&w=..&h=..`` returns one render,
``/state`` the live step and loss, ``/stop`` ends the loop.

Every request is handled on the loop's own thread (``handle_request``), so
every CUDA call stays on one thread.

Differences from the JAX package:

* Frames are encoded by the port's host library (``native.encode_jpeg``,
  quality 90, 4:2:0) on every host, where the JAX package calls cv2: the
  bytes differ from libjpeg's, the decoded pixels agree within JPEG's error.
* ``train_loop`` drives the port's trainer on ``fit``'s cadence
  (``update_grid`` every ``update_extra_interval`` steps, full while
  ``iter_density`` < 16, then ``_maybe_retune_march`` on the last aux;
  ``train_step`` with the statistics on the step before each refresh), so
  N steps of it are N steps of ``fit``.
* ``close`` also runs after ``--gui --test`` (``cli.run_gui``).
"""

from __future__ import annotations

import json
import math
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

__all__ = ["OrbitCamera", "NeRFGUI"]

_PAGE = """<!doctype html><html><body style="margin:0;background:#111;color:#eee;font:13px monospace">
<div id="s" style="padding:4px">connecting...</div>
<img id="v" style="display:block" draggable="false">
<script>
let th=1.2, ph=0.0, r=%RADIUS%, drag=null, busy=false;
const img=document.getElementById('v'), st=document.getElementById('s');
function refresh(){ if(busy) return; busy=true;
  img.src='/frame?theta='+th+'&phi='+ph+'&radius='+r+'&t='+Date.now(); }
img.onload=()=>{busy=false;};
img.onerror=()=>{busy=false;};
img.onmousedown=e=>{drag=[e.clientX,e.clientY];e.preventDefault();};
window.onmouseup=()=>{drag=null;};
window.onmousemove=e=>{ if(!drag) return;
  ph-=(e.clientX-drag[0])*0.01; th-=(e.clientY-drag[1])*0.01;
  th=Math.min(3.0,Math.max(0.1,th)); drag=[e.clientX,e.clientY]; refresh(); };
window.onwheel=e=>{ r*=Math.pow(1.1,e.deltaY>0?1:-1); refresh(); };
setInterval(()=>{ fetch('/state').then(x=>x.json()).then(j=>{
  st.textContent='step '+j.step+'  loss '+j.loss.toFixed(5)+'  '+j.mode;
  if(j.training) refresh(); }); }, 1000);
refresh();
</script></body></html>"""


class OrbitCamera:
    """Spherical orbit camera around the origin, parameterised by angles so
    that a stateless HTTP query names any view."""

    def __init__(self, W: int, H: int, radius: float = 2.0, fovy: float = 60.0):
        self.W, self.H = W, H
        self.radius = radius
        self.fovy = fovy

    def pose(self, theta: float, phi: float, radius: Optional[float] = None) -> np.ndarray:
        r = self.radius if radius is None else radius
        center = r * np.array([math.sin(theta) * math.sin(phi), math.cos(theta),
                               math.sin(theta) * math.cos(phi)], np.float32)

        def norm(v):
            return v / (np.linalg.norm(v) + 1e-10)

        fwd = -norm(center)
        up = np.array([0.0, -1.0, 0.0], np.float32)
        right = norm(np.cross(fwd, up))
        up = norm(np.cross(right, fwd))
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = np.stack([right, up, fwd], axis=-1)
        pose[:3, 3] = center
        return pose

    def intrinsics(self, W: Optional[int] = None, H: Optional[int] = None):
        W = W or self.W
        H = H or self.H
        focal = H / (2 * math.tan(math.radians(self.fovy) / 2))
        return (focal, focal, W / 2, H / 2)


class NeRFGUI:
    """The HTTP train / view loop. ``test_loop()`` serves frames of a fixed
    state until ``/stop``; ``train_loop(scene)`` interleaves bursts of
    ``train_steps`` steps with request handling, the burst adapting toward
    about 500 ms."""

    def __init__(self, trainer, state, W: int = 400, H: int = 400, radius: float = 2.0,
                 fovy: float = 60.0, host: str = "127.0.0.1", port: int = 7860,
                 train_steps: int = 16):
        self.trainer = trainer
        self.state = state
        self.cam = OrbitCamera(W, H, radius, fovy)
        self.train_steps = train_steps
        # the host's step counter (the port's state.step is a host int too)
        self.step = int(getattr(state, "step", 0))
        self.loss = 0.0  # strict JSON: a NaN would break the page's parse
        self.training = False
        self._stop = False

        gui = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    self._reply(_PAGE.replace("%RADIUS%", str(gui.cam.radius)).encode(), "text/html")
                elif u.path == "/state":
                    body = json.dumps({"step": gui.step, "loss": gui.loss, "training": gui.training,
                                       "mode": "train" if gui.training else "infer"}).encode()
                    self._reply(body, "application/json")
                elif u.path == "/frame":
                    q = parse_qs(u.query)

                    def g(k, d):
                        return float(q.get(k, [d])[0])

                    body = gui.render_frame(theta=g("theta", 1.2), phi=g("phi", 0.0),
                                            radius=g("radius", gui.cam.radius),
                                            W=int(g("w", gui.cam.W)), H=int(g("h", gui.cam.H)))
                    self._reply(body, "image/jpeg")
                elif u.path == "/stop":
                    gui._stop = True
                    self._reply(b"ok", "text/plain")
                else:
                    self.send_error(404)

            def _reply(self, body: bytes, ctype: str):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.server = HTTPServer((host, port), Handler)
        self.server.timeout = 0.02  # handle_request returns fast when idle
        self.port = self.server.server_address[1]

    # ------------------------------------------------------------- rendering

    def render_frame(self, theta: float, phi: float, radius: float, W: Optional[int] = None,
                     H: Optional[int] = None) -> bytes:
        """One orbit-camera render (the EMA params when the trainer keeps an
        EMA) -> JPEG bytes at quality 90."""
        from ..native import encode_jpeg

        W = W or self.cam.W
        H = H or self.cam.H
        pose = self.cam.pose(theta, phi, radius)
        params = self.state.ema_params if getattr(self.trainer.cfg, "ema_decay", 0) > 0 else self.state.params
        img, _ = self.trainer.render_image(params, self.state.occ, pose, self.cam.intrinsics(W, H), H, W)
        return encode_jpeg((img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy(), quality=90)

    # ----------------------------------------------------------------- loops

    def test_loop(self, max_seconds: Optional[float] = None):
        """Serve frames of the current (frozen) state until /stop."""
        t0 = time.time()
        while not self._stop:
            self.server.handle_request()
            if max_seconds is not None and time.time() - t0 > max_seconds:
                break

    def train_loop(self, scene, max_iters: Optional[int] = None):
        """Bursts of training steps on ``fit``'s cadence, each followed by
        one request's handling, until ``max_iters`` (``cfg.iters`` by
        default) steps or /stop. Returns the state."""
        tr = self.trainer
        data = tr.scene_to_device(scene)
        total = max_iters if max_iters is not None else tr.cfg.iters
        interval = tr.cfg.update_extra_interval
        self.training = True
        aux = None
        while self.step < total and not self._stop:
            t0 = time.time()
            for _ in range(min(self.train_steps, total - self.step)):
                if tr.cfg.renderer == "occgrid" and self.step % interval == 0:
                    occ = tr.update_grid(self.state.params, self.state.occ, generator=self.state.rng,
                                         full=int(self.state.occ.iter_density) < 16)
                    self.state = self.state._replace(occ=occ)
                    tr._maybe_retune_march(self.state, aux)
                self.state, aux = tr.train_step(self.state, data,
                                                with_stats=(self.step + 1) % interval == 0)
                self.step += 1
            self.loss = float(aux["loss"])  # waits for the burst
            # adapt the burst toward ~500 ms
            dt = (time.time() - t0) / max(self.train_steps, 1)
            self.train_steps = int(min(64, max(4, 0.5 / max(dt, 1e-4))))
            self.server.handle_request()
        self.training = False
        return self.state

    def close(self):
        self.server.server_close()
