"""Web launcher and monitor for training runs (port of
``trinerflet_tpu/webapp.py``).

A dependency-free ``http.server`` app that starts one training run of the
port as a subprocess, polls its status and serves its newest image or
video:

* ``GET /``            the page: the app (SR launcher or reconstruction
                       CLI), a config of ``configs/``, extra arguments,
                       Run / Stop, a live status panel
* ``POST /run``        start the run (its log in the workspace)
* ``POST /stop``       terminate it (through its ``Popen`` handle)
* ``GET /status``      JSON: alive, returncode, seconds, the log's tail,
                       the newest artifact's name
* ``GET /configs``     the YAML configs
* ``GET /artifact``    the newest image or video under the workspace

Run: ``python -m trinerflet_tpu_torch.webapp --port 7861 [--configs configs/]``.
The runs start ``python -m trinerflet_tpu_torch.sr.launch`` and ``python -m
trinerflet_tpu_torch.cli`` from the repository's root, on the card (their
default device).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse

__all__ = ["LaunchMonitor", "make_server", "main"]

_IMG_EXT = (".png", ".jpg", ".jpeg")
_VID_EXT = (".mp4",)

_PAGE = """<!doctype html><html><body style="margin:0;padding:12px;background:#111;color:#eee;font:13px monospace">
<h3 style="margin:2px 0">trinerflet_tpu_torch launcher</h3>
<div>
 app <select id="app"><option value="sr">sr.launch</option><option value="recon">cli (recon)</option></select>
 config <select id="cfg">%CONFIGS%</select>
 workspace <input id="ws" value="/tmp/webapp_trial" size="24">
</div>
<div style="margin:6px 0">extra args <input id="extra" size="80"
  placeholder="system.total_steps=2000 ... (sr dotlist) | --iters 500 ... (recon flags)"></div>
<button id="run">Run</button> <button id="stop">Stop</button>
<pre id="st" style="background:#000;padding:8px;white-space:pre-wrap"></pre>
<img id="art" style="max-width:512px;display:none">
<script>
const $=id=>document.getElementById(id);
$('run').onclick=()=>fetch('/run',{method:'POST',headers:{'Content-Type':'application/json'},
  body:JSON.stringify({app:$('app').value,config:$('cfg').value,
                       workspace:$('ws').value,extra:$('extra').value})})
  .then(r=>r.json()).then(j=>{$('st').textContent=JSON.stringify(j);});
$('stop').onclick=()=>fetch('/stop',{method:'POST'});
setInterval(()=>{fetch('/status').then(r=>r.json()).then(j=>{
  $('st').textContent='alive: '+j.alive+'  rc: '+j.returncode+'  '+j.seconds.toFixed(0)+'s\\n'+j.log;
  if(j.artifact){$('art').style.display='block';$('art').src='/artifact?t='+Date.now();}
});},1000);
</script></body></html>"""

# the repository's root: the children run `python -m` from there
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tail(path: str, max_bytes: int = 4000) -> str:
    """The last ``max_bytes`` of a log file."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - max_bytes))
            return f.read().decode("utf-8", "replace")
    except OSError:
        return ""


class LaunchMonitor:
    """Owns at most one training subprocess and answers status queries."""

    def __init__(self, configs_dir: str = "configs", python: str = sys.executable):
        self.configs_dir = configs_dir
        self.python = python
        self.proc: subprocess.Popen | None = None
        self.workspace = ""
        self.log_path = ""
        self.t0 = 0.0
        self._lock = threading.Lock()

    # ------------------------------------------------------------- lifecycle

    def configs(self):
        return sorted(os.path.basename(p) for p in glob.glob(os.path.join(self.configs_dir, "*.yaml")))

    def start(self, app: str, config: str, workspace: str, extra: str) -> dict:
        with self._lock:
            if self.proc is not None and self.proc.poll() is None:
                return {"error": "a run is already active; stop it first"}
            os.makedirs(workspace, exist_ok=True)
            extra_args = extra.split()
            if app == "sr":
                cfg = os.path.join(self.configs_dir, os.path.basename(config))
                cmd = [self.python, "-u", "-m", "trinerflet_tpu_torch.sr.launch", "--config", cfg,
                       "--train", "--workspace", workspace, *extra_args]
            elif app == "recon":
                cmd = [self.python, "-u", "-m", "trinerflet_tpu_torch.cli", "--workspace", workspace,
                       *extra_args]
            else:
                return {"error": f"unknown app {app!r}"}
            self.workspace = workspace
            self.log_path = os.path.join(workspace, "webapp_log.txt")
            log = open(self.log_path, "ab")
            self.proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=_ROOT)
            log.close()
            self.t0 = time.time()
            return {"pid": self.proc.pid, "cmd": " ".join(cmd)}

    def stop(self) -> dict:
        with self._lock:
            if self.proc is None:
                return {"stopped": False}
            if self.proc.poll() is None:
                self.proc.terminate()
                try:
                    self.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    self.proc.kill()
                    self.proc.wait()
            return {"stopped": True, "returncode": self.proc.returncode}

    # ---------------------------------------------------------------- status

    def newest_artifact(self):
        best, best_t = None, -1.0
        for root, _, files in os.walk(self.workspace or "."):
            for f in files:
                if f.lower().endswith(_IMG_EXT + _VID_EXT):
                    p = os.path.join(root, f)
                    try:
                        st = os.stat(p)
                    except OSError:
                        continue
                    if st.st_size == 0:  # created, not yet written
                        continue
                    if st.st_mtime > best_t:
                        best, best_t = p, st.st_mtime
        return best

    def status(self) -> dict:
        alive = self.proc is not None and self.proc.poll() is None
        art = self.newest_artifact() if self.workspace else None
        return {
            "alive": alive,
            "pid": self.proc.pid if self.proc else None,
            "returncode": None if self.proc is None else self.proc.poll(),
            "seconds": (time.time() - self.t0) if self.proc else 0.0,
            "log": _tail(self.log_path) if self.log_path else "",
            "artifact": os.path.basename(art) if art else None,
        }


def make_server(monitor: LaunchMonitor, host: str = "127.0.0.1", port: int = 0):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _reply(self, body: bytes, ctype: str, code: int = 200):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code: int = 200):
            self._reply(json.dumps(obj).encode(), "application/json", code)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/":
                opts = "".join(f"<option>{c}</option>" for c in monitor.configs())
                self._reply(_PAGE.replace("%CONFIGS%", opts).encode(), "text/html")
            elif u.path == "/status":
                self._json(monitor.status())
            elif u.path == "/configs":
                self._json(monitor.configs())
            elif u.path == "/artifact":
                p = monitor.newest_artifact()
                if not p:
                    self.send_error(404)
                    return
                ctype = ("video/mp4" if p.lower().endswith(_VID_EXT)
                         else "image/png" if p.lower().endswith(".png") else "image/jpeg")
                with open(p, "rb") as f:
                    self._reply(f.read(), ctype)
            else:
                self.send_error(404)

        def do_POST(self):
            u = urlparse(self.path)
            n = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(n) or b"{}") if n else {}
            if u.path == "/run":
                self._json(monitor.start(body.get("app", "sr"), body.get("config", ""),
                                         body.get("workspace", "/tmp/webapp_trial"),
                                         body.get("extra", "")))
            elif u.path == "/stop":
                self._json(monitor.stop())
            else:
                self.send_error(404)

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7861)
    p.add_argument("--configs", default="configs")
    args = p.parse_args(argv)
    server = make_server(LaunchMonitor(args.configs), args.host, args.port)
    print(f"webapp on http://{args.host}:{server.server_address[1]}/", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
