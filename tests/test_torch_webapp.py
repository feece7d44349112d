"""The web launcher in the PyTorch port (CPU): tests/test_webapp.py's cases
on the port's ``LaunchMonitor`` and server, with a stand-in ``Popen``, and
the commands naming the port's modules, run from the repository's root."""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from trinerflet_tpu_torch import webapp
from trinerflet_tpu_torch.webapp import LaunchMonitor, make_server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read()


def _post(port, path, obj):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


@pytest.fixture()
def server(tmp_path):
    cfgs = tmp_path / "configs"
    cfgs.mkdir()
    (cfgs / "a.yaml").write_text("name: a\n")
    (cfgs / "b.yaml").write_text("name: b\n")
    (cfgs / "notes.txt").write_text("not a config\n")
    mon = LaunchMonitor(configs_dir=str(cfgs))
    srv = make_server(mon, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv.server_address[1], mon, tmp_path
    mon.stop()
    srv.shutdown()
    srv.server_close()


def test_page_and_configs(server):
    port, _, _ = server
    page = _get(port, "/").decode()
    assert "<option>a.yaml</option><option>b.yaml</option>" in page and "launcher" in page
    assert json.loads(_get(port, "/configs")) == ["a.yaml", "b.yaml"]
    with pytest.raises(urllib.error.HTTPError):
        _get(port, "/nope")
    st = json.loads(_get(port, "/status"))
    assert st == {"alive": False, "pid": None, "returncode": None, "seconds": 0.0, "log": "", "artifact": None}
    with pytest.raises(urllib.error.HTTPError):
        _get(port, "/artifact")


def test_run_poll_artifact_stop(server, monkeypatch):
    """/run starts the port's SR launcher (a stand-in child that logs, writes
    an image atomically and sleeps), /status shows its log and artifact,
    /artifact serves it, a second /run is refused, /stop ends it."""
    port, mon, tmp_path = server
    ws = str(tmp_path / "trial")
    child = ("import os,sys,time; os.makedirs(sys.argv[1], exist_ok=True);"
             "print('step 1 loss 0.5', flush=True);"
             "p=os.path.join(sys.argv[1], 'val_0.png');"
             "open(p+'.tmp', 'wb').write(b'\\x89PNG fake');"
             "os.rename(p+'.tmp', p);"
             "time.sleep(60)")
    orig = subprocess.Popen
    calls = {}

    def fake_popen(cmd, **kw):
        calls["cmd"], calls["kw"] = cmd, kw
        return orig([sys.executable, "-c", child, ws], **kw)

    monkeypatch.setattr(subprocess, "Popen", fake_popen)
    out = _post(port, "/run", {"app": "sr", "config": "a.yaml", "workspace": ws, "extra": "k=v"})
    assert "pid" in out
    cmd = calls["cmd"]
    assert cmd[:4] == [sys.executable, "-u", "-m", "trinerflet_tpu_torch.sr.launch"]
    assert cmd[4:] == ["--config", os.path.join(mon.configs_dir, "a.yaml"), "--train", "--workspace", ws, "k=v"]
    assert calls["kw"]["cwd"] == ROOT and os.path.isdir(os.path.join(ROOT, "trinerflet_tpu_torch"))
    deadline = time.time() + 20
    st = {}
    while time.time() < deadline:
        st = json.loads(_get(port, "/status"))
        if st.get("artifact") and "loss" in st.get("log", ""):
            break
        time.sleep(0.3)
    assert st["alive"] is True and st["returncode"] is None and st["seconds"] > 0
    assert st["artifact"] == "val_0.png" and "step 1 loss 0.5" in st["log"]
    assert _get(port, "/artifact").startswith(b"\x89PNG")
    assert "error" in _post(port, "/run", {"app": "sr", "config": "a.yaml", "workspace": ws})
    stopped = _post(port, "/stop", {})
    assert stopped["stopped"] is True and stopped["returncode"] is not None
    assert json.loads(_get(port, "/status"))["alive"] is False


def test_recon_command_shape(server, monkeypatch):
    _, mon, tmp_path = server
    captured = {}

    class FakeProc:
        pid = 123
        returncode = 0

        def poll(self):
            return 0

        def terminate(self):
            pass

        def wait(self, timeout=None):
            return 0

    def fake_popen(cmd, **kw):
        captured["cmd"], captured["kw"] = cmd, kw
        return FakeProc()

    monkeypatch.setattr(subprocess, "Popen", fake_popen)
    out = mon.start("recon", "", str(tmp_path / "w"), "--path /tmp/scene -O --iters 10")
    assert out["pid"] == 123 and out["cmd"].startswith(f"{sys.executable} -u -m trinerflet_tpu_torch.cli")
    assert captured["cmd"] == [sys.executable, "-u", "-m", "trinerflet_tpu_torch.cli", "--workspace",
                               str(tmp_path / "w"), "--path", "/tmp/scene", "-O", "--iters", "10"]
    assert captured["kw"]["cwd"] == ROOT
    assert mon.stop() == {"stopped": True, "returncode": 0}


def test_unknown_app_rejected(server):
    _, mon, tmp_path = server
    assert "error" in mon.start("nope", "", str(tmp_path / "w2"), "")
    assert mon.stop() == {"stopped": False}


def test_newest_artifact_skips_empty_files(tmp_path):
    mon = LaunchMonitor(configs_dir=str(tmp_path))
    mon.workspace = str(tmp_path)
    (tmp_path / "a.png").write_bytes(b"x")
    time.sleep(0.02)
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "b.mp4").write_bytes(b"yy")
    time.sleep(0.02)
    (tmp_path / "c.jpg").write_bytes(b"")  # created, not yet written
    (tmp_path / "d.txt").write_bytes(b"zzz")
    assert mon.newest_artifact() == str(tmp_path / "sub" / "b.mp4")


def test_main_serves(monkeypatch, capsys):
    """``main`` builds the server on the given host and port and serves
    until interrupted."""
    served = {}

    class FakeServer:
        server_address = ("127.0.0.1", 4321)

        def serve_forever(self):
            served["forever"] = True

        def server_close(self):
            served["closed"] = True

    monkeypatch.setattr(webapp, "make_server", lambda mon, host, port: (served.update(
        configs=mon.configs_dir, host=host, port=port), FakeServer())[1])
    webapp.main(["--port", "0", "--configs", "cfgs"])
    assert served == {"configs": "cfgs", "host": "127.0.0.1", "port": 0, "forever": True, "closed": True}
    assert "webapp on http://127.0.0.1:4321/" in capsys.readouterr().out
