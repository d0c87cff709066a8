#!/usr/bin/env python
"""HTTP smoke drive of the PyTorch port's full server surface.

The counterpart of ``tools/http_smoke.py`` on ``digipathai_tpu_torch``:
build a demo slide (the port's writer), start
``python -m digipathai_tpu_torch.server.cli`` in a child process, and
exercise every route the reference frontend uses
(``reference DigiPathAI/templates/viewer.html:244-304``): file list, viewer
page, static assets, .dzi descriptors, image tiles, POST /segment (bad
knobs rejected), status polling to Done, then the mask/uncertainty overlay
pyramids.  A run that ends in ``Error`` fails: there is no retry on
another device.

Exit code 0 iff every check passes.  Usage:

    python tools/http_smoke_torch.py [--slide PATH] [--keep] [--full]
        [--port PORT] [--device DEVICE]

``--full`` runs tile mode, the 3-model ensemble, every TTA and the CRF
(supertile 1024).  ``--device`` is passed to the child (default ``cuda``:
the engine runs on the card).  Requires no network: DPAI_OFFLINE=1 is set
for the child server, whose output goes to ``server.log`` beside the slide
(its tail is printed when a check fails).
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.parse
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

# seconds from POST /segment to Done, quick or --full.  No compile budget
# is needed (JAX's --full allowed 2700 s for XLA): --full takes seconds on
# the card and about 90 s with --device cpu on 8 shared cores (PERF.md)
DEADLINE = 900
FULL_FLAGS = ["--inference-mode", "tile", "--ensemble", "--tta", "all",
              "--crf", "--engine-opt", "supertile=1024"]


def get(url, binary=False):
    with urllib.request.urlopen(url, timeout=60) as r:
        body = r.read()
        return r.status, body if binary else body.decode("utf-8", "replace")


def start_server(slide_dir, port, device=None, full=False, extra=(),
                 env=None, log_path=None):
    """The port's CLI in a child process on ``slide_dir``; ``device=None``
    leaves the CLI's default.  Its output goes to ``log_path``."""
    env = dict(os.environ if env is None else env, DPAI_OFFLINE="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    cmd = [sys.executable, "-m", "digipathai_tpu_torch.server.cli", "-s",
           slide_dir, "-l", "127.0.0.1", "-p", str(port)]
    if device is not None:
        cmd += ["--device", device]
    if full:
        cmd += FULL_FLAGS
    cmd += list(extra)
    log = open(log_path or os.devnull, "wb")
    try:
        return subprocess.Popen(cmd, env=env, stdout=log,
                                stderr=subprocess.STDOUT)
    finally:
        log.close()


def wait_ready(base, proc, timeout=120.0) -> float:
    """Seconds until ``base + '/'`` answers; raises if the child exits or
    ``timeout`` passes first."""
    t0 = time.time()
    while time.time() - t0 < timeout:
        if proc.poll() is not None:
            raise RuntimeError(f"server exited with {proc.returncode}")
        try:
            get(base + "/")
            return time.time() - t0
        except (urllib.error.URLError, ConnectionError):
            time.sleep(0.1)
    raise RuntimeError(f"server did not answer within {timeout:.0f} s")


def stop_server(proc):
    proc.terminate()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)


def run_checks(base, name, log=print, on_done=None):
    """Every route check against a running server whose slide directory
    holds slide ``name``.  Returns (failed check labels, seconds from
    ``POST /segment`` to the final status).  ``on_done()`` runs once the
    run has ended, while the server still lives."""
    fails = []

    def check(label, ok, detail=""):
        log(f"{'ok  ' if ok else 'FAIL'} {label} {detail}")
        if not ok:
            fails.append(label)
        return ok

    st, body = get(base + "/")
    check("GET / (file list)", st == 200 and name in body)
    q = urllib.parse.quote(name)
    st, body = get(f"{base}/{q}")
    check("GET viewer page", st == 200 and "SOURCES" in body
          and "DPAIViewer" in body)
    check("viewer references static js", "/static/dpai/viewer.js" in body)
    st, body = get(base + "/static/dpai/viewer.js")
    check("GET /static/dpai/viewer.js", st == 200 and len(body) > 1000)
    st, body = get(f"{base}/{q}.dzi")
    check("GET .dzi", st == 200 and "deepzoom" in body)
    st, tile = get(f"{base}/{q}_files/9/0_0.jpeg", binary=True)
    check("GET slide tile", st == 200 and tile[:2] == b"\xff\xd8",
          f"{len(tile)}B")

    # per-request knob validation: bad values 400 without starting a run
    for bad in (b"tissuetype=Colon&quick=maybe",
                b"tissuetype=Colon&tta=FLIP_DIAGONAL"):
        breq = urllib.request.Request(
            base + "/segment", data=bad,
            headers={"Content-Type": "application/x-www-form-urlencoded"})
        try:
            with urllib.request.urlopen(breq, timeout=60):
                check(f"POST /segment rejects {bad.decode()}", False)
        except urllib.error.HTTPError as e:
            check("POST /segment rejects bad knob", e.code == 400,
                  bad.decode().split("&", 1)[1])

    req = urllib.request.Request(
        base + "/segment", data=b"tissuetype=Colon",
        headers={"Content-Type": "application/x-www-form-urlencoded"})
    with urllib.request.urlopen(req, timeout=60) as r:
        check("POST /segment", r.status == 200)

    status = {}
    t0 = time.time()
    while time.time() - t0 < DEADLINE:
        st, body = get(base + "/check_segment_status")
        status = json.loads(body)
        if status.get("status") in ("Done", "Error"):
            break
        time.sleep(0.25)
    seconds = time.time() - t0
    if on_done is not None:
        on_done()
    check("segmentation reaches Done", status.get("status") == "Done",
          f"({status.get('status')} after {seconds:.1f}s)")

    stem = name.rsplit(".", 1)[0]
    for suffix in ("-dgai-mask", "-dgai-uncertainty"):
        art = urllib.parse.quote(f"{stem}{suffix}.tiff")
        try:
            st, body = get(f"{base}/{art}.dzi")
            check(f"GET {suffix}.dzi", st == 200 and "deepzoom" in body)
            st, tile = get(f"{base}/{art}_files/9/0_0.jpeg", binary=True)
            check(f"GET {suffix} tile", st == 200 and tile[:2] == b"\xff\xd8")
        except urllib.error.HTTPError as e:
            check(f"GET {suffix}", False, f"HTTP {e.code}")
    st, body = get(base + "/")
    check("file list shows mask available", "Available" in body)
    return fails, seconds


def tail(path, n=40):
    try:
        with open(path, "rb") as f:
            lines = f.read().decode("utf-8", "replace").splitlines()
    except OSError:
        return ""
    return "\n".join(lines[-n:])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--slide", default=None)
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--port", type=int, default=8123)
    ap.add_argument("--device", default="cuda",
                    help="torch device the server's engine runs on [cuda]")
    args = ap.parse_args(argv)

    d = tempfile.mkdtemp(prefix="dpai_smoke_torch_")
    if args.slide:
        shutil.copy(args.slide, d)
        name = os.path.basename(args.slide)
    else:
        sys.path.insert(0, HERE)
        from torch_fixtures import make_synthetic_slide

        name = "demo.tiff"
        make_synthetic_slide(os.path.join(d, name), 768, 768, seed=9)

    log_path = os.path.join(d, "server.log")
    srv = start_server(d, args.port, args.device, args.full,
                       log_path=log_path)
    base = f"http://127.0.0.1:{args.port}"
    fails = []
    try:
        try:
            print(f"server answered in {wait_ready(base, srv):.1f}s")
            fails, _ = run_checks(base, name)
        except (RuntimeError, OSError) as e:
            fails = [f"server: {e}"]
            print(f"FAIL {fails[0]}")
    finally:
        stop_server(srv)
        if fails:
            print(f"--- server log (tail) ---\n{tail(log_path)}")
        if not args.keep:
            shutil.rmtree(d, ignore_errors=True)

    print(f"\n{'PASS' if not fails else 'FAIL'}: "
          f"{len(fails)} failed check(s) {fails or ''}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
