"""Minimal first-party WSGI toolkit (router + request/response).

The environment has no Flask; this provides just enough routing/request
parsing to reproduce the reference server's HTTP surface
(``reference DigiPathAI/main_server.py:144-242``) on the stdlib WSGI stack
(``wsgiref`` + ``ThreadingMixIn`` for the reference's ``threaded=True``).
"""

from __future__ import annotations

import json
import re
import threading
import urllib.parse
from typing import Callable, Dict, List, Optional, Tuple
from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server


class Request:
    def __init__(self, environ):
        self.environ = environ
        self.method = environ.get("REQUEST_METHOD", "GET").upper()
        self.path = urllib.parse.unquote(environ.get("PATH_INFO", "/"))
        self.query = dict(urllib.parse.parse_qsl(environ.get("QUERY_STRING", "")))
        self._form: Optional[Dict[str, str]] = None

    @property
    def form(self) -> Dict[str, str]:
        if self._form is None:
            self._form = {}
            try:
                length = int(self.environ.get("CONTENT_LENGTH") or 0)
            except ValueError:
                length = 0
            if length > 0:
                body = self.environ["wsgi.input"].read(length)
                ctype = self.environ.get("CONTENT_TYPE", "")
                if "application/x-www-form-urlencoded" in ctype or not ctype:
                    self._form = dict(
                        urllib.parse.parse_qsl(body.decode("utf-8", "replace")))
                elif "application/json" in ctype:
                    try:
                        self._form = {
                            str(k): str(v)
                            for k, v in json.loads(body.decode()).items()
                        }
                    except (ValueError, AttributeError):
                        self._form = {}
        return self._form


class Response:
    def __init__(self, body=b"", status: int = 200,
                 content_type: str = "text/html; charset=utf-8",
                 headers: Optional[List[Tuple[str, str]]] = None):
        if isinstance(body, str):
            body = body.encode("utf-8")
        self.body = body
        self.status = status
        self.headers = [("Content-Type", content_type),
                        ("Content-Length", str(len(body)))] + (headers or [])

    @classmethod
    def json(cls, obj, status: int = 200) -> "Response":
        return cls(json.dumps(obj), status, "application/json")

    @classmethod
    def abort(cls, status: int, message: str = "") -> "Response":
        import html as _html

        text = {404: "Not Found", 400: "Bad Request", 405: "Method Not Allowed",
                500: "Internal Server Error"}.get(status, "Error")
        # escape: the message often echoes the request path (reflected XSS)
        return cls(f"<h1>{status} {text}</h1><p>{_html.escape(message)}</p>",
                   status)

    _STATUS_TEXT = {200: "OK", 400: "Bad Request", 404: "Not Found",
                    405: "Method Not Allowed", 500: "Internal Server Error"}

    def status_line(self) -> str:
        return f"{self.status} {self._STATUS_TEXT.get(self.status, 'OK')}"


class HTTPError(Exception):
    def __init__(self, status: int, message: str = ""):
        self.status = status
        self.message = message


def abort(status: int, message: str = ""):
    raise HTTPError(status, message)


class App:
    """Regex router + WSGI callable."""

    def __init__(self):
        self._routes: List[Tuple[re.Pattern, Tuple[str, ...], Callable]] = []

    def route(self, pattern: str, methods=("GET",)):
        """Register ``pattern`` (full-match regex with named groups)."""
        rx = re.compile(pattern)

        def deco(fn):
            self._routes.append((rx, tuple(m.upper() for m in methods), fn))
            return fn

        return deco

    def __call__(self, environ, start_response):
        req = Request(environ)
        try:
            resp = self._dispatch(req)
        except HTTPError as e:
            resp = Response.abort(e.status, e.message)
        except Exception as e:  # noqa: BLE001 — boundary: render a 500
            import traceback

            traceback.print_exc()
            resp = Response.abort(500, str(e))
        start_response(resp.status_line(), resp.headers)
        return [resp.body]

    def _dispatch(self, req: Request) -> Response:
        allowed: List[str] = []
        for rx, methods, fn in self._routes:
            m = rx.fullmatch(req.path)
            if not m:
                continue
            if req.method not in methods:
                allowed.extend(methods)
                continue
            out = fn(req, **m.groupdict())
            return out if isinstance(out, Response) else Response(out)
        if allowed:
            return Response.abort(405)
        return Response.abort(404)


class _ThreadingWSGIServer(WSGIServer):
    """Thread-per-request (reference: app.run(threaded=True))."""

    daemon_threads = True

    def process_request(self, request, client_address):
        t = threading.Thread(
            target=self._handle, args=(request, client_address), daemon=True)
        t.start()

    def _handle(self, request, client_address):
        try:
            self.finish_request(request, client_address)
        except Exception:  # noqa: BLE001
            self.handle_error(request, client_address)
        finally:
            self.shutdown_request(request)


class _QuietHandler(WSGIRequestHandler):
    def log_message(self, fmt, *args):  # route through stdout, not stderr
        print("%s - %s" % (self.address_string(), fmt % args))


def serve(app: App, host: str = "127.0.0.1", port: int = 8080, quiet=False):
    handler = _QuietHandler if not quiet else type(
        "Silent", (WSGIRequestHandler,), {"log_message": lambda *a, **k: None})
    httpd = make_server(host, port, app, server_class=_ThreadingWSGIServer,
                        handler_class=handler)
    return httpd
