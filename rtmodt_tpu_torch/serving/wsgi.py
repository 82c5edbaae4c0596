"""Minimal WSGI micro-framework (router + request/response + multipart).

The port's copy of ``rtmodt_tpu/serving/wsgi.py``, kept apart so that the
port imports nothing of the JAX package.  A dependency-free serving layer
on the Python stdlib: a tiny router with typed responses,
multipart/form-data parsing, a threaded WSGI server, and an in-process test
client in the style of ``fastapi.testclient``.
"""

from __future__ import annotations

import io
import json
import mimetypes
import re
import threading
from typing import Any, Callable
from wsgiref.simple_server import WSGIServer, WSGIRequestHandler, make_server
from socketserver import ThreadingMixIn


class Request:
    def __init__(self, environ: dict[str, Any]):
        self.environ = environ
        self.method = environ["REQUEST_METHOD"]
        self.path = environ["PATH_INFO"]
        self.content_type = environ.get("CONTENT_TYPE", "")
        self.path_params: dict[str, str] = {}
        try:
            length = int(environ.get("CONTENT_LENGTH") or 0)
        except ValueError:
            length = 0
        self.body = environ["wsgi.input"].read(length) if length else b""

    def json(self) -> Any:
        return json.loads(self.body.decode("utf-8"))

    @property
    def query(self) -> dict[str, str]:
        """Parsed query string (last value wins per key)."""
        from urllib.parse import parse_qsl

        return dict(parse_qsl(self.environ.get("QUERY_STRING", "")))

    def files(self) -> dict[str, tuple[str, bytes]]:
        """Parse multipart/form-data -> {field_name: (filename, content)}.

        Content is delimited EXACTLY by ``\\r\\n--boundary`` (RFC 2046): a
        naive ``strip(b"\\r\\n")`` would also remove the payload's own
        trailing CR/LF bytes, silently truncating binary uploads.
        """
        m = re.search(r"boundary=([^;]+)", self.content_type)
        if not m:
            return {}
        marker = b"--" + m.group(1).strip('"').encode()
        pieces = self.body.split(b"\r\n" + marker)
        if pieces and pieces[0].startswith(marker):   # no preamble
            pieces[0] = pieces[0][len(marker):]
        out: dict[str, tuple[str, bytes]] = {}
        for piece in pieces:
            if piece.startswith(b"--"):               # closing delimiter
                continue
            if piece.startswith(b"\r\n"):
                piece = piece[2:]
            if b"\r\n\r\n" not in piece:
                continue
            header_blob, content = piece.split(b"\r\n\r\n", 1)
            headers = header_blob.decode("utf-8", "replace")
            # (?<![-\w]) so 'filename="..."' cannot satisfy the name lookup
            # when a client emits filename before name
            name_m = re.search(r'(?<![-\w])name="([^"]*)"', headers)
            file_m = re.search(r'filename="([^"]*)"', headers)
            if name_m:
                out[name_m.group(1)] = (file_m.group(1) if file_m else "", content)
        return out


class Response:
    def __init__(self, body: bytes | str, status: int = 200,
                 content_type: str = "text/plain; charset=utf-8",
                 headers: list[tuple[str, str]] | None = None):
        self.body = body.encode() if isinstance(body, str) else body
        self.status = status
        self.content_type = content_type
        self.headers = headers or []


class JSONResponse(Response):
    def __init__(self, data: Any, status: int = 200):
        super().__init__(json.dumps(data), status, "application/json")


class StreamingResponse(Response):
    """Response whose body is produced incrementally by an iterator of bytes
    (the stdlib analog of ``fastapi.responses.StreamingResponse``).

    Enables long-lived streams - e.g. ``multipart/x-mixed-replace`` MJPEG
    video - where the body length is unknown up front.  No ``Content-Length``
    is sent; the stream ends when the iterator is exhausted and the
    connection closes (browsers accept this for multipart streams).  If the
    iterator is a generator, the server calls ``close()`` on client
    disconnect, so ``finally`` blocks in the producer run for cleanup."""

    def __init__(self, body_iter, status: int = 200,
                 content_type: str = "application/octet-stream",
                 headers: list[tuple[str, str]] | None = None):
        super().__init__(b"", status, content_type, headers)
        self.body_iter = body_iter


class HTTPError(Exception):
    def __init__(self, status: int, detail: str):
        self.status = status
        self.detail = detail


_STATUS_TEXT = {200: "OK", 204: "No Content", 400: "Bad Request",
                404: "Not Found", 405: "Method Not Allowed",
                413: "Payload Too Large", 500: "Internal Server Error"}


class App:
    """Route table + WSGI callable.  Path params use ``{name}`` segments."""

    def __init__(self) -> None:
        self._routes: list[tuple[str, re.Pattern, Callable[[Request], Response]]] = []

    def route(self, method: str, pattern: str):
        regex = re.compile(
            "^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern) + "$")

        def deco(fn):
            self._routes.append((method.upper(), regex, fn))
            return fn

        return deco

    def get(self, pattern: str):
        return self.route("GET", pattern)

    def post(self, pattern: str):
        return self.route("POST", pattern)

    def __call__(self, environ, start_response):
        req = Request(environ)
        try:
            resp = self._dispatch(req)
        except HTTPError as e:
            resp = JSONResponse({"detail": e.detail}, e.status)
        except Exception as e:  # pragma: no cover - defensive 500
            from rtmodt_tpu_torch.utils.logging import logger

            logger.exception(f"{req.method} {req.path} failed")
            resp = JSONResponse({"detail": f"internal error: {e}"}, 500)
        status_line = f"{resp.status} {_STATUS_TEXT.get(resp.status, 'Unknown')}"
        if isinstance(resp, StreamingResponse):
            # no Content-Length: the body is open-ended; wsgiref switches to
            # connection-close delimiting and closes the iterator (running
            # generator ``finally`` blocks) if the client goes away
            headers = [("Content-Type", resp.content_type),
                       ("Access-Control-Allow-Origin", "*"),
                       *resp.headers]
            start_response(status_line, headers)
            return resp.body_iter
        headers = [("Content-Type", resp.content_type),
                   ("Content-Length", str(len(resp.body))),
                   ("Access-Control-Allow-Origin", "*"),  # CORS-allow-all, as reference
                   *resp.headers]
        start_response(status_line, headers)
        return [resp.body]

    def _dispatch(self, req: Request) -> Response:
        path_matched = False
        allowed: list[str] = []
        for method, regex, fn in self._routes:
            m = regex.match(req.path)
            if m:
                path_matched = True
                allowed.append(method)
                if method == req.method:
                    req.path_params = m.groupdict()
                    return fn(req)
        if req.method == "OPTIONS" and path_matched:
            # CORS preflight: without this, cross-origin JSON POSTs are
            # blocked by the browser despite Allow-Origin on real responses
            return Response(b"", 204, headers=[
                ("Access-Control-Allow-Methods", ", ".join(allowed + ["OPTIONS"])),
                ("Access-Control-Allow-Headers", "Content-Type"),
            ])
        raise HTTPError(405 if path_matched else 404,
                        "method not allowed" if path_matched else "not found")


def static_response(file_path: str) -> Response:
    try:
        with open(file_path, "rb") as f:
            data = f.read()
    except (FileNotFoundError, IsADirectoryError):
        raise HTTPError(404, "file not found")
    ctype = mimetypes.guess_type(file_path)[0] or "application/octet-stream"
    return Response(data, 200, ctype)


class _ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
    daemon_threads = True


class _QuietHandler(WSGIRequestHandler):
    def log_message(self, fmt, *args):  # route access logs through our logger
        from rtmodt_tpu_torch.utils.logging import logger

        logger.debug(f"{self.address_string()} {fmt % args}")


def run_server(app: App, host: str = "0.0.0.0", port: int = 8000) -> None:
    srv = make_server(host, port, app, server_class=_ThreadingWSGIServer,
                      handler_class=_QuietHandler)
    srv.serve_forever()


class TestClient:
    """In-process WSGI client (stdlib analog of fastapi.testclient)."""

    def __init__(self, app: App):
        self.app = app

    def _call(self, method: str, path: str, body: bytes = b"",
              content_type: str = "") -> "TestResponse":
        path, _, qs = path.partition("?")
        environ = {
            "REQUEST_METHOD": method,
            "PATH_INFO": path,
            "QUERY_STRING": qs,
            "CONTENT_TYPE": content_type,
            "CONTENT_LENGTH": str(len(body)),
            "wsgi.input": io.BytesIO(body),
        }
        captured: dict[str, Any] = {}

        def start_response(status, headers):
            captured["status"] = int(status.split()[0])
            captured["headers"] = headers

        chunks = self.app(environ, start_response)
        return TestResponse(captured["status"], dict(captured["headers"]),
                            b"".join(chunks))

    def get(self, path: str) -> "TestResponse":
        return self._call("GET", path)

    def post(self, path: str, json_body: Any = None,
             files: dict[str, tuple[str, bytes, str]] | None = None) -> "TestResponse":
        if json_body is not None:
            return self._call("POST", path, json.dumps(json_body).encode(),
                              "application/json")
        if files:
            boundary = "rtmodtboundary123"
            parts = []
            for name, (filename, content, ctype) in files.items():
                parts.append(
                    f'--{boundary}\r\nContent-Disposition: form-data; '
                    f'name="{name}"; filename="{filename}"\r\n'
                    f"Content-Type: {ctype}\r\n\r\n".encode() + content + b"\r\n")
            body = b"".join(parts) + f"--{boundary}--\r\n".encode()
            return self._call("POST", path, body,
                              f"multipart/form-data; boundary={boundary}")
        return self._call("POST", path)


class TestResponse:
    def __init__(self, status_code: int, headers: dict[str, str], content: bytes):
        self.status_code = status_code
        self.headers = headers
        self.content = content

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", "replace")

    def json(self) -> Any:
        return json.loads(self.content)
