"""Shared HTTP + SSE plumbing of the remote-API providers (a copy of
``llm_consensus_tpu/providers/http_sse.py``).

The three remote clients (providers/openai.py, anthropic.py, google.py)
share one shape: POST JSON, a non-2xx status is an error carrying the body,
and a streamed answer is a line loop over the response body keeping the
``data: `` SSE payloads. This module holds that shape once
(:class:`RemoteProvider`); each provider supplies its endpoint, headers,
request body and event extraction.

Requests honor the run's cancellation context: the socket timeout is the
context's remaining time (60 s without a deadline), and ``http.client``
opens the connection object before the request is sent, so a cancel can
abort any phase (connect, waiting for headers, reading the body) by closing
the socket from the ``ctx.on_done`` hook.

Transient failures (connection errors, a mid-body reset, statuses 408, 409,
429 and 5xx) retry with exponential backoff: ``retries`` more attempts
(default 2) after ``backoff * 2**n`` seconds (default 0.5), waiting on the
context; the CLI takes both from ``LLMC_HTTP_RETRIES`` and
``LLMC_HTTP_BACKOFF``. A streamed answer retries only before its first
chunk reached the caller. The fault plan's ``sse`` site
(``sse_reset@chunk=N``) replaces the Nth SSE data event of the process with
a mid-stream reset.
"""

from __future__ import annotations

import http.client
import json
import os
import time
import urllib.parse
from typing import Callable, Iterator, Optional

from llm_consensus_tpu_torch import faults, obs
from llm_consensus_tpu_torch.providers.base import Provider, Request, Response, StreamCallback
from llm_consensus_tpu_torch.utils.context import Context

DEFAULT_TIMEOUT_S = 60.0  # connection-level default without a deadline
DEFAULT_RETRIES = 2
DEFAULT_BACKOFF_S = 0.5

# Transient statuses: timeout, conflict, rate limit, server errors.
RETRYABLE_STATUS = frozenset({408, 409, 429, 500, 502, 503, 504})


class TransientHTTPError(RuntimeError):
    """A connection-phase or mid-transfer failure worth retrying."""


class HTTPError(RuntimeError):
    """Non-2xx API response, carrying status and (truncated) body."""

    def __init__(self, status: int, body: str):
        self.status = status
        self.body = body
        super().__init__(f"API request failed with status {status}: {body[:500]}")


def _retryable(err: Exception) -> bool:
    if isinstance(err, HTTPError):
        return err.status in RETRYABLE_STATUS
    return isinstance(err, TransientHTTPError)


def _with_retries(ctx: Context, fn, retries: int, backoff: float, delivered=None):
    """Run ``fn`` with exponential-backoff retries on transient failures.
    ``delivered`` (when given) vetoes a retry once output reached the
    caller: a restart would emit content twice. Cancellation
    (``Cancelled``, ``DeadlineExceeded``: not RuntimeErrors) always
    escapes."""
    attempts = 1 + max(0, retries)
    for attempt in range(attempts):
        try:
            return fn()
        except (HTTPError, TransientHTTPError) as err:
            if ((delivered is not None and delivered()) or attempt == attempts - 1
                    or not _retryable(err)):
                raise
            if not ctx.sleep(backoff * (2 ** attempt)):
                ctx.raise_if_done()
    raise AssertionError("unreachable")


def _socket_timeout(ctx: Context) -> float:
    rem = ctx.remaining()
    if rem is None:
        return DEFAULT_TIMEOUT_S
    return max(0.001, rem)


def _connect(ctx: Context, url: str, headers: dict[str, str], body: dict,
             accept: Optional[str]):
    """Open a connection, send the POST, return (conn, resp, unsubscribe).
    The ``ctx.on_done`` hook closes the connection, so a cancel interrupts
    every blocking phase; the blocked read then raises an OSError, which
    callers turn back into the context's error."""
    ctx.raise_if_done()
    parsed = urllib.parse.urlsplit(url)
    conn_cls = (http.client.HTTPSConnection if parsed.scheme == "https"
                else http.client.HTTPConnection)
    conn = conn_cls(parsed.netloc, timeout=_socket_timeout(ctx))
    unsubscribe = ctx.on_done(conn.close)
    path = parsed.path + (f"?{parsed.query}" if parsed.query else "")
    all_headers = {"Content-Type": "application/json", **headers}
    if accept:
        all_headers["Accept"] = accept
    try:
        conn.request("POST", path, body=json.dumps(body).encode("utf-8"), headers=all_headers)
        resp = conn.getresponse()
    except (http.client.HTTPException, ValueError, OSError) as err:
        unsubscribe()
        conn.close()
        ctx.raise_if_done()  # closed by cancellation: the context's error
        raise TransientHTTPError(f"request failed: {err}") from None
    if not 200 <= resp.status < 300:
        status = resp.status
        body_text = resp.read().decode("utf-8", "replace")
        unsubscribe()
        conn.close()
        raise HTTPError(status, body_text)
    return conn, resp, unsubscribe


def post_json(ctx: Context, url: str, headers: dict[str, str], body: dict, *,
              retries: int = DEFAULT_RETRIES, backoff: float = DEFAULT_BACKOFF_S) -> dict:
    """POST a JSON body and return the parsed JSON response, retrying
    transient failures."""
    return _with_retries(ctx, lambda: _post_json_once(ctx, url, headers, body),
                         retries, backoff)


def _post_json_once(ctx: Context, url: str, headers: dict[str, str], body: dict) -> dict:
    conn, resp, unsubscribe = _connect(ctx, url, headers, body, accept=None)
    try:
        raw = resp.read()
        ctx.raise_if_done()  # a cancelled read can return b""
        return json.loads(raw.decode("utf-8"))
    except json.JSONDecodeError as err:
        raise RuntimeError(f"invalid JSON response: {err}") from None
    except (ValueError, OSError, http.client.HTTPException) as err:
        ctx.raise_if_done()
        # Nothing reached the caller: a mid-body reset is as retryable as
        # a connect failure.
        raise TransientHTTPError(f"reading response failed: {err}") from None
    finally:
        unsubscribe()
        conn.close()


def post_sse(ctx: Context, url: str, headers: dict[str, str], body: dict) -> Iterator[str]:
    """POST a JSON body and yield each SSE ``data:`` payload string, until
    the stream ends or a ``[DONE]`` sentinel. A cancellation mid-stream
    always raises: closing the socket errors the blocked read or ends the
    iteration early, and both paths check the context again."""
    obs_r = obs.recorder()  # one None check per event when off
    fault_plan = faults.plan()  # the same
    conn, resp, unsubscribe = _connect(ctx, url, headers, body, accept="text/event-stream")
    saw_data = False
    try:
        for raw in resp:
            ctx.raise_if_done()
            line = raw.decode("utf-8", "replace").strip()
            if not line.startswith("data: "):
                continue  # comments, event: lines, blanks
            data = line[len("data: "):]
            if data == "[DONE]":
                return
            saw_data = True
            if obs_r is not None:
                # The remote provider's streaming cadence on the timeline.
                obs_r.instant("sse_chunk", tid="sse", bytes=len(data))
            if fault_plan is not None:
                # sse_reset@chunk=N: the Nth data event at this site (one
                # process-wide counter across all streams) becomes a
                # mid-transfer reset, the transient shape a dropped
                # connection has, so it rides the real retry machinery.
                fs = fault_plan.fire("sse")
                if fs is not None:
                    raise TransientHTTPError(f"injected mid-stream reset ({fs.kind})")
            yield data
        ctx.raise_if_done()  # a cancel can end the stream cleanly
        if not saw_data:
            # A connection torn down right after the headers reads as a
            # clean EOF: transient, not an empty answer.
            raise TransientHTTPError("stream ended before any data arrived")
    except (ValueError, OSError, http.client.HTTPException) as err:
        ctx.raise_if_done()
        # Mid-stream resets and short reads are transient; whether a retry
        # is safe is the consumer's call (it knows what it delivered).
        raise TransientHTTPError(f"stream failed: {err}") from None
    finally:
        unsubscribe()
        conn.close()


def stream_json_events(ctx: Context, url: str, headers: dict[str, str], body: dict,
                       extract: Callable[[dict], Optional[str]],
                       callback: Optional[Callable[[str], None]], *,
                       retries: int = DEFAULT_RETRIES,
                       backoff: float = DEFAULT_BACKOFF_S) -> str:
    """Drive an SSE stream, extracting a text delta per event (``extract``
    returns None to skip one; malformed events are skipped). Returns the
    whole content. Transient failures retry only while no chunk reached
    ``callback``."""
    parts: list[str] = []

    def attempt() -> str:
        parts.clear()
        for data in post_sse(ctx, url, headers, body):
            try:
                event = json.loads(data)
            except json.JSONDecodeError:
                continue
            chunk = extract(event)
            if chunk:
                parts.append(chunk)
                if callback is not None:
                    callback(chunk)
        return "".join(parts)

    return _with_retries(ctx, attempt, retries, backoff, delivered=lambda: bool(parts))


class RemoteProvider(Provider):
    """A remote API behind the Provider seam: the key from ``KEY_ENV``
    (required), the base URL from ``BASE_ENV`` or ``DEFAULT_BASE_URL`` (an
    argument wins over both), and ``retries``/``backoff`` for every call. A
    subclass gives its URL, headers, body and the text of a response and
    of a stream event."""

    name = ""
    KEY_ENV = ""
    BASE_ENV = ""
    DEFAULT_BASE_URL = ""

    def __init__(self, api_key: Optional[str] = None, base_url: Optional[str] = None, *,
                 retries: int = DEFAULT_RETRIES, backoff: float = DEFAULT_BACKOFF_S):
        key = api_key or os.environ.get(self.KEY_ENV, "")
        if not key:
            raise RuntimeError(f"{self.KEY_ENV} environment variable not set")
        self._key = key
        base = base_url or os.environ.get(self.BASE_ENV) or self.DEFAULT_BASE_URL
        self._base = base.rstrip("/")
        self._retry = {"retries": retries, "backoff": backoff}

    def _url(self, req: Request, stream: bool) -> str:
        raise NotImplementedError

    def _headers(self) -> dict[str, str]:
        return {}

    def _body(self, req: Request, stream: bool) -> dict:
        raise NotImplementedError

    @staticmethod
    def _text(data: dict) -> str:
        """The text of a whole (non-streamed) response."""
        raise NotImplementedError

    @staticmethod
    def _delta(event: dict) -> Optional[str]:
        """The text chunk of one stream event, or None to skip it."""
        raise NotImplementedError

    def query(self, ctx: Context, req: Request) -> Response:
        start = time.monotonic()
        data = post_json(ctx, self._url(req, False), self._headers(), self._body(req, False),
                         **self._retry)
        return Response(req.model, self._text(data), self.name,
                        (time.monotonic() - start) * 1000)

    def query_stream(self, ctx: Context, req: Request,
                     callback: Optional[StreamCallback]) -> Response:
        start = time.monotonic()
        content = stream_json_events(ctx, self._url(req, True), self._headers(),
                                     self._body(req, True), self._delta, callback,
                                     **self._retry)
        return Response(req.model, content, self.name, (time.monotonic() - start) * 1000)
