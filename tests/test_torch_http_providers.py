"""The port's remote HTTP providers against a local fake SSE server: the
19 cases of tests/test_http_providers.py (auth headers, request bodies,
stream parsing, whole-response extraction, errors, the context's cancel
and deadline, retries), with the retry settings passed as the providers'
arguments (the CLI reads ``LLMC_HTTP_RETRIES``/``LLMC_HTTP_BACKOFF`` in
``utils/knobs.py``)."""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

from llm_consensus_tpu_torch.providers import Request
from llm_consensus_tpu_torch.providers.anthropic import AnthropicProvider
from llm_consensus_tpu_torch.providers.google import GoogleProvider
from llm_consensus_tpu_torch.providers.http_sse import HTTPError, post_json, stream_json_events
from llm_consensus_tpu_torch.providers.openai import OpenAIProvider
from llm_consensus_tpu_torch.utils.context import Context


class FakeAPI(BaseHTTPRequestHandler):
    """Scriptable endpoint: a test sets ``respond(path, body) -> (status,
    payload)``; a list payload is sent as SSE lines."""

    respond = None
    requests: list = []

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(length) or b"{}")
        FakeAPI.requests.append({"path": self.path, "body": body,
                                 "headers": {k.lower(): v for k, v in self.headers.items()}})
        status, payload = FakeAPI.respond(self.path, body)
        self.send_response(status)
        is_sse = isinstance(payload, list)
        self.send_header("Content-Type", "text/event-stream" if is_sse else "application/json")
        self.end_headers()
        if is_sse:
            for line in payload:
                self.wfile.write((line + "\n").encode())
        else:
            self.wfile.write(json.dumps(payload).encode())

    def log_message(self, *args):
        pass


@pytest.fixture()
def fake_api():
    server = HTTPServer(("127.0.0.1", 0), FakeAPI)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    FakeAPI.requests = []
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    thread.join(timeout=10)
    assert not thread.is_alive()


CTX = Context.background


# -- OpenAI ---------------------------------------------------------------------------


def test_openai_requires_api_key(monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    with pytest.raises(RuntimeError, match="OPENAI_API_KEY"):
        OpenAIProvider()


def test_openai_query(fake_api):
    FakeAPI.respond = lambda path, body: (200, {"output": [
        {"content": [{"type": "output_text", "text": "four"}]},
        {"content": [{"type": "reasoning", "text": "skip"},
                     {"type": "output_text", "text": "!"}]},
    ]})
    p = OpenAIProvider(api_key="sk-test", base_url=fake_api)
    resp = p.query(CTX(), Request(model="gpt-x", prompt="2+2?"))
    assert resp.content == "four!"
    assert resp.provider == "openai"
    assert resp.latency_ms >= 0
    req = FakeAPI.requests[0]
    assert req["path"] == "/responses"
    assert req["headers"]["authorization"] == "Bearer sk-test"
    assert req["body"] == {"model": "gpt-x", "input": "2+2?"}


def test_openai_stream(fake_api):
    FakeAPI.respond = lambda path, body: (200, [
        'data: {"type":"response.created"}',
        'data: {"type":"response.output_text.delta","delta":"fo"}',
        ": comment to skip",
        'data: {"type":"response.output_text.delta","delta":"ur"}',
        "data: not-json-is-skipped",
        "data: [DONE]",
        'data: {"type":"response.output_text.delta","delta":"IGNORED"}',
    ])
    p = OpenAIProvider(api_key="sk-test", base_url=fake_api)
    chunks = []
    resp = p.query_stream(CTX(), Request(model="gpt-x", prompt="2+2?"), chunks.append)
    assert chunks == ["fo", "ur"]
    assert resp.content == "four"
    assert FakeAPI.requests[0]["body"]["stream"] is True


def test_openai_http_error_includes_body(fake_api):
    FakeAPI.respond = lambda path, body: (401, {"error": "bad key"})
    p = OpenAIProvider(api_key="sk-bad", base_url=fake_api)
    with pytest.raises(HTTPError, match="status 401") as err:
        p.query(CTX(), Request(model="m", prompt="p"))
    assert "bad key" in err.value.body


# -- Anthropic ------------------------------------------------------------------------


def test_anthropic_requires_api_key(monkeypatch):
    monkeypatch.delenv("ANTHROPIC_API_KEY", raising=False)
    with pytest.raises(RuntimeError, match="ANTHROPIC_API_KEY"):
        AnthropicProvider()


def test_anthropic_query(fake_api):
    FakeAPI.respond = lambda path, body: (200, {"content": [
        {"type": "text", "text": "hello"}, {"type": "text", "text": " there"}]})
    p = AnthropicProvider(api_key="ak-test", base_url=fake_api)
    resp = p.query(CTX(), Request(model="claude-x", prompt="hi"))
    assert resp.content == "hello there"
    assert resp.provider == "anthropic"
    req = FakeAPI.requests[0]
    assert req["path"] == "/messages"
    assert req["headers"]["x-api-key"] == "ak-test"
    assert req["headers"]["anthropic-version"] == "2023-06-01"
    assert req["body"]["max_tokens"] == 4096
    assert req["body"]["messages"] == [{"role": "user", "content": "hi"}]


def test_anthropic_stream(fake_api):
    FakeAPI.respond = lambda path, body: (200, [
        'data: {"type":"message_start"}',
        'data: {"type":"content_block_delta","delta":{"type":"text_delta","text":"he"}}',
        'data: {"type":"content_block_delta","delta":{"type":"input_json_delta",'
        '"partial_json":"x"}}',
        'data: {"type":"content_block_delta","delta":{"type":"text_delta","text":"llo"}}',
        'data: {"type":"message_stop"}',
    ])
    p = AnthropicProvider(api_key="ak", base_url=fake_api)
    chunks = []
    resp = p.query_stream(CTX(), Request(model="claude-x", prompt="hi"), chunks.append)
    assert chunks == ["he", "llo"]
    assert resp.content == "hello"


# -- Google ---------------------------------------------------------------------------


def test_google_requires_api_key(monkeypatch):
    monkeypatch.delenv("GOOGLE_API_KEY", raising=False)
    with pytest.raises(RuntimeError, match="GOOGLE_API_KEY"):
        GoogleProvider()


def test_google_query_key_in_url_model_in_path(fake_api):
    FakeAPI.respond = lambda path, body: (
        200, {"candidates": [{"content": {"parts": [{"text": "bonjour"}]}}]})
    p = GoogleProvider(api_key="gk-test", base_url=fake_api)
    resp = p.query(CTX(), Request(model="gemini-x", prompt="hi"))
    assert resp.content == "bonjour"
    assert resp.provider == "google"
    req = FakeAPI.requests[0]
    assert req["path"] == "/models/gemini-x:generateContent?key=gk-test"
    assert req["body"] == {"contents": [{"parts": [{"text": "hi"}]}]}


def test_google_stream_full_response_chunks(fake_api):
    FakeAPI.respond = lambda path, body: (200, [
        'data: {"candidates":[{"content":{"parts":[{"text":"bon"}]}}]}',
        'data: {"candidates":[]}',
        'data: {"candidates":[{"content":{"parts":[{"text":"jour"}]}}]}',
    ])
    p = GoogleProvider(api_key="gk", base_url=fake_api)
    chunks = []
    resp = p.query_stream(CTX(), Request(model="gemini-x", prompt="hi"), chunks.append)
    assert chunks == ["bon", "jour"]
    assert resp.content == "bonjour"
    assert FakeAPI.requests[0]["path"].endswith(":streamGenerateContent?key=gk&alt=sse")


# -- shared behaviour -----------------------------------------------------------------


def test_cancelled_context_aborts_before_request(fake_api):
    FakeAPI.respond = lambda path, body: (200, {"content": []})
    p = AnthropicProvider(api_key="ak", base_url=fake_api)
    ctx = Context.background().with_cancel()
    ctx.cancel()
    with pytest.raises(Exception, match="context canceled"):
        p.query(ctx, Request(model="m", prompt="p"))
    assert FakeAPI.requests == []


def test_deadline_bounds_stream(fake_api):
    FakeAPI.respond = lambda path, body: (
        200, ['data: {"type":"content_block_delta","delta":{"type":"text_delta","text":"x"}}'] * 3)
    p = AnthropicProvider(api_key="ak", base_url=fake_api)
    ctx = Context.background().with_timeout(0.0001)
    time.sleep(0.01)
    with pytest.raises(Exception, match="deadline"):
        p.query_stream(ctx, Request(model="m", prompt="p"), None)


# -- retries with backoff ---------------------------------------------------------------


def test_post_json_retries_transient_5xx(fake_api):
    calls = {"n": 0}

    def respond(path, body):
        calls["n"] += 1
        if calls["n"] == 1:
            return 503, {"error": "overloaded"}
        return 200, {"ok": True}

    FakeAPI.respond = respond
    assert post_json(CTX(), f"{fake_api}/x", {}, {}, backoff=0) == {"ok": True}
    assert calls["n"] == 2


def test_post_json_does_not_retry_4xx(fake_api):
    calls = {"n": 0}

    def respond(path, body):
        calls["n"] += 1
        return 401, {"error": "bad key"}

    FakeAPI.respond = respond
    with pytest.raises(HTTPError):
        post_json(CTX(), f"{fake_api}/x", {}, {}, backoff=0)
    assert calls["n"] == 1


def test_post_json_gives_up_after_max_retries(fake_api):
    calls = {"n": 0}

    def respond(path, body):
        calls["n"] += 1
        return 503, {"error": "down"}

    FakeAPI.respond = respond
    with pytest.raises(HTTPError):
        post_json(CTX(), f"{fake_api}/x", {}, {}, retries=1, backoff=0)
    assert calls["n"] == 2  # the first attempt and 1 retry


def test_stream_retries_only_before_first_chunk(fake_api):
    calls = {"n": 0}

    def respond(path, body):
        calls["n"] += 1
        if calls["n"] == 1:
            return 429, {"error": "rate limited"}
        return 200, ['data: {"text": "hello"}', "data: [DONE]"]

    FakeAPI.respond = respond
    chunks = []
    out = stream_json_events(CTX(), f"{fake_api}/x", {}, {}, extract=lambda e: e.get("text"),
                             callback=chunks.append, backoff=0)
    assert out == "hello"
    assert chunks == ["hello"]
    assert calls["n"] == 2


def test_stream_retries_reset_after_headers(fake_api, monkeypatch):
    """A connection that dies after the 200 and the SSE headers, before any
    data line, is transient and retries."""
    calls = {"n": 0}

    def do_post(self):
        self.rfile.read(int(self.headers.get("Content-Length", 0)))
        calls["n"] += 1
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        if calls["n"] == 1:
            self.send_header("Content-Length", "1000")
            self.end_headers()
            self.wfile.flush()
            self.connection.close()  # reset before any data arrives
        else:
            self.end_headers()
            for line in ('data: {"text": "ok"}', "data: [DONE]"):
                self.wfile.write((line + "\n").encode())

    monkeypatch.setattr(FakeAPI, "do_POST", do_post)
    out = stream_json_events(CTX(), f"{fake_api}/x", {}, {}, extract=lambda e: e.get("text"),
                             callback=None, backoff=0)
    assert out == "ok"
    assert calls["n"] == 2


def test_malformed_retry_env_falls_back_to_defaults(monkeypatch):
    from llm_consensus_tpu.providers.http_sse import _backoff_s, _max_attempts
    from llm_consensus_tpu_torch.utils.knobs import http_settings

    monkeypatch.setenv("LLMC_HTTP_RETRIES", "two")
    monkeypatch.setenv("LLMC_HTTP_BACKOFF", "0,5")
    assert http_settings() == {"retries": 2, "backoff": 0.5}
    assert 1 + http_settings()["retries"] == _max_attempts() == 3
    assert http_settings()["backoff"] == _backoff_s(0)
    monkeypatch.setenv("LLMC_HTTP_RETRIES", "0")
    monkeypatch.setenv("LLMC_HTTP_BACKOFF", "0.25")
    assert http_settings() == {"retries": 0, "backoff": 0.25}


def test_system_prompt_maps_to_native_fields(fake_api, monkeypatch):
    monkeypatch.setenv("OPENAI_API_KEY", "k")
    monkeypatch.setenv("ANTHROPIC_API_KEY", "k")
    monkeypatch.setenv("GOOGLE_API_KEY", "k")
    FakeAPI.respond = lambda path, body: (200, {
        "output": [{"content": [{"type": "output_text", "text": "ok"}]}],
        "content": [{"type": "text", "text": "ok"}],
        "candidates": [{"content": {"parts": [{"text": "ok"}]}}],
    })
    req = Request(model="m", prompt="p", system="sys!")

    OpenAIProvider(base_url=fake_api).query(CTX(), req)
    assert FakeAPI.requests[-1]["body"]["instructions"] == "sys!"

    AnthropicProvider(base_url=fake_api).query(CTX(), req)
    assert FakeAPI.requests[-1]["body"]["system"] == "sys!"

    GoogleProvider(base_url=fake_api).query(CTX(), req)
    assert FakeAPI.requests[-1]["body"]["systemInstruction"] == {"parts": [{"text": "sys!"}]}


# -- the catalog ----------------------------------------------------------------------


def test_remote_catalog_is_the_jax_one(monkeypatch):
    from llm_consensus_tpu.providers.registry import REMOTE_MODELS as JAX_MODELS
    from llm_consensus_tpu_torch.providers.registry import (
        REMOTE_MODELS, create_remote_provider, remote_registry)

    assert REMOTE_MODELS == JAX_MODELS
    for key in ("OPENAI_API_KEY", "ANTHROPIC_API_KEY", "GOOGLE_API_KEY"):
        monkeypatch.setenv(key, "k")
    for model, kind in REMOTE_MODELS.items():
        provider = create_remote_provider(model, retries=0, backoff=0)
        assert provider.name == kind
    reg = remote_registry(["gpt-5.2-2025-12-11", "claude-opus-4-5"], "gemini-3-pro-preview")
    assert reg.models() == sorted(["gpt-5.2-2025-12-11", "claude-opus-4-5",
                                   "gemini-3-pro-preview"])
    with pytest.raises(ValueError, match="unknown remote model"):
        create_remote_provider("gpt-0")
