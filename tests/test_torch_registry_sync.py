"""The port's model-registry-sync tool (``llm_consensus_tpu_torch/tools/
registry_sync.py``), held to ``tests/test_registry_sync.py`` and
``tests/test_registry_sync_shapes.py`` case by case: the real fetchers run
against a local ``http.server`` (no network). Beside them: the port's
``local`` records equal the JAX tool's field by field apart from the id
prefix (``gpu:`` for ``tpu:``), and the shipped ``models.json`` is in sync
with the port's presets.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from llm_consensus_tpu.tools import registry_sync as jax_sync
from llm_consensus_tpu_torch.tools.registry_sync import (
    ModelRecord,
    SourceError,
    fetch_local_models,
    fetch_openai_models,
    fetch_openrouter_models,
    main,
    render,
    sync,
)

OPENAI_PAYLOAD = {
    "object": "list",
    "data": [
        {"id": "gpt-b", "object": "model", "owned_by": "openai"},
        {"id": "gpt-a", "object": "model", "owned_by": "openai"},
    ],
}

OPENROUTER_PAYLOAD = {
    "data": [
        {
            "id": "meta/llama-3-8b",
            "name": "Llama 3 8B",
            "context_length": 8192,
            "pricing": {"prompt": "0.0000001", "completion": 0.0000002},
        },
        {"id": "no/extras"},
        {"id": None, "name": "null id — must be dropped, not become 'None'"},
        {"id": "junk/nonfinite", "name": None, "context_length": float("inf")},
    ]
}


class _Handler(BaseHTTPRequestHandler):
    behavior = "ok"  # ok | error | malformed

    def do_GET(self):  # noqa: N802 (stdlib API)
        if self.behavior == "error":
            self.send_response(500)
            self.end_headers()
            self.wfile.write(b"boom")
            return
        if self.behavior == "malformed":
            body = b"not json {"
        elif "openrouter" in self.path or self.headers.get("X-Flavor") == "openrouter":
            body = json.dumps(OPENROUTER_PAYLOAD).encode()
        else:
            body = json.dumps(OPENAI_PAYLOAD).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):  # silence test output
        pass


@pytest.fixture
def server():
    class H(_Handler):
        pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield H, f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()


def test_openai_fetch_and_normalize(server):
    _, base = server
    recs = fetch_openai_models(base_url=base, api_key="k")
    assert [r.id for r in recs] == ["gpt-b", "gpt-a"]
    assert all(r.source == "openai" for r in recs)
    assert recs[0].raw["owned_by"] == "openai"


def test_openai_requires_key(server, monkeypatch):
    _, base = server
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    with pytest.raises(SourceError, match="OPENAI_API_KEY"):
        fetch_openai_models(base_url=base)


def test_openrouter_fetch_normalizes_context_and_pricing(server):
    _, base = server
    recs = fetch_openrouter_models(base_url=base + "/openrouter", api_key="")
    assert recs[0].context_length == 8192
    # pricing values normalized to strings regardless of feed type
    assert recs[0].pricing == {"prompt": "0.0000001", "completion": "2e-07"}
    assert recs[1].context_length is None and recs[1].pricing is None


def test_openrouter_junk_entries_are_sanitized(server):
    """Null ids are dropped (never the literal "None"); non-finite
    context_length (json accepts Infinity/NaN) degrades to None instead of
    raising past sync()'s per-source isolation."""
    _, base = server
    recs = fetch_openrouter_models(base_url=base + "/openrouter", api_key="")
    assert [r.id for r in recs] == ["meta/llama-3-8b", "no/extras", "junk/nonfinite"]
    junk = recs[2]
    assert junk.context_length is None
    assert junk.name == ""


def test_http_error_is_source_error(server):
    H, base = server
    H.behavior = "error"
    with pytest.raises(SourceError, match="status 500"):
        fetch_openai_models(base_url=base, api_key="k")


def test_malformed_json_is_source_error(server):
    H, base = server
    H.behavior = "malformed"
    with pytest.raises(SourceError, match="invalid JSON"):
        fetch_openai_models(base_url=base, api_key="k")


def test_local_source_covers_every_preset():
    from llm_consensus_tpu_torch.models import MODEL_PRESETS

    recs = fetch_local_models()
    assert {r.name for r in recs} == set(MODEL_PRESETS)
    assert all(r.id.startswith("gpu:") and r.source == "local" for r in recs)
    assert all(r.context_length and r.raw["n_params"] > 0 for r in recs)


def test_sync_sorts_and_tolerates_partial_failure():
    def ok():
        return [ModelRecord("zz", "b"), ModelRecord("zz", "a")]

    def bad():
        raise SourceError("down")

    records, warnings = sync({"bad": bad, "zz": ok, "local": fetch_local_models})
    assert warnings == ["bad: down"]
    keys = [(r.source, r.id) for r in records]
    assert keys == sorted(keys)  # stable (source, id) ordering
    assert ("zz", "a") in keys and ("zz", "b") in keys


def test_render_raw_toggle():
    rec = ModelRecord("s", "m", raw={"secret": 1})
    assert "secret" not in render([rec], include_raw=False)
    assert "secret" in render([rec], include_raw=True)


def test_main_writes_file_and_partial_failure_exit_codes(server, tmp_path, capsys):
    _, base = server
    out = tmp_path / "models.json"
    # Remote source down (unused port), local healthy → exit 0 + warning.
    rc = main(
        [
            "--out", str(out),
            "--no-openrouter",
            "--openai-base-url", "http://127.0.0.1:9",
            "--timeout", "0.2",
        ]
    )
    assert rc == 0
    assert "warning: openai" in capsys.readouterr().err
    data = json.loads(out.read_text())
    assert all(r["source"] == "local" for r in data)

    # Every enabled source down, zero records → exit 1.
    rc = main(
        [
            "--no-local",
            "--no-openrouter",
            "--openai-base-url", "http://127.0.0.1:9",
            "--timeout", "0.2",
        ]
    )
    assert rc == 1


def test_shipped_catalog_snapshot_is_in_sync():
    """The port's providers/models/models.json must match what its local
    source generates today — regenerate with
    `python -m llm_consensus_tpu_torch.tools.registry_sync --no-openai
    --no-openrouter --raw --out llm_consensus_tpu_torch/providers/models/models.json`
    whenever a model preset changes."""
    import os

    import llm_consensus_tpu_torch
    from llm_consensus_tpu_torch.tools.registry_sync import fetch_local_models, render

    path = os.path.join(
        os.path.dirname(llm_consensus_tpu_torch.__file__), "providers", "models",
        "models.json",
    )
    with open(path, encoding="utf-8") as f:
        shipped = json.load(f)
    records = sorted(fetch_local_models(), key=lambda r: (r.source, r.id))
    expected = json.loads(render(records, include_raw=True))
    assert shipped == expected


def test_local_records_equal_the_jax_tools_apart_from_the_id_prefix():
    """Same presets, same fields: only the CLI scheme differs (the port's
    CLI accepts ``gpu:<preset>``, the JAX one ``tpu:<preset>``)."""
    port = [r.to_json(include_raw=True) for r in fetch_local_models()]
    ref = [r.to_json(include_raw=True) for r in jax_sync.fetch_local_models()]
    assert len(port) == len(ref)
    for p, j in zip(port, ref):
        assert p["id"] == "gpu:" + j["id"].removeprefix("tpu:")
        assert {k: v for k, v in p.items() if k != "id"} == {
            k: v for k, v in j.items() if k != "id"}


# ---------------------------------------------------------------------------
# hostile payload shapes (tests/test_registry_sync_shapes.py): they degrade to
# SourceError (warn-and-continue), never crash the tool


def _serve_body(body: bytes):
    class H(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            self.send_response(200)
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.mark.parametrize(
    "body,match",
    [
        (b"[]", "expected JSON object"),
        (b'["gpt-a"]', "expected JSON object"),
        (b'{"data": "nope"}', "'data' is not a list"),
    ],
)
def test_non_object_payloads_are_source_errors(body, match):
    srv, base = _serve_body(body)
    try:
        with pytest.raises(SourceError, match=match):
            fetch_openai_models(base_url=base, api_key="k")
    finally:
        srv.shutdown()
        srv.server_close()


def test_non_dict_items_in_data_are_skipped():
    srv, base = _serve_body(json.dumps({"data": ["junk", 7, {"id": "gpt-ok"}]}).encode())
    try:
        recs = fetch_openai_models(base_url=base, api_key="k")
        assert [r.id for r in recs] == ["gpt-ok"]
    finally:
        srv.shutdown()
        srv.server_close()
