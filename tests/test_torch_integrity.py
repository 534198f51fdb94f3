"""The port's integrity plane (llm_consensus_tpu_torch/integrity/) against
the JAX package's (mirrors the WAL, logits and counter cases of
tests/test_integrity.py).

  * **Checksums and digests**: ``crc32c``, the WAL frame, ``digest_bytes``,
    ``digest_array`` and ``canonical_digest`` equal the JAX functions' on
    the same bytes; ``digest_tree`` of a parameter tree is stable across
    builds from one seed and moves with one flipped bit.
  * **WAL**: every ``StreamJournal`` record is CRC32C-framed; a torn tail
    or a flipped bit truncates to the last good record on read, never
    parses wrong; the WAL files of the two packages' journals are
    byte-equal for the same stream and read back through either reader.
  * **Logits**: the finite-logit sentinel fails exactly the poisoned row
    (``nan_logits``) with a typed :class:`IntegrityError`; its neighbour
    emits the single-stream engine's tokens, and a clean run with the plane
    on gives the tokens of one without it.
"""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu import faults as jax_faults
from llm_consensus_tpu import integrity as jax_integrity
from llm_consensus_tpu import recovery as jax_recovery
from llm_consensus_tpu.engine import SamplingParams as JaxSampling
from llm_consensus_tpu_torch import faults, integrity, obs
from llm_consensus_tpu_torch.engine import Engine, SamplingParams
from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher
from llm_consensus_tpu_torch.faults import FaultPlan
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.recovery import StreamJournal, read_wal
from tests.test_torch_batcher import _engines

WAIT = 300


@pytest.fixture(autouse=True)
def _clean_planes(monkeypatch):
    """No fault plan, integrity plane, journal or recorder leaks between
    tests, in either package (they are process-wide)."""
    for knob in ("LLMC_INTEGRITY", "LLMC_FAULTS", "LLMC_JOURNAL"):
        monkeypatch.delenv(knob, raising=False)
    for mod in (faults, integrity, jax_faults, jax_integrity, jax_recovery):
        mod.reset()
    obs.reset()
    yield
    for mod in (faults, integrity, jax_faults, jax_integrity, jax_recovery):
        mod.reset()
    obs.reset()


def _arm():
    plane = integrity.IntegrityPlane()
    integrity.install(plane)
    return plane


# -- checksums and digests ----------------------------------------------------------------


@pytest.mark.parametrize("data", [b"", b"a", b"123456789", bytes(range(256)) * 3,
                                  "#finish=eos é".encode()])
def test_checksums_equal_the_jax_ones(data):
    assert integrity.crc32c(data) == jax_integrity.crc32c(data)
    assert integrity.crc32c(data, 0x1234) == jax_integrity.crc32c(data, 0x1234)
    assert integrity.digest_bytes(data, 7) == jax_integrity.digest_bytes(data, 7)
    assert integrity.crc32_str(data.decode("utf-8", "replace"), 3) == \
        jax_integrity.crc32_str(data.decode("utf-8", "replace"), 3)
    # The CRC32C check value of the standard test vector.
    assert integrity.crc32c(b"123456789") == 0xE3069283


@pytest.mark.parametrize("dtype", ["float32", "int8", "int32", "bfloat16"])
def test_digest_array_equals_the_jax_one(dtype):
    rng = np.random.default_rng(3)
    base = rng.standard_normal((4, 3, 5)).astype(np.float32) * 20
    jarr = jnp.asarray(base).astype(dtype)
    host = np.asarray(jarr)
    t = torch.from_numpy(np.asarray(jnp.asarray(base).astype(jnp.float32)))
    t = t.to(getattr(torch, dtype)) if dtype != "bfloat16" else t.to(torch.bfloat16)
    assert np.asarray(jarr).tobytes() == (
        t.view(torch.int16) if dtype == "bfloat16" else t).numpy().tobytes()
    want = jax_integrity.digest_array(jarr)
    assert integrity.digest_array(t) == want
    assert integrity.digest_array(host) == jax_integrity.digest_array(host)
    # dtype, shape and content all count.
    assert integrity.digest_array(t.reshape(12, 5)) != want
    flipped = t.clone().reshape(-1)
    flipped.view(torch.uint8)[0] ^= 1
    assert integrity.digest_array(flipped.reshape(t.shape)) != want


def test_canonical_digest_equals_the_jax_one():
    doc = {"b": [1, 2, {"z": None}], "a": "xé", "c": 1.5}
    assert integrity.canonical_digest(doc) == jax_integrity.canonical_digest(doc)
    assert integrity.canonical_digest(dict(reversed(doc.items()))) == \
        integrity.canonical_digest(doc)


def test_digest_tree_is_stable_per_seed_and_moves_with_a_bit():
    cfg = get_config("tiny-llama")
    a = Engine(cfg, device="cpu", dtype=torch.float32, max_seq=64).params
    b = Engine(cfg, device="cpu", dtype=torch.float32, max_seq=64).params
    c = Engine(cfg, device="cpu", dtype=torch.float32, max_seq=64, seed=1).params
    assert integrity.digest_tree(a) == integrity.digest_tree(b)
    assert integrity.digest_tree(a) != integrity.digest_tree(c)
    b["layers"]["wq"].view(torch.int32)[0, 0, 0] ^= 1
    assert integrity.digest_tree(a) != integrity.digest_tree(b)


# -- WAL framing ------------------------------------------------------------------------------


def test_wal_frame_roundtrip_and_refusal():
    line = integrity.frame_wal_line("#finish=eos")
    assert line == jax_integrity.frame_wal_line("#finish=eos")
    assert integrity.parse_wal_line(line) == "#finish=eos"
    # One flipped payload character: the CRC no longer reproduces.
    bad = line[:-1] + chr(ord(line[-1]) ^ 1)
    assert integrity.parse_wal_line(bad) is None
    assert integrity.parse_wal_line("nonsense") is None
    assert integrity.parse_wal_line("") is None


def _journal_one(path, tokens, finish="eos", journal_cls=StreamJournal, sampling=None):
    j = journal_cls(path=str(path))
    e = j.record([5, 6, 7], sampling or SamplingParams(max_new_tokens=8))
    for t in tokens:
        e.append(t)
    e.close(finish)
    (wal,) = glob.glob(os.path.join(str(path), "*.wal"))
    return wal


def test_wal_torn_tail_truncates_to_last_good(tmp_path):
    """torn_wal_tail mid-finish-record: read_wal keeps the header and every
    token, truncates the file to them, and a second read is clean."""
    plane = _arm()
    want = read_wal(_journal_one(tmp_path / "clean", [10, 11, 12]))
    assert want["finish"] == "eos" and not want["truncated"]

    faults.install(FaultPlan("torn_wal_tail", seed=1))
    torn = _journal_one(tmp_path / "torn", [10, 11, 12])
    doc = read_wal(torn)
    assert doc["truncated"]
    assert doc["finish"] is None  # the finish record was the torn tail
    assert doc["header"]["prompt_ids"] == want["header"]["prompt_ids"]
    assert doc["tokens"] == want["tokens"] == [10, 11, 12]
    assert plane.stats()["failures"].get("wal", 0) >= 1
    again = read_wal(torn)
    assert not again["truncated"]
    assert again["tokens"] == doc["tokens"] and again["header"] == doc["header"]


def test_wal_bit_flip_record_refused_not_misparsed(tmp_path):
    plane = _arm()
    faults.install(FaultPlan("bit_flip@surface=wal", seed=1))
    doc = read_wal(_journal_one(tmp_path, [42, 43]))
    assert doc["truncated"] and doc["finish"] is None
    assert doc["tokens"] == [42, 43]  # everything before the flip survives
    assert plane.stats()["failures"].get("wal", 0) >= 1
    assert plane.stats()["checks"].get("wal", 0) >= 3


@pytest.mark.parametrize("finish", ["eos", "length", "recovered"])
def test_wal_files_are_byte_equal_and_cross_read(tmp_path, finish):
    """The same stream journaled by each package: byte-equal WAL files,
    each read back by the other package's reader."""
    tokens = [104, 105, 33, 1000, 7]
    ours = _journal_one(tmp_path / "port", tokens, finish)
    theirs = _journal_one(tmp_path / "jax", tokens, finish, journal_cls=jax_recovery.StreamJournal,
                          sampling=JaxSampling(max_new_tokens=8))
    assert os.path.basename(ours) == os.path.basename(theirs)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    a, b = read_wal(theirs, repair=False), jax_recovery.read_wal(ours, repair=False)
    assert a == b
    assert a["tokens"] == tokens and a["finish"] == finish
    assert a["header"]["prompt_ids"] == [5, 6, 7]
    assert json.dumps(a["header"]["sampling"], sort_keys=True) == json.dumps(
        {"max_new_tokens": 8, "temperature": 0.0, "top_k": None, "top_p": None, "seed": 0,
         "ignore_eos": False}, sort_keys=True)


def test_torn_jax_wal_reads_through_the_port(tmp_path):
    jax_faults.install(jax_faults.FaultPlan("torn_wal_tail", seed=1))
    torn = _journal_one(tmp_path, [1, 2], journal_cls=jax_recovery.StreamJournal,
                        sampling=JaxSampling(max_new_tokens=8))
    doc = read_wal(torn)
    assert doc["truncated"] and doc["tokens"] == [1, 2] and doc["finish"] is None


# -- the finite-logit sentinel -------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LLMC_PREFIX_CACHE", "0")
        return _engines()


PROMPTS = ["the poisoned stream", "the innocent neighbor stream"]
S16 = SamplingParams(max_new_tokens=16, ignore_eos=True)


def _fresh(te):
    """An engine on ``te``'s weights, built now: engines bind the fault plan
    at construction."""
    return Engine(te.cfg, params=te.params, dtype=torch.float32, max_seq=te.max_seq,
                  stream_interval=te.stream_interval, device="cpu")


def _batched(engine, prompts, s=S16):
    b = ContinuousBatcher(_fresh(engine), max_batch=len(prompts))
    try:
        futs = [b.submit(p, s) for p in prompts]
        out = []
        for f in futs:
            try:
                out.append(f.result(timeout=WAIT))
            except Exception as exc:  # noqa: BLE001 — returned for the test to read
                out.append(exc)
        return out
    finally:
        b.close()


def test_nan_row_fails_typed_neighbors_byte_identical(pair):
    """nan_logits@row=0 poisons exactly one decode row: that stream fails
    with a typed IntegrityError (surface ``logits``); its slot neighbour
    finishes with the single-stream tokens of both packages' engines."""
    je, te = pair
    want = te.generate(PROMPTS[1], S16).token_ids
    assert want == je.generate(PROMPTS[1], JaxSampling(max_new_tokens=16,
                                                       ignore_eos=True)).token_ids
    plane = _arm()
    faults.install(FaultPlan("nan_logits@row=0", seed=5))
    r0, r1 = _batched(te, PROMPTS)
    assert isinstance(r0, integrity.IntegrityError) and r0.surface == "logits"
    assert r1.token_ids == want
    assert plane.stats()["failures"] == {"logits": 1}
    assert plane.stats()["checks"]["logits"] >= 2


def test_poisoned_row_emits_nothing_after_its_chunk(pair):
    """A row poisoned in its second chunk keeps what it emitted before and
    emits none of that chunk's tokens; its journal entry closes typed."""
    te = pair[1]

    class Kept(StreamJournal):
        entries: list = []

        def record(self, *a, **k):
            entry = super().record(*a, **k)
            self.entries.append(entry)
            return entry

    _arm()
    # The corrupt site counts decode dispatches: the 2nd chunk is poisoned.
    faults.install(FaultPlan("nan_logits@row=1@step=2", seed=5))
    j = Kept()
    b = ContinuousBatcher(_fresh(te), max_batch=2, journal=j)
    try:
        futs = [b.submit(p, S16) for p in PROMPTS]
        ok = futs[0].result(timeout=WAIT)
        with pytest.raises(integrity.IntegrityError):
            futs[1].result(timeout=WAIT)
    finally:
        b.close()
    # The prefill-sampled first token and the first chunk's 8 got out.
    poisoned = j.entries[1]
    assert poisoned.finish == "integrity"
    assert poisoned.tokens() == te.generate(PROMPTS[1], S16).token_ids[:1 + te.stream_interval]
    assert ok.token_ids == te.generate(PROMPTS[0], S16).token_ids
    assert j.entries[0].finish == "length"
    assert j.stats() == {"depth": 0, "opened": 2, "closed": 2}


def test_plane_on_clean_run_equals_plane_off(pair):
    te = pair[1]
    prompts = PROMPTS + ["a third stream", "and a fourth one here"]
    off = [r.token_ids for r in _batched(te, prompts)]
    plane = _arm()
    on = [r.token_ids for r in _batched(te, prompts)]
    assert on == off
    assert plane.stats()["failures_total"] == 0 and plane.stats()["checks"]["logits"] >= 2


def test_sentinel_off_adds_nothing_to_the_step(pair):
    """``sentinel=False`` returns the three outputs of the plain step and
    equal tokens; ``sentinel=True`` adds the all-true verdict."""
    from llm_consensus_tpu_torch.models.transformer import init_kv_cache

    te = pair[1]
    outs = []
    for sentinel in (False, True):
        cache = init_kv_cache(te.cfg, batch=2, max_seq=64, device=te.device, dtype=te.dtype)
        token = torch.tensor([5, 9])
        pos = torch.full((), 3, dtype=torch.int32)
        with torch.inference_mode():
            outs.append(te._decode_chunk(token, pos, cache, 4, None, (0.0, None, None), 64,
                                         sentinel=sentinel,
                                         row_start=torch.zeros(2, dtype=torch.int32)))
    assert len(outs[0]) == 3 and len(outs[1]) == 4
    assert torch.equal(outs[0][1], outs[1][1])
    assert outs[1][3].tolist() == [True, True]


def test_integrity_counters_snapshot():
    plane = _arm()
    plane.check("logits", 3)
    plane.failure("wal", "torn")
    stats = plane.stats()
    assert stats == {"checks": {"logits": 3}, "failures": {"wal": 1}, "checks_total": 3,
                     "failures_total": 1}
    assert integrity.counters() is plane.counters
    rec = obs.Recorder()
    obs.install(rec)
    counted = integrity.IntegrityPlane()
    counted.check("logits")
    counted.failure("logits", "row 1")
    assert rec.counters() == {"integrity.checks.logits": 1, "integrity.failures.logits": 1}
