"""Shared-prefix attention of the port against the JAX package
(mirrors tests/test_prefix_attention.py).

  * ``attention(return_state)`` + ``merge_attention_states``: a KV split at
    any point and merged equals one softmax; a fully masked source drops
    out. State and outputs match the JAX ops at 2e-5 (float32, the JAX
    file's own tolerance).
  * The decode kernel's plain version with ``return_state`` against the
    JAX Pallas kernel with ``return_state=True`` in interpret mode, over the
    dense and the int8 cache, with and without softcap (out, m and l at
    1e-5 in float32; 2e-4 over int8 codes, the JAX int8 tests' tolerance),
    and ``prefix_attention`` + that state merged against attention over the
    concatenated cache (3e-5, as the JAX file).
  * ``forward`` with a prefix against the JAX ``forward`` with the same
    prefix: suffix prefill and decode, mixed ``prefix_rows`` next to a
    row-start row, the int8 cache, and the sliding-window refusal. Logits
    at 1e-4 (float32 matmuls in another order; 1e-3 through the int8
    quantizer, as tests/test_torch_model.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.models import config as jconfig
from llm_consensus_tpu.models import transformer as jtf
from llm_consensus_tpu.ops.attention import attention as jax_attention
from llm_consensus_tpu.ops.attention import merge_attention_states as jax_merge
from llm_consensus_tpu.ops.attention import prefix_attention as jax_prefix_attention
from llm_consensus_tpu.ops.pallas.decode_attention import decode_attention as jax_decode
from llm_consensus_tpu.ops.quant import quantize_kv as jax_quantize_kv
from llm_consensus_tpu_torch.models import config as tconfig
from llm_consensus_tpu_torch.models import transformer as ttf
from llm_consensus_tpu_torch.ops import attention as ta
from llm_consensus_tpu_torch.ops.kernels import decode_attention as da

CPU = torch.device("cpu")
TOL = dict(atol=1e-4, rtol=1e-4)
TOL8 = dict(atol=1e-3, rtol=1e-3)
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
STATE_TOL8 = dict(atol=2e-4, rtol=2e-4)


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _mask(b, t, s_total):
    qpos = np.broadcast_to(np.arange(s_total - t, s_total)[None], (b, t))
    kvpos = np.broadcast_to(np.arange(s_total)[None], (b, s_total))
    return kvpos[:, None, :] <= qpos[:, :, None]  # [B, T, S]


# -- the ops ----------------------------------------------------------------------


def test_attention_state_split_merge_matches_full():
    """Splitting KV into [0, s) + [s, S) and merging == one softmax, in the
    port and against the JAX ops."""
    b, t, hq, hkv, dh, s_total, split = 2, 3, 8, 4, 64, 48, 20
    q, k, v = _normal(0, (b, t, hq, dh), (b, s_total, hkv, dh), (b, s_total, hkv, dh))
    mask = _mask(b, t, s_total)
    tq, tk, tv = _t(q, k, v)
    tm = torch.from_numpy(mask.copy())
    want = ta.attention(tq, tk, tv, tm)
    o1, m1, l1 = ta.attention(tq, tk[:, :split], tv[:, :split], tm[:, :, :split],
                              return_state=True)
    o2, m2, l2 = ta.attention(tq, tk[:, split:], tv[:, split:], tm[:, :, split:],
                              return_state=True)
    got = ta.merge_attention_states(o1, m1, l1, o2, m2, l2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)
    with jax.default_matmul_precision("highest"):
        jo, jm, jl = jax_attention(jnp.asarray(q), jnp.asarray(k[:, :split]),
                                   jnp.asarray(v[:, :split]), jnp.asarray(mask[:, :, :split]),
                                   return_state=True)
        jo2, jm2, jl2 = jax_attention(jnp.asarray(q), jnp.asarray(k[:, split:]),
                                      jnp.asarray(v[:, split:]), jnp.asarray(mask[:, :, split:]),
                                      return_state=True)
        jgot = jax_merge(jo, jm, jl, jo2, jm2, jl2)
    for ours, theirs in ((o1, jo), (m1, jm), (l1, jl), (got, jgot)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=2e-5, rtol=2e-5)


def test_attention_state_fully_masked_source_drops_out():
    b, t, hq, hkv, dh, s = 1, 2, 4, 2, 64, 16
    tq, tk, tv = _t(*_normal(1, (b, t, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh)))
    full = torch.ones((b, t, s), dtype=torch.bool)
    none = torch.zeros((b, t, s), dtype=torch.bool)
    want = ta.attention(tq, tk, tv, full)
    o1, m1, l1 = ta.attention(tq, tk, tv, full, return_state=True)
    o2, m2, l2 = ta.attention(tq, tk, tv, none, return_state=True)
    assert bool((l2 == 0.0).all())
    for got in (ta.merge_attention_states(o1, m1, l1, o2, m2, l2),
                ta.merge_attention_states(o2, m2, l2, o1, m1, l1)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


def test_prefix_attention_matches_jax():
    b, t, hq, hkv, dh, p_cap, p_len = 3, 2, 8, 4, 64, 32, 27
    q, pk, pv = _normal(2, (b, t, hq, dh), (p_cap, hkv, dh), (p_cap, hkv, dh))
    active = np.array([True, False, True])
    got = ta.prefix_attention(*_t(q, pk, pv), p_len, torch.from_numpy(active),
                              logit_softcap=30.0)
    with jax.default_matmul_precision("highest"):
        want = jax_prefix_attention(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                                    jnp.int32(p_len), jnp.asarray(active), logit_softcap=30.0)
    for ours, theirs in zip(got, want):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=2e-5, rtol=2e-5)
    assert bool((got[2][1] == 0.0).all())  # the inactive row contributes nothing


# -- the decode kernel's return_state ----------------------------------------------


def _int8_stack(x):
    """[L, B, W, H, dh] float → {"q8", "s" [L, B, H, W]} numpy, quantized by JAX."""
    q8, s = jax_quantize_kv(jnp.asarray(x))
    return {"q8": np.array(q8), "s": np.array(jnp.swapaxes(s[..., 0], 2, 3))}


def _decode_state(q, k, v, pos, row_start, quantized, w8a8=False, **kw):
    """(port plain, JAX interpret) → each (out, m, l) as numpy (the JAX
    kernel takes W8A8 from LLMC_DECODE_W8A8)."""
    rs = np.asarray(row_start, np.int32)
    if quantized:
        tk = {key: torch.from_numpy(a) for key, a in k.items()}
        tv = {key: torch.from_numpy(a) for key, a in v.items()}
        jk = {key: jnp.asarray(a) for key, a in k.items()}
        jv = {key: jnp.asarray(a) for key, a in v.items()}
    else:
        tk, tv, jk, jv = torch.from_numpy(k), torch.from_numpy(v), jnp.asarray(k), jnp.asarray(v)
    ours = da.decode_attention_plain(
        torch.from_numpy(q), tk, tv, torch.tensor(pos, dtype=torch.int32),
        torch.tensor(0, dtype=torch.int32), torch.from_numpy(rs), return_state=True,
        w8a8=w8a8, **kw)
    with jax.default_matmul_precision("highest"):
        theirs = jax_decode(jnp.asarray(q), jk, jv, jnp.int32(pos), jnp.int32(0),
                            jnp.asarray(rs), interpret=True, return_state=True, **kw)
    return [x.numpy() for x in ours], [np.asarray(x) for x in theirs]


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_decode_state_matches_jax_interpret(quantized, softcap):
    b, hq, hkv, dh, width, pos = 4, 8, 4, 128, 64, 40
    q, k, v = _normal(3, (b, 1, hq, dh), (1, b, width, hkv, dh), (1, b, width, hkv, dh))
    if quantized:
        k, v = _int8_stack(k), _int8_stack(v)
    ours, theirs = _decode_state(q, k, v, pos, [0, 3, 11, 40], quantized,
                                 logit_softcap=softcap)
    tol = STATE_TOL8 if quantized else STATE_TOL
    assert [o.shape for o in ours] == [(b, 1, hq, dh), (b, hq), (b, hq)]
    for got, want in zip(ours, theirs):
        np.testing.assert_allclose(got, want, **tol)


def test_decode_state_w8a8_matches_jax_interpret(monkeypatch):
    b, hq, hkv, dh, width, pos = 2, 16, 8, 128, 128, 100
    q, k, v = _normal(4, (b, 1, hq, dh), (1, b, width, hkv, dh), (1, b, width, hkv, dh))
    k8, v8 = _int8_stack(k), _int8_stack(v)
    monkeypatch.setenv("LLMC_DECODE_W8A8", "1")
    ours, theirs = _decode_state(q, k8, v8, pos, [0, 9], True, w8a8=True)
    for got, want in zip(ours, theirs):
        np.testing.assert_allclose(got, want, **STATE_TOL8)


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
def test_decode_state_row_with_nothing_valid(quantized):
    """A row whose row_start lies past pos: out 0, m = NEG_INF, l = 0 (the
    JAX kernel counts masked columns in l there; the merge drops the row
    either way)."""
    q, k, v = _normal(5, (2, 1, 8, 128), (1, 2, 64, 4, 128), (1, 2, 64, 4, 128))
    if quantized:
        k, v = _int8_stack(k), _int8_stack(v)
    (out, m, l), (j_out, j_m, _) = _decode_state(q, k, v, 10, [0, 11], quantized)
    assert np.all(out[1] == 0.0) and np.all(m[1] == da.NEG_INF) and np.all(l[1] == 0.0)
    np.testing.assert_array_equal(j_m[1], m[1])
    np.testing.assert_allclose(out[0], j_out[0], **(STATE_TOL8 if quantized else STATE_TOL))


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_prefix_plus_decode_state_matches_concat_reference(softcap):
    """prefix_attention + the decode state merged == the plain attention op
    over the concatenated [prefix ++ suffix window] cache."""
    b, hq, hkv, dh = 4, 8, 4, 128
    p_len, p_cap, width, pos = 30, 32, 64, 40
    q, pk, sk = _normal(6, (b, 1, hq, dh), (2, p_cap, hkv, dh), (2, b, width, hkv, dh))
    rs = torch.tensor([0, 3, 11, 0], dtype=torch.int32)
    tq, tpk, tsk = _t(q, pk, sk)
    o2, m2, l2 = da.decode_attention_plain(tq, tsk[0][None], tsk[1][None], pos, 0, rs,
                                           logit_softcap=softcap, return_state=True)
    o1, m1, l1 = ta.prefix_attention(tq, tpk[0, :p_len], tpk[1, :p_len], p_len,
                                     torch.ones(b, dtype=torch.bool), logit_softcap=softcap)
    got = ta.merge_attention_states(o1, m1, l1, o2, m2[:, None], l2[:, None])
    k_cat = torch.cat([tpk[0, :p_len][None].expand(b, p_len, hkv, dh), tsk[0]], dim=1)
    v_cat = torch.cat([tpk[1, :p_len][None].expand(b, p_len, hkv, dh), tsk[1]], dim=1)
    slots = torch.arange(width)[None, :]
    valid = torch.cat([torch.ones((b, p_len), dtype=torch.bool),
                       (slots <= pos) & (slots >= rs[:, None])], dim=1)
    want = ta.attention(tq, k_cat, v_cat, valid[:, None, :], logit_softcap=softcap)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5)


def test_state_wrapper_on_cpu_counts_no_launch(monkeypatch):
    def no_build():
        raise AssertionError("CPU tensors must not build the CUDA kernel")

    monkeypatch.setattr(da, "ensure_built", no_build)
    tq, tk, tv = _t(*_normal(7, (2, 1, 8, 128), (1, 2, 64, 4, 128), (1, 2, 64, 4, 128)))
    before = da.LAUNCHES_STATE.count
    got = da.decode_attention(tq, tk, tv, 50, 0, return_state=True)
    want = da.decode_attention_plain(tq, tk, tv, 50, 0, return_state=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert da.LAUNCHES_STATE.count == before
    # Without return_state the output is the same, alone.
    assert torch.equal(da.decode_attention(tq, tk, tv, 50, 0), want[0])


# -- forward with a prefix ------------------------------------------------------


def _pair(name="tiny-llama", seed=0):
    jcfg, tcfg = jconfig.get_config(name), tconfig.get_config(name)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    tp = ttf.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, CPU, torch.float32)
    return jcfg, tcfg, jp, tp


def _ids(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _prefix_caches(jcfg, tcfg, jp, tp, prefix, p_cap, quant=None):
    """Batch-1 prefill of the shared prefix in both packages."""
    jc = jtf.init_kv_cache(jcfg, 1, p_cap, dtype=jnp.float32, quant=quant)
    _, jc = jtf.forward(jp, jcfg, jnp.asarray(prefix[None]), jc, start_pos=0)
    tc = ttf.init_kv_cache(tcfg, 1, p_cap, device=CPU, dtype=torch.float32, quant=quant)
    _, tc = ttf.forward(tp, tcfg, torch.from_numpy(prefix[None]).long(), tc, 0)
    return jc, tc


@pytest.mark.parametrize("quant", [None, "int8"], ids=["dense", "int8"])
@pytest.mark.parametrize("attn_impl", ["torch", "flash"])
def test_forward_prefix_suffix_prefill_and_decode_match_jax(attn_impl, quant):
    """Two rows share a 24-token prefix with different 8-token suffixes: the
    suffix prefill (plain op with state + merge) and four decode steps (the
    decode kernel's state form, plain here, or the plain op) give the JAX
    forward's logits with the same prefix."""
    jcfg, tcfg, jp, tp = _pair()
    p_len, s_len, cap = 24, 8, 32
    prefix = _ids(10, (p_len,), jcfg.vocab_size)
    suffixes = _ids(11, (2, s_len), jcfg.vocab_size)
    jpc, tpc = _prefix_caches(jcfg, tcfg, jp, tp, prefix, 32, quant)
    jc = jtf.init_kv_cache(jcfg, 2, cap, dtype=jnp.float32, quant=quant)
    tc = ttf.init_kv_cache(tcfg, 2, cap, device=CPU, dtype=torch.float32, quant=quant)
    rows = torch.ones(2, dtype=torch.bool)
    tol = TOL8 if quant else TOL
    with jax.default_matmul_precision("highest"):
        want, jc = jtf.forward(jp, jcfg, jnp.asarray(suffixes), jc, start_pos=0, prefix=jpc,
                               prefix_len=jnp.int32(p_len), prefix_rows=jnp.ones(2, bool))
        got, tc = ttf.forward(tp, tcfg, torch.from_numpy(suffixes).long(), tc, 0, prefix=tpc,
                              prefix_len=p_len, prefix_rows=rows)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
        tok = np.asarray(jnp.argmax(want[:, -1], axis=-1)).astype(np.int32)
        for pos in range(s_len, s_len + 4):
            want, jc = jtf.forward(jp, jcfg, jnp.asarray(tok[:, None]), jc,
                                   start_pos=jnp.int32(pos), kv_width=cap,
                                   attn_impl="xla" if attn_impl == "torch" else "flash",
                                   prefix=jpc, prefix_len=jnp.int32(p_len),
                                   prefix_rows=jnp.ones(2, bool))
            got, tc = ttf.forward(tp, tcfg, torch.from_numpy(tok[:, None]).long(), tc,
                                  torch.tensor(pos, dtype=torch.int32), kv_width=cap,
                                  attn_impl=attn_impl, prefix=tpc, prefix_len=p_len,
                                  prefix_rows=rows)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
            tok = np.asarray(jnp.argmax(want[:, -1], axis=-1)).astype(np.int32)


@pytest.mark.parametrize("attn_impl", ["torch", "flash"])
def test_forward_prefix_mixed_rows_match_jax_and_full_prompts(attn_impl):
    """Row 0 attends the shared prefix with its suffix at the frontier; row 1
    carries an unrelated full prompt at a row_start offset. Logits match
    the JAX forward given the same rows, and each row's single-row run."""
    jcfg, tcfg, jp, tp = _pair()
    p_len, s_len, cap = 24, 8, 64
    n_other = p_len + s_len
    prefix = _ids(12, (p_len,), jcfg.vocab_size)
    suffix = _ids(13, (s_len,), jcfg.vocab_size)
    other = _ids(14, (n_other,), jcfg.vocab_size)
    jpc, tpc = _prefix_caches(jcfg, tcfg, jp, tp, prefix, 32)
    row_start = np.array([n_other - s_len, 0], np.int32)
    rows_np = np.array([True, False])
    toks = np.stack([np.concatenate([other[:n_other - s_len], suffix]), other])
    jpool = jtf.init_kv_cache(jcfg, 2, cap, dtype=jnp.float32)
    tpool = ttf.init_kv_cache(tcfg, 2, cap, device=CPU, dtype=torch.float32)
    jkw = dict(row_start=jnp.asarray(row_start), prefix=jpc, prefix_len=jnp.int32(p_len),
               prefix_rows=jnp.asarray(rows_np))
    tkw = dict(row_start=torch.from_numpy(row_start), prefix=tpc, prefix_len=p_len,
               prefix_rows=torch.from_numpy(rows_np))
    # Single-row references: the full prompt of each row alone.
    ref = ttf.init_kv_cache(tcfg, 2, cap, device=CPU, dtype=torch.float32)
    full = torch.from_numpy(np.stack([np.concatenate([prefix, suffix]), other])).long()
    ref_logits, ref = ttf.forward(tp, tcfg, full, ref, 0)
    with jax.default_matmul_precision("highest"):
        want, jpool = jtf.forward(jp, jcfg, jnp.asarray(toks), jpool, start_pos=0, **jkw)
        got, tpool = ttf.forward(tp, tcfg, torch.from_numpy(toks).long(), tpool, 0, **tkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(got[:, -1].numpy(), ref_logits[:, -1].numpy(), **TOL)
        tok = ref_logits[:, -1].argmax(dim=-1).numpy().astype(np.int32)
        for pos in range(n_other, n_other + 3):
            want, jpool = jtf.forward(jp, jcfg, jnp.asarray(tok[:, None]), jpool,
                                      start_pos=jnp.int32(pos),
                                      attn_impl="xla" if attn_impl == "torch" else "flash",
                                      **jkw)
            got, tpool = ttf.forward(tp, tcfg, torch.from_numpy(tok[:, None]).long(), tpool,
                                     torch.tensor(pos, dtype=torch.int32),
                                     attn_impl=attn_impl, **tkw)
            step, ref = ttf.forward(tp, tcfg, torch.from_numpy(tok[:, None]).long(), ref,
                                    torch.tensor(pos, dtype=torch.int32))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            np.testing.assert_allclose(got.numpy(), step.numpy(), **TOL)
            tok = step[:, -1].argmax(dim=-1).numpy().astype(np.int32)


def test_forward_refusals_match_jax():
    jcfg, tcfg, jp, tp = _pair("tiny-mistral")
    pc = ttf.init_kv_cache(tcfg, 1, 32, device=CPU, dtype=torch.float32)
    cache = ttf.init_kv_cache(tcfg, 1, 32, device=CPU, dtype=torch.float32)
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="sliding_window"):
        ttf.forward(tp, tcfg, tokens, cache, 0, prefix=pc, prefix_len=8)
    with pytest.raises(ValueError, match="sliding_window"):
        jtf.forward(jp, jcfg, jnp.zeros((1, 4), jnp.int32),
                    jtf.init_kv_cache(jcfg, 1, 32, dtype=jnp.float32), start_pos=0,
                    prefix=jtf.init_kv_cache(jcfg, 1, 32, dtype=jnp.float32),
                    prefix_len=jnp.int32(8))
    _, tcfg, _, tp = _pair()
    cache = ttf.init_kv_cache(tcfg, 1, 32, device=CPU, dtype=torch.float32)
    with pytest.raises(ValueError, match="requires a cache"):
        ttf.forward(tp, tcfg, tokens, row_start=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="requires a cache"):
        ttf.forward(tp, tcfg, tokens, prefix=cache, prefix_len=4)
    with pytest.raises(ValueError, match="prefix_len"):
        ttf.forward(tp, tcfg, tokens, cache, 0, prefix=cache)
