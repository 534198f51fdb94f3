"""The port's CUDA kernels and engine on a card (``gpu`` marker).

Every test here needs a CUDA card: a fixture skips it when torch sees none,
so the file collects the same tests everywhere. It imports no JAX (the
machine with the card has none), so it runs there without the repo's
conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Flash: tolerance 3e-2 on bf16 outputs of magnitude ~1 (the kernels and
their plain versions round p to bf16 at different running maxima). Decode
outputs shrink as the width grows (~0.07 at most at width 8192), so decode
checks allow 5 % of the largest plain output (a few bf16 ulps there), at
most 3e-2.
"""

import time

import numpy as np
import pytest
import torch

from llm_consensus_tpu_torch.engine import Engine, SamplingParams
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.ops.kernels import decode_attention as da
from llm_consensus_tpu_torch.ops.kernels import flash_attention as fa

pytestmark = pytest.mark.gpu
TOL = 3e-2
DECODE_REL_TOL = 0.05


def _decode_err_and_tol(got, want):
    err = (got.float() - want.float()).abs().max().item()
    return err, min(TOL, DECODE_REL_TOL * want.float().abs().max().item())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bf16(cuda, seed, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda, torch.bfloat16)
            for s in shapes]


def _i32(cuda, *values):
    return torch.tensor(values, dtype=torch.int32, device=cuda)


@pytest.mark.parametrize("b,t,s,hq,hkv,dh,off,window,cap", [
    (1, 512, 512, 32, 8, 128, 0, None, None),   # llama-3-8b prefill
    (1, 256, 256, 16, 8, 128, 0, None, None),   # consensus-1b prefill
    (1, 64, 192, 8, 2, 128, 128, 48, 30.0),     # offset + window + softcap
    (2, 48, 48, 8, 4, 64, 0, None, None),       # ragged T, dh 64
])
def test_flash_kernel_matches_plain(cuda, b, t, s, hq, hkv, dh, off, window, cap):
    q, k, v = _bf16(cuda, 0, (b, t, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh))
    kw = dict(q_offset=off, sliding_window=window, logit_softcap=cap)
    before = fa.LAUNCHES.count
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES.count == before + 1
    want = fa.flash_attention_plain(q, k, v, **kw)
    assert bool(torch.isfinite(got).all())
    assert (got.float() - want.float()).abs().max().item() < TOL


@pytest.mark.parametrize("b,s,hq,hkv,pos,width,rs", [
    (1, 8192, 32, 8, 600, 640, (0,)),           # llama-3-8b stack
    (1, 4096, 16, 8, 4095, 4096, (0,)),         # consensus-1b, full window
    (4, 128, 8, 2, 95, 128, (0, 5, 17, 90)),    # ragged rows
])
def test_decode_kernel_matches_plain(cuda, b, s, hq, hkv, pos, width, rs):
    q, k, v = _bf16(cuda, 1, (b, 1, hq, 128), (2, b, s, hkv, 128), (2, b, s, hkv, 128))
    k[1, :, pos + 1:] = float("nan")  # unwritten slots must not leak
    v[1, :, pos + 1:] = float("nan")
    before = da.LAUNCHES.count
    got = da.decode_attention(q, k, v, _i32(cuda, pos)[0], _i32(cuda, 1)[0],
                              _i32(cuda, *rs), kv_width=width)
    torch.cuda.synchronize()
    assert da.LAUNCHES.count == before + 1
    want = da.decode_attention_plain(q, k, v, pos, 1, _i32(cuda, *rs), kv_width=width)
    assert bool(torch.isfinite(got).all())
    err, tol = _decode_err_and_tol(got, want)
    assert err <= tol


def test_kernels_refuse_what_they_do_not_take(cuda):
    q, k, v = (x.float() for x in _bf16(cuda, 2, (1, 64, 4, 32), (1, 64, 2, 32),
                                        (1, 64, 2, 32)))
    with pytest.raises(TypeError, match="bf16"):
        fa.flash_attention(q, k, v)
    q, k, v = _bf16(cuda, 3, (1, 1, 8, 128), (1, 1, 64, 2, 128), (1, 1, 64, 2, 128))
    with pytest.raises(ValueError, match="int32"):
        da.decode_attention(q, k, v, 10, _i32(cuda, 0)[0], _i32(cuda, 0))


def test_engine_runs_through_both_kernels(cuda):
    """A narrow model (head_dim 128) generates on the card through the flash
    and decode kernels, with no host sync per step."""
    engine = Engine(get_config("tiny-llama", head_dim=128), max_seq=256, device=cuda)
    flash0, decode0 = fa.LAUNCHES.count, da.LAUNCHES.count
    result = engine.generate("the quick brown fox", SamplingParams(max_new_tokens=20,
                                                                   ignore_eos=True))
    assert len(result.token_ids) == 20 and result.finish_reason == "length"
    assert fa.LAUNCHES.count - flash0 == engine.cfg.n_layers   # one prefill
    assert da.LAUNCHES.count - decode0 >= 19 * engine.cfg.n_layers
    assert all(0 <= t < engine.cfg.vocab_size for t in result.token_ids)


def _int8_cache(cuda, seed, l, b, s, hkv, dh=128):
    """An int8 cache side {"q8", "s"} on the card from seeded normals."""
    from llm_consensus_tpu_torch.ops.quant import quantize_kv

    (x,) = _bf16(cuda, seed, (l, b, s, hkv, dh))
    q8, sc = quantize_kv(x)
    return {"q8": q8.contiguous(), "s": sc[..., 0].transpose(2, 3).contiguous()}


@pytest.mark.parametrize("w8a8", [False, True], ids=["int8", "w8a8"])
@pytest.mark.parametrize("b,s,hq,hkv,pos,width,rs,window,cap", [
    (1, 8192, 32, 8, 383, 384, (0,), None, None),      # llama-3-8b, slice width
    (1, 8192, 32, 8, 8191, 8192, (0,), None, None),    # full window
    (4, 256, 16, 8, 200, 256, (0, 37, 5, 90), None, None),  # ragged rows
    (2, 512, 16, 8, 400, 512, (0, 0), 128, 30.0),      # window + softcap
])
def test_int8_decode_kernels_match_plain(cuda, w8a8, b, s, hq, hkv, pos, width, rs,
                                         window, cap):
    (q,) = _bf16(cuda, 4, (b, 1, hq, 128))
    k, v = _int8_cache(cuda, 5, 2, b, s, hkv), _int8_cache(cuda, 6, 2, b, s, hkv)
    for side in (k, v):  # garbage past the frontier must not leak
        side["s"][1, :, :, pos + 1:] = float("nan")
        side["q8"][1, :, pos + 1:] = 127
    counter = da.LAUNCHES_W8A8 if w8a8 else da.LAUNCHES_INT8
    before = counter.count
    kw = dict(kv_width=width, sliding_window=window, logit_softcap=cap, w8a8=w8a8)
    got = da.decode_attention(q, k, v, _i32(cuda, pos)[0], _i32(cuda, 1)[0], _i32(cuda, *rs),
                              **kw)
    torch.cuda.synchronize()
    assert counter.count == before + 1
    want = da.decode_attention_plain(q, k, v, pos, 1, _i32(cuda, *rs), **kw)
    assert bool(torch.isfinite(got).all())
    err, tol = _decode_err_and_tol(got, want)
    assert err <= tol


@pytest.mark.parametrize("b,s,hq,hkv,pos,width", [
    (1, 1024, 32, 8, 383, 384),     # llama-3-8b at the slice width
    (4, 512, 16, 8, 300, 384),      # consensus-1b's group, B = 4
])
def test_w8a8_kernel_is_not_the_int8_kernel(cuda, b, s, hq, hkv, pos, width):
    """q with one outlier of 127 per head, on a dimension where every K code
    is 0: q's int8 scale becomes 1 with the scores untouched, so W8A8
    rounds the rest of q to integers and its output moves well past the
    tolerance. Each kernel matches its own plain version, not the other's."""
    (q,) = _bf16(cuda, 10, (b, 1, hq, 128))
    q[..., 0] = 127.0
    k, v = _int8_cache(cuda, 11, 1, b, s, hkv), _int8_cache(cuda, 12, 1, b, s, hkv)
    k["q8"][..., 0] = 0
    rs = _i32(cuda, *([0] * b))
    got, want = {}, {}
    for w8a8 in (False, True):
        args = (q, k, v, _i32(cuda, pos)[0], _i32(cuda, 0)[0], rs)
        got[w8a8] = da.decode_attention(*args, kv_width=width, w8a8=w8a8)
        want[w8a8] = da.decode_attention_plain(*args, kv_width=width, w8a8=w8a8)
    torch.cuda.synchronize()
    for w8a8 in (False, True):
        err, tol = _decode_err_and_tol(got[w8a8], want[w8a8])
        cross, _ = _decode_err_and_tol(got[w8a8], want[not w8a8])
        assert err <= tol < cross, (w8a8, err, tol, cross)


def test_int8_kernel_refuses_what_it_does_not_take(cuda):
    (q,) = _bf16(cuda, 7, (1, 1, 8, 128))
    k = _int8_cache(cuda, 8, 1, 1, 64, 2)
    bad = {"q8": k["q8"], "s": k["s"].float()}
    with pytest.raises(TypeError, match="k.s"):
        da.decode_attention(q, bad, bad, _i32(cuda, 10)[0], _i32(cuda, 0)[0], _i32(cuda, 0))
    mha = _int8_cache(cuda, 9, 1, 1, 64, 8)
    with pytest.raises(ValueError, match="W8A8"):
        da.decode_attention(q, mha, mha, _i32(cuda, 10)[0], _i32(cuda, 0)[0], _i32(cuda, 0),
                            w8a8=True)


def test_int8_matmul_on_the_card_is_exact(cuda):
    from llm_consensus_tpu_torch.ops.quant import _int8_mm

    gen = torch.Generator().manual_seed(0)
    for m in (1, 17, 40):
        a = torch.randint(-127, 128, (m, 4096), generator=gen, dtype=torch.int8)
        b = torch.randint(-127, 128, (4096, 1024), generator=gen, dtype=torch.int8)
        got = _int8_mm(a.to(cuda), b.to(cuda))
        assert got.dtype == torch.int32 and got.shape == (m, 1024)
        assert torch.equal(got.cpu(), _int8_mm(a, b))


@pytest.mark.parametrize("modes,counter", [
    ({"quant": "int8", "kv_quant": "int8"}, "LAUNCHES_INT8"),
    ({"quant": "int8", "kv_quant": "int8", "w8a8": True, "decode_w8a8": True}, "LAUNCHES_W8A8"),
    ({"quant": "int4"}, "LAUNCHES"),
])
def test_quantized_engine_runs_through_the_kernels(cuda, modes, counter):
    engine = Engine(get_config("tiny-llama", head_dim=128), max_seq=256, device=cuda, **modes)
    flash0, decode0 = fa.LAUNCHES.count, getattr(da, counter).count
    result = engine.generate("the quick brown fox", SamplingParams(max_new_tokens=20,
                                                                   ignore_eos=True))
    assert len(result.token_ids) == 20
    assert fa.LAUNCHES.count - flash0 == engine.cfg.n_layers
    assert getattr(da, counter).count - decode0 >= 19 * engine.cfg.n_layers


@pytest.mark.parametrize("variant", ["bf16", "int8", "w8a8"])
@pytest.mark.parametrize("b,s,hq,hkv,pos,width,rs,window,cap", [
    (4, 8192, 32, 8, 300, 384, (0, 37, 300, 5), None, None),   # llama-3-8b, one row 1 slot
    (4, 8192, 32, 8, 8000, 8192, (0, 100, 7999, 8000), None, None),
    (4, 512, 16, 8, 400, 512, (0, 0, 390, 0), 128, 30.0),     # window + softcap
])
def test_state_kernels_match_plain(cuda, variant, b, s, hq, hkv, pos, width, rs, window, cap):
    """return_state of each variant: out at the decode tolerance; m within
    1e-2 absolute (scores of magnitude ~10, fp32 sums in another order);
    l within 1e-2 relative (a sum of exps rescaled in another order)."""
    (q,) = _bf16(cuda, 20, (b, 1, hq, 128))
    if variant == "bf16":
        k, v = _bf16(cuda, 21, (2, b, s, hkv, 128), (2, b, s, hkv, 128))
        k[1, :, pos + 1:] = float("nan")
        v[1, :, pos + 1:] = float("nan")
    else:
        k, v = _int8_cache(cuda, 22, 2, b, s, hkv), _int8_cache(cuda, 23, 2, b, s, hkv)
        for side in (k, v):
            side["s"][1, :, :, pos + 1:] = float("nan")
            side["q8"][1, :, pos + 1:] = 127
    kw = dict(kv_width=width, sliding_window=window, logit_softcap=cap,
              w8a8=variant == "w8a8", return_state=True)
    before = da.LAUNCHES_STATE.count
    got = da.decode_attention(q, k, v, _i32(cuda, pos)[0], _i32(cuda, 1)[0], _i32(cuda, *rs),
                              **kw)
    torch.cuda.synchronize()
    assert da.LAUNCHES_STATE.count == before + 1
    want = da.decode_attention_plain(q, k, v, pos, 1, _i32(cuda, *rs), **kw)
    err, tol = _decode_err_and_tol(got[0], want[0])
    assert err <= tol
    assert (got[1] - want[1]).abs().max().item() <= 1e-2
    assert ((got[2] - want[2]).abs() <= 1e-2 * want[2].abs() + 1e-6).all()
    assert got[1].dtype == got[2].dtype == torch.float32 and got[1].shape == (b, hq)


def test_state_kernel_row_with_nothing_valid(cuda):
    (q,) = _bf16(cuda, 24, (2, 1, 8, 128))
    k, v = _bf16(cuda, 25, (1, 2, 256, 4, 128), (1, 2, 256, 4, 128))
    out, m, l = da.decode_attention(q, k, v, _i32(cuda, 100)[0], _i32(cuda, 0)[0],
                                    _i32(cuda, 0, 101), kv_width=256, return_state=True)
    torch.cuda.synchronize()
    assert bool((out[1] == 0).all()) and bool((l[1] == 0).all())
    assert bool((m[1] == da.NEG_INF).all()) and bool((l[0] > 0).all())


def test_batcher_shared_prefix_runs_through_the_state_kernel(cuda):
    """A shared-prefix wave on the card: the prefix decode goes through the
    state kernel, and a lone prompt afterwards (no prefix) through the
    plain decode kernel."""
    from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher

    engine = Engine(get_config("tiny-llama", head_dim=128), max_seq=512, device=cuda)
    b = ContinuousBatcher(engine, max_batch=4, pool_prefix_min=64)
    try:
        s = SamplingParams(max_new_tokens=20, ignore_eos=True)
        prefix = "a shared prompt prefix that every stream of the wave carries " * 2
        state0, plain0 = da.LAUNCHES_STATE.count, da.LAUNCHES.count
        futs = [b.submit(f"{prefix} stream {i}", s) for i in range(4)]
        results = [f.result(timeout=300) for f in futs]
        assert b.snapshot()["prefix_len"] >= 64
        assert all(len(r.token_ids) == 20 for r in results)
        assert da.LAUNCHES_STATE.count - state0 >= 19 * engine.cfg.n_layers
        lone = b.submit("unrelated", s).result(timeout=300)
        assert len(lone.token_ids) == 20 and b.snapshot()["prefix_len"] == 0
        assert da.LAUNCHES.count - plain0 >= 19 * engine.cfg.n_layers
    finally:
        b.close()


@pytest.mark.parametrize("b,t,s,hq,hkv,dh,off,window,cap", [
    (1, 48, 48, 8, 2, 128, 0, None, None),       # T below one 128-row q tile
    (1, 200, 200, 8, 8, 128, 0, None, None),     # ragged last q tile, group 1
    (2, 320, 320, 8, 1, 128, 0, None, None),     # group 8
    (1, 100, 300, 8, 2, 128, 170, None, None),   # q_offset: a kv tile straddles the diagonal
    (1, 320, 320, 8, 2, 128, 0, 200, None),      # window ending mid-tile
    (2, 128, 128, 8, 4, 128, 0, None, 30.0),     # softcap
    (1, 200, 200, 8, 2, 32, 0, None, None),      # dh 32 (64-byte swizzle)
    (1, 320, 320, 8, 2, 64, 0, None, None),      # dh 64
    (4, 512, 512, 32, 8, 128, 0, None, None),    # the batcher's B = 4 admission wave
])
def test_flash_kernel_tiles_and_masks(cuda, b, t, s, hq, hkv, dh, off, window, cap):
    """The Hopper flash kernel (128-row q tiles, 128-row kv tiles, masks only
    on edge tiles) against its plain version where the tiling has edges."""
    q, k, v = _bf16(cuda, 30, (b, t, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh))
    kw = dict(q_offset=off, sliding_window=window, logit_softcap=cap)
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v, **kw)
    assert bool(torch.isfinite(got).all())
    assert (got.float() - want.float()).abs().max().item() < TOL


VARIANTS = ["bf16", "int8", "w8a8"]
COUNTERS = {"bf16": "LAUNCHES", "int8": "LAUNCHES_INT8", "w8a8": "LAUNCHES_W8A8"}


def _cache(cuda, variant, seed, l, b, s, hkv, dh=128):
    """k and v stacks [l, b, s, hkv, dh] of the variant's cache (bf16, or the
    int8 dicts for int8 and w8a8), made on the card from a seed."""
    from llm_consensus_tpu_torch.ops.quant import quantize_kv

    gen = torch.Generator(device=cuda).manual_seed(seed)
    out = []
    for _ in range(2):
        x = torch.randn((l, b, s, hkv, dh), generator=gen, device=cuda, dtype=torch.bfloat16)
        if variant != "bf16":
            q8, sc = quantize_kv(x)
            x = {"q8": q8.contiguous(), "s": sc[..., 0].transpose(2, 3).contiguous()}
        out.append(x)
    return out


def _poison(k, v, layer, pos, rs=()):
    """Garbage in layer ``layer`` past ``pos`` and before each row's
    row_start: NaN (bf16), or NaN scales and codes of 127 (int8). None of it
    may reach the output."""
    spans = [(slice(None), slice(pos + 1, None))] + [(i, slice(0, r)) for i, r in enumerate(rs)]
    for row, span in spans:
        for side in (k, v):
            if isinstance(side, dict):
                side["q8"][layer, row, span] = 127
                side["s"][layer, row, :, span] = float("nan")
            else:
                side[layer, row, span] = float("nan")


@pytest.mark.parametrize("b,s,hq,hkv,pos,width,rs,dh", [
    (1, 64, 32, 8, 0, 1, (0,), 128),                    # one slot
    (1, 128, 32, 8, 62, 63, (0,), 128),                 # below one chunk
    (1, 128, 32, 8, 64, 65, (0,), 128),                 # one slot past a chunk
    (1, 1024, 32, 8, 511, 512, (0,), 128),              # the first width that splits (2 x 256)
    (1, 8192, 32, 8, 8191, 8192, (0,), 128),            # the full llama-3-8b window
    (4, 1024, 32, 8, 700, 768, (0, 699, 700, 3), 128),  # ragged rows, one holds one slot
    (1, 3000, 32, 8, 2998, 2999, (0,), 128),            # split bounds off multiples of 8
    (4, 1024, 32, 8, 900, 1000, (37, 3, 901, 13), 128), # row starts off 8, one row empty
    (2, 2048, 8, 2, 2000, 2040, (5, 77), 32),           # dh 32
    (1, 1536, 16, 4, 1500, 1533, (19,), 64),            # dh 64
    (1, 131072, 32, 8, 131000, 131072, (0,), 128),      # the long-context stack's S
])
@pytest.mark.parametrize("state", [False, True], ids=["out", "state"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_split_plan_edges(cuda, variant, b, s, hq, hkv, pos, width, rs, dh, state):
    """Each decode kernel at the split plan's edge widths, with garbage past
    pos and before each row's start."""
    (q,) = _bf16(cuda, 31, (b, 1, hq, dh))
    k, v = _cache(cuda, variant, 31, 2, b, s, hkv, dh)
    _poison(k, v, 1, pos, rs)
    kw = dict(kv_width=width, return_state=state, w8a8=variant == "w8a8")
    counter = getattr(da, COUNTERS[variant])
    before = counter.count
    got = da.decode_attention(q, k, v, _i32(cuda, pos)[0], _i32(cuda, 1)[0], _i32(cuda, *rs),
                              **kw)
    torch.cuda.synchronize()
    assert counter.count == before + 1
    want = da.decode_attention_plain(q, k, v, pos, 1, _i32(cuda, *rs), **kw)
    got, want = (got, want) if state else ((got,), (want,))
    assert bool(torch.isfinite(got[0]).all())
    err, tol = _decode_err_and_tol(got[0], want[0])
    assert err <= tol
    if state:
        assert (got[1] - want[1]).abs().max().item() <= 1e-2
        assert ((got[2] - want[2]).abs() <= 1e-2 * want[2].abs() + 1e-6).all()


@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_state_row_with_nothing_valid_among_splits(cuda, variant):
    """A row whose row_start lies past pos, beside full rows, at a width
    the plan splits: out 0, m = NEG_INF, l = 0 for it alone."""
    (q,) = _bf16(cuda, 32, (4, 1, 32, 128))
    k, v = _cache(cuda, variant, 33, 1, 4, 1024, 8)
    rs = _i32(cuda, 0, 900, 0, 10)
    kw = dict(kv_width=1024, return_state=True, w8a8=variant == "w8a8")
    out, m, l = da.decode_attention(q, k, v, _i32(cuda, 899)[0], _i32(cuda, 0)[0], rs, **kw)
    torch.cuda.synchronize()
    assert da.split_plan(1024, 4, 8) > 1
    assert bool((out[1] == 0).all()) and bool((l[1] == 0).all())
    assert bool((m[1] == da.NEG_INF).all())
    assert bool((l[[0, 2, 3]] > 0).all())
    want = da.decode_attention_plain(q, k, v, 899, 0, rs, **kw)
    err, tol = _decode_err_and_tol(out, want[0])
    assert err <= tol


@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_graph_replay_at_other_positions(cuda, variant):
    """One CUDA graph of a decode call replayed at four frontiers: the
    kernel's merge tickets must be back at 0 after every launch, and pos is
    read on the device."""
    (q,) = _bf16(cuda, 34, (1, 1, 32, 128))
    k, v = _cache(cuda, variant, 35, 1, 1, 2048, 8)
    pos, layer, rs = _i32(cuda, 100)[0], _i32(cuda, 0)[0], _i32(cuda, 0)
    kw = dict(kv_width=2048, w8a8=variant == "w8a8")
    assert da.split_plan(2048, 1, 8) > 1
    da.decode_attention(q, k, v, pos, layer, rs, **kw)  # makes the tickets
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.decode_attention(q, k, v, pos, layer, rs, **kw)
    for p in (100, 2047, 700, 5):
        pos.fill_(p)
        graph.replay()
        torch.cuda.synchronize()
        want = da.decode_attention_plain(q, k, v, p, 0, rs, **kw)
        err, tol = _decode_err_and_tol(out, want)
        assert err <= tol, (p, err, tol)


# -- mixture of experts and checkpoints on the card ----------------------------------


@pytest.mark.parametrize("n", [1, 4, 64])
def test_moe_block_on_the_card_matches_the_cpu(cuda, n):
    """float32 on the card (TF32 off, torch's default) against float32 on
    the CPU: identical routing and outputs within 1e-4 (float32 sums of
    512 and 1,024 products in another order). n = 64 at 8 experts drops
    choices past capacity 32."""
    from llm_consensus_tpu_torch.ops.moe import moe_block, route

    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(n)
    e, d, f = 8, 512, 1024
    x = rng.standard_normal((1, n, d)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) * sc for s, sc in (
        ((d, e), 0.3), ((e, d, f), d ** -0.5), ((e, d, f), d ** -0.5), ((e, f, d), f ** -0.5))]
    cpu = [torch.from_numpy(a) for a in [x] + ws]
    dev = [t.to(cuda) for t in cpu]
    _, idx_cpu = route(cpu[0].reshape(n, d), cpu[1], 2)
    _, idx_dev = route(dev[0].reshape(n, d), dev[1], 2)
    assert torch.equal(idx_dev.cpu(), idx_cpu)
    got = moe_block(*dev, top_k=2)
    want = moe_block(*cpu, top_k=2)
    assert got.is_cuda and (got.cpu() - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("mode", ["int8", "int4", "w8a8"])
@pytest.mark.parametrize("rows", [1, 40], ids=["decode", "prefill"])
def test_expert_products_on_the_card(cuda, mode, rows):
    """``qmatmul``'s expert form [E, C, K] @ [E, K, N] on the card against
    the CPU on the same codes: bf16 activations on the card against float32
    on the CPU, within 2 % of the largest output (bf16 rounding of inputs
    and outputs); W8A8's int32 products are exact and only its bf16 output
    rounds, so each value within 2^-8 of its own size."""
    from llm_consensus_tpu_torch.ops.quant import qmatmul, quantize_weight

    gen = torch.Generator().manual_seed(rows)
    e, k, n = 8, 512, 256
    w = quantize_weight(torch.randn(e, k, n, generator=gen) * k ** -0.5,
                        "int4" if mode == "int4" else "int8")
    x = torch.randn(e, rows, k, generator=gen).to(torch.bfloat16)
    x[2] = 0  # an empty expert
    w8a8 = mode == "w8a8"
    got = qmatmul(x.to(cuda), {kk: v.to(cuda) for kk, v in w.items()}, w8a8=w8a8)
    want = qmatmul(x.float(), {kk: v.float() if v.is_floating_point() else v
                               for kk, v in w.items()}, w8a8=w8a8)
    assert got.is_cuda and got.shape == (e, rows, n) and not got[2].any()
    err = (got.float().cpu() - want).abs()
    if w8a8:
        assert bool((err <= 2 ** -8 * want.abs() + 1e-6).all())
    else:
        assert err.max().item() <= 2e-2 * want.abs().max().item()


def test_checkpoint_loads_on_the_card(cuda, tmp_path):
    """A synthetic HF checkpoint of tiny-mixtral in BF16 (chip_smoke.py's
    writer: the card's machine has no safetensors package), loaded on the
    card (int8-quantized as it lands) and on the CPU: the same tree; and
    GPUProvider(checkpoint_dir=...) on the card gives the greedy text of an
    engine on the card over the CPU load moved there."""
    from llm_consensus_tpu_torch.engine.checkpoint import load_hf_safetensors
    from llm_consensus_tpu_torch.models.transformer import param_leaves
    from llm_consensus_tpu_torch.providers import Request
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider
    from llm_consensus_tpu_torch.utils.context import Context

    from chip_smoke import synthetic_hf_tensors, write_safetensors

    cfg = get_config("tiny-mixtral")
    (tmp_path / cfg.name).mkdir()
    write_safetensors(str(tmp_path / cfg.name / "model.safetensors"),
                      synthetic_hf_tensors(torch, cfg, seed=0))
    on_card = load_hf_safetensors(cfg, str(tmp_path / cfg.name), device=cuda, quant="int8")
    on_cpu = load_hf_safetensors(cfg, str(tmp_path / cfg.name), device=torch.device("cpu"),
                                 quant="int8")
    for (name, a), (_, b) in zip(param_leaves(on_card), param_leaves(on_cpu)):
        assert a.is_cuda and torch.equal(a.cpu(), b), name
    prompt = "checkpoint on the card"
    provider = GPUProvider(device=cuda, checkpoint_dir=str(tmp_path), quant="int8")
    try:
        got = provider.query(Context.background(), Request(
            model=f"gpu:{cfg.name}", prompt=prompt, max_tokens=16)).content
    finally:
        provider.release()
    moved = Engine(cfg, _to(on_cpu, cuda), device=cuda, quant="int8")
    assert got == moved.generate(prompt, SamplingParams(max_new_tokens=16)).text


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


# -- the telemetry planes on the card (obs/) ------------------------------------------------


@pytest.fixture
def planes():
    """The attribution and roofline ledgers, installed for the test only."""
    from llm_consensus_tpu_torch import obs

    obs.reset_planes()
    led = obs.attrib.ChipTimeLedger(warmup_s=3600.0)
    rl = obs.roofline.RooflineLedger()
    obs.attrib.install(led)
    obs.roofline.install(rl)
    yield led, rl
    obs.reset_planes()


def _small_engine(cuda):
    from llm_consensus_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig(name="obs-small", family="llama", vocab_size=512, d_model=512,
                      n_layers=4, n_heads=8, n_kv_heads=2, head_dim=64, d_ff=1024,
                      max_seq_len=1024)
    return Engine(cfg, device=cuda, stream_interval=8)


def test_family_walls_cover_the_profiled_kernel_time(cuda, planes):
    """The ledger's stream intervals of one generate hold every kernel the
    profiler saw in it and fit inside its wall."""
    import time

    from torch.profiler import ProfilerActivity, profile

    led, _ = planes
    engine = _small_engine(cuda)
    sp = SamplingParams(max_new_tokens=40, ignore_eos=True)
    engine.generate_ids(list(range(1, 200)), sp)  # warm: kernels built, keys counted
    before = led.snapshot()["busy_s"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        engine.generate_ids(list(range(1, 200)), sp)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    busy = led.snapshot()["busy_s"] - before
    kernels = sum(getattr(e, "self_device_time_total", 0.0) or getattr(e, "self_cuda_time_total", 0.0)
                  for e in prof.key_averages()
                  if "CUDA" in str(getattr(e, "device_type", ""))) / 1e6
    if kernels == 0:
        pytest.skip("torch.profiler saw no device time")
    # The ledger rounds to 0.1 ms.
    assert kernels - 1e-4 <= busy <= wall + 1e-4, (kernels, busy, wall)


def test_capture_books_a_kernel_launch_and_launches_it(cuda, planes):
    _, rl = planes
    q, k, v = _bf16(cuda, 7, (1, 128, 8, 64), (1, 128, 2, 64), (1, 128, 2, 64))
    before = fa.LAUNCHES.count
    with rl.dispatch("prefill", ("f",), tokens=128):
        fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES.count == before + 1
    flops, nbytes, _ = fa.flash_work(q, k)
    fam = rl.snapshot(device_s={})["families"]["prefill"]
    assert (fam["flops"], fam["bytes"]) == (flops, nbytes)
    assert flops == 4.0 * 8 * 64 * (128 * 129 // 2)


def test_planes_add_no_synchronization(cuda, planes, monkeypatch):
    """The same generate with the planes bound and with none makes the same
    number of synchronize calls."""
    engine = _small_engine(cuda)
    bound = (engine._obs, engine._attrib, engine._roofline)
    sp = SamplingParams(max_new_tokens=40, ignore_eos=True)
    engine.generate_ids(list(range(1, 100)), sp)
    counts = {}
    calls = [0]
    sync, event_sync = torch.cuda.synchronize, torch.cuda.Event.synchronize

    def counted(fn):
        def wrapper(*a, **kw):
            calls[0] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(torch.cuda, "synchronize", counted(sync))
    monkeypatch.setattr(torch.cuda.Event, "synchronize", counted(event_sync))
    for arm in ("off", "on"):
        engine._obs, engine._attrib, engine._roofline = bound if arm == "on" else (None,) * 3
        calls[0] = 0
        engine.generate_ids(list(range(1, 100)), sp)
        counts[arm] = calls[0]
    engine._obs, engine._attrib, engine._roofline = bound
    assert bound[1] is not None and counts["on"] == counts["off"] > 0


def test_hbm_device_stats_read_the_card(cuda, planes):
    led, _ = planes
    x = torch.empty(1 << 20, device=cuda)
    st = led.hbm_device_stats()
    assert st["bytes_in_use"] >= x.numel() * 4 and st["peak_bytes_in_use"] >= st["bytes_in_use"]
    assert st["bytes_limit"] == torch.cuda.get_device_properties(0).total_memory
    assert "device" in led.snapshot()["hbm"]


# -- prefix reuse, the prefill session and the retry ladder on the card --------------

# bf16 logits of two computation orders (a restored or appended cache against a
# one-shot prefill), the bound chip_smoke.py holds the batched path to.
REUSE_LOGIT_TOL = 0.25


def _reuse_engines(cuda):
    cfg = get_config("tiny-llama", head_dim=128)
    eng = Engine(cfg, max_seq=1024, device=cuda, prefill_chunk=128, stream_interval=8)
    fresh = Engine(cfg, eng.params, max_seq=1024, device=cuda, prefill_chunk=128,
                   stream_interval=8, prefix_cache=False)
    return eng, fresh


def test_prefix_reuse_on_the_card_matches_a_fresh_engine(cuda):
    eng, fresh = _reuse_engines(cuda)
    ids = [eng.tokenizer.bos_id] + list(range(32, 127)) * 3
    s = SamplingParams(max_new_tokens=24, ignore_eos=True)
    first = eng.generate_ids(ids, s)
    follow = ids + first.token_ids + list(range(40, 100))
    assert eng._reusable_prefix(follow)[0] == len(ids) + 24
    with torch.inference_mode():
        reused, _ = eng._prefill_ids(follow)
        ref, _ = fresh._prefill_ids(follow)
    assert bool(torch.isfinite(reused).all())
    assert (reused - ref).abs().max().item() <= REUSE_LOGIT_TOL
    # The snapshot is only read: three generates of one prompt agree.
    runs = [eng.generate_ids(follow, s).token_ids for _ in range(3)]
    assert runs[0] == runs[1] == runs[2]


def test_prefill_session_on_the_card_matches_one_shot(cuda):
    """Uneven appends of a 384-token prompt (three whole chunks): the
    session's last logits against the one-shot chunked prefill, then its
    decode."""
    eng, fresh = _reuse_engines(cuda)
    ids = [eng.tokenizer.bos_id] + (list(range(32, 127)) * 5)[:383]
    with torch.inference_mode():
        ref, _ = fresh._prefill_ids(ids)
    sess = eng.prefill_session()
    for i in range(0, len(ids), 100):
        sess.append(ids[i:i + 100])
    sess.sync()
    assert sess.prefilled == len(ids) == 384
    assert (sess._last_logits - ref).abs().max().item() <= REUSE_LOGIT_TOL
    out = sess.generate(SamplingParams(max_new_tokens=16, ignore_eos=True))
    assert len(out.token_ids) == 16 and out.prompt_tokens == len(ids)
    assert all(0 <= t < eng.cfg.vocab_size for t in out.token_ids)


def test_ladder_propagates_a_kernel_error_on_the_card(cuda, monkeypatch):
    from llm_consensus_tpu_torch.ops.kernels.build import KernelLaunchError
    from llm_consensus_tpu_torch.providers import Request
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider
    from llm_consensus_tpu_torch.utils.context import Context

    provider = GPUProvider(device=cuda, max_seq=256)
    req = Request(model="gpu:tiny-llama", prompt="ladder probe", max_tokens=8)
    try:
        assert provider.query(Context.background(), req).tokens == 8
        engine = provider.engines()["tiny-llama"]
        builds = []
        monkeypatch.setattr(provider, "_build_engine", lambda preset: builds.append(preset))

        def launch_failed(*a, **k):
            raise KernelLaunchError("decode_bf16_kernel: an illegal memory access")

        monkeypatch.setattr(engine, "generate", launch_failed)
        with pytest.raises(KernelLaunchError):
            provider.query(Context.background(), req)
        assert builds == [] and provider.engines()["tiny-llama"] is engine
    finally:
        provider.release()


# -- the row-bucketed pool's rows and preemption (the serving slice) -------------------

ROWS16 = (0, 17, 100, 5, 0, 300, 31, 2, 64, 0, 200, 9, 1, 150, 40, 77)


@pytest.mark.parametrize("state", [False, True], ids=["out", "state"])
@pytest.mark.parametrize("pos,width", [(383, 384), (2047, 2048)])
def test_decode_kernel_at_16_rows_matches_plain(cuda, state, pos, width):
    """The bf16 decode kernel and its return_state form at B = 16 (a
    row-bucketed pool's middle size), ragged row starts, garbage past pos."""
    q, k, v = _bf16(cuda, 30, (16, 1, 32, 128), (2, 16, 2048, 8, 128), (2, 16, 2048, 8, 128))
    k[1, :, pos + 1:] = float("nan")
    v[1, :, pos + 1:] = float("nan")
    kw = dict(kv_width=width, return_state=state)
    counter = da.LAUNCHES_STATE if state else da.LAUNCHES
    before = counter.count
    got = da.decode_attention(q, k, v, _i32(cuda, pos)[0], _i32(cuda, 1)[0], _i32(cuda, *ROWS16),
                              **kw)
    torch.cuda.synchronize()
    assert counter.count == before + 1
    want = da.decode_attention_plain(q, k, v, pos, 1, _i32(cuda, *ROWS16), **kw)
    out, ref = (got[0], want[0]) if state else (got, want)
    assert bool(torch.isfinite(out).all())
    err, tol = _decode_err_and_tol(out, ref)
    assert err <= tol
    if state:
        assert (got[1] - want[1]).abs().max().item() <= 1e-2
        assert ((got[2] - want[2]).abs() <= 1e-2 * want[2].abs() + 1e-6).all()


def test_batcher_preempt_resume_on_the_card(cuda):
    """consensus-1b at its published width (random weights): a HIGH
    latecomer preempts one of two LOW residents of a 2-row pool; the victim
    resumes through a flash prefill of its prompt and emitted tokens and
    every stream runs its full length with in-vocabulary tokens (greedy
    tokens against single-stream, with bf16 near-ties, are chip_smoke.py's
    serving phase (c))."""
    from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher

    engine = Engine(get_config("consensus-1b"), device=cuda)
    b = ContinuousBatcher(engine, max_batch=2)
    s_low = SamplingParams(max_new_tokens=96, ignore_eos=True)
    s_high = SamplingParams(max_new_tokens=32, ignore_eos=True)
    lows = [[engine.tokenizer.bos_id] + list(range(40 + i, 120 + i)) * 4 for i in range(2)]
    try:
        for _attempt in range(3):
            futs = [b.submit_ids(ids, s_low, priority=2) for ids in lows]
            while sum(1 for st in list(b._slots) if st is not None and len(st.out_ids) >= 16) < 2:
                time.sleep(0.002)
            flash0 = fa.LAUNCHES.count
            high = b.submit_ids(lows[0][:200], s_high, priority=0).result(timeout=300)
            results = [f.result(timeout=300) for f in futs]
            if b.snapshot()["preemptions"]:
                break
        assert b.snapshot()["preemptions"] >= 1
        # The latecomer's admission and the victim's resume: two flash prefills.
        assert fa.LAUNCHES.count - flash0 >= 2 * engine.cfg.n_layers
        assert len(high.token_ids) == 32 and all(len(r.token_ids) == 96 for r in results)
        assert any(r.preempted for r in results) and not high.preempted
        assert all(r.finish_reason == "length" for r in results + [high])
        assert all(0 <= t < engine.cfg.vocab_size for r in results for t in r.token_ids)
    finally:
        b.close()
