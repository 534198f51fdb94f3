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


def test_generate_batch_decodes_through_the_kernel_with_row_starts(cuda):
    """``Engine.generate_batch`` on the card: the left-padded batch prefill
    takes the plain op (no flash launch), every decode step one decode
    launch a layer with the rows' starts, and each row's tokens match its
    single-stream generate or sit at a bf16 near-tie (at least the first
    token equal)."""
    engine = Engine(get_config("tiny-llama", head_dim=128), max_seq=512, device=cuda)
    prompts = ["short", "a somewhat longer prompt of the batch " * 2, "mid-length prompt " * 3]
    s = SamplingParams(max_new_tokens=17, ignore_eos=True)
    flash0, plain0, state0 = fa.LAUNCHES.count, da.LAUNCHES.count, da.LAUNCHES_STATE.count
    got = engine.generate_batch(prompts, s)
    torch.cuda.synchronize()
    assert fa.LAUNCHES.count == flash0 and da.LAUNCHES_STATE.count == state0
    assert da.LAUNCHES.count - plain0 == 16 * engine.cfg.n_layers  # one 16-step chunk
    for prompt, r in zip(prompts, got):
        solo = engine.generate(prompt, s).token_ids
        assert len(r.token_ids) == 17 and r.token_ids[0] == solo[0]


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


# -- crash recovery and the finite-logit sentinel (the recovery slice) -----------------------


def test_crash_replay_on_the_card(cuda):
    """consensus-1b at its published width (random weights from seed 0):
    crash@chunk=2 under a journaled 2-slot provider with three streams. One
    rebuild, every stream runs its full length with the text it streamed
    continuous, the journal empty, the rebuilt engine's weights equal to the
    first one's, and the replay prefilled through flash and decoded through
    the decode kernel (greedy tokens against single-stream, with bf16
    near-ties, are chip_smoke.py's recovery phase (a))."""
    import threading

    from llm_consensus_tpu_torch import faults, integrity
    from llm_consensus_tpu_torch.providers import Request
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider
    from llm_consensus_tpu_torch.recovery import StreamJournal
    from llm_consensus_tpu_torch.utils.context import Context

    faults.install(faults.FaultPlan("crash@chunk=2", seed=7))
    provider = GPUProvider(device=cuda, batch_streams=2, journal=StreamJournal(),
                           ignore_eos=True, max_seq=1024)
    prompts = [f"crash replay probe {i} " * (4 + 3 * i) for i in range(3)]
    results, streamed = [None] * 3, [[] for _ in range(3)]
    try:
        digest0 = integrity.digest_tree(provider._engine_for("gpu:consensus-1b").params)

        def fire(i):
            results[i] = provider.query_stream(
                Context.background(),
                Request(model="gpu:consensus-1b", prompt=prompts[i], max_tokens=64),
                streamed[i].append)

        flash0, decode0 = fa.LAUNCHES.count, da.LAUNCHES.count
        threads = [threading.Thread(target=fire, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        stats = provider.recovery_stats()
        assert (stats["restarts"], stats["journal_depth"]) == (1, 0), stats
        assert stats["replayed_streams"] >= 1
        for r, chunks in zip(results, streamed):
            assert r is not None and r.tokens == 64 and "".join(chunks) == r.content
        digest1 = integrity.digest_tree(provider.engines()["consensus-1b"].params)
        assert digest1 == digest0
        assert fa.LAUNCHES.count > flash0 and da.LAUNCHES.count > decode0
    finally:
        provider.release()
        faults.reset()


def test_poisoned_row_fails_typed_on_the_card(cuda):
    """consensus-1b, a 4-row pool with the integrity plane on and
    nan_logits@row=1: row 1's stream fails with IntegrityError and the
    other three equal the clean plane-on run's tokens."""
    from llm_consensus_tpu_torch import faults, integrity
    from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher

    cfg = get_config("consensus-1b")
    s = SamplingParams(max_new_tokens=48, ignore_eos=True)
    prompts = [[1] + list(range(30 + 7 * i, 130 + 7 * i)) for i in range(4)]

    def run():
        b = ContinuousBatcher(Engine(cfg, device=cuda, max_seq=1024), max_batch=4)
        try:
            futs = [b.submit_ids(ids, s) for ids in prompts]
            out = []
            for f in futs:
                try:
                    out.append(f.result(timeout=300).token_ids)
                except integrity.IntegrityError as exc:
                    out.append(exc)
            return out
        finally:
            b.close()

    plane = integrity.IntegrityPlane()
    integrity.install(plane)
    try:
        clean = run()
        faults.install(faults.FaultPlan("nan_logits@row=1", seed=5))
        poisoned = run()
    finally:
        faults.reset()
        integrity.reset()
    assert all(isinstance(t, list) and len(t) == 48 for t in clean)
    assert isinstance(poisoned[1], integrity.IntegrityError)
    assert poisoned[1].surface == "logits"
    assert [poisoned[i] for i in (0, 2, 3)] == [clean[i] for i in (0, 2, 3)]
    assert plane.stats()["failures"] == {"logits": 1}


# -- the KV pool's block copies (kv/pool.py) -----------------------------------------------------


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["bf16", "int8"])
def test_kv_pool_block_copies_on_the_card(cuda, kv_quant):
    """llama-3-8b's cache layout at 64-token blocks: a publish copies each
    of a 1,501-token cache's 24 blocks (the last partial) to its slot and
    leaves every other arena block byte for byte as it was; a gather of the
    chain gives back the cache's bytes at [0, 24 x 64)."""
    from llm_consensus_tpu_torch.kv import KVPool
    from llm_consensus_tpu_torch.kv import pool as pool_mod
    from llm_consensus_tpu_torch.models.transformer import init_kv_cache

    cfg = get_config("llama-3-8b")
    pool = KVPool(cfg, dtype=torch.bfloat16, kv_quant=kv_quant, device=cuda, max_seq=2048,
                  block_size=64, budget_bytes=40 * 64 * 131_072,
                  new_cache=lambda n: init_kv_cache(cfg, 1, n, device=cuda,
                                                    dtype=torch.bfloat16, quant=kv_quant))
    gen = torch.Generator(device=cuda).manual_seed(0)

    def fill(cache):
        for leaf in pool_mod._leaves(cache):
            if leaf.dtype == torch.int8:
                leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=gen, device=cuda))
            else:
                leaf.copy_(torch.randn(leaf.shape, generator=gen, device=cuda))

    with torch.inference_mode():
        fill(pool._arena)
        before = [leaf.clone() for leaf in pool_mod._leaves(pool._arena)]
        src = init_kv_cache(cfg, 1, 2048, device=cuda, dtype=torch.bfloat16, quant=kv_quant)
        fill(src)
    ids = list(range(1501))
    wrote, truncated = pool.publish(ids, src)
    assert (wrote, truncated) == (24, False)
    slots = [b.slot for b in pool._radix.match(ids)[1]]
    torch.cuda.synchronize()
    for leaf, old, s in zip(pool_mod._leaves(pool._arena), before, pool_mod._leaves(src)):
        ax = pool_mod.kv_seq_axis(leaf)
        for slot in range(pool.n_blocks):
            got = leaf.narrow(ax, slot * 64, 64)
            want = (s.narrow(ax, slots.index(slot) * 64, 64) if slot in slots
                    else old.narrow(ax, slot * 64, 64))
            assert torch.equal(got, want), (slot, slot in slots)
    n, cache = pool.lookup(ids, min_tokens=512)
    torch.cuda.synchronize()
    assert n == 1500
    for g, s in zip(pool_mod._leaves(cache), pool_mod._leaves(src)):
        ax = pool_mod.kv_seq_axis(g)
        assert torch.equal(g.narrow(ax, 0, 24 * 64), s.narrow(ax, 0, 24 * 64))


def test_kv_pool_hit_on_the_card_matches_a_fresh_engine(cuda):
    """A consensus-1b follow-up on a pool hit: logits within the reuse
    tolerance of a fresh engine's, the gathered cache restored in place."""
    cfg = get_config("consensus-1b")
    eng = Engine(cfg, max_seq=1024, device=cuda, prefill_chunk=128, stream_interval=8,
                 kv_pool=True, kv_pool_block=64, kv_pool_mb=64.0)
    fresh = Engine(cfg, eng.params, max_seq=1024, device=cuda, prefill_chunk=128,
                   stream_interval=8, prefix_cache=False)
    ids = [eng.tokenizer.bos_id] + list(range(32, 127)) * 3
    s = SamplingParams(max_new_tokens=24, ignore_eos=True)
    first = eng.generate_ids(ids, s)
    follow = ids + first.token_ids + list(range(40, 100))
    with torch.inference_mode():
        reused, _ = eng._prefill_ids(follow)
        ref, _ = fresh._prefill_ids(follow)
    assert eng._kv_pool.stats()["hits"] == 1
    assert bool(torch.isfinite(reused).all())
    assert (reused - ref).abs().max().item() <= REUSE_LOGIT_TOL


# -- speculative decoding (the speculation slice) -------------------------------------

# bf16 greedy tokens of a verify forward (T = k + 1, the plain op) and of a
# decode step (T = 1, the decode kernel) may flip where the two best logits
# are this close; a misplaced or lost token reads far above it.
SPEC_NEAR_TIE = 0.25


def _spec_equal_or_near_tie(engine, ids, got, want):
    """Greedy tokens equal, or equal up to a first difference where the two
    tokens' logits (teacher-forced on ``want``) are within SPEC_NEAR_TIE."""
    from llm_consensus_tpu_torch.models.transformer import forward

    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if i is None:
        return len(got) == len(want)
    with torch.inference_mode():
        logits, _ = forward(engine.params, engine.cfg,
                            torch.tensor([ids + want[:i]], device=engine.device), None, 0)
    last = logits[0, -1].float()
    return abs(float(last[got[i]] - last[want[i]])) <= SPEC_NEAR_TIE


def test_spec_drafted_generate_on_the_card(cuda):
    """llama-3.2-1b (dh 64) drafted by another llama-3.2-1b: the draft's
    steps launch the decode kernel (k + 1 steps a round, every layer), the
    verify forwards none, both prompts flash once a layer; the tokens equal
    plain decode up to a bf16 near-tie."""
    from llm_consensus_tpu_torch.engine import SpeculativeEngine

    cfg = get_config("llama-3.2-1b")
    target = Engine(cfg, device=cuda, max_seq=1024, seed=0)
    draft = Engine(cfg, device=cuda, max_seq=1024, seed=1)
    ids = [target.tokenizer.bos_id] + list(range(40, 140)) * 3
    prompt = target.tokenizer.decode(ids[1:])
    s = SamplingParams(max_new_tokens=48, ignore_eos=True)
    want = target.generate(prompt, s)
    spec = SpeculativeEngine(target, draft, k=4, adaptive=False, governor=False)
    flash0, dec0 = fa.LAUNCHES.count, da.LAUNCHES.count
    got = spec.generate(prompt, s)
    rounds = spec.stats["rounds"]
    assert fa.LAUNCHES.count - flash0 == 2 * cfg.n_layers
    assert da.LAUNCHES.count - dec0 == rounds * 5 * cfg.n_layers
    assert len(got.token_ids) == 48 and rounds > 0
    p_ids = target.tokenizer.encode(prompt)
    assert _spec_equal_or_near_tie(target, p_ids, got.token_ids, want.token_ids)


def test_spec_pool_on_the_card(cuda):
    """consensus-1b at its published width: a 4-row prompt-lookup pool
    runs rounds (no kernel in a verify), every stream equal to
    single-stream up to a bf16 near-tie."""
    from llm_consensus_tpu_torch.engine import SpecConfig
    from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher

    engine = Engine(get_config("consensus-1b"), device=cuda, max_seq=1024)
    prompts = [[engine.tokenizer.bos_id] + list(range(40 + i, 90 + i)) * 3 for i in range(4)]
    s = SamplingParams(max_new_tokens=40, ignore_eos=True)
    refs = [engine.generate_ids(p, s).token_ids for p in prompts]
    b = ContinuousBatcher(engine, max_batch=4, spec=SpecConfig(kind="lookup", governor=False))
    try:
        dec0 = da.LAUNCHES.count
        got = [f.result(timeout=300).token_ids for f in [b.submit_ids(p, s) for p in prompts]]
        snap = b.spec_snapshot()
    finally:
        b.close()
    assert da.LAUNCHES.count == dec0  # verify and plain windows: the plain op
    assert snap["rounds"] > 0
    for p, g, r in zip(prompts, got, refs):
        assert _spec_equal_or_near_tie(engine, p, g, r)


# -- the weight swap and the gateway (the serve slice) -------------------------------------


def test_engine_swap_on_the_card_keeps_a_pinned_stream_and_rolls_back(cuda):
    """consensus-1b at its published width: a stream pinned across a swap
    keeps its bytes (the flip parks until it ends), the flip frees nothing
    early (the replaced tree stays resident as the rollback buffer, its
    storage intact), and a rollback restores the v0 tokens under version 2."""
    from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher
    from llm_consensus_tpu_torch.models.transformer import init_params

    cfg = get_config("consensus-1b")
    engine = Engine(cfg, device=cuda, max_seq=1024, seed=0)
    s = SamplingParams(max_new_tokens=64, ignore_eos=True)
    ids = [engine.tokenizer.bos_id] + list(range(40, 140)) * 2
    ref = engine.generate_ids(ids, s).token_ids
    snapshot = {name: t.clone() for name, t in _leaves(engine.params)}
    ptrs = {name: t.data_ptr() for name, t in _leaves(engine.params)}
    new = init_params(cfg, 1, device=cuda, dtype=engine.dtype)
    weight_bytes = sum(t.numel() * t.element_size() for _, t in _leaves(new))
    b = ContinuousBatcher(engine, max_batch=2)
    try:
        fut = b.submit_ids(ids, s)
        while engine.swap_stats()["pins"] == 0:
            time.sleep(0.001)
        assert engine.swap_weights(1, new) is True
        assert engine.swap_pending()
        got = fut.result(timeout=300).token_ids
        while engine.weight_version < 1:
            time.sleep(0.001)
    finally:
        b.close()
    del new
    torch.cuda.synchronize()
    assert got == ref  # the pinned stream ran on v0 to its end
    assert engine.swap_stats()["swap_queued"] == 1
    # Nothing freed early: the replaced tree (held by nothing but the
    # engine) is the rollback buffer, in its own storage, bytes unchanged.
    prev = dict(_leaves(engine._prev_weights[1]))
    assert {name: t.data_ptr() for name, t in prev.items()} == ptrs
    assert all(torch.equal(t, snapshot[name]) for name, t in prev.items())
    assert torch.cuda.memory_allocated() >= 2 * weight_bytes
    assert engine.generate_ids(ids, s).token_ids != ref
    assert engine.rollback_weights() == 2
    assert engine.generate_ids(ids, s).token_ids == ref


def _leaves(tree, prefix=""):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", value


def test_one_gateway_request_through_serve_main_on_the_card(cuda, tmp_path):
    """``serve_main`` on the card (device=None) with a tiny-llama panel of
    two and judge: one request answers 200 with both responses and a
    consensus, flash and the decode kernel launch, the drain returns 0."""
    import http.client
    import io
    import json
    import threading

    from llm_consensus_tpu_torch import obs
    from llm_consensus_tpu_torch.cli.serve import serve_main

    obs.reset_planes()
    stop, err, rc = threading.Event(), io.StringIO(), []
    argv = ["--models", "gpu:tiny-llama,gpu:tiny-llama", "--judge", "gpu:tiny-llama",
            "--max-tokens", "32", "--port", "0", "--data-dir", str(tmp_path)]
    t = threading.Thread(target=lambda: rc.append(serve_main(
        argv, stdout=io.StringIO(), stderr=err, install_signal_handlers=False, shutdown=stop)),
        daemon=True)
    flash0, dec0 = fa.LAUNCHES.count, da.LAUNCHES.count
    t.start()
    try:
        deadline = time.monotonic() + 120
        while "http://" not in err.getvalue() and time.monotonic() < deadline:
            time.sleep(0.01)
        port = int(err.getvalue().split("http://", 1)[1].split("/", 1)[0].rsplit(":", 1)[1])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/v1/consensus", json.dumps({"prompt": "hello card " * 20}),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        doc = json.loads(r.read())
        conn.close()
    finally:
        stop.set()
        t.join(120)
        obs.reset_planes()
    assert r.status == 200 and len(doc["responses"]) == 2 and doc["consensus"]
    assert rc == [0]
    assert fa.LAUNCHES.count > flash0 and da.LAUNCHES.count > dec0
    assert (tmp_path / doc["run_id"] / "result.json").exists()


def test_router_fails_a_stream_over_between_two_gateways_on_the_card(cuda, tmp_path):
    """Two consensus-1b gateways on the card (panel of one, the judge passing
    its answer through), each over its own provider (engines at 1,024
    slots, random weights from one seed), behind a router
    that loses the first replica at the second SSE frame: the client gets
    the undisturbed stream's text exactly, one ``done`` naming the second
    replica, and flash and the decode kernel launch through the routed
    request."""
    import http.client
    import json

    from llm_consensus_tpu_torch import faults, obs, serve
    from llm_consensus_tpu_torch.providers import Registry
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider
    from llm_consensus_tpu_torch.serve.router import RouteRequest

    model = "gpu:consensus-1b"

    def sse(port, body):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            conn.request("POST", "/v1/consensus", json.dumps(dict(body, stream=True)),
                         {"Content-Type": "application/json", "Accept": "text/event-stream"})
            r = conn.getresponse()
            assert r.status == 200
            events, name = [], None
            for raw in r:
                line = raw.decode("utf-8").rstrip("\r\n")
                if line.startswith("event: "):
                    name = line[len("event: "):]
                elif line.startswith("data: "):
                    events.append((name, json.loads(line[len("data: "):])))
        finally:
            conn.close()
        text: dict = {}
        for n, d in events:
            if n == "chunk":
                text[d["model"] + d["kind"]] = text.get(d["model"] + d["kind"], "") + d["text"]
        return events, text

    obs.reset_planes()
    faults.reset()
    gws, providers, router = [], [], None
    try:
        for tag in ("a", "b"):
            torch.manual_seed(0)
            provider = GPUProvider(device=None, max_seq=1024, batch_streams=2)
            registry = Registry()
            registry.register(model, provider)
            gw = serve.build_gateway(registry, [model], model, max_tokens=48,
                                     cache_size=0, data_dir=str(tmp_path / tag), save=False,
                                     pressure={"enabled": False})
            gw.start()
            gws.append(gw)
            providers.append(provider)
        urls = ["http://%s:%d" % g.address for g in gws]
        body = next(b for b in ({"prompt": f"route card probe {i} " * 8} for i in range(100))
                    if serve.fleet.ring_order(RouteRequest(b"", dict(b), False).key(),
                                              urls)[0] == urls[0])
        _, want = sse(gws[1].address[1], body)
        faults.install(faults.FaultPlan("replica_down@phase=proxy@frame=2", seed=1))
        router = serve.build_router(urls, poll_s=60.0)
        faults.install(None)
        router.start()
        flash0, dec0 = fa.LAUNCHES.count, da.LAUNCHES.count
        events, got = sse(router.address[1], body)
    finally:
        faults.reset()
        if router is not None:
            router.close()
        for gw in gws:
            gw.close(drain=True, timeout=120)
        for provider in providers:
            provider.release()
        obs.reset_planes()
    names = [n for n, _ in events]
    assert names.count("done") == 1 and names[-1] == "done"
    assert events[-1][1]["failovers"] == 1 and events[-1][1]["replica"] == urls[1]
    assert got == want
    assert fa.LAUNCHES.count > flash0 and da.LAUNCHES.count > dec0


def test_handoff_on_its_own_stream_publishes_the_prefill_bytes(cuda):
    """consensus-1b at its published width, both roles on the card: the
    prefill worker's wave of two one-chunk rows (512 tokens, the shortest a
    shared-device handoff takes) runs on its own CUDA stream (flash at
    B = 2) and
    its publish is ordered after it, so the decode side gathers exactly
    the bytes a prefill of the same rows gives on the default stream; the
    flash launches are the worker thread's (one a layer a wave; the two
    rows may land in one wave or two)."""
    import threading as th

    from llm_consensus_tpu_torch.engine.handoff import KVHandoff
    from llm_consensus_tpu_torch.ops.quant import kv_seq_axis

    cfg = get_config("consensus-1b")
    de = Engine(cfg, max_seq=1024, device=cuda, prefill_chunk=512, kv_pool=True,
                kv_pool_block=64, kv_pool_mb=256.0)
    pe = Engine(cfg, de.params, max_seq=1024, device=cuda, prefill_chunk=512,
                prefix_cache=False)
    rows = [[de.tokenizer.bos_id] + [(7 * i + j) % 90 + 32 for i in range(511)]
            for j in range(2)]
    # The references, as one wave of both rows and as one wave a row (the
    # worker may pop the first ticket before the second arrives).
    refs = {2: [pe.admission_session(rows).run()[1]] * 2,
            1: [pe.admission_session([r]).run()[1] for r in rows]}
    threads: list = []
    real_add = fa.LAUNCHES.add

    def add():
        threads.append(th.current_thread().name)
        real_add()

    fa.LAUNCHES.add = add
    h = KVHandoff(pe, de, wave_rows=2, name="card")
    try:
        tickets = [h.submit(r, 1) for r in rows]
        assert all(t is not None and t.wait(120) and t.ok for t in tickets), h.snapshot()
    finally:
        h.close()
        del fa.LAUNCHES.add
    assert threads and all(name.startswith("llmc-handoff-") for name in threads)
    assert len(threads) == cfg.n_layers * h.waves  # one flash a layer a wave
    for j, r in enumerate(rows):
        n, gathered = de._kv_pool.lookup(r + [40], min_tokens=1)
        span = (len(r) // 64) * 64
        assert n == span
        ref, row = refs[3 - h.waves][j], j if h.waves == 1 else 0
        for name in ("k", "v"):
            want = ref[name].narrow(1, row, 1).narrow(kv_seq_axis(ref[name]), 0, span)
            got = gathered[name].narrow(kv_seq_axis(gathered[name]), 0, span)
            assert torch.equal(got, want), (j, name)


# -- head slices of a tensor-parallel shard, and a tp = 2 engine (parallel/) ------------------


@pytest.mark.parametrize("tp,hq,hkv", [(2, 16, 4), (8, 4, 1)], ids=["tp2", "tp8"])
def test_kernels_on_a_shards_head_slice(cuda, tp, hq, hkv):
    """llama-3-8b's heads over tp positions (group 4): flash at q[1,512,Hq,128]
    and the bf16 and int8 decode kernels over one shard's contiguous
    [L, 1, S, Hkv, 128] cache, each against its plain version."""
    q, k, v = _bf16(cuda, 20 + tp, (1, 512, hq, 128), (1, 512, hkv, 128), (1, 512, hkv, 128))
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert (got.float() - fa.flash_attention_plain(q, k, v).float()).abs().max().item() < TOL
    q, k, v = _bf16(cuda, 30 + tp, (1, 1, hq, 128), (2, 1, 8192, hkv, 128),
                    (2, 1, 8192, hkv, 128))
    rs = _i32(cuda, 0)
    for pos, width in ((383, 384), (8191, 8192)):
        got = da.decode_attention(q, k, v, _i32(cuda, pos)[0], _i32(cuda, 1)[0], rs,
                                  kv_width=width)
        torch.cuda.synchronize()
        err, tol = _decode_err_and_tol(got, da.decode_attention_plain(q, k, v, pos, 1, rs,
                                                                      kv_width=width))
        assert err <= tol
    k8, v8 = _int8_cache(cuda, 40 + tp, 2, 1, 2048, hkv), _int8_cache(cuda, 50 + tp, 2, 1, 2048,
                                                                     hkv)
    before = da.LAUNCHES_INT8.count
    got = da.decode_attention(q, k8, v8, _i32(cuda, 1000)[0], _i32(cuda, 1)[0], rs,
                              kv_width=1024)
    torch.cuda.synchronize()
    assert da.LAUNCHES_INT8.count == before + 1
    err, tol = _decode_err_and_tol(got, da.decode_attention_plain(q, k8, v8, 1000, 1, rs,
                                                                  kv_width=1024))
    assert err <= tol


def test_tp2_engine_on_two_positions_of_the_card_matches_tp1(cuda):
    """A tp = 2 bf16 Engine on virtual_devices(2, "cuda") against the tp = 1
    engine on the same weights: each shard launches its own flash and decode
    kernels (twice the layers' launches), and the greedy tokens are equal or
    keep every token within 0.25 of the tp = 1 model's best logit under
    teacher forcing (the near-tie rule: the partial sums add in another
    order in bf16)."""
    from llm_consensus_tpu_torch.engine.engine import _bucket
    from llm_consensus_tpu_torch.models.transformer import init_kv_cache
    from llm_consensus_tpu_torch.parallel import make_mesh, virtual_devices

    cfg = get_config("tiny-llama", head_dim=128, n_heads=8, n_kv_heads=4)
    base = Engine(cfg, max_seq=256, device=cuda)
    sharded = Engine(cfg, base.params, max_seq=256,
                     mesh=make_mesh({"dp": 1, "tp": 2}, virtual_devices(2, cuda)))
    s = SamplingParams(max_new_tokens=20, ignore_eos=True)
    prompt_ids = base.tokenizer.encode("the quick brown fox")
    want = base.generate_ids(prompt_ids, s).token_ids
    flash0, decode0 = fa.LAUNCHES.count, da.LAUNCHES.count
    got = sharded.generate_ids(prompt_ids, s).token_ids
    assert fa.LAUNCHES.count - flash0 == 2 * cfg.n_layers
    assert da.LAUNCHES.count - decode0 >= 2 * 19 * cfg.n_layers
    assert len(got) == len(want)
    if got != want:
        ids = prompt_ids + got
        with torch.inference_mode():
            cache = init_kv_cache(cfg, 1, 256, device=cuda, dtype=base.dtype)
            tokens = base._ids_tensor(ids + [0] * (_bucket(len(ids), 256) - len(ids)))
            logits, _ = base._forward(tokens, cache, 0, attn_impl="flash")
            lg = logits[0, len(prompt_ids) - 1:len(ids) - 1].float()
            gaps = lg.max(-1).values - lg.gather(1, torch.tensor(got, device=cuda)[:, None])[:, 0]
        assert gaps.max().item() <= 0.25, gaps.tolist()
