"""Speculative decoding: a drafter proposes, the target verifies (port of
``llm_consensus_tpu/engine/speculative.py``).

Single-stream decode streams every weight once per token. Verifying ``k``
draft tokens in one target forward streams them once for up to ``k + 1``
tokens, so speculation pays when the mean accepted run length beats the
draft's cost plus the verify forward's.

Three draft sources behind one :class:`Drafter` interface:

  * :class:`ModelDrafter`: a second, smaller engine drafts ``k`` tokens as
    ``k + 1`` chained one-token steps (``_spec_draft``) through the decode
    kernel, every step on the device;
  * :class:`PromptLookupDrafter`: n-gram prompt lookup over a device token
    buffer (prompt + accepted output), the continuation of the most recent
    earlier occurrence of the last ``ngram`` tokens; no model, and the
    judge's quote-the-panel prompts are its workload;
  * :class:`OracleDrafter`: replays a known continuation, optionally
    forced to accept exactly ``accept`` tokens a round (``(tok + 1) %
    vocab`` junk after the first ``accept - 1``): the machinery's ceiling
    and its break-even curve.

A round is one proposal then ONE target forward over ``k + 1`` positions
with acceptance on the device; the verify forward runs the plain
attention op (T = k + 1 at a device position, as the JAX package runs XLA
there). The host chains rounds with the carry (tokens, position, caches,
token buffer) on the device and copies a round group's accepted tokens to
the host once (:func:`_to_host`). There is no cache rollback in a single
stream: junk KV past the accepted frontier is rewritten before any read
reaches it. The batched form cannot rewrite (rows share one frontier), so
rejected slots become per-row holes masked by a written-slot bitmap (the
transformer's ``kv_mask``); see ``_spec_verify_batch``.

Greedy acceptance keeps the longest draft prefix the target's argmax
agrees with plus the target's token at the first mismatch, so greedy
output is token-exact against the plain engine for any draft.
Rejection-sampling acceptance (temperature > 0, no top-k/top-p, model
drafter) keeps the target's output distribution for any draft
(:func:`rejection_accept`, a function of the probabilities, the drafts and
uniform draws). Random draws come from a ``torch.Generator`` reseeded from
``(seed, round)`` at each round, so a seeded generation does not depend on
how rounds group into fetches; its stream differs from JAX's PRNG by
design (tokens agree in distribution, not one by one).

Control plane (host side): :class:`AdaptiveK` walks the draft length
along a power-of-two ladder on an acceptance EMA; :class:`SpecGovernor`
measures a window of drafted decode, then a window of plain decode on the
same carry, and locks the faster mode. Everything here takes its settings
as arguments (the knobs' defaults); only the CLI reads the environment
(``utils/knobs.py`` ``spec_settings``).
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from llm_consensus_tpu_torch import faults as _faults
from llm_consensus_tpu_torch import obs
from llm_consensus_tpu_torch.engine.engine import Engine, GenerateResult, SamplingParams
from llm_consensus_tpu_torch.engine.tokenizer import StreamDecoder
from llm_consensus_tpu_torch.ops.sampling import sample_token
from llm_consensus_tpu_torch.utils.context import Context


# -- host-side control plane ---------------------------------------------------


def k_ladder(k_max: int) -> list[int]:
    """The power-of-two draft-length ladder {1, 2, 4, ...} and ``k_max``."""
    ladder = []
    v = 1
    while v < k_max:
        ladder.append(v)
        v *= 2
    ladder.append(k_max)
    return ladder


class AdaptiveK:
    """Per-stream draft-length controller on an acceptance EMA.

    ``observe(accepted, k_used)`` feeds one round's accepted count (in
    ``[1, k_used + 1]``); ``k`` is the rung the next round uses. It regrows
    one rung when the EMA sits near the ceiling and shrinks one when rounds
    mostly deliver only the correction token."""

    def __init__(self, k_max: int, alpha: float = 0.25, adaptive: bool = True):
        self.ladder = k_ladder(max(1, k_max))
        self._i = len(self.ladder) - 1  # start at k_max: optimistic
        self.alpha = alpha
        self.adaptive = adaptive
        self.ema = 1.0 + self.ladder[self._i] / 2.0  # neutral prior

    @property
    def k(self) -> int:
        return self.ladder[self._i]

    def observe(self, accepted: float, k_used: int) -> None:
        self.ema += self.alpha * (accepted - self.ema)
        if not self.adaptive:
            return
        if self.ema >= 0.8 * (k_used + 1) and self._i < len(self.ladder) - 1:
            self._i += 1
        elif self.ema <= 1.35 and self._i > 0:
            self._i -= 1


class SpecGovernor:
    """Online drafted-vs-plain A/B for one stream (or one pool).

    ``spec_probe`` → ``plain_probe`` → ``spec_locked`` | ``plain_locked``:
    each probe measures ``probe_tokens`` emitted tokens of wall time in its
    mode and the decision locks the faster one. Greedy modes emit the same
    tokens, so a losing drafter costs one probe window. ``feed`` is called
    at fetch boundaries."""

    def __init__(self, probe_tokens: int = 64, enabled: bool = True):
        self.enabled = enabled
        self.probe_tokens = max(1, probe_tokens)
        self.state = "spec_probe" if enabled else "spec_locked"
        self._tokens = 0
        self._wall = 0.0
        self._spec_rate: Optional[float] = None
        self.disabled_spec = False  # plain won the A/B

    @property
    def mode(self) -> str:
        """"spec" or "plain": what the next dispatch runs."""
        return "plain" if self.state in ("plain_probe", "plain_locked") else "spec"

    def feed(self, tokens: int, wall: float) -> bool:
        """Account one fetched window in the current mode; True when the
        mode just changed."""
        if self.state in ("spec_locked", "plain_locked"):
            return False
        self._tokens += tokens
        self._wall += wall
        if self._tokens < self.probe_tokens:
            return False
        rate = self._tokens / max(self._wall, 1e-9)
        if self.state == "spec_probe":
            self._spec_rate = rate
            self.state = "plain_probe"
            self._tokens, self._wall = 0, 0.0
            return True
        if self._spec_rate is not None and self._spec_rate >= rate:
            self.state = "spec_locked"
            return True
        self.state = "plain_locked"
        self.disabled_spec = True
        return False  # already in plain mode


@dataclass(frozen=True)
class SpecConfig:
    """Speculation plan of a continuous-batching pool (and the provider's):
    the drafter (``"lookup"`` or ``"oracle"``), the k ceiling and the
    control plane's settings, with the knobs' defaults (``LLMC_SPEC_K``,
    ``LLMC_SPEC_NGRAM``, ``LLMC_SPEC_ADAPT``, ``LLMC_SPEC_GOVERNOR``,
    ``LLMC_SPEC_PROBE``). ``oracle`` maps prompt ids to a known
    continuation (tests, measurements)."""

    kind: str
    k: int = 4
    ngram: int = 3
    adaptive: bool = True
    governor: bool = True
    probe_tokens: int = 64
    oracle: Optional[Callable] = None  # (prompt_ids: list) -> list[int]
    oracle_accept: Optional[int] = None  # force per-round acceptance


# -- drafters ------------------------------------------------------------------


class Drafter:
    """One draft source. ``needs_buffer`` drafters propose from the device
    token buffer and batch; the model drafter carries its own KV cache and
    serves single streams."""

    kind = "base"
    needs_buffer = False


class ModelDrafter(Drafter):
    """A second (smaller) engine proposes autoregressively."""

    kind = "model"

    def __init__(self, engine: Engine):
        self.engine = engine


class PromptLookupDrafter(Drafter):
    """n-gram prompt lookup (``_lookup_propose``): no model cost."""

    kind = "lookup"
    needs_buffer = True

    def __init__(self, ngram: int = 3):
        if ngram < 1:
            raise ValueError("ngram must be >= 1")
        self.ngram = ngram


class OracleDrafter(Drafter):
    """Replays a known continuation of the prompt. ``accept`` forces every
    round to accept exactly that many tokens: the first ``accept - 1``
    proposals are the oracle's, the rest ``(tok + 1) % vocab``. ``None``
    replays everything (every round accepts ``k + 1``)."""

    kind = "oracle"
    needs_buffer = True

    def __init__(self, continuation_ids: list, accept: Optional[int] = None):
        self.continuation_ids = list(continuation_ids)
        self.accept = accept


# -- one host copy per round group ---------------------------------------------


def _to_host(tensors: list) -> list[list]:
    """Copy ``tensors`` (integer, on one device) to the host with ONE copy:
    flattened into one int64 tensor, copied, split back. Returns each
    tensor's values as a flat list. The speculative loops fetch a round
    group's tokens, acceptances and frontier through here."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1).to(torch.long) for t in tensors])
    vals = flat.cpu().tolist()
    out, i = [], 0
    for t in tensors:
        n = t.numel()
        out.append(vals[i:i + n])
        i += n
    return out


# -- acceptance ----------------------------------------------------------------


def greedy_accept(drafts: torch.Tensor, greedy: torch.Tensor):
    """Greedy acceptance over the last axis: ``drafts`` [..., k], the
    target's argmax ``greedy`` [..., k + 1] after ``[cur, d_1..d_k]``.
    Returns ``(out [..., k + 1], a [...], leading [...])``: the longest
    agreeing draft prefix (``leading`` tokens), then the target's token
    there (the correction, or the bonus when every draft agreed), zeros
    after; ``a = leading + 1`` in ``[1, k + 1]``."""
    k = drafts.shape[-1]
    leading = (drafts == greedy[..., :-1]).long().cumprod(-1).sum(-1)
    idx = torch.arange(k + 1, device=drafts.device)
    dpad = torch.cat([drafts, torch.zeros_like(drafts[..., :1])], -1)
    corr = greedy.gather(-1, leading.unsqueeze(-1))
    lead = leading.unsqueeze(-1)
    out = torch.where(idx < lead, dpad, torch.where(idx == lead, corr, torch.zeros_like(dpad)))
    return out, leading + 1, leading


def rejection_accept(ps: torch.Tensor, qs: torch.Tensor, drafts: torch.Tensor,
                     us: torch.Tensor):
    """Rejection-sampling acceptance (Leviathan et al. 2023) as a function
    of tensors: target probabilities ``ps`` [k + 1, V], draft probabilities
    ``qs`` [k, V], the drafts [k] (drawn from ``qs``) and uniforms ``us``
    [k + 1] in [0, 1).

    Draft i is accepted when ``us[i] < min(1, p_i(d_i) / q_i(d_i))``; the
    first rejection draws the correction from ``max(p - q, 0)``
    (renormalized; ``p`` itself when that is numerically empty), a fully
    accepted round draws the bonus from ``p_k``; the draw is the inverse
    CDF at ``us[k]``. The emitted tokens are distributed as the target's.
    Returns ``(out [k + 1], a, leading)`` as :func:`greedy_accept`."""
    k = drafts.shape[0]
    rows = torch.arange(k, device=drafts.device)
    p_of_d = ps[rows, drafts]
    q_of_d = qs[rows, drafts]
    accept = us[:k] < torch.clamp(p_of_d / q_of_d.clamp(min=1e-30), max=1.0)
    leading = accept.long().cumprod(0).sum()
    q_at = qs[leading.clamp(max=k - 1)]
    p_at = ps[leading]
    resid = (p_at - q_at).clamp(min=0.0)
    use_resid = (leading < k) & (resid.sum() > 1e-12)
    probs = torch.where(use_resid, resid, p_at)
    cdf = torch.cumsum(probs, 0)
    corr = torch.searchsorted(cdf, (us[k] * cdf[-1]).reshape(1), right=True)
    corr = corr.clamp(max=probs.shape[0] - 1)[0]
    idx = torch.arange(k + 1, device=drafts.device)
    dpad = torch.cat([drafts, drafts.new_zeros(1)])
    out = torch.where(idx < leading, dpad,
                      torch.where(idx == leading, corr, torch.zeros_like(dpad)))
    return out, leading + 1, leading


def _round_seed(seed: int, round_no: int) -> int:
    """The sampled path's per-round generator seed: a function of the
    request's seed and the round counter only (never of fetch cadence)."""
    return (seed * 0x9E3779B1 + round_no * 0x85EBCA77 + 0x27D4EB2F) % (1 << 63)


def _frontier_shift(out: torch.Tensor, leading: torch.Tensor, cur: torch.Tensor):
    """``(prev', cur')`` after a round: the new current token and the one
    before it (the draft opener re-ingests it at ``pos - 1``)."""
    new_cur = out.gather(0, leading.reshape(1))
    new_prev = torch.where(leading > 0, out.gather(0, (leading - 1).clamp(min=0).reshape(1)),
                           cur)
    return new_prev, new_cur


# -- single-stream device programs ---------------------------------------------


def _spec_draft(drf: Engine, prev_tok, cur_tok, pos, dcache, k: int, kv_width):
    """Draft ``k`` proposals as ``k + 1`` chained one-token steps through
    the decode kernel: step 0 re-ingests ``prev`` at ``pos - 1`` (the
    bonus-token case, where the draft never saw the previous round's last
    accepted token; an idempotent rewrite otherwise) and its output is
    dropped; steps 1..k emit proposals. Returns the proposals [k]."""
    tok, outs = prev_tok, []
    for i in range(k + 1):
        lg, _ = drf._forward(tok[:, None], dcache, pos - 1 + i, attn_impl="flash",
                             kv_width=kv_width)
        nxt = torch.argmax(lg[:, -1], dim=-1)
        if i == 0:
            tok = cur_tok
        else:
            outs.append(nxt)
            tok = nxt
    return torch.cat(outs)


def _draft_ingest(drf: Engine, toks, pos, dcache, kv_width) -> None:
    """Catch the draft cache up over the tokens ``toks`` [1, n] the target
    decoded in a plain governor window (one forward, logits dropped)."""
    drf._forward(toks, dcache, pos, attn_impl="torch", kv_width=kv_width)


def _verify_forward(tgt: Engine, vin, cache, pos, kv_width, family_key, **rows):
    """One target forward over ``vin`` [B, k + 1] at ``pos`` through the
    plain attention op (the kernels are gated off for these shapes),
    counted under the roofline's ``spec_verify`` family."""
    cap = tgt._capture("spec_verify", family_key, vin.numel())
    with cap or nullcontext():
        logits, _ = tgt._forward(vin, cache, pos, attn_impl="torch", kv_width=kv_width,
                                 capture=cap, **rows)
    return logits


def _spec_verify(tgt: Engine, cur_tok, drafts, pos, tcache, kv_width):
    """One target forward over ``[cur, d_1..d_k]`` and greedy acceptance.
    Returns ``(out [k + 1], a, prev', cur', pos')``, all on the device."""
    k = drafts.shape[0]
    vin = torch.cat([cur_tok, drafts])[None, :]
    logits = _verify_forward(tgt, vin, tcache, pos, kv_width, ((1, k + 1), kv_width))
    greedy = torch.argmax(logits[0], dim=-1)
    out, a, leading = greedy_accept(drafts, greedy)
    prev, cur = _frontier_shift(out, leading, cur_tok)
    return out, a, prev, cur, pos + a


def _spec_draft_sampled(drf: Engine, prev_tok, cur_tok, pos, dcache, k: int,
                        temperature: float, gen: torch.Generator, kv_width):
    """Sampled drafting: ``k`` proposals drawn from the draft's temperature
    distribution, with each step's probabilities (rejection sampling needs
    q, not only the token). Returns ``(drafts [k], qs [k, V])``."""
    tok, outs, qs = prev_tok, [], []
    for i in range(k + 1):
        lg, _ = drf._forward(tok[:, None], dcache, pos - 1 + i, attn_impl="flash",
                             kv_width=kv_width)
        if i == 0:
            tok = cur_tok
            continue
        q = torch.softmax(lg[0, -1].float() / temperature, dim=-1)
        nxt = torch.multinomial(q, 1, generator=gen)
        outs.append(nxt)
        qs.append(q)
        tok = nxt
    return torch.cat(outs), torch.stack(qs)


def _spec_verify_sampled(tgt: Engine, cur_tok, drafts, qs, pos, tcache, temperature: float,
                         gen: torch.Generator, kv_width):
    """One target forward and rejection sampling (:func:`rejection_accept`).
    Returns ``(out [k + 1], a, prev', cur', pos')``."""
    k = drafts.shape[0]
    vin = torch.cat([cur_tok, drafts])[None, :]
    logits = _verify_forward(tgt, vin, tcache, pos, kv_width, ((1, k + 1), kv_width))
    ps = torch.softmax(logits[0].float() / temperature, dim=-1)
    us = torch.rand(k + 1, generator=gen, device=ps.device)
    out, a, leading = rejection_accept(ps, qs, drafts, us)
    prev, cur = _frontier_shift(out, leading, cur_tok)
    return out, a, prev, cur, pos + a


# -- buffer-drafter programs (any batch size) -------------------------------------


def _lookup_propose(buf: torch.Tensor, blen: torch.Tensor, k: int, g: int) -> torch.Tensor:
    """Prompt-lookup proposals for every row: [B, k].

    ``buf`` [B, S] holds each row's known tokens (``blen`` of them, the last
    the stream's current token). The gram is the last ``g`` known tokens;
    the proposal is the continuation after its most recent earlier
    occurrence (source position p < blen - g), or the current token
    repeated when nothing matches."""
    b, s = buf.shape
    dev = buf.device
    gidx = (blen[:, None] - g + torch.arange(g, device=dev)[None, :]).clamp(min=0)
    gram = buf.gather(1, gidx)
    n_src = s - g
    match = torch.ones((b, n_src), dtype=torch.bool, device=dev)
    for j in range(g):
        match &= buf[:, j:j + n_src] == gram[:, j:j + 1]
    src_pos = torch.arange(n_src, device=dev)
    match &= src_pos[None, :] < (blen - g)[:, None]
    p_best = torch.where(match, src_pos[None, :], torch.full_like(src_pos, -1)[None, :]).amax(1)
    src = (p_best[:, None] + g + torch.arange(k, device=dev)[None, :]).clamp(0, s - 1)
    props = buf.gather(1, src)
    last = buf.gather(1, (blen - 1).clamp(min=0)[:, None])
    return torch.where(p_best[:, None] >= 0, props, last.expand(b, k))


def _oracle_propose(obuf: torch.Tensor, blen: torch.Tensor, k: int, vocab: int,
                    accept: Optional[int] = None) -> torch.Tensor:
    """Oracle proposals ``obuf[blen : blen + k]`` (token p of the stream at
    ``obuf[p]``); with ``accept``, proposals past the first ``accept - 1``
    become ``(tok + 1) % vocab``, so each round accepts exactly ``accept``."""
    s = obuf.shape[1]
    src = (blen[:, None] + torch.arange(k, device=obuf.device)[None, :]).clamp(0, s - 1)
    props = obuf.gather(1, src)
    if accept is not None:
        junk = (props + 1) % vocab
        keep = torch.arange(k, device=obuf.device)[None, :] < accept - 1
        props = torch.where(keep, props, junk)
    return props


def _junk_propose(buf: torch.Tensor, blen: torch.Tensor, k: int, vocab: int) -> torch.Tensor:
    """Deterministic junk proposals (the ``acceptance_collapse`` fault):
    acceptance pins to ~1, greedy output is unchanged."""
    last = buf.gather(1, (blen - 1).clamp(min=0)[:, None])
    return (last + 1 + torch.arange(k, device=buf.device)[None, :]) % vocab


def _scatter_accepted(buf: torch.Tensor, blen: torch.Tensor, out: torch.Tensor,
                      a: torch.Tensor) -> None:
    """Write each row's accepted tokens ``out[i, :a[i]]`` into ``buf`` at
    ``blen[i]``, in place (the rest of the window keeps its tokens)."""
    n = out.shape[1]
    idx = torch.arange(n, device=buf.device)[None, :]
    bidx = (blen[:, None] + idx).clamp(max=buf.shape[1] - 1)
    old = buf.gather(1, bidx)
    buf.scatter_(1, bidx, torch.where(idx < a[:, None], out, old))


def _spec_verify_buf(tgt: Engine, cur_tok, drafts, pos, blen, tcache, buf, kv_width):
    """Single-stream verify that maintains the token buffer: the accepted
    tokens land in ``buf`` at ``blen`` (skipped when ``buf`` is None, the
    oracle's buffer, which already holds the future). Returns ``(out
    [k + 1], a, cur', pos', blen')``."""
    k = drafts.shape[0]
    vin = torch.cat([cur_tok, drafts])[None, :]
    logits = _verify_forward(tgt, vin, tcache, pos, kv_width, ((1, k + 1), kv_width))
    greedy = torch.argmax(logits[0], dim=-1)
    out, a, leading = greedy_accept(drafts, greedy)
    if buf is not None:
        _scatter_accepted(buf, blen.reshape(1), out[None, :], a.reshape(1))
    return out, a, out.gather(0, leading.reshape(1)), pos + a, blen + a


def _append_buf(buf: torch.Tensor, blen: torch.Tensor, toks: torch.Tensor):
    """Append a plain chunk's tokens ``toks`` [n, 1] to a single stream's
    buffer (in place); returns the new ``blen``."""
    n = toks.shape[0]
    idx = (blen + torch.arange(n, device=buf.device)).clamp(max=buf.shape[1] - 1)
    buf[0].index_copy_(0, idx, toks[:, 0])
    return blen + n


# -- batched (shared-frontier) programs ------------------------------------------


def _spec_verify_batch(eng: Engine, cur, drafts, pos: int, row_start, blen, cache, valid, buf,
                       k: int, kv_width):
    """One target forward verifies ``k + 1`` positions for every row of the
    pool (B x (k + 1) tokens a weight stream), with the shared frontier and
    per-row holes.

    Every round writes slots ``[pos, pos + k]`` of every row and the
    frontier advances ``k + 1``, host-known, so admission, capacity checks
    and compaction keep their arithmetic. Per-row acceptance is data:

      * slots ``[pos + a_i, pos + k]`` become row i's holes, junk KV never
        rewritten; the bitmap ``valid`` [B, S] masks them (the transformer's
        ``kv_mask``). This round's window is marked valid before the forward
        (in-window causality comes from positions), then trimmed to ``a_i``;
      * ``row_start`` absorbs the holes (row_start_i = pos - blen_i + 1, so
        slot s of a new write holds logical position s - row_start_i):
        each round adds ``k + 1 - a_i``;
      * ``blen`` and ``buf`` track each row's logical sequence; accepted
        tokens land at ``blen_i`` for the lookup drafter.

    ``valid``, ``buf`` and the cache are updated in place. Returns ``(out
    [B, k + 1], a [B], cur' [B], row_start' [B] int32, blen' [B])``."""
    idx = torch.arange(k + 1, device=cur.device)
    valid[:, pos:pos + k + 1] = True
    vin = torch.cat([cur[:, None], drafts], dim=1)
    logits = _verify_forward(eng, vin, cache, pos, kv_width,
                             (tuple(vin.shape), k, kv_width), row_start=row_start, kv_mask=valid)
    greedy = torch.argmax(logits, dim=-1)
    out, a, leading = greedy_accept(drafts, greedy)
    new_cur = out.gather(1, leading[:, None])[:, 0]
    valid[:, pos:pos + k + 1] = idx[None, :] < a[:, None]
    _scatter_accepted(buf, blen, out, a)
    new_rs = (row_start + (k + 1) - a).to(torch.int32)
    return out, a, new_cur, new_rs, blen + a


def _plain_chunk_masked(eng: Engine, token, pos: int, row_start, blen, cache, valid, buf,
                        n_steps: int, kv_width):
    """``n_steps`` greedy decode steps over a holey pool cache (the
    governor's plain windows and the cache tail of a speculative pool): each
    step marks its slot in the bitmap before the forward and appends its
    token to the buffer. The bitmap sends the forward to the plain
    attention op. Returns ``(last token [B], tokens [n_steps, B],
    blen')``."""
    b = token.shape[0]
    cap = eng._capture("decode", ((b,), n_steps, kv_width, "masked"), n_steps * b, n_steps)
    toks = []
    rows = torch.arange(b, device=token.device)
    for i in range(n_steps):
        valid[:, pos + i] = True
        counted = cap if i == 0 else None
        with counted or nullcontext():
            logits, _ = eng._forward(token[:, None], cache, pos + i, attn_impl="torch",
                                     kv_width=kv_width, capture=counted, row_start=row_start,
                                     kv_mask=valid)
        token = torch.argmax(logits[:, -1], dim=-1)
        buf[rows, blen.clamp(max=buf.shape[1] - 1)] = token
        blen = blen + 1
        toks.append(token)
    return token, torch.stack(toks), blen


def _install_spec_rows(valid, buf, blen, slots: torch.Tensor, dsts: list, pos: int,
                       prompts: list, samples: torch.Tensor) -> None:
    """Install admitted rows' speculative state, in place: bitmap row = the
    spliced prompt window ``[dst, pos)``, buffer row = the prompt ids and
    the prefill-sampled first token, ``blen`` = n + 1 (the sampled token is
    the stream's current token; its KV is written by the row's first
    round)."""
    s = valid.shape[1]
    dev = valid.device
    ar = torch.arange(s, device=dev)[None, :]
    dst_t = torch.tensor(dsts, dtype=torch.long).to(dev)[:, None]
    valid[slots] = (ar >= dst_t) & (ar < pos)
    w = min(max(len(p) for p in prompts) + 1, s)
    host = torch.zeros((len(prompts), w), dtype=torch.long)
    for i, p in enumerate(prompts):
        host[i, :min(len(p), w)] = torch.tensor(p[:w], dtype=torch.long)
    rows = torch.zeros((len(prompts), s), dtype=buf.dtype, device=dev)
    rows[:, :w] = host.to(dev)
    nlens = torch.tensor([len(p) for p in prompts], dtype=torch.long).to(dev)
    rows[torch.arange(len(prompts), device=dev), nlens.clamp(max=s - 1)] = samples.to(buf.dtype)
    buf[slots] = rows
    blen[slots] = nlens + 1


def _roll_valid(valid: torch.Tensor, shift: int) -> None:
    """Compaction's twin of the cache slide: every row's bitmap moves left
    by ``shift`` with the KV it describes (in place)."""
    valid.copy_(torch.roll(valid, -shift, dims=1))


# -- engine ----------------------------------------------------------------------


class SpeculativeEngine:
    """Drives a target Engine with speculative decode from any Drafter.

    ``generate`` keeps ``Engine.generate``'s contract and is token-exact
    against ``target.generate`` for greedy sampling. Top-k/top-p sampling
    and buffer drafters under sampling delegate to the plain target engine
    (pure-temperature sampling rides a model drafter by rejection
    sampling), as does any generation whose prompt and requested tokens
    would outgrow a model draft's window, and ``max_new_tokens <= 0``
    returns at once. A model draft whose target or draft sits on a mesh of
    more than one position raises ``ValueError`` (the JAX rule); a buffer
    drafter rides a sharded target. Near the cache's end the loop stops a round's worth of
    slots early instead of switching to one-token steps.

    Per stream an :class:`AdaptiveK` (off with ``adaptive=False``) and a
    :class:`SpecGovernor` (off with ``governor=False``; ``probe_tokens`` a
    window) steer the rounds; ``rounds_per_chunk`` (``stream_interval //
    2``) rounds share one host fetch. The finished target cache is retained
    through ``Engine._retain_prefix`` (a KV-pool publish under the pool).
    The fault plan (the ``spec`` site: ``acceptance_collapse``,
    ``draft_stall``), the recorder (``spec.rounds``, ``spec.accepted``) and
    the attribution ledger (``spec_rejected`` tokens; dispatches tagged
    ``draft`` and ``spec_verify``) are bound at construction.
    """

    def __init__(self, target: Engine, draft, k: int = 4,
                 rounds_per_chunk: Optional[int] = None, adaptive: bool = True,
                 governor: bool = True, probe_tokens: int = 64):
        if k < 1:
            raise ValueError("k must be >= 1")
        if isinstance(draft, Engine):
            draft = ModelDrafter(draft)
        if not isinstance(draft, Drafter):
            raise TypeError("draft must be an Engine or a Drafter")
        if isinstance(draft, ModelDrafter):
            if target.sharded or draft.engine.sharded:
                # The JAX rule: a model draft's cache would have to live
                # beside a sharded target's across the slice. A buffer
                # drafter carries no second cache and rides a sharded
                # target (its verify runs through forward_sharded).
                raise ValueError(
                    "speculative decoding supports unsharded engines or "
                    "a target/draft pair on the same single-device mesh")
            if draft.engine.device != target.device:
                raise ValueError(
                    f"speculative decoding needs the draft on the target's device "
                    f"({draft.engine.device} vs {target.device})")
            if draft.engine.cfg.vocab_size != target.cfg.vocab_size:
                # The draft ingests the target's tokens: another vocabulary
                # would index its embedding out of range.
                raise ValueError(
                    f"draft vocabulary {draft.engine.cfg.vocab_size} differs from the "
                    f"target's {target.cfg.vocab_size}")
        self.target = target
        self.drafter = draft
        self.draft = draft.engine if isinstance(draft, ModelDrafter) else None
        self.k = k
        # A round advances >= 1 token, so rounds ~ stream_interval / 2 keeps
        # a fetch's latency near the plain decode chunk's.
        self.rounds = rounds_per_chunk or max(1, target.stream_interval // 2)
        self.tokenizer = target.tokenizer
        self.adaptive = bool(adaptive)
        self.governor_enabled = bool(governor)
        self.probe_tokens = int(probe_tokens)
        self.stats = {"rounds": 0, "accepted": 0, "plain_tokens": 0,
                      "governor_disables": 0, "collapse_faults": 0}
        self.last_accept_ema = 0.0
        self._faults = _faults.plan()
        self._obs = obs.recorder()
        self._attrib = obs.attrib.ledger()

    @property
    def mean_accepted(self) -> float:
        """Mean tokens per round so far (1.0: no speculation win)."""
        r = self.stats["rounds"]
        return self.stats["accepted"] / r if r else 0.0

    def _fire_spec_fault(self, sampled: bool = False) -> Optional[str]:
        """Consult the ``spec`` fault site once per round.
        ``acceptance_collapse`` junks this round's proposals (speed only);
        ``draft_stall`` sleeps the host dispatcher (``@s=`` seconds). On the
        sampled path collapse is a no-op (proposals must keep their q): it
        lands in the trace but not in ``collapse_faults``."""
        if self._faults is None:
            return None
        fs = self._faults.fire("spec", model=self.target.cfg.name)
        if fs is None:
            return None
        if fs.kind == "draft_stall":
            time.sleep(float(fs.param("s", 0.05)))
            return "draft_stall"
        if fs.kind == "acceptance_collapse" and not sampled:
            self.stats["collapse_faults"] += 1
            return "acceptance_collapse"
        return None

    def generate(self, prompt: str, sampling: SamplingParams = SamplingParams(),
                 ctx: Optional[Context] = None,
                 on_text: Optional[Callable[[str], None]] = None) -> GenerateResult:
        if sampling.temperature != 0.0 and (
            self.draft is None or sampling.top_k is not None or sampling.top_p is not None
        ):
            # Rejection sampling needs the draft's q and a pure-temperature
            # target distribution: anything else runs plain.
            return self.target.generate(prompt, sampling, ctx, on_text)
        ctx = ctx or Context.background()
        start_time = time.monotonic()
        tgt = self.target
        prompt_ids, truncated = tgt._budget_prompt(self.tokenizer.encode(prompt),
                                                   sampling.max_new_tokens)
        if not prompt_ids:
            raise ValueError("empty prompt")
        n = len(prompt_ids)
        max_new = min(sampling.max_new_tokens, tgt.max_seq - n)
        if self.draft is not None and n + max_new + self.k + 2 > self.draft.max_seq:
            # The draft's window would bind before the requested tokens are
            # done: the target's limits alone decide the output's length.
            return self.target.generate(prompt, sampling, ctx, on_text)
        if max_new <= 0:
            return GenerateResult(token_ids=[], text="", finish_reason="length", prompt_tokens=n,
                                  latency_ms=(time.monotonic() - start_time) * 1000,
                                  truncated_prompt=truncated)
        run = self._generate_sampled if sampling.temperature != 0.0 else self._generate_greedy
        with torch.inference_mode():
            return run(prompt_ids, n, max_new, truncated, sampling, ctx, on_text, start_time)

    def _emitter(self, max_new: int, eos: int, on_text):
        """The host side of a stream: ``emit(tok)`` appends (True: stop)."""
        decoder = StreamDecoder(self.tokenizer)
        state = {"out": [], "parts": [], "finish": "length"}

        def emit(tok: int) -> bool:
            if tok == eos:
                state["finish"] = "eos"
                return True
            if len(state["out"]) >= max_new:
                return True
            state["out"].append(tok)
            text = decoder.push(tok)
            if text:
                state["parts"].append(text)
                if on_text is not None:
                    on_text(text)
            return False

        def flush() -> str:
            tail = decoder.flush()
            if tail:
                state["parts"].append(tail)
                if on_text is not None:
                    on_text(tail)
            return "".join(state["parts"])

        return emit, flush, state

    # -- greedy (any drafter; adaptive k and governor) ---------------------------

    def _generate_greedy(self, prompt_ids, n, max_new, truncated, sampling, ctx, on_text,
                         start_time):
        tgt, drf, drafter = self.target, self.draft, self.drafter
        dev = tgt.device
        stats0 = dict(self.stats)
        eos = -1 if sampling.ignore_eos else self.tokenizer.eos_id
        emit, flush, st = self._emitter(max_new, eos, on_text)
        out_ids = st["out"]

        # Prefill the target (and a model draft); the target's greedy token
        # is the first output and the loop's first ``cur``, fetched with
        # the first round group.
        with obs.attrib.tag("prefill"):
            tlogits, tcache = tgt._prefill_ids(prompt_ids)
            cur = torch.argmax(tlogits, dim=-1)  # [1]
            dcache = prev = None
            if drf is not None:
                _, dcache = drf._prefill_ids(prompt_ids)
                prev = tgt.to_device([prompt_ids[-1]])
        buf = blen = None
        oracle = isinstance(drafter, OracleDrafter)
        if drafter.needs_buffer:
            sbuf = tgt.max_seq
            # The oracle's buffer holds the future too: token p at obuf[p].
            host = (prompt_ids + drafter.continuation_ids if oracle else prompt_ids)[:sbuf]
            buf = tgt.to_device([host + [0] * (sbuf - len(host))])
            if not oracle:
                buf[0, min(n, sbuf - 1)] = cur[0]
            blen = torch.full((), n + 1, dtype=torch.long, device=dev)

        pos_dev = torch.full((), n, dtype=torch.long, device=dev)
        first: Optional[torch.Tensor] = cur
        stopped = False
        cap = min(tgt.max_seq, drf.max_seq if drf is not None else tgt.max_seq)
        vocab = tgt.cfg.vocab_size
        chunk_sz = tgt.stream_interval
        controller = AdaptiveK(self.k, adaptive=self.adaptive)
        governor = SpecGovernor(probe_tokens=self.probe_tokens, enabled=self.governor_enabled)
        decode_t0: Optional[float] = None
        decode_n0 = 0
        # Host frontier upper bound (acceptance is data), exact after each
        # fetch.
        pos_ub = n
        win_t0, win_tokens0 = time.monotonic(), 0
        plain_backlog: list = []  # (tokens [1, n], start pos) the draft missed
        pending: list = []  # ("spec", out, a, pos, k) | ("plain", toks, pos_ub, n)

        def drain() -> None:
            nonlocal stopped, decode_t0, decode_n0, pos_ub, first
            if not pending and first is None:
                return
            tensors = ([first] if first is not None else [])
            for p in pending:
                tensors += [p[1], p[2].reshape(1)] if p[0] == "spec" else [p[1]]
            spec_entries = [p for p in pending if p[0] == "spec"]
            if spec_entries:
                tensors.append(spec_entries[-1][3].reshape(1))
            vals = _to_host(tensors)
            i = 0
            if first is not None:
                first = None
                stopped = emit(vals[0][0])
                i = 1
            for kind, *rest in pending:
                if kind == "spec":
                    out_v, a = vals[i], vals[i + 1][0]
                    i += 2
                else:
                    out_v, a = vals[i], None
                    i += 1
                if stopped:
                    continue
                if kind == "spec":
                    self.stats["rounds"] += 1
                    self.stats["accepted"] += a
                    if self._attrib is not None:
                        self._attrib.token_event("spec_rejected", rest[3] + 1 - a)
                    controller.observe(a, rest[3])
                    for tok in out_v[:a]:
                        if emit(tok):
                            stopped = True
                            break
                else:
                    for tok in out_v:
                        if emit(tok):
                            stopped = True
                            break
                    if not stopped:
                        self.stats["plain_tokens"] += len(out_v)
            if spec_entries:
                pos_ub = vals[-1][0]
                if pending[-1][0] == "plain":
                    pos_ub = pending[-1][2]
            elif pending:
                pos_ub = pending[-1][2]
            pending.clear()
            if decode_t0 is None:
                decode_t0 = time.monotonic()
                decode_n0 = len(out_ids)

        def governor_feed() -> None:
            nonlocal win_t0, win_tokens0, plain_backlog
            now = time.monotonic()
            switched = governor.feed(len(out_ids) - win_tokens0, now - win_t0)
            win_t0, win_tokens0 = now, len(out_ids)
            if governor.disabled_spec and self.stats["governor_disables"] == 0:
                self.stats["governor_disables"] = 1
                if self._obs is not None:
                    self._obs.instant("spec_governor_disable", tid="engine",
                                      model=tgt.cfg.name, ema=round(controller.ema, 3))
            if switched and governor.mode == "spec" and plain_backlog:
                # Back to drafting after a plain window: the model draft's
                # cache catches up over the tokens it never saw (buffer
                # drafters stayed current through _append_buf).
                if drf is not None:
                    for toks, sp, nst in plain_backlog:
                        _draft_ingest(drf, toks, sp, dcache,
                                      drf._decode_width(min(pos_ub, cap)))
                plain_backlog = []

        while True:
            k = controller.k
            can_dispatch = (
                not stopped and not ctx.done() and pos_ub + (k + 1) + 1 <= cap
                and len(out_ids) + sum(1 if p[0] == "spec" else p[3] for p in pending)
                + (1 if first is not None else 0) < max_new
            )
            if not can_dispatch:
                drain()
                governor_feed()
                if stopped or len(out_ids) >= max_new:
                    break
                if ctx.done():
                    st["finish"] = "deadline" if ctx.remaining() == 0.0 else "cancelled"
                    break
                if pos_ub + (k + 1) + 1 > cap:
                    break  # cache tail: the documented early stop
                continue
            if governor.mode == "plain":
                n_steps = chunk_sz if pos_ub + chunk_sz + 1 <= cap else 1
                width = tgt._decode_width(min(pos_ub + n_steps + 1, cap))
                cur_prev = cur  # its KV is written by the chunk's first step
                with obs.attrib.tag("decode"):
                    cur, toks, _ = tgt._decode_chunk(cur, pos_dev, tcache, n_steps, None,
                                                     (0.0, None, None), width)
                if buf is not None and not oracle:
                    blen = _append_buf(buf, blen, toks)
                if drf is not None and governor.state == "plain_probe":
                    # The window the target wrote at [pos, pos + n) is
                    # [cur_prev, toks[:-1]]: what the draft replays later.
                    win = torch.cat([cur_prev, toks[:-1, 0]])[None, :]
                    plain_backlog.append((win, pos_dev, n_steps))
                if prev is not None:
                    # The opener re-ingests the token at pos - 1.
                    prev = toks[-2] if n_steps >= 2 else cur_prev
                pos_dev = pos_dev + n_steps
                pos_ub += n_steps
                pending.append(("plain", toks[:, 0], pos_ub, n_steps))
                if len(pending) >= max(1, self.rounds // 2):
                    drain()
                    governor_feed()
                continue
            fault = self._fire_spec_fault()
            width = tgt._decode_width(min(pos_ub + k + 2, cap))
            if drf is not None:
                with obs.attrib.tag("draft"):
                    drafts = _spec_draft(drf, prev, cur, pos_dev, dcache, k,
                                         drf._decode_width(min(pos_ub + k + 2, cap)))
                    if fault == "acceptance_collapse":
                        drafts = (drafts + 1) % vocab  # the draft's cost stays
                with obs.attrib.tag("spec_verify"):
                    out, a, prev, cur, pos_dev = _spec_verify(tgt, cur, drafts, pos_dev, tcache,
                                                              width)
            else:
                with obs.attrib.tag("draft"):
                    if fault == "acceptance_collapse":
                        drafts = _junk_propose(buf, blen.reshape(1), k, vocab)[0]
                    elif oracle:
                        drafts = _oracle_propose(buf, blen.reshape(1), k, vocab,
                                                 accept=drafter.accept)[0]
                    else:
                        lcap = tgt._capture("draft", (k, drafter.ngram), k)
                        with lcap or nullcontext():
                            drafts = _lookup_propose(buf, blen.reshape(1), k, drafter.ngram)[0]
                with obs.attrib.tag("spec_verify"):
                    out, a, cur, pos_dev, blen = _spec_verify_buf(
                        tgt, cur, drafts, pos_dev, blen, tcache, None if oracle else buf, width)
            pending.append(("spec", out, a, pos_dev, k))
            pos_ub += k + 1
            if len(pending) >= self.rounds:
                drain()
                governor_feed()

        self.last_accept_ema = controller.ema
        d_rounds = self.stats["rounds"] - stats0["rounds"]
        d_accepted = self.stats["accepted"] - stats0["accepted"]
        if self._obs is not None:
            self._obs.count("spec.rounds", d_rounds)
            self._obs.count("spec.accepted", d_accepted)
        spec_info = {
            "kind": drafter.kind, "k": self.k, "rounds": d_rounds, "accepted": d_accepted,
            "mean_accepted": round(d_accepted / d_rounds, 3) if d_rounds else None,
            "accept_ema": round(controller.ema, 3), "governor": governor.state,
            "plain_tokens": self.stats["plain_tokens"] - stats0["plain_tokens"],
        }
        # Retain the finished cache with the ids whose KV it holds: every
        # slot below the exact frontier ``pos_ub`` was written by an
        # accepted verify position or a plain step.
        kv_truncated = False
        if not stopped or st["finish"] in ("eos", "length"):
            kv_truncated = tgt._retain_prefix((prompt_ids + out_ids)[:pos_ub], tcache)
        return self._result(st, flush, n, start_time, truncated, decode_t0, decode_n0,
                            spec_info, kv_truncated)

    def _result(self, st, flush, n, start_time, truncated, decode_t0, decode_n0, spec_info,
                kv_truncated=False) -> GenerateResult:
        decode_tokens, decode_s = 0, 0.0
        if decode_t0 is not None:
            decode_tokens = len(st["out"]) - decode_n0
            decode_s = time.monotonic() - decode_t0
        text = flush()
        return GenerateResult(
            token_ids=st["out"], text=text, finish_reason=st["finish"], prompt_tokens=n,
            latency_ms=(time.monotonic() - start_time) * 1000, truncated_prompt=truncated,
            decode_tokens=decode_tokens, decode_s=decode_s, spec=spec_info,
            kv_truncated=bool(kv_truncated))

    # -- sampled (model drafter; rejection sampling) -----------------------------

    def _generate_sampled(self, prompt_ids, n, max_new, truncated, sampling, ctx, on_text,
                          start_time):
        tgt, drf = self.target, self.draft
        dev = tgt.device
        stats0 = dict(self.stats)
        eos = -1 if sampling.ignore_eos else self.tokenizer.eos_id
        emit, flush, st = self._emitter(max_new, eos, on_text)
        out_ids = st["out"]
        temperature = sampling.temperature
        # The first token is the plain engine's first draw (same seed).
        gen = torch.Generator(device=dev).manual_seed(sampling.seed)
        with obs.attrib.tag("prefill"):
            tlogits, tcache = tgt._prefill_ids(prompt_ids)
            _, dcache = drf._prefill_ids(prompt_ids)
        cur = sample_token(tlogits, gen, temperature)
        prev = tgt.to_device([prompt_ids[-1]])
        first: Optional[torch.Tensor] = cur
        stopped = False
        controller = AdaptiveK(self.k, adaptive=self.adaptive)
        cap = min(tgt.max_seq, drf.max_seq)
        decode_t0: Optional[float] = None
        decode_n0 = 0
        pos_ub = n
        pos_dev = torch.full((), n, dtype=torch.long, device=dev)
        # A monotone round counter seeds each round's draws: the schedule
        # never depends on how rounds group into fetches.
        round_no = 0
        pending: list = []  # (out, a, pos, k) per round

        def drain() -> None:
            nonlocal stopped, decode_t0, decode_n0, pos_ub, first
            if not pending and first is None:
                return
            tensors = [first] if first is not None else []
            for out, a, _p, _k in pending:
                tensors += [out, a.reshape(1)]
            if pending:
                tensors.append(pending[-1][2].reshape(1))
            vals = _to_host(tensors)
            i = 0
            if first is not None:
                first = None
                stopped = emit(vals[0][0])
                i = 1
            for _o, _a, _p, k_used in pending:
                out_v, a = vals[i], vals[i + 1][0]
                i += 2
                if stopped:
                    continue
                self.stats["rounds"] += 1
                self.stats["accepted"] += a
                controller.observe(a, k_used)
                for tok in out_v[:a]:
                    if emit(tok):
                        stopped = True
                        break
            if pending:
                pos_ub = vals[-1][0]
            pending.clear()
            if decode_t0 is None:
                decode_t0 = time.monotonic()
                decode_n0 = len(out_ids)

        while True:
            k = controller.k
            can_dispatch = (
                not stopped and not ctx.done() and pos_ub + (k + 1) + 1 <= cap
                and len(out_ids) + len(pending) + (1 if first is not None else 0) < max_new
            )
            if not can_dispatch:
                drain()
                if stopped or len(out_ids) >= max_new:
                    break
                if ctx.done():
                    st["finish"] = "deadline" if ctx.remaining() == 0.0 else "cancelled"
                    break
                if pos_ub + (k + 1) + 1 > cap:
                    break  # cache tail: the documented early stop
                continue
            self._fire_spec_fault(sampled=True)  # only draft_stall acts here
            width = tgt._decode_width(min(pos_ub + k + 2, cap))
            round_no += 1
            gen.manual_seed(_round_seed(sampling.seed, round_no))
            with obs.attrib.tag("draft"):
                drafts, qs = _spec_draft_sampled(drf, prev, cur, pos_dev, dcache, k, temperature,
                                                 gen, drf._decode_width(min(pos_ub + k + 2, cap)))
            with obs.attrib.tag("spec_verify"):
                out, a, prev, cur, pos_dev = _spec_verify_sampled(
                    tgt, cur, drafts, qs, pos_dev, tcache, temperature, gen, width)
            pending.append((out, a, pos_dev, k))
            pos_ub += k + 1
            if len(pending) >= self.rounds:
                drain()

        self.last_accept_ema = controller.ema
        d_rounds = self.stats["rounds"] - stats0["rounds"]
        d_accepted = self.stats["accepted"] - stats0["accepted"]
        if self._obs is not None:
            self._obs.count("spec.rounds", d_rounds)
            self._obs.count("spec.accepted", d_accepted)
        spec_info = {
            "kind": "model", "k": self.k, "rounds": d_rounds, "accepted": d_accepted,
            "mean_accepted": round(d_accepted / d_rounds, 3) if d_rounds else None,
            "accept_ema": round(controller.ema, 3),
            "governor": "sampled",  # the rejection path has no A/B
            "plain_tokens": 0,
        }
        return self._result(st, flush, n, start_time, truncated, decode_t0, decode_n0,
                             spec_info)

