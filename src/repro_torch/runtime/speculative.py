"""Self-speculative decoding from nested LUT-Q dictionaries.

Counterpart of ``repro.runtime.speculative``. Decode streams the whole
quantized model for one token a slot. LUT-Q gives a draft model at the
cost of a second small dictionary: :func:`repro_torch.core.policy.
draft_view` re-clusters each K-entry dictionary into K' = 2**draft_bits
entries over the same stored indices. A round:

  1. the draft view proposes k tokens, one decode step each;
  2. ONE target forward over the (k + 1)-token window checks them
     (``api.decode_window`` / ``api.paged_decode_window``: the decode
     step's path over k + 1 tokens a slot);
  3. the accepted tokens commit, and the cache length moves to
     ``n0 + n_acc``.

Draft and target share one KV cache. The draft steps write their K/V at
positions n0 .. n0 + k - 1; the verify window, rewound to n0, writes the
target's K/V position by position before each position attends, so every
verify position attends target K/V only and greedy tokens are the bits
of non-speculative decoding. Rejected positions' K/V stay past ``len``,
masked, and are overwritten by the next round. An encdec cache's cross
K/V and ``src_len`` are only read by a round, so nothing of them is
rolled back; a vlm cache's ``len`` counts its P image-prefix slots, and
a round starts there as at any other length.

A sliding-window ring needs one more move: the k + 1 ring columns of a
round may hold entries from ``window`` positions back that are still
live, so the round snapshots them first, restores all of them before
the verify window and, after it, those past the accepted length
(k + 1 <= ring width, which the engine enforces).

Under a temperature the accept rule is Leviathan et al.'s rejection
sampling, each row drawing from its request's ``torch.Generator`` (the
reference splits ``jax.random`` keys): draft token d_i is accepted with
probability min(1, p_i(d_i) / q_i(d_i)), the first rejection resamples
from norm(max(0, p_i - q_i)), and a fully accepted round draws a bonus
token from p_{k+1}, so each emitted token is distributed as sampling
from the target alone.

:func:`spec_round` reads and writes the caller's buffers in place and
makes no host read on the greedy path, so the engine captures a greedy
round as one CUDA graph and replays it (``runtime/engine.py``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.device import scalar_like
from repro_torch.models import api
from repro_torch.models.config import ModelConfig

_RING_KEYS = ("k", "v", "k_scale", "v_scale")


def ring_width(cfg: ModelConfig, max_len: int) -> Optional[int]:
    """Width of the slot cache's SWA ring, or None for a linear cache."""
    if cfg.window is None:
        return None
    return min(max_len, cfg.window)


def is_ring(cfg: ModelConfig, cache) -> bool:
    """A slot cache whose per-layer K/V are a sliding-window ring."""
    if cfg.window is None or "layers" not in cache:
        return False
    return cache["layers"][0]["k"].shape[1] <= cfg.window


def ring_slots(n0: torch.Tensor, W: int, eff: int) -> torch.Tensor:
    """(B, W) ring columns a round touches: the slot of position n0 + j."""
    return (n0.long()[:, None]
            + torch.arange(W, device=n0.device)[None, :]) % eff


def ring_snapshot(cache, slots: torch.Tensor) -> List[dict]:
    """Copies of the touched ring columns of every layer's K/V (and
    scale) leaves, one dict a layer."""
    b = torch.arange(slots.shape[0], device=slots.device)[:, None]
    return [{k: c[k][b, slots] for k in _RING_KEYS if k in c}
            for c in cache["layers"]]


def ring_restore(cache, snap: List[dict], slots: torch.Tensor,
                 n_acc: torch.Tensor) -> None:
    """Put back the snapshot's columns j >= n_acc (per row), in place.

    Columns j < n_acc hold the verified K/V of the accepted positions;
    the others were overwritten by the round and regain their earlier
    entries (still live under the window)."""
    B, W = slots.shape
    b = torch.arange(B, device=slots.device)[:, None]
    keep = (torch.arange(W, device=slots.device)[None, :]
            >= n_acc.long()[:, None])
    for c, sv in zip(cache["layers"], snap):
        for k, v in sv.items():
            cur = c[k][b, slots]
            m = keep.reshape(keep.shape + (1,) * (cur.ndim - 2))
            c[k][b, slots] = torch.where(m, v, cur)


# ---------------------------------------------------------------------------
# accept rules
# ---------------------------------------------------------------------------

def greedy_accept(d: torch.Tensor, p_logits: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Longest-matching-prefix accept under greedy.

    d: (B, k) draft tokens; p_logits: (B, k + 1, V) target logits of the
    window. Returns ``(out (B, k + 1), n_acc (B,))``, both int32: the
    target's argmax at every position (on the accepted prefix it is the
    draft token), valid through ``n_acc = longest match + 1``.
    """
    k = d.shape[1]
    tgt = torch.argmax(p_logits.float(), dim=-1).to(torch.int32)
    match = (d == tgt[:, :k]).to(torch.int32)
    n_acc = 1 + torch.cumprod(match, dim=1).sum(dim=1)
    return tgt, n_acc.to(torch.int32)


def rejection_accept(gens, d: torch.Tensor, q_logits: torch.Tensor,
                     p_logits: torch.Tensor, temperature: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Leviathan-style speculative rejection sampling (temperature > 0).

    gens: one ``torch.Generator`` a row (None: a row with no request,
    which emits 0 and accepts nothing); d: (B, k) draft tokens sampled
    from q; q_logits: (B, k, V) the draft logits they were sampled from;
    p_logits: (B, k + 1, V) target logits. Accepts d_i with probability
    min(1, p_i(d_i) / q_i(d_i)) (in log space), resamples the first
    rejection from norm(max(0, p_i - q_i)), and draws a bonus token from
    p_{k+1} after a full accept. Returns ``(out (B, k + 1), n_acc
    (B,))``; the marginal of each emitted token is softmax(p_i / T).
    """
    B, k = d.shape
    dev = d.device
    temp = scalar_like(temperature, p_logits)
    out = torch.zeros((B, k + 1), dtype=torch.int32, device=dev)
    n_acc = torch.ones((B,), dtype=torch.int32, device=dev)
    pos = torch.arange(k + 1, device=dev)
    for b, gen in enumerate(gens):
        if gen is None:
            continue
        db = d[b].long()
        lq = torch.log_softmax(q_logits[b].float() / temp, dim=-1)
        lp = torch.log_softmax(p_logits[b].float() / temp, dim=-1)
        lq_d = torch.take_along_dim(lq, db[:, None], dim=1)[:, 0]
        lp_d = torch.take_along_dim(lp[:k], db[:, None], dim=1)[:, 0]
        u = torch.rand(k, generator=gen, device=dev)
        acc = torch.log(u) < (lp_d - lq_d)  # u < p / q  <=>  accept
        L = torch.cumprod(acc.to(torch.int32), dim=0).sum()
        p_res = torch.exp(lp[L])
        q_res = torch.exp(lq[torch.clamp(L, max=k - 1)])
        resid = torch.where(L == k, p_res, torch.clamp(p_res - q_res, min=0))
        tot = resid.sum()
        probs = torch.where(tot > 0, resid / torch.clamp(tot, min=1e-38),
                            p_res)
        extra = torch.multinomial(probs, 1, generator=gen)[0]
        out[b] = torch.where(pos < L, torch.cat([db, db[-1:]]), extra).to(
            torch.int32)
        n_acc[b] = (L + 1).to(torch.int32)
    return out, n_acc


def sample_draft(gens, logits: torch.Tensor, temperature: float
                 ) -> torch.Tensor:
    """(B,) int32 draft tokens drawn from softmax(logits / T), row b from
    ``gens[b]`` (0 for a row with no generator)."""
    probs = torch.softmax(logits.float() / scalar_like(temperature, logits),
                          dim=-1)
    out = torch.zeros(logits.shape[0], dtype=torch.int32,
                      device=logits.device)
    for b, gen in enumerate(gens):
        if gen is not None:
            out[b] = torch.multinomial(probs[b], 1, generator=gen)[0]
    return out


# ---------------------------------------------------------------------------
# the round
# ---------------------------------------------------------------------------

def spec_round(model, draft, cfg: ModelConfig, k: int, tok: torch.Tensor,
               cache, *, paged: bool, gens=None, temperature: float = 0.0):
    """One round: k draft steps, a rewind to ``n0``, one verify window,
    accept.

    ``tok`` (B, 1) is each slot's pending token (its K/V not yet in the
    cache) and ``cache`` the engine's slot or paged cache at length
    ``n0 = cache["len"]``. The K/V of the accepted positions are written
    in place (under a ring the other touched columns are restored);
    ``cache["len"]`` itself is left alone. ``gens`` (one generator or
    None a row) selects the temperature rule, else greedy. Returns
    ``(out (B, k + 1), n_acc (B,), n0 + n_acc)``: ``out[b, :n_acc[b]]``
    are the round's tokens and ``out[b, n_acc[b] - 1]`` is the new
    pending token.
    """
    if k < 1:
        raise ValueError(f"speculative k must be >= 1, got {k}")
    greedy = gens is None
    n0 = cache["len"]
    ring = not paged and is_ring(cfg, cache)
    if ring:
        slots = ring_slots(n0, k + 1, cache["layers"][0]["k"].shape[1])
        snap = ring_snapshot(cache, slots)
    forward = api.paged_decode_window if paged else api.decode_window

    c, cur = cache, tok
    q_logits, drafts = [], []
    for _ in range(k):
        lg, c = forward(draft, cfg, cur, c)
        lg = lg[:, -1]
        if greedy:
            nxt = torch.argmax(lg.float(), dim=-1).to(torch.int32)
        else:
            q_logits.append(lg)
            nxt = sample_draft(gens, lg, temperature)
        cur = nxt[:, None]
        drafts.append(cur)
    d = torch.cat(drafts, dim=1)

    if ring:
        # a full ring attends every filled column, so the columns the
        # drafts overwrote regain their entries before the window; its
        # scatter then rewrites column j just before position j attends
        ring_restore(cache, snap, slots, torch.zeros_like(n0))
    c = dict(c)
    c["len"] = n0
    p_logits, _ = forward(model, cfg, torch.cat([tok, d], dim=1), c)
    if greedy:
        out, n_acc = greedy_accept(d, p_logits)
    else:
        out, n_acc = rejection_accept(gens, d, torch.stack(q_logits, dim=1),
                                      p_logits, temperature)
    if ring:
        ring_restore(cache, snap, slots, n_acc)
    return out, n_acc, n0 + n_acc
