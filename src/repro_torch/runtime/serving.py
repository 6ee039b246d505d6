"""Serving: prefill-cache adaptation, paged entry points, generation.

Counterpart of ``repro.runtime.serving``:
  * ``ring_from_linear``: re-lay a linear KV cache into the SWA ring
    (slot = position % window) so decode can continue a long prompt;
  * ``grow_cache``: right-pad linear caches to max_len;
  * ``adapt_prefill_cache``: prefill cache -> decode-ready cache;
  * ``paged_chunk`` / ``paged_splice`` / ``paged_hydrate`` /
    ``paged_packed``: the paged engine's chunked prefill, workspace ->
    pages commit, prefix-hit rebuild and packed prefill of several
    prompts (plain functions where the reference keeps jit caches; the
    engine captures each as a CUDA graph over its own buffers);
    ``paged_encdec_splice``: an encdec request's prefill cache -> pages
    and its cross K/V slab row;
  * ``generate``: static-batch generation, a thin wrapper over
    ``runtime.engine.Engine`` (one batched prefill through ``preload``,
    then the engine's decode/retire loop), so sampling, EOS retirement
    and stats are one code path for static and continuous batching,
    self-speculative decoding included (``speculative=k``).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.models import api
from repro_torch.models import encdec as m_encdec
from repro_torch.models import lm as m_lm
from repro_torch.models.config import ModelConfig


def ring_from_linear(lin: torch.Tensor, prompt_len, window: int
                     ) -> torch.Tensor:
    """lin: (B, S_prompt, ...) linear cache -> (B, window, ...) ring.

    Position p lands in slot p % window; only the last ``window``
    positions survive. ``prompt_len`` may be an int or a per-stream (B,)
    vector. Slot s reads position ``s + window * floor((len-1-s)/window)``.
    """
    B, S = lin.shape[:2]
    L = torch.as_tensor(prompt_len, device=lin.device).reshape(-1)
    L = L.expand(B).long()[:, None]                           # (B, 1)
    s = torch.arange(window, device=lin.device)[None, :]      # (1, W)
    p = s + window * torch.div(L - 1 - s, window, rounding_mode="floor")
    valid = p >= 0                             # slot empty when len < window
    tail = (1,) * (lin.ndim - 2)
    idx = torch.clamp(p, 0, S - 1).reshape((B, window) + tail)
    gathered = torch.take_along_dim(lin, idx, dim=1)
    mask = valid.reshape((B, window) + tail)
    return torch.where(mask, gathered, torch.zeros((), dtype=lin.dtype,
                                                   device=lin.device))


def grow_cache(cache_small, cache_big):
    """Right-pad every linear-seq leaf of ``cache_small`` to the shape of
    its ``cache_big`` counterpart."""
    if isinstance(cache_big, dict):
        return {k: grow_cache(cache_small[k], v) for k, v in cache_big.items()}
    if isinstance(cache_big, list):
        return [grow_cache(s, b) for s, b in zip(cache_small, cache_big)]
    small = cache_small.to(cache_big.dtype)
    if small.shape == cache_big.shape:
        return small
    pad = []
    for b, s in reversed(list(zip(cache_big.shape, small.shape))):
        pad += [0, b - s]
    return torch.nn.functional.pad(small, pad)


def adapt_prefill_cache(cfg: ModelConfig, cache, batch: int, max_len: int,
                        *, src_len: int = 0, lengths=None):
    """Convert a prefill cache into a decode-ready cache of max_len.

    ``lengths``: per-stream (B,) cache lengths for right-padded batches
    (a vlm prefix's positions included); defaults to the prefill cache's
    own ``len`` vector. The int8 KV
    quantization and the SWA ring apply to the decoder-only families' GQA
    K/V only: MLA latents are grown as they are, as the reference's
    ``attn_kv`` guard leaves them, and so are an encdec cache's leaves,
    its cross K/V right-padded to ``src_len`` (the target cache's width:
    ``src_len`` or ``max_len``) and its ``src_len`` vector kept. A
    hybrid cache's shared-block K/V are grown to ``max_len`` and its SSM
    states and conv windows, already of their decode shapes, kept; an
    ssm cache's WKV states and token-shift rows are all of their decode
    shapes and kept as they are.
    """
    dev = cache["len"].device
    target = api.init_cache(cfg, batch, max_len, src_len=src_len, device=dev)
    if lengths is None:
        lengths = cache["len"]
    lengths = torch.as_tensor(lengths, device=dev).reshape(-1)
    lengths = lengths.expand(batch).to(torch.int32)
    layers = [dict(c) for c in cache["layers"]]
    attn_kv = cfg.family in ("dense", "moe", "vlm") and not cfg.use_mla
    if attn_kv and cfg.kv_cache_bits == 8:
        # prefill emits float K/V; the decode cache holds int8 + scales
        from repro_torch.models.lm import _kv_quant

        for c in layers:
            for key in ("k", "v"):
                c[key], c[f"{key}_scale"] = _kv_quant(c[key], 8)
    out = {"len": lengths}
    if attn_kv and cfg.window is not None:
        # SWA ring: re-lay per-position leaves at the decode ring width,
        # each stream at its own length
        out["layers"] = [
            {k: ring_from_linear(v, lengths, t[k].shape[1]).to(t[k].dtype)
             for k, v in c.items()}
            for c, t in zip(layers, target["layers"])]
        return out
    out["layers"] = grow_cache(layers, target["layers"])
    if "src_len" in cache:
        out["src_len"] = cache["src_len"]
    return out


# ---------------------------------------------------------------------------
# paged entry points (block-table KV; see runtime/paged_kv.py)
# ---------------------------------------------------------------------------

def paged_chunk(model: nn.Module, cfg: ModelConfig, tokens, ws, start,
                n_real):
    """One prefill chunk into the workspace: (last logits, ws). ``start``
    and ``n_real``: ints or 0-dim int32 tensors on the device."""
    return m_lm.lm_paged_prefill_chunk(model, cfg, tokens, ws, start, n_real)


def paged_splice(cfg: ModelConfig, pool, ws, block_row, start, length):
    """Commit workspace positions [start, length) to the pages (ints or
    0-dim int32 tensors); the rest goes to the trash page."""
    return m_lm.lm_paged_splice(cfg, pool, ws, block_row, start, length)


def paged_hydrate(cfg: ModelConfig, pool, block_row, hist_len, ws):
    """Rebuild the workspace prefix [0, hist_len) from cached pages
    (``hist_len`` an int or a 0-dim int32 tensor)."""
    return m_lm.lm_paged_hydrate(cfg, pool, block_row, hist_len, ws)


def paged_encdec_splice(cfg: ModelConfig, cache, prefill_layers, block_row,
                        length, slot: int):
    """One encdec request's prefill cache (``encdec_prefill``'s layers)
    into the pages of ``block_row`` and row ``slot`` of the cross K/V
    slabs, in place."""
    return m_encdec.encdec_paged_splice(cfg, cache, prefill_layers,
                                        block_row, length, slot)


def paged_packed(model: nn.Module, cfg: ModelConfig, tokens, pool, blocks,
                 bases, hists, lens, wws: int):
    """Several prompts' tails in one prefill call, straight into the
    pages: logits (S, 1, V), one row a segment. blocks (S, NB), bases,
    hists, lens (S,): integer tensors on the device (or arrays)."""
    return m_lm.lm_paged_prefill_packed(model, cfg, tokens, pool, blocks,
                                        bases, hists, lens, wws)


#: the engine stats that a speculative ``generate`` also returns
_SPEC_STATS = ("speculative_k", "draft_bits", "decode_steps", "spec_rounds",
               "acceptance_rate", "spec_tokens_per_round",
               "draft_extra_bytes", "draft_shared_leaves",
               "draft_coarse_leaves")


def generate(model: nn.Module, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
             *, steps: int, lengths=None, max_len: Optional[int] = None,
             temperature: float = 0.0, seed: int = 0,
             eos_id: Optional[int] = None, return_stats: bool = False,
             speculative: int = 0, draft_bits: int = 3, draft_params=None,
             device="cuda"):
    """Prefill the prompt then decode ``steps`` tokens: (B, steps) int32.

    A thin static-batch wrapper over ``runtime.engine.Engine``: the whole
    batch is preloaded into a capacity-B slot pool with one batched
    prefill, then decoded by the engine's loop. ``device`` is where the
    run happens ("cuda" unless asked for "cpu"); the model must already
    live there. ``lengths``: per-stream prompt lengths for right-padded
    batches (where ``api.exact_length_prefill``, each padded stream is
    prefilled alone, at its exact length, as the reference does).
    ``eos_id``: streams retire at their EOS and are right-padded with
    it. ``temperature`` > 0 samples stream i from the generator that a
    solo ``Engine(seed=seed)`` gives its request i. The kernel
    backend is ``cfg.kernel_backend``. ``return_stats=True`` also
    returns {"t_prefill_s", "t_decode_s", "t_warmup_s", "decode_tok_s",
    "backend"}, timed on the host clock (each ends in a device read). On
    CUDA the engine of the call captures its decode step at the first
    step: ``t_warmup_s`` is that capture, kept out of ``t_decode_s``.
    ``speculative``: draft block length k of self-speculative decoding
    (0: off; ``runtime/speculative.py``), drafting from the
    ``draft_bits`` view of ``model`` unless ``draft_params`` is given.
    Greedy tokens equal ``speculative=0``'s; the cache gets k positions
    of headroom, and the stats also hold ``spec_rounds``,
    ``acceptance_rate``, ``spec_tokens_per_round`` and the draft view's
    bytes (``_SPEC_STATS``). An encdec batch carries ``frames`` (B,
    S_src, D); the engine's source width is ``S_src``. A vlm batch may
    carry ``prefix_embeds`` (B, P, D): the engine widens its cache by
    the config's P (``max_len`` counts text tokens), and ``lengths``
    count text tokens.
    """
    from repro_torch.runtime.engine import Engine

    B, P = batch["tokens"].shape
    eng = Engine(model, cfg, capacity=B,
                 max_len=max_len or (P + steps + int(speculative)),
                 src_len=(batch["frames"].shape[1]
                          if cfg.family == "encdec" else 0),
                 temperature=temperature, seed=seed,
                 speculative=speculative, draft_bits=draft_bits,
                 draft_params=draft_params, device=device)
    lens = (None if lengths is None else np.broadcast_to(
        torch.as_tensor(lengths).cpu().numpy().astype(np.int32).reshape(-1),
        (B,)))
    padded = lens is not None and (int(lens.min()) != int(lens.max())
                                   or int(lens.max()) != P)
    if padded and api.exact_length_prefill(cfg):
        # every stream is prefilled at its exact length through the
        # admission path
        toks = torch.as_tensor(batch["tokens"]).cpu().numpy()
        for i in range(B):
            eng.submit(toks[i, :int(lens[i])], max_new=steps, eos_id=eos_id)
    else:
        eng.preload(batch, steps, lengths=lengths, eos_id=eos_id)
    results = eng.run()
    gen = np.full((B, steps), 0 if eos_id is None else eos_id, np.int32)
    for r in results:
        gen[r["rid"], :len(r["tokens"])] = r["tokens"]
    gen = torch.from_numpy(gen).to(eng.device)
    if not return_stats:
        return gen
    stats = eng.stats()
    out = {"t_prefill_s": stats["t_prefill_s"],
           "t_decode_s": stats["t_decode_s"],
           "t_warmup_s": stats["t_warmup_s"],
           "decode_tok_s": stats["decode_tok_s"],
           "backend": cfg.kernel_backend}
    if speculative:
        out.update({k: v for k, v in stats.items() if k in _SPEC_STATS})
    return gen, out
