"""Serving: prefill-cache adaptation and static-batch greedy generation.

Counterpart of ``repro.runtime.serving``:
  * ``ring_from_linear``: re-lay a linear KV cache into the SWA ring
    (slot = position % window) so decode can continue a long prompt;
  * ``grow_cache``: right-pad linear caches to max_len;
  * ``adapt_prefill_cache``: prefill cache -> decode-ready cache;
  * ``generate``: prefill, adapt the cache, argmax, then ``steps - 1``
    decode steps. It does for a static batch what the reference's
    ``Engine.preload`` plus ``run`` do; the engine, temperature
    sampling, ``eos_id`` and speculative decoding are not ported yet and
    raise.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.nn.tree import module_device


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
                        *, lengths=None):
    """Convert a prefill cache into a decode-ready cache of max_len.

    ``lengths``: per-stream (B,) prompt lengths for right-padded batches;
    defaults to the prefill cache's own ``len`` vector.
    """
    dev = cache["len"].device
    target = api.init_cache(cfg, batch, max_len, device=dev)
    if lengths is None:
        lengths = cache["len"]
    lengths = torch.as_tensor(lengths, device=dev).reshape(-1)
    lengths = lengths.expand(batch).to(torch.int32)
    layers = [dict(c) for c in cache["layers"]]
    if cfg.kv_cache_bits == 8:
        # prefill emits float K/V; the decode cache holds int8 + scales
        from repro_torch.models.lm import _kv_quant

        for c in layers:
            for key in ("k", "v"):
                c[key], c[f"{key}_scale"] = _kv_quant(c[key], 8)
    out = {"len": lengths}
    if cfg.window is not None:
        # SWA ring: re-lay per-position leaves at the decode ring width,
        # each stream at its own length
        out["layers"] = [
            {k: ring_from_linear(v, lengths, t[k].shape[1]).to(t[k].dtype)
             for k, v in c.items()}
            for c, t in zip(layers, target["layers"])]
        return out
    out["layers"] = grow_cache(layers, target["layers"])
    return out


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits (B, 1, V) -> (B, 1) int32 argmax (first maximum on ties)."""
    return torch.argmax(logits[:, -1].float(), dim=-1)[:, None].to(torch.int32)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(model: nn.Module, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
             *, steps: int, lengths=None, max_len: Optional[int] = None,
             temperature: float = 0.0, eos_id: Optional[int] = None,
             return_stats: bool = False, speculative: int = 0,
             device="cuda"):
    """Prefill the prompt then decode greedily: returns (B, steps) int32.

    ``device`` is where the run happens ("cuda" unless asked for "cpu");
    the model must already live there. ``lengths``: per-stream prompt
    lengths for right-padded batches. The kernel backend is
    ``cfg.kernel_backend``. ``return_stats=True`` also returns
    {"t_prefill_s", "t_decode_s", "decode_tok_s", "backend"}, timed on
    the host clock around work that ends in a device synchronize.
    """
    if temperature != 0.0:
        raise NotImplementedError("temperature sampling is not ported yet "
                                  "(ROADMAP queue 1 item 2)")
    if eos_id is not None:
        raise NotImplementedError("eos_id is not ported yet (ROADMAP "
                                  "queue 1 item 2)")
    if speculative:
        raise NotImplementedError("speculative decoding is not ported yet "
                                  "(ROADMAP queue 1 item 5)")
    dev = resolve_device(device)
    have = module_device(model)
    if have is not None and have.type != dev.type:
        raise ValueError(f"generate(device={str(dev)!r}) but the model "
                         f"lives on {have}")
    toks = batch["tokens"].to(dev)
    B, P = toks.shape
    max_len = max_len or (P + steps)
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=dev).reshape(-1).expand(B)

    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = api.prefill(model, cfg, {"tokens": toks},
                                    lengths=lengths)
        cache = adapt_prefill_cache(cfg, cache, B, max_len, lengths=lengths)
        tok = _greedy(logits)
        out = [tok]
        _sync(dev)
        t1 = time.perf_counter()
        for _ in range(steps - 1):
            logits, cache = api.decode_step(model, cfg, tok, cache)
            tok = _greedy(logits)
            out.append(tok)
        gen = torch.cat(out, dim=1)
        _sync(dev)
        t2 = time.perf_counter()
    if not return_stats:
        return gen
    decoded = B * (steps - 1)
    return gen, {"t_prefill_s": t1 - t0, "t_decode_s": t2 - t1,
                 "decode_tok_s": decoded / max(t2 - t1, 1e-9),
                 "backend": cfg.kernel_backend}
