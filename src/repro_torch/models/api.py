"""Model API (counterpart of ``repro.models.api``), every family of the
reference: dense, MoE, vlm, encoder-decoder, hybrid and ssm. GQA
attention or MLA (deepseek's latent cache, on the slot path only),
leading dense layers (``cfg.first_dense``), the vlm family's
bidirectional prefix of image embeddings (``prefix_embeds``, on the
slot path only), the encdec family's encoder over ``frames`` and
cross-attending decoder (``models/encdec.py``), the hybrid family's
Mamba2 layers with a shared attention block (``models/zamba.py``, on
the slot path only), and the ssm family's RWKV6 layers
(``models/rwkv.py``, attention-free, on the slot path only).

    init(cfg, seed=, device=)                  -> model
    quantize(model, cfg)                       -> model (in place)
    calibrate(model, cfg, batch, lengths=)     -> model (in place)
    loss_fn(model, cfg, batch)                 -> (loss, metrics)
    serve_state(cfg, seed=, pack4=, calib_batch=, device=)
                                               -> serve model [, manifest]
    draft_view(model, draft_bits=, with_report=) -> coarse draft model
    prefill(model, cfg, batch, lengths=)       -> (logits, cache)
    decode_step(model, cfg, token, cache)      -> (logits, cache)
    init_cache(cfg, batch, max_len, src_len=, device=) -> cache
    exact_length_prefill(cfg)                  -> bool
    paged_supported(cfg)                       -> bool
    init_paged_cache(cfg, batch, n_pages, page_size, n_blocks, src_len=,
                     device=)
    paged_decode_step(model, cfg, token, cache) -> (logits, cache)
    speculative_supported(cfg)                 -> (ok, reason)
    decode_window(model, cfg, tokens, cache)   -> (logits, cache)
    paged_decode_window(model, cfg, tokens, cache) -> (logits, cache)

An encdec batch carries ``frames`` (B, S_src, D) beside ``tokens``; its
caches hold each decoder layer's cross K/V of ``src_len`` source
positions. A vlm batch may carry ``prefix_embeds`` (B, P, D); its
cache's ``len`` then counts the P prefix positions too. A hybrid or
ssm cache holds a fixed-size recurrent state that a decode step
overwrites in place; its prompts are prefilled at their exact length
(the state integrates padding), it decodes one token a step and never
speculates. Every family trains through ``loss_fn``.

Every entry point that creates tensors runs on ``device="cuda"`` unless
the caller passes ``device="cpu"``; asking for CUDA where there is none
raises.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from repro_torch.core.policy import draft_view, quantize_tree
from repro_torch.device import resolve_device
from repro_torch.models import encdec as m_encdec
from repro_torch.models import lm as m_lm
from repro_torch.models import rwkv as m_rwkv
from repro_torch.models import zamba as m_zamba
from repro_torch.models.config import ModelConfig


#: the model families the port serves
FAMILIES = ("dense", "moe", "vlm", "encdec", "hybrid", "ssm")


def _ported(cfg: ModelConfig):
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r} (config "
                         f"{cfg.name!r}); the port serves {FAMILIES}")


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> nn.Module:
    """Random fp32 model from ``seed``, built on ``device``."""
    _ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.family == "encdec":
        return m_encdec.init_encdec(gen, cfg, device=dev)
    if cfg.family == "hybrid":
        return m_zamba.init_zamba(gen, cfg, device=dev)
    if cfg.family == "ssm":
        return m_rwkv.init_rwkv(gen, cfg, device=dev)
    return m_lm.init_lm(gen, cfg, device=dev)


def resolved_policy(cfg: ModelConfig):
    """The effective QuantPolicy for a config (None = fp baseline)."""
    from repro_torch.core.rules import EMBED_PATTERN, QuantRule, as_policy

    policy = as_policy(cfg.quant)
    if policy is None:
        return None
    if not cfg.quantize_embed:
        policy = policy.prepend(QuantRule(EMBED_PATTERN, None, name="embed-fp"))
    return policy


def quantize(model: nn.Module, cfg: ModelConfig) -> nn.Module:
    """Install LUT-Q state on every eligible kernel (paper step 0), in
    place."""
    policy = resolved_policy(cfg)
    if policy is None:
        return model
    return quantize_tree(model, policy)


def calibrate(model: nn.Module, cfg: ModelConfig, batch, *, lengths=None
              ) -> nn.Module:
    """Freeze activation scales from one short calibration batch, in
    place; returns ``model``.

    Runs a prefill forward of the model under
    :func:`repro_torch.core.actquant.capture_act_scales` (max|x| at each
    matmul boundary, one maximum per logical leaf; an encdec batch
    carries ``frames``, a vlm batch may carry ``prefix_embeds``), then
    installs
    ``[scale, qmax]`` pairs into the ``act`` of every leaf whose rule has
    ``act_frozen=True`` and ``act_bits < 32``. The pairs persist through
    ``serve_view`` and checkpoints; the pow2 backend quantizes
    activations with them instead of a per-call max.
    """
    from repro_torch.core.actquant import apply_act_scales, capture_act_scales

    with torch.no_grad(), capture_act_scales(model) as record:
        prefill(model, cfg, batch, lengths=lengths)
    return apply_act_scales(model, record, quant=resolved_policy(cfg))


def serve_state(cfg: ModelConfig, *, seed: int = 0, pack4: bool = False,
                with_manifest: bool = False, calib_batch=None,
                device="cuda"):
    """init -> quantize [-> calibrate] -> serve_view. Returns the serve
    model (plus the backend manifest with ``with_manifest=True``); the
    fp masters are dropped with the quantized tree. ``calib_batch``: a
    prefill batch (``{"tokens": ...}``, with ``"frames"`` for encdec) run
    through :func:`calibrate`
    before the serve view, freezing activation scales for
    ``act_frozen`` rules (the ``serving_pow2`` preset). The draft model
    of self-speculative decoding is ``draft_view(serve_state(...))``
    (:func:`repro_torch.core.policy.draft_view`)."""
    from repro_torch.core.policy import serve_view

    qmodel = quantize(init(cfg, seed=seed, device=device), cfg)
    if calib_batch is not None:
        qmodel = calibrate(qmodel, cfg, calib_batch)
    return serve_view(qmodel, pack4=pack4, policy=resolved_policy(cfg),
                      with_manifest=with_manifest)


def loss_fn(model: nn.Module, cfg: ModelConfig, batch):
    """Training loss of a batch (tokens, labels; a vlm batch's
    ``prefix_embeds`` and an encdec batch's ``frames`` too): (loss,
    metrics). Each family's loss is the masked CE over f32 logits
    (``models/lm.masked_ce``) of its training forward."""
    _ported(cfg)
    if cfg.family == "encdec":
        return m_encdec.encdec_loss(model, cfg, batch)
    if cfg.family == "hybrid":
        return m_zamba.zamba_loss(model, cfg, batch)
    if cfg.family == "ssm":
        return m_rwkv.rwkv_loss(model, cfg, batch)
    return m_lm.lm_loss(model, cfg, batch)


def prefill(model: nn.Module, cfg: ModelConfig, batch, *, lengths=None):
    """Run the prompt, return (last_logits (B, 1, V), cache). An encdec
    batch encodes ``batch["frames"]`` first; a vlm batch's
    ``prefix_embeds`` go in front of the text (``lengths`` count text
    tokens). A hybrid or ssm prompt batch should be of one length: its
    state integrates the padding (``models/zamba.zamba_prefill``,
    ``models/rwkv.rwkv_prefill``)."""
    _ported(cfg)
    if cfg.family == "encdec":
        return m_encdec.encdec_prefill(model, cfg, batch["frames"],
                                       batch["tokens"], lengths=lengths)
    if cfg.family == "hybrid":
        return m_zamba.zamba_prefill(model, cfg, batch["tokens"],
                                     lengths=lengths)
    if cfg.family == "ssm":
        return m_rwkv.rwkv_prefill(model, cfg, batch["tokens"],
                                   lengths=lengths)
    return m_lm.lm_prefill(model, cfg, batch["tokens"],
                           prefix_embeds=batch.get("prefix_embeds"),
                           lengths=lengths)


def decode_step(model: nn.Module, cfg: ModelConfig, token, cache):
    """(B, W) tokens against a cache at length n -> (logits (B, W, V),
    cache at n + W). W = 1 is a decode step; a wider W is a speculative
    verify window, each row the bits of W chained steps
    (``models/lm.lm_decode``, ``models/encdec.encdec_decode``); a hybrid
    or ssm config takes W = 1 only and updates its cache in place
    (``models/zamba.zamba_decode``, ``models/rwkv.rwkv_decode``)."""
    _ported(cfg)
    if cfg.family == "encdec":
        return m_encdec.encdec_decode(model, cfg, token, cache)
    if cfg.family == "hybrid":
        return m_zamba.zamba_decode(model, cfg, token, cache)
    if cfg.family == "ssm":
        return m_rwkv.rwkv_decode(model, cfg, token, cache)
    return m_lm.lm_decode(model, cfg, token, cache)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               src_len: int = 0, device="cuda"):
    """An empty slot cache; an encdec one holds ``src_len`` (else
    ``max_len``) cross positions a row, as the reference's; an ssm one
    has a fixed size and ignores ``max_len``."""
    _ported(cfg)
    dev = resolve_device(device)
    if cfg.family == "encdec":
        return m_encdec.init_encdec_cache(cfg, batch, max_len,
                                          src_len or max_len, device=dev)
    if cfg.family == "hybrid":
        return m_zamba.init_zamba_cache(cfg, batch, max_len, device=dev)
    if cfg.family == "ssm":
        return m_rwkv.init_rwkv_cache(cfg, batch, device=dev)
    return m_lm.init_cache(cfg, batch, max_len, device=dev)


def exact_length_prefill(cfg: ModelConfig) -> bool:
    """Whether a batched prefill must hold prompts of one length: MoE
    routing capacity couples real tokens to padding, and a recurrent
    state (ssm, hybrid) integrates it (the engine groups such requests
    by prompt length, ``generate`` prefills padded streams alone)."""
    return bool(cfg.n_experts) or cfg.family in ("ssm", "hybrid")


def paged_supported(cfg: ModelConfig) -> bool:
    """Configs the paged KV cache serves: dense attention without MLA,
    experts, prefix layers or a modality prefix, and encdec (its growing
    self-attention K/V paged, its cross K/V a slab a slot). MoE, vlm,
    hybrid and ssm (a fixed-size recurrent state) stay on the slot path,
    as in the reference (an ``Engine(kv_pages=...)`` of such a config
    silently serves through its slot pool)."""
    if cfg.family == "encdec":
        return True
    return (cfg.family == "dense" and not cfg.use_mla and cfg.n_experts == 0
            and cfg.first_dense == 0 and cfg.n_prefix_tokens == 0)


def init_paged_cache(cfg: ModelConfig, batch: int, n_pages: int,
                     page_size: int, n_blocks: int, *, src_len: int = 0,
                     device="cuda"):
    if not paged_supported(cfg):
        raise ValueError(f"paged KV unsupported for family={cfg.family} "
                         "(use api.paged_supported to gate)")
    dev = resolve_device(device)
    if cfg.family == "encdec":
        return m_encdec.init_paged_encdec_cache(cfg, batch, n_pages,
                                                page_size, n_blocks, src_len,
                                                device=dev)
    return m_lm.init_paged_cache(cfg, batch, n_pages, page_size, n_blocks,
                                 device=dev)


def paged_decode_step(model: nn.Module, cfg: ModelConfig, token, cache):
    """Paged-pool twin of :func:`decode_step`."""
    _ported(cfg)
    if cfg.family == "encdec":
        return m_encdec.encdec_paged_decode(model, cfg, token, cache)
    return m_lm.lm_paged_decode(model, cfg, token, cache)


def speculative_supported(cfg: ModelConfig) -> Tuple[bool, str]:
    """Whether self-speculative decoding can serve ``cfg``: ``(ok,
    reason)``, the reference's refusals and reasons. Speculation needs
    rollback to be a cache-length truncation (no recurrent state or MLA
    latents) and the verify window's rows to be independent, so that one
    batched forward gives each row the bits of chained one-token steps:
    MoE routing couples the window's tokens, and dynamic activation
    quantization takes a scale over the whole batch."""
    if cfg.act_bits < 32:
        return False, ("speculative decoding refused under activation "
                       "quantization: per-tensor act scales couple draft "
                       "and verify rows (act_bits < 32)")
    if cfg.family == "encdec":
        return True, ""
    if cfg.n_experts > 0 or cfg.family == "moe":
        return False, ("speculative decoding unsupported with MoE: "
                       "routing/capacity couples the verify-window token "
                       "batch, breaking per-position parity")
    if cfg.family not in ("dense", "vlm"):
        return False, (f"speculative decoding unsupported for family="
                       f"{cfg.family}: recurrent/hybrid state cannot rewind "
                       "rejected tokens")
    if cfg.use_mla:
        return False, ("speculative decoding unsupported with MLA: the "
                       "latent cache is not length-truncatable bitwise")
    return True, ""


#: a speculative verify window: (B, W) tokens through the decode path
decode_window = decode_step
paged_decode_window = paged_decode_step
