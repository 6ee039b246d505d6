"""Continuous-batching serving engine: slot pool, FIFO queue, paged KV.

Counterpart of ``repro.runtime.engine``. A fixed-capacity **slot pool**:
every decode step advances all ``capacity`` slots through one decode
step and per-slot sampling, while a FIFO queue prefills new requests
into free slots mid-flight and EOS / max-token retirement frees slots
the same step.

Lifecycle per request (``docs/serving.md``)::

  submit -> [queue] -> admit: requests taken the same step share ONE
                              batched prefill (per-stream ``lengths``)
                              -> adapt_prefill_cache -> cache rows
         -> decode: one token per engine step, per-slot position and
                    sampling generator
         -> retire: EOS or max_new reached; slot freed the same step

With ``kv_pages`` the slots' caches become block-table rows over a
global page pool (``runtime/paged_kv.py``): admission reserves pages
(FIFO deferral on a shortfall, evicting cold prefixes first), long
prompts prefill in chunks of at most ``max_chunk`` tokens, one chunk per
engine step, prompt pages are published to a prefix cache that later
requests hit, and pages that slide behind the attention window are
released mid-generation. Decode attends through the block table in the
``paged_attn`` CUDA kernel (``kernels/paged_attn.py``).

Sampling: greedy is an argmax. With a temperature each request owns a
``torch.Generator`` on the engine's device, seeded from (engine seed,
rid) or from ``submit(seed=)``, so its samples depend on its own
generator only and a solo run reproduces them. The numbers are not
``jax.random``'s.

The decode step (forward, the new KV entries, ``len + 1`` and, greedy,
the argmax) is one function over the engine's own buffers; on the CPU
it is called, and on CUDA it is captured once per engine as a CUDA graph
and replayed, the counterpart of the reference's jit of ``decode_step +
sample``, keyed as that is on the engine's geometry: (capacity, max_len,
greedy) for the slot pool, (capacity, n_pages, page_size, n_blocks,
greedy) for the paged engine. A paged engine built with ``warmup`` runs
the step once over its dead slots and captures it at construction, as
the reference's ``_warm_paged`` compiles it (``stats()["t_warmup_s"]``);
other engines capture at their first decode step, as a lazy jit traces.
``paged_trace_counts`` counts the graphs an engine captured and
:func:`disable_graphs` is the counterpart of ``jax.disable_jit``.

A paged engine's chunked prefill is captured the same way, as the
reference jits it: one graph per chunk width of
``paged_kv.prefill_buckets(max_chunk)`` (``start`` and ``n_real`` are
0-dim device buffers, the reference's traced scalars), one for the
hydrate and one for the splice, all over the engine's own buffers and
sharing one memory pool; a warmed engine captures them at construction
beside the decode step.

Packed prefill (``prefill_pack``, on for a paged engine at ``act_bits >=
32``, as in the reference): when no chunked prefill is in flight,
consecutive queue heads whose prompt tails (past their prospective
prefix hits) sum within ``max_chunk`` and whose ``attn_kv_block``-aligned
workspace spans fit the workspace are admitted together, and ONE call
(``serving.paged_packed``) hydrates, prefills and splices them all,
with segment-masked attention; it is captured as one graph per bucket
width, as the chunk is. Dynamic activation scales span a whole product,
so under ``act_bits < 32`` packing would couple the segments' rows and
stays off. The slot pool's batched prefill, the first
token's sampling and temperature sampling run eagerly. The kernel
wrappers' launch counts (``COUNTS`` in ``kernels/``) count a replay as
the eager step it stands for.

Self-speculative decoding (``speculative=k``, ``runtime/speculative.py``):
each engine step is one round, in which a coarse ``draft_bits`` view of
the same LUT-Q indices drafts k tokens and one verify window of the
target checks them, with one host read a round. Greedy rounds give the
tokens of non-speculative decoding; a greedy round is one function over
the engine's buffers, captured and replayed as the decode step is (a
paged engine's warmup captures both); a temperature round runs eagerly.

An encdec engine (``src_len``: the widest source it takes) serves
requests that carry ``frames`` (S_src <= src_len, D). The slot pool
prefills a group of equal source widths in one call (the encoder's
padding would reach real positions) and right-pads each row's cross K/V
to ``src_len``, masked by the row's ``src_len``. A paged encdec engine
admits one request a step through one bucket-padded prefill and
``serving.paged_encdec_splice``, eagerly, as the slot pool's prefill
runs; its decode step and greedy round are captured as graphs that read
``len`` and ``src_len`` on the device. Its prefix cache and packed
prefill are off: the K/V depends on the frames.

A hybrid engine (zamba2) keeps each slot's Mamba state (the SSM state
and the conv window a layer) beside its shared block's K/V; the captured
decode step overwrites that state in place, so every replay advances
it. Its requests are prefilled in groups of one prompt length (the
state integrates padding), and it stays on the slot path, as in the
reference. An ssm engine (rwkv6) is the same without any K/V: each
slot's state is a WKV matrix and two token-shift rows a layer, spliced
into the slot rows in place at admission (``_admit_group``) and
overwritten in place by every replay of the captured step.

A vlm engine (paligemma) serves requests with or without
``prefix_embeds`` (P, D), the config's P precomputed image embeddings
in front of the prompt. Its slots are ``max_len + P`` wide (``max_len``
counts text tokens, and a request's length check counts P even when it
brings no prefix, as the reference's does). Prefixed and text-only
requests never share a prefill (their caches start at other widths); a
prefixed row's ``len`` counts its P prefix slots. A vlm engine stays on
the slot path, as in the reference (``api.paged_supported``).

Not ported yet, and raising ``NotImplementedError``: ``mesh`` (ROADMAP
queue 1, multi-GPU).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.core import actquant
from repro_torch.device import resolve_device, scalar_like
from repro_torch.kernels import audit, ops
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import init_paged_workspace
from repro_torch.nn.tree import module_device
from repro_torch.runtime import paged_kv, speculative as spec
from repro_torch.runtime.serving import (adapt_prefill_cache, paged_chunk,
                                         paged_encdec_splice, paged_hydrate,
                                         paged_packed, paged_splice)


#: open :func:`disable_graphs` blocks
_GRAPHS_OFF = 0


@contextlib.contextmanager
def disable_graphs():
    """Counterpart of ``jax.disable_jit()``: engine decode steps, rounds
    and prefill chunks, hydrates and splices taken inside the block run
    their functions eagerly on CUDA too, with no capture and no replay
    (an engine's graphs, if it has them, are kept)."""
    global _GRAPHS_OFF
    _GRAPHS_OFF += 1
    try:
        yield
    finally:
        _GRAPHS_OFF -= 1


def synthetic_requests(cfg: ModelConfig, n: int, *, max_prompt: int,
                       max_new: int, seed: int = 0, src_len: int = 0,
                       rate: float = 0.0):
    """Deterministic ragged workload, the reference's for the same seed:
    ``n`` requests with prompt lengths uniform in [max(2, max_prompt//4),
    max_prompt], max_new uniform in [max(1, max_new//8), max_new], for
    encdec ``frames`` of a width uniform in [max(2, src_len//2),
    src_len] (standard normal, float32), for vlm ``prefix_embeds`` of
    the config's P rows (standard normal, float32, drawn after the
    request's tokens), and (``rate > 0``) Poisson arrival offsets at
    ``rate`` requests/s. Returns kwargs dicts for ``Engine.submit`` plus
    ``arrival_s``."""
    rng = np.random.default_rng(seed)
    t = 0.0
    reqs = []
    for _ in range(n):
        L = int(rng.integers(max(2, max_prompt // 4), max_prompt + 1))
        g = int(rng.integers(max(1, max_new // 8), max_new + 1))
        reqs.append({
            "tokens": rng.integers(0, cfg.vocab, size=(L,)).astype(np.int32),
            "max_new": g,
            "arrival_s": t,
        })
        if cfg.family == "encdec":
            sl = int(rng.integers(max(2, src_len // 2), src_len + 1))
            reqs[-1]["frames"] = rng.standard_normal(
                (sl, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            reqs[-1]["prefix_embeds"] = rng.standard_normal(
                (cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
        if rate > 0:
            t += float(rng.exponential(1.0 / rate))
    return reqs


def request_seed(engine_seed: int, rid: int) -> int:
    """The sampling seed of request ``rid`` of an engine seeded with
    ``engine_seed`` (what ``submit`` uses unless given ``seed=``)."""
    return int(np.random.SeedSequence([engine_seed, rid]).generate_state(1)[0])


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray                      # (L,) int32 prompt
    max_new: int
    eos_id: Optional[int]
    gen: Optional[torch.Generator]          # sampling generator (temperature)
    frames: Optional[torch.Tensor] = None   # encdec source embeddings (S, D)
    prefix_embeds: Optional[torch.Tensor] = None  # vlm image prefix (P, D)
    out: List[int] = dataclasses.field(default_factory=list)
    pstart: int = 0   # index into the engine's pending-token list
    kv_pages: int = 0  # pages reserved at admission (paged engines)
    finish: str = ""
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


class Engine:
    """Fixed-capacity continuous-batching engine.

    Usage::

        eng = Engine(model, cfg, capacity=8, max_len=128, device="cuda")
        eng.submit(prompt_tokens, max_new=32, eos_id=2)
        for result in eng.run(stream=True):
            ...                      # per-request dict as it retires
        print(eng.stats())

    ``capacity``: decode slots (the fixed decode batch). ``max_len``:
    per-slot context in text tokens (prompt + new); a vlm config's
    prefix of P positions widens each slot to ``max_len + P``.
    ``kv_pages``: serve through the paged KV cache with this many pages
    of ``page_size`` tokens (``prefix_cache`` shares prompt pages).
    ``device``: where the engine's state lives and the run happens; the
    model must already be there. ``warmup``: a paged engine runs its
    decode step (and speculative round), every prefill chunk width, the
    hydrate, the splice and (``prefill_pack``) a packed call of every
    width once at construction and, on CUDA, captures them there (others
    capture each at its first call). ``prefill_pack``: admit several
    short prompts' tails in one packed prefill call where the engine is
    paged and ``act_bits >= 32`` (``self.prefill_pack`` says whether it
    is on).
    ``speculative``: draft block length k (0: off). Each engine step is
    then one speculative round: the ``draft_bits`` view of the model
    (``api.draft_view``, or ``draft_params``) drafts k tokens and one
    target forward over the k + 1 window checks them. Every request
    needs k tokens of cache headroom (``submit`` checks it).
    ``src_len``: an encdec engine's cross-attention memory width, the
    most frames a request may carry.
    """

    def __init__(self, model: nn.Module, cfg: ModelConfig, *,
                 capacity: int = 8, max_len: int = 128, src_len: int = 0,
                 temperature: float = 0.0, seed: int = 0,
                 backend: Optional[str] = None, mesh=None, kv_pages: Optional[int] = None,
                 page_size: int = 64, prefix_cache: bool = True,
                 max_chunk: int = 256, prefill_pack: bool = True,
                 warmup: bool = True, speculative: int = 0,
                 draft_bits: int = 3, draft_params: Optional[nn.Module] = None,
                 device="cuda"):
        if mesh is not None:
            raise NotImplementedError("meshed serving is not ported yet "
                                      "(ROADMAP queue 1, multi-GPU)")
        if backend is not None:
            cfg = cfg.replace(kernel_backend=backend)
        self.device = resolve_device(device)
        have = module_device(model)
        if have is not None and have.type != self.device.type:
            raise ValueError(f"Engine(device={str(self.device)!r}) but the "
                             f"model lives on {have}")
        self.cfg = cfg
        self.model = model
        self.capacity = int(capacity)
        # a vlm slot holds the image prefix's positions before the text
        self.prefix = cfg.n_prefix_tokens if cfg.family == "vlm" else 0
        self.max_len = int(max_len) + self.prefix
        self.src_len = int(src_len)
        self.encdec = cfg.family == "encdec"
        self.temperature = float(temperature)
        self.greedy = self.temperature <= 0
        self.seed = int(seed)
        self.paged = kv_pages is not None and api.paged_supported(cfg)
        # packed prefill couples the rows of a product: off under dynamic
        # activation scales (per-tensor maxima), as in the reference
        self.prefill_pack = (bool(prefill_pack) and self.paged
                             and cfg.family != "encdec"
                             and cfg.act_bits >= 32)
        # self-speculative decoding (runtime/speculative.py); the
        # refusals are exactness gates, as in the reference
        self.spec_k = int(speculative)
        self.draft_bits = int(draft_bits)
        self.draft_report: Optional[Dict[str, Dict]] = None
        self.n_spec_rounds = 0
        self._spec_acc_tok = 0    # accepted tokens over live slot-rounds
        self._spec_acc_draft = 0  # accepted draft tokens (bonus excluded)
        self._spec_live = 0       # live slot-rounds
        if self.spec_k:
            if self.spec_k < 1:
                raise ValueError(f"speculative k must be >= 1, got "
                                 f"{self.spec_k}")
            ok, why = api.speculative_supported(cfg)
            if not ok:
                raise ValueError(why)
            eff = spec.ring_width(cfg, self.max_len)
            if not self.paged and eff is not None and self.spec_k + 1 > eff:
                raise ValueError(
                    f"speculative k={self.spec_k} needs k+1 <= ring width "
                    f"{eff} (verify window must fit in the SWA ring)")
            if draft_params is None:
                draft_params, self.draft_report = api.draft_view(
                    model, draft_bits=self.draft_bits, with_report=True)
        self.draft = draft_params if self.spec_k else None
        self._chunking: Optional[Dict[str, Any]] = None
        self.n_chunk_calls = 0
        self.n_packed_groups = 0
        self.n_packed_reqs = 0
        dev = self.device
        if self.paged:
            self.page_size = int(page_size)
            self.n_blocks = -(-self.max_len // self.page_size)
            self.n_pages = int(kv_pages)
            # an encdec request's K/V depends on its frames: never shared
            self.pkv = paged_kv.PagedKV(
                self.n_pages, self.page_size, self.n_blocks, self.capacity,
                prefix_cache=prefix_cache and not self.encdec)
            self.cache = api.init_paged_cache(cfg, self.capacity,
                                              self.n_pages, self.page_size,
                                              self.n_blocks,
                                              src_len=self.src_len,
                                              device=dev)
            if self.encdec:
                # a whole prompt in one prefill, padded to a pow2 bucket
                self.max_chunk = paged_kv.next_pow2(self.max_len)
            else:
                self.max_chunk = min(int(max_chunk),
                                     paged_kv.next_pow2(self.max_len))
                self.wws = paged_kv.workspace_len(
                    self.max_len, self.n_blocks, self.page_size)
                self.ws = init_paged_workspace(cfg, self.wws, device=dev)
            self.buckets = paged_kv.prefill_buckets(self.max_chunk)
            # the chunk's inputs and output, where its graphs read and
            # write them: each width replays on its own leading columns
            # of the token buffer (a prompt tail pads to at least 16)
            self.chunk_tok = torch.zeros((1, max(self.max_chunk, 16)),
                                         dtype=torch.int32, device=dev)
            scalar = functools.partial(torch.zeros, (), dtype=torch.int32,
                                       device=dev)
            self.chunk_start, self.chunk_n_real = scalar(), scalar()
            self.chunk_hit, self.chunk_length = scalar(), scalar()
            self.chunk_row = torch.zeros((self.n_blocks,), dtype=torch.int32,
                                         device=dev)
            self.chunk_logits = torch.zeros((1, 1, cfg.vocab),
                                            dtype=torch.float32, device=dev)
            # a packed call's inputs beside chunk_tok: one block row and
            # (base, hist, len) a segment, and its logits, a row each
            self.pack_blocks = torch.zeros((self.capacity, self.n_blocks),
                                           dtype=torch.int32, device=dev)
            self.pack_meta = torch.zeros((3, self.capacity),
                                         dtype=torch.int32, device=dev)
            self.pack_logits = torch.zeros((self.capacity, 1, cfg.vocab),
                                           dtype=torch.float32, device=dev)
        else:
            self.cache = api.init_cache(cfg, self.capacity, self.max_len,
                                        src_len=self.src_len, device=dev)
        self.tok = torch.zeros((self.capacity, 1), dtype=torch.int32,
                               device=dev)
        self.logits = torch.zeros((self.capacity, 1, cfg.vocab),
                                  dtype=torch.float32, device=dev)
        # a round's tokens and accepted counts (speculative engines)
        self.spec_out = torch.zeros((self.capacity, self.spec_k + 1),
                                    dtype=torch.int32, device=dev)
        self.spec_acc = torch.zeros((self.capacity,), dtype=torch.int32,
                                    device=dev)
        #: captured steps, "decode", "spec", "chunk<width>", "hydrate",
        #: "splice" and "packed<width>": (graph, the kernel launches a
        #: replay stands for)
        self._graphs: Dict[str, Any] = {}
        #: the memory pool the prefill graphs share (made at the first)
        self._prefill_pool = None
        self.t_warmup = 0.0
        self.slots: List[Optional[Request]] = [None] * self.capacity
        self.queue: deque = deque()
        self._pending: List[torch.Tensor] = []  # un-synced decode tokens
        self.results: Dict[int, Dict[str, Any]] = {}
        self._next_rid = 0
        self.n_decode_steps = 0
        self.n_admitted = 0
        self.t_prefill = 0.0
        self.t_decode = 0.0
        self._t_start: Optional[float] = None
        if self.paged and warmup:
            self._warm()

    # ------------------------------------------------------------- queue

    def _new_request(self, tokens, max_new, eos_id, seed, t_submit):
        rid = self._next_rid
        self._next_rid += 1
        gen = None
        if not self.greedy:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(request_seed(self.seed, rid) if seed is None
                            else int(seed))
        return Request(rid, tokens, int(max_new), eos_id, gen,
                       t_submit=t_submit)

    def submit(self, tokens, *, max_new: int, eos_id: Optional[int] = None,
               seed: Optional[int] = None, frames=None,
               prefix_embeds=None) -> int:
        """Enqueue one request; returns its rid (FIFO admission order).

        ``seed``: the request's sampling seed (default
        ``request_seed(engine seed, rid)``). To reproduce a temperature
        stream of one engine in another, submit it with the same seed.
        ``frames``: an encdec request's source embeddings (S, D), S <=
        the engine's ``src_len`` (other families ignore them, as the
        reference does). ``prefix_embeds``: a vlm request's image
        prefix (P, D) (a vlm request may also come without one); other
        families refuse it.
        """
        if prefix_embeds is not None:
            prefix_embeds = self._prefix_embeds(prefix_embeds)
        if self.encdec:
            if frames is None:
                raise ValueError("encdec requests need `frames`")
            frames = torch.as_tensor(frames)
            if frames.shape[0] > self.src_len:
                raise ValueError(f"frames {frames.shape[0]} exceed engine "
                                 f"src_len {self.src_len}")
        if isinstance(tokens, torch.Tensor):
            tokens = tokens.cpu().numpy()
        prompt = np.asarray(tokens, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if (len(prompt) + int(max_new) + self.prefix + self.spec_k
                > self.max_len):
            extra = (f" (+{self.spec_k} speculative headroom)"
                     if self.spec_k else "")
            raise ValueError(f"prompt {len(prompt)} + max_new {max_new}"
                             f"{extra} exceeds engine max_len "
                             f"{self.max_len - self.prefix}")
        if self.paged:
            n_need = self.pkv.n_pages_for(
                len(prompt) + int(max_new) + self.spec_k)
            if n_need > self.n_pages - 1:
                raise ValueError(
                    f"request needs {n_need} KV pages but the pool only has "
                    f"{self.n_pages - 1} allocatable pages")
        req = self._new_request(prompt, max_new, eos_id, seed,
                                time.perf_counter())
        if self.encdec:
            req.frames = frames
        req.prefix_embeds = prefix_embeds
        self.queue.append(req)
        return req.rid

    def _prefix_embeds(self, e) -> torch.Tensor:
        """A request's image prefix as a tensor, refused unless the
        engine serves a vlm config and it is (P, d_model)."""
        if not self.prefix:
            raise ValueError(f"prefix_embeds are for a vlm config; "
                             f"{self.cfg.name!r} is {self.cfg.family}")
        e = torch.as_tensor(e)
        if tuple(e.shape) != (self.prefix, self.cfg.d_model):
            raise ValueError(f"prefix_embeds {tuple(e.shape)}, expected "
                             f"({self.prefix}, {self.cfg.d_model})")
        return e

    # ---------------------------------------------------------- sampling

    def _sample(self, logits, reqs: List[Optional[Request]]) -> torch.Tensor:
        """Per-row sampling: logits (n, 1, V) -> (n,) int32. Greedy rows
        take the first maximum; with a temperature, row i draws from its
        request's generator (rows without a request give 0)."""
        lg = logits[:, -1].float()
        if self.greedy:
            return torch.argmax(lg, dim=-1).to(torch.int32)
        temp = scalar_like(max(self.temperature, 1e-6), lg)
        probs = torch.softmax(lg / temp, dim=-1)
        out = torch.zeros(lg.shape[0], dtype=torch.int32, device=lg.device)
        for i, req in enumerate(reqs):
            if req is not None:
                out[i] = torch.multinomial(probs[i], 1,
                                           generator=req.gen)[0].to(torch.int32)
        return out

    # --------------------------------------------------------- admission

    def _group_key(self, req: Request):
        """Requests admitted in one step share one batched prefill where
        exactness allows it: attention-only families batch ragged prompts
        freely (per-stream ``lengths`` keep them exact); MoE routing
        couples real tokens to padding (capacity) and a recurrent state
        integrates it, so MoE, ssm and hybrid group by exact prompt
        length, encdec by source width (padded frames would reach the
        real positions' memory), and prefixed and text-only vlm requests
        apart (their caches start at other widths), as the reference's
        engine does."""
        if api.exact_length_prefill(self.cfg):
            return ("exact", len(req.tokens))
        if self.encdec:
            return ("src", req.frames.shape[0])
        return ("any", req.prefix_embeds is not None)

    def _admit_group(self, slots: List[int], reqs: List[Request]):
        """Prefill a group of requests with ONE batched call and write
        each row into its slot."""
        t0 = time.perf_counter()
        cfg, dev = self.cfg, self.device
        m = len(reqs)
        Ls = [len(r.tokens) for r in reqs]
        toks = np.zeros((m, max(Ls)), np.int32)
        for i, r in enumerate(reqs):
            toks[i, :Ls[i]] = r.tokens
        lengths = torch.tensor(Ls, dtype=torch.int32, device=dev)
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        if self.encdec:  # one source width a group
            batch["frames"] = torch.stack([r.frames for r in reqs]).to(dev)
        # a prefix occupies cache slots only where the group brings one
        # (the group key keeps prefixed and text-only requests apart)
        pfx = 0
        if reqs[0].prefix_embeds is not None:
            batch["prefix_embeds"] = torch.stack(
                [r.prefix_embeds for r in reqs]).to(dev)
            pfx = self.prefix
        # the prefill takes text lengths; the cache's len counts the
        # prefix's slots too
        logits, pcache = api.prefill(self.model, cfg, batch, lengths=lengths)
        lengths = lengths + pfx
        grp = adapt_prefill_cache(cfg, pcache, m, self.max_len,
                                  src_len=self.src_len, lengths=lengths)
        idx = torch.tensor(slots, device=dev)
        for c, g in zip(self.cache["layers"], grp["layers"]):
            for key, t in c.items():
                t[idx] = g[key].to(t.dtype)
        self.cache["len"][idx] = lengths
        if self.encdec:
            self.cache["src_len"][idx] = grp["src_len"]
        firsts = self._sample(logits, reqs)
        self.tok[idx, 0] = firsts
        firsts = firsts.cpu().tolist()  # one sync per group
        now = time.perf_counter()
        for slot, req, first in zip(slots, reqs, firsts):
            req.t_admit = t0
            req.t_first = now
            req.out = [first]
            req.pstart = len(self._pending)  # earlier pending rows belong
            self.slots[slot] = req           # to the slot's prior occupant
            self.n_admitted += 1
            self._maybe_retire(slot)
        self.t_prefill += now - t0

    def _maybe_retire(self, slot: int):
        req = self.slots[slot]
        done_eos = req.eos_id is not None and req.out[-1] == req.eos_id
        done_len = len(req.out) >= req.max_new
        if not (done_eos or done_len):
            return
        req.finish = "eos" if done_eos else "length"
        req.t_done = time.perf_counter()
        self.slots[slot] = None
        # pin the freed slot's position and token so its dead-slot
        # decode writes stay inside the slot until the next admission
        self.cache["len"][slot] = 0
        self.tok[slot] = 0
        if self.paged and self.pkv.rows[slot] is not None:
            # release the refcounts AND zero the device block row: the
            # freed pages may be handed out at once, and a stale row would
            # let this dead slot's writes corrupt them
            self.pkv.release_slot(slot)
            self.cache["block"][slot] = 0
        self.results[req.rid] = {
            "rid": req.rid,
            "tokens": np.asarray(req.out, np.int32),
            "prompt_len": len(req.tokens),
            "n_new": len(req.out),
            "finish": req.finish,
            "t_queue_s": req.t_admit - req.t_submit,
            "t_first_token_s": req.t_first - req.t_submit,
            "t_total_s": req.t_done - req.t_submit,
            "kv_pages": req.kv_pages,
        }

    # ---------------------------------------------------- paged admission

    def _paged_admit(self):
        """Spend the step's prefill budget (one call): advance the
        in-flight chunked prefill (decode slots keep stepping between
        chunks), or admit queue heads in FIFO order, several in one
        packed call where they fit, else the head alone into a free slot
        if its pages can be reserved. A shortfall defers the head (FIFO
        kept) until retirements or prefix-cache eviction free pages. A
        packed call, or a group that shrank to one request (its chunks
        start next step), is the step's prefill, as in the reference."""
        budget = 1
        while budget > 0:
            if self._chunking is not None:
                self._chunk_step()
                budget -= 1
                continue
            if not self.queue or None not in self.slots:
                return
            if self.encdec:
                if not self._admit_paged_encdec(self.slots.index(None),
                                                self.queue[0]):
                    return  # deferred: not enough pages
                budget -= 1
                continue
            if self.prefill_pack and self._try_packed_admit():
                budget -= 1
                continue
            req = self.queue[0]
            slot = self.slots.index(None)
            got = self.pkv.admit(slot, req.tokens,
                                 len(req.tokens) + req.max_new + self.spec_k)
            if got is None:
                return  # deferred: not enough pages even after eviction
            self.queue.popleft()
            row, hit = got
            req.t_admit = time.perf_counter()
            req.kv_pages = len(self.pkv.rows[slot])
            self._start_chunking(slot, req, row, hit)

    def _span(self, length: int) -> int:
        """Workspace positions a packed segment of ``length`` takes: its
        base stays aligned to the attention's kv block."""
        kvb = min(self.cfg.attn_kv_block, self.wws)
        return -(-length // kvb) * kvb

    def _try_packed_admit(self) -> bool:
        """Admit several queue heads as ONE packed prefill call.

        A group is consecutive FIFO requests whose tails (prompt past the
        prospective prefix hit of the side-effect-free ``pkv.peek``) sum
        within ``max_chunk`` and whose aligned spans fit the workspace, at
        most one a free slot. Pages are then reserved in FIFO order up to
        the first shortfall, each fit checked again against the actual
        hit (an earlier admission's eviction can shrink a later hit).
        Returns True when it spent the step's prefill (a packed call, or
        a group of one handed to the chunked path); False leaves the
        queue as it was for the unpacked path."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        if len(free) < 2 or len(self.queue) < 2:
            return False
        plan: List[Request] = []
        c_tot = base = 0
        for req in list(self.queue)[:len(free)]:
            if req.prefix_embeds is not None:
                break  # a prefix is never packed (vlm stays unpaged)
            L = len(req.tokens)
            tail = L - self.pkv.peek(req.tokens)
            if (c_tot + tail > self.max_chunk
                    or base + self._span(L) > self.wws):
                break
            plan.append(req)
            c_tot += tail
            base += self._span(L)
        if len(plan) < 2:
            return False
        admitted = []
        c_tot = base = 0
        for req in plan:
            slot = free[len(admitted)]
            L = len(req.tokens)
            got = self.pkv.admit(slot, req.tokens,
                                 L + req.max_new + self.spec_k)
            if got is None:
                break
            row, hit = got
            if (c_tot + L - hit > self.max_chunk
                    or base + self._span(L) > self.wws):
                self.pkv.release_slot(slot)
                break
            self.queue.popleft()
            req.t_admit = time.perf_counter()
            req.kv_pages = len(self.pkv.rows[slot])
            admitted.append((slot, req, row, hit))
            c_tot += L - hit
            base += self._span(L)
        if not admitted:
            return False  # page shortfall at the head: deferred, FIFO kept
        if len(admitted) == 1:
            self._start_chunking(*admitted[0])
            return True
        self._packed_prefill(admitted)
        return True

    def _packed_prefill(self, admitted):
        """One packed prefill call for an admitted group, then each
        member installed: its block row and length on the device, its
        prompt in the prefix cache, its first token from its logits row
        (one host read for the group)."""
        t0 = time.perf_counter()
        S, n = self.capacity, len(admitted)
        blocks = np.zeros((S, self.n_blocks), np.int32)
        meta = np.zeros((3, S), np.int32)  # bases, hists, lens
        base = 0
        for s, (_, req, row, hit) in enumerate(admitted):
            blocks[s] = row
            meta[:, s] = base, hit, len(req.tokens)
            base += self._span(len(req.tokens))
        meta[0, n:] = base  # inactive segments park at the end
        tail = np.concatenate([req.tokens[hit:]
                               for _, req, _, hit in admitted])
        width = paged_kv.next_pow2(max(len(tail), self.buckets[0]))
        toks = np.zeros((1, width), np.int32)
        toks[0, :len(tail)] = tail
        self._to_device(toks, self.chunk_tok[:, :width])
        self._to_device(blocks, self.pack_blocks)
        self._to_device(meta, self.pack_meta)
        t_capture = self._run_graphed(
            f"packed{width}", functools.partial(self._packed_step, width),
            prefill=True)
        self.n_chunk_calls += 1
        self.n_packed_groups += 1
        self.n_packed_reqs += n
        reqs = [req for _, req, _, _ in admitted]
        firsts = self._sample(self.pack_logits[:n], reqs)
        for s, (slot, req, _, _) in enumerate(admitted):
            self.cache["block"][slot].copy_(self.pack_blocks[s])
            self.cache["len"][slot] = len(req.tokens)
            self.tok[slot, 0] = firsts[s]
            self.pkv.insert_prefix(slot, req.tokens)
        firsts = firsts.cpu().tolist()  # one sync per group
        now = time.perf_counter()
        for (slot, req, _, _), first in zip(admitted, firsts):
            req.t_first = now
            req.out = [first]
            req.pstart = len(self._pending)
            self.slots[slot] = req
            self.n_admitted += 1
            self.pkv.lens[slot] = len(req.tokens)
            self._maybe_retire(slot)
        self._prefill_time(t0, t_capture)

    def _start_chunking(self, slot: int, req: Request, row: np.ndarray,
                        hit_tokens: int):
        """Begin a chunked prefill. The device block row stays all-trash
        until the prefill finishes, so the slot's dead decode writes land
        in the trash page meanwhile. The workspace is always hydrated:
        from cached pages on a prefix hit, zeros otherwise."""
        t0 = time.perf_counter()
        self._to_device(row, self.chunk_row)
        self.chunk_hit.fill_(hit_tokens)
        t_capture = self._run_graphed("hydrate", self._hydrate_step,
                                      prefill=True)
        self._chunking = {
            "req": req, "slot": slot,
            "plan": paged_kv.chunk_plan(len(req.tokens), hit_tokens,
                                        self.max_chunk),
            "i": 0,
        }
        self._prefill_time(t0, t_capture)

    def _chunk_step(self):
        st = self._chunking
        t0 = time.perf_counter()
        start, width, n_real = st["plan"][st["i"]]
        if start + width > self.wws:
            raise ValueError(f"chunk [{start}, {start + width}) overruns "
                             f"the workspace of {self.wws} positions")
        req = st["req"]
        toks = np.zeros((1, width), np.int32)
        toks[0, :n_real] = req.tokens[start:start + n_real]
        self._to_device(toks, self.chunk_tok[:, :width])
        self.chunk_start.fill_(start)
        self.chunk_n_real.fill_(n_real)
        t_capture = self._run_graphed(
            f"chunk{width}", functools.partial(self._prefill_chunk, width),
            prefill=True)
        self.n_chunk_calls += 1
        st["i"] += 1
        self._prefill_time(t0, t_capture)
        if st["i"] == len(st["plan"]):
            self._finish_chunking()

    def _finish_chunking(self):
        """Commit the finished prefill: splice workspace KV [hit, L) to
        the pages (never rewriting shared prefix-hit pages), install the
        block row and length, publish the prompt to the prefix cache and
        sample the first token."""
        st, self._chunking = self._chunking, None
        req, slot = st["req"], st["slot"]
        t0 = time.perf_counter()
        L = len(req.tokens)
        self.chunk_length.fill_(L)
        t_capture = self._run_graphed("splice", self._splice_step,
                                      prefill=True)
        self.cache["block"][slot].copy_(self.chunk_row)
        self.cache["len"][slot] = L
        self.pkv.insert_prefix(slot, req.tokens)
        self._install_first_token(slot, req, self.chunk_logits, L)
        self._prefill_time(t0, t_capture)

    def _install_first_token(self, slot: int, req: Request, logits,
                             length: int):
        """The end of a paged admission: the first token sampled from
        ``logits`` (1, 1, V) into ``tok``, the slot armed (retired at
        once if its first token ends it)."""
        first = self._sample(logits, [req])
        self.tok[slot, 0] = first[0]
        req.t_first = time.perf_counter()
        req.out = [int(first[0])]
        req.pstart = len(self._pending)
        self.slots[slot] = req
        self.n_admitted += 1
        self.pkv.lens[slot] = length
        self._maybe_retire(slot)

    def _admit_paged_encdec(self, slot: int, req: Request) -> bool:
        """An encdec admission: reserve the request's pages, run ONE
        prefill of its prompt right-padded to a bucket width (the causal
        decoder keeps padding out of the real positions; its frames at
        face value), splice its self-attention K/V into the pages and its
        cross K/V into the slot's slab row, then set the slot's block
        row, ``len`` and ``src_len``. Eager, as the slot pool's prefill.
        Returns False on a page shortfall (the queue head waits)."""
        got = self.pkv.admit(slot, None,
                             len(req.tokens) + req.max_new + self.spec_k)
        if got is None:
            return False
        self.queue.popleft()
        row, _ = got
        req.t_admit = t0 = time.perf_counter()
        req.kv_pages = len(self.pkv.rows[slot])
        cfg, dev = self.cfg, self.device
        L = len(req.tokens)
        toks = np.zeros((1, paged_kv.next_pow2(max(L, self.buckets[0]))),
                        np.int32)
        toks[0, :L] = req.tokens
        logits, pcache = api.prefill(
            self.model, cfg, {"tokens": torch.from_numpy(toks).to(dev),
                              "frames": req.frames[None].to(dev)},
            lengths=torch.tensor([L], dtype=torch.int32, device=dev))
        row_t = torch.from_numpy(row).to(dev)
        paged_encdec_splice(cfg, self.cache, pcache["layers"], row_t, L,
                            slot)
        self.cache["block"][slot].copy_(row_t)
        self.cache["len"][slot] = L
        self.cache["src_len"][slot] = req.frames.shape[0]
        self._install_first_token(slot, req, logits, L)
        self._prefill_time(t0, 0.0)
        return True

    def _prefill_time(self, t0: float, t_capture: float):
        """Charge the host seconds since ``t0`` to prefill, a capture's
        to warmup."""
        self.t_warmup += t_capture
        self.t_prefill += time.perf_counter() - t0 - t_capture

    def _to_device(self, host: np.ndarray, out: torch.Tensor):
        """Copy ``host`` into the device buffer ``out`` with no sync: on
        CUDA asynchronously from pinned memory, which the host allocator
        keeps until the copy has run."""
        src = torch.from_numpy(host)
        if out.is_cuda:
            out.copy_(src.pin_memory(), non_blocking=True)
        else:
            out.copy_(src)

    # ---------------------------------------------- prefill graph steps

    def _hydrate_step(self):
        """The workspace from the pages of ``chunk_row`` up to
        ``chunk_hit``, zeros beyond."""
        paged_hydrate(self.cfg, self.cache["pool"], self.chunk_row,
                      self.chunk_hit, self.ws)

    def _prefill_chunk(self, width: int):
        """One chunk of ``width`` tokens from ``chunk_tok`` at
        ``chunk_start`` into the workspace; its last real row's logits
        into ``chunk_logits``."""
        logits, _ = paged_chunk(self.model, self.cfg,
                                self.chunk_tok[:, :width], self.ws,
                                self.chunk_start, self.chunk_n_real)
        self.chunk_logits.copy_(logits)

    def _splice_step(self):
        """Workspace positions [``chunk_hit``, ``chunk_length``) to the
        pages of ``chunk_row``, the rest to the trash page."""
        paged_splice(self.cfg, self.cache["pool"], self.ws, self.chunk_row,
                     self.chunk_hit, self.chunk_length)

    def _packed_step(self, width: int):
        """One packed call of ``width`` tokens from ``chunk_tok`` over the
        segments of ``pack_blocks`` and ``pack_meta`` (bases, hists,
        lens) into the pages; a logits row a segment into
        ``pack_logits``."""
        bases, hists, lens = self.pack_meta.unbind(0)
        logits = paged_packed(self.model, self.cfg,
                              self.chunk_tok[:, :width], self.cache["pool"],
                              self.pack_blocks, bases, hists, lens, self.wws)
        self.pack_logits.copy_(logits)

    def _release_window_pages(self):
        """Sliding-window decode never reads KV behind ``len - window``:
        free those pages (shared prefix pages keep their other holders)
        and zero their device block entries."""
        rows, cols = [], []
        for slot, r in enumerate(self.slots):
            if r is None:
                continue
            for j in self.pkv.release_behind_window(slot, self.cfg.window):
                rows.append(slot)
                cols.append(j)
        if rows:
            self.cache["block"][torch.tensor(rows, device=self.device),
                                torch.tensor(cols, device=self.device)] = 0

    # ------------------------------------------------------ static batch

    @torch.inference_mode()
    def preload(self, batch: Dict[str, torch.Tensor], steps: int, *,
                lengths=None, eos_id: Optional[int] = None):
        """Admit a whole padded batch with ONE batched prefill: the
        static-batch path of ``serving.generate``. The engine must be
        idle and ``batch["tokens"]`` must have ``capacity`` rows; row i
        becomes request i, as a solo ``submit`` of it would; with
        ``batch["prefix_embeds"]`` (B, P, D) (a vlm batch) row i's prefix
        too."""
        if self.queue or any(s is not None for s in self.slots):
            raise RuntimeError("preload requires an idle engine")
        if self.paged:
            raise RuntimeError("preload is a slot-pool fast path; submit "
                               "requests individually on a paged engine")
        toks = torch.as_tensor(batch["tokens"]).cpu().numpy().astype(np.int32)
        B, P = toks.shape
        if B != self.capacity:
            raise ValueError(f"batch {B} != capacity {self.capacity}")
        lens = (np.full(B, P) if lengths is None else np.broadcast_to(
            torch.as_tensor(lengths).cpu().numpy().reshape(-1), (B,)))
        t0 = time.perf_counter()
        reqs = [self._new_request(toks[i, :int(lens[i])], steps, eos_id,
                                  None, t0) for i in range(B)]
        if self.encdec:
            frames = torch.as_tensor(batch["frames"])
            if frames.shape[1] > self.src_len:
                raise ValueError(f"frames {frames.shape[1]} exceed engine "
                                 f"src_len {self.src_len}")
            for req, f in zip(reqs, frames):
                req.frames = f
        if batch.get("prefix_embeds") is not None:
            for req, e in zip(reqs, torch.as_tensor(batch["prefix_embeds"])):
                req.prefix_embeds = self._prefix_embeds(e)
        self._admit_group(list(range(B)), reqs)

    # ------------------------------------------------------- decode step

    def _decode_step(self):
        """The decode step over the engine's own buffers: reads ``tok``,
        ``cache["len"]`` (and ``cache["block"]``) and the pools or rings;
        writes the new K/V entries, ``len + 1``, the logits (into
        ``self.logits``) and, greedy, their argmax (into ``tok``), all in
        place, so that a CUDA graph of it replays on the same addresses."""
        step = api.paged_decode_step if self.paged else api.decode_step
        logits, cache = step(self.model, self.cfg, self.tok, self.cache)
        self.cache["len"].copy_(cache["len"])
        self.logits.copy_(logits)
        if self.greedy:
            self.tok.copy_(torch.argmax(self.logits[:, -1], dim=-1)[:, None])

    def _graphs_on(self) -> bool:
        """Decode steps replay a graph: on CUDA, outside
        :func:`disable_graphs` and outside a calibration block (whose
        maxima a replay would not record)."""
        return (self.device.type == "cuda" and not _GRAPHS_OFF
                and not actquant.capturing())

    def _capture(self, fn, pool=None):
        """Run ``fn`` (a step over the engine's buffers) eagerly on a side
        stream (it builds the kernels' libraries and makes every lazily
        made buffer outside the graph's pool), then capture it, into
        ``pool`` if given. The eager run is a real step; the capture runs
        nothing, and the launches it counted are taken back and added on
        every replay. Returns (graph, the launches a replay stands for,
        the capture's seconds)."""
        with torch.cuda.device(self.device):
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                fn()
            main.wait_stream(side)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            before = ops.read_counts()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool):
                fn()
            counts = ops.count_delta(before)
            ops.set_counts(before)
        return graph, counts, time.perf_counter() - t0

    def _run_graphed(self, key: str, fn, eager: bool = False,
                     prefill: bool = False) -> float:
        """``fn``, a step over the engine's buffers: called (off CUDA,
        under :func:`disable_graphs`, or ``eager``), captured as
        ``self._graphs[key]`` at its first call, replayed after. The
        ``prefill`` graphs share one memory pool: each writes its output
        into engine buffers made outside any graph, and they replay one
        at a time on one stream, so none reads another's memory. Returns
        the seconds spent capturing (0 but on a capturing step). Raises
        where it would capture or replay while a multiply audit records
        (``kernels/audit.py``): the audit sees none of a graph's ops."""
        if eager or not self._graphs_on():
            fn()
            return 0.0
        if audit.RECORDER is not None:
            raise RuntimeError(
                f"Engine: the {key!r} step would capture or replay a CUDA "
                f"graph inside a multiply audit, which sees none of its "
                f"ops; audit it under disable_graphs()")
        if key not in self._graphs:
            pool = None
            if prefill:
                if self._prefill_pool is None:
                    self._prefill_pool = torch.cuda.graph_pool_handle()
                pool = self._prefill_pool
            graph, counts, t = self._capture(fn, pool)
            self._graphs[key] = (graph, counts)
            return t
        graph, counts = self._graphs[key]
        graph.replay()
        ops.add_counts(counts)
        return 0.0

    def _run_decode_step(self) -> float:
        return self._run_graphed("decode", self._decode_step)

    def _spec_step(self):
        """One speculative round over the engine's own buffers: reads
        ``tok``, the cache and its ``len``; writes the K/V, the round's
        tokens and accepted counts (``spec_out``, ``spec_acc``), ``len =
        n0 + n_acc`` and the new pending tokens into ``tok``, in place,
        so that a CUDA graph of a greedy round replays on the same
        addresses."""
        gens = (None if self.greedy
                else [r.gen if r is not None else None for r in self.slots])
        out, n_acc, new_len = spec.spec_round(
            self.model, self.draft, self.cfg, self.spec_k, self.tok,
            self.cache, paged=self.paged, gens=gens,
            temperature=self.temperature)
        self.spec_out.copy_(out)
        self.spec_acc.copy_(n_acc)
        self.cache["len"].copy_(new_len)
        self.tok.copy_(torch.take_along_dim(out, (n_acc.long() - 1)[:, None],
                                            dim=1))

    def _run_spec_step(self) -> float:
        """One round, run as the decode step is; a temperature round (its
        draws from the requests' generators) always eagerly."""
        return self._run_graphed("spec", self._spec_step,
                                 eager=not self.greedy)

    def _warm(self):
        """The paged engine's warmup, as the reference's ``_warm_paged``:
        a hydrate, one chunk of every bucket width and a splice over an
        all-trash row at ``start = length = hit = 0`` (the splice sends
        every workspace position to the trash page; the chunks' workspace
        entries are zeroed by the next hydrate), with ``prefill_pack`` a
        packed call of every width over an all-inactive group (every row
        masked, zeros to the trash page), one decode step, and on
        a speculative engine one round, over the dead slots (``len`` 0
        and all-trash block rows, so their K/V writes land on the trash
        page only), each captured on CUDA; then ``len``, ``tok``, the
        logits and the round's outputs are zeroed again and the launches
        are not counted. An encdec engine's admission runs eagerly: its
        warmup runs it once a bucket width, a prefill of zero frames of
        ``src_len`` and a splice at length 0 onto an all-trash row (the
        pages get zeros on the trash page; slot 0's slab row is
        rewritten by its first admission), then the decode step."""
        t0 = time.perf_counter()
        before = ops.read_counts()
        with torch.inference_mode():
            if self.encdec:
                self._warm_encdec_admission()
            else:
                self._warm_prefill_graphs()
            for run in ((self._run_decode_step, self._run_spec_step)
                        if self.spec_k else (self._run_decode_step,)):
                run()
                self.cache["len"].zero_()
                self.tok.zero_()
            self.logits.zero_()
            self.spec_out.zero_()
            self.spec_acc.zero_()
        ops.set_counts(before)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t_warmup = time.perf_counter() - t0

    def _warm_prefill_graphs(self):
        """The chunked and packed prefill's graphs, captured over an
        all-trash row (see :meth:`_warm`)."""
        self._run_graphed("hydrate", self._hydrate_step, prefill=True)
        for width in self.buckets:
            self.chunk_n_real.fill_(width)
            self._run_graphed(f"chunk{width}",
                              functools.partial(self._prefill_chunk, width),
                              prefill=True)
        self._run_graphed("splice", self._splice_step, prefill=True)
        for width in self.buckets if self.prefill_pack else ():
            self._run_graphed(f"packed{width}",
                              functools.partial(self._packed_step, width),
                              prefill=True)
        self.chunk_n_real.zero_()
        self.chunk_logits.zero_()
        self.pack_logits.zero_()

    def _warm_encdec_admission(self):
        """An encdec engine's admission once a bucket width: zero frames
        of ``src_len``, a one-token prompt, a splice at length 0 onto an
        all-trash row (see :meth:`_warm`)."""
        if not self.src_len:
            return
        cfg, dev = self.cfg, self.device
        frames = torch.zeros((1, self.src_len, cfg.d_model), dtype=cfg.dtype,
                             device=dev)
        row = torch.zeros((self.n_blocks,), dtype=torch.int32, device=dev)
        one = torch.ones((1,), dtype=torch.int32, device=dev)
        for width in self.buckets:
            toks = torch.zeros((1, width), dtype=torch.int32, device=dev)
            _, pc = api.prefill(self.model, cfg,
                                {"tokens": toks, "frames": frames},
                                lengths=one)
            paged_encdec_splice(cfg, self.cache, pc["layers"], row, 0, 0)

    def paged_trace_counts(self) -> Dict[str, int]:
        """Counterpart of the reference's jit-cache counts: the graphs
        this engine captured, the decode step's (and, speculative, the
        round's) and, paged, ``chunk`` (one a chunk width), ``hydrate``,
        ``splice`` and, packing, ``packed`` (one a width). A warmed paged
        engine on CUDA holds 1 of each and ``len(buckets)`` chunk and
        packed widths from construction on, and a serve must not change
        them; on the CPU nothing is captured (0). The
        sampler and an encdec engine's admission run eagerly and have
        nothing to count."""
        keys = ("decode", "spec") if self.spec_k else ("decode",)
        out = {k: int(k in self._graphs) for k in keys}
        if self.paged and not self.encdec:
            out["chunk"] = sum(k.startswith("chunk") for k in self._graphs)
            out["hydrate"] = int("hydrate" in self._graphs)
            out["splice"] = int("splice" in self._graphs)
            if self.prefill_pack:
                out["packed"] = sum(k.startswith("packed")
                                    for k in self._graphs)
        return out

    # -------------------------------------------------------------- loop

    def _materialize(self):
        """Pull all pending decode tokens to the host in one sync and
        run the retirement checks they unlock."""
        if not self._pending:
            return
        vals = torch.stack(self._pending).cpu().numpy()  # (k, capacity)
        k = len(self._pending)
        self._pending = []
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            req.out.extend(int(v) for v in vals[req.pstart:k, slot])
            req.pstart = 0
        for slot in range(self.capacity):
            if self.slots[slot] is not None:
                self._maybe_retire(slot)

    @torch.inference_mode()
    def step(self) -> List[Dict[str, Any]]:
        """One engine iteration: admit into free slots, then advance all
        slots one decode step. Returns the requests retired this step.

        Sampled tokens stay on the device as pending handles and are
        pulled to the host in one sync only when a retirement decision
        needs them: every step while a live request carries an
        ``eos_id``, otherwise on the step where some request reaches
        ``max_new`` (host-predictable)."""
        if self._t_start is None:
            self._t_start = time.perf_counter()
        before = set(self.results)
        if self.paged:
            self._paged_admit()
        elif self.queue and None in self.slots:
            free = [i for i, s in enumerate(self.slots) if s is None]
            take = [self.queue.popleft()
                    for _ in range(min(len(free), len(self.queue)))]
            groups: Dict[Any, List[Request]] = {}
            for req in take:
                groups.setdefault(self._group_key(req), []).append(req)
            for reqs in groups.values():
                slots, free = free[:len(reqs)], free[len(reqs):]
                self._admit_group(slots, reqs)
        active = [r for r in self.slots if r is not None]
        if active and self.spec_k:
            t0 = time.perf_counter()
            t_capture = self._spec_round()
            self.t_warmup += t_capture
            self.t_decode += time.perf_counter() - t0 - t_capture
            self.n_decode_steps += 1
        elif active:
            t0 = time.perf_counter()
            t_capture = self._run_decode_step()
            if not self.greedy:
                self.tok.copy_(self._sample(self.logits, self.slots)[:, None])
            # a copy: the next step overwrites tok in place
            self._pending.append(self.tok[:, 0].clone())
            if self.paged:
                for i, r in enumerate(self.slots):
                    if r is not None:
                        self.pkv.lens[i] += 1
                if self.cfg.window is not None:
                    self._release_window_pages()
            n_pend = len(self._pending)
            if (any(r.eos_id is not None for r in active)
                    or any(len(r.out) + n_pend - r.pstart >= r.max_new
                           for r in active)):
                self._materialize()
            self.t_warmup += t_capture
            self.t_decode += time.perf_counter() - t0 - t_capture
            self.n_decode_steps += 1
        return [self.results[r] for r in sorted(set(self.results) - before)]

    def _spec_round(self) -> float:
        """One speculative round over all slots, then ONE host read of
        the accepted blocks (a round replaces the pending-token scheme:
        the host must see ``n_acc`` to know how far each slot got).

        An EOS or ``max_new`` inside an accepted block truncates the block
        there and retires the request in the same step; the tokens after
        it are dropped, as sequential decode would never have made them.
        ``len`` still advances by the whole block, which is harmless:
        retirement pins the freed slot's length to 0. Returns the seconds
        spent capturing."""
        t_capture = self._run_spec_step()
        host = torch.cat([self.spec_out, self.spec_acc[:, None]],
                         dim=1).cpu().numpy()
        self.n_spec_rounds += 1
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            A = int(host[slot, -1])
            self._spec_live += 1
            self._spec_acc_tok += A
            self._spec_acc_draft += A - 1
            for t in host[slot, :A]:
                req.out.append(int(t))
                if ((req.eos_id is not None and int(t) == req.eos_id)
                        or len(req.out) >= req.max_new):
                    break
            if self.paged:
                self.pkv.lens[slot] += A
            self._maybe_retire(slot)
        if self.paged and self.cfg.window is not None:
            self._release_window_pages()
        return t_capture

    @property
    def prefilling(self) -> bool:
        """A chunked prefill is in flight (its slot is not live yet)."""
        return self._chunking is not None

    @property
    def idle(self) -> bool:
        return (not self.queue and not self.prefilling
                and all(s is None for s in self.slots))

    def run(self, stream: bool = False):
        """Drive the engine until every request retires.

        ``stream=True`` yields per-request result dicts as they finish;
        otherwise returns the full list ordered by rid."""

        def _gen():
            while not self.idle:
                yield from self.step()

        if stream:
            return _gen()
        for _ in _gen():
            pass
        return [self.results[rid] for rid in sorted(self.results)]

    # ------------------------------------------------------------- stats

    def stats(self) -> Dict[str, Any]:
        done = list(self.results.values())
        new_toks = sum(r["n_new"] for r in done)
        # first tokens come from prefill; decode produced the rest
        decoded = sum(max(r["n_new"] - 1, 0) for r in done)
        lat = sorted(r["t_total_s"] for r in done) or [0.0]
        ttft = sorted(r["t_first_token_s"] for r in done) or [0.0]
        wall = ((time.perf_counter() - self._t_start)
                if self._t_start is not None else 0.0)
        out = {
            "capacity": self.capacity,
            "max_len": self.max_len,
            "backend": self.cfg.kernel_backend,
            "mesh": None,
            "admitted": self.n_admitted,
            "completed": len(done),
            "decode_steps": self.n_decode_steps,
            "new_tokens": new_toks,
            "t_prefill_s": self.t_prefill,
            "t_decode_s": self.t_decode,
            "t_warmup_s": self.t_warmup,
            "wall_s": wall,
            "decode_tok_s": decoded / max(self.t_decode, 1e-9),
            "goodput_tok_s": new_toks / max(wall, 1e-9),
            "tokens_per_engine_step": decoded / max(self.n_decode_steps, 1),
            "p50_latency_s": float(np.percentile(lat, 50)),
            "p95_latency_s": float(np.percentile(lat, 95)),
            "ttft_p50_s": float(np.percentile(ttft, 50)),
            "ttft_p99_s": float(np.percentile(ttft, 99)),
            "paged": self.paged,
        }
        if self.encdec:
            out["src_len"] = self.src_len
        if self.paged:
            out.update(self.pkv.stats())
            out["kv_bytes_per_token"] = paged_kv.kv_bytes_per_token(self.cfg)
            out["prefill_chunk_calls"] = self.n_chunk_calls
            out["packed_groups"] = self.n_packed_groups
            out["packed_requests"] = self.n_packed_reqs
        if self.spec_k:
            live = max(self._spec_live, 1)
            out["speculative_k"] = self.spec_k
            out["draft_bits"] = self.draft_bits
            out["spec_rounds"] = self.n_spec_rounds
            # the share of drafted tokens the verify window accepted
            out["acceptance_rate"] = self._spec_acc_draft / (self.spec_k
                                                             * live)
            out["spec_tokens_per_round"] = self._spec_acc_tok / live
            if self.draft_report is not None:
                rep = self.draft_report.values()
                out["draft_extra_bytes"] = sum(v["draft_bytes"] for v in rep)
                out["draft_shared_leaves"] = sum(v["shared"] for v in rep)
                out["draft_coarse_leaves"] = sum(not v["shared"]
                                                 for v in rep)
        return out
