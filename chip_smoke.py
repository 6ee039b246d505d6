#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --ab-timings DIR   # phase 4's GEMM (at
        # M = 4, 8, 32, 64 and 512), lutq_shift, flash-attention and
        # kmeans_stats timings of the package at DIR/src (say the parent
        # commit, from git archive) and of this one, in turns DIR, this,
        # this, DIR, all timed by this script

Phases, each fatal on failure (nothing here catches a phase's error):

1. setup: the card's name, count and power limit; build the CUDA
   kernels from src/repro_torch/kernels/csrc and print the build time.
2. kernels against their plain versions on the card, at h2o-danube-1.8b
   shapes. The GEMMs: danube's five products at M = 1, 4, 8, 9, 16, 17,
   64, 65, 128, 129, 130, 256 and 512 (decode, the engine's 8 slots and
   256-token chunks, generate's 512-token prefill and every tile edge),
   bf16 and f32 x, plus ragged N, a ragged Kin, assignments at an odd
   byte offset, K = 2 and (fused) K = 17 and K = 256 with indices >=
   128; error is max|kernel - plain| over max|plain|: at most 1e-4 for
   f32 x (f32 accumulation in another order) and 1e-3 for bf16 x
   (tensor-core bf16 products accumulated in f32). At split decode and
   prefill shapes a second call, and one call captured in a CUDA graph
   and replayed twice, must give the first call's bits, with the merge
   tickets back at 0. kmeans_stats: every leaf shape of the model with a 4-bit pow2
   dictionary (K=16) and with K=256, a ragged N, a dictionary whose
   midpoints are weights, N = 1, 3, 5 (below one float4) with K = 1, 2
   and 17, and w at element offsets 1-3 into a buffer (a misaligned
   head); assignments equal byte for byte, counts exactly equal, each
   entry's sum within 1e-5 of sum|w| over the entry (f32 in another
   order). A second call and two replays of a call captured in a CUDA
   graph give the first call's bits, one launch a call, the merge ticket
   back at 0, and write_a=False the same sums and counts; the profiler's
   kernel list holds the kernel once a call and no memset.
3. serve: full-width h2o-danube-1.8b (24 layers, random weights from a
   seed), 4-bit LUT-Q (QuantSpec(bits=4, min_size=1024)), 8-bit
   activations, batch 4, prompt 128, 16 generated tokens, through
   (a) the packed 4-bit serve view (packed4 kernel) and (b) the int8
   serve view with kernel_backend="fused". Each generate runs twice:
   its engine replaying the decode step it captured at the first step,
   and stepping eagerly inside disable_graphs(); both must give the same
   tokens and counts. Kernel counts are zeroed just before each generate
   and read just after: each forward must launch its kernel 7 * 24 + 1
   times and run no plain version. Each mode logs prefill ms, decode
   tok/s, the capture's ms, peak memory and a profiled generate. Then
   the reduced config served on the card must give the tokens it gives
   on the CPU through the plain versions.
2c. paged attention: both variants of the CUDA kernel (each split's
   scores in shared memory; in a global workspace, forced with
   smem_budget_bytes=0) against the plain version (gather, dequantize,
   attend) at full-width decode shapes (B=8, Hkv=8, G=4, dh=80, page
   64, NB=69, lengths 1..4416; B=16 with lengths on the split edges of
   this card's split plans, rows shorter than one split, one-position
   rows and window rows whose first valid position is on no page or
   split edge; a batch of empty rows) and reduced ones (dh=16, G=2,
   page 8/16, an empty row), bf16/f32 queries, bf16/f32/int8 pages,
   window none, 24 or 4096; head dim 128 at page 64 with bf16 queries
   over bf16 and int8 pages, window none and 4096, full-width lengths
   and (B=16) the split edges, at G = 4 (mistral-nemo-12b), 8
   (qwen1.5-110b), 12 (mistral-large-123b) and 16 (the kernel's limit),
   and a G = 12 batch of 64 one-split rows whose scores the plan itself
   moves to the workspace. Error of each (sequence, query head) row
   over that row's own max|plain|: at most one bf16 ulp of the row
   (2^-7) for bf16 queries (bf16 output, bf16 scores that may round the
   other way where the f32 sums differ in their last bits), 1e-5 for
   f32 queries; an empty row exactly 0. A second call must give the
   same bits; every dead or behind-window block entry is then pointed
   at a page of NaN: the output must keep its bits. One call of each
   variant captured in a CUDA graph and replayed twice must equal the
   eager call, with the merge tickets back at 0, at (G, dh) = (4, 80)
   and (12, 128).
2d. lutq_shift (the shift-add kernel of the multiplier-less pow2 path)
   against its plain version on the card, bit for bit (torch.equal, no
   tolerance: int32 sums): danube's seven body shapes at M = 1, 2, 4, 8,
   130, 512 (a two-digit-plane dictionary) and at M = 4, 8, 9, 16, 17,
   64, 256, 512 (one plane, as danube's leaves: every tile edge, the
   engine's 8-slot step and 256-row chunk), a ragged shape (Kin 2000, N
   700, M 3 and 130), K = 2, 16, 256 (indices >= 128 stored as negative
   int8) at decode and prefill M, zero entries, both signs, and operands
   at the overflow guard's limit (7 + span + ceil(log2 Kin) = 31, every
   term at its largest): two planes at danube's Kin, three and four at
   small Kin. A second call and two replays of a call captured in a CUDA
   graph give the first call's bits at split and unsplit shapes, one
   launch a call, the merge tickets back at 0; the profiler's kernel list
   over calls at split decode and prefill shapes holds the kernel once a
   call and no memset.
2e. flash attention (the counterpart of the TPU kernel
   flash_attention_tpu) against its plain version on the card: the
   shapes of tests/test_flash_kernel.py (S, D, bq, bk in (256, 64, 128,
   128), (512, 128, 128, 128), (256, 64, 64, 128), (384, 32, 128, 128),
   BH=3), causal and full, f32 and bf16; q blocks of 32 and 48 rows
   (bf16, the calls flash_attn.plan leaves on the mma.sync kernel);
   danube's prefill geometry in the GQA layout (B=4, S=512, 32 query
   heads over 8 KV heads repeated per group, D=80: BH=128) and one
   4096-token row (BH=32, D=80), bf16, causal. Each line names the
   kernel that ran (flash_wgmma, flash_bf16 or flash_f32). Error of each
   query row over that row's max|plain|: at most 1e-5 for f32 (f32 sums
   in another order), 2^-7 for bf16 (one bf16 ulp of the row). K/V rows
   [b, S) of the danube geometry set to NaN with bq = b = S/2 and b = 64
   (one warpgroup), bk = min(b, 128): rows [0, b) must keep their bits
   (skipped blocks are never read). A second call and two replays of a
   call captured in a CUDA graph keep the first call's bits. The same
   geometry against the port's own prefill attention
   (nn.attention.flash_attention, window 4096): 1e-5 in f32; 2^-5 in
   bf16, where that path rounds q * scale and its scores to bf16 (the
   errors of both against f64 attention are printed). Every call
   launches the kernel that flash_attn.plan names; no plain version
   runs.
2f. the card divides where the reference divides: fake_quant (8 and 16
   bits) on (4, 128, 2560) activations and _kv_quant on (4, 128, 8, 80)
   K/V, f32 and bf16, with maxima where amax * f32(1/127) != amax / 127,
   equal the CPU's bit for bit (int8 bytes and bf16 scales included).
   AdamW: the elements of 2^24 float32 values where torch.sqrt,
   _foreach_sqrt_ and the bias-correction divide on the card differ
   from the CPU are counted; one whole AdamW step (weight decay 0.1) of
   danube's leaf shapes (2560, 6912), (2560, 640) and (2560,) from a
   seeded state must equal the CPU's bit for bit (parameters and both
   moments).
2g. verify-window rows: danube's four layer product shapes and the head,
   through both GEMM kernels, bf16 x: every block of B rows of a
   B (k + 1)-row product (a speculative verify window) must equal the
   product of those B rows alone (the decode step's), bit for bit
   (torch.equal), for B = 1, 4, 8 and k = 1..4; the first product and M
   whose rows differ are named. Windows wider than 64 rows, (B, k) =
   (13, 4), (16, 4), (72, 1), run their products over whole positions
   at a time, as the window does, under the same check. Logged beside
   it: how many of those row blocks an RMSNorm over the whole window
   changes (the reason the window norms per position).
2m. the expert-stacked kernels (the MoE family's: kernels 1, 2 and 4
   with a grid dimension selecting the expert, one launch a stacked
   product) against their plain versions (a loop over the experts) at
   qwen3-moe-235b-a22b's expert shapes, wi/wg (C, 4096) @ (4096, 1536)
   and wo (C, 1536) @ (1536, 4096), E = 128 with C = 1, 2, 10, 40
   (decode, two tokens an expert, one 128-token prompt, 4 x 128 tokens)
   and a 4-expert stack at C = 1 and 40 whose products split their
   reduction; bf16 and f32 x (lutq_shift: int8, bit for bit), distinct
   per-expert dictionaries (lutq_shift: spans 0..9 from expert to
   expert), expert 3 an all-zero slab (its output exactly 0). Phase 2's
   tolerances; one launch and no plain call a product; each of experts
   0, 3 and E - 1 against a one-expert launch of the plain product's
   kernel on its operands, bit for bit where the two plans split alike;
   at C = 1 and 40 a second call and two replays of a captured call give
   the first call's bits, the merge tickets back at 0.
2o. deepseek-v2-lite-16b's shapes: kernels 1, 2 and 4 at its leaves, q
   (2048, 3072), dkv (2048, 576: N not a multiple of 128, a partial n
   tile and, packed, its byte pairs), uk / uv (512, 2048), o, the dense
   MLP (2048 <-> 1408) and the shared experts (2048 <-> 2816), M = 1, 4,
   128, 384, 512, against their plain versions (phase 2's tolerances;
   lutq_shift bit for bit and a second call's bits); second-call and
   graph bits at N = 576 and Kin = 512; then phase 2m's checks of the
   three expert stacks at E = 64, wi/wg (2048, 1408) and wo (1408,
   2048) (Kin 1408 = 11 x 128: an odd chunk count), C = 1, 40, 60.
2h. prefill rows: danube's five product shapes through both GEMM
   kernels, bf16 x: the first m rows of an M-row product equal the
   m-row product bit for bit for every m < M in 16, 32, 64, 128, 256
   (the paged engine's chunk widths and a packed call's widths), each
   pair printed; then one forward's 169 products at M = 128 and 256 on
   this plan (the 64 x 128 mma.sync tile at the decode split up to 256
   rows), on the 128 x 256 wgmma tile at the same split, and on the
   plan before packed prefill (the wgmma tile above 64 rows with its own
   split), whose rows are printed too; in turns, CUDA-graph timed.
3c. paged engine: full-width h2o-danube-1.8b (the phase-3 serve views)
   through Engine(kv_pages=...), page 64, 8-bit activations: (a) 24
   synthetic requests (prompts 128-512, 8-64 new tokens) on 8 slots,
   160 pages, int8 KV, packed4; (b) 16 requests sharing a 256-token
   system prompt (tails 1-64, 4-32 new) on 8 slots, bf16 KV, fused,
   prefix hits asserted; (c) one 4352-token prompt and 64 new tokens on
   1 slot, int8 KV, 80 pages: 17 prefill chunks of 256, the row past
   the 4096 window (at least 4 blocks released, their device entries
   0). Counts are zeroed just before each run and read just after: the
   paged kernel launches 24 x decode steps, all in the variant
   smem_plan picks (the shared-memory one: a split of danube's rows
   holds at most a few hundred positions' scores), the
   GEMM kernel 169 x (decode steps + prefill chunks), no plain version;
   every request ends at max_new; the allocator's invariants hold with
   only prefix-cache pages held. Each run serves its queue twice: an
   engine that captured at construction its decode step, one prefill
   chunk graph a width of prefill_buckets(max_chunk) (16-256), the
   hydrate and the splice replays them (trace counts decode, hydrate,
   splice 1 and chunk 5 after the warmup and after the serve), then an
   engine made and stepped inside disable_graphs() runs the same
   functions eagerly (all counts 0); the tokens and counts of the two
   must be equal. Prints, for both, prefill seconds and ms a chunk on
   the engine's clock, one 256-wide chunk timed between synchronizes
   on the idle engine, decode tok/s, goodput, TTFT p50/p99, latency
   p50/p95, wall, the warmup's seconds, pages peak, prefix hit rate,
   peak memory (allocated and reserved), the card's idle share over one
   profiled decode step and the wall of the next decode step without
   the profiler, then both side by side.
3d. the reduced config through the paged engine (int8 and f32 pages;
   int8 pages packing its prefills, which must pack as often on both)
   and the slot engine: the same tokens on the card and on the CPU.
3i. packed prefill: the phase-3 serve views at act_bits=32, page 64, 8
   slots, 160 pages, max_len 512 + 64 (a 2048-position workspace: at
   most 4 segments a packed call), max_chunk 256, over 32 requests at
   t=0 (prompts 16-96, 2-16 new tokens, seed 2): P1 packed4, bf16 KV,
   prefix cache on, every second prompt behind one 128-token system
   prompt; P2 fused, int8 KV, prefix cache off. Each served packed with
   graphs, packed inside disable_graphs() and unpacked
   (prefill_pack=False) with graphs, each pass under phase 3c's checks
   (its graphs, one packed graph a width where it packs, after the
   warmup and unchanged by the serve; GEMM launches 169 x (decode steps
   + prefill calls), a packed call's head one product over its
   segments; paged attention 24 x decode steps; no plain version). The
   three must give the same tokens request by request, the packed
   passes the same counts, and packing at least one group and fewer
   prefill calls than unpacked; prefill calls, prefill seconds, TTFT
   p50/p99, goodput, warmup and peak memory are logged side by side.
   Its launches go into the kernels' record as "packed_launches".
3m. the MoE family: qwen3-moe-235b-a22b at full width (d_model 4096,
   64 query heads of 128 over 4 KV heads, qk-norm, 128 experts top-8 of
   d_ff 1536, vocab 151936, RoPE 1e6, its own 4-bit pow2 LUT-Q and 8-bit
   activations), 2 of its 94 layers (each layer's experts are 2.416 G
   weights), random weights from seed 0. (b) init + quantize (one
   dictionary an expert), then generate (B=4, prompt 128, 16 tokens)
   through the int8 view (kernel 1 and its expert stack) and the packed4
   view (kernel 2 and its stack), each replaying its decode step and
   eagerly: the same tokens and counts, 4 x 2 + 1 dense and 3 x 2
   stacked launches a forward, no plain version; prefill ms, decode
   tok/s, capture ms, peak memory and a profiled generate's heaviest
   kernels are logged. Then serving_pow2 through api.serve_state
   (calibrated on 2 x 64 tokens; every expert leaf pow2-encoded with
   frozen (128, 2) pairs): the same generate on lutq_shift (4 x 2) and
   its stack (3 x 2), and the multiply audit of its prefill (B=4 x 96)
   and one decode step: 14 int dots a forward, all lutq_shift and
   lutq_shift_experts notes, 2 router fp dots. (c) the slot-pool engine
   over 4 prompts of 64-128 tokens, 8 new each: one slot, each request
   equal to its lone generate; four slots with kv_pages (a MoE config
   keeps the slot path, stats()["paged"] False); graph equal to eager.
   (d) reduced qwen3-moe on the card gives the CPU's tokens through the
   int8, packed4 and calibrated serving_pow2 views.
3n. the remaining dense families at full width, 2 layers each, random
   weights from seed 0, one family on the card at a time:
   mistral-large-123b (d_model 12288, 96 query heads of 128 over 8 KV
   heads: a group of 12, d_ff 28672, vocab 32768) and qwen1.5-110b
   (d_model 8192, 64 / 8 heads of 128, d_ff 49152, vocab 152064, a bias
   on q, k and v, set to seeded values), each under its own 4-bit pow2
   LUT-Q (embedding and head included) and 8-bit activations. (a) init +
   quantize; (b) generate (B=4, prompt 128, 16 tokens) through the int8
   view (kernel 1) and the packed4 view (kernel 2), each replaying its
   decode step and eagerly: the same tokens and counts, 7 x 2 + 1
   launches a forward, no plain version, prefill ms, decode tok/s,
   capture ms, peak memory and a profiled generate logged; (c) at
   act_bits 32 the paged engine (page 64, 4 slots, packed prefill;
   mistral-large int8 pages, qwen1.5 bf16) over 5 prompts of 64-128
   tokens, 8 new each, and its speculative twin (k=3, draft_bits 3):
   each request's tokens equal its lone generate, the paged kernel
   n_layers launches a step (x 7 a round) in the variant its plan picks,
   no plain version; (d) serving_pow2, calibrated on 2 x 64 tokens: the
   overflow guard's 7 + span + ceil(log2 Kin) and decision for every
   logical leaf (a leaf kept on its float dictionary runs kernel 1 and
   the audit must refuse it), generate through lutq_shift as in (b),
   and the multiply audit of its prefill (B=4 x 128) and one decode
   step: one integer dot a pow2 leaf, all lutq_shift launches; (e) the
   reduced config (mistral-large at 12 query heads over 1 KV head;
   qwen1.5 with seeded biases) on the card gives the CPU's tokens
   through the int8, packed4 and serving_pow2 views. Then
   mistral-nemo-12b's paged engine (2 full-width layers, G = 4, head
   dim 128, int8 pages) over the same kind of queue, as in (c). Its
   launches go into the kernels' record as "dense_family_launches".
3o. deepseek-v2-lite-16b at full width (d_model 2048, 16 heads, MLA
   with kv_lora 512, q/k heads of 128 + 64 rope, v heads of 128; 64
   experts top-6 of d_ff 1408 plus 2 shared (2816), vocab 102400, its own
   4-bit pow2 LUT-Q, 8-bit activations), 3 of its 27 layers: the dense
   prefix layer and 2 MoE layers, random weights from seed 0. (b) int8
   and packed4 generate (B=4, prompt 128, 16 tokens), graph and eager:
   equal tokens and counts, no plain version; a prefill runs 8 dense
   products a layer (MLA's q, dkv, uk, uv, o and the MLP or the shared
   experts) plus the head, a decode step 6 (the absorbed form decodes uk
   and uv in the step) plus the head, and 3 stacked launches a MoE
   layer; the materialize of uk / uv beside a replayed decode step. The
   calibrated serving_pow2 view the same on lutq_shift (no head) and
   its stack; (c) the audit of its 96-token prefill and one decode step:
   the integer dots as in (b), the routers' 2 float products, and the
   absorbed decode's 2 float latent products a layer (on decoded uk /
   uv, reported apart: not multiplier-less); (d) the slot engine over 5
   prompts (two lengths twice: groups of equal length), as phase 3m (c);
   (e) reduced deepseek (floor 0: every MLA leaf quantized) on the card
   gives the CPU's tokens in the three views. Its launches go into the
   kernels' record as "deepseek_launches".
2p. seamless-m4t-medium's shapes: kernels 1, 2 and 4 at its body leaves
   (Kin x N 1024 x 1024, 1024 x 4096, 4096 x 1024) and M = 1..512
   (every tile edge) against their plain versions (phase 2's tolerances,
   lutq_shift bit for bit); kernel 1 and lutq_shift on the transposed
   tied head (Kin 1024, N 256206: a partial n tile) at M = 1, 4 and 9;
   second-call and graph bits; kernels 6 and 7 at G = 1, dh 64, 16 KV
   heads, bf16 q over bf16 pages: full-width lengths, the split edges of
   the engine's plan (4 rows, 3 blocks) and of a 16-row plan, empty rows,
   the NaN pages and a graph replay at phase 2c's per-row tolerance.
3p. seamless-m4t-medium at full width, 4 of its 12 encoder and 4 of
   its 12 decoder layers (SM_LAYERS): d_model 1024, 16 / 16 heads of
   64, d_ff 4096, vocab 256206 with a tied readout, its 4-bit pow2
   LUT-Q, 8-bit activations, random weights from seed 0 and 128 seeded
   frames a row. (b) int8 and packed4 generate (B=4, prompt 128, 16
   tokens), graph and eager: equal tokens and counts, no plain version;
   a prefill runs 7 products an encoder layer and 11 a decoder layer
   (73 with the head in int8; 217 at full depth), a decode step 9 a
   decoder layer (37; 109); the packed4 view's tied head is
   one decode-backend call a forward (the packed table used transposed,
   as in the reference); the head's share of a replayed decode step and
   the graph pools' MiB; the random model's greedy tokens repeat, so
   the logits are held too: a decode step replayed from a graph is the
   eager step's bits and lies within SM_LOGIT_TOL of a prefill one token
   longer (half the source masked moves it by SM_LOGIT_APART or more),
   and a W = 4 window equals 4 chained steps. The calibrated
   serving_pow2 view the same on lutq_shift (72 / 36, the head float);
   (c) its audit (a 20-token
   prefill over 20 frames and one decode step: 72 and 36 integer
   dots); (d) at act_bits 32, synthetic_requests(seed=0) (12 requests,
   prompts up to 128, 64-128 frames of a 128-frame src_len, up to 32 new
   tokens) through the paged engine (4 slots, page 64, bf16 pages), its
   speculative twin (k = 3) and a 4-slot slot engine: each request's
   tokens equal its lone generate, each request's first decode step's
   logits in the paged and slot engines lie within SM_LOGIT_TOL of its
   lone first step's and SM_LOGIT_APART or more from the next
   request's, a W = 4 paged window equals 4 chained paged steps, the
   paged kernel launches once a decoder layer a decode step ((2k + 1) a
   layer a round); (e) reduced
   seamless on the card gives the
   CPU's tokens in the three views. Its launches go into the kernels'
   record as "seamless_launches".
2q. paligemma-3b's shapes: kernels 1, 2 and 4 at its body leaves (Kin x
   N 2048 x 2048, 2048 x 256, 2048 x 16384, 16384 x 2048) and M =
   1..512 against their plain versions (phase 2's tolerances, lutq_shift
   bit for bit); kernel 1 and lutq_shift on the transposed tied head
   (Kin 2048, N 257216: a partial n tile of 64) at M = 1, 4 and 9;
   second-call and graph bits; kmeans_stats on a 526.8 M-weight leaf
   (the tied table's 2.107 GB of f32: byte offsets past 2^31), aligned
   and 3 elements into a buffer: assignments bit for bit, counts equal,
   sums within 1e-5 of sum|w|, repeats the same bits, one call timed
   beside its byte bound.
3q. paligemma-3b at full width, 2 of its 18 layers (PG_LAYERS): d_model
   2048, 8 query heads of 256 over 1 KV head, d_ff 16384, vocab 257216
   with a tied readout, its 4-bit pow2 LUT-Q, 8-bit activations, random
   weights from seed 0 and a seeded 256-row image prefix a row. (b)
   int8 and packed4 generate (B=4, prompt 128 after the prefix, 16
   tokens), graph and eager: equal tokens and counts, no plain version,
   15 kernel-1 launches a forward in int8 (the head on a transposed
   copy), 14 of kernel 2 and one decode-backend call in packed4; the
   head's share of a replayed decode step and the graph pools' MiB; a
   replayed decode step is the eager step's bits and lies within
   _logit_tol (2e-3 a layer at act_bits 32, twice that at 8) of a
   prefill one token longer, a zeroed prefix moves it by CONTROL_APART
   times that or more, a W = 4 window equals 4 chained
   steps. The calibrated serving_pow2 view the same on lutq_shift (14,
   the head float); (c) its audit (the prefix and 20 tokens, one decode
   step: 14 integer dots each); (d) at act_bits 32,
   synthetic_requests(seed=0) (12 requests, every third text-only,
   prompts up to 128, up to 32 new)
   through a 4-slot engine asked for pages (a vlm engine keeps its slot
   pool: paged False) and its speculative twin (k = 3): each request's
   tokens equal its lone generate, each first decode step's logits lie
   within _logit_tol of its lone first step's and SM_LOGIT_APART from
   the next request's; (e) 3 steps of the trainer (train.build at 2 layers,
   the vocab kept, B = 2 x (256 + 128) prefixed batches): finite losses,
   30 kmeans_stats launches a step (the table among the leaves), no
   plain version, ms a step and peak memory; (f) reduced paligemma on
   the card gives the CPU's tokens in the three views. Its launches go
   into the kernels' record as "paligemma_launches".
2r. zamba2-2.7b's shapes: kernels 1, 2 and 4 at its products (Kin x N
   2560 x 10448, in_proj, whose N is no multiple of the 64-wide n tile;
   5120 x 2560, out_proj; 2560 x 10240 and 10240 x 2560, the shared
   block's MLP) and M = 1, 4, 9, 128, 256 against their plain versions
   (phase 2's tolerances, bf16 and f32 x; lutq_shift bit for bit);
   second-call and graph bits.
3r. zamba2-2.7b at full width, ZB_LAYERS (6) of its 54 layers: one
   super-block of 6 Mamba2 layers (d_inner 5120, 80 SSM heads of 64,
   ssm_state 64) followed by the shared attention block (32 heads of
   80, d_ff 10240; the reduced tests and the card tests hold it applied
   twice, over two K/V caches), vocab 32000 with a tied readout, its
   4-bit pow2 LUT-Q, 8-bit activations, random weights from seed 0. (a)
   int8 and packed4 generate (B=4, 16 tokens) after a 128-token prompt
   (one SSD chunk; int8's graph run profiled) and a 300-token one
   (three, the last padded), graph and eager: equal
   tokens and counts, no plain version, 20 kernel-1 launches a forward in
   int8 (12 Mamba products, the shared block's 7, the head on a
   transposed copy), 19 of kernel 2 and one decode-backend head call in
   packed4; a decode step captured as a CUDA graph and replayed three
   times equals three eager steps bit for bit (logits, every SSM state,
   conv window and K/V), each replay advancing the state, and the first
   lies within _logit_tol (1e-3 a layer at act_bits 32, twice that at
   8) of a prefill one token longer, while the same step from a copy of
   the cache with every SSM state and conv window zeroed lands
   CONTROL_APART times that tolerance or more from it (a step that lost
   or froze its recurrent state fails); the head's share of a replayed
   step, the graph pools' MiB and the state bytes a step read and
   written are logged. (b) The calibrated serving_pow2 view the same
   on lutq_shift (19 a forward, the head float, conv_w pow2-encoded and
   decoded by materialize), then its audit (a 160-token prefill and one
   decode step: 19 integer dots each; the SSD's float einsums are
   counted beside the head's). (c) At act_bits 32,
   synthetic_requests(seed=0) (12 requests, prompts up to 128, up to 32
   new) through a 4-slot engine asked for pages (a hybrid engine keeps
   its slot pool: paged False, one prefill group a prompt length): each
   request's tokens equal its lone generate, each first decode step's
   logits lie within _logit_tol of its lone first step's and
   SM_LOGIT_APART from the next request's; speculative=3 raises the
   reference's reason. (d) Reduced zamba on the card gives the CPU's
   tokens in the three views (conv_w quantized: floors at 1024). Its
   launches go into the kernels' record as "zamba_launches".
2s. rwkv6-1.6b's shapes: kernels 1, 2 and 4 at its products that no
   earlier phase holds (w1 2048 x 64: N = 64, a quarter or a half of
   one tile's width; w2 64 x 2048: Kin = 64, one BK = 64 stage, nothing
   to split; cm_k 2048 x 7168 and cm_v 7168 x 2048) and M = 1, 4, 9,
   128, 256 against their plain versions (phase 2's tolerances, bf16 and
   f32 x: rwkv's products take f32 activations; lutq_shift bit for bit);
   second-call and graph bits.
3s. rwkv6-1.6b at full width, RW_LAYERS (4) of its 24 layers: d_model
   2048 = 32 WKV heads of 64, d_ff 7168, the decay LoRA 64 wide, vocab
   65536 with a tied readout, its 4-bit pow2 LUT-Q, 8-bit activations,
   random weights from seed 0, an f32 residual stream. (a) int8 and
   packed4 generate (B=4, prompt 128, 16 tokens; int8's graph run
   profiled), graph and eager: equal tokens and counts, no plain
   version, 10 x RW_LAYERS + 1 kernel-1 launches a forward in int8 (r,
   k, v, g, o, w1, w2, cm_k, cm_v, cm_r a layer, the head on a
   transposed copy), 10 x RW_LAYERS of kernel 2 and one decode-backend
   head call in packed4 (w1 and w2 packed, the table packed along its
   rows); the decode step replayed three times from a CUDA graph equals
   three eager steps bit for bit (logits, every WKV state and
   token-shift row), each replay advancing the state; the first lies
   within _logit_tol (one bf16 ulp of the logits' row, 2^-7, at any
   depth: the body runs in f32; twice that at act_bits 8) of a prefill
   one token longer, and the same step from a cache whose WKV
   states and shift rows are zeroed CONTROL_APART times that or more
   from it; the head's share of a replayed step, the graph pools' MiB
   and the state bytes a step read and written are logged. (b) The
   calibrated serving_pow2 view the same on lutq_shift (10 x RW_LAYERS a
   forward, the head float, w1 and w2 pow2-encoded with frozen pairs),
   then its audit (a 96-token prefill and one decode step: 10 x
   RW_LAYERS integer dots each; the WKV einsums are float dots, the
   lerps, gates, decay and state updates float multiplies, outside the
   multiplier-less claim as zamba's scan). (c) At act_bits 32,
   synthetic_requests(seed=0) through a 4-slot engine asked for pages
   (an ssm engine keeps its slot pool: paged False, one prefill group a
   prompt length), checked as phase 3r (c). (d) Reduced rwkv on the card
   gives the CPU's tokens in the three views. Its launches go into the
   kernels' record as "rwkv_launches".
3e. serving_pow2: full-width h2o-danube-1.8b (24 layers, seed 0) through
   api.serve_state: init, quantize (4-bit pow2 body, float embeddings
   and head), calibrate the frozen activation scales on 2 x 64 tokens,
   serve_view. All 168 body leaves must be pow2-encoded with frozen
   scales; the largest 7 + span + ceil(log2 Kin) is printed. generate
   (B=4, prompt 128, 16 tokens) must launch lutq_shift 168 times a
   forward and no other GEMM kernel or plain version, and in a profiled
   generate the card must run one lutq_shift kernel a call and no more
   memsets than the same generate through the decode oracle; the prefill
   logits of the integer decode oracle (kernel_backend="decode", plain
   torch on the card) must equal the kernel's bit for bit, and the
   greedy tokens must be identical; all of it with graphs and eagerly,
   the two giving the same tokens and counts. Then one paged engine run
   over phase 3c run (a)'s queue (24 requests, 8 slots, 160 pages, int8
   KV), in both modes as in phase 3c, with run (a)'s checks and
   lutq_shift at 168 x (steps + chunks); the same queue through the
   engine with the decode oracle must give the same tokens, request by
   request.
3k. the multiply audit (repro_torch.kernels.audit: every aten op under a
   TorchDispatchMode plus a note from each kernel launch), inside phase
   3e on its view: memory.affine_shift_ops' and pow2_layer_bits' totals
   over the 168 body leaves are logged, then four eager functions are
   audited with params=view, each logging its count_ops: api.prefill (B=4,
   prompt 128), one api.decode_step from its cache, one paged-engine
   decode step (8 slots, page 64, 160 pages, int8 KV, 8 live requests of
   64-128 prompt tokens) and generate(steps=4), the last two inside
   disable_graphs(). Each must pass with 168 int dots a forward, all of
   them lutq_shift launches, int_dot_flops = sum(M) x sum(Kin N), no fp
   dot on a quantized shape and one head dot a forward beside the
   attention's fp dots (counted). Refused, as they must be: a float
   dictionary at danube's (2560, 6912) through the fused and the packed4
   kernel ("decoded-weight matmul" from the kernel's note), the integer
   decode oracle's prefill on the card (the same, from its float64 aten
   mm) and the engine's decode step once its graph is captured (a replay
   inside an audit). No plain version runs; the phase's launches go into
   the kernels' record as "audit_launches".
3f. self-speculative decoding: the phase-3 serve views (seed 0) at
   act_bits=32, a draft view of draft_bits=3 (K' = 8, packed, every one
   of the 9 quantized leaves coarse; its extra bytes printed), k=3.
   generate (B=4, prompt 128, 32 tokens) through the packed4 and the
   fused target, each with graphs and eagerly, speculative and not:
   speculative tokens must equal k=0's and graph must equal eager; per
   round the target kernel launches 169 times and lutq_gemv_packed 3 x
   169 times for the draft (plus one prefill forward), and no plain
   version runs. Then one paged engine (8 slots, 160 pages, int8 KV,
   prefill_pack=False, fused target) over run (a)'s queue, speculative
   and not: the same tokens request by request, its graphs (decode,
   spec, hydrate, splice 1 each, chunk one a width) after the warmup
   and unchanged by the serve, paged attention 24 x (2k + 1) launches a
   round; the speculative engine serves the queue's first
   SPEC_EAGER_LEAD (8) requests again inside disable_graphs(), with the
   graph pass's tokens request by request (at act_bits 32 a request's
   tokens do not depend on its neighbours) and its own rounds' launch
   counts. Each run logs decode tok/s,
   the round's (or step's) ms, acceptance, tokens a round and peak
   memory, the engine also goodput, one profiled round (or step: wall,
   device busy, the heaviest kernels) and the next one without the
   profiler. The speculative runs' launches go
   into the kernels' record as "speculative_launches".
3b. train: full-width h2o-danube-1.8b (vocab 32000, random f32 masters
   from a seed) through the training CLI's build path and TrainLoop,
   with its default spec (4-bit pow2, kmeans_iters=1, min_size=4096)
   and 8-bit activations, B=4, S=512, 3 steps of AdamW. Each step must
   launch kmeans_stats (kmeans_iters + 1) x (quantized leaves) times
   and run no plain version; losses finite; afterwards every dictionary
   sorted with power-of-two nonzero entries and the masters moved. One
   more step is profiled (device-idle share, kmeans_stats share), and
   AdamW's square roots over every second moment are timed both ways
   (float64 rounded once, as the optimizer takes them; one float32
   _foreach_sqrt_ pass). Then
   the reduced config trains 3 steps on the card and on the CPU from
   the same initial state and batches with kmeans_impl="stats": losses
   within 1e-4 relative, dictionaries within 1e-5.
3b'. the checkpoint: phase 3b's TrainLoop writes the final train state
   (the reference's format, ~23.8 GB) into a new temporary directory,
   which must have 30 GB free (its free space and the host's memory are
   logged first); the save's seconds and bytes are logged. Before the
   state goes, the trained model's packed serve view runs generate (B=4,
   prompt 128, 16 tokens, graph mode): the in-memory tokens.
3g. the train -> serve handoff at full width, the train state freed:
   ckpt.restore_params (memory-mapped, no optimizer moment opened),
   check_ckpt_shapes, interop.from_train_params (pack4, one layer at a
   time to the card, masters unmaterialised) and serve_view, each timed;
   the peak allocated above the baseline must be at most the serve
   view's bytes + 1 GiB, every leaf's d and unpacked a must equal the
   checkpoint's bit for bit, and generate from it, with graphs and
   eagerly, must give the in-memory tokens with 169 lutq_gemv_packed
   launches a forward and no plain version. Then the serve CLI on the
   directory: --pack4 --engine (phase 3c run (a)'s geometry: kernels 2
   and 6) and --kernel-backend fused (B=4, prompt 128, 16 tokens: kernel
   1): each returns 0, prints the restored line and the manifest's policy
   (4-bit pow2, min_size 4096, not the CLI's 1024) and runs no plain
   version. The directory is removed.
3h. the text path: repro_torch.launch.train_e2e, the reference's
   train_e2e recipe (12 layers x d640, GQA 8/2, window 256, vocab 256,
   4-bit pow2, 8-bit activations; 300 AdamW steps of 4 x 256 bytes of
   this checkout, checkpoints at 100, 200, 300), logging the corpus
   bytes, ms a step, tokens/s and the loss: the loss must fall, and
   kmeans_stats must launch (kmeans_iters + 1) x 86 times a step with no
   plain version. Its last checkpoint is served (restore_params,
   from_train_params, packed serve view): 64 greedy bytes after four
   128-byte prompts of the corpus at act_bits 8 (logged as text), then
   at act_bits 32 speculative (k=3, draft_bits=3) beside plain greedy:
   the tokens must be equal; the acceptance on these trained weights is
   logged. Then reduced danube trained 3 steps under serving_pow2 on the
   CPU by the training CLI: its checkpoint served by the serve CLI on the
   card (lutq_shift launches, no plain version) and on the CPU must give
   the same sample, and generate (B=4, 16 tokens) from it on both the
   same tokens. The launches of these phases go into the kernels' record
   as "handoff_launches".
3t. training of the sequence families: (a) seamless-m4t-medium at 2 + 2
   of its 12 + 12 layers (its 256206-row tied table), zamba2-2.7b at 6 of
   54 layers (one super-block and the shared block) and rwkv6-1.6b at 4
   of 24, full width, the vocab kept, each through the training CLI's
   build path (4-bit pow2, kmeans_iters=1, min_size=4096, 8-bit
   activations) and TrainLoop over batch_fn's batches (seamless's with
   frames) for 3 steps of B=2 x S=128: losses finite, kmeans_stats
   launched (kmeans_iters + 1) times a step for every leaf of 2^16
   weights or more (zamba's conv_w, 21 k a layer, runs dense k-means, as
   in the reference), no plain version; ms a step and peak memory
   logged, then one more step profiled (device-idle share). (b) each
   family's reduced config trained 3 steps on the card and on the CPU
   from one initial state with kmeans_impl="stats" at act_bits 32:
   losses within 1e-4 relative, dictionaries within 1e-5, every
   kmeans_stats pass a launch on the card and a plain pass on the CPU.
   The launches of (a) go into the kmeans_stats record as
   "sequence_train_launches".
3j. vision: (a) the reduced ResNet (widths 8/16, one block a stage, 8x8
   images, B=8), seeded, quantized on the CPU under cifar_table's fully
   multiplier-less row and copied to the card: every forward form
   (training and multiplier_less on and off, act_bits 32 and 8) within
   1e-4 (32) and 2e-2 (8) of max|CPU logits| (an 8-bit activation within
   an ulp of a grid boundary may round the other way), the folded ML-BN
   scales equal bit for bit, and one train_step: loss within 1e-2
   relative, running variances 1e-3, every parameter within 2 lr (Adam's
   first step moves by lr), dictionaries equal, assignments equal except
   within 2 lr of a midpoint (counted). (b) ResNet-20 proper (16/32/64, 3
   blocks a stage, 8 classes: 22 LUT-Q leaves) trained by
   cifar_table.train under that row (4-bit pow2, ML-BN, 8-bit
   activations) for 200 steps of B=128 on shapes_dataset(2048, res=32):
   the loss must fall (mean of the last 10 below the first 10), no kernel
   and no plain version runs (every leaf is under the k-means kernel's
   2^16 threshold); ms a step, peak memory above what earlier phases
   hold, loss. (c) 512 held-out images evaluated (batches of 128,
   training=False, multiplier_less, act_bits 8) in the train form and through serve_view int8, pack4=True and
   policy=serving_pow2: the fc launches lutq_matmul, lutq_gemv_packed and
   lutq_shift (dynamic int8 scales) once a forward and nothing else runs;
   each kernel against its plain version at the fc's shape (M = 1, 8,
   128, 512 x Kin 64 x N 8, K = 16; lutq_shift bit for bit); the
   shift-add fold's logits equal the multiply form's bit for bit with
   deterministic convolutions; the int8 and packed views' logits within
   1e-4 of the train form's. Logs held-out error and images/s of each,
   then 10 more steps' ms and one profiled step's idle share. Its serve
   launches go into the kernels' record as "vision_launches".
4. timing of each GEMM kernel at the decode (M=4) and prefill (M=512)
   shapes with CUDA events, beside its bound, its plain version and a
   torch.matmul on the pre-decoded bf16 weight (a yardstick the port
   never calls), both regimes in the kernels' record (M=512 under
   "prefill", as for lutq_shift); kmeans_stats over every leaf shape of one training
   step (two passes, both writing a), beside its byte bound and its plain
   version (no single PyTorch call computes what it does), then the step
   as the trainer makes it (the iteration pass with write_a=False)
   beside its own bound; lutq_shift at the 168
   body shapes of one forward (M = 4, 8 and 512; M = 8 is logged) beside
   its bound, its plain version and torch._int_mm on the pre-decoded int8
   weight (a yardstick the port never calls, exact where |wsh| <= 64;
   every layout it accepts is timed and the fastest reported); the
   paged-attention
   kernel, both variants, at run (a)'s decode geometry and at run (c)'s
   longest row, with the K/V bytes a call reads rotated through more
   than twice the L2, beside its byte bound (the valid positions' K/V
   rows and scales, q, out and the block table), its plain version
   and scaled_dot_product_attention on a pre-gathered, pre-dequantized
   row (a yardstick the port never calls), and swept over the split
   plan's target of 1, 2, 4 and 8 blocks an SM; both variants again at
   run (a)'s geometry with head dim 128 at G = 8 and 12 (qwen1.5's and
   mistral-large's groups; the record's "shapes"); flash attention at phase
   2e's danube geometry and 4096-token row, operands rotated through
   more than twice the L2, the planned kernel (flash_wgmma) beside the
   mma.sync kernel flash_bf16 forced on the same operands, its bound (the
   larger of q, k, v and out at the HBM rate and 4 BH D S(S+1)/2 causal
   bf16 operations at the tensor-core peak), its plain version and
   scaled_dot_product_attention(..., is_causal=True) on the same tensors
   viewed as (B, H, S, D) (a yardstick the port never calls); the
   expert-stacked kernels at E = 128, C = 1 and 40, each of a MoE
   layer's three products, the assignments in two copies, beside the
   bound (assignments, x, output and dictionaries at the HBM rate; 2 E C
   Kin N at the bf16 or int8 peak), the plain version and torch.bmm on
   the pre-decoded bf16 weights (a yardstick; none for lutq_shift): the
   record's top level is one layer at C = 1, its "prefill" at C = 40;
   the same at deepseek's E = 64 stacks (2048 <-> 1408), C = 1 and 60
   (its 4 x 128-token prefill at top-6 and cf 1.25), the record's
   "deepseek"; kernels 6 and 7 at seamless's G = 1, dh 64 with 16 KV
   heads over bf16 pages at run (a)'s lengths (the record's "shapes",
   "G1_dh64_bf16").

A log line near the end gives each phase's seconds ("seconds a phase":
1 the build, 2 every kernel check of phase 2, then the phases of 3 and
4 by the names above). The line before the last is the kernels' JSON
record; the last line is
{"ok": true, "device": {...}}. Without a card, or outside a checkout,
it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
L2_BYTES = 50 * 2**20
STEPS_GEN, BATCH, PROMPT = 16, 4, 128
TOL = {"float32": 1e-4, "bfloat16": 1e-3}
# paged attention, per (sequence, query head) row, of that row's
# max|plain|: one bf16 ulp of the row (2^-7) for bf16 q, whose output
# rounds to bf16 and whose bf16 scores may round the other way where the
# two f32 sums differ in their last bits; 1e-5 for f32 q (f32 sums in
# another order)
PAGED_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# flash attention, per (row, query) of that query row's max|plain|: one
# bf16 ulp of the row (2^-7) for bf16, 1e-5 for f32 (f32 sums in another
# order). Against the port's prefill attention (nn.attention.flash_
# attention, the reference's jnp path): 1e-5 in f32; in bf16 that path
# scales q in bf16 and rounds its scores to bf16 (jnp's bf16 einsum), which
# alone puts it ~2^-6 of the row max from exact attention at danube's
# geometry, three times as far as the kernel's function (phase 2e logs
# both against f64 attention), so the bound there is 2^-5
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
FLASH_PREFILL_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -5}
# danube's prefill attention at phase 3's batch in the GQA layout of
# tests/test_flash_kernel.py, and one 4096-token row
FLASH_DANUBE = dict(B=4, S=512, H=32, Hkv=8, D=80)
FLASH_LONG = dict(B=1, S=4096, H=32, Hkv=8, D=80)
# float32 maxima where amax * f32(1/127) != amax / 127 (found with numpy)
RECIPROCAL_MISSES = [float.fromhex(h) for h in (
    "0x1.7166ecp+2", "0x1.499822p+1", "0x1.968e02p+0", "0x1.d6c39ap-1",
    "0x1.69f1eep-11", "0x1.4bc9bap+7")]

# danube's (Kin, N) per layer, with calls per forward, and the head
LAYER_SHAPES = {"q/o": ((2560, 2560), 2), "k/v": ((2560, 640), 2),
                "wi/wg": ((2560, 6912), 2), "wo": ((6912, 2560), 1)}
HEAD_SHAPE = (2560, 32000)
N_LAYERS = 24
CALLS_PER_FORWARD = 7 * N_LAYERS + 1
# serving_pow2 keeps the head in floating point: 7 body matmuls a layer
SHIFT_CALLS_PER_FORWARD = 7 * N_LAYERS
CALIB_BATCH, CALIB_LEN = 2, 64
INT8_OPS = 1979e12  # int8 tensor-core rate, the table's rate for int8 data

# danube's quantized leaves (rows, cols) with their count in one model
TRAIN_LEAVES = {"q/o": ((2560, 2560), 2 * N_LAYERS),
                "k/v": ((2560, 640), 2 * N_LAYERS),
                "wi/wg": ((2560, 6912), 2 * N_LAYERS),
                "wo": ((6912, 2560), N_LAYERS),
                "embed/head": ((32000, 2560), 2)}
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 3, 4, 512
#: free space phase 3b' needs for its checkpoint: 1.831e9 weights x (4 B
#: master + 8 B moments) + 1.83 GB of int8 assignments is ~23.8 GB
CKPT_FREE_BYTES = 30e9
# phase 3c: the paged engine's page, run (a)'s queue, run (c)'s request
ENGINE_PAGE, ENGINE_QUEUE = 64, 24
LONG_PROMPT, LONG_GEN = 4352, 64
KMEANS_SUM_TOL = 1e-5  # of sum|w| over the entry
#: the card's name and power limit (nvidia-smi), set by setup(): logged
#: beside every MoE number
CARD = ""

KERNELS = {
    "lutq_matmul": dict(route="cuda",
                        source="src/repro_torch/kernels/csrc/lutq_matmul.cu",
                        replaces="src/repro/kernels/lutq_matmul.py:52",
                        packed=False),
    "lutq_gemv_packed": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/lutq_gemv_packed.cu",
        replaces="src/repro/kernels/lutq_gemv_packed.py:48", packed=True),
    "kmeans_stats": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/kmeans_stats.cu",
        replaces="src/repro/kernels/kmeans_tpu.py:51"),
    "lutq_shift": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/lutq_shift.cu",
        replaces="src/repro/kernels/lutq_shift.py:58"),
    "paged_attention": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_attn.cu",
        replaces="src/repro/kernels/paged_attn.py:253"),
    "paged_attention_multipass": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_attn.cu",
        replaces="src/repro/kernels/paged_attn.py:342"),
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attn.cu",
        replaces="src/repro/kernels/flash_attn.py:73"),
}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def die(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        die(msg)


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def setup():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    check((SRC / "repro_torch").is_dir(),
          f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products accumulate in f32 throughout (the plain versions'
    # bf16 einsums included), as the reference's do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    global CARD
    CARD = card
    print(card, flush=True)
    log(f"device {name} x{count} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    from repro_torch.kernels import build

    build.load_library()
    log(f"kernels built in {build.BUILD_INFO['seconds']:.1f} s -> "
        f"{build.BUILD_INFO['path']}")
    for src, sec in build.BUILD_INFO.get("sources", {}).items():
        log(f"  nvcc {src}: {sec:.1f} s")
    entry = ""
    for line in str(build.BUILD_INFO["ptxas"]).splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "registers" in line or "spill" in line:
            log(f"  ptxas {entry[:72]}: {line.strip()}")
    return name, count, card


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def _operands(M, Kin, N, K, dtype, gen, dev, packed, offset=0):
    """x, the assignments (int8, or packed 4-bit) and d; with ``offset``
    the assignments sit that many bytes into a buffer on the card, so
    their rows are not 16-byte aligned."""
    import torch

    from repro_torch.kernels.ref import pack4_kin

    x = torch.randn(M, Kin, generator=gen, device=dev).to(dtype)
    lo = -128 if K == 256 else 0
    a = torch.randint(lo, lo + K, (Kin, N), generator=gen, device=dev,
                      dtype=torch.int8)
    d = torch.sort(torch.randn(K, generator=gen, device=dev)).values
    a = pack4_kin(a) if packed else a
    if offset:
        buf = torch.zeros(a.numel() + offset, dtype=a.dtype, device=dev)
        shifted = buf[offset:].view(a.shape)
        shifted.copy_(a)
        a = shifted
    return x, a, d


#: phase 2's M for the GEMMs at danube's shapes: decode (generate's 4,
#: the engine's 8 slots, 1), the engine's 256-token prefill chunk,
#: generate's 512-token prefill, and each tile's edges (8 | 9, 16 | 17,
#: 64 | 65, 128 | 129, 130)
GEMM_CHECK_M = (1, 4, 8, 9, 16, 17, 64, 65, 128, 129, 130, 256, 512)
#: (M, Kin, N, K, byte offset of the assignments) beyond those: ragged N
#: (unaligned rows, plain loads), a ragged Kin (x rows not 16-byte
#: aligned), assignments at an odd byte offset, K = 2, and for the int8
#: kernel K = 17 and 256 (the shared-table dictionary; indices >= 128
#: stored as negative int8)
GEMM_EXTRA_CASES = [(3, 2560, 211, 16, 0), (130, 2002, 211, 16, 0),
                    (4, 2560, 640, 16, 1), (256, 2560, 640, 16, 3),
                    (8, 2560, 640, 2, 0), (512, 2560, 640, 2, 0)]
GEMM_INT8_CASES = [(4, 2560, 2560, 256, 0), (8, 2560, 640, 17, 0),
                   (512, 2560, 2560, 256, 0), (129, 2002, 211, 256, 1)]
#: (M, Kin, N): a second call and a CUDA-graph replay must give the same
#: bits (decode and prefill with split reductions, prefill without)
GEMM_REPEAT_CASES = [(4, 2560, 2560), (8, 2560, 640), (512, 2560, 640),
                     (512, 2560, 32000)]


def _gemm_fns():
    from repro_torch.kernels import lutq_gemv_packed, lutq_matmul
    from repro_torch.kernels.ref import lutq_gemv_packed_ref, lutq_matmul_ref

    return {"lutq_matmul": (lutq_matmul.lutq_matmul, lutq_matmul_ref),
            "lutq_gemv_packed": (lutq_gemv_packed.lutq_gemv_packed,
                                 lutq_gemv_packed_ref)}


def _gemm_repeats(kname, fn, gen, dev, cases=GEMM_REPEAT_CASES):
    """A second call, and one call captured in a CUDA graph and replayed
    twice, equal the first call bit for bit; the merge tickets are back
    at 0 afterwards."""
    import torch

    from repro_torch.kernels import build

    for M, Kin, N in cases:
        x, a, d = _operands(M, Kin, N, 16, torch.bfloat16, gen, dev,
                            KERNELS[kname]["packed"])
        first = fn(x, a, d)
        second = fn(x, a, d)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn(x, a, d)  # warm-up on the capture stream
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = fn(x, a, d)
        same = [torch.equal(first, second)]
        for _ in range(2):
            captured.zero_()
            graph.replay()
            torch.cuda.synchronize()
            same.append(torch.equal(captured, first))
        tickets = build._GEMM_TICKETS.get(str(x.device))
        plan = build.plan_splits(M, N, Kin, build.sm_count(x.device))
        log(f"check {kname} M={M} Kin={Kin} N={N} bf16 repeat: second call "
            f"{'same' if same[0] else 'DIFFERENT'} bits, graph replays "
            f"{'same' if all(same[1:]) else 'DIFFERENT'} bits (plan "
            f"{plan['bm']}x{plan['bn']}, {plan['splits']} splits)")
        check(all(same), f"{kname} is not deterministic at M={M} Kin={Kin} "
              f"N={N}")
        check(tickets is None or not bool(tickets.any()),
              f"{kname} left a merge ticket set")
        del graph


def kernel_checks():
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [s for s, _ in LAYER_SHAPES.values()] + [HEAD_SHAPE]
    worst = {}
    for kname, (fn, plain) in _gemm_fns().items():
        packed = KERNELS[kname]["packed"]
        cases = [(M, Kin, N, 16, 0) for (Kin, N) in shapes
                 for M in GEMM_CHECK_M] + GEMM_EXTRA_CASES
        if not packed:
            cases += GEMM_INT8_CASES
        worst[kname] = 0.0
        for M, Kin, N, K, offset in cases:
            for dtype in (torch.bfloat16, torch.float32):
                x, a, d = _operands(M, Kin, N, K, dtype, gen, dev, packed,
                                    offset)
                got = fn(x, a, d)
                torch.cuda.synchronize()
                want = plain(x, a, d)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                scale = want.abs().max().item()
                dname = str(dtype).split(".")[-1]
                rel = err / max(scale, 1e-30)
                log(f"check {kname} M={M} Kin={Kin} N={N} K={K} "
                    f"offset={offset} {dname}: max_abs_err {err:.3e} rel "
                    f"{rel:.2e} (tol {TOL[dname]:.0e})")
                check(bool(torch.isfinite(got).all()),
                      f"{kname} produced non-finite values")
                check(rel <= TOL[dname], f"{kname} disagrees with its "
                      f"plain version at M={M} Kin={Kin} N={N} {dname}")
                worst[kname] = max(worst[kname], err)
                del x, a, d, got, want
        _gemm_repeats(kname, fn, gen, dev)
    return worst


def _pow2_dict(w, K):
    """A sorted 4-bit pow2 dictionary fit to w, as the training spec's
    init makes it (K=16), or a sorted random one (other K)."""
    import torch

    from repro_torch.core.lutq import init_dictionary
    from repro_torch.core.spec import QuantSpec

    if K == 16:
        return init_dictionary(w[: 1 << 20], QuantSpec(bits=4,
                                                       constraint="pow2"))
    g = torch.Generator(device=w.device).manual_seed(K)
    scale = w.std() if w.numel() > 1 else 0.02
    return torch.sort(torch.randn(K, generator=g, device=w.device)
                      * scale).values


def kmeans_checks():
    """kmeans_stats against its plain version; returns the largest
    |sums - plain sums| seen."""
    import torch

    from repro_torch.kernels.kmeans_stats import kmeans_stats
    from repro_torch.kernels.ref import kmeans_stats_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    # (N, K, ties, offset of w in elements into a buffer)
    cases = [(r * c, K, False, 0) for (r, c), _ in TRAIN_LEAVES.values()
             for K in (16, 256)]
    cases += [(1_000_003, 16, False, 0), (1_000_003, 256, False, 0),
              (4_000_037, 16, True, 0), (1_000_003, 256, True, 0)]
    cases += [(N, K, False, 0) for N in (1, 3, 5) for K in (1, 2, 17)]
    cases += [(N, K, ties, off) for off in (1, 2, 3) for N, K, ties in
              ((2560 * 640, 16, False), (4099, 17, False), (5, 2, False),
               (70_001, 256, True))]
    worst = 0.0
    for N, K, ties, off in cases:
        w = torch.randn(N, generator=gen, device=dev) * 0.02
        if ties:  # every midpoint of d is a weight, many times over
            d = torch.arange(K, dtype=torch.float32, device=dev) - (K - 1) / 2
            w = (torch.randint(0, 2 * K, (N,), generator=gen, device=dev)
                 - K) * 0.5
        else:
            d = _pow2_dict(w, K)
        if off:
            buf = torch.zeros(N + off, device=dev)
            buf[off:] = w
            w = buf[off:]
            check((w.data_ptr() // 4) % 4 == off, "offset buffer misplaced")
        a, sums, counts = kmeans_stats(w, d)
        torch.cuda.synchronize()
        a0, s0, c0 = kmeans_stats_ref(w, d)
        torch.cuda.synchronize()
        idx = a0.view(torch.uint8).long()
        mag = torch.zeros(K, dtype=torch.float64, device=dev).index_add_(
            0, idx, w.abs().double()).float()
        err = (sums - s0).abs()
        rel = (err / mag.clamp(min=1e-30)).max().item()
        n_bad = int((a != a0).sum())
        on_mid = int(torch.isin(w, (d[:-1] + d[1:]) * 0.5).sum())
        log(f"check kmeans_stats N={N} K={K} offset {off}: {on_mid} "
            f"weights on a "
            f"midpoint, assignments differing {n_bad}, counts equal "
            f"{bool(torch.equal(counts, c0))}, sums max err "
            f"{err.max().item():.3e} ({rel:.2e} of sum|w|, tol "
            f"{KMEANS_SUM_TOL:.0e})")
        check(n_bad == 0, f"kmeans_stats assignments differ at N={N} K={K}")
        check(bool(torch.equal(counts, c0)), f"kmeans_stats counts differ "
              f"at N={N} K={K}")
        check(bool((err <= KMEANS_SUM_TOL * mag).all()),
              f"kmeans_stats sums off at N={N} K={K}")
        if K == 256:
            check(bool((a < 0).any()), "K=256: no index >= 128 seen")
        worst = max(worst, err.max().item())
        del w, a, a0
    _kmeans_repeats(gen, dev)
    return worst


def _kmeans_repeats(gen, dev):
    """A second call, and one call captured in a CUDA graph and replayed
    twice, equal the first call bit for bit, one launch a call and no
    plain call; the merge ticket is back at 0; write_a=False gives the
    same sums and counts and no assignments. Then the profiler's kernel
    list over calls at a leaf shape and at K = 256: the kernel once a
    call and no memset."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build, kmeans_stats as km

    for N, K in ((2560 * 640, 16), (32000 * 2560, 16), (1_000_003, 256),
                 (5, 2)):
        w = torch.randn(N, generator=gen, device=dev) * 0.02
        d = _pow2_dict(w, K)
        before = dict(km.COUNTS)
        first = km.kmeans_stats(w, d)
        second = km.kmeans_stats(w, d)
        calls = km.COUNTS["launches"] - before["launches"]
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            km.kmeans_stats(w, d)  # warm-up
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = km.kmeans_stats(w, d)
        same = [all(torch.equal(x, y) for x, y in zip(first, second))]
        for _ in range(2):
            for x in captured:
                x.zero_()
            graph.replay()
            torch.cuda.synchronize()
            same.append(all(torch.equal(x, y)
                            for x, y in zip(captured, first)))
        a, sums, counts = km.kmeans_stats(w, d, write_a=False)
        no_a = (a is None and torch.equal(sums, first[1])
                and torch.equal(counts, first[2]))
        tickets = not bool(build.merge_tickets(1, w.device).any())
        plain = km.COUNTS["plain"] - before["plain"]
        p = km.plan(N, K, build.sm_count(dev))
        log(f"check kmeans_stats N={N} K={K} repeat: second call "
            f"{'same' if same[0] else 'DIFFERENT'} bits, graph replays "
            f"{'same' if all(same[1:]) else 'DIFFERENT'} bits, write_a="
            f"False {'same' if no_a else 'DIFFERENT'} sums and counts, "
            f"{calls} launches for 2 calls, {plain} plain, ticket back at "
            f"0 {tickets} (plan {p['blocks']} blocks x {p['threads']}, "
            f"chunk {p['chunk']} vectors)")
        check(all(same) and no_a, f"kmeans_stats is not deterministic at "
              f"N={N} K={K}")
        check(calls == 2 and plain == 0,
              f"kmeans_stats: {calls} launches, {plain} plain for 2 calls")
        check(tickets, "kmeans_stats left its merge ticket set")
        del graph, captured, first, second, w
    for N, K in ((2560 * 2560, 16), (70_001, 256)):
        w = torch.randn(N, generator=gen, device=dev) * 0.02
        d = _pow2_dict(w, K)
        km.kmeans_stats(w, d)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                km.kmeans_stats(w, d)
            torch.cuda.synchronize()
        rows = {e.key: e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}
        log(f"check kmeans_stats N={N} K={K}: 4 calls, profiler kernels "
            f"{rows}")
        check(not any("emset" in k for k in rows),
              f"kmeans_stats put a memset on the stream: {rows}")
        check(len(rows) == 1 and "kmeans_stats" in next(iter(rows))
              and next(iter(rows.values())) == 4,
              f"kmeans_stats is not one launch a call: {rows}")


# ---------------------------------------------------------------------------
# phase 2d
# ---------------------------------------------------------------------------

def _shift_operands(M, Kin, N, K, gen, dev, span=9, extreme=False):
    """xq int8, a int8 and wsh int32 of a pow2 dictionary of K codes: a
    zero code, both signs, nonzero magnitudes 1..span+1 (so the shifted
    entries reach 2^span). K=256 draws every byte, so half the indices
    are stored as negative int8. ``extreme``: every weight the largest
    entry and every xq ±127 with its sign, |acc| = 127 * 2^span * Kin."""
    import torch

    from repro_torch.kernels.ref import pow2_shift_weights

    mag = torch.randint(1, span + 2, (K,), generator=gen, device=dev)
    mag[0], mag[-1] = 1, span + 1
    sign = torch.randint(0, 2, (K,), generator=gen, device=dev) * 2 - 1
    code = mag * sign
    if K > 2:
        code[1] = 0
    wsh = pow2_shift_weights(code.to(torch.int8))
    if extreme:
        a = torch.full((Kin, N), K - 1, dtype=torch.uint8,
                       device=dev).view(torch.int8)
        xq = torch.full((M, Kin), 127, dtype=torch.int8, device=dev)
        return xq * int(torch.sign(wsh[K - 1])), a, wsh
    a = torch.randint(-128, 128, (Kin, N), generator=gen, device=dev,
                      dtype=torch.int8)
    if K < 256:
        a = (a.view(torch.uint8) % K).view(torch.int8)
    xq = torch.randint(-127, 128, (M, Kin), generator=gen, device=dev,
                       dtype=torch.int8)
    return xq, a, wsh


#: (M, Kin, N): a second call and two CUDA-graph replays of lutq_shift
#: must give the first call's bits (decode and prefill shapes that split
#: the reduction, and one that does not)
SHIFT_REPEAT_CASES = [(4, 2560, 2560), (8, 2560, 640), (512, 2560, 640),
                      (512, 2560, 6912)]
#: (span, Kin, K): dictionaries of 2, 3 and 4 digit planes (span // 7 +
#: 1), each at the guard's limit 7 + span + ceil(log2 Kin) = 31
SHIFT_PLANE_CASES = [(17, 128, 16), (14, 1024, 256), (20, 16, 16),
                     (21, 8, 256), (23, 2, 16)]


def _shift_repeats(gen, dev):
    """A second call, and one call captured in a CUDA graph and replayed
    twice, equal the first call bit for bit, one launch a call; the merge
    tickets are back at 0. Then the profiler's kernel list over calls at
    a split decode and a split prefill shape: the kernel once a call and
    no memset."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build, lutq_shift
    from repro_torch.kernels.ref import shift_planes

    for M, Kin, N in SHIFT_REPEAT_CASES:
        xq, a, wsh = _shift_operands(M, Kin, N, 16, gen, dev, span=5)
        planes = shift_planes(wsh)
        launches = lutq_shift.COUNTS["launches"]
        first = lutq_shift.lutq_shift(xq, a, wsh, planes)
        second = lutq_shift.lutq_shift(xq, a, wsh, planes)
        calls = lutq_shift.COUNTS["launches"] - launches
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            lutq_shift.lutq_shift(xq, a, wsh, planes)  # warm-up
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = lutq_shift.lutq_shift(xq, a, wsh, planes)
        same = [torch.equal(first, second)]
        for _ in range(2):
            captured.zero_()
            graph.replay()
            torch.cuda.synchronize()
            same.append(torch.equal(captured, first))
        tickets = build._GEMM_TICKETS.get(str(xq.device))
        plan = lutq_shift.plan_splits(M, N, Kin, build.sm_count(xq.device))
        log(f"check lutq_shift M={M} Kin={Kin} N={N} repeat: second call "
            f"{'same' if same[0] else 'DIFFERENT'} bits, graph replays "
            f"{'same' if all(same[1:]) else 'DIFFERENT'} bits, {calls} "
            f"launches for 2 calls (plan {plan['bm']}x{plan['bn']}, "
            f"{plan['splits']} splits)")
        check(all(same), f"lutq_shift is not deterministic at M={M} "
              f"Kin={Kin} N={N}")
        check(calls == 2, f"lutq_shift: {calls} launches for 2 calls")
        check(tickets is None or not bool(tickets.any()),
              "lutq_shift left a merge ticket set")
        del graph
    for M, Kin, N in SHIFT_REPEAT_CASES[:3:2]:
        xq, a, wsh = _shift_operands(M, Kin, N, 16, gen, dev, span=5)
        lutq_shift.lutq_shift(xq, a, wsh, 1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                lutq_shift.lutq_shift(xq, a, wsh, 1)
            torch.cuda.synchronize()
        rows = {e.key: e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}
        log(f"check lutq_shift M={M} Kin={Kin} N={N}: 4 calls, profiler "
            f"kernels {rows}")
        check(not any("emset" in k for k in rows),
              f"lutq_shift put a memset on the stream: {rows}")
        check(len(rows) == 1 and "lutq_shift" in next(iter(rows))
              and next(iter(rows.values())) == 4,
              f"lutq_shift is not one launch a call: {rows}")


def shift_checks():
    """lutq_shift against its plain version on the card, bit for bit
    (torch.equal): danube's four body shapes at M = 1, 2, 4, 8, 130, 512
    with a two-plane dictionary (span 9), and at M = 4, 8, 9, 16, 17, 64,
    256, 512 (every tile edge, the engine's 8-slot step and 256-row chunk)
    with a one-plane one (span 5, as danube's leaves), a ragged shape,
    K = 2, 16, 256 (indices >= 128 as negative int8) at decode and
    prefill M, operands at the overflow guard's limit, 7 + span +
    ceil(log2 Kin) = 31 with every term at its largest (two planes at
    danube's Kin, three and four at small Kin), then the repeat, graph and
    one-launch checks of ``_shift_repeats``. Returns max |kernel - plain|
    (0)."""
    import torch

    from repro_torch.kernels.lutq_shift import lutq_shift
    from repro_torch.kernels.ref import lutq_shift_ref, shift_planes

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    leaves = {"q/o": (2560, 2560), "k/v": (2560, 640),
              "wi/wg": (2560, 6912), "wo": (6912, 2560)}
    cases = [(name, M, Kin, N, 16, 9, False) for name, (Kin, N)
             in leaves.items() for M in (1, 2, 4, 8, 130, 512)]
    cases += [(name, M, Kin, N, 16, 5, False) for name, (Kin, N)
              in leaves.items() for M in (4, 8, 9, 16, 17, 64, 256, 512)]
    cases += [("ragged", M, 2000, 700, 16, 9, False) for M in (3, 130)]
    cases += [(f"K={K}", M, 2560, 640, K, 9, False) for K in (2, 256)
              for M in (4, 130, 512)]
    for Kin, N in ((2560, 6912), (6912, 2560)):
        span = 31 - 7 - math.ceil(math.log2(Kin))
        cases += [(f"guard limit span={span}", M, Kin, N, 16, span, True)
                  for M in (4, 512)]
    cases += [(f"guard limit span={span}", M, Kin, 640, K, span, extreme)
              for span, Kin, K in SHIFT_PLANE_CASES for M in (4, 130)
              for extreme in (False, True)]
    worst = 0
    seen_planes = set()
    for label, M, Kin, N, K, span, extreme in cases:
        xq, a, wsh = _shift_operands(M, Kin, N, K, gen, dev, span, extreme)
        planes = shift_planes(wsh)
        seen_planes.add(planes)
        got = lutq_shift(xq, a, wsh)
        torch.cuda.synchronize()
        want = lutq_shift_ref(xq, a, wsh)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        log(f"check lutq_shift {label} M={M} Kin={Kin} N={N} K={K}: equal "
            f"{bool(torch.equal(got, want))} | {planes} digit planes | max "
            f"|acc| {int(want.abs().max())} | max |wsh| "
            f"{int(wsh.abs().max())}")
        check(torch.equal(got, want), f"lutq_shift differs from its plain "
              f"version ({label}, M={M} Kin={Kin} N={N} K={K})")
        check(planes == span // 7 + 1, f"{planes} planes for span {span}")
        if extreme:
            check(int(want.abs().min()) == 127 * 2 ** span * Kin,
                  "guard-limit case did not reach its largest sum")
        if K == 256:
            check(bool((a < 0).any()), "K=256: no index >= 128 seen")
        worst = max(worst, err)
        del xq, a, got, want
    check(seen_planes == {1, 2, 3, 4}, f"digit planes seen: {seen_planes}")
    _shift_repeats(gen, dev)
    return float(worst)


# ---------------------------------------------------------------------------
# phase 2e
# ---------------------------------------------------------------------------

def _flash_gqa(g, dtype, dev, B, S, H, Hkv, D):
    """(B, S, H, D) queries and (B, S, Hkv, D) keys and values, and the
    kernel's (B*H, S, D) operands with each KV head repeated for its
    query heads, as tests/test_flash_kernel.py lays out GQA."""
    import torch

    G = H // Hkv
    q = torch.randn((B, S, H, D), generator=g, device=dev).to(dtype)
    k = torch.randn((B, S, Hkv, D), generator=g, device=dev).to(dtype)
    v = torch.randn((B, S, Hkv, D), generator=g, device=dev).to(dtype)
    qf = q.reshape(B, S, Hkv, G, D).permute(0, 2, 3, 1, 4).reshape(-1, S, D)
    kf = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).reshape(-1, S, D)
    vf = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).reshape(-1, S, D)
    return (q, k, v), (qf.contiguous(), kf.contiguous(), vf.contiguous())


def _flash_rows(got, want):
    """(max |got - want|, worst row error over that row's own max|want|,
    per-row errors, per-row maxima)."""
    err = (got.float() - want.float()).abs().amax(-1)
    ref = want.float().abs().amax(-1)
    rel = err / ref.clamp_min(1e-30)
    return err.max().item(), rel.max().item(), err, ref


def _exact_attention(q, k, v):
    """Causal softmax attention of (BH, S, D) operands in float64."""
    import torch

    S = q.shape[1]
    s = torch.matmul(q.double(), k.double().transpose(1, 2)) \
        * q.shape[-1] ** -0.5
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).triu(1)
    s = s.masked_fill(mask, float("-inf"))
    return torch.matmul(torch.softmax(s, dim=-1), v.double())


def flash_checks():
    """Kernel 5 against its plain version on the card: the JAX test's
    shapes (f32 and bf16, causal and not), danube's prefill geometry in
    the GQA layout and one 4096-token row (bf16, causal); NaN-poisoned
    skipped blocks; the danube geometry against the port's own prefill
    attention. Returns the largest |kernel - plain|."""
    import torch

    from repro_torch.kernels import flash_attn
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.nn.attention import flash_attention as prefill_attention

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(3, S, D, bq, bk, causal, dt)
             for S, D, bq, bk in ((256, 64, 128, 128), (512, 128, 128, 128),
                                  (256, 64, 64, 128), (384, 32, 128, 128))
             for causal in (True, False) for dt in (f32, bf16)]
    # q blocks of 32 and 48 rows: the bf16 calls that stay on flash_bf16
    cases += [(3, 256, 80, 32, 128, True, bf16),
              (3, 384, 32, 48, 64, False, bf16)]
    cases.append((FLASH_LONG["B"] * FLASH_LONG["H"], FLASH_LONG["S"],
                  FLASH_LONG["D"], 128, 128, True, bf16))
    worst = 0.0
    flash_attn.COUNTS.update({k: 0 for k in flash_attn.COUNTS})
    planned = {k: 0 for k in flash_attn.KERNEL_CODES}
    for BH, S, D, bq, bk, causal, dt in cases:
        q, k, v = (torch.randn((BH, S, D), generator=g, device=dev).to(dt)
                   for _ in range(3))
        want = flash_attention_ref(q, k, v, causal=causal, bq=bq, bk=bk)
        kernel = flash_attn.plan(S, S, D, bq, bk, dt)
        planned[kernel] += 1
        got = flash_attn.flash_attention(q, k, v, causal=causal, bq=bq,
                                         bk=bk)
        torch.cuda.synchronize()
        tol = FLASH_TOL[str(dt).split(".")[-1]]
        err, rel, row_err, ref = _flash_rows(got, want)
        log(f"check flash_attention BH={BH} S={S} D={D} bq={bq} bk={bk} "
            f"causal={causal} {dt} ({kernel}): max_abs_err {err:.3e} | "
            f"worst row {rel:.2e} of its own max (tol {tol:.1e})")
        check(got.dtype == dt and got.shape == q.shape,
              "flash_attention: wrong output dtype or shape")
        check(bool(torch.isfinite(got).all()),
              "flash_attention produced non-finite values")
        check(bool((row_err <= tol * ref).all()),
              "flash_attention disagrees with its plain version")
        worst = max(worst, err)
        del q, k, v, want, got
    # danube's geometry: skipped blocks are never read, and the kernel
    # computes the port's own prefill attention (window 4096 > S)
    geo = FLASH_DANUBE
    B, S, H, Hkv, D = (geo[x] for x in ("B", "S", "H", "Hkv", "D"))
    (q, k, v), (qf, kf, vf) = _flash_gqa(g, bf16, dev, **geo)
    # rows of the first q block keep their bits with NaN past it, at bq =
    # S / 2 and at bq = 64 (one warpgroup), bk = min(bq, 128) (the largest
    # kv tile that holds no NaN row the reference reads)
    for b in (S // 2, 64):
        bk = min(b, 128)
        clean = flash_attn.flash_attention(qf, kf, vf, bq=b, bk=bk)
        kp, vp = kf.clone(), vf.clone()
        kp[:, b:], vp[:, b:] = float("nan"), float("nan")
        poisoned = flash_attn.flash_attention(qf, kp, vp, bq=b, bk=bk)
        torch.cuda.synchronize()
        kernel = flash_attn.plan(S, S, D, b, bk, bf16)
        planned[kernel] += 2
        same = bool(torch.equal(poisoned[:, :b], clean[:, :b]))
        log(f"check flash_attention NaN in K/V rows [{b}, {S}), bq={b} "
            f"bk={bk} ({kernel}): rows [0, {b}) keep their bits {same}")
        check(same, "flash_attention read a kv block that the reference "
              "skips")
        del kp, vp, clean, poisoned
    flat = flash_attn.flash_attention(qf, kf, vf)
    planned[flash_attn.plan(S, S, D, 128, 128, bf16)] += 1
    # a second call, and two replays of a call captured in a CUDA graph
    # (the kernel's TMA maps travel in the captured launch), keep the bits
    again = flash_attn.flash_attention(qf, kf, vf)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_attn.flash_attention(qf, kf, vf)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = flash_attn.flash_attention(qf, kf, vf)
    replays = []
    for _ in range(2):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        replays.append(bool(torch.equal(captured, flat)))
    same = bool(torch.equal(again, flat)) and all(replays)
    planned[flash_attn.plan(S, S, D, 128, 128, bf16)] += 3
    log(f"check flash_attention danube prefill: a second call and two CUDA-"
        f"graph replays give the first call's bits {same}")
    check(same, "flash_attention changed its bits on a second call or in a "
          "CUDA graph")
    del again, captured, graph
    plain = flash_attention_ref(qf, kf, vf)
    torch.cuda.synchronize()
    err, rel, row_err, ref = _flash_rows(flat, plain)
    log(f"check flash_attention danube prefill B={B} S={S} H={H} Hkv={Hkv} "
        f"D={D} (BH={B * H}, GQA layout) bf16 causal: max_abs_err "
        f"{err:.3e} | worst row {rel:.2e} of its own max (tol "
        f"{FLASH_TOL['bfloat16']:.1e})")
    check(bool((row_err <= FLASH_TOL["bfloat16"] * ref).all()),
          "flash_attention disagrees with its plain version")
    worst = max(worst, err)
    # the same inputs in f32 run the kernel's f32 path
    operands = {bf16: (q, k, v, flat),
                f32: (q.float(), k.float(), v.float(),
                      flash_attn.flash_attention(qf.float(), kf.float(),
                                                 vf.float()))}
    planned["flash_f32"] += 1
    for dt, (qd, kd, vd, fd) in operands.items():
        got = fd.reshape(B, Hkv, H // Hkv, S, D).permute(0, 3, 1, 2, 4)
        got = got.reshape(B, S, H, D)
        want = prefill_attention(qd, kd, vd, window=4096)
        torch.cuda.synchronize()
        err, rel, row_err, ref = _flash_rows(got, want)
        tol = FLASH_PREFILL_TOL[str(dt).split(".")[-1]]
        if dt == bf16:
            exact = _exact_attention(qf, kf, vf).reshape(
                B, Hkv, H // Hkv, S, D).permute(0, 3, 1, 2, 4).reshape(
                    B, S, H, D)
            log(f"  against f64 attention of the same bf16 inputs, worst row "
                f"over its own max: kernel {_flash_rows(got, exact)[1]:.2e}"
                f" | the port's prefill attention "
                f"{_flash_rows(want, exact)[1]:.2e}")
            del exact
        log(f"check flash_attention vs the port's prefill attention "
            f"(nn.attention.flash_attention, window 4096) B={B} S={S} "
            f"H={H} Hkv={Hkv} D={D} {dt}: max_abs_err {err:.3e} | worst row "
            f"{rel:.2e} of its own max (tol {tol:.1e})")
        check(bool((row_err <= tol * ref).all()),
              "flash_attention disagrees with the port's prefill attention")
    counts = dict(flash_attn.COUNTS)
    log(f"flash_attention counts {counts}, planned {planned}")
    check(counts["launches"] == len(cases) + 9 and counts["plain"] == 0
          and all(counts[k] == n for k, n in planned.items()),
          f"flash_attention did not launch the planned kernel every call: "
          f"{counts}")
    return float(worst)


# ---------------------------------------------------------------------------
# phase 2f
# ---------------------------------------------------------------------------

def quant_divide_checks():
    """The activation and KV quantizers on the card equal the CPU's bit
    for bit at danube's full-width shapes, with maxima where a reciprocal
    multiply would miss the scale by an ulp."""
    import torch

    from repro_torch.core.actquant import fake_quant
    from repro_torch.models.lm import _kv_quant

    g = torch.Generator().manual_seed(13)
    for dt in (torch.float32, torch.bfloat16):
        for amax in RECIPROCAL_MISSES:
            x = (torch.rand((BATCH, PROMPT, 2560), generator=g) * 2 - 1) \
                * (0.99 * amax)
            x[0, 0, 0] = -amax
            x = x.to(dt)
            for bits in (8, 16):
                want = fake_quant(x, bits)
                got = fake_quant(x.cuda(), bits).cpu()
                check(torch.equal(got, want), f"fake_quant on the card "
                      f"differs from the CPU ({dt}, {bits} bits, amax "
                      f"{amax!r})")
        misses = torch.tensor(RECIPROCAL_MISSES)
        shape = (BATCH, PROMPT, 8, 80)
        rows = shape[0] * shape[1] * shape[2]
        amax = misses.repeat(-(-rows // len(misses)))[:rows].reshape(
            shape[:-1])
        t = (torch.rand(shape, generator=g) * 2 - 1) * (0.99 * amax[..., None])
        t[..., 0] = -amax
        t = t.to(dt)
        want_q, want_s = _kv_quant(t, 8)
        got_q, got_s = _kv_quant(t.cuda(), 8)
        check(torch.equal(got_q.cpu(), want_q) and
              torch.equal(got_s.cpu(), want_s),
              f"_kv_quant on the card differs from the CPU ({dt})")
        log(f"check fake_quant (B={BATCH}, S={PROMPT}, 2560; 8 and 16 bits) "
            f"and _kv_quant ({', '.join(map(str, shape))}) {dt}: card equals "
            f"CPU bit for bit at {len(RECIPROCAL_MISSES)} maxima where "
            f"amax * f32(1/127) != amax / 127")


def adamw_checks():
    """Phase 2f, the optimizer: which float32 op of AdamW's update misses
    the CPU's bits on the card (the root alone, through torch.sqrt and
    _foreach_sqrt_, and the bias-correction divide before it, counted
    over 2^24 values), then one whole AdamW step at danube's full-width
    leaf shapes on the card and on the CPU from the same seeded state:
    parameters and both moments equal bit for bit."""
    import numpy as np
    import torch

    from repro_torch.device import scalar_like
    from repro_torch.optim.optimizers import adamw

    g = torch.Generator().manual_seed(17)
    n = 1 << 24
    x = torch.rand(n, generator=g) * torch.exp2(
        torch.randint(-40, 20, (n,), generator=g).float())
    c2 = float(np.float32(1.0) - np.float32(0.95) ** np.float32(3.0))
    misses = {
        "torch.sqrt": torch.sqrt(x.cuda()).cpu() != torch.sqrt(x),
        "_foreach_sqrt_": torch._foreach_sqrt([x.cuda()])[0].cpu()
        != torch.sqrt(x),
        "v / c2": torch._foreach_div([x.cuda()], scalar_like(
            c2, x.cuda()))[0].cpu() != torch._foreach_div(
                [x], scalar_like(c2, x))[0],
    }
    log("adamw ops on the card against the CPU, float32, 2^24 values: "
        + ", ".join(f"{k} {int(v.sum())} differ" for k, v in misses.items()))
    shapes = {"wi": (2560, 6912), "k": (2560, 640), "norm": (2560,)}
    state = {}
    for name, shape in shapes.items():
        p = torch.randn(shape, generator=g)
        gr = torch.randn(shape, generator=g) * 1e-2
        m = torch.randn(shape, generator=g) * 1e-3
        v = torch.rand(shape, generator=g) * 1e-5
        state[name] = (p, gr, m, v)
    opt = adamw(lambda step: 3e-4, weight_decay=0.1)
    out = {}
    for dev in ("cpu", "cuda"):
        params = {k: t[0].clone().to(dev) for k, t in state.items()}
        grads = {k: t[1].to(dev) for k, t in state.items()}
        st = {"m": {k: t[2].clone().to(dev) for k, t in state.items()},
              "v": {k: t[3].clone().to(dev) for k, t in state.items()}}
        opt.update(grads, st, params, 2)
        out[dev] = (params, st)
    diff = {k: int((out["cuda"][0][k].cpu() != out["cpu"][0][k]).sum())
            for k in shapes}
    moments = all(torch.equal(out["cuda"][1][mv][k].cpu(),
                              out["cpu"][1][mv][k])
                  for mv in ("m", "v") for k in shapes)
    leaves = ", ".join(f"{k} {s}" for k, s in shapes.items())
    log(f"check one AdamW step (leaves {leaves}; "
        f"{sum(math.prod(s) for s in shapes.values())} elements) card "
        f"against CPU: parameters differing {diff} | moments equal "
        f"{moments}")
    check(not any(diff.values()) and moments,
          "an AdamW step on the card differs from the CPU's")


# ---------------------------------------------------------------------------
# phase 2c
# ---------------------------------------------------------------------------

def _paged_case(B, Hkv, G, dh, page, NB, lens, q_dtype, kv_dtype, window,
                gen, dev):
    """One decode step's operands: q, pools with a zero trash page 0, a
    block table of distinct pages, and a second block table whose dead
    entries (past each row's live pages, or wholly behind the window)
    point at a poison page of NaN (float pools) or NaN scales (int8)."""
    import torch

    from repro_torch.kernels.paged_attn import TRASH_PAGE

    P = 2 + B * NB
    poison = P - 1
    shape = (P, page, Hkv, dh)
    quant = kv_dtype == torch.int8
    if quant:
        kp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        ks = (torch.rand(shape[:-1], generator=gen, device=dev) * 0.05
              ).to(torch.bfloat16)
        vs = (torch.rand(shape[:-1], generator=gen, device=dev) * 0.05
              ).to(torch.bfloat16)
        for t in (kp, vp, ks, vs):
            t[TRASH_PAGE] = 0
        ks[poison] = float("nan")
        vs[poison] = float("nan")
    else:
        kp = torch.randn(shape, generator=gen, device=dev).to(kv_dtype)
        vp = torch.randn(shape, generator=gen, device=dev).to(kv_dtype)
        for t in (kp, vp):
            t[TRASH_PAGE] = 0
            t[poison] = float("nan")
        ks = vs = None
    q = torch.randn((B, 1, Hkv * G, dh), generator=gen,
                    device=dev).to(q_dtype)
    perm = 1 + torch.randperm(B * NB, generator=gen, device=dev)
    full = perm.reshape(B, NB).to(torch.int32)
    block, poisoned = full.clone(), full.clone()
    for b, L in enumerate(lens):
        first = 0 if window is None else max(0, (L - window) // page)
        last = (min(L, NB * page) - 1) // page if L > 0 else -1
        for j in range(NB):
            if not first <= j <= last:
                block[b, j] = TRASH_PAGE
                poisoned[b, j] = poison
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kp, vp, ks, vs, block, poisoned, cl


def paged_kernel_checks():
    """Both paged-attention variants against the plain version, at the
    full-width decode shapes and the reduced ones. Returns the largest
    |kernel - plain| of each variant."""
    import torch

    from repro_torch.kernels import build, paged_attn

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(6)
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    full_lens = [1, 63, 64, 65, 577, 2048, 4101, 69 * 64]
    cases = [(8, 8, 4, 80, 64, 69, full_lens, q, kv, w)
             for q, kv in ((bf16, bf16), (bf16, i8), (f32, i8))
             for w in (None, 4096)]
    cases += [(6, 1, 2, 16, page, 4, [0, 1, page - 1, page, 3 * page + 1,
                                      4 * page], q, kv, w)
              for page in (8, 16) for q in (f32, bf16)
              for kv in (f32, bf16, i8) for w in (None, 24)]
    # lengths on the split edges of both full-width plans at this card's
    # SM count: one position, rows shorter than one split, each edge
    # +- 1, window rows whose first valid position is on no page or split
    # edge; then a batch of empty rows
    sms = build.sm_count(dev)
    edges = [1]
    for w in (4096, None):
        c = paged_attn.split_plan(16, 8, 69, 64, w, sms=sms)["chunk"]
        edges += [c // 2, c - 1, c, c + 1, 2 * c + 1]
    edges = sorted({min(x, 69 * 64) for x in edges + [4097, 4193, 69 * 64]})
    edges = (edges * 16)[:16]
    cases += [(16, 8, 4, 80, 64, 69, edges, q, kv, w)
              for q, kv in ((bf16, i8), (f32, i8), (bf16, bf16))
              for w in (None, 4096)]
    cases += [(4, 8, 4, 80, 64, 69, [0] * 4, bf16, i8, 4096)]
    # head dim 128 at the groups of mistral-nemo-12b (4), qwen1.5-110b
    # (8), mistral-large-123b (12) and the kernel's limit (16): full-width
    # lengths, then the split edges (the plan does not depend on G or dh);
    # at G = 12 also a batch of 64 rows, one split each, whose score rows
    # outgrow shared memory: the plan itself picks the workspace variant
    for G in (4, 8, 12, 16):
        cases += [(8, 8, G, 128, 64, 69, full_lens, bf16, kv, w)
                  for kv in (bf16, i8) for w in (None, 4096)]
        cases += [(16, 8, G, 128, 64, 69, edges, bf16, i8, w)
                  for w in (None, 4096)]
    cases += [(64, 8, 12, 128, 64, 69, (full_lens * 8)[:64], bf16, bf16,
               None)]
    worst = _paged_cases(cases, gen, dev)
    # one call of each variant captured in a CUDA graph, replayed twice,
    # at danube's (G, dh) and mistral-large's
    for G, dh in ((4, 80), (12, 128)):
        _paged_graph(16, 8, G, dh, 69, edges, i8, gen, dev)
    return worst


def _paged_cases(cases, gen, dev):
    """Both variants of each case (B, Hkv, G, dh, page, NB, lens, q dtype,
    pool dtype, window) against the plain version, per row within
    PAGED_TOL of the row's max; the same bits with every dead or
    behind-window entry on a NaN page and on a second call; empty rows
    0. Returns the largest |kernel - plain| of each variant."""
    import torch

    from repro_torch.kernels import build, paged_attn
    from repro_torch.kernels.ref import paged_attention_ref

    sms = build.sm_count(dev)
    worst = {name: 0.0 for name in paged_attn.VARIANTS}
    for B, Hkv, G, dh, page, NB, lens, qdt, kvdt, window in cases:
        q, kp, vp, ks, vs, block, poisoned, cl = _paged_case(
            B, Hkv, G, dh, page, NB, lens, qdt, kvdt, window, gen, dev)
        want = paged_attention_ref(q, kp, vp, block, cl, window=window,
                                   k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        tol = PAGED_TOL[str(qdt).split(".")[-1]]
        ref = want.float().abs().amax(-1)  # (B, 1, H): each row's max
        for name, budget in (("paged_attention", None),
                             ("paged_attention_multipass", 0)):
            got = paged_attn.paged_attention(
                q, kp, vp, block, cl, window=window, k_scale=ks,
                v_scale=vs, smem_budget_bytes=budget)
            again = paged_attn.paged_attention(
                q, kp, vp, poisoned, cl, window=window, k_scale=ks,
                v_scale=vs, smem_budget_bytes=budget)
            twice = paged_attn.paged_attention(
                q, kp, vp, block, cl, window=window, k_scale=ks,
                v_scale=vs, smem_budget_bytes=budget)
            torch.cuda.synchronize()
            row_err = (got.float() - want.float()).abs().amax(-1)
            err = row_err.max().item()
            rel = torch.where(ref > 0, row_err / ref.clamp_min(1e-30),
                              row_err)
            at = int(rel.amax(-1).reshape(-1).argmax())
            same = bool(torch.equal(got, again))
            stable = bool(torch.equal(got, twice))
            zero_rows = [b for b, L in enumerate(lens) if L == 0]
            zeros = all(bool((got[b] == 0).all()) for b in zero_rows)
            split = paged_attn.launch_plan(
                B, Hkv, NB, page, dh, G, window=window,
                itemsize=kp.element_size(), sms=sms, budget_bytes=budget)
            log(f"check {name} B={B} Hkv={Hkv} G={G} dh={dh} page={page} "
                f"NB={NB} q {qdt} pool {kvdt} window {window} (nsplit "
                f"{split['nsplit']}, chunk {split['chunk']}, "
                f"{'workspace' if split['multipass'] else 'shared memory'}"
                f"): max_abs_err "
                f"{err:.3e} | worst row {rel.max().item():.2e} of its own "
                f"max (len {lens[at]}, tol {tol:.1e}) | poisoned dead "
                f"entries give the same bits {same} | two calls the same "
                f"bits {stable} | empty rows 0 {zeros}")
            check(bool(torch.isfinite(got).all()),
                  f"{name} produced non-finite values")
            check(bool((row_err <= tol * ref).all()),
                  f"{name} disagrees with its plain version")
            check(same, f"{name} read a dead or behind-window page")
            check(stable, f"{name}: two calls gave different bits")
            check(zeros, f"{name}: a row with cache_len 0 is not 0")
            check(B != 64 or split["multipass"], f"{name}: the plan kept "
                  f"B=64 score rows of G={G} in shared memory")
            worst[name] = max(worst[name], err)
    return worst


def _paged_graph(B, Hkv, G, dh, NB, lens, kvdt, gen, dev):
    """One call of each variant (page 64, window 4096, bf16 q) captured
    in a CUDA graph and replayed twice: each replay equals the eager
    call, the merge tickets back at 0."""
    import torch

    from repro_torch.kernels import paged_attn

    q, kp, vp, ks, vs, block, _, cl = _paged_case(
        B, Hkv, G, dh, 64, NB, lens, torch.bfloat16, kvdt, 4096, gen,
        dev)
    for name, budget in (("paged_attention", None),
                         ("paged_attention_multipass", 0)):
        def call():
            return paged_attn.paged_attention(
                q, kp, vp, block, cl, window=4096, k_scale=ks,
                v_scale=vs, smem_budget_bytes=budget)
        eager = call()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = call()
        replays = []
        for _ in range(2):
            captured.zero_()
            graph.replay()
            torch.cuda.synchronize()
            replays.append(bool(torch.equal(captured, eager)))
        tickets = not bool(paged_attn._TICKETS[dev.index].any())
        log(f"check {name} in a CUDA graph (B={B}, Hkv={Hkv}, G={G}, "
            f"dh={dh}, split edges): two replays equal the eager call "
            f"{replays} | merge tickets back at 0 {tickets}")
        check(all(replays) and tickets,
              f"{name}: a CUDA graph replay differs from the eager call")
        del graph


# ---------------------------------------------------------------------------
# phase 2m: the expert-stacked kernels at qwen3-moe-235b-a22b's shapes
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen3-moe-235b-a22b"
MOE_E = 128
#: an expert's (Kin, N) per product of a MoE layer, with products a layer
MOE_SHAPES = {"wi/wg": ((4096, 1536), 2), "wo": ((1536, 4096), 1)}
#: capacity C of an expert slab: decode (1..8 tokens at cf 2: C = 1), C =
#: 2, one 128-token prompt (C = 10) and 4 x 128 tokens (C = 40)
MOE_C = (1, 2, 10, 40)
#: the empty expert (an all-zero slab) of every check
MOE_EMPTY = 3
#: a 4-expert stack whose products split their reduction (128 experts
#: fill the card without a split)
MOE_SPLIT_E = 4
MOE_KERNELS = {
    "lutq_matmul_experts": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/lutq_matmul.cu",
        replaces="src/repro/kernels/lutq_matmul.py:52", packed=False),
    "lutq_gemv_packed_experts": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/lutq_gemv_packed.cu",
        replaces="src/repro/kernels/lutq_gemv_packed.py:48", packed=True),
    "lutq_shift_experts": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/lutq_shift.cu",
        replaces="src/repro/kernels/lutq_shift.py:58", packed=False),
}


def _expert_fns():
    """{name: (stacked wrapper, plain version, one-expert wrapper,
    one-expert plan, stacked plan)}."""
    from repro_torch.kernels import (build, lutq_gemv_packed, lutq_matmul,
                                     lutq_shift)
    from repro_torch.kernels import ref

    def gemm_plan(C, Kin, N, sms, experts=1):
        return build.plan_splits(C, N, Kin, sms, experts=experts)

    def shift_plan(C, Kin, N, sms, experts=1):
        return lutq_shift.plan_splits(C, N, Kin, sms, experts=experts)

    return {
        "lutq_matmul_experts": (lutq_matmul.lutq_matmul_experts,
                                ref.lutq_matmul_experts_ref,
                                lutq_matmul.lutq_matmul, gemm_plan),
        "lutq_gemv_packed_experts": (
            lutq_gemv_packed.lutq_gemv_packed_experts,
            ref.lutq_gemv_packed_experts_ref,
            lutq_gemv_packed.lutq_gemv_packed, gemm_plan),
        "lutq_shift_experts": (lutq_shift.lutq_shift_experts,
                               ref.lutq_shift_experts_ref,
                               lutq_shift.lutq_shift, shift_plan),
    }


def _expert_operands(kname, E, C, Kin, N, dtype, gen, dev, span=9):
    """x (E, C, Kin) with expert MOE_EMPTY all zero, assignments (E, Kin,
    N) (packed for the packed kernel) and per-expert dictionaries: sorted
    random floats (E, 16), or for lutq_shift int8 xq and the shifted
    dictionaries (E, 16) int32 of pow2 codes whose span differs from
    expert to expert (0..span)."""
    import torch

    from repro_torch.kernels.ref import pack4_kin, pow2_shift_weights

    K = 16
    a = torch.randint(0, K, (E, Kin, N), generator=gen, device=dev,
                      dtype=torch.int8)
    if kname == "lutq_shift_experts":
        x = torch.randint(-127, 128, (E, C, Kin), generator=gen, device=dev,
                          dtype=torch.int8)
        spans = torch.arange(E, device=dev) % (span + 1)
        mag = (torch.randint(0, 1 << 20, (E, K), generator=gen, device=dev)
               % (spans[:, None] + 1)) + 1
        mag[:, 0], mag[:, -1] = 1, spans + 1
        sign = torch.randint(0, 2, (E, K), generator=gen, device=dev) * 2 - 1
        code = (mag * sign).to(torch.int8)
        code[:, 1] = 0
        d = pow2_shift_weights(code)
    else:
        x = torch.randn(E, C, Kin, generator=gen, device=dev).to(dtype)
        d = torch.sort(torch.randn(E, K, generator=gen, device=dev),
                       dim=-1).values
        if MOE_KERNELS[kname]["packed"]:
            a = pack4_kin(a)
    if MOE_EMPTY < E:
        x[MOE_EMPTY] = 0
    return x, a, d


def _expert_call(kname, fn, args):
    """fn's output, and the stacked launches and plain calls it made."""
    import torch

    from repro_torch.kernels import ops

    before = ops.read_counts()
    y = fn(*args)
    torch.cuda.synchronize()
    delta = ops.count_delta(before)
    mod = {"lutq_matmul_experts": 8, "lutq_gemv_packed_experts": 9,
           "lutq_shift_experts": 10}[kname]
    plain = sum(c.get("plain", 0) for c in delta)
    return y, delta[mod]["launches"], plain


def _expert_error(kname, got, want):
    """(max_abs_err, rel) with rel over max|plain|; lutq_shift exact."""
    err = (got.double() - want.double()).abs().max().item()
    scale = want.double().abs().max().item()
    return err, err / max(scale, 1e-30)


def _expert_repeats(fn, args, first):
    """A second call, and one call captured in a CUDA graph and replayed
    twice, give the first call's bits; the merge tickets are back at 0."""
    import torch

    from repro_torch.kernels import build

    second = fn(*args)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn(*args)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn(*args)
    same = [torch.equal(first, second)]
    for _ in range(2):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        same.append(torch.equal(captured, first))
    tickets = build._GEMM_TICKETS.get(str(first.device))
    del graph
    return all(same), tickets is None or not bool(tickets.any())


def moe_kernel_checks(E_main=MOE_E, shapes=MOE_SHAPES, cs=MOE_C,
                      split_e=MOE_SPLIT_E, repeat_c=(1, 40), label="2m"):
    """Phase 2m: each expert-stacked kernel against its plain version at
    qwen3-moe's expert shapes, E = 128 (and a 4-expert stack that
    splits), C in MOE_C, bf16 and f32 x (lutq_shift: int8, bit for bit),
    distinct per-expert dictionaries and an empty expert; one launch a
    stacked product; each expert's slab against a one-expert launch of
    the plain product's kernel on its operands (bit for bit where the
    two plans split alike); second-call and graph-replay bits at C in
    ``repeat_c``. Phase 2o runs it at deepseek's stacks (the arguments;
    ``split_e`` None: no small stack)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.ref import shift_planes

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(29)
    sms = build.sm_count(dev)
    worst = {}
    t0 = time.perf_counter()
    for kname, (fn, plain, one, plan_of) in _expert_fns().items():
        shift = kname == "lutq_shift_experts"
        worst[kname] = 0.0
        dtypes = ((torch.int8,) if shift
                  else (torch.bfloat16, torch.float32))
        cases = [(E_main, C, shape) for C in cs
                 for shape, _ in shapes.values()]
        if split_e:
            cases += [(split_e, C, shape) for C in (1, 40)
                      for shape, _ in shapes.values()]
        for E, C, (Kin, N) in cases:
            for dtype in dtypes:
                x, a, d = _expert_operands(kname, E, C, Kin, N, dtype, gen,
                                           dev)
                # the shift-add kernel's digit planes, derived once, as the
                # serving path hands them in (a host read)
                args = (x, a, d) + ((shift_planes(d),) if shift else ())
                got, launches, nplain = _expert_call(kname, fn, args)
                want = plain(x, a, d)
                torch.cuda.synchronize()
                err, rel = _expert_error(kname, got, want)
                dname = str(dtype).split(".")[-1]
                stacked = plan_of(C, Kin, N, sms, experts=E)
                single = plan_of(C, Kin, N, sms)
                same_plan = all(stacked[k] == single[k]
                                for k in ("bm", "bn", "splits", "kchunk"))
                ones = []
                for e in sorted({0, MOE_EMPTY, E - 1}):
                    y1 = one(x[e], a[e], d[e])
                    if same_plan:
                        ones.append(torch.equal(y1, got[e]))
                    else:
                        ones.append(_expert_error(kname, y1, got[e])[1]
                                    <= TOL.get(dname, 0.0))
                tol = 0.0 if shift else TOL[dname]
                log(f"check {kname} E={E} C={C} Kin={Kin} N={N} {dname}: "
                    f"max_abs_err {err:.3e} rel {rel:.2e} (tol {tol:.0e}) | "
                    f"{launches} launch, plan {stacked['bm']}x{stacked['bn']} "
                    f"{stacked['splits']} splits (one expert: "
                    f"{single['splits']} splits) | one-expert launches "
                    f"{'bit-equal' if same_plan else 'within tol'}: "
                    f"{all(ones)} | empty expert max "
                    f"{got[min(MOE_EMPTY, E - 1)].abs().max().item():.1e}")
                check(launches == 1 and nplain == 0,
                      f"{kname}: {launches} launches and {nplain} plain "
                      f"calls for one stacked product")
                check(bool(torch.isfinite(got.float()).all()),
                      f"{kname} produced non-finite values")
                check(rel <= tol, f"{kname} disagrees with its plain "
                      f"version at E={E} C={C} Kin={Kin} N={N} {dname}")
                check(all(ones), f"{kname}: an expert's slab differs from a "
                      f"one-expert launch at E={E} C={C} Kin={Kin} N={N}")
                if MOE_EMPTY < E:
                    check(not bool(got[MOE_EMPTY].any()),
                          f"{kname}: the empty expert's slab is not zero")
                if C in repeat_c and dtype != torch.float32:
                    same, tickets = _expert_repeats(fn, args, got)
                    log(f"check {kname} E={E} C={C} Kin={Kin} N={N} repeat: "
                        f"second call and graph replays "
                        f"{'same' if same else 'DIFFERENT'} bits, tickets "
                        f"{'at 0' if tickets else 'SET'}")
                    check(same and tickets, f"{kname} is not deterministic "
                          f"at E={E} C={C} Kin={Kin} N={N}")
                worst[kname] = max(worst[kname], err)
                del x, a, d, got, want, args
        torch.cuda.empty_cache()
    log(f"phase {label} {time.perf_counter() - t0:.1f} s")
    return worst


def moe_kernel_timings(card: str, E=MOE_E, shapes=MOE_SHAPES, cs=(1, 40)):
    """The expert-stacked kernels at E = 128 with C = 1 (decode) and C =
    40 (4 x 128 prompt tokens), each of a MoE layer's three products
    (phase 4o: deepseek's E = 64 stacks, C = 1 and 60, the arguments),
    the assignments in two copies (805 MB each, far past the L2), beside
    the bound (the assignments at 1 byte, or half a byte packed, x, the
    output and the dictionaries at the HBM rate; 2 E C Kin N operations
    at the bf16 or int8 tensor-core peak), the plain version (a loop of
    128 plain products) and, for the float kernels, torch.bmm on the
    pre-decoded bf16 weights (a yardstick the port never calls; none for
    the shift-add kernel). Returns {kernel: {C: one layer's three
    products}}."""
    import torch

    from repro_torch.core.lutq import decode
    from repro_torch.kernels.ref import shift_planes, unpack4_kin

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    out = {}
    for kname, (fn, plain, _, _) in _expert_fns().items():
        shift = kname == "lutq_shift_experts"
        packed = MOE_KERNELS[kname]["packed"]
        per_c = {}
        for C in cs:
            agg = dict(ms=0.0, plain_ms=0.0, library_ms=None if shift
                       else 0.0, bytes_ms=0.0, ops_ms=0.0)
            for label, ((Kin, N), calls) in shapes.items():
                x, a, d = _expert_operands(kname, E, C, Kin, N,
                                           torch.bfloat16, gen, dev)
                extra = (shift_planes(d),) if shift else ()
                sets = [(x, a, d) + extra, (x, a.clone(), d) + extra]
                t, t_loop = time_ms(fn, sets, iters=8)
                tp, _ = time_ms(plain, [s[:3] for s in sets], iters=2)
                tl = None
                if not shift:
                    w = decode(d, unpack4_kin(a) if packed else a).to(
                        torch.bfloat16)
                    tl, _ = time_ms(torch.bmm, [(x, w), (x, w.clone())],
                                    iters=8)
                    del w
                abytes = E * Kin * N // (2 if packed else 1)
                xbytes = x.numel() * x.element_size()
                ybytes = E * C * N * 4
                tb = (abytes + xbytes + ybytes + d.numel() * 4) \
                    / HBM_BYTES_PER_S * 1e3
                to = 2 * E * C * Kin * N / (
                    INT8_OPS if shift else PEAK_FLOPS["bfloat16"]) * 1e3
                b, by = max(tb, to), ("bytes" if tb >= to else "operations")
                log(f"time {kname} E={E} C={C} {label} Kin={Kin} N={N}: "
                    f"kernel {t * 1e3:.1f} us (host loop "
                    f"{t_loop * 1e3:.1f} us) | bound {b * 1e3:.1f} us ({by})"
                    f" = {b / t * 100:.1f}% | plain {tp * 1e3:.1f} us | "
                    f"torch.bmm bf16 "
                    f"{'n/a' if tl is None else '%.1f us' % (tl * 1e3)} | "
                    f"{card}")
                agg["ms"] += calls * t
                agg["plain_ms"] += calls * tp
                if tl is not None:
                    agg["library_ms"] += calls * tl
                agg["bytes_ms"] += calls * tb
                agg["ops_ms"] += calls * to
                del x, a, d, sets
                torch.cuda.empty_cache()
            agg["bound_ms"] = max(agg["bytes_ms"], agg["ops_ms"])
            agg["bound_by"] = ("bytes" if agg["bytes_ms"] >= agg["ops_ms"]
                               else "operations")
            log(f"time {kname} E={E} C={C} one MoE layer (3 products): "
                f"kernel {agg['ms']:.3f} ms | bound {agg['bound_ms']:.3f} ms "
                f"({agg['bound_by']}) = "
                f"{agg['bound_ms'] / agg['ms'] * 100:.1f}% | plain "
                f"{agg['plain_ms']:.3f} ms | {card}")
            per_c[C] = agg
        out[kname] = per_c
    return out


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def _count_dicts():
    from repro_torch.kernels import ops

    return ops.count_dicts()


def _reset_counts():
    for counts in _count_dicts():
        for k in counts:
            counts[k] = 0


def _read_counts():
    mm, gp, sh, km, pa, variants, fa, ops, mme, gpe, she = _count_dicts()
    return {"lutq_matmul": mm["launches"], "lutq_gemv_packed": gp["launches"],
            "lutq_shift": sh["launches"], "kmeans_stats": km["launches"],
            "flash_attention": fa["launches"],
            **variants, "lutq_matmul_experts": mme["launches"],
            "lutq_gemv_packed_experts": gpe["launches"],
            "lutq_shift_experts": she["launches"],
            "plain": (mm["plain"] + gp["plain"] + sh["plain"] + km["plain"]
                      + pa["plain"] + fa["plain"] + mme["plain"]
                      + gpe["plain"] + she["plain"]),
            "decode": ops["decode"]}


def profile_run(fn, what: str):
    """Device-busy share of ``fn()`` (which ends in a synchronize), from
    torch.profiler: the sum of kernel device time over the host wall
    time. Returns (wall ms, busy ms, [(ms, count, kernel name)])."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the device's activities (kernels, memsets, copies) read from the
    # trace's events, summed by name: the rows key_averages() gives for
    # them, without building every host op's event tree first (seconds
    # for an eager generate's trace)
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ns, n = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (ns + e.duration_ns(), n + 1)
    rows = [(ns / 1e6, n, name) for name, (ns, n) in by_name.items()
            if ns > 0]
    busy_ms = sum(r[0] for r in rows)
    check(busy_ms > 0, f"profile of {what}: no device time recorded")
    log(f"  profile {what}: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({busy_ms / wall_ms * 100:.1f}%), idle "
        f"{(1 - busy_ms / wall_ms) * 100:.1f}%")
    for ms, count, key in sorted(rows, reverse=True)[:8]:
        log(f"    {ms:9.3f} ms  x{count:<6d} {key[:90]}")
    return wall_ms, busy_ms, rows


#: the two ways phases 3, 3c and 3e serve: replaying each engine's
#: captured decode step, and stepping eagerly inside disable_graphs()
MODES = ("graph", "eager")


def _mode(mode: str):
    import contextlib

    from repro_torch.runtime.engine import disable_graphs

    return disable_graphs() if mode == "eager" else contextlib.nullcontext()


def profile_generate(view, cfg, toks):
    import torch

    from repro_torch.runtime.serving import generate

    def run():
        generate(view, cfg, {"tokens": toks}, steps=STEPS_GEN, device="cuda")
        torch.cuda.synchronize()
    wall_ms, busy_ms, _ = profile_run(run, "generate")
    return wall_ms, busy_ms


def serve_full_width():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.policy import backend_manifest, serve_view
    from repro_torch.core.spec import QuantSpec
    from repro_torch.models import api
    from repro_torch.runtime.serving import generate

    cfg = get_config("h2o-danube-1.8b").replace(
        quant=QuantSpec(bits=4, min_size=1024), act_bits=8)
    t0 = time.perf_counter()
    model = api.quantize(api.init(cfg, seed=0, device="cuda"), cfg)
    policy = api.resolved_policy(cfg)
    views = {"lutq_gemv_packed": (serve_view(model, pack4=True,
                                             policy=policy), "auto"),
             "lutq_matmul": (serve_view(model, pack4=False,
                                        policy=policy), "fused")}
    del model  # frees the fp masters
    torch.cuda.synchronize()
    log(f"full-width {cfg.name}: init + quantize + serve views "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen)
    launches, tokens, stats_out = {}, {}, {}
    for kname, (view, backend) in views.items():
        run_cfg = cfg.replace(kernel_backend=backend)
        manifest = backend_manifest(view, policy, override=backend)
        want_be = "packed4" if KERNELS[kname]["packed"] else "fused"
        matmul_leaves = [p for p in manifest if p != "embed/table"]
        check(all(manifest[p]["backend"] == want_be for p in matmul_leaves),
              f"{kname} view: not every matmul leaf resolves to {want_be}")
        generate(view, run_cfg, {"tokens": toks}, steps=2,
                 device="cuda")  # warm-up, outside the counted run
        torch.cuda.synchronize()
        per_mode = {}
        for mode in MODES:
            with _mode(mode):
                torch.cuda.reset_peak_memory_stats()
                _reset_counts()
                out, stats = generate(view, run_cfg, {"tokens": toks},
                                      steps=STEPS_GEN, return_stats=True,
                                      device="cuda")
                counts = _read_counts()
                peak = torch.cuda.max_memory_allocated() / 2**30
                expected = STEPS_GEN * CALLS_PER_FORWARD
                other = ("lutq_matmul" if kname == "lutq_gemv_packed"
                         else "lutq_gemv_packed")
                log(f"serve [{want_be}] B={BATCH} P={PROMPT} gen={STEPS_GEN}"
                    f" ({mode}): prefill {stats['t_prefill_s'] * 1e3:.1f} ms"
                    f" | decode {stats['decode_tok_s']:.1f} tok/s | warmup "
                    f"{stats['t_warmup_s'] * 1e3:.1f} ms | peak {peak:.2f} "
                    f"GiB | launches {counts}")
                check(counts[kname] == expected, f"{kname} ({mode}): "
                      f"{counts[kname]} launches in the serve run, expected "
                      f"{expected}")
                check(counts[other] == 0 and counts["plain"] == 0
                      and counts["decode"] == 0,
                      f"{kname} run ({mode}) went through another path: "
                      f"{counts}")
                check(out.shape == (BATCH, STEPS_GEN),
                      f"tokens shape {out.shape}")
                check(bool(((out >= 0) & (out < cfg.vocab)).all()),
                      "tokens out of range")
                log(f"  sample tokens {out[0, :8].tolist()}")
                wall_ms, busy_ms = profile_generate(view, run_cfg, toks)
            per_mode[mode] = dict(stats, peak_gib=peak, counts=counts,
                                  tokens=out.cpu(), profiled_wall_ms=wall_ms,
                                  profiled_busy_ms=busy_ms)
        graph, eager = per_mode["graph"], per_mode["eager"]
        check(torch.equal(graph["tokens"], eager["tokens"]),
              f"{kname}: graph and eager serves give other tokens")
        check(graph["counts"] == eager["counts"],
              f"{kname}: graph and eager serves launch other counts")
        with torch.inference_mode():
            logits, _ = api.prefill(view, run_cfg, {"tokens": toks.cuda()})
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
        launches[kname] = graph["counts"][kname]
        # the prefill's attention is plain torch, as the reference's is
        launches["flash_attention"] = (launches.get("flash_attention", 0)
                                       + graph["counts"]["flash_attention"])
        tokens[kname] = graph["tokens"]
        stats_out[kname] = per_mode
    same = bool((tokens["lutq_matmul"] == tokens["lutq_gemv_packed"]).all())
    log(f"packed4 and fused runs give the same tokens: {same}")
    # the views serve phase 3c; main() drops them before training
    return launches, stats_out, {k: v for k, (v, _) in views.items()}, cfg


def reduced_reference():
    """The reduced config served on the card agrees with the CPU run
    through the plain versions."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.policy import serve_view
    from repro_torch.core.spec import QuantSpec
    from repro_torch.models import api
    from repro_torch.models.reduce import reduced
    from repro_torch.runtime.serving import generate

    cfg = reduced(get_config("h2o-danube-1.8b")).replace(
        quant=QuantSpec(bits=4, min_size=512), act_bits=32)
    toks = torch.randint(0, cfg.vocab, (2, 30),
                         generator=torch.Generator().manual_seed(2))
    for pack4 in (True, False):
        cpu = serve_view(api.quantize(api.init(cfg, seed=0, device="cpu"),
                                      cfg), pack4=pack4,
                         policy=api.resolved_policy(cfg))
        gpu = serve_view(api.quantize(api.init(cfg, seed=0, device="cpu"),
                                      cfg), pack4=pack4,
                         policy=api.resolved_policy(cfg)).to("cuda")
        with torch.inference_mode():
            lc, _ = api.prefill(cpu, cfg, {"tokens": toks})
            lg, _ = api.prefill(gpu, cfg, {"tokens": toks.cuda()})
        err = (lg.cpu() - lc).abs().max().item() / lc.abs().max().item()
        tc = generate(cpu, cfg, {"tokens": toks}, steps=8, device="cpu")
        tg = generate(gpu, cfg, {"tokens": toks}, steps=8, device="cuda")
        log(f"reduced {cfg.name} pack4={pack4}: card vs cpu logits rel err "
            f"{err:.2e}, tokens equal {bool((tc == tg.cpu()).all())}")
        check(err <= 1e-4, "reduced logits: card and CPU disagree")
        check(bool((tc == tg.cpu()).all()), "reduced tokens differ")


# ---------------------------------------------------------------------------
# phase 3m: the MoE family at full width (qwen3-moe-235b-a22b)
# ---------------------------------------------------------------------------

#: qwen3-moe's depth on the card: 2 of its 94 layers (each layer's
#: experts are 2.416 G weights, 9.66 GB in float32; 2 layers with the
#: 151936 x 4096 embedding and head are ~24.9 GB before quantize)
MOE_LAYERS = 2
#: q, k, v, o and the three expert-stacked products a layer, plus the head
MOE_CALLS = 7 * MOE_LAYERS + 1
#: phase 3m (c): the engine's queue, prompts of unequal lengths
MOE_QUEUE = (128, 96, 64, 112)
MOE_ENGINE_GEN = 8
#: phase 3m's audited prefill: B=4 x 96 tokens. The audit's rule is by
#: shape (no fp dot on a quantized leaf's (Kin, N) or its transpose), and
#: at 4 x 128 = 512 tokens the routers' float product (512, 4096) @
#: (4096, 128) has the shape of k's and v's transposed (512, 4096) plane
MOE_AUDIT_PROMPT = 96


def _per_generate(n):
    """Launches of a kernel in one generate of STEPS_GEN tokens (a
    prefill and STEPS_GEN - 1 decode steps): ``n`` a forward, or ``n =
    (prefill, decode)`` where the two run other counts (MLA's absorbed
    decode leaves uk and uv out)."""
    p, d = n if isinstance(n, tuple) else (n, n)
    return p + (STEPS_GEN - 1) * d


def _family_serve(label, name, view, cfg, toks, expect, frames=None,
                  prefix=None, profile=True):
    """One view's generate (B=4, prompt 128, 16 tokens; an encdec config
    over ``frames``, a vlm config after ``prefix``, its image embeddings)
    replaying the decode step it captured and eagerly
    (phases 3m (b), 3n, 3o (b), 3p (b) and 3q (b)):
    equal tokens and counts, ``expect[kernel]`` launches of each kernel
    a forward (or a (prefill, decode step) pair, ``_per_generate``), no
    other kernel (paged attention aside) and no plain version; prefill
    ms, decode tok/s, capture ms, peak memory and a profiled generate's
    heaviest kernels are logged (``profile=False`` skips the profiled
    generate). Returns the graph serve's (tokens, counts)."""
    import torch

    from repro_torch.models import api
    from repro_torch.runtime.serving import generate

    batch = {"tokens": toks}
    if frames is not None:
        batch["frames"] = frames
    if prefix is not None:
        batch["prefix_embeds"] = prefix
    generate(view, cfg, batch, steps=2, device="cuda")  # warm-up
    torch.cuda.synchronize()
    per_mode = {}
    for mode in MODES:
        with _mode(mode):
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            out, stats = generate(view, cfg, batch,
                                  steps=STEPS_GEN, return_stats=True,
                                  device="cuda")
            counts = _read_counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
            other = {k: v for k, v in counts.items()
                     if k not in expect and k not in (
                         "paged_attention", "paged_attention_multipass")}
            log(f"{label} serve [{name}] {cfg.name} x{cfg.n_layers} layers "
                f"B={BATCH} P={toks.shape[1]} gen={STEPS_GEN} ({mode}): "
                f"prefill "
                f"{stats['t_prefill_s'] * 1e3:.1f} ms | decode "
                f"{stats['decode_tok_s']:.1f} tok/s | capture "
                f"{stats['t_warmup_s'] * 1e3:.1f} ms | peak {peak:.2f} GiB |"
                f" launches " + ", ".join(f"{k} {counts[k]}" for k in expect)
                + f" | {CARD}")
            want = {k: _per_generate(n) for k, n in expect.items()}
            check(all(counts[k] == n for k, n in want.items()),
                  f"{label} {name} ({mode}): launches "
                  f"{ {k: counts[k] for k in expect} }, expected {want}")
            check(not any(other.values()), f"{label} {name} ({mode}) went "
                  f"through another path: {other}")
            check(out.shape == (BATCH, STEPS_GEN)
                  and bool(((out >= 0) & (out < cfg.vocab)).all()),
                  f"{label} {name}: tokens out of shape or range")
            if mode == "graph" and profile:
                def run():
                    generate(view, cfg, batch, steps=STEPS_GEN,
                             device="cuda")
                    torch.cuda.synchronize()
                profile_run(run, f"{label} generate [{name}]")
        per_mode[mode] = (out.cpu(), counts)
    check(torch.equal(per_mode["graph"][0], per_mode["eager"][0]),
          f"{label} {name}: graph and eager serves give other tokens")
    check(per_mode["graph"][1] == per_mode["eager"][1],
          f"{label} {name}: graph and eager serves launch other counts")
    with torch.inference_mode():
        logits, _ = api.prefill(view, cfg, {k: v.cuda()
                                            for k, v in batch.items()})
    check(bool(torch.isfinite(logits).all()), f"{label} {name}: non-finite "
          f"logits")
    log(f"  sample tokens {per_mode['graph'][0][0, :8].tolist()}")
    return per_mode["graph"]


def _moe_engine(view, cfg, toks_by_len, label="moe", gen=MOE_ENGINE_GEN):
    """Phases 3m (c) and 3o (d): the slot-pool engine over prompts of
    unequal lengths (equal lengths are admitted as one group). One
    slot: each request's tokens equal a lone generate of it
    (with more slots the requests of a decode step share the experts'
    capacity and the activation scales, so a request's tokens depend on
    its batch, as in the reference); graph and eager equal. Four slots
    (kv_pages given: a MoE config keeps the slot path): graph and eager
    give the same tokens and counts, stats()["paged"] is False."""
    import contextlib

    import torch

    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.serving import generate

    max_len = max(len(t) for t in toks_by_len) + gen
    lone = [generate(view, cfg, {"tokens": t[None]}, steps=gen,
                     max_len=max_len, device="cuda")[0].cpu()
            for t in toks_by_len]
    for capacity, kw in ((1, {}), (4, dict(kv_pages=64, page_size=64))):
        runs = {}
        for mode in MODES:
            with _mode(mode):
                torch.cuda.reset_peak_memory_stats()
                _reset_counts()
                eng = Engine(view, cfg, capacity=capacity, max_len=max_len,
                             device="cuda", **kw)
                for t in toks_by_len:
                    eng.submit(t, max_new=gen)
                res = eng.run()
                torch.cuda.synchronize()
                st = eng.stats()
                counts = _read_counts()
                peak = torch.cuda.max_memory_allocated() / 2**30
            runs[mode] = ([torch.as_tensor(r["tokens"]) for r in res], counts)
            log(f"{label} engine {capacity} slot(s) ({mode}): "
                f"{st['completed']} requests, decode "
                f"{st['decode_tok_s']:.1f} tok/s, goodput "
                f"{st['goodput_tok_s']:.1f} tok/s, "
                f"{st['decode_steps']} steps, paged {st['paged']}, peak "
                f"{peak:.2f} GiB | {CARD}")
            check(st["paged"] is False, "a MoE engine took the paged path")
            check(counts["plain"] == 0, f"{label} engine ran plain "
                  f"versions: {counts}")
        check(all(torch.equal(a, b) for a, b in
                  zip(runs["graph"][0], runs["eager"][0]))
              and runs["graph"][1] == runs["eager"][1],
              f"{label} engine ({capacity} slots): graph and eager differ")
        if capacity == 1:
            same = [torch.equal(a, b) for a, b in zip(runs["graph"][0],
                                                      lone)]
            log(f"  one-slot engine equals lone generate per request: "
                f"{same}")
            check(all(same), f"{label} engine: a request differs from its "
                  f"lone generate")


def _family_audit(label, view, cfg, toks, prompt, int_dots,
                  decode_dots=None, frames=None, prefix=None):
    """The serving_pow2 view's prefill (B=4 x ``prompt``; an encdec
    config over the first ``prompt`` of ``frames``, a vlm config after
    ``prefix``) and one decode step through the multiply audit at full
    width (phases 3m (b), 3n, 3o (c), 3p (c), 3q (c)): ``int_dots`` ({op:
    count}; ``decode_dots`` for the decode step where it differs)
    integer dots a forward, all of them kernel
    launches, no fp dot on a quantized shape; the routers' float
    products (a MoE layer's, not quantized; one a MoE layer) and the
    float head are allowed. Under MLA the absorbed decode's two float
    products a layer on the decoded uk / uv (trailing dims (qk_nope,
    kv_lora) and (kv_lora, v_head), which no quantized leaf has) are
    counted and reported apart: that decode is not multiplier-less in
    its latent products, in the reference either. Returns {run: (count,
    flops)} of those latent products."""
    import torch

    from repro_torch.kernels import audit
    from repro_torch.models import api
    from repro_torch.runtime import serving

    batch = {"tokens": toks[:, :prompt].cuda()}
    if frames is not None:
        batch["frames"] = frames[:, :prompt].cuda()
    width = prompt + 2
    if prefix is not None:
        batch["prefix_embeds"] = prefix.cuda()
        width += prefix.shape[1]

    def prefill():
        with torch.inference_mode():
            return api.prefill(view, cfg, batch)

    _, cache = prefill()
    cache = serving.adapt_prefill_cache(cfg, cache, BATCH, width)
    tok = torch.zeros((BATCH, 1), dtype=torch.int32, device="cuda")

    def step():
        with torch.inference_mode():
            return api.decode_step(view, cfg, tok, cache)

    n_moe = cfg.n_layers - cfg.first_dense if cfg.n_experts else 0
    latent_dims = ({(cfg.qk_nope, cfg.kv_lora), (cfg.kv_lora, cfg.v_head)}
                   if cfg.use_mla else set())
    latent = {}
    for name, fn in (("prefill", prefill), ("decode_step", step)):
        want = (decode_dots or int_dots) if name == "decode_step" \
            else int_dots
        t0 = time.perf_counter()
        rep = audit.audit_multiplierless(fn, params=view)
        c = audit.count_ops(rep)
        ops_ = {op: sum(d["op"] == op for d in rep["int_dots"])
                for op in sorted({d["op"] for d in rep["int_dots"]})}
        routers = [d for d in rep["fp_dots"]
                   if d["rhs"] == (cfg.d_model, cfg.n_experts)]
        lat = [d for d in rep["fp_dots"] if d["rhs"][-2:] in latent_dims]
        latent[name] = (len(lat), sum(d["flops"] for d in lat))
        log(f"  {label} audit {cfg.name} {name}: PASS in "
            f"{time.perf_counter() - t0:.2f} s | count_ops {c} | int dots "
            f"{ops_} | router fp dots {len(routers)}"
            + (f" | float latent products {len(lat)} "
               f"({sorted({(d['lhs'], d['rhs']) for d in lat})}), "
               f"{latent[name][1]} flops" if cfg.use_mla else ""))
        check(ops_ == want, f"{label} audit {name}: int dots {ops_}, "
              f"expected {want}")
        check(len(routers) == n_moe,
              f"{label} audit {name}: {len(routers)} router products")
        check(len(lat) == (2 * cfg.n_layers if name == "decode_step"
                           and cfg.use_mla else 0),
              f"{label} audit {name}: {len(lat)} float latent products")
    return latent


def _random_qkv_biases(model, seed):
    """Set every q/k/v bias of ``model`` (a qkv_bias config's: zero at
    init) to seeded normal values, so the bias path carries numbers."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for layer in model.layers:
            for k in ("q", "k", "v"):
                b = getattr(layer.attn, k).bias
                b.copy_(torch.randn(b.shape, generator=g).to(b.device))


def _reduced_card_vs_cpu(label, base, pow2_policy=None):
    """The reduced config ``base`` (act_bits 32) on the card gives the
    CPU's greedy tokens through each view (int8, packed4, serving_pow2
    with calibration, or ``pow2_policy``): phases 3m (d), 3n (e), 3o (e),
    3p (e) (an encdec config over 20 seeded frames a row) and 3q (f) (a
    vlm config after a seeded prefix of its image embeddings)."""
    import torch

    from repro_torch.core.policy import serve_view
    from repro_torch.core.rules import serving_pow2
    from repro_torch.models import api
    from repro_torch.runtime.serving import generate

    gen = torch.Generator().manual_seed(6)
    batch = {"tokens": torch.randint(0, base.vocab, (3, 24), generator=gen)}
    if base.family == "encdec":
        batch["frames"] = torch.randn((3, 20, base.d_model), generator=gen)
    if base.family == "vlm":
        batch["prefix_embeds"] = torch.randn(
            (3, base.n_prefix_tokens, base.d_model), generator=gen)
    for view in ("int8", "packed4", "pow2"):
        cfg = (base.replace(quant=pow2_policy or serving_pow2())
               if view == "pow2" else base)
        model = api.init(cfg, seed=0, device="cpu")
        if cfg.qkv_bias:
            _random_qkv_biases(model, 8)
        model = api.quantize(model, cfg)
        if view == "pow2":
            model = api.calibrate(model, cfg,
                                  {k: v[:2] for k, v in batch.items()})
        cpu = serve_view(model, pack4=view == "packed4",
                         policy=api.resolved_policy(cfg))
        want = generate(cpu, cfg, batch, steps=8, device="cpu")
        got = generate(cpu.to("cuda"), cfg, batch, steps=8,
                       device="cuda").cpu()
        log(f"reduced {cfg.name} (G = {cfg.n_heads // cfg.n_kv_heads}, qkv "
            f"bias {cfg.qkv_bias}) [{view}] card vs cpu tokens equal "
            f"{bool(torch.equal(got, want))}")
        check(torch.equal(got, want), f"reduced {label} [{view}]: card and "
              f"CPU tokens differ")


def moe_full_width():
    """Phase 3m: qwen3-moe-235b-a22b at full width (2 layers, random
    weights from a seed): (b) served through the int8/fused, packed4 and
    calibrated serving_pow2 views, the last audited; (c) the slot-pool
    engine; (d) the reduced config card vs CPU. Returns {kernel:
    launches} of the expert-stacked kernels on the main path (phase (b)'s
    graph-mode generates), and under "dense" the other kernels' launches
    in those generates."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.policy import serve_view
    from repro_torch.core.rules import serving_pow2
    from repro_torch.models import api

    t_phase = time.perf_counter()
    base = get_config(MOE_ARCH).replace(n_layers=MOE_LAYERS)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, base.vocab, (BATCH, PROMPT), generator=gen)
    launches = {}
    t0 = time.perf_counter()
    model = api.quantize(api.init(base, seed=0, device="cuda"), base)
    policy = api.resolved_policy(base)
    torch.cuda.synchronize()
    log(f"moe {base.name} x{MOE_LAYERS}: init + quantize "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated | "
        f"{CARD}")
    views = {"int8": serve_view(model, policy=policy),
             "packed4": serve_view(model, pack4=True, policy=policy)}
    del model  # the fp masters go
    torch.cuda.empty_cache()
    wi = views["int8"].layers[0].moe.wi.state
    check(wi.d.shape == (base.n_experts, 16) and wi.a.shape == (
        base.n_experts, base.d_model, base.d_ff), f"expert leaf {wi.d.shape}"
        f" {wi.a.shape}")
    launches["dense"] = {}
    for name, stacked, dense in (
            ("int8", "lutq_matmul_experts", "lutq_matmul"),
            ("packed4", "lutq_gemv_packed_experts", "lutq_gemv_packed")):
        _, counts = _family_serve("moe", name, views[name], base, toks,
                                  {dense: 4 * MOE_LAYERS + 1,
                                   stacked: 3 * MOE_LAYERS})
        launches[stacked] = counts[stacked]
        launches["dense"][dense] = counts[dense]
    rng = torch.Generator().manual_seed(7)
    queue = [torch.randint(0, base.vocab, (n,), generator=rng)
             for n in MOE_QUEUE]
    _moe_engine(views["packed4"], base, queue)
    del views
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg = base.replace(quant=serving_pow2())
    calib = torch.randint(0, cfg.vocab, (CALIB_BATCH, CALIB_LEN),
                          generator=torch.Generator().manual_seed(2))
    view = api.serve_state(cfg, seed=0, device="cuda",
                           calib_batch={"tokens": calib.cuda()})
    torch.cuda.synchronize()
    wo = view.layers[1].moe.wo.state
    check(wo.d.dtype == torch.int8 and wo.act is not None
          and wo.act.shape == (cfg.n_experts, 2),
          "serving_pow2: the expert leaves are not pow2-encoded with "
          "frozen pairs")
    log(f"moe serving_pow2: serve_state (init, quantize, calibrate, "
        f"serve_view) {time.perf_counter() - t0:.1f} s")
    _, counts = _family_serve("moe", "serving_pow2", view, cfg, toks,
                              {"lutq_shift": 4 * MOE_LAYERS,
                               "lutq_shift_experts": 3 * MOE_LAYERS})
    launches["lutq_shift_experts"] = counts["lutq_shift_experts"]
    launches["dense"]["lutq_shift"] = counts["lutq_shift"]
    _family_audit("moe", view, cfg, toks, MOE_AUDIT_PROMPT,
                  {"lutq_shift": 4 * MOE_LAYERS,
                   "lutq_shift_experts": 3 * MOE_LAYERS})
    del view
    torch.cuda.empty_cache()
    from repro_torch.models.reduce import reduced

    _reduced_card_vs_cpu("MoE", reduced(get_config(MOE_ARCH)).replace(
        act_bits=32))
    log(f"phase 3m {time.perf_counter() - t_phase:.1f} s | launches "
        f"{launches}")
    return launches


# ---------------------------------------------------------------------------
# phases 2o, 3o and 4o: deepseek-v2-lite-16b at full width
# ---------------------------------------------------------------------------

DS_ARCH = "deepseek-v2-lite-16b"
#: deepseek's depth on the card: 3 of its 27 layers, the reduced
#: config's layout (the dense prefix layer and 2 MoE layers); every
#: width stays at its published size
DS_LAYERS = 3
DS_E = 64
#: the (Kin, N) of deepseek's quantized products beside the expert
#: stacks: q, dkv (N = 576, not a multiple of 128: a partial n tile),
#: uk / uv (Kin = 512), o, the dense layer's MLP (d_ff 1408 = 11 x 128)
#: and the shared experts (2816)
DS_LEAF_SHAPES = {"q": (2048, 3072), "dkv": (2048, 576),
                  "uk/uv": (512, 2048), "o": (2048, 2048),
                  "mlp wi/wg": (2048, 1408), "mlp wo": (1408, 2048),
                  "shared wi/wg": (2048, 2816), "shared wo": (2816, 2048)}
#: M of those checks: one slot's decode (1), generate's (4), one
#: 128-token prompt, the audited 4 x 96 prefill, generate's 4 x 128
DS_CHECK_M = (1, 4, 128, 384, 512)
#: (M, Kin, N): second-call and graph-replay bits at dkv's N = 576 and
#: uk's Kin = 512, decode and prefill
DS_REPEAT_CASES = [(4, 2048, 576), (512, 2048, 576), (4, 512, 2048),
                   (512, 512, 2048)]
#: a MoE layer's expert stack products, (Kin, N) and products a layer
DS_SHAPES = {"wi/wg": ((2048, 1408), 2), "wo": ((1408, 2048), 1)}
#: C of the stack checks: decode (4 tokens x top-6 of 64 at cf 2: 1),
#: phase 2m's prefill C (40), generate's 4 x 128 prefill (512 x 6 / 64 x
#: 1.25: 60)
DS_C = (1, 40, 60)
#: phase 3o (d): the slot engine's queue, equal lengths in groups
DS_QUEUE = (128, 96, 128, 64, 96)
DS_ENGINE_GEN = 8


def deepseek_kernel_checks():
    """Phase 2o: kernels 1, 2 and 4 at deepseek's leaf shapes (N = 576,
    Kin = 512, 1408, 2816) and M in DS_CHECK_M against their plain
    versions (bf16 and f32 x; lutq_shift bit for bit), second-call and
    graph bits at N = 576 and Kin = 512; then their expert stacks at E =
    64, C in DS_C (phase 2m's checks). Returns {kernel: max abs err}."""
    import torch

    from repro_torch.kernels.lutq_shift import lutq_shift
    from repro_torch.kernels.ref import lutq_shift_ref, shift_planes

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(37)
    worst = {}
    for kname, (fn, plain) in _gemm_fns().items():
        packed = KERNELS[kname]["packed"]
        worst[kname] = 0.0
        for label, (Kin, N) in DS_LEAF_SHAPES.items():
            for M in DS_CHECK_M:
                for dtype in (torch.bfloat16, torch.float32):
                    x, a, d = _operands(M, Kin, N, 16, dtype, gen, dev,
                                        packed)
                    got = fn(x, a, d)
                    want = plain(x, a, d)
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    rel = err / max(want.abs().max().item(), 1e-30)
                    dname = str(dtype).split(".")[-1]
                    log(f"check {kname} deepseek {label} M={M} Kin={Kin} "
                        f"N={N} {dname}: max_abs_err {err:.3e} rel "
                        f"{rel:.2e} (tol {TOL[dname]:.0e})")
                    check(bool(torch.isfinite(got).all()),
                          f"{kname} produced non-finite values")
                    check(rel <= TOL[dname], f"{kname} disagrees with its "
                          f"plain version at deepseek {label} M={M} {dname}")
                    worst[kname] = max(worst[kname], err)
                    del x, a, d, got, want
        _gemm_repeats(kname, fn, gen, dev, DS_REPEAT_CASES)
    worst["lutq_shift"] = 0.0
    for label, (Kin, N) in DS_LEAF_SHAPES.items():
        for M in DS_CHECK_M:
            xq, a, wsh = _shift_operands(M, Kin, N, 16, gen, dev, span=9)
            planes = shift_planes(wsh)
            got = lutq_shift(xq, a, wsh, planes)
            again = lutq_shift(xq, a, wsh, planes)
            want = lutq_shift_ref(xq, a, wsh)
            torch.cuda.synchronize()
            log(f"check lutq_shift deepseek {label} M={M} Kin={Kin} N={N}: "
                f"equal {bool(torch.equal(got, want))}, second call "
                f"{'same' if torch.equal(got, again) else 'DIFFERENT'} "
                f"bits")
            check(torch.equal(got, want) and torch.equal(got, again),
                  f"lutq_shift differs from its plain version or itself at "
                  f"deepseek {label} M={M}")
            del xq, a, got, again, want
    log(f"phase 2o (kernels 1, 2, 4 at deepseek's leaves) "
        f"{time.perf_counter() - t0:.1f} s")
    stacks = moe_kernel_checks(E_main=DS_E, shapes=DS_SHAPES, cs=DS_C,
                               split_e=None, repeat_c=(1, 60), label="2o")
    worst.update(stacks)
    return worst


def _graph_ms(fn, iters=20, pool=False):
    """Device ms of ``fn`` captured in a CUDA graph and replayed
    ``iters`` times between CUDA events (warmed up on a side stream);
    with ``pool`` also the MiB the capture reserved (its memory pool)."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    pool_mib = (torch.cuda.memory_reserved() - reserved) / 2**20
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    ms = start.elapsed_time(end) / iters
    return (ms, pool_mib) if pool else ms


def _materialize_share(name, view, cfg, toks):
    """Phase 3o: the absorbed decode's per-step decode of the uk / uv
    leaves (``materialize``, two 1 M-entry decodes a layer, inside the
    captured step) beside one whole decode step, both replayed from CUDA
    graphs at B=4 against a 130-column cache; returns (materialize ms,
    step ms)."""
    import torch

    from repro_torch.models import api
    from repro_torch.models.lm import all_layers
    from repro_torch.nn.linear import materialize
    from repro_torch.nn.tree import leaf
    from repro_torch.runtime import serving

    with torch.inference_mode():
        _, cache = api.prefill(view, cfg, {"tokens": toks.cuda()})
        cache = serving.adapt_prefill_cache(cfg, cache, BATCH, PROMPT + 2)
        tok = torch.zeros((BATCH, 1), dtype=torch.int32, device="cuda")
        states = [leaf(getattr(layer.attn, k), "kernel")
                  for layer in all_layers(view) for k in ("uk", "uv")]
        mat = _graph_ms(lambda: [materialize(st, cfg.dtype)
                                 for st in states])
        step = _graph_ms(lambda: api.decode_step(view, cfg, tok, cache))
    log(f"  deepseek [{name}] materialize of uk / uv ({len(states)} leaves) "
        f"{mat * 1e3:.1f} us of a {step * 1e3:.1f} us decode step "
        f"({mat / step * 100:.1f}%), graph replay | {CARD}")
    return mat, step


def deepseek_full_width():
    """Phase 3o: deepseek-v2-lite-16b at full width (3 layers: the dense
    prefix layer and 2 MoE layers, random weights from a seed): (b) the
    int8, packed4 and calibrated serving_pow2 views through generate,
    graph and eager, with each kernel's launches a forward derived from
    the view; the materialize share of a replayed decode step; (c) the
    serving_pow2 view's audit; (d) the slot engine; (e) the reduced
    config card vs CPU. Returns {kernel: launches} of the graph-mode
    generates of (b)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.policy import serve_view
    from repro_torch.core.rules import serving_pow2, with_size_floor
    from repro_torch.core.spec import QuantSpec
    from repro_torch.models import api
    from repro_torch.models.reduce import reduced

    t_phase = time.perf_counter()
    base = get_config(DS_ARCH).replace(n_layers=DS_LAYERS)
    L, n_moe = base.n_layers, base.n_layers - base.first_dense
    # launches a forward: MLA's q, dkv, uk, uv, o in the prefill and q,
    # dkv, o in the absorbed decode (uk, uv decoded in the step instead),
    # a dense MLP or the shared experts (3 products) a layer, the head
    # (float under serving_pow2); the 3 expert-stacked products of each
    # MoE layer
    p, d = 5 * L + 3 * L, 3 * L + 3 * L
    stack = 3 * n_moe
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, base.vocab, (BATCH, PROMPT), generator=gen)
    launches, shares = {}, {}
    t0 = time.perf_counter()
    model = api.quantize(api.init(base, seed=0, device="cuda"), base)
    policy = api.resolved_policy(base)
    torch.cuda.synchronize()
    log(f"deepseek {base.name} x{L} ({base.first_dense} dense + {n_moe} "
        f"MoE): init + quantize {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated | "
        f"{CARD}")
    views = {"int8": serve_view(model, policy=policy),
             "packed4": serve_view(model, pack4=True, policy=policy)}
    del model
    torch.cuda.empty_cache()
    p0 = views["int8"].prefix_layers["0"]
    check(p0.attn.dkv.kernel.state.a.shape == (base.d_model, 576)
          and views["packed4"].layers[0].attn.uk.kernel.state.a.shape
          == (256, 2048) and hasattr(p0, "mlp"),
          "deepseek: the MLA leaves or the prefix layer are not as expected")
    for name, stacked, dense in (
            ("int8", "lutq_matmul_experts", "lutq_matmul"),
            ("packed4", "lutq_gemv_packed_experts", "lutq_gemv_packed")):
        _, counts = _family_serve("deepseek", name, views[name], base, toks,
                                  {dense: (p + 1, d + 1), stacked: stack})
        launches[stacked] = counts[stacked]
        launches[dense] = counts[dense]
        shares[name] = _materialize_share(name, views[name], base, toks)
    rng = torch.Generator().manual_seed(7)
    queue = [torch.randint(0, base.vocab, (n,), generator=rng)
             for n in DS_QUEUE]
    _moe_engine(views["packed4"], base, queue, label="deepseek",
                gen=DS_ENGINE_GEN)
    del views
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg = base.replace(quant=serving_pow2())
    calib = torch.randint(0, cfg.vocab, (CALIB_BATCH, CALIB_LEN),
                          generator=torch.Generator().manual_seed(2))
    view = api.serve_state(cfg, seed=0, device="cuda",
                           calib_batch={"tokens": calib.cuda()})
    torch.cuda.synchronize()
    uk = view.layers[1].attn.uk.kernel.state
    wo = view.layers[1].moe.wo.state
    check(uk.d.dtype == torch.int8 and uk.act is not None
          and wo.d.dtype == torch.int8 and wo.act is not None
          and wo.act.shape == (cfg.n_experts, 2),
          "serving_pow2: the MLA or expert leaves are not pow2-encoded with "
          "frozen pairs")
    log(f"deepseek serving_pow2: serve_state (init, quantize, calibrate, "
        f"serve_view) {time.perf_counter() - t0:.1f} s")
    _, counts = _family_serve("deepseek", "serving_pow2", view, cfg, toks,
                              {"lutq_shift": (p, d),
                               "lutq_shift_experts": stack})
    launches["lutq_shift_experts"] = counts["lutq_shift_experts"]
    launches["lutq_shift"] = counts["lutq_shift"]
    shares["serving_pow2"] = _materialize_share("serving_pow2", view, cfg,
                                                toks)
    latent = _family_audit("deepseek", view, cfg, toks, MOE_AUDIT_PROMPT,
                           {"lutq_shift": p, "lutq_shift_experts": stack},
                           {"lutq_shift": d, "lutq_shift_experts": stack})
    del view
    torch.cuda.empty_cache()
    # floor 0: reduced deepseek's MLA leaves are under 4096 elements
    small = reduced(get_config(DS_ARCH)).replace(
        act_bits=32, quant=QuantSpec(bits=4, constraint="pow2", min_size=0))
    _reduced_card_vs_cpu("deepseek", small,
                         with_size_floor(serving_pow2(), 0))
    log(f"phase 3o {time.perf_counter() - t_phase:.1f} s | launches "
        f"{launches} | decode's float latent products {latent} | "
        f"materialize ms / step ms {shares}")
    return launches


# ---------------------------------------------------------------------------
# phases 2p and 3p: the encoder-decoder family (seamless-m4t-medium)
# ---------------------------------------------------------------------------

SM_ARCH = "seamless-m4t-medium"
#: seamless's (Kin, N) of its body products: q, k, v, o and the
#: cross-attention's four (1024 x 1024), wi / wg (1024 x 4096), wo (4096
#: x 1024)
SM_LEAF_SHAPES = {"attn": (1024, 1024), "wi/wg": (1024, 4096),
                  "wo": (4096, 1024)}
#: the tied readout's assignments as the int8 view's head reads them,
#: transposed: (Kin 1024, N 256206), a partial n tile of 78 at 128
SM_HEAD = (1024, 256206)
#: phase 2p's M: decode (1, generate's 4, the engine's 4 slots), the tile
#: edges, a 128-token prompt and generate's 4 x 128 prefill
SM_CHECK_M = (1, 4, 8, 9, 16, 17, 64, 65, 128, 129, 256, 512)
SM_HEAD_M = (1, 4, 9)
SM_REPEAT_CASES = [(4, 1024, 1024), (512, 1024, 4096), (4, 4096, 1024),
                   (4, 1024, 256206)]
#: phase 3p: source frames a row, the engine queue (synthetic_requests,
#: seed 0: prompts of 32-128 tokens over 64-128 frames, up to 32 new
#: tokens), the audited prefill's width (B x 20 rows: no activation of a
#: quantized leaf's 1024 or 4096 rows)
SM_SRC, SM_QUEUE, SM_MAX_NEW, SM_AUDIT = 128, 12, 32, 20
#: phase 3p's depth: 4 of the 12 encoder and 4 of the 12 decoder layers
#: (the whole model took 68.0 s of phase 3p, over its 60 s share of the
#: script's limit, and 6 + 6 38.5 s on a slow H100 host whose whole
#: script took 1124.8 s of its 1200 s once phase 3q joined; the width
#: stays whole)
SM_LAYERS = 4
#: the paged engine's block-table width: ceil((128 + 32 + 3) / 64)
SM_NB = 3
#: phase 3p's logits checks: max |a - b| over the reference row's max
#: |logit|, for a decode step against a prefill one token longer, an
#: engine row's first decode step against its request's alone, and a W
#: = 4 window against 4 chained steps (bf16 activations, f32 sums); at
#: serving_pow2's frozen 8-bit activation scales a bf16 difference
#: upstream can move an activation by a whole step, so its decode step
#: against the prefill is held to SM_LOGIT_TOL_ACT8
SM_LOGIT_TOL, SM_LOGIT_TOL_ACT8 = 2e-2, 4e-2
#: the least relative distance that a wrong input (half the source
#: masked, another request's row) must put between two logits rows, so
#: that the checks above can fail where the greedy tokens repeat
SM_LOGIT_APART = 0.1


def seamless_kernel_checks():
    """Phase 2p: kernels 1, 2 and 4 at seamless's body shapes and M in
    SM_CHECK_M against their plain versions (bf16 and f32 x, phase 2's
    tolerances; lutq_shift bit for bit), kernel 1 and lutq_shift on the
    transposed tied head (N = 256206), second-call and graph bits; then
    kernels 6 and 7 at G = 1, dh 64 (16 KV heads), bf16 q over bf16
    pages: full-width lengths, the split edges of the engine's plan and
    of a 16-row plan, empty rows, the NaN pages, a graph replay, with
    phase 2c's per-row tolerance. Returns {kernel: max abs err}."""
    import torch

    from repro_torch.kernels import build, paged_attn
    from repro_torch.kernels.lutq_shift import lutq_shift
    from repro_torch.kernels.ref import lutq_shift_ref, shift_planes

    t0 = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(41)
    worst = {}
    shapes = [(label, shape, SM_CHECK_M)
              for label, shape in SM_LEAF_SHAPES.items()]
    for kname, (fn, plain) in _gemm_fns().items():
        packed = KERNELS[kname]["packed"]
        worst[kname] = 0.0
        # the packed view's head is the decode backend: kernel 1 only
        head = [] if packed else [("head", SM_HEAD, SM_HEAD_M)]
        for label, (Kin, N), ms in shapes + head:
            for M in ms:
                for dtype in (torch.bfloat16, torch.float32):
                    x, a, d = _operands(M, Kin, N, 16, dtype, gen, dev,
                                        packed)
                    got = fn(x, a, d)
                    want = plain(x, a, d)
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    rel = err / max(want.abs().max().item(), 1e-30)
                    dname = str(dtype).split(".")[-1]
                    log(f"check {kname} seamless {label} M={M} Kin={Kin} "
                        f"N={N} {dname}: max_abs_err {err:.3e} rel "
                        f"{rel:.2e} (tol {TOL[dname]:.0e})")
                    check(bool(torch.isfinite(got).all()),
                          f"{kname} produced non-finite values")
                    check(rel <= TOL[dname], f"{kname} disagrees with its "
                          f"plain version at seamless {label} M={M} {dname}")
                    worst[kname] = max(worst[kname], err)
                    del x, a, d, got, want
        _gemm_repeats(kname, fn, gen, dev, SM_REPEAT_CASES)
    worst["lutq_shift"] = 0.0
    for label, (Kin, N), ms in shapes + [("head", SM_HEAD, SM_HEAD_M)]:
        for M in ms:
            xq, a, wsh = _shift_operands(M, Kin, N, 16, gen, dev, span=9)
            planes = shift_planes(wsh)
            got = lutq_shift(xq, a, wsh, planes)
            again = lutq_shift(xq, a, wsh, planes)
            want = lutq_shift_ref(xq, a, wsh)
            torch.cuda.synchronize()
            log(f"check lutq_shift seamless {label} M={M} Kin={Kin} N={N}: "
                f"equal {bool(torch.equal(got, want))}, second call "
                f"{'same' if torch.equal(got, again) else 'DIFFERENT'} "
                f"bits")
            check(torch.equal(got, want) and torch.equal(got, again),
                  f"lutq_shift differs from its plain version or itself at "
                  f"seamless {label} M={M}")
            del xq, a, got, again, want
    log(f"phase 2p (kernels 1, 2, 4 at seamless's leaves and head) "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    sms = build.sm_count(dev)
    full_lens = [0, 1, 63, 64, 65, 577, 2048, 69 * 64]
    edges = {}
    for B, NB in ((4, SM_NB), (16, 69)):
        c = paged_attn.split_plan(B, 16, NB, 64, None, sms=sms)["chunk"]
        e = sorted({min(x, NB * 64) for x in
                    (1, c // 2, c - 1, c, c + 1, 2 * c + 1, NB * 64)})
        edges[B] = (e * B)[:B]
    cases = [(8, 16, 1, 64, 64, 69, full_lens, bf16, bf16, w)
             for w in (None, 4096)]
    cases += [(B, 16, 1, 64, 64, NB, edges[B], bf16, bf16, None)
              for B, NB in ((4, SM_NB), (16, 69))]
    cases += [(4, 16, 1, 64, 64, SM_NB, [0, 5, 0, 64], bf16, bf16, None),
              (4, 16, 1, 64, 64, SM_NB, [0] * 4, bf16, bf16, None)]
    for name, err in _paged_cases(cases, gen, dev).items():
        worst[name] = err
    _paged_graph(4, 16, 1, 64, SM_NB, edges[4], bf16, gen, dev)
    _paged_graph(16, 16, 1, 64, 69, edges[16], bf16, gen, dev)
    log(f"phase 2p (kernels 6 and 7 at G = 1, dh 64) "
        f"{time.perf_counter() - t0:.1f} s")
    return worst


def _head_share(label, name, view, cfg, batch, width, **adapt):
    """Phases 3p, 3q and 3r: the tied readout (its product on B=4 normed
    rows) beside one whole decode step, both replayed from CUDA graphs
    against the cache of ``batch``'s prefill grown to ``width`` columns
    (``adapt``: ``adapt_prefill_cache``'s other arguments); returns (head
    ms, step ms, the step graph's pool MiB, the head graph's)."""
    import torch

    from repro_torch.kernels.build import ROW_STABLE_M
    from repro_torch.models import api
    from repro_torch.models.lm import _head
    from repro_torch.runtime import serving

    with torch.inference_mode():
        _, cache = api.prefill(view, cfg, {k: v.cuda()
                                           for k, v in batch.items()})
        cache = serving.adapt_prefill_cache(cfg, cache, BATCH, width,
                                            **adapt)
        tok = torch.zeros((BATCH, 1), dtype=torch.int32, device="cuda")
        x = torch.randn((BATCH, 1, cfg.d_model), device="cuda").to(cfg.dtype)
        head, head_mib = _graph_ms(
            lambda: _head(view, cfg, x, ROW_STABLE_M), pool=True)
        step, step_mib = _graph_ms(
            lambda: api.decode_step(view, cfg, tok, cache), pool=True)
    log(f"  {label} [{name}] tied head {head * 1e3:.1f} us of a "
        f"{step * 1e3:.1f} us decode step ({head / step * 100:.1f}%), graph "
        f"replay | graph pools: step {step_mib:.1f} MiB, head alone "
        f"{head_mib:.1f} MiB | {CARD}")
    return head, step, step_mib, head_mib


def _rel(a, ref) -> float:
    """max |a - ref| over max |ref|, in float32."""
    a, ref = a.float(), ref.float()
    return float((a - ref).abs().max() / ref.abs().max())


def _clone_tree(tree):
    """A copy of a cache's nested dicts and lists of tensors."""
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(v) for v in tree]
    return tree.clone()


def _decode_logits_checks(name, view, cfg, toks, frames):
    """Phase 3p (b): one decode step's logits (B=4, after a 127-token
    prefill over 128 frames) replayed from a CUDA graph are the eager
    step's bits and lie within SM_LOGIT_TOL (SM_LOGIT_TOL_ACT8 at 8-bit
    activations) of a 128-token prefill's last logits; half the source masked (``src_len`` 64) moves them by
    more than SM_LOGIT_APART; a W = 4 window equals 4 chained steps
    within SM_LOGIT_TOL. int8 and packed4 at act_bits 32 (8-bit dynamic
    scales couple a batch's rows), serving_pow2 at its frozen scales."""
    import torch

    from repro_torch.models import api
    from repro_torch.runtime import serving

    if name != "serving_pow2":
        cfg = cfg.replace(act_bits=32)
    tol = SM_LOGIT_TOL if cfg.act_bits == 32 else SM_LOGIT_TOL_ACT8
    toks, frames = toks.cuda(), frames.cuda()
    P = toks.shape[1] - 1
    with torch.inference_mode():
        want, _ = api.prefill(view, cfg, {"tokens": toks, "frames": frames})
        _, cache = api.prefill(view, cfg, {"tokens": toks[:, :P],
                                           "frames": frames})
        cache = serving.adapt_prefill_cache(cfg, cache, BATCH, P + 5,
                                            src_len=SM_SRC)
        snap = _clone_tree(cache)
        tok = toks[:, P:].to(torch.int32).contiguous()

        def step():
            return api.decode_step(view, cfg, tok, cache)[0]
        eager = step().clone()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            step()
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = step()
        graph.replay()
        torch.cuda.synchronize()
        replayed = out.clone()
        del graph
        half = _clone_tree(snap)
        half["src_len"].fill_(SM_SRC // 2)
        masked = api.decode_step(view, cfg, tok, half)[0]
        gen = torch.Generator(device="cuda").manual_seed(3)
        win = torch.cat([tok, torch.randint(0, cfg.vocab, (BATCH, 3),
                                            generator=gen, device="cuda",
                                            dtype=torch.int32)], dim=1)
        window = api.decode_window(view, cfg, win, _clone_tree(snap))[0]
        c, chained = _clone_tree(snap), []
        for j in range(4):
            lg, c = api.decode_step(view, cfg, win[:, j:j + 1], c)
            chained.append(lg)
        chained = torch.cat(chained, dim=1)
    err, moved = _rel(eager, want), _rel(masked, want)
    werr = _rel(window, chained)
    log(f"  seamless [{name}] logits (act_bits {cfg.act_bits}): graph step "
        f"= eager step bits {bool(torch.equal(replayed, eager))}; decode "
        f"step vs prefill {err:.3e}, with half the source masked "
        f"{moved:.3e} (tol {tol:g}, apart >= {SM_LOGIT_APART:g}); "
        f"W=4 window vs 4 chained steps {werr:.3e} (bits "
        f"{bool(torch.equal(window, chained))}); greedy tokens "
        f"{want[:, -1].argmax(-1).tolist()} | {CARD}")
    check(torch.equal(replayed, eager), f"seamless {name}: a replayed "
          f"decode step's logits are not the eager step's")
    check(err <= tol, f"seamless {name}: decode step logits {err:.3e} "
          f"from the prefill's (tol {tol:g})")
    check(moved >= SM_LOGIT_APART, f"seamless {name}: masking half the "
          f"source moved the logits by only {moved:.3e}")
    check(werr <= SM_LOGIT_TOL, f"seamless {name}: a W=4 window's logits "
          f"{werr:.3e} from 4 chained steps' (tol {SM_LOGIT_TOL:g})")


def _first_step_logits(view, cfg, r, width):
    """A request's first decode step alone (B = 1, eagerly, as its lone
    generate runs it): the prefill over its tokens and its frames or
    image prefix where it has them, the cache grown to the engine's slot
    ``width``, its greedy first token, one step. Returns the step's
    logits (V,)."""
    import torch

    from repro_torch.models import api
    from repro_torch.runtime import serving

    batch = {k: torch.as_tensor(r[k])[None].cuda()
             for k in ("tokens", "frames", "prefix_embeds") if k in r}
    adapt = ({"src_len": batch["frames"].shape[1]} if "frames" in batch
             else {})
    with torch.inference_mode():
        logits, cache = api.prefill(view, cfg, batch)
        cache = serving.adapt_prefill_cache(cfg, cache, 1, width, **adapt)
        first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        return api.decode_step(view, cfg, first, cache)[0][0, -1]


def _paged_window_check(view, cfg, eng):
    """Phase 3p (d): on a copy of the paged engine's cache, a W = 4
    window (each slot's pending token and 3 seeded drafts, as a
    speculative round's verify runs it) against 4 chained paged steps:
    within SM_LOGIT_TOL of each other; their launches are not counted.
    Returns the distance."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import api

    before = ops.read_counts()
    gen = torch.Generator(device="cuda").manual_seed(4)
    with torch.inference_mode():
        win = torch.cat([eng.tok, torch.randint(
            0, cfg.vocab, (eng.tok.shape[0], 3), generator=gen,
            device="cuda", dtype=torch.int32)], dim=1)
        window = api.paged_decode_window(view, cfg, win,
                                         _clone_tree(eng.cache))[0]
        c, chained = _clone_tree(eng.cache), []
        for j in range(4):
            lg, c = api.paged_decode_step(view, cfg, win[:, j:j + 1], c)
            chained.append(lg)
        chained = torch.cat(chained, dim=1)
    ops.set_counts(before)
    werr = _rel(window, chained)
    live = sum(q is not None for q in eng.slots)
    log(f"  seamless paged W=4 window vs 4 chained paged steps ({live} live "
        f"slots): {werr:.3e} (bits {bool(torch.equal(window, chained))}, "
        f"tol {SM_LOGIT_TOL:g})")
    check(werr <= SM_LOGIT_TOL, f"seamless paged window: logits {werr:.3e} "
          f"from chained steps' (tol {SM_LOGIT_TOL:g})")
    return werr


def _seamless_engines(view, cfg):
    """Phase 3p (d): at act_bits 32, synthetic_requests(seed=0) (12
    requests over 64-128 frames of a 128-frame src_len) through the
    paged engine (4 slots, page 64, bf16 pages), its speculative twin (k
    = 3, draft_bits 3) and a 4-slot slot engine: every request's tokens
    equal its lone generate; in the paged and slot engines each
    request's first decode step's logits row lies within SM_LOGIT_TOL of
    its lone first step's and SM_LOGIT_APART from the next request's,
    and a W = 4 paged window equals chained paged steps
    (``_paged_window_check``); the paged kernel launches n_layers times
    a decode step (n_layers (2k + 1) a round) in the variant its plan
    picks; no plain version. Returns {kernel: launches}."""
    from collections import Counter

    import torch

    from repro_torch.kernels import build, paged_attn
    from repro_torch.runtime.engine import Engine, synthetic_requests
    from repro_torch.runtime.serving import generate

    reqs = synthetic_requests(cfg, SM_QUEUE, max_prompt=PROMPT,
                              max_new=SM_MAX_NEW, seed=0, src_len=SM_SRC)
    max_len = PROMPT + SM_MAX_NEW + 3
    t0 = time.perf_counter()
    lone = [generate(view, cfg, {"tokens": torch.as_tensor(r["tokens"])[None],
                                 "frames": torch.as_tensor(r["frames"])[None]},
                     steps=r["max_new"], max_len=max_len,
                     device="cuda")[0].cpu() for r in reqs]
    lone_rows = [_first_step_logits(view, cfg, r, max_len) for r in reqs]
    log(f"seamless: {len(reqs)} lone generates "
        f"{time.perf_counter() - t0:.1f} s (sources "
        f"{sorted(len(r['frames']) for r in reqs)}, prompts "
        f"{sorted(len(r['tokens']) for r in reqs)})")
    plan = paged_attn.launch_plan(
        4, cfg.n_kv_heads, SM_NB, ENGINE_PAGE, cfg.resolved_head_dim,
        cfg.n_heads // cfg.n_kv_heads, window=None, itemsize=2,
        sms=build.sm_count(torch.device("cuda", 0)))
    variant = ("paged_attention_multipass" if plan["multipass"]
               else "paged_attention")
    launches = Counter()
    for kind, k, kw in (("paged", 0, dict(kv_pages=16)),
                        ("paged", 3, dict(kv_pages=16)),
                        ("slot", 0, {})):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(view, cfg, capacity=4, max_len=max_len, src_len=SM_SRC,
                     page_size=ENGINE_PAGE, speculative=k, draft_bits=3,
                     device="cuda", **kw)
        warm = time.perf_counter() - t0
        _reset_counts()
        for r in reqs:
            eng.submit(r["tokens"], max_new=r["max_new"], frames=r["frames"])
        rows, werr = {}, None
        while not eng.idle:  # run(), a step at a time
            held = {q.rid for q in eng.slots if q is not None}
            eng.step()
            for i, q in enumerate(eng.slots):
                if not k and q is not None and q.rid not in held:
                    # admitted this step: the step decoded its first token
                    rows[q.rid] = eng.logits[i, -1].clone()
            if (kind == "paged" and not k and werr is None
                    and None not in eng.slots):
                werr = _paged_window_check(view, cfg, eng)
        res = [eng.results[rid] for rid in sorted(eng.results)]
        torch.cuda.synchronize()
        st, counts = eng.stats(), _read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        same = [torch.equal(torch.as_tensor(r["tokens"]), want)
                for r, want in zip(res, lone)]
        n = len(reqs)
        errs = [_rel(rows[i], lone_rows[i]) for i in sorted(rows)]
        apart = [_rel(rows[i], lone_rows[(i + 1) % n]) for i in sorted(rows)]
        distinct = [len(set(r["tokens"].tolist())) for r in res]
        steps = st["spec_rounds"] if k else st["decode_steps"]
        paged = kind == "paged"
        per = cfg.n_layers * (2 * k + 1) if paged else 0
        log(f"seamless {kind} engine{f' speculative k={k}' if k else ''} "
            f"(G = 1, dh 64, bf16 pages): {st['completed']} requests, "
            f"{steps} {'rounds' if k else 'steps'}, decode "
            f"{st['decode_tok_s']:.1f} tok/s, goodput "
            f"{st['goodput_tok_s']:.1f} tok/s, prefill "
            f"{st['t_prefill_s']:.2f} s, warmup {warm:.2f} s, "
            + (f"acceptance {st['acceptance_rate']:.3f}, " if k else "")
            + f"{variant} {counts[variant]} (plan: {plan['nsplit']} splits "
            f"of {plan['chunk']}), peak {peak:.2f} GiB"
            + (f", graph pools {_graph_pools(eng)}" if paged else "")
            + f" | equal to lone generates {same}, distinct tokens a "
            f"request {distinct}"
            + (f" | first-step logits vs alone max {max(errs):.3e}, vs the "
               f"next request's min {min(apart):.3e}" if rows else "")
            + f" | {CARD}")
        check(st["paged"] is paged and len(res) == len(reqs),
              f"seamless {kind} engine: paged {st['paged']}, "
              f"{len(res)} results")
        check(all(same), f"seamless {kind} engine (k={k}): a request's "
              f"tokens differ from its lone generate")
        check(werr is not None or k or not paged, "seamless paged engine: "
              "no step had every slot live for the window check")
        if not k:
            check(len(rows) == n and max(errs) <= SM_LOGIT_TOL,
                  f"seamless {kind} engine: {len(rows)} first-step rows of "
                  f"{n}, max {max(errs):.3e} from alone (tol "
                  f"{SM_LOGIT_TOL:g})")
            check(min(apart) >= SM_LOGIT_APART, f"seamless {kind} engine: "
                  f"a request's first-step logits lie within "
                  f"{min(apart):.3e} of another's")
        check(counts[variant] == per * steps and counts["plain"] == 0,
              f"seamless {kind} engine: {counts[variant]} {variant} "
              f"launches for {steps} steps of {per}, plain "
              f"{counts['plain']}")
        launches.update({kk: v for kk, v in counts.items() if v})
        del eng
        torch.cuda.empty_cache()
    return launches


def seamless_full_width():
    """Phase 3p: seamless-m4t-medium at full width (SM_LAYERS of its 12
    encoder and of its 12 decoder layers, d_model 1024, 16 / 16 heads of
    64, d_ff 4096, vocab 256206 tied, its 4-bit pow2 LUT-Q, 8-bit
    activations; random weights from seed 0, 128 seeded frames a row): (b) int8 and packed4
    generate (B=4, prompt 128, 16 tokens), graph and eager, with each
    kernel's launches a forward (a prefill 7 products an encoder layer,
    11 a decoder layer, a decode step 9 a decoder layer, and the tied
    head: kernel 1 in int8, the decode backend in packed4), the head's
    share of a replayed step and the graph pools; the calibrated
    serving_pow2 view the same on lutq_shift (the head float); (c) its
    audit (a 20-token prefill over 20 frames, one decode step); (d) the
    engines at act_bits 32; (e) reduced seamless card vs CPU. Returns
    {kernel: launches} of (b)'s graph-mode generates and (d)."""
    from collections import Counter

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.policy import serve_view
    from repro_torch.core.rules import serving_pow2
    from repro_torch.models import api
    from repro_torch.models.reduce import reduced

    t_phase = time.perf_counter()
    base = get_config(SM_ARCH).replace(n_layers=SM_LAYERS,
                                       enc_layers=SM_LAYERS)
    E, L = base.enc_layers, base.n_layers
    p, d = 7 * E + 11 * L, 9 * L  # body products: prefill, decode step
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, base.vocab, (BATCH, PROMPT), generator=gen)
    frames = torch.randn((BATCH, SM_SRC, base.d_model), generator=gen)
    launches, shares, parts = Counter(), {}, {}
    t0 = time.perf_counter()
    model = api.quantize(api.init(base, seed=0, device="cuda"), base)
    policy = api.resolved_policy(base)
    torch.cuda.synchronize()
    log(f"seamless {base.name} ({E} + {L} layers, d_model {base.d_model}, "
        f"{base.n_heads} / {base.n_kv_heads} heads of "
        f"{base.resolved_head_dim}, d_ff {base.d_ff}, vocab {base.vocab} "
        f"tied): init + quantize {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated | {CARD}")
    views = {"int8": serve_view(model, policy=policy),
             "packed4": serve_view(model, pack4=True, policy=policy)}
    del model
    torch.cuda.empty_cache()
    t8 = views["int8"].embed.table.state.a
    t4 = views["packed4"].embed.table.state.a
    check(t8.shape == (base.vocab, base.d_model) and t8.dtype == torch.int8
          and t4.shape == (base.vocab // 2, base.d_model)
          and t4.dtype == torch.uint8 and len(views["int8"].encoder) == E
          and len(views["int8"].decoder) == L,
          "seamless: the tied table or the stacks are not as expected")
    for name, expect in (
            ("int8", {"lutq_matmul": (p + 1, d + 1)}),
            ("packed4", {"lutq_gemv_packed": (p, d), "decode": 1})):
        _, counts = _family_serve("seamless", name, views[name], base, toks,
                                  expect, frames=frames)
        for kname in expect:
            if kname != "decode":
                launches[kname] += counts[kname]
        shares[name] = _head_share("seamless", name, views[name], base,
                                   {"tokens": toks, "frames": frames},
                                   PROMPT + 2, src_len=SM_SRC)
        _decode_logits_checks(name, views[name], base, toks, frames)
    parts["int8 + packed4"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches.update(_seamless_engines(views["packed4"],
                                      base.replace(act_bits=32)))
    parts["engines"] = time.perf_counter() - t0
    del views
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg = base.replace(quant=serving_pow2())
    cgen = torch.Generator().manual_seed(2)
    calib = {"tokens": torch.randint(0, cfg.vocab, (CALIB_BATCH, CALIB_LEN),
                                     generator=cgen).cuda(),
             "frames": torch.randn((CALIB_BATCH, CALIB_LEN, cfg.d_model),
                                   generator=cgen).cuda()}
    view = api.serve_state(cfg, seed=0, device="cuda", calib_batch=calib)
    torch.cuda.synchronize()
    xq = view.decoder[0].xattn.q.kernel.state
    check(xq.d.dtype == torch.int8 and xq.act is not None
          and view.embed.table.dtype == torch.float32,
          "serving_pow2: the cross-attention leaves are not pow2-encoded "
          "with frozen pairs, or the tied table is not float")
    log(f"seamless serving_pow2: serve_state (init, quantize, calibrate on "
        f"{CALIB_BATCH} x {CALIB_LEN} tokens and frames, serve_view) "
        f"{time.perf_counter() - t0:.1f} s")
    _, counts = _family_serve("seamless", "serving_pow2", view, cfg, toks,
                              {"lutq_shift": (p, d)}, frames=frames)
    launches["lutq_shift"] += counts["lutq_shift"]
    shares["serving_pow2"] = _head_share(
        "seamless", "serving_pow2", view, cfg,
        {"tokens": toks, "frames": frames}, PROMPT + 2, src_len=SM_SRC)
    _decode_logits_checks("serving_pow2", view, cfg, toks, frames)
    _family_audit("seamless", view, cfg, toks, SM_AUDIT, {"lutq_shift": p},
                  {"lutq_shift": d}, frames=frames)
    del view
    torch.cuda.empty_cache()
    parts["serving_pow2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _reduced_card_vs_cpu("seamless", reduced(get_config(SM_ARCH)).replace(
        act_bits=32))
    parts["reduced"] = time.perf_counter() - t0
    log(f"phase 3p {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items())
        + ") | launches "
        f"{dict(launches)} | head ms, step ms, step / head graph pool MiB "
        f"{ {k: tuple(round(x, 4) for x in v) for k, v in shares.items()} }")
    return dict(launches)


# ---------------------------------------------------------------------------
# phases 2q and 3q: the vlm family (paligemma-3b)
# ---------------------------------------------------------------------------

PG_ARCH = "paligemma-3b"
#: paligemma's (Kin, N) of its body products: q and o (2048 x 2048), k
#: and v (one KV head of 256: 2048 x 256), wi / wg (2048 x 16384), wo
#: (16384 x 2048)
PG_LEAF_SHAPES = {"q/o": (2048, 2048), "k/v": (2048, 256),
                  "wi/wg": (2048, 16384), "wo": (16384, 2048)}
#: the tied readout's assignments as the int8 view's head reads them,
#: transposed: (Kin 2048, N 257216), a partial n tile of 64 at 128
PG_HEAD = (2048, 257216)
#: the tied table's entries: 526.8 M float32 masters, 2.107 GB, the
#: first leaf whose float32 bytes pass 2^31
PG_TABLE = 257216 * 2048
PG_REPEAT_CASES = [(4, 2048, 2048), (512, 2048, 16384), (4, 16384, 2048),
                   (4, 2048, 257216)]
#: phase 3q's depth: 2 of paligemma's 18 layers (the width whole; the
#: script's 1200 s limit leaves the phase ~60 s)
PG_LAYERS = 2
#: the image prefix a row (the config's n_prefix_tokens), the engine
#: queue (synthetic_requests, seed 0: prompts of 32-128 tokens, up to 32
#: new tokens; every third request text-only), the audited prefill's
#: text (B x (256 + 20) rows: no activation of a quantized leaf's 256,
#: 2048 or 16384 rows)
PG_PFX, PG_QUEUE, PG_MAX_NEW, PG_AUDIT = 256, 12, 32, 20
#: phase 3q (e): the trainer's batch, sequence and steps (the vocab kept)
PG_TRAIN_BATCH, PG_TRAIN_SEQ, PG_TRAIN_STEPS = 2, 128, 3
#: phases 3q's, 3r's and 3s's logits checks at act_bits 32, max |a - b| over
#: the reference row's max |logit| (a decode step against a prefill one
#: token longer, an engine row's first step against its request's alone,
#: a W = 4 window against chained steps), a layer, by family: bf16
#: activations and f32 sums in other orders (other GEMM tiles; zamba's
#: chunked scan beside its recurrence) put the two apart by an amount
#: that grows with depth. On an H100: paligemma 5.0e-4 at 2 layers,
#: 4.7e-3 at 18; zamba 3.8e-4 at 6, 9.5e-4 at 12, 4.9e-3 at 54. Twice
#: that at serving_pow2's frozen 8-bit scales (paligemma 1.5e-3 at 2
#: layers; zamba 0 at 6 and 12, 1.1e-2 at 54). zamba's rate is set
#: by its control (CONTROL_APART): zeroing the recurrent state moved
#: serving_pow2's step by only 2.2e-2 at 6 layers, inside 2e-3 a
#: layer's 8-bit tolerance (2.4e-2). The depth counted stops at
#: LOGIT_TOL_DEPTH, the deepest run measured against paligemma's rate:
#: deeper runs keep 18 layers' tolerance (zamba at 54: 1.8e-2, 3.7x
#: what it measured)
LOGIT_TOL_LAYER = {"vlm": 2e-3, "hybrid": 1e-3}
LOGIT_TOL_DEPTH = 18
#: the same for a family whose body runs in f32 (ssm: the residual
#: stream and every product's activations), whatever its depth: its step
#: and prefill part where the bf16 logits round, by one bf16 ulp of the
#: row's largest logit at most (2^-7 of it). On an H100: rwkv 4.2e-3 at
#: 4 layers, 3.6e-3 at 24 (int8 and packed4 alike), 0 in serving_pow2
LOGIT_TOL_FLAT = {"ssm": 2.0 ** -7}
#: the least distance, over the tolerance, that a control must put
#: between a decode step's logits and the same step's on the true cache
#: (through one path, so nothing else moves them), so that a step that
#: lost what the control takes away fails the check against the
#: prefill: phase 3q zeroes the image prefix (the random model's last
#: token leans on its own residual: an H100 measured 1.3e-2 at 2 layers,
#: 0.12 at 18), phase 3r every SSM state and conv window (2.6e-2 at 6
#: layers, 2.2e-2 in serving_pow2; 0.14 at 54), phase 3s every WKV state
#: and token-shift row (1.46 at 4 layers, 1.25 at 24; 1.38 in
#: serving_pow2 at 24)
CONTROL_APART = 1.25


def _logit_tol(cfg) -> float:
    """Phases 3q's, 3r's and 3s's logits tolerance at ``cfg``'s family,
    depth and act_bits."""
    tol = LOGIT_TOL_FLAT.get(cfg.family) or LOGIT_TOL_LAYER[cfg.family] \
        * min(cfg.n_layers, LOGIT_TOL_DEPTH)
    return tol if cfg.act_bits == 32 else 2 * tol


def _kmeans_table_check(gen, dev):
    """Phase 2q: kmeans_stats on a leaf of the tied table's 526.8 M
    float32 weights (2.107 GB: byte offsets past 2^31), aligned and 3
    elements into a buffer, against its plain version: assignments bit
    for bit, counts equal, sums within KMEANS_SUM_TOL of sum|w| an
    entry; a second call the same bits, write_a=False the same sums;
    one call timed with CUDA events beside its byte bound. Returns the
    largest |sums - plain sums|."""
    import torch

    from repro_torch.kernels import build, kmeans_stats as km
    from repro_torch.kernels.ref import kmeans_stats_ref

    worst = 0.0
    for off in (0, 3):
        t0 = time.perf_counter()
        buf = torch.randn(PG_TABLE + off, generator=gen, device=dev) * 0.02
        w = buf[off:]
        d = _pow2_dict(w, 16)
        before = dict(km.COUNTS)
        a, sums, counts = km.kmeans_stats(w, d)
        again = km.kmeans_stats(w, d)
        no_a = km.kmeans_stats(w, d, write_a=False)
        calls = km.COUNTS["launches"] - before["launches"]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        km.kmeans_stats(w, d)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        a0, s0, c0 = kmeans_stats_ref(w, d)
        torch.cuda.synchronize()
        n_bad = int((a != a0).sum())
        mag = torch.zeros(16, dtype=torch.float64, device=dev).index_add_(
            0, a0.view(torch.uint8).long(), w.abs().double()).float()
        err = (sums - s0).abs()
        same = (torch.equal(a, again[0]) and torch.equal(sums, again[1])
                and torch.equal(counts, again[2]) and no_a[0] is None
                and torch.equal(no_a[1], sums)
                and torch.equal(no_a[2], counts))
        bound = (w.numel() * 4 + w.numel()) / HBM_BYTES_PER_S * 1e3
        p = km.plan(w.numel(), 16, build.sm_count(dev),
                    (w.data_ptr() // 4) % 4)
        log(f"check kmeans_stats paligemma table N={w.numel()} K=16 "
            f"offset {off} ({w.numel() * 4 / 1e9:.3f} GB float32): "
            f"assignments differing {n_bad}, counts equal "
            f"{bool(torch.equal(counts, c0))} (largest {int(c0.max())}), "
            f"sums max err {err.max().item():.3e} "
            f"({(err / mag.clamp(min=1e-30)).max().item():.2e} of sum|w|, "
            f"tol {KMEANS_SUM_TOL:.0e}), repeat / write_a=False "
            f"{'same' if same else 'DIFFERENT'}, {calls} launches for 3 "
            f"calls, {km.COUNTS['plain'] - before['plain']} plain; one call "
            f"{ms:.3f} ms against a {bound:.3f} ms byte bound "
            f"({bound / ms * 100:.1f}%; plan {p['blocks']} blocks, head "
            f"{p['head']} tail {p['tail']}) in "
            f"{time.perf_counter() - t0:.1f} s | {CARD}")
        check(n_bad == 0 and bool(torch.equal(counts, c0)),
              f"kmeans_stats on the paligemma table (offset {off}): "
              f"{n_bad} assignments differ or the counts do")
        check(bool((err <= KMEANS_SUM_TOL * mag).all()),
              f"kmeans_stats sums off on the paligemma table (offset {off})")
        check(same and calls == 3, f"kmeans_stats on the paligemma table: "
              f"repeats differ or {calls} launches for 3 calls")
        worst = max(worst, err.max().item())
        del buf, w, a, a0, again, no_a, mag
        torch.cuda.empty_cache()
    return worst


def paligemma_kernel_checks():
    """Phase 2q: kernels 1, 2 and 4 at paligemma's body shapes and M in
    SM_CHECK_M against their plain versions (bf16 and f32 x, phase 2's
    tolerances; lutq_shift bit for bit), kernel 1 and lutq_shift on the
    transposed tied head (N = 257216), second-call and graph bits; then
    kmeans_stats on the 526.8 M-weight table (``_kmeans_table_check``).
    Returns {kernel: max abs err}."""
    import torch

    from repro_torch.kernels.lutq_shift import lutq_shift
    from repro_torch.kernels.ref import lutq_shift_ref, shift_planes

    t0 = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(43)
    worst = {}
    shapes = [(label, shape, SM_CHECK_M)
              for label, shape in PG_LEAF_SHAPES.items()]
    head = [("head", PG_HEAD, SM_HEAD_M)]
    for kname, (fn, plain) in _gemm_fns().items():
        packed = KERNELS[kname]["packed"]
        worst[kname] = 0.0
        # the packed view's head is the decode backend: kernel 1 only
        for label, (Kin, N), ms in shapes + ([] if packed else head):
            for M in ms:
                for dtype in (torch.bfloat16, torch.float32):
                    x, a, d = _operands(M, Kin, N, 16, dtype, gen, dev,
                                        packed)
                    got = fn(x, a, d)
                    want = plain(x, a, d)
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    rel = err / max(want.abs().max().item(), 1e-30)
                    dname = str(dtype).split(".")[-1]
                    log(f"check {kname} paligemma {label} M={M} Kin={Kin} "
                        f"N={N} {dname}: max_abs_err {err:.3e} rel "
                        f"{rel:.2e} (tol {TOL[dname]:.0e})")
                    check(bool(torch.isfinite(got).all()),
                          f"{kname} produced non-finite values")
                    check(rel <= TOL[dname], f"{kname} disagrees with its "
                          f"plain version at paligemma {label} M={M} "
                          f"{dname}")
                    worst[kname] = max(worst[kname], err)
                    del x, a, d, got, want
        _gemm_repeats(kname, fn, gen, dev, PG_REPEAT_CASES)
    worst["lutq_shift"] = 0.0
    for label, (Kin, N), ms in shapes + head:
        for M in ms:
            xq, a, wsh = _shift_operands(M, Kin, N, 16, gen, dev, span=9)
            planes = shift_planes(wsh)
            got = lutq_shift(xq, a, wsh, planes)
            again = lutq_shift(xq, a, wsh, planes)
            want = lutq_shift_ref(xq, a, wsh)
            torch.cuda.synchronize()
            log(f"check lutq_shift paligemma {label} M={M} Kin={Kin} "
                f"N={N}: equal {bool(torch.equal(got, want))}, second call "
                f"{'same' if torch.equal(got, again) else 'DIFFERENT'} "
                f"bits")
            check(torch.equal(got, want) and torch.equal(got, again),
                  f"lutq_shift differs from its plain version or itself at "
                  f"paligemma {label} M={M}")
            del xq, a, got, again, want
    log(f"phase 2q (kernels 1, 2, 4 at paligemma's leaves and head) "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    worst["kmeans_stats"] = _kmeans_table_check(gen, dev)
    log(f"phase 2q (kernel 3 on the 526.8 M-weight table) "
        f"{time.perf_counter() - t0:.1f} s")
    return worst


def _pg_batch(toks, prefix):
    """A generate / prefill batch on the card, the prefix if given."""
    batch = {"tokens": toks.cuda()}
    if prefix is not None:
        batch["prefix_embeds"] = prefix.cuda()
    return batch


def _pg_logits_checks(name, view, cfg, toks, prefix):
    """Phase 3q (b): one decode step's logits (B=4, after the prefix and
    a 127-token prefill) replayed from a CUDA graph are the eager step's
    bits and lie within ``_logit_tol`` of a 128-token prefill's last
    logits; the same step after a zeroed prefix lies CONTROL_APART
    times the act_bits-32 tolerance or more from the step's; a W = 4
    window equals 4 chained steps within the tolerance. int8 and
    packed4 at act_bits 32 (8-bit dynamic scales couple a batch's rows),
    serving_pow2 at its frozen scales."""
    import torch

    from repro_torch.models import api
    from repro_torch.runtime import serving

    if name != "serving_pow2":
        cfg = cfg.replace(act_bits=32)
    tol = _logit_tol(cfg)
    apart = CONTROL_APART * _logit_tol(cfg.replace(act_bits=32))
    toks, prefix = toks.cuda(), prefix.cuda()
    P = toks.shape[1] - 1
    width = PG_PFX + P + 5
    with torch.inference_mode():
        want, _ = api.prefill(view, cfg, _pg_batch(toks, prefix))
        _, cache = api.prefill(view, cfg, _pg_batch(toks[:, :P], prefix))
        cache = serving.adapt_prefill_cache(cfg, cache, BATCH, width)
        snap = _clone_tree(cache)
        _, zeroed = api.prefill(view, cfg, _pg_batch(toks[:, :P],
                                                     torch.zeros_like(prefix)))
        zeroed = serving.adapt_prefill_cache(cfg, zeroed, BATCH, width)
        tok = toks[:, P:].to(torch.int32).contiguous()

        def step():
            return api.decode_step(view, cfg, tok, cache)[0]
        eager = step().clone()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            step()
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = step()
        graph.replay()
        torch.cuda.synchronize()
        replayed = out.clone()
        del graph
        masked = api.decode_step(view, cfg, tok, zeroed)[0]
        gen = torch.Generator(device="cuda").manual_seed(3)
        win = torch.cat([tok, torch.randint(0, cfg.vocab, (BATCH, 3),
                                            generator=gen, device="cuda",
                                            dtype=torch.int32)], dim=1)
        window = api.decode_window(view, cfg, win, _clone_tree(snap))[0]
        c, chained = _clone_tree(snap), []
        for j in range(4):
            lg, c = api.decode_step(view, cfg, win[:, j:j + 1], c)
            chained.append(lg)
        chained = torch.cat(chained, dim=1)
    err, moved = _rel(eager, want), _rel(masked, eager)
    werr = _rel(window, chained)
    log(f"  paligemma [{name}] logits (act_bits {cfg.act_bits}): graph step "
        f"= eager step bits {bool(torch.equal(replayed, eager))}; decode "
        f"step vs prefill {err:.3e}, after a zeroed prefix {moved:.3e} "
        f"(tol {tol:g}, apart >= {apart:g}); W=4 window vs 4 "
        f"chained steps {werr:.3e} (bits "
        f"{bool(torch.equal(window, chained))}); greedy tokens "
        f"{want[:, -1].argmax(-1).tolist()} | {CARD}")
    check(torch.equal(replayed, eager), f"paligemma {name}: a replayed "
          f"decode step's logits are not the eager step's")
    check(err <= tol, f"paligemma {name}: decode step logits {err:.3e} "
          f"from the prefill's (tol {tol:g})")
    check(moved >= apart, f"paligemma {name}: zeroing the prefix moved "
          f"the logits by only {moved:.3e}")
    check(werr <= tol, f"paligemma {name}: a W=4 window's logits "
          f"{werr:.3e} from 4 chained steps' (tol {tol:g})")


def _pg_engines(view, cfg):
    """Phase 3q (d): at act_bits 32, synthetic_requests(seed=0) (12
    requests, every third text-only) through a 4-slot engine asked for
    pages (a vlm engine keeps its slot pool: ``paged`` False) and its
    speculative twin (k = 3, draft_bits 3): every request's tokens equal
    its lone generate; in the plain engine each request's first decode
    step's logits row lies within ``_logit_tol`` of its lone first step's
    and SM_LOGIT_APART from the next request's; no plain version.
    Returns {kernel: launches}."""
    from collections import Counter

    import torch

    from repro_torch.runtime.engine import Engine, synthetic_requests
    from repro_torch.runtime.serving import generate

    reqs = synthetic_requests(cfg, PG_QUEUE, max_prompt=PROMPT,
                              max_new=PG_MAX_NEW, seed=0)
    for i in range(1, PG_QUEUE, 3):
        del reqs[i]["prefix_embeds"]
    max_len = PROMPT + PG_MAX_NEW + 3
    t0 = time.perf_counter()
    lone, lone_rows = [], []
    for r in reqs:
        batch = {"tokens": torch.as_tensor(r["tokens"])[None]}
        if "prefix_embeds" in r:
            batch["prefix_embeds"] = torch.as_tensor(r["prefix_embeds"])[None]
        lone.append(generate(view, cfg, batch, steps=r["max_new"],
                             max_len=max_len, device="cuda")[0].cpu())
        lone_rows.append(_first_step_logits(view, cfg, r, max_len + PG_PFX))
    log(f"paligemma: {len(reqs)} lone generates "
        f"{time.perf_counter() - t0:.1f} s (prompts "
        f"{sorted(len(r['tokens']) for r in reqs)}, "
        f"{sum('prefix_embeds' in r for r in reqs)} with a prefix)")
    launches = Counter()
    for k in (0, 3):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(view, cfg, capacity=4, max_len=max_len, kv_pages=16,
                     page_size=ENGINE_PAGE, speculative=k, draft_bits=3,
                     device="cuda")
        _reset_counts()
        for r in reqs:
            eng.submit(r["tokens"], max_new=r["max_new"],
                       prefix_embeds=r.get("prefix_embeds"))
        rows = {}
        while not eng.idle:  # run(), a step at a time
            held = {q.rid for q in eng.slots if q is not None}
            eng.step()
            for i, q in enumerate(eng.slots):
                if not k and q is not None and q.rid not in held:
                    # admitted this step: the step decoded its first token
                    rows[q.rid] = eng.logits[i, -1].clone()
        res = [eng.results[rid] for rid in sorted(eng.results)]
        torch.cuda.synchronize()
        st, counts = eng.stats(), _read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        same = [torch.equal(torch.as_tensor(r["tokens"]), want)
                for r, want in zip(res, lone)]
        n = len(reqs)
        errs = [_rel(rows[i], lone_rows[i]) for i in sorted(rows)]
        apart = [_rel(rows[i], lone_rows[(i + 1) % n]) for i in sorted(rows)]
        distinct = [len(set(r["tokens"].tolist())) for r in res]
        steps = st["spec_rounds"] if k else st["decode_steps"]
        log(f"paligemma slot engine{f' speculative k={k}' if k else ''} "
            f"(kv_pages asked, paged {st['paged']}): {st['completed']} "
            f"requests, {steps} {'rounds' if k else 'steps'}, decode "
            f"{st['decode_tok_s']:.1f} tok/s, goodput "
            f"{st['goodput_tok_s']:.1f} tok/s, prefill "
            f"{st['t_prefill_s']:.2f} s, wall {time.perf_counter() - t0:.2f}"
            f" s, " + (f"acceptance {st['acceptance_rate']:.3f}, " if k
                       else "")
            + f"peak {peak:.2f} GiB | launches "
            f"{ {kk: v for kk, v in counts.items() if v} } | equal to lone "
            f"generates {same}, distinct tokens a request {distinct}"
            + (f" | first-step logits vs alone max {max(errs):.3e}, vs the "
               f"next request's min {min(apart):.3e}" if rows else "")
            + f" | {CARD}")
        check(st["paged"] is False and len(res) == n
              and st["max_len"] == max_len + PG_PFX,
              f"paligemma engine: paged {st['paged']}, {len(res)} results, "
              f"max_len {st['max_len']}")
        check(all(same), f"paligemma engine (k={k}): a request's tokens "
              f"differ from its lone generate")
        check(counts["plain"] == 0, f"paligemma engine ran plain versions: "
              f"{counts}")
        if not k:
            check(len(rows) == n and max(errs) <= _logit_tol(cfg),
                  f"paligemma engine: {len(rows)} first-step rows of {n}, "
                  f"max {max(errs):.3e} from alone (tol {_logit_tol(cfg):g})")
            check(min(apart) >= SM_LOGIT_APART, f"paligemma engine: a "
                  f"request's first-step logits lie within "
                  f"{min(apart):.3e} of another's")
        launches.update({kk: v for kk, v in counts.items() if v})
        del eng
        torch.cuda.empty_cache()
    return launches


def _family_train(arch, cut, steps, batch, seq, *, check_build=None,
                  check_batch=None, profile=False):
    """A family's trainer at full width: launch/train.build at ``cut``
    (config fields replaced, the depth) with the vocab kept and the CLI's
    4-bit pow2 spec, TrainLoop over batch_fn's batches (a vlm one's with
    its prefix, an encdec one's with frames) for ``steps`` steps of
    ``batch`` x ``seq``: finite losses, kmeans_stats (kmeans_iters + 1)
    times a step for each leaf of 2^16 weights or more (the smaller run
    dense k-means, as in the reference), no plain version; ms a step and
    peak memory. ``check_build(cfg, state, leaves)`` and
    ``check_batch(cfg, batch)`` add a family's checks; ``profile`` runs
    one more step under the profiler (device-idle share). Returns the
    kmeans_stats launches of the ``steps`` steps."""
    import torch

    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.kernels import kmeans_stats
    from repro_torch.launch import train as train_cli
    from repro_torch.models import api
    from repro_torch.runtime.loop import TrainLoop

    args = _train_args("--steps", str(steps + int(profile)), "--batch",
                       str(batch), "--seq", str(seq), "--vocab", "0",
                       "--device", "cuda", arch=arch)
    t0 = time.perf_counter()
    full = train_cli._train_cfg
    train_cli._train_cfg = lambda a: full(a).replace(**cut)
    try:
        cfg, state, step_fn = train_cli.build(args)
    finally:
        train_cli._train_cfg = full
    torch.cuda.synchronize()
    leaves = _leaves(state.model)
    big = [n for n, m in leaves if m.w.numel() >= 1 << 16]
    per_step = (cfg.quant.kmeans_iters + 1) * len(big)
    if check_build is not None:
        check_build(cfg, state, leaves)
    log(f"{arch} train: build (init + quantize; {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, vocab {cfg.vocab}, {len(leaves)} leaves, "
        f"{len(big)} of 2^16 weights or more) "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    launches = []

    def counted_step(st, b):
        before = kmeans_stats.COUNTS["launches"]
        out = step_fn(st, b)
        launches.append(kmeans_stats.COUNTS["launches"] - before)
        return out

    make_batch = train_cli.batch_fn(MarkovLM(cfg.vocab, seed=args.data_seed),
                                    args, args.device, cfg)
    if check_batch is not None:
        check_batch(cfg, make_batch(0))
    loop = TrainLoop(counted_step, make_batch, log_every=1, log_fn=log,
                     quant_policy=api.resolved_policy(cfg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    state, step = loop.run(state, steps, handle_signals=False)
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = [h["dt"] * 1e3 for h in loop.history]
    losses = [h["loss"] for h in loop.history]
    log(f"{arch} train {cfg.n_layers} layers B={batch} x {seq}: ms "
        f"{['%.1f' % t for t in ms]} | loss {['%.4f' % x for x in losses]}"
        f" | peak {peak:.2f} GiB | kmeans_stats a step {launches} "
        f"(expected {per_step}), plain {counts['plain']} | {CARD}")
    check(step == steps and all(math.isfinite(x) for x in losses),
          f"{arch} train: {step} steps, losses {losses}")
    check(launches == [per_step] * steps and counts["plain"] == 0,
          f"{arch} train: kmeans_stats {launches} a step, plain "
          f"{counts['plain']}")
    if profile:
        b = make_batch(steps)

        def one_step():
            step_fn(state, b)
            torch.cuda.synchronize()

        profile_run(one_step, f"one {arch} training step")
        del b
    out = counts["kmeans_stats"]
    del state, loop, step_fn, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _pg_train(base):
    """Phase 3q (e): the trainer at PG_LAYERS layers for PG_TRAIN_STEPS
    steps of B = PG_TRAIN_BATCH x (256 + PG_TRAIN_SEQ) (``_family_train``),
    the 526.8 M-entry table among the leaves, each batch with its
    prefix. Returns the kmeans_stats launches."""

    def check_build(cfg, state, leaves):
        table = state.model.embed.table.w
        check((cfg.n_layers, cfg.vocab, cfg.n_prefix_tokens, len(leaves),
               table.numel()) == (base.n_layers, 257216, PG_PFX,
                                  7 * base.n_layers + 1, PG_TABLE),
              f"paligemma trainer: {cfg.n_layers} layers, vocab {cfg.vocab},"
              f" {len(leaves)} leaves, table {table.numel()}")

    def check_batch(cfg, batch):
        check(batch["prefix_embeds"].shape
              == (PG_TRAIN_BATCH, PG_PFX, cfg.d_model),
              "paligemma trainer: the batch has no prefix")

    return _family_train(PG_ARCH, dict(n_layers=base.n_layers),
                         PG_TRAIN_STEPS, PG_TRAIN_BATCH, PG_TRAIN_SEQ,
                         check_build=check_build, check_batch=check_batch)


def paligemma_full_width():
    """Phase 3q: paligemma-3b at full width (PG_LAYERS of its 18 layers,
    d_model 2048, 8 / 1 heads of 256, d_ff 16384, vocab 257216 tied, its
    4-bit pow2 LUT-Q, 8-bit activations; random weights from seed 0, a
    256-row seeded image prefix a row): (b) int8 and packed4 generate
    (B=4, prompt 128, 16 tokens), graph and eager, with each kernel's
    launches a forward (7 a layer, and the tied head: kernel 1 in int8,
    the decode backend in packed4), the head's share of a replayed step,
    the graph pools and the logits checks; the calibrated serving_pow2
    view the same on lutq_shift (the head float); (c) its audit (a
    prefill of the prefix and 20 tokens, one decode step); (d) the slot
    engine at act_bits 32; (e) training; (f) reduced paligemma card vs
    CPU. Returns {kernel: launches} of (b)'s graph-mode generates, (d)
    and (e)."""
    from collections import Counter

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.policy import serve_view
    from repro_torch.core.rules import serving_pow2
    from repro_torch.models import api
    from repro_torch.models.reduce import reduced

    t_phase = time.perf_counter()
    base = get_config(PG_ARCH).replace(n_layers=PG_LAYERS)
    L = base.n_layers
    p = 7 * L  # body products a forward
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, base.vocab, (BATCH, PROMPT), generator=gen)
    prefix = torch.randn((BATCH, PG_PFX, base.d_model), generator=gen)
    launches, shares, parts = Counter(), {}, {}
    t0 = time.perf_counter()
    model = api.quantize(api.init(base, seed=0, device="cuda"), base)
    policy = api.resolved_policy(base)
    torch.cuda.synchronize()
    log(f"paligemma {base.name} ({L} layers, d_model {base.d_model}, "
        f"{base.n_heads} / {base.n_kv_heads} heads of "
        f"{base.resolved_head_dim}, d_ff {base.d_ff}, vocab {base.vocab} "
        f"tied, prefix {base.n_prefix_tokens}): init + quantize "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated | {CARD}")
    views = {"int8": serve_view(model, policy=policy),
             "packed4": serve_view(model, pack4=True, policy=policy)}
    del model
    torch.cuda.empty_cache()
    t8 = views["int8"].embed.table.state.a
    t4 = views["packed4"].embed.table.state.a
    check(t8.shape == (base.vocab, base.d_model) and t8.dtype == torch.int8
          and t4.shape == (base.vocab // 2, base.d_model)
          and t4.dtype == torch.uint8 and len(views["int8"].layers) == L
          and not hasattr(views["int8"], "lm_head"),
          "paligemma: the tied table or the stack is not as expected")
    for name, expect in (("int8", {"lutq_matmul": p + 1}),
                         ("packed4", {"lutq_gemv_packed": p, "decode": 1})):
        _, counts = _family_serve("paligemma", name, views[name], base, toks,
                                  expect, prefix=prefix)
        for kname in expect:
            if kname != "decode":
                launches[kname] += counts[kname]
        shares[name] = _head_share(
            "paligemma", name, views[name], base,
            {"tokens": toks, "prefix_embeds": prefix}, PG_PFX + PROMPT + 2)
        _pg_logits_checks(name, views[name], base, toks, prefix)
    del views["packed4"]
    torch.cuda.empty_cache()
    parts["int8 + packed4"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches.update(_pg_engines(views["int8"], base.replace(act_bits=32)))
    parts["engines"] = time.perf_counter() - t0
    del views
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg = base.replace(quant=serving_pow2())
    cgen = torch.Generator().manual_seed(2)
    calib = {"tokens": torch.randint(0, cfg.vocab, (CALIB_BATCH, CALIB_LEN),
                                     generator=cgen).cuda(),
             "prefix_embeds": torch.randn((CALIB_BATCH, PG_PFX, cfg.d_model),
                                          generator=cgen).cuda()}
    view = api.serve_state(cfg, seed=0, device="cuda", calib_batch=calib)
    torch.cuda.synchronize()
    kq = view.layers[0].attn.k.kernel.state
    check(kq.d.dtype == torch.int8 and kq.act is not None
          and view.embed.table.dtype == torch.float32,
          "serving_pow2: k is not pow2-encoded with frozen pairs, or the "
          "tied table is not float")
    log(f"paligemma serving_pow2: serve_state (init, quantize, calibrate on "
        f"{CALIB_BATCH} x ({PG_PFX} + {CALIB_LEN}), serve_view) "
        f"{time.perf_counter() - t0:.1f} s")
    _, counts = _family_serve("paligemma", "serving_pow2", view, cfg, toks,
                              {"lutq_shift": p}, prefix=prefix)
    launches["lutq_shift"] += counts["lutq_shift"]
    shares["serving_pow2"] = _head_share(
        "paligemma", "serving_pow2", view, cfg,
        {"tokens": toks, "prefix_embeds": prefix}, PG_PFX + PROMPT + 2)
    _pg_logits_checks("serving_pow2", view, cfg, toks, prefix)
    _family_audit("paligemma", view, cfg, toks, PG_AUDIT, {"lutq_shift": p},
                  prefix=prefix)
    del view
    torch.cuda.empty_cache()
    parts["serving_pow2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches["kmeans_stats"] += _pg_train(base)
    parts["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _reduced_card_vs_cpu("paligemma", reduced(get_config(PG_ARCH)).replace(
        act_bits=32))
    parts["reduced"] = time.perf_counter() - t0
    log(f"phase 3q {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items())
        + ") | launches "
        f"{dict(launches)} | head ms, step ms, step / head graph pool MiB "
        f"{ {k: tuple(round(x, 4) for x in v) for k, v in shares.items()} }")
    return dict(launches)


# ---------------------------------------------------------------------------
# phases 2r and 3r: zamba2-2.7b, the hybrid family (Mamba2 state updated
# in place under the slot engine's CUDA graphs)
# ---------------------------------------------------------------------------

ZB_ARCH = "zamba2-2.7b"
#: zamba's (Kin, N) products: in_proj (2 x 5120 + 2 x 64 + 80 = 10448,
#: no multiple of the 64-wide n tile), out_proj, the shared block's MLP
#: (its q, k, v and o are danube's q's 2560 x 2560, phase 2)
ZB_LEAF_SHAPES = {"in_proj": (2560, 10448), "out_proj": (5120, 2560),
                  "wi/wg": (2560, 10240), "wo": (10240, 2560)}
ZB_CHECK_M = (1, 4, 9, 128, 256)
ZB_REPEAT_CASES = [(4, 2560, 10448), (256, 2560, 10448), (4, 5120, 2560)]
#: phase 3r's depth: 6 of zamba's 54 layers, one super-block (the width
#: whole). 12 layers (two super-blocks, the shared block twice over two
#: caches) took phase 3r 26.3 s and the script 1178.7 s of its 1200 on a
#: slow host; the reduced tests hold two applications
ZB_LAYERS = 6
#: phase 3r's second prompt: three SSD chunks of 128, the last padded
ZB_LONG = 300
#: the audited prefill's tokens (two chunks; no activation of a quantized
#: leaf's rows: 2560, 5120, 10240 or conv_w's 4)
ZB_AUDIT = 160
#: phases 3r's and 3s's engine queue (synthetic_requests, seed 0) and
#: its budget of new tokens
RECURRENT_QUEUE, RECURRENT_MAX_NEW = 12, 32


def _family_kernel_checks(label, shapes, ms, repeats, seed):
    """Kernels 1, 2 and 4 at a family's product shapes ({name: (Kin,
    N)}) and M in ``ms`` against their plain versions (bf16 and f32 x,
    phase 2's tolerances; lutq_shift bit for bit, with two replays of a
    captured call at M = 4 and 256), second-call and graph bits of the
    GEMMs at ``repeats``: phases 2r and 2s. Returns {kernel: max abs
    err}."""
    import torch

    from repro_torch.kernels.lutq_shift import lutq_shift
    from repro_torch.kernels.ref import lutq_shift_ref, shift_planes

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = {}
    for kname, (fn, plain) in _gemm_fns().items():
        packed = KERNELS[kname]["packed"]
        worst[kname] = 0.0
        for name, (Kin, N) in shapes.items():
            for M in ms:
                for dtype in (torch.bfloat16, torch.float32):
                    x, a, d = _operands(M, Kin, N, 16, dtype, gen, dev,
                                        packed)
                    got = fn(x, a, d)
                    want = plain(x, a, d)
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    rel = err / max(want.abs().max().item(), 1e-30)
                    dname = str(dtype).split(".")[-1]
                    log(f"check {kname} {label} {name} M={M} Kin={Kin} "
                        f"N={N} {dname}: max_abs_err {err:.3e} rel "
                        f"{rel:.2e} (tol {TOL[dname]:.0e})")
                    check(bool(torch.isfinite(got).all()),
                          f"{kname} produced non-finite values")
                    check(rel <= TOL[dname], f"{kname} disagrees with its "
                          f"plain version at {label} {name} M={M} {dname}")
                    worst[kname] = max(worst[kname], err)
                    del x, a, d, got, want
        _gemm_repeats(kname, fn, gen, dev, repeats)
    worst["lutq_shift"] = 0.0
    for name, (Kin, N) in shapes.items():
        for M in ms:
            xq, a, wsh = _shift_operands(M, Kin, N, 16, gen, dev, span=9)
            planes = shift_planes(wsh)
            got = lutq_shift(xq, a, wsh, planes)
            again = lutq_shift(xq, a, wsh, planes)
            want = lutq_shift_ref(xq, a, wsh)
            graph_same = True
            if M in (4, 256):
                stream = torch.cuda.Stream()
                stream.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(stream):
                    lutq_shift(xq, a, wsh, planes)
                torch.cuda.current_stream().wait_stream(stream)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    captured = lutq_shift(xq, a, wsh, planes)
                for _ in range(2):
                    captured.zero_()
                    graph.replay()
                    torch.cuda.synchronize()
                    graph_same &= torch.equal(captured, want)
                del graph
            torch.cuda.synchronize()
            log(f"check lutq_shift {label} {name} M={M} Kin={Kin} N={N}: "
                f"equal {bool(torch.equal(got, want))}, second call "
                f"{'same' if torch.equal(got, again) else 'DIFFERENT'} "
                f"bits" + (f", graph replays "
                           f"{'same' if graph_same else 'DIFFERENT'} bits"
                           if M in (4, 256) else ""))
            check(torch.equal(got, want) and torch.equal(got, again)
                  and graph_same, f"lutq_shift differs from its plain "
                  f"version or itself at {label} {name} M={M}")
            del xq, a, got, again, want
    return worst


def zamba_kernel_checks():
    """Phase 2r: kernels 1, 2 and 4 at zamba's product shapes
    (``_family_kernel_checks``). Returns {kernel: max abs err}."""
    t0 = time.perf_counter()
    worst = _family_kernel_checks("zamba", ZB_LEAF_SHAPES, ZB_CHECK_M,
                                  ZB_REPEAT_CASES, 44)
    log(f"phase 2r (kernels 1, 2, 4 at zamba's products) "
        f"{time.perf_counter() - t0:.1f} s")
    return worst


#: the recurrent leaves of a hybrid's (zamba: SSM state, conv window)
#: and an ssm's (rwkv: WKV state, token-shift rows) slot cache, which a
#: decode step overwrites in place
RECURRENT_KEYS = frozenset({"ssm", "conv", "wkv", "shift_t", "shift_c"})


def _recurrent_serves(label, name, view, cfg, prompts, expect):
    """Phases 3r and 3s (a), (b): ``_family_serve`` of one view after each
    prompt, each timed; the int8 view's 128-token graph serve is
    profiled (a profiled generate costs ~7 s at zamba's 12 layers, ~4 at
    6). Returns {kernel: launches} of the graph serves."""
    from collections import Counter

    launches = Counter()
    for plabel, toks in prompts.items():
        t0 = time.perf_counter()
        _, counts = _family_serve(f"{label} {plabel}", name, view, cfg,
                                  toks, expect, profile=(name, plabel) == (
                                      "int8", "P128"))
        launches.update({k: counts[k] for k in expect if k != "decode"})
        log(f"  {label} {plabel} [{name}] serves "
            f"{time.perf_counter() - t0:.1f} s")
    return launches


def _recurrent_head_share(label, name, view, cfg, toks):
    """Phases 3r and 3s: ``_head_share`` against a cache of a 128-token
    prompt, and the bytes of recurrent state (every RECURRENT_KEYS leaf
    of a B=4 cache) a decode step reads and writes back; returns (head
    ms, step ms, the step graph's pool MiB, the head graph's, state
    bytes a step)."""
    from repro_torch.models import api

    out = _head_share(label, name, view, cfg, {"tokens": toks}, PROMPT + 64)
    cache = api.init_cache(cfg, BATCH, 1, device="meta")
    state = 2 * sum(t.numel() * t.element_size() for c in cache["layers"]
                    for k, t in c.items() if k in RECURRENT_KEYS)
    log(f"  {label} [{name}] recurrent state read + written a step "
        f"{state / 1e6:.1f} MB ({state / 1e6 / (out[1] * 1e-3) / 1e6:.3f} "
        f"TB/s of the step) | {CARD}")
    return out + (state,)


def _recurrent_logits_checks(label, name, view, cfg, toks):
    """Phases 3r and 3s (a), (b): a decode step (B=4, after a prefill of
    all but the last 3 tokens) captured as a CUDA graph and replayed
    three times equals three eager steps bit for bit (logits and every
    cache leaf: the recurrent state it overwrites in place, any K/V
    columns it writes), each replay moving the first layer's state (an
    SSM or WKV matrix); the first step lies within ``_logit_tol`` of a
    prefill one token longer, and the same step from a copy of the cache
    with every RECURRENT_KEYS leaf zeroed (any K/V kept) lies
    CONTROL_APART times that tolerance or more from it, so that a step
    that lost or froze its recurrent state fails the check against the
    prefill. int8 and packed4 at act_bits 32 (8-bit dynamic scales couple
    a batch's rows), serving_pow2 at its frozen scales. Returns (step
    against prefill, zeroed-state control), each over max |logit|."""
    import torch

    from repro_torch.models import api
    from repro_torch.runtime import serving

    if name != "serving_pow2":
        cfg = cfg.replace(act_bits=32)
    tol = _logit_tol(cfg)
    apart = CONTROL_APART * tol
    toks = toks.cuda()
    P = toks.shape[1] - 3
    with torch.inference_mode():
        want, _ = api.prefill(view, cfg, {"tokens": toks[:, :P + 1]})
        _, cache = api.prefill(view, cfg, {"tokens": toks[:, :P]})
        cache = serving.adapt_prefill_cache(cfg, cache, BATCH, P + 5)
        eager, graphed, warm, zeroed = (_clone_tree(cache) for _ in range(4))
        for c in zeroed["layers"]:
            for k in c.keys() & RECURRENT_KEYS:
                c[k].zero_()
        watch = "ssm" if "ssm" in cache["layers"][0] else "wkv"
        tok = toks[:, P:P + 1].to(torch.int32).contiguous()
        masked = api.decode_step(view, cfg, tok, zeroed)[0]
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            api.decode_step(view, cfg, tok, warm)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out, nxt = api.decode_step(view, cfg, tok, graphed)
        same, moved, first = [], [], None
        prev = graphed["layers"][0][watch].clone()
        for _ in range(3):
            graph.replay()
            step, after = api.decode_step(view, cfg, tok, eager)
            torch.cuda.synchronize()
            if first is None:
                first = step.clone()
            same.append(torch.equal(out, step) and all(
                torch.equal(g[k], e[k])
                for g, e in zip(graphed["layers"], eager["layers"])
                for k in g))
            moved.append(not torch.equal(graphed["layers"][0][watch], prev))
            prev = graphed["layers"][0][watch].clone()
            graphed["len"].copy_(nxt["len"])
            eager["len"] = after["len"]
        del graph
    err, lost = _rel(first, want), _rel(masked, first)
    log(f"  {label} [{name}] logits (act_bits {cfg.act_bits}): 3 graph "
        f"replays = 3 eager steps bits (logits and state) {same}, state "
        f"moved by each replay {moved}; decode step vs prefill {err:.3e}, "
        f"from a zeroed recurrent state {lost:.3e} (tol {tol:g}, apart >= "
        f"{apart:g}); greedy tokens {want[:, -1].argmax(-1).tolist()} | "
        f"{CARD}")
    check(all(same), f"{label} {name}: a replayed decode step's logits or "
          f"state are not the eager step's")
    check(all(moved), f"{label} {name}: a replay did not advance the state")
    check(err <= tol, f"{label} {name}: decode step logits {err:.3e} from "
          f"the prefill's (tol {tol:g})")
    check(lost >= apart, f"{label} {name}: zeroing the recurrent state "
          f"moved the logits by only {lost:.3e}")
    return err, lost


def _recurrent_engine(label, view, cfg):
    """Phases 3r and 3s (c): at act_bits 32, synthetic_requests(seed=0)
    (RECURRENT_QUEUE requests, prompts up to 128, up to RECURRENT_MAX_NEW
    new) through a 4-slot engine asked for pages (a hybrid or ssm engine
    keeps its slot pool and prefills one prompt length a group): every
    request's tokens equal its lone generate, each request's first
    decode step's logits row lies within ``_logit_tol`` of its lone
    first step's and SM_LOGIT_APART from the next request's, no plain
    version; speculative=3 raises the reference's reason. Returns
    {kernel: launches}."""
    from collections import Counter

    import torch

    from repro_torch.runtime.engine import Engine, synthetic_requests
    from repro_torch.runtime.serving import generate

    reqs = synthetic_requests(cfg, RECURRENT_QUEUE, max_prompt=PROMPT,
                              max_new=RECURRENT_MAX_NEW, seed=0)
    max_len = PROMPT + RECURRENT_MAX_NEW
    t0 = time.perf_counter()
    lone, lone_rows = [], []
    for r in reqs:
        lone.append(generate(view, cfg, {"tokens": torch.as_tensor(
            r["tokens"])[None]}, steps=r["max_new"], max_len=max_len,
            device="cuda")[0].cpu())
        lone_rows.append(_first_step_logits(view, cfg, r, max_len))
    log(f"{label}: {len(reqs)} lone generates "
        f"{time.perf_counter() - t0:.1f} s (prompts "
        f"{sorted(len(r['tokens']) for r in reqs)})")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(view, cfg, capacity=4, max_len=max_len, kv_pages=16,
                 page_size=ENGINE_PAGE, device="cuda")
    _reset_counts()
    for r in reqs:
        eng.submit(r["tokens"], max_new=r["max_new"])
    rows = {}
    while not eng.idle:  # run(), a step at a time
        held = {q.rid for q in eng.slots if q is not None}
        eng.step()
        for i, q in enumerate(eng.slots):
            if q is not None and q.rid not in held:
                # admitted this step: the step decoded its first token
                rows[q.rid] = eng.logits[i, -1].clone()
    res = [eng.results[rid] for rid in sorted(eng.results)]
    torch.cuda.synchronize()
    st, counts = eng.stats(), _read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    same = [torch.equal(torch.as_tensor(r["tokens"]), want)
            for r, want in zip(res, lone)]
    n = len(reqs)
    errs = [_rel(rows[i], lone_rows[i]) for i in sorted(rows)]
    apart = [_rel(rows[i], lone_rows[(i + 1) % n]) for i in sorted(rows)]
    log(f"{label} slot engine (kv_pages asked, paged {st['paged']}): "
        f"{st['completed']} requests, {st['decode_steps']} steps, decode "
        f"{st['decode_tok_s']:.1f} tok/s, goodput "
        f"{st['goodput_tok_s']:.1f} tok/s, prefill {st['t_prefill_s']:.2f} "
        f"s, wall {time.perf_counter() - t0:.2f} s, peak {peak:.2f} GiB | "
        f"launches { {k: v for k, v in counts.items() if v} } | equal to "
        f"lone generates {same} | first-step logits vs alone max "
        f"{max(errs):.3e}, vs the next request's min {min(apart):.3e} | "
        f"{CARD}")
    check(st["paged"] is False and len(res) == n,
          f"{label} engine: paged {st['paged']}, {len(res)} results")
    check(all(same), f"{label} engine: a request's tokens differ from its "
          f"lone generate")
    check(counts["plain"] == 0, f"{label} engine ran plain versions: "
          f"{counts}")
    check(len(rows) == n and max(errs) <= _logit_tol(cfg),
          f"{label} engine: {len(rows)} first-step rows of {n}, max "
          f"{max(errs):.3e} from alone (tol {_logit_tol(cfg):g})")
    check(min(apart) >= SM_LOGIT_APART, f"{label} engine: a request's "
          f"first-step logits lie within {min(apart):.3e} of another's")
    launches = Counter({k: v for k, v in counts.items() if v})
    del eng
    torch.cuda.empty_cache()
    try:
        Engine(view, cfg, capacity=4, max_len=max_len, speculative=3,
               device="cuda")
    except ValueError as exc:
        log(f"{label} speculative=3 refused: {exc}")
        check("cannot rewind" in str(exc), f"{label} speculative=3 refused "
              f"for another reason: {exc}")
    else:
        die(f"{label}: speculative=3 was not refused")
    return launches


def zamba_full_width():
    """Phase 3r: zamba2-2.7b at full width (ZB_LAYERS of its 54 layers,
    d_model 2560, d_inner 5120, 32 / 32 heads of 80 in the shared block,
    d_ff 10240, vocab 32000 tied, its 4-bit pow2 LUT-Q, 8-bit
    activations; random weights from seed 0): (a) int8 and packed4
    generate (B=4, prompts 128 and 300, 16 tokens), graph and eager,
    each kernel's launches a forward, the logits and state checks, the
    head's share of a replayed step; (b) the calibrated serving_pow2 view
    the same on lutq_shift, then its audit; (c) the slot engine at
    act_bits 32; (d) reduced zamba card vs CPU. Returns {kernel:
    launches} of (a)'s and (b)'s graph-mode generates and (c)."""
    from collections import Counter

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.policy import serve_view
    from repro_torch.core.rules import serving_pow2, with_size_floor
    from repro_torch.core.spec import QuantSpec
    from repro_torch.models import api
    from repro_torch.models.reduce import reduced
    from repro_torch.models.zamba import n_super

    t_phase = time.perf_counter()
    base = get_config(ZB_ARCH).replace(n_layers=ZB_LAYERS)
    p = 2 * base.n_layers + 7 * n_super(base)  # body products a forward
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, base.vocab, (BATCH, ZB_LONG), generator=gen)
    prompts = {"P128": toks[:, :PROMPT], "P300": toks}
    launches, shares, parts = Counter(), {}, {}
    t0 = time.perf_counter()
    model = api.quantize(api.init(base, seed=0, device="cuda"), base)
    policy = api.resolved_policy(base)
    torch.cuda.synchronize()
    log(f"zamba {base.name} ({base.n_layers} layers in {n_super(base)} "
        f"super-blocks, d_model {base.d_model}, d_inner "
        f"{base.resolved_d_inner}, ssm_state {base.ssm_state}, "
        f"{base.n_heads} / {base.n_kv_heads} heads of "
        f"{base.resolved_head_dim}, d_ff {base.d_ff}, vocab {base.vocab} "
        f"tied): init + quantize {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated | "
        f"{CARD}")
    views = {"int8": serve_view(model, policy=policy),
             "packed4": serve_view(model, pack4=True, policy=policy)}
    del model
    torch.cuda.empty_cache()
    conv8 = views["int8"].mamba_layers[-1][-1].mamba.conv_w.state
    conv4 = views["packed4"].mamba_layers[0][0].mamba.conv_w.state
    check(conv8.a.shape == (4, 5248) and conv8.a.dtype == torch.int8
          and conv4.a.shape == (2, 5248) and conv4.a.dtype == torch.uint8
          and views["packed4"].embed.table.state.a.dtype == torch.uint8
          and len(views["int8"].mamba_layers) == n_super(base),
          "zamba: conv_w, the tied table or the stack is not as expected")
    for name, expect in (("int8", {"lutq_matmul": p + 1}),
                         ("packed4", {"lutq_gemv_packed": p, "decode": 1})):
        launches.update(_recurrent_serves("zamba", name, views[name], base,
                                           prompts, expect))
        shares[name] = _recurrent_head_share("zamba", name, views[name],
                                             base, toks[:, :PROMPT])
        _recurrent_logits_checks("zamba", name, views[name], base,
                                 toks[:, :PROMPT])
    _recurrent_logits_checks("zamba", "int8 P300", views["int8"], base,
                             toks)
    del views["packed4"]
    torch.cuda.empty_cache()
    parts["int8 + packed4"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches.update(_recurrent_engine("zamba", views["int8"],
                                       base.replace(act_bits=32)))
    parts["engine"] = time.perf_counter() - t0
    del views
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg = base.replace(quant=serving_pow2())
    cgen = torch.Generator().manual_seed(2)
    calib = {"tokens": torch.randint(0, cfg.vocab, (CALIB_BATCH, CALIB_LEN),
                                     generator=cgen).cuda()}
    view = api.serve_state(cfg, seed=0, device="cuda", calib_batch=calib)
    torch.cuda.synchronize()
    inq = view.mamba_layers[0][0].mamba.in_proj.kernel.state
    conv = view.mamba_layers[0][0].mamba.conv_w.state
    check(inq.d.dtype == torch.int8 and inq.act is not None
          and conv.d.dtype == torch.int8
          and view.embed.table.dtype == torch.float32,
          "serving_pow2: in_proj is not pow2-encoded with frozen pairs, "
          "conv_w not pow2-encoded, or the tied table is not float")
    log(f"zamba serving_pow2: serve_state (init, quantize, calibrate on "
        f"{CALIB_BATCH} x {CALIB_LEN}, serve_view) "
        f"{time.perf_counter() - t0:.1f} s")
    launches.update(_recurrent_serves("zamba", "serving_pow2", view, cfg,
                                       prompts, {"lutq_shift": p}))
    shares["serving_pow2"] = _recurrent_head_share(
        "zamba", "serving_pow2", view, cfg, toks[:, :PROMPT])
    _recurrent_logits_checks("zamba", "serving_pow2", view, cfg,
                             toks[:, :PROMPT])
    _family_audit("zamba", view, cfg, toks, ZB_AUDIT, {"lutq_shift": p})
    del view
    torch.cuda.empty_cache()
    parts["serving_pow2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    red = reduced(get_config(ZB_ARCH)).replace(
        act_bits=32, quant=QuantSpec(bits=4, constraint="pow2",
                                     min_size=1024))
    _reduced_card_vs_cpu("zamba", red, with_size_floor(serving_pow2(), 1024))
    parts["reduced"] = time.perf_counter() - t0
    log(f"phase 3r {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items())
        + ") | launches "
        f"{dict(launches)} | head ms, step ms, step / head graph pool MiB, "
        f"state bytes a step "
        f"{ {k: tuple(round(x, 4) for x in v) for k, v in shares.items()} }")
    return dict(launches)


# ---------------------------------------------------------------------------
# phases 2s and 3s: rwkv6-1.6b (the ssm family)
# ---------------------------------------------------------------------------

RW_ARCH = "rwkv6-1.6b"
#: rwkv's (Kin, N) products that no earlier phase holds: the decay
#: LoRA's w1 (N = 64: a quarter or a half of one GEMM tile's width) and
#: w2 (Kin = 64: one BK = 64 pipeline stage, nothing for the split plans
#: to split), the channel-mix's cm_k and cm_v (r, k, v, g, o and cm_r are
#: 2048 x 2048, paligemma's q / o of phase 2q)
RW_LEAF_SHAPES = {"w1": (2048, 64), "w2": (64, 2048), "cm_k": (2048, 7168),
                  "cm_v": (7168, 2048)}
RW_CHECK_M = (1, 4, 9, 128, 256)
RW_REPEAT_CASES = [(4, 2048, 64), (256, 2048, 64), (4, 64, 2048),
                   (256, 64, 2048), (4, 7168, 2048)]
#: phase 3s's depth: RW_LAYERS of rwkv's 24 layers (the width whole)
RW_LAYERS = 4
#: the audited prefill's tokens (4 x 96 = 384 rows: no quantized leaf
#: has 384 rows or columns)
RW_AUDIT = 96


def rwkv_kernel_checks():
    """Phase 2s: kernels 1, 2 and 4 at rwkv's product shapes
    (``_family_kernel_checks``). Returns {kernel: max abs err}."""
    t0 = time.perf_counter()
    worst = _family_kernel_checks("rwkv", RW_LEAF_SHAPES, RW_CHECK_M,
                                  RW_REPEAT_CASES, 45)
    log(f"phase 2s (kernels 1, 2, 4 at rwkv's products) "
        f"{time.perf_counter() - t0:.1f} s")
    return worst


def _rw_leaves(name, view, manifest, table_backend):
    """Phase 3s: each view's decay-LoRA leaves and tied table as the
    reference's serve_view makes them (the backends checked on the CPU
    against its manifest): int8 assignments (w1 (2048, 64), w2 (64,
    2048)) on kernel 1, packed pairs (w1 (1024, 64), w2 (32, 2048)) on
    kernel 2 and the table packed along its rows (so its transposed
    product takes the decode backend), or pow2-encoded with frozen pairs
    and a float table."""
    import torch

    mix = view.layers[0].mix
    w1, w2 = mix.w1.state, mix.w2.state
    body = {"int8": "fused", "packed4": "packed4", "serving_pow2": "pow2"}
    backends = {k: manifest[f"layers/mix/{k}"]["backend"]
                for k in ("w1", "w2", "r/kernel", "cm_v/kernel")}
    log(f"  rwkv [{name}] w1 a {tuple(w1.a.shape)} {w1.a.dtype}, w2 a "
        f"{tuple(w2.a.shape)} {w2.a.dtype}, backends {backends}, table "
        f"{manifest.get('embed/table', {}).get('backend', 'float')}")
    check(set(backends.values()) == {body[name]},
          f"rwkv {name}: body backends {backends}")
    check(manifest.get("embed/table", {}).get("backend") == table_backend,
          f"rwkv {name}: the tied table's backend is not {table_backend}")
    if name == "serving_pow2":
        check(w1.d.dtype == torch.int8 and w2.d.dtype == torch.int8
              and w1.act is not None and w2.act is not None
              and view.embed.table.dtype == torch.float32,
              "rwkv serving_pow2: w1 / w2 not pow2-encoded with frozen "
              "pairs, or the tied table is not float")
        return
    packed = name == "packed4"
    dt = torch.uint8 if packed else torch.int8
    check(w1.a.dtype == dt and w2.a.dtype == dt
          and view.embed.table.state.a.dtype == dt
          and tuple(w1.a.shape) == (2048 // (1 + packed), 64)
          and tuple(w2.a.shape) == (64 // (1 + packed), 2048),
          f"rwkv {name}: w1, w2 or the table's assignments are not as "
          f"expected")


def rwkv_full_width():
    """Phase 3s: rwkv6-1.6b at full width (RW_LAYERS of its 24 layers,
    d_model 2048 = 32 WKV heads of 64, d_ff 7168, vocab 65536 tied, its
    4-bit pow2 LUT-Q, 8-bit activations; random weights from seed 0; the
    residual stream f32): (a) int8 and packed4 generate (B=4, prompt
    128, 16 tokens), graph and eager, each kernel's launches a forward,
    the logits and state checks, the head's share of a replayed step;
    (b) the calibrated serving_pow2 view the same on lutq_shift, then
    its audit; (c) the slot engine at act_bits 32; (d) reduced rwkv card
    vs CPU. Returns {kernel: launches} of (a)'s and (b)'s graph-mode
    generates and (c)."""
    from collections import Counter

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.policy import serve_view
    from repro_torch.core.rules import serving_pow2
    from repro_torch.core.spec import QuantSpec
    from repro_torch.models import api
    from repro_torch.models.reduce import reduced

    t_phase = time.perf_counter()
    base = get_config(RW_ARCH).replace(n_layers=RW_LAYERS)
    p = 10 * base.n_layers  # body products a forward, w1 and w2 among them
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, base.vocab, (BATCH, PROMPT), generator=gen)
    prompts = {"P128": toks}
    launches, shares, errs, parts = Counter(), {}, {}, {}
    t0 = time.perf_counter()
    model = api.quantize(api.init(base, seed=0, device="cuda"), base)
    policy = api.resolved_policy(base)
    torch.cuda.synchronize()
    log(f"rwkv {base.name} ({base.n_layers} layers, d_model {base.d_model} "
        f"= {base.d_model // base.ssm_head_dim} WKV heads of "
        f"{base.ssm_head_dim}, d_ff {base.d_ff}, vocab {base.vocab} tied): "
        f"init + quantize {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated | "
        f"{CARD}")
    views, mans = {}, {}
    for name, pack4 in (("int8", False), ("packed4", True)):
        views[name], mans[name] = serve_view(model, pack4=pack4,
                                             policy=policy,
                                             with_manifest=True)
    del model
    torch.cuda.empty_cache()
    for name, expect, table in (
            ("int8", {"lutq_matmul": p + 1}, "fused"),
            ("packed4", {"lutq_gemv_packed": p, "decode": 1}, "packed4")):
        _rw_leaves(name, views[name], mans[name], table)
        launches.update(_recurrent_serves("rwkv", name, views[name], base,
                                          prompts, expect))
        shares[name] = _recurrent_head_share("rwkv", name, views[name],
                                             base, toks)
        errs[name] = _recurrent_logits_checks("rwkv", name, views[name],
                                              base, toks)
    del views["packed4"]
    torch.cuda.empty_cache()
    parts["int8 + packed4"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches.update(_recurrent_engine("rwkv", views["int8"],
                                      base.replace(act_bits=32)))
    parts["engine"] = time.perf_counter() - t0
    del views
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg = base.replace(quant=serving_pow2())
    cgen = torch.Generator().manual_seed(2)
    calib = {"tokens": torch.randint(0, cfg.vocab, (CALIB_BATCH, CALIB_LEN),
                                     generator=cgen).cuda()}
    view, man = api.serve_state(cfg, seed=0, device="cuda",
                                calib_batch=calib, with_manifest=True)
    torch.cuda.synchronize()
    log(f"rwkv serving_pow2: serve_state (init, quantize, calibrate on "
        f"{CALIB_BATCH} x {CALIB_LEN}, serve_view) "
        f"{time.perf_counter() - t0:.1f} s")
    _rw_leaves("serving_pow2", view, man, None)
    launches.update(_recurrent_serves("rwkv", "serving_pow2", view, cfg,
                                      prompts, {"lutq_shift": p}))
    shares["serving_pow2"] = _recurrent_head_share(
        "rwkv", "serving_pow2", view, cfg, toks)
    errs["serving_pow2"] = _recurrent_logits_checks("rwkv", "serving_pow2",
                                                    view, cfg, toks)
    # the WKV einsums and the head are the float dots; the lerps, gates,
    # decay and state updates the float multiplies (count_ops)
    _family_audit("rwkv", view, cfg, toks, RW_AUDIT, {"lutq_shift": p})
    del view
    torch.cuda.empty_cache()
    parts["serving_pow2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    red = reduced(get_config(RW_ARCH)).replace(
        act_bits=32, quant=QuantSpec(bits=4, constraint="pow2"))
    _reduced_card_vs_cpu("rwkv", red)
    parts["reduced"] = time.perf_counter() - t0
    log(f"phase 3s {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items())
        + ") | launches "
        f"{dict(launches)} | head ms, step ms, step / head graph pool MiB, "
        f"state bytes a step "
        f"{ {k: tuple(round(x, 4) for x in v) for k, v in shares.items()} }"
        f" | step vs prefill, zeroed-state control "
        f"{ {k: tuple(f'{x:.3e}' for x in v) for k, v in errs.items()} }")
    return dict(launches)


# ---------------------------------------------------------------------------
# phase 3n: the remaining dense families at full width
# ---------------------------------------------------------------------------

#: phase 3n's families (kv bits of their paged engines: int8 pages at
#: mistral-large's group of 12, bf16 pages at qwen1.5's group of 8) and
#: mistral-nemo-12b, whose paged engine runs once (group 4, head dim 128)
DENSE_ARCHS = {"mistral-large-123b": 8, "qwen1.5-110b": 16}
NEMO_ARCH = "mistral-nemo-12b"
#: their depth on the card: 2 layers (mistral-large ~5.5 GB of float32
#: masters a layer and 3.2 GB of embedding and head; qwen1.5 ~5.4 GB a
#: layer and 10 GB of embedding and head at vocab 152064)
DENSE_LAYERS = 2
#: phase 3n (c): the paged engine's queue and new tokens a request
DENSE_QUEUE = (128, 96, 64, 112, 80)
DENSE_ENGINE_GEN = 8


def _dense_engine(label, view, cfg, queue, *, speculative=True):
    """Phase 3n (c): the paged engine (page 64, 4 slots, packed prefill,
    act_bits 32, graph replay) over prompts of unequal lengths: each
    request's tokens equal its lone generate; the paged kernel launches
    n_layers times a decode step in the variant its plan picks, no plain
    version. With ``speculative`` a speculative paged engine (k = 3,
    draft_bits 3) gives the same tokens (plain decoding's). Returns
    {kernel: launches} over the runs."""
    from collections import Counter

    import torch

    from repro_torch.kernels import build, paged_attn
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.serving import generate

    # the speculative engine's k = 3 positions of headroom past each
    # request's last token
    max_len = max(len(t) for t in queue) + DENSE_ENGINE_GEN + 3
    lone = [generate(view, cfg, {"tokens": t[None]}, steps=DENSE_ENGINE_GEN,
                     max_len=max_len, device="cuda")[0].cpu()
            for t in queue]
    G = cfg.n_heads // cfg.n_kv_heads
    plan = paged_attn.launch_plan(
        4, cfg.n_kv_heads, -(-max_len // ENGINE_PAGE), ENGINE_PAGE,
        cfg.resolved_head_dim, G, window=cfg.window,
        itemsize=1 if cfg.kv_cache_bits == 8 else 2,
        sms=build.sm_count(torch.device("cuda", 0)))
    variant = ("paged_attention_multipass" if plan["multipass"]
               else "paged_attention")
    launches = Counter()
    for k in ((0, 3) if speculative else (0,)):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(view, cfg, capacity=4, max_len=max_len, kv_pages=48,
                     page_size=ENGINE_PAGE, speculative=k, draft_bits=3,
                     device="cuda")
        warm = time.perf_counter() - t0
        _reset_counts()
        for t in queue:
            eng.submit(t, max_new=DENSE_ENGINE_GEN)
        res = eng.run()
        torch.cuda.synchronize()
        st, counts = eng.stats(), _read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        same = [torch.equal(torch.as_tensor(r["tokens"]), want)
                for r, want in zip(res, lone)]
        steps = st["spec_rounds"] if k else st["decode_steps"]
        per = cfg.n_layers * (2 * k + 1 if k else 1)
        log(f"{label} paged engine {cfg.name} x{cfg.n_layers} (G = {G}, "
            f"dh {cfg.resolved_head_dim}, kv {cfg.kv_cache_bits} bits"
            + (f", speculative k={k}" if k else "") + f"): "
            f"{st['completed']} requests, {steps} "
            + ("rounds" if k else "steps") + f", decode "
            f"{st['decode_tok_s']:.1f} tok/s, goodput "
            f"{st['goodput_tok_s']:.1f} tok/s, warmup {warm:.2f} s, "
            + (f"acceptance {st['acceptance_rate']:.3f}, " if k else "")
            + f"{variant} {counts[variant]} (plan: {plan['nsplit']} splits "
            f"of {plan['chunk']}), peak {peak:.2f} GiB | equal to lone "
            f"generates {same} | {CARD}")
        check(st["paged"] is True and len(res) == len(queue),
              f"{label} {cfg.name}: the engine did not serve its queue paged")
        check(all(same), f"{label} {cfg.name}: a request's tokens differ from "
              f"its lone generate (speculative k={k})")
        check(counts[variant] == per * steps and counts["plain"] == 0,
              f"{label} {cfg.name}: {counts[variant]} {variant} launches for "
              f"{steps} steps of {per}, plain {counts['plain']}")
        launches.update({kk: v for kk, v in counts.items() if v})
        del eng
        torch.cuda.empty_cache()
    return launches


def _dense_family(arch, kv_bits):
    """Phase 3n for one family: (a) init + quantize 2 full-width layers
    (qwen1.5's q/k/v biases set to seeded values); (b) generate through
    the int8 and packed4 views, graph and eager; (c) the paged engine and
    its speculative twin at act_bits 32; (d) serving_pow2 (calibrated):
    the per-leaf overflow guard, generate and the multiply audit; (e)
    the reduced config card vs CPU. Returns {kernel: launches} of the
    main-path runs (the graph-mode generates and the engines)."""
    from collections import Counter

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.policy import serve_view
    from repro_torch.core.rules import serving_pow2
    from repro_torch.models import api
    from repro_torch.models.reduce import reduced

    t_phase = time.perf_counter()
    base = get_config(arch).replace(n_layers=DENSE_LAYERS)
    L = base.n_layers
    toks = torch.randint(0, base.vocab, (BATCH, PROMPT),
                         generator=torch.Generator().manual_seed(1))
    launches = Counter()

    def build(cfg):
        model = api.init(cfg, seed=0, device="cuda")
        if cfg.qkv_bias:
            _random_qkv_biases(model, 3)
        return api.quantize(model, cfg)

    t0 = time.perf_counter()
    model = build(base)
    torch.cuda.synchronize()
    log(f"dense {arch} x{L} (d_model {base.d_model}, {base.n_heads} / "
        f"{base.n_kv_heads} heads of {base.resolved_head_dim}, d_ff "
        f"{base.d_ff}, vocab {base.vocab}, qkv bias {base.qkv_bias}): init "
        f"+ quantize {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated | {CARD}")
    policy = api.resolved_policy(base)
    views = {"int8": serve_view(model, policy=policy),
             "packed4": serve_view(model, pack4=True, policy=policy)}
    del model
    torch.cuda.empty_cache()
    q = views["int8"].layers[0].attn.q
    check(hasattr(q, "bias") == base.qkv_bias
          and (not base.qkv_bias or bool(q.bias.abs().min() > 0)),
          f"{arch}: the served q projection's bias is not what the config "
          f"says")
    for name, kernel in (("int8", "lutq_matmul"),
                         ("packed4", "lutq_gemv_packed")):
        _, counts = _family_serve("dense", name, views[name], base, toks,
                                  {kernel: 7 * L + 1})
        launches[kernel] += counts[kernel]
    rng = torch.Generator().manual_seed(7)
    queue = [torch.randint(0, base.vocab, (n,), generator=rng)
             for n in DENSE_QUEUE]
    launches.update(_dense_engine(
        "dense", views["packed4"], base.replace(act_bits=32,
                                                kv_cache_bits=kv_bits),
        queue))
    del views
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg = base.replace(quant=serving_pow2())
    calib = torch.randint(0, cfg.vocab, (CALIB_BATCH, CALIB_LEN),
                          generator=torch.Generator().manual_seed(2))
    model = api.calibrate(build(cfg), cfg, {"tokens": calib.cuda()})
    view = serve_view(model, policy=api.resolved_policy(cfg))
    del model
    torch.cuda.empty_cache()
    n_leaves, n_encoded, bits, kept = _pow2_guard_report(view)
    log(f"dense serving_pow2 {arch}: init, quantize, calibrate ("
        f"{CALIB_BATCH} x {CALIB_LEN} tokens), serve view "
        f"{time.perf_counter() - t0:.1f} s | {n_encoded} of {n_leaves} body "
        f"leaves pow2-encoded with frozen scales | guard (7 + span + "
        f"ceil(log2 Kin) <= 31) per logical leaf: {bits} | kept on a float "
        f"dictionary (kernel 1, refused by the audit): {kept or 'none'}")
    check(n_leaves == 7 * L, f"{arch}: {n_leaves} body leaves")
    check(all((b > 31) == (p in kept) for p, b in bits.items()),
          f"{arch}: the guard's decisions disagree with its bits {bits}")
    n_kept = L * len(kept)  # float-dictionary products a forward
    expect = {"lutq_shift": 7 * L - n_kept}
    if n_kept:
        expect["lutq_matmul"] = n_kept
    _, counts = _family_serve("dense", "serving_pow2", view, cfg, toks,
                              expect)
    launches["lutq_shift"] += counts["lutq_shift"]
    if kept:
        try:
            _family_audit("dense", view, cfg, toks, PROMPT,
                          {"lutq_shift": 7 * L - n_kept})
        except AssertionError as e:
            log(f"  dense audit {arch}: REFUSED, as the reference's audit "
                f"refuses a float dictionary ({kept}): {str(e)[:200]}")
        else:
            die(f"{arch}: the audit passed a float dictionary {kept}")
    else:
        _family_audit("dense", view, cfg, toks, PROMPT,
                      {"lutq_shift": 7 * L})
    del view
    torch.cuda.empty_cache()
    red = reduced(get_config(arch)).replace(act_bits=32)
    if arch == "mistral-large-123b":  # reduced() makes the group 4
        red = red.replace(n_heads=12, n_kv_heads=1)
    _reduced_card_vs_cpu("dense", red)
    log(f"phase 3n {arch} {time.perf_counter() - t_phase:.1f} s | launches "
        f"{dict(launches)}")
    return launches


def dense_families_full_width():
    """Phase 3n: mistral-large-123b and qwen1.5-110b at full width (2
    layers each, one family on the card at a time), then
    mistral-nemo-12b's paged engine at 2 full-width layers. Returns
    {kernel: launches} over their main-path runs."""
    from collections import Counter

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.policy import serve_view
    from repro_torch.models import api

    t_phase = time.perf_counter()
    launches = Counter()
    for arch, kv_bits in DENSE_ARCHS.items():
        launches.update(_dense_family(arch, kv_bits))
    cfg = get_config(NEMO_ARCH).replace(n_layers=DENSE_LAYERS)
    model = api.quantize(api.init(cfg, seed=0, device="cuda"), cfg)
    view = serve_view(model, pack4=True, policy=api.resolved_policy(cfg))
    del model
    rng = torch.Generator().manual_seed(9)
    queue = [torch.randint(0, cfg.vocab, (n,), generator=rng)
             for n in DENSE_QUEUE]
    launches.update(_dense_engine(
        "dense", view, cfg.replace(act_bits=32, kv_cache_bits=8), queue,
        speculative=False))
    del view
    torch.cuda.empty_cache()
    log(f"phase 3n {time.perf_counter() - t_phase:.1f} s | launches "
        f"{dict(launches)}")
    return launches


# ---------------------------------------------------------------------------
# phase 3c / 3d
# ---------------------------------------------------------------------------

def _shared_prefix_requests(vocab):
    """Run (b)'s queue: a 256-token system prompt shared by 16 requests,
    each with its own tail of 1-64 tokens and max_new of 4-32."""
    import numpy as np

    rng = np.random.default_rng(7)
    sys_prompt = rng.integers(0, vocab, 256)
    return [{"tokens": np.concatenate([sys_prompt, rng.integers(
                0, vocab, int(rng.integers(1, 65)))]).astype(np.int32),
             "max_new": int(rng.integers(4, 33))} for _ in range(16)]


def engine_runs(views, cfg):
    """Phase 3c: the paged engine at full width through its three runs.
    Returns per-run numbers, launches included."""
    import numpy as np

    from repro_torch.runtime.engine import synthetic_requests

    long_req = {"tokens": np.random.default_rng(8).integers(
        0, cfg.vocab, LONG_PROMPT).astype(np.int32), "max_new": LONG_GEN}
    runs = {
        "a": dict(view="lutq_gemv_packed", backend="auto", kv_bits=8,
                  capacity=8, kv_pages=160, max_len=512 + 64,
                  requests=synthetic_requests(cfg, ENGINE_QUEUE,
                                              max_prompt=512, max_new=64,
                                              seed=0)),
        "b": dict(view="lutq_matmul", backend="fused", kv_bits=16,
                  capacity=8, kv_pages=64, max_len=256 + 64 + 32,
                  requests=_shared_prefix_requests(cfg.vocab)),
        "c": dict(view="lutq_gemv_packed", backend="auto", kv_bits=8,
                  capacity=1, kv_pages=80, max_len=LONG_PROMPT + LONG_GEN,
                  requests=[long_req]),
    }
    out = {}
    for name, r in runs.items():
        gemm = "lutq_gemv_packed" if r["view"] == "lutq_gemv_packed" \
            else "lutq_matmul"
        out[name] = engine_run(name, views[r["view"]], cfg, r, gemm,
                               CALLS_PER_FORWARD)
    return out


def engine_run(name, view, cfg, r, gemm, calls_per_forward):
    """One paged-engine run over ``r``'s queue, served twice: replaying
    the decode step the engine captured at construction, then stepping
    eagerly inside disable_graphs(). Both passes must give the same
    tokens and launch counts. Returns the graph pass's numbers, with the
    eager pass's under "eager"."""
    import numpy as np

    out = {mode: _engine_pass(name, mode, view, cfg, r, gemm,
                              calls_per_forward) for mode in MODES}
    graph, eager = out["graph"], out["eager"]
    same = all(np.array_equal(a, b)
               for a, b in zip(graph["tokens"], eager["tokens"]))
    log(f"engine run ({name}) graph | eager: prefill "
        f"{graph['t_prefill_s']:.2f} | {eager['t_prefill_s']:.2f} s over "
        f"{graph['prefill_chunk_calls']} chunks ("
        f"{graph['prefill_ms_a_chunk']:.1f} | "
        f"{eager['prefill_ms_a_chunk']:.1f} ms a chunk on the engine's "
        f"clock; one {graph['chunk_width']}-wide chunk between "
        f"synchronizes {graph['chunk_ms']:.2f} | {eager['chunk_ms']:.2f} "
        f"ms), wall {graph['wall_s']:.2f} | {eager['wall_s']:.2f} s "
        f"(profiler {graph['profiler_s']:.2f} | {eager['profiler_s']:.2f}), "
        f"decode "
        f"{graph['decode_tok_s']:.1f} | {eager['decode_tok_s']:.1f} tok/s, "
        f"goodput {graph['goodput_tok_s']:.1f} | "
        f"{eager['goodput_tok_s']:.1f} tok/s (without the profiler "
        f"{graph['goodput_net_tok_s']:.1f} | "
        f"{eager['goodput_net_tok_s']:.1f}), TTFT p50 "
        f"{graph['ttft_p50_s'] * 1e3:.0f} | {eager['ttft_p50_s'] * 1e3:.0f}"
        f" ms, p99 {graph['ttft_p99_s'] * 1e3:.0f} | "
        f"{eager['ttft_p99_s'] * 1e3:.0f} ms, profiled step "
        f"{graph['profiled_step_ms']:.2f} | {eager['profiled_step_ms']:.2f}"
        f" ms, idle {graph['idle'] * 100:.1f} | {eager['idle'] * 100:.1f} "
        f"%, step without the profiler {graph['timed_step_ms']:.2f} | "
        f"{eager['timed_step_ms']:.2f} ms, peak {graph['peak_gib']:.2f} | "
        f"{eager['peak_gib']:.2f} GiB (reserved "
        f"{graph['reserved_gib']:.2f} | {eager['reserved_gib']:.2f}), "
        f"warmup {graph['t_warmup_s']:.3f} | {eager['t_warmup_s']:.3f} s | "
        f"tokens equal {same}, counts equal "
        f"{graph['counts'] == eager['counts']}")
    check(same, f"run ({name}): graph and eager passes give other tokens")
    check(graph["counts"] == eager["counts"],
          f"run ({name}): graph and eager passes launch other counts")
    return dict(graph, eager=eager)


def _engine_pass(name, mode, view, cfg, r, gemm, calls_per_forward):
    """One pass of the paged engine over ``r``'s queue in ``mode``:
    counts zeroed just before and read just after, one decode step
    profiled, the checks of phase 3c. Returns the pass's numbers."""
    import torch

    from repro_torch.kernels import build, paged_attn
    from repro_torch.runtime.engine import Engine

    run_cfg = cfg.replace(kernel_backend=r["backend"],
                          kv_cache_bits=r["kv_bits"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _mode(mode):
        eng = Engine(view, run_cfg, capacity=r["capacity"],
                     max_len=r["max_len"], kv_pages=r["kv_pages"],
                     page_size=ENGINE_PAGE,
                     prefix_cache=r.get("prefix_cache", True),
                     prefill_pack=r.get("prefill_pack", True),
                     device="cuda")
        traces = eng.paged_trace_counts()
        check(traces == _paged_traces(eng, mode == "graph"),
              f"run ({name}, {mode}): {traces} graphs after warmup")
        log(f"  run ({name}, {mode}): graphs {traces} after a "
            f"{eng.t_warmup:.3f} s warmup; graph pools: "
            f"{_graph_pools(eng)}")
        for req in r["requests"]:
            eng.submit(req["tokens"], max_new=req["max_new"])
        torch.cuda.synchronize()
        _reset_counts()
        profiled, timed_ms, freed = _serve_pass(name, mode, eng, r)
    check(eng.paged_trace_counts() == traces,
          f"run ({name}, {mode}): the serve captured more graphs")
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    reserved = torch.cuda.max_memory_reserved() / 2**30
    st = eng.stats()
    with _mode(mode):
        chunk_ms = _chunk_ms(eng)
    res = [eng.results[i] for i in sorted(eng.results)]
    steps, chunks = st["decode_steps"], st["prefill_chunk_calls"]
    st["prefill_ms_a_chunk"] = st["t_prefill_s"] / max(chunks, 1) * 1e3
    plan = paged_attn.launch_plan(
        r["capacity"], cfg.n_kv_heads, eng.n_blocks, ENGINE_PAGE,
        cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads,
        window=cfg.window, itemsize=1 if r["kv_bits"] == 8 else 2,
        sms=build.sm_count(torch.device("cuda", torch.cuda.current_device())))
    variant = ("paged_attention_multipass" if plan["multipass"]
               else "paged_attention")
    wall_ms, busy_ms, rows, prof_s = profiled
    st["profiler_s"] = prof_s
    st["goodput_net_tok_s"] = st["new_tokens"] / (st["wall_s"] - prof_s)
    pa_ms = sum(x[0] for x in rows if "paged_decode" in x[2])
    log(f"engine run ({name}, {mode}) [{st['backend']}, {r['kv_bits']}-bit "
        f"KV, capacity {r['capacity']}, {len(res)} requests]: decode "
        f"{st['decode_tok_s']:.1f} tok/s | goodput "
        f"{st['goodput_tok_s']:.1f} tok/s | TTFT p50 "
        f"{st['ttft_p50_s'] * 1e3:.0f} ms p99 "
        f"{st['ttft_p99_s'] * 1e3:.0f} ms | latency p50 "
        f"{st['p50_latency_s'] * 1e3:.0f} ms p95 "
        f"{st['p95_latency_s'] * 1e3:.0f} ms | {steps} decode steps, "
        f"{chunks} prefill chunks, prefill {st['t_prefill_s']:.2f} s "
        f"({st['prefill_ms_a_chunk']:.1f} ms a chunk; one "
        f"{eng.buckets[-1]}-wide chunk between synchronizes "
        f"{chunk_ms:.2f} ms), decode {st['t_decode_s']:.2f} s, wall "
        f"{st['wall_s']:.2f} s ({prof_s:.2f} s of it the profiler's start,"
        f" stop and reading; goodput without it "
        f"{st['goodput_net_tok_s']:.1f} tok/s) | "
        f"pages peak {st['pages_peak']} of {st['kv_pages'] - 1} | prefix "
        f"hits {st.get('prefix_hits', 0)}/{st.get('prefix_queries', 0)} "
        f"({st.get('prefix_hit_rate', 0) * 100:.1f}%) | peak {peak:.2f} GiB "
        f"({reserved:.2f} reserved) | warmup {st['t_warmup_s']:.3f} s | "
        f"card idle {(1 - busy_ms / wall_ms) * 100:.1f}% of a decode "
        f"step ({wall_ms:.1f} ms, paged kernel {pa_ms:.3f} ms; "
        f"{plan['nsplit']} splits of {plan['chunk']} positions, "
        f"{plan['blocks']} blocks) | launches {counts}")
    check(counts[variant] == N_LAYERS * steps and
          counts["paged_attention"] + counts["paged_attention_multipass"]
          == N_LAYERS * steps,
          f"run ({name}, {mode}): {counts} paged launches, expected "
          f"{N_LAYERS} x {steps} decode steps of {variant}")
    check(counts["plain"] == 0 and counts["decode"] == 0,
          f"run ({name}) ran a plain version: {counts}")
    check(counts[gemm] == calls_per_forward * (steps + chunks),
          f"run ({name}): {counts[gemm]} {gemm} launches, expected "
          f"{calls_per_forward} x ({steps} steps + {chunks} chunks)")
    others = [k for k in ("lutq_matmul", "lutq_gemv_packed", "lutq_shift")
              if k != gemm and counts[k]]
    check(not others, f"run ({name}) launched another GEMM: {counts}")
    for req, got in zip(r["requests"], res):
        check(got["n_new"] == req["max_new"] and got["finish"] == "length",
              f"run ({name}) request {got['rid']}: {got['n_new']} of "
              f"{req['max_new']} tokens, {got['finish']}")
        check(bool(((got["tokens"] >= 0) & (got["tokens"] < cfg.vocab)
                    ).all()), "tokens out of range")
    eng.pkv.alloc.check()
    held = ({n.page for n in eng.pkv.prefix._nodes.values()}
            if eng.pkv.prefix is not None else set())
    check(eng.pkv.alloc.pages_in_use == len(held),
          f"run ({name}): {eng.pkv.alloc.pages_in_use} pages still held, "
          f"{len(held)} by the prefix cache")
    if name == "b":
        check(st["prefix_hits"] > 0, "run (b): no prefix hit")
    if name == "c":
        check(chunks == LONG_PROMPT // 256, f"run (c): {chunks} chunks")
        check(freed >= 4, f"run (c): {freed} blocks released behind the "
              f"window, expected >= 4")
        log(f"  run (c): {freed} blocks of the row released behind the "
            f"window, their device entries 0")
    out = dict(st, peak_gib=peak, reserved_gib=reserved,
               idle=1 - busy_ms / wall_ms, timed_step_ms=timed_ms,
               chunk_ms=chunk_ms, chunk_width=eng.buckets[-1],
               launches={k: counts[k] for k in
                         ("paged_attention", "paged_attention_multipass",
                          gemm)}, counts=counts,
               profiled_step_ms=wall_ms, tokens=[x["tokens"] for x in res])
    del eng
    torch.cuda.empty_cache()
    return out


def _paged_traces(eng, graphs: bool) -> dict:
    """The graphs a warmed paged engine holds from its construction on:
    the decode step (and the speculative round), one chunk graph a
    width of ``prefill_buckets(max_chunk)``, the hydrate and the splice,
    and one packed graph a width where the engine packs; none when it
    was made inside disable_graphs()."""
    from repro_torch.runtime import paged_kv

    n = int(graphs)
    widths = len(paged_kv.prefill_buckets(eng.max_chunk))
    out = {"decode": n, "hydrate": n, "splice": n, "chunk": n * widths}
    if eng.spec_k:
        out["spec"] = n
    if eng.prefill_pack:
        out["packed"] = n * widths
    return out


def _graph_pools(eng) -> str:
    """MiB reserved in the engine's graph memory pools, from the
    allocator's segments: the pool the prefill graphs share, and the
    decode step's own ("not measured" where segments name no pool)."""
    import torch

    segs = torch.cuda.memory_snapshot()
    if not eng._graphs or not all("segment_pool_id" in g for g in segs):
        return "not measured"
    pools = {"prefill": eng._prefill_pool,
             "decode": eng._graphs["decode"][0].pool()}
    mib = {k: sum(g["total_size"] for g in segs
                  if tuple(g["segment_pool_id"]) == tuple(v)) / 2**20
           for k, v in pools.items() if v is not None}
    return ", ".join(f"{k} {v:.1f} MiB" for k, v in mib.items())


def _chunk_ms(eng, reps: int = 3) -> float:
    """Host ms of one chunk of the idle engine's widest bucket at start
    0, between synchronizes, as the current mode runs it (the replayed
    graph, or the function eagerly inside disable_graphs()); one call
    first, then the mean of ``reps``. The workspace it writes is zeroed
    by the next hydrate, and its launches are taken back."""
    import functools

    import torch

    from repro_torch.kernels import ops

    check(eng.idle, "the chunk is timed on an idle engine")
    width = eng.buckets[-1]
    before = ops.read_counts()
    eng.chunk_tok.zero_()
    eng.chunk_start.zero_()
    eng.chunk_n_real.fill_(width)
    fn = functools.partial(eng._prefill_chunk, width)
    with torch.inference_mode():
        eng._run_graphed(f"chunk{width}", fn, prefill=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            eng._run_graphed(f"chunk{width}", fn, prefill=True)
        torch.cuda.synchronize()
    ops.set_counts(before)
    return (time.perf_counter() - t0) / reps * 1e3


def _serve_pass(name, mode, eng, r):
    """Engine.run, one step at a time. The first step that only decodes
    (every slot live, or nothing left to admit) is profiled and the next
    such step timed without the profiler, each between synchronizes. Run
    (c) keeps each step's device block row (a copy on the card, no sync)
    and checks after the run that the blocks released behind the window
    read 0. Returns (the profile: wall ms, busy ms, kernel rows and the
    seconds the profiler itself held the serve; the unprofiled step's
    ms; the most blocks released)."""
    import torch

    profiled, timed_ms, rows = None, None, []
    while not eng.idle:
        live = sum(x is not None for x in eng.slots)
        decode_only = live and not eng.prefilling and (
            live == r["capacity"] or not eng.queue)
        if decode_only and profiled is None:
            def one_step():
                eng.step()
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            profiled = profile_run(one_step, f"one decode step, run ({name},"
                                   f" {mode}), {live} live slots")
            # the profiler's own start, stop and trace reading, which the
            # serve's wall holds beside the step
            profiled += (time.perf_counter() - t0 - profiled[0] / 1e3,)
        elif decode_only and timed_ms is None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            timed_ms = (time.perf_counter() - t0) * 1e3
        else:
            eng.step()
        if name == "c" and eng.slots[0] is not None:
            rows.append(([j for j, p in enumerate(eng.pkv.rows[0]) if p == 0],
                         eng.cache["block"][0].clone()))
    freed = 0
    for dead, block in rows:
        check(not block[dead].any(),
              "a released block entry still points at a page")
        freed = max(freed, len(dead))
    check(timed_ms is not None, f"run ({name}, {mode}): no second "
          f"decode-only step to time")
    log(f"  one decode step, run ({name}, {mode}), without the profiler: "
        f"{timed_ms:.2f} ms")
    return profiled, timed_ms, freed


def reduced_engine_card_vs_cpu():
    """Phase 3d: the reduced config through the paged engine (int8 and
    f32 pools) and the slot engine, on the card and on the CPU through
    the plain versions: the same tokens."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.policy import serve_view
    from repro_torch.core.spec import QuantSpec
    from repro_torch.models import api
    from repro_torch.models.reduce import reduced
    from repro_torch.runtime.engine import Engine, synthetic_requests

    base = reduced(get_config("h2o-danube-1.8b")).replace(
        quant=QuantSpec(bits=4, min_size=512), act_bits=32)
    reqs = synthetic_requests(base, 6, max_prompt=30, max_new=8, seed=1)
    model = serve_view(api.quantize(api.init(base, seed=0, device="cpu"),
                                    base), pack4=True,
                       policy=api.resolved_policy(base))
    for label, kv_bits, kw in (
            ("paged int8", 8, dict(kv_pages=24, page_size=8,
                                   prefill_pack=False)),
            ("paged f32", 16, dict(kv_pages=24, page_size=8,
                                   prefill_pack=False)),
            ("paged int8 packed", 8, dict(kv_pages=24, page_size=8)),
            ("slot", 16, {})):
        cfg = base.replace(kv_cache_bits=kv_bits)
        toks, counts, groups = {}, {}, {}
        for dev in ("cpu", "cuda"):
            eng = Engine(model.to(dev), cfg, capacity=2, max_len=38,
                         device=dev, **kw)
            for r in reqs:
                eng.submit(r["tokens"], max_new=r["max_new"])
            _reset_counts()
            toks[dev] = [r["tokens"].tolist() for r in eng.run()]
            counts[dev] = _read_counts()
            groups[dev] = eng.stats().get("packed_groups", 0)
        same = toks["cpu"] == toks["cuda"]
        log(f"reduced engine {label}: card vs cpu tokens equal {same} | "
            f"packed groups {groups['cuda']} | {groups['cpu']} | "
            f"card {counts['cuda']} | cpu {counts['cpu']}")
        if label.endswith("packed"):
            check(groups["cuda"] >= 1 and groups["cuda"] == groups["cpu"],
                  f"reduced engine {label}: packed groups {groups}")
        check(same, f"reduced engine {label}: card and CPU tokens differ")
        check(counts["cuda"]["plain"] == 0, "card run took a plain version")
        if kw:
            check(counts["cuda"]["paged_attention"] > 0
                  and counts["cpu"]["paged_attention"] == 0,
                  f"reduced engine {label}: paged kernel launches wrong")


# ---------------------------------------------------------------------------
# phase 3i
# ---------------------------------------------------------------------------

#: phase 3i: the reference's prefill_packing burst scaled to run (a)'s 8
#: slots: 32 requests at t=0, prompts of 16-96 tokens, 2-16 new tokens
PACK_QUEUE, PACK_SYSTEM = 32, 128


def _packing_requests(vocab, shared: bool):
    """Phase 3i's queue (seed 2); with ``shared`` every second prompt
    sits behind one 128-token system prompt."""
    import numpy as np

    rng = np.random.default_rng(2)
    system = rng.integers(0, vocab, PACK_SYSTEM)
    out = []
    for i in range(PACK_QUEUE):
        toks = rng.integers(0, vocab, int(rng.integers(16, 97)))
        if shared and i % 2:
            toks = np.concatenate([system, toks])
        out.append({"tokens": toks.astype(np.int32),
                    "max_new": int(rng.integers(2, 17))})
    return out


def packed_runs(views, cfg):
    """Phase 3i: packed prefill at full width (act_bits 32, page 64, 8
    slots, 160 pages, max_len 576: a 2048-position workspace, at most 4
    segments a call). Run P1: packed4, bf16 KV, prefix cache on, half
    the prompts behind a shared system prompt (segments hydrate prefix
    hits); run P2: fused, int8 KV, prefix cache off. Each is served
    packed replaying its graphs, packed eagerly inside disable_graphs(),
    and unpacked replaying its graphs, with phase 3c's checks on each
    pass; the tokens of the three must be equal request by request, the
    packed passes' counts equal, the packed passes must pack and make
    fewer prefill calls than the unpacked one. Returns the kernels'
    launches over the packed graph passes."""
    import numpy as np

    pcfg = cfg.replace(act_bits=32)
    runs = {
        "P1": dict(view="lutq_gemv_packed", backend="auto", kv_bits=16,
                   prefix_cache=True, shared=True),
        "P2": dict(view="lutq_matmul", backend="fused", kv_bits=8,
                   prefix_cache=False, shared=False),
    }
    launches = {}
    for name, r in runs.items():
        r.update(capacity=8, kv_pages=160, max_len=512 + 64,
                 requests=_packing_requests(cfg.vocab, r["shared"]))
        gemm = r["view"]
        out = {}
        for label, mode, pack in (("packed", "graph", True),
                                  ("packed eager", "eager", True),
                                  ("unpacked", "graph", False)):
            out[label] = _engine_pass(f"{name} {label}", mode,
                                      views[r["view"]], pcfg,
                                      dict(r, prefill_pack=pack), gemm,
                                      CALLS_PER_FORWARD)
        pk, ea, up = out["packed"], out["packed eager"], out["unpacked"]
        same = all(np.array_equal(a, b) and np.array_equal(a, c)
                   for a, b, c in zip(pk["tokens"], ea["tokens"],
                                      up["tokens"]))
        log(f"packed run ({name}) packed graph | packed eager | unpacked "
            f"graph: prefill calls {pk['prefill_chunk_calls']} | "
            f"{ea['prefill_chunk_calls']} | {up['prefill_chunk_calls']} "
            f"({pk['packed_groups']} packed groups of "
            f"{pk['packed_requests']} requests), prefill "
            f"{pk['t_prefill_s']:.3f} | {ea['t_prefill_s']:.3f} | "
            f"{up['t_prefill_s']:.3f} s, TTFT p50 "
            f"{pk['ttft_p50_s'] * 1e3:.1f} | {ea['ttft_p50_s'] * 1e3:.1f} | "
            f"{up['ttft_p50_s'] * 1e3:.1f} ms, p99 "
            f"{pk['ttft_p99_s'] * 1e3:.1f} | {ea['ttft_p99_s'] * 1e3:.1f} | "
            f"{up['ttft_p99_s'] * 1e3:.1f} ms, goodput "
            f"{pk['goodput_tok_s']:.1f} | {ea['goodput_tok_s']:.1f} | "
            f"{up['goodput_tok_s']:.1f} tok/s (without the profiler "
            f"{pk['goodput_net_tok_s']:.1f} | {ea['goodput_net_tok_s']:.1f}"
            f" | {up['goodput_net_tok_s']:.1f}), decode steps "
            f"{pk['decode_steps']} | {ea['decode_steps']} | "
            f"{up['decode_steps']}, prefix hits {pk.get('prefix_hits', 0)}"
            f" | {ea.get('prefix_hits', 0)} | {up.get('prefix_hits', 0)}, "
            f"warmup {pk['t_warmup_s']:.3f} | {ea['t_warmup_s']:.3f} | "
            f"{up['t_warmup_s']:.3f} s, peak {pk['peak_gib']:.2f} | "
            f"{ea['peak_gib']:.2f} | {up['peak_gib']:.2f} GiB (reserved "
            f"{pk['reserved_gib']:.2f} | {ea['reserved_gib']:.2f} | "
            f"{up['reserved_gib']:.2f}) | tokens equal {same}")
        check(pk["packed_groups"] >= 1 and ea["packed_groups"] >= 1,
              f"run ({name}): nothing packed")
        check(up["packed_groups"] == 0, f"run ({name}): unpacked packed")
        check(pk["prefill_chunk_calls"] + pk["packed_groups"]
              < up["prefill_chunk_calls"],
              f"run ({name}): {pk['prefill_chunk_calls']} prefill calls "
              f"packed, not fewer than {up['prefill_chunk_calls']}")
        check(same, f"run ({name}): packed and unpacked serves give other "
              f"tokens")
        check(pk["counts"] == ea["counts"],
              f"run ({name}): packed graph and eager passes launch other "
              f"counts")
        if r["shared"]:
            check(pk["prefix_hits"] > 0, f"run ({name}): no prefix hit")
        for k, v in pk["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return launches


# ---------------------------------------------------------------------------
# phase 2g / 3f
# ---------------------------------------------------------------------------

#: phase 3f: the verify window's draft block, the draft view's bits and
#: the tokens a generate makes
SPEC_K, SPEC_DRAFT_BITS, SPEC_GEN = 3, 3, 32
#: phase 3f: the speculative paged engine's eager pass serves the first
#: SPEC_EAGER_LEAD requests of the queue (one batch of 8 slots; the whole
#: 24-request queue took it 50 s on an H100)
SPEC_EAGER_LEAD = 8
#: phase 2g: the slots and draft blocks of the windows whose rows it checks
WINDOW_B, WINDOW_K = (1, 4, 8), (1, 2, 3, 4)
#: phase 2g: (B, k) of windows wider than ROW_STABLE_M rows, whose
#: products run over whole positions at a time (13 and 16 slots: 4
#: positions, then 1; 72 slots: one position a product)
WIDE_WINDOWS = ((13, 4), (16, 4), (72, 1))


def window_row_checks():
    """Phase 2g: each of danube's products and the head, through both
    GEMM kernels, gives the rows of a verify window of B (k + 1) rows the
    bits that the B-row decode step gives them: every block of B rows of
    the window's product equals the product of those B rows alone, for B
    = 1, 4, 8 and k = 1..4. Windows wider than ROW_STABLE_M rows
    (WIDE_WINDOWS) run their products as the window does
    (``lm._rows``), and each position's B rows must equal those B rows
    alone. Fatal; names the first product and M whose rows differ."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.models.lm import _rows

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    shapes = dict({k: s for k, (s, _) in LAYER_SHAPES.items()},
                  head=HEAD_SHAPE)
    sms = build.sm_count(dev)
    for kname, (fn, _) in _gemm_fns().items():
        n = 0
        for label, (Kin, N) in shapes.items():
            _, a, d = _operands(1, Kin, N, 16, torch.bfloat16, gen, dev,
                                KERNELS[kname]["packed"])
            x = torch.randn(max(WINDOW_B) * (max(WINDOW_K) + 1), Kin,
                            generator=gen, device=dev).to(torch.bfloat16)
            for B in WINDOW_B:
                for k in WINDOW_K:
                    M = B * (k + 1)
                    full = fn(x[:M], a, d)
                    for j in range(k + 1):
                        rows = slice(j * B, (j + 1) * B)
                        same = torch.equal(fn(x[rows], a, d), full[rows])
                        n += 1
                        if not same:
                            plan = build.plan_splits(M, N, Kin, sms)
                            die(f"{kname} {label} (Kin={Kin}, N={N}): rows "
                                f"{rows.start}..{rows.stop - 1} of M={M} "
                                f"(B={B}, k={k}) differ from the same "
                                f"{B} rows alone (plan {plan['bm']}x"
                                f"{plan['bn']}, {plan['splits']} splits)")
            for B, k in WIDE_WINDOWS:
                xw = torch.randn(B, k + 1, Kin, generator=gen,
                                 device=dev).to(torch.bfloat16)
                # as ops.lutq_dot hands its x to the kernel
                win = _rows(lambda t: fn(t.reshape(-1, Kin).contiguous(), a,
                                         d).reshape(*t.shape[:-1], -1),
                            xw, build.ROW_STABLE_M)
                for j in range(k + 1):
                    n += 1
                    if not torch.equal(fn(xw[:, j].contiguous(), a, d),
                                       win[:, j]):
                        die(f"{kname} {label} (Kin={Kin}, N={N}): position "
                            f"{j} of a {B * (k + 1)}-row window (B={B}, "
                            f"k={k}, products over whole positions) "
                            f"differs from the same {B} rows alone")
            del a, d, x
        log(f"check {kname}: verify-window rows equal the decode rows bit "
            f"for bit at B = {WINDOW_B}, k = {WINDOW_K} and (B, k) = "
            f"{WIDE_WINDOWS} on danube's products and head ({n} row "
            f"blocks)")
    _window_norm_report(gen, dev)


def _window_norm_report(gen, dev):
    """Why the window's norms run per position (``lm._norm_rows``): an
    RMSNorm over all B (k + 1) rows at once, against the same rows
    normed B at a time as the decode step norms them. Logged only."""
    import torch

    from repro_torch.nn.norms import rmsnorm_apply, rmsnorm_init

    p = rmsnorm_init(LAYER_SHAPES["q/o"][0][0], device=dev)
    p.scale.data = torch.randn(p.scale.shape, generator=gen, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        x = (torch.randn(max(WINDOW_B) * (max(WINDOW_K) + 1), 1,
                         p.scale.numel(), generator=gen, device=dev)
             * 3).to(dtype)
        n = bad = 0
        for B in WINDOW_B:
            for k in WINDOW_K:
                whole = rmsnorm_apply(p, x[:B * (k + 1)])
                for j in range(k + 1):
                    rows = slice(j * B, (j + 1) * B)
                    n += 1
                    bad += not torch.equal(rmsnorm_apply(p, x[rows]),
                                           whole[rows])
        log(f"RMSNorm over a whole window, {str(dtype)[6:]}: {bad} of {n} "
            f"row blocks differ from the decode step's (the window norms "
            f"per position)")


#: phase 2h: the prefill widths whose rows must agree (the paged engine's
#: chunk buckets, a packed call's widths)
PREFILL_M = (16, 32, 64, 128, 256)
#: phase 2h: two other plans of the GEMM tiles, for their rows and
#: cost: the 128 x 256 wgmma tile above 64 rows at the decode split, and
#: the plan before packed prefill (PR 25), the wgmma tile above 64 rows
#: with its own split: (tiles, stable_m) of build.plan_splits
OTHER_PLANS = {
    "wgmma at the decode split": (
        ((8, 8, 256, 2, 8), (16, 16, 256, 2, 8), (64, 64, 128, 2, 8),
         (256, 128, 256, 1, 4), (None, 128, 256, 1, 4)), 256),
    "wgmma, own split": (
        ((8, 8, 256, 2, 8), (16, 16, 256, 2, 8), (64, 64, 128, 2, 8),
         (None, 128, 256, 1, 4)), 64),
}


def prefill_row_checks():
    """Phase 2h: the first m rows of an M-row product equal an m-row
    product bit for bit, at danube's five shapes, for M, m in PREFILL_M,
    both GEMM kernels (bf16 x): a packed prefill call gives each prompt
    the rows its own chunks give it. Fatal on the build's plan; logged
    for OTHER_PLANS. Then the cost of each plan: one forward's 169
    products at M = 128 and 256, CUDA-graph timed, the plans in turns."""
    import functools

    import torch

    from repro_torch.kernels import build

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    shapes = dict({k: s for k, (s, _) in LAYER_SHAPES.items()},
                  head=HEAD_SHAPE)
    sms = build.sm_count(dev)
    stable = build.plan_splits
    plans = {"row-stable": stable}
    plans.update({name: functools.partial(stable, tiles=tiles,
                                          stable_m=top)
                  for name, (tiles, top) in OTHER_PLANS.items()})

    def under(plan, fn, *args):
        build.plan_splits = plans[plan]
        try:
            return fn(*args)
        finally:
            build.plan_splits = stable

    for kname, (fn, _) in _gemm_fns().items():
        ops_ = {}
        for label, (Kin, N) in shapes.items():
            _, a, d = _operands(1, Kin, N, 16, torch.bfloat16, gen, dev,
                                KERNELS[kname]["packed"])
            x = torch.randn(max(PREFILL_M), Kin, generator=gen,
                            device=dev).to(torch.bfloat16)
            for plan, plan_fn in plans.items():
                ys = {M: under(plan, fn, x[:M].contiguous(), a, d)
                      for M in PREFILL_M}
                pairs = [(m, M, torch.equal(ys[M][:m], ys[m]))
                         for M in PREFILL_M for m in PREFILL_M if m < M]
                splits = {M: plan_fn(M, N, Kin, sms)["splits"]
                          for M in PREFILL_M}
                log(f"check {kname} {label} (Kin={Kin}, N={N}) prefill rows"
                    f" [{plan}], first m of M equal to m alone: " + " ".join(
                        f"{m}<{M}:{'=' if ok else 'DIFFERENT'}"
                        for m, M, ok in pairs) + f" (splits {splits})")
                bad = [(m, M) for m, M, ok in pairs if not ok]
                check(plan != "row-stable" or not bad,
                      f"{kname} {label}: prefill rows depend on M at (m, M)"
                      f" = {bad}")
            ops_[label] = [(a, d)] + [
                _operands(1, Kin, N, 16, torch.bfloat16, gen, dev,
                          KERNELS[kname]["packed"])[1:]
                for _ in range(_copies(a.numel()) - 1)]
        for M in PREFILL_M[-2:]:
            xs = {lab: torch.randn(M, shapes[lab][0], generator=gen,
                                   device=dev).to(torch.bfloat16)
                  for lab in shapes}

            def forward():
                for layer in range(N_LAYERS):
                    for lab, (_, calls) in LAYER_SHAPES.items():
                        copies = ops_[lab]
                        for _ in range(calls):
                            fn(xs[lab], *copies[layer % len(copies)])
                fn(xs["head"], *ops_["head"][0])

            ms = {plan: [] for plan in plans}
            for plan in list(plans) + list(plans)[::-1]:
                ms[plan].append(under(plan, time_ms, forward, [()], 2)[0])
            log(f"cost {kname} M={M}: one forward's 169 products, ms (two "
                f"runs in turns): " + " | ".join(
                    f"{plan} {sum(t) / 2:.3f} ({t[0]:.3f}, {t[1]:.3f})"
                    for plan, t in ms.items()))
        del ops_


def serve_speculative(views, cfg):
    """Phase 3f: self-speculative decoding at full width (the phase-3
    serve views at act_bits=32, draft_bits=3, k=3). Returns the launches
    of the speculative runs (graph mode) per kernel."""
    import numpy as np
    import torch

    from repro_torch.models import api
    from repro_torch.runtime.engine import Engine, synthetic_requests
    from repro_torch.runtime.serving import generate

    scfg = cfg.replace(act_bits=32)
    ok, why = api.speculative_supported(scfg)
    check(ok, f"speculative refused: {why}")
    t0 = time.perf_counter()
    # the packed and int8 views hold the same indices: one draft serves
    # both targets
    draft, report = api.draft_view(views["lutq_gemv_packed"],
                                   draft_bits=SPEC_DRAFT_BITS,
                                   with_report=True)
    torch.cuda.synchronize()
    extra = sum(v["draft_bytes"] for v in report.values())
    coarse = sum(not v["shared"] for v in report.values())
    log(f"speculative: draft view ({SPEC_DRAFT_BITS} bits) built in "
        f"{time.perf_counter() - t0:.2f} s: +{extra / 2**20:.1f} MiB, "
        f"{coarse} coarse and {len(report) - coarse} shared leaves")
    check(coarse == len(report) == 9, f"draft view report {report}")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen)
    launches = {"lutq_matmul": 0, "lutq_gemv_packed": 0,
                "paged_attention": 0}
    for kname, backend in (("lutq_gemv_packed", "auto"),
                           ("lutq_matmul", "fused")):
        run_cfg = scfg.replace(kernel_backend=backend)
        res = {}
        for mode in MODES:
            for k in (0, SPEC_K):
                with _mode(mode):
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    _reset_counts()
                    out, st = generate(
                        views[kname], run_cfg, {"tokens": toks},
                        steps=SPEC_GEN, return_stats=True, speculative=k,
                        draft_bits=SPEC_DRAFT_BITS,
                        draft_params=draft if k else None, device="cuda")
                    counts = _read_counts()
                peak = torch.cuda.max_memory_allocated() / 2**30
                res[mode, k] = r = dict(st, tokens=out.cpu(), counts=counts,
                                        peak_gib=peak)
                steps = st["decode_steps"] if k else SPEC_GEN - 1
                r["step_ms"] = st["t_decode_s"] / max(steps, 1) * 1e3
                line = (f"speculative generate [{backend}] k={k} ({mode}): "
                        f"decode {st['decode_tok_s']:.1f} tok/s | "
                        f"{steps} {'rounds' if k else 'steps'} of "
                        f"{r['step_ms']:.2f} ms | warmup "
                        f"{st['t_warmup_s'] * 1e3:.1f} ms | peak {peak:.2f} "
                        f"GiB")
                if k:
                    line += (f" | acceptance {st['acceptance_rate']:.3f}, "
                             f"{st['spec_tokens_per_round']:.2f} tok/round")
                log(line + f" | launches {counts}")
                check(counts["plain"] == 0 and counts["decode"] == 0,
                      f"speculative run went through a plain version: "
                      f"{counts}")
                target = CALLS_PER_FORWARD * (1 + steps)
                drafts = k * CALLS_PER_FORWARD * steps
                want = ({"lutq_gemv_packed": target + drafts,
                         "lutq_matmul": 0} if kname == "lutq_gemv_packed"
                        else {"lutq_gemv_packed": drafts,
                              "lutq_matmul": target})
                got = {g: counts[g] for g in want}
                check(got == want, f"speculative generate [{backend}] k={k}"
                      f" ({mode}): launches {got}, expected {want}")
                if k and mode == "graph":
                    for g, v in got.items():
                        launches[g] += v
        for mode in MODES:
            check(torch.equal(res[mode, SPEC_K]["tokens"],
                              res[mode, 0]["tokens"]),
                  f"[{backend}] ({mode}): speculative tokens differ from "
                  f"k=0's")
        check(torch.equal(res["graph", SPEC_K]["tokens"],
                          res["eager", SPEC_K]["tokens"]),
              f"[{backend}]: graph and eager speculative tokens differ")
        g, e = res["graph", SPEC_K], res["eager", SPEC_K]
        g0, e0 = res["graph", 0], res["eager", 0]
        log(f"speculative generate [{backend}] graph | eager: k={SPEC_K} "
            f"{g['decode_tok_s']:.1f} | {e['decode_tok_s']:.1f} tok/s "
            f"(round {g['step_ms']:.2f} | {e['step_ms']:.2f} ms) against "
            f"k=0 {g0['decode_tok_s']:.1f} | {e0['decode_tok_s']:.1f} tok/s "
            f"(step {g0['step_ms']:.2f} | {e0['step_ms']:.2f} ms); tokens "
            f"equal k=0's in both modes")

    # the paged engine over run (a)'s queue, fused target, int8 KV
    run_cfg = scfg.replace(kernel_backend="fused", kv_cache_bits=8)
    reqs = synthetic_requests(cfg, ENGINE_QUEUE, max_prompt=512, max_new=64,
                              seed=0)
    tokens, passes = {}, {}
    # the speculative engine also serves the queue's first
    # SPEC_EAGER_LEAD requests eagerly, inside disable_graphs()
    for k, mode in ((0, "graph"), (SPEC_K, "graph"), (SPEC_K, "eager")):
        queue = reqs if mode == "graph" else reqs[:SPEC_EAGER_LEAD]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with _mode(mode):
            eng = Engine(views["lutq_matmul"], run_cfg, capacity=8,
                         max_len=512 + 64 + k, kv_pages=160,
                         page_size=ENGINE_PAGE, prefill_pack=False,
                         speculative=k, draft_bits=SPEC_DRAFT_BITS,
                         draft_params=draft if k else None, device="cuda")
            traces = eng.paged_trace_counts()
            check(traces == _paged_traces(eng, mode == "graph"),
                  f"paged speculative engine k={k} ({mode}): {traces} "
                  f"graphs after the warmup")
            for req in queue:
                eng.submit(req["tokens"], max_new=req["max_new"])
            torch.cuda.synchronize()
            _reset_counts()
            profiled, timed_ms, _ = _serve_pass(f"spec k={k}", mode, eng,
                                                {"capacity": 8})
            torch.cuda.synchronize()
        counts = _read_counts()
        check(eng.paged_trace_counts() == traces,
              f"paged speculative engine k={k} ({mode}): the serve "
              f"captured more graphs")
        st = eng.stats()
        peak = torch.cuda.max_memory_allocated() / 2**30
        wall_ms, busy_ms, _, prof_s = profiled
        steps, chunks = st["decode_steps"], st["prefill_chunk_calls"]
        want = {"lutq_matmul": CALLS_PER_FORWARD * (steps + chunks),
                "lutq_gemv_packed": k * CALLS_PER_FORWARD * steps,
                "paged": N_LAYERS * (2 * k + 1) * steps}
        got = {"lutq_matmul": counts["lutq_matmul"],
               "lutq_gemv_packed": counts["lutq_gemv_packed"],
               "paged": counts["paged_attention"]
               + counts["paged_attention_multipass"]}
        line = (f"speculative paged engine k={k} ({mode}) [fused, int8 KV, "
                f"8 slots, {len(queue)} requests]: decode "
                f"{st['decode_tok_s']:.1f} "
                f"tok/s | goodput {st['goodput_tok_s']:.1f} tok/s | {steps} "
                f"{'rounds' if k else 'steps'} of "
                f"{st['t_decode_s'] / max(steps, 1) * 1e3:.2f} ms, "
                f"{chunks} prefill chunks, prefill {st['t_prefill_s']:.2f} "
                f"s ({st['t_prefill_s'] / max(chunks, 1) * 1e3:.1f} ms a "
                f"chunk), wall {st['wall_s']:.2f} s ({prof_s:.2f} s of it "
                f"the profiler's start, stop and reading) | TTFT p50 "
                f"{st['ttft_p50_s'] * 1e3:.0f} ms p99 "
                f"{st['ttft_p99_s'] * 1e3:.0f} ms | warmup "
                f"{st['t_warmup_s']:.3f} s | peak {peak:.2f} GiB "
                f"({torch.cuda.max_memory_reserved() / 2**30:.2f} reserved) "
                f"| a "
                f"{'round' if k else 'step'} {timed_ms:.2f} ms without the "
                f"profiler, {wall_ms:.1f} ms profiled with the card busy "
                f"{busy_ms:.2f} ms")
        if k:
            line += (f" | acceptance {st['acceptance_rate']:.3f}, "
                     f"{st['spec_tokens_per_round']:.2f} tok/round")
        log(line + f" | launches {counts}")
        check(got == want, f"paged speculative engine k={k}: launches "
              f"{got}, expected {want}")
        check(counts["plain"] == 0 and counts["decode"] == 0,
              f"paged speculative engine k={k} ran a plain version")
        res = [eng.results[i] for i in sorted(eng.results)]
        check(len(res) == len(queue), f"paged speculative engine k={k}: "
              f"{len(res)} results of {len(queue)} requests")
        for req, r in zip(queue, res):
            check(r["n_new"] == req["max_new"] and r["finish"] == "length",
                  f"paged speculative engine k={k} request {r['rid']}: "
                  f"{r['n_new']} of {req['max_new']} tokens")
        toks = [r["tokens"] for r in res]
        passes[k, mode] = (toks, counts)
        if mode == "eager":
            # at act_bits 32 a request's tokens do not depend on the
            # requests beside it (the graph passes with and without
            # speculation agree request by request), so the eager pass
            # over the queue's head is held against the graph pass's
            g_toks, _ = passes[k, "graph"]
            check(all(np.array_equal(a, b) for a, b in zip(toks, g_toks)),
                  f"paged speculative engine k={k}: the eager pass gives "
                  f"other tokens than the graph pass")
            log(f"speculative paged engine k={k}: the eager pass over the "
                f"queue's first {len(queue)} requests gives the graph "
                f"pass's tokens, request by request, and its launch counts "
                f"are its rounds' and chunks'")
            del eng
            torch.cuda.empty_cache()
            continue
        tokens[k] = toks
        if k:
            launches["lutq_matmul"] += got["lutq_matmul"]
            launches["lutq_gemv_packed"] += got["lutq_gemv_packed"]
            launches["paged_attention"] += got["paged"]
        del eng
        torch.cuda.empty_cache()
    same = [i for i, (a, b) in enumerate(zip(tokens[0], tokens[SPEC_K]))
            if not np.array_equal(a, b)]
    check(not same, f"paged speculative engine: requests {same} differ "
          f"from the engine without speculation")
    log(f"speculative paged engine: tokens equal the plain engine's, "
        f"request by request ({len(reqs)} requests)")
    for g, v in launches.items():
        check(v > 0, f"the speculative path launched no {g}")
    return launches


# phase 3e
# ---------------------------------------------------------------------------

def _pow2_guard_report(view):
    """(body leaves, leaves pow2-encoded with frozen scales, {logical
    leaf: 7 + span + ceil(log2 Kin)} over every logical leaf, the
    logical leaves the guard kept on a float dictionary). A kept leaf's
    bits are those of its dictionaries' own sign+exponent planes."""
    from collections import defaultdict

    import torch

    from repro_torch.core.lutq import LutqState, pow2_encode
    from repro_torch.core.policy import pow2_guard_bits
    from repro_torch.nn.tree import logical_path, tree_paths

    groups = defaultdict(list)
    for path, leaf in tree_paths(view):
        if isinstance(leaf, LutqState):
            groups[logical_path(path)[0]].append(leaf)
    leaves = [x for g in groups.values() for x in g]
    encoded = [x for x in leaves
               if x.d.dtype == torch.int8 and x.act is not None]
    bits, kept = {}, []
    for p, g in groups.items():
        d = torch.stack([x.d for x in g])
        if d.dtype != torch.int8:
            kept.append("/".join(p))
            d = pow2_encode(d)
        bits["/".join(p)] = pow2_guard_bits(d, g[0].a.shape[-2])
    return len(leaves), len(encoded), bits, kept


def serve_pow2_full_width():
    """Phase 3e: full-width danube under serving_pow2, calibrated, served
    through generate and one paged engine run. Returns its numbers."""
    from collections import Counter

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.rules import serving_pow2
    from repro_torch.models import api
    from repro_torch.runtime.engine import Engine, synthetic_requests
    from repro_torch.runtime.serving import generate

    cfg = get_config("h2o-danube-1.8b").replace(quant=serving_pow2(),
                                                act_bits=8)
    calib = torch.randint(0, cfg.vocab, (CALIB_BATCH, CALIB_LEN),
                          generator=torch.Generator().manual_seed(5))
    t0 = time.perf_counter()
    view, manifest = api.serve_state(cfg, seed=0, with_manifest=True,
                                     calib_batch={"tokens": calib.cuda()},
                                     device="cuda")
    torch.cuda.synchronize()
    n_leaves, n_encoded, bits, _ = _pow2_guard_report(view)
    kinds = Counter((m["backend"], m["encoding"], m["act_frozen"])
                    for m in manifest.values())
    log(f"serving_pow2 {cfg.name}: init + quantize + calibrate ({CALIB_BATCH}"
        f" x {CALIB_LEN} tokens) + serve view {time.perf_counter() - t0:.1f}"
        f" s | manifest (backend, encoding, act_frozen): {dict(kinds)} | "
        f"{n_encoded} of {n_leaves} body leaves pow2-encoded with frozen "
        f"scales | largest 7 + span + ceil(log2 Kin) = "
        f"{max(bits.values())} ({bits})")
    check(n_leaves == SHIFT_CALLS_PER_FORWARD == n_encoded,
          f"{n_encoded} of {n_leaves} body leaves pow2-encoded with frozen "
          f"scales, expected all {SHIFT_CALLS_PER_FORWARD}")
    check(all(m["backend"] == "pow2" for m in manifest.values()),
          f"not every leaf resolves to pow2: {manifest}")
    check(max(bits.values()) <= 31, f"guard bits {bits}")

    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen)
    oracle_cfg = cfg.replace(kernel_backend="decode")
    with torch.inference_mode():
        logits = {be: api.prefill(view, cfg.replace(kernel_backend=be),
                                  {"tokens": toks.cuda()})[0]
                  for be in ("decode", "auto")}
    same_logits = bool(torch.equal(logits["decode"], logits["auto"]))
    check(bool(torch.isfinite(logits["auto"]).all())
          and logits["auto"].shape == (BATCH, 1, cfg.vocab),
          "pow2 prefill logits not finite or of the wrong shape")
    generate(view, cfg, {"tokens": toks}, steps=2, device="cuda")  # warm-up
    torch.cuda.synchronize()
    per_mode = {mode: _pow2_generate(mode, view, cfg, oracle_cfg, toks,
                                     same_logits) for mode in MODES}
    graph, eager = per_mode["graph"], per_mode["eager"]
    check(torch.equal(graph["tokens"], eager["tokens"])
          and graph["counts"] == eager["counts"],
          "pow2 generate: graph and eager serves differ")
    stats, counts = graph, graph["counts"]

    run = dict(backend="auto", kv_bits=8, capacity=8, kv_pages=160,
               max_len=512 + 64,
               requests=synthetic_requests(cfg, ENGINE_QUEUE, max_prompt=512,
                                           max_new=64, seed=0))
    eng = engine_run("pow2", view, cfg, run, "lutq_shift",
                     SHIFT_CALLS_PER_FORWARD)
    # the engine's decode steps run lutq_shift at M = capacity: the same
    # queue through the integer decode oracle must give the same tokens
    t0 = time.perf_counter()
    oracle_eng = Engine(view, oracle_cfg.replace(kv_cache_bits=run["kv_bits"]),
                        capacity=run["capacity"], max_len=run["max_len"],
                        kv_pages=run["kv_pages"], page_size=ENGINE_PAGE,
                        device="cuda")
    for req in run["requests"]:
        oracle_eng.submit(req["tokens"], max_new=req["max_new"])
    oracle_toks = [x["tokens"] for x in oracle_eng.run()]
    same = [torch.equal(torch.as_tensor(x), torch.as_tensor(y))
            for x, y in zip(eng.pop("tokens"), oracle_toks)]
    log(f"engine run (pow2) against the decode oracle's engine run "
        f"({time.perf_counter() - t0:.1f} s): tokens identical in "
        f"{sum(same)} of {len(same)} requests")
    check(len(same) == len(run["requests"]) and all(same),
          "pow2 engine tokens: kernel and oracle differ")
    del oracle_eng
    audited = audit_full_width(view, cfg, toks)
    del view
    torch.cuda.empty_cache()
    return dict(stats, launches=counts["lutq_shift"]
                + eng["launches"]["lutq_shift"], eager=eager, engine=eng,
                guard_bits=max(bits.values()), audit=audited)


def _pow2_generate(mode, view, cfg, oracle_cfg, toks, same_logits):
    """Phase 3e's generate in ``mode``: its launch counts, the oracle's
    tokens, and one lutq_shift kernel a call and no more memsets than the
    oracle's generate in the profiler's list. Returns its numbers."""
    import torch

    from repro_torch.runtime.serving import generate

    with _mode(mode):
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        out, stats = generate(view, cfg, {"tokens": toks}, steps=STEPS_GEN,
                              return_stats=True, device="cuda")
        counts = _read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        oracle = generate(view, oracle_cfg, {"tokens": toks},
                          steps=STEPS_GEN, device="cuda")
    expected = STEPS_GEN * SHIFT_CALLS_PER_FORWARD
    log(f"serve [pow2] B={BATCH} P={PROMPT} gen={STEPS_GEN} ({mode}): "
        f"prefill {stats['t_prefill_s'] * 1e3:.1f} ms | decode "
        f"{stats['decode_tok_s']:.1f} tok/s | warmup "
        f"{stats['t_warmup_s'] * 1e3:.1f} ms | peak {peak:.2f} GiB | "
        f"launches {counts} | prefill logits of the decode oracle and the "
        f"kernel bit-identical {same_logits} | greedy tokens identical "
        f"{bool(torch.equal(out, oracle))}")
    log(f"  sample tokens {out[0, :8].tolist()}")
    check(counts["lutq_shift"] == expected, f"lutq_shift ({mode}): "
          f"{counts['lutq_shift']} launches in the serve run, expected "
          f"{expected}")
    check(counts["lutq_matmul"] == 0 and counts["lutq_gemv_packed"] == 0
          and counts["plain"] == 0 and counts["decode"] == 0,
          f"the pow2 run ({mode}) went through another path: {counts}")
    check(same_logits, "pow2 prefill logits: kernel and oracle differ")
    check(torch.equal(out, oracle), "pow2 tokens: kernel and oracle differ")
    check(out.shape == (BATCH, STEPS_GEN) and bool(
        ((out >= 0) & (out < cfg.vocab)).all()), "pow2 tokens out of range")

    def profiled(run_cfg):
        def run():
            generate(view, run_cfg, {"tokens": toks}, steps=STEPS_GEN,
                     device="cuda")
            torch.cuda.synchronize()
        return run
    with _mode(mode):
        _reset_counts()
        wall_ms, busy_ms, rows = profile_run(profiled(cfg),
                                             f"generate ({mode})")
        calls = _read_counts()["lutq_shift"]
        _, _, oracle_rows = profile_run(
            profiled(oracle_cfg), f"generate (integer decode oracle, {mode})")
    kernels = sum(c for _, c, k in rows if "lutq_shift" in k)
    memsets = [sum(c for _, c, k in r if "emset" in k)
               for r in (rows, oracle_rows)]
    log(f"  profiled pow2 generate ({mode}): {calls} lutq_shift calls, "
        f"{kernels} lutq_shift kernels on the card "
        f"({sum(ms for ms, _, k in rows if 'lutq_shift' in k):.3f} ms), "
        f"{memsets[0]} memsets in the run ({memsets[1]} in the same "
        f"generate through the decode oracle, which launches no kernel of "
        f"the port)")
    check(calls == expected and kernels == calls,
          f"lutq_shift ({mode}): {kernels} kernels for {calls} calls, "
          f"expected one each, {expected} in all")
    check(memsets[0] <= memsets[1],
          f"lutq_shift adds memsets to a pow2 generate ({mode}): {memsets}")
    return dict(stats, peak_gib=peak, counts=counts, tokens=out.cpu(),
                profiled_wall_ms=wall_ms, profiled_busy_ms=busy_ms)


# ---------------------------------------------------------------------------
# phase 3k
# ---------------------------------------------------------------------------

#: phase 3k: the paged engine's queue (8 prompts of 64-128 tokens, enough
#: new tokens that every slot is live for the audited and the refused
#: step) and the decode steps of its audited generate
AUDIT_PROMPTS, AUDIT_NEW, AUDIT_GEN = (64, 128), 32, 4


def _audited(name, fn, view, cfg, per_token, rows):
    """Audit ``fn`` (eager) with params=view, whose rules hold every fp
    dot off the quantized shapes: 168 lutq_shift int dots a forward,
    int_dot_flops = sum(M) x sum(Kin N) over ``rows`` (each forward's M),
    one head dot a forward beside the attention's. Returns its
    count_ops."""
    from repro_torch.kernels import audit

    t0 = time.perf_counter()
    rep = audit.audit_multiplierless(fn, params=view)
    c = audit.count_ops(rep)
    head = [d for d in rep["fp_dots"] if d["out"][-1] == cfg.vocab]
    attn = [d for d in rep["fp_dots"] if d["out"][-1] != cfg.vocab]
    kinds = sorted({d["op"] for d in attn})
    log(f"  audit {name}: PASS in {time.perf_counter() - t0:.2f} s | "
        f"count_ops {c} | int dots: {len(rep['int_dots'])} lutq_shift "
        f"launches over {len(rows)} forward(s) at M = {rows} | fp dots off "
        f"the quantized shapes: head {len(head)}, attention {len(attn)} "
        f"({', '.join(kinds)})")
    check(all(d["kernel"] and d["op"] == "lutq_shift"
              for d in rep["int_dots"]),
          f"audit {name}: an int dot that is no lutq_shift launch")
    check(c["n_int_dots"] == SHIFT_CALLS_PER_FORWARD * len(rows),
          f"audit {name}: {c['n_int_dots']} int dots, expected "
          f"{SHIFT_CALLS_PER_FORWARD} x {len(rows)}")
    check(c["int_dot_flops"] == sum(rows) * per_token,
          f"audit {name}: int_dot_flops {c['int_dot_flops']} != "
          f"{sum(rows)} x {per_token}")
    check(len(head) == len(rows) and bool(attn),
          f"audit {name}: {len(head)} head dots, {len(attn)} attention dots")
    return c


def _refused(name, exc, match, fn):
    """``fn`` must raise ``exc`` with ``match`` in its message."""
    try:
        fn()
    except exc as e:
        msg = str(e)
        check(all(m in msg for m in match),
              f"audit negative {name}: raised without {match}: {msg[:300]}")
        log(f"  audit negative {name}: raised {exc.__name__}: {msg[:160]}")
        return
    die(f"audit negative {name}: the audit passed")


def audit_full_width(view, cfg, toks):
    """Phase 3k: the multiply audit (repro_torch.kernels.audit) of the
    full-width serving_pow2 view at phase 3e's prompts, eager: prefill,
    one decode step, one paged-engine decode step and generate pass with
    168 lutq_shift int dots a forward; the float-dictionary kernels, the
    integer decode oracle on the card and a graph replay are refused.
    Returns {"launches": the phase's kernel launches, "seconds", "ops"}."""
    import torch

    from repro_torch.core.lutq import LutqState
    from repro_torch.kernels import audit, ops
    from repro_torch.kernels.ref import pack4_kin
    from repro_torch.launch.serve_edge import op_budget, storage_bits
    from repro_torch.models import api
    from repro_torch.nn.tree import tree_paths
    from repro_torch.runtime.engine import Engine, disable_graphs
    from repro_torch.runtime.serving import adapt_prefill_cache, generate

    t_start = time.perf_counter()
    per_token = sum(int(x.a.shape[0]) * int(x.a.shape[1])
                    for _, x in tree_paths(view) if isinstance(x, LutqState))
    _, tot, dense = op_budget(view)
    q_bits, dense_bits = storage_bits(view)
    log(f"phase 3k: memory.affine_shift_ops of one token over the "
        f"{SHIFT_CALLS_PER_FORWARD} body leaves: adds {tot['adds']}, shifts "
        f"{tot['shifts']}, fp_mults {tot['fp_mults']} ({dense} dense "
        f"multiplies); pow2_layer_bits {q_bits / 8 / 2**20:.1f} MiB against "
        f"{dense_bits / 8 / 2**20:.1f} MiB f32; sum of Kin x N {per_token}")
    check(tot["adds"] == per_token, "affine_shift_ops adds != sum Kin x N")
    B, P = toks.shape
    toks = toks.cuda()
    _reset_counts()
    out = {}
    with torch.inference_mode():
        def prefill():
            out["prefill"] = api.prefill(view, cfg, {"tokens": toks})
            return out["prefill"][0]
        res = {"prefill": _audited("api.prefill", prefill, view, cfg,
                                   per_token, [B * P])}
        logits, cache = out["prefill"]
        cache = adapt_prefill_cache(cfg, cache, B, P + 8)
        tok = torch.argmax(logits[:, -1].float(), -1)[:, None].to(
            torch.int32)
        res["decode_step"] = _audited(
            "api.decode_step",
            lambda: api.decode_step(view, cfg, tok, cache)[0], view, cfg,
            per_token, [B])
        del cache, out["prefill"]

    gen = torch.Generator().manual_seed(3)
    run_cfg = cfg.replace(kv_cache_bits=8)
    with disable_graphs():
        eng = Engine(view, run_cfg, capacity=8, max_len=512 + 64,
                     kv_pages=160, page_size=ENGINE_PAGE, device="cuda")
        for _ in range(8):
            n = int(torch.randint(*AUDIT_PROMPTS, (), generator=gen))
            eng.submit(torch.randint(0, cfg.vocab, (n,), generator=gen,
                                     dtype=torch.int32).numpy(),
                       max_new=AUDIT_NEW)
        while eng.queue or eng.prefilling:
            eng.step()
        check(all(s is not None for s in eng.slots),
              "phase 3k: the paged engine's slots are not all live")
        res["engine_step"] = _audited("paged Engine.step (disable_graphs)",
                                      eng.step, view, run_cfg, per_token,
                                      [eng.capacity])
        res["generate"] = _audited(
            f"generate(steps={AUDIT_GEN}) (disable_graphs)",
            lambda: generate(view, cfg, {"tokens": toks}, steps=AUDIT_GEN,
                             device="cuda"),
            view, cfg, per_token, [B * P] + [B] * (AUDIT_GEN - 1))

    # negatives: a float dictionary through the two LUT-decode kernels at
    # danube's wi shape, the integer decode oracle on the card (float64
    # aten mm) and a graph replay
    g = torch.Generator(device="cuda").manual_seed(4)
    kin, n = LAYER_SHAPES["wi/wg"][0]
    d = torch.sort(torch.randn(16, device="cuda", generator=g)).values
    a = torch.randint(0, 16, (kin, n), device="cuda", generator=g,
                      dtype=torch.int8)
    x = torch.randn(B, kin, device="cuda", generator=g)
    for backend, leaf in (("fused", LutqState(None, d, a)),
                          ("packed4", LutqState(None, d, pack4_kin(a)))):
        kname = "lutq_matmul" if backend == "fused" else "lutq_gemv_packed"
        _refused(f"{backend} ({kin}, {n}) leaf", AssertionError,
                 ("decoded-weight matmul", f"'op': '{kname}'",
                  "'kernel': True"),
                 lambda: audit.audit_multiplierless(
                     lambda: ops.lutq_dot(x, leaf, backend=backend),
                     weight_shapes=[(kin, n)]))
    oracle_cfg = cfg.replace(kernel_backend="decode")
    with torch.inference_mode():
        _refused("integer decode oracle's prefill on the card",
                 AssertionError,
                 ("decoded-weight matmul", "'op': 'mm'", "'dtype': 'f64'"),
                 lambda: audit.audit_multiplierless(
                     lambda: api.prefill(view, oracle_cfg,
                                         {"tokens": toks})[0],
                     params=view))
    eng.step()  # captures the decode step's graph
    check(eng.paged_trace_counts()["decode"] == 1,
          "phase 3k: the engine captured no decode graph")
    _refused("decode-step graph replay", RuntimeError,
             ("disable_graphs",), lambda: audit.record(eng.step))
    del eng
    launches = _read_counts()
    check(launches["plain"] == 0, f"phase 3k ran a plain version: {launches}")
    seconds = time.perf_counter() - t_start
    log(f"phase 3k {seconds:.1f} s | launches {launches}")
    return dict(launches=launches, seconds=seconds, ops=res)


# ---------------------------------------------------------------------------
# phase 3b
# ---------------------------------------------------------------------------

def _train_args(*flags, arch="h2o-danube-1.8b"):
    import torch

    from repro_torch.launch import train as train_cli

    args = train_cli.parser().parse_args(["--arch", arch, *flags])
    args.device = torch.device(args.device)
    return args


def _leaves(model):
    from repro_torch.nn.tree import QuantKernel

    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, QuantKernel)]


def _host_memory() -> str:
    info = {}
    for line in Path("/proc/meminfo").read_text().splitlines():
        key, _, val = line.partition(":")
        info[key] = int(val.split()[0]) * 1024
    return (f"host memory {info['MemAvailable'] / 1e9:.1f} GB available of "
            f"{info['MemTotal'] / 1e9:.1f} GB")


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def _ckpt_dir(need_bytes: float, what: str) -> str:
    """A new temporary directory for a checkpoint of ``what``; logs its
    free space and the host's memory, and fails with the sizes where
    fewer than ``need_bytes`` are free."""
    import shutil
    import tempfile

    d = tempfile.mkdtemp(prefix="lutq_ckpt_")
    free = shutil.disk_usage(d).free
    log(f"{what} checkpoint directory {d}: {free / 1e9:.1f} GB free | "
        f"{_host_memory()}")
    check(free >= need_bytes, f"{d} has {free / 1e9:.1f} GB free, the "
          f"{what} checkpoint needs {need_bytes / 1e9:.0f} GB")
    return d


def train_full_width():
    """Full-width danube trained 3 steps through the CLI's build path and
    TrainLoop into a checkpoint (phase 3b'), served in memory before the
    state goes; returns the phase's numbers and what phase 3g needs."""
    import torch

    from repro_torch.core.policy import serve_view
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.kernels import kmeans_stats
    from repro_torch.launch import train as train_cli
    from repro_torch.models import api
    from repro_torch.runtime.loop import TrainLoop
    from repro_torch.runtime.serving import generate

    ckpt_dir = _ckpt_dir(CKPT_FREE_BYTES, "full-width train")
    args = _train_args("--steps", str(TRAIN_STEPS), "--batch",
                       str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                       "--vocab", "0", "--device", "cuda")
    t0 = time.perf_counter()
    cfg, state, step_fn = train_cli.build(args)
    torch.cuda.synchronize()
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
           cfg.vocab) == (N_LAYERS, 2560, 32, 8, 6912, 32000),
          f"not full-width danube: {cfg}")
    spec = cfg.quant
    leaves = _leaves(state.model)
    n_leaves = len(leaves)
    per_step = (spec.kmeans_iters + 1) * n_leaves
    log(f"train {cfg.name}: init + quantize {time.perf_counter() - t0:.1f} s"
        f" | {n_leaves} quantized leaves | spec bits={spec.bits} "
        f"{spec.constraint} kmeans_iters={spec.kmeans_iters} | act_bits "
        f"{cfg.act_bits} | B={args.batch} S={args.seq} | remat {cfg.remat}")
    check(n_leaves == 7 * N_LAYERS + 2, f"{n_leaves} quantized leaves")
    watch = {n: m.w.detach().clone() for n, m in
             (leaves[0], leaves[n_leaves // 2], leaves[-1])}
    lm = MarkovLM(cfg.vocab, seed=args.data_seed)
    launches = []

    def counted_step(st, batch):
        before = kmeans_stats.COUNTS["launches"]
        out = step_fn(st, batch)
        launches.append(kmeans_stats.COUNTS["launches"] - before)
        return out

    loop = TrainLoop(counted_step, train_cli.batch_fn(lm, args, args.device),
                     log_every=1, log_fn=log, ckpt_dir=ckpt_dir,
                     quant_policy=api.resolved_policy(cfg))
    save_s = []
    save = loop.ckpt.save

    def timed_save(tree, step):  # the host snapshot and the write
        t0 = time.perf_counter()
        save(tree, step)
        loop.ckpt.wait()
        save_s.append(time.perf_counter() - t0)
    loop.ckpt.save = timed_save
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    state, step = loop.run(state, TRAIN_STEPS, handle_signals=False)
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(step == TRAIN_STEPS, f"trained {step} steps")
    ckpt_bytes = _dir_bytes(ckpt_dir)
    check(len(save_s) == 1 and ckpt_bytes > 0, "no final checkpoint")
    log(f"checkpoint at step {step}: {ckpt_bytes / 1e9:.2f} GB on disk, "
        f"saved in {save_s[0]:.1f} s (host snapshot and write) | "
        f"{_host_memory()}")
    ms = [h["dt"] * 1e3 for h in loop.history]
    losses = [h["loss"] for h in loop.history]
    tok_s = [TRAIN_BATCH * TRAIN_SEQ / (t / 1e3) for t in ms]
    log(f"train steps: ms {['%.1f' % t for t in ms]} | tokens/s "
        f"{['%.0f' % t for t in tok_s]} | loss {['%.4f' % x for x in losses]}"
        f" | grad_norm {['%.3f' % h['grad_norm'] for h in loop.history]} | "
        f"peak {peak:.2f} GiB | launches {counts} per step {launches}")
    check(all(math.isfinite(x) for x in losses), f"loss not finite: {losses}")
    check(launches == [per_step] * TRAIN_STEPS,
          f"kmeans_stats launched {launches} per step, expected {per_step}")
    check(counts["plain"] == 0, f"a plain version ran: {counts}")
    check(counts["lutq_matmul"] == 0 and counts["lutq_gemv_packed"] == 0,
          f"train-form leaves reached a serve kernel: {counts}")
    for name, mod in leaves:
        d = mod.d
        check(bool((d[1:] >= d[:-1]).all()), f"{name}: dictionary unsorted")
        mant, _ = torch.frexp(d[d != 0])
        check(bool((mant.abs() == 0.5).all()),
              f"{name}: a dictionary entry is not a power of two: {d}")
    moved = {n: float((dict(leaves)[n].w.detach() - w0).abs().max())
             for n, w0 in watch.items()}
    log(f"masters moved (max |w - w0|): {moved}")
    check(all(v > 0 for v in moved.values()), "the masters did not move")

    # the trained model as checkpointed, served in memory: phase 3g's
    # tokens from the checkpoint must equal these
    policy = api.resolved_policy(cfg)
    view = serve_view(state.model, pack4=True, policy=policy)
    toks = torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                         generator=torch.Generator().manual_seed(1))
    t_mem = generate(view, cfg, {"tokens": toks}, steps=STEPS_GEN,
                     device="cuda").cpu()
    log(f"trained model served in memory (packed4, graph): tokens "
        f"{t_mem[0, :8].tolist()}")
    del view

    batch = loop.make_batch(TRAIN_STEPS)

    def one_step():
        step_fn(state, batch)
        torch.cuda.synchronize()
    wall, busy, rows = profile_run(one_step, "one training step")
    km_ms = sum(r[0] for r in rows if "kmeans" in r[2])
    log(f"  kmeans_stats in the profiled step: {km_ms:.2f} ms = "
        f"{km_ms / wall * 100:.2f}% of the step, "
        f"{km_ms / busy * 100:.2f}% of device time")
    # AdamW's roots over every second moment of the step: float64 and
    # rounded once (optimizers.sqrt_rn_) against one float32 pass
    from repro_torch.optim.optimizers import sqrt_rn_

    moments = list(state.opt_state["v"].values())
    roots = {}
    for name, fn in (("float32 _foreach_sqrt_", torch._foreach_sqrt_),
                     ("float64 sqrt_rn_", sqrt_rn_)):
        xs = [v.clone() for v in moments]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn(xs)
        end.record()
        torch.cuda.synchronize()
        roots[name] = (start.elapsed_time(end), (time.perf_counter() - t0) * 1e3)
        del xs
    log(f"  AdamW's roots over {len(moments)} moments "
        f"({sum(v.numel() for v in moments)} elements) a step: "
        + ", ".join(f"{k} {d:.2f} ms on the stream ({h:.2f} ms host wall)"
                    for k, (d, h) in roots.items()))
    out = dict(launches=counts["kmeans_stats"], n_leaves=n_leaves,
               per_step=per_step, ms=ms, tok_s=tok_s, peak_gib=peak,
               idle=1 - busy / wall, kmeans_share=km_ms / wall,
               ckpt_dir=ckpt_dir, cfg=cfg, toks=toks, t_mem=t_mem)
    del state, loop, step_fn, watch, moments, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _serve_cli(*flags):
    """repro_torch.launch.serve.main on ``flags`` in this process: (its
    return code, its standard output, the launch counts of the call)."""
    from repro_torch.launch import serve as serve_cli

    buf = io.StringIO()
    _reset_counts()
    with contextlib.redirect_stdout(buf):
        rc = serve_cli.main(["--arch", "h2o-danube-1.8b", *flags])
    counts = _read_counts()
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"  | {line}")
    return rc, out, counts


def _add(total: dict, counts: dict) -> None:
    for k in KERNELS:
        total[k] = total.get(k, 0) + counts.get(k, 0)


def handoff_full_width(trained, handoff):
    """Phase 3g: the full-width checkpoint of phase 3b' served from disk,
    masters and moments never on the card; then through the serve CLI.
    Adds the kernels' launches to ``handoff``."""
    import shutil

    import numpy as np
    import torch

    from repro_torch import interop
    from repro_torch.checkpoint import ckpt
    from repro_torch.core.policy import serve_view
    from repro_torch.kernels.ref import unpack4_kin
    from repro_torch.launch.serve import check_ckpt_shapes, footprint_bytes
    from repro_torch.models import api
    from repro_torch.nn.tree import QuantKernel
    from repro_torch.runtime.serving import generate

    d, toks, t_mem = trained["ckpt_dir"], trained["toks"], trained["t_mem"]
    cfg = trained["cfg"].replace(quant=ckpt.load_policy(d))
    policy = api.resolved_policy(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, step = ckpt.restore_params(d)
    t1 = time.perf_counter()
    check_ckpt_shapes(cfg, params["trainable"])
    t2 = time.perf_counter()
    model = interop.from_train_params(params, cfg, pack4=True, policy=policy,
                                      device="cuda")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    view = serve_view(model, pack4=True, policy=policy)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() - base
    view_bytes = footprint_bytes(view)
    log(f"handoff of step {step}: restore_params {t1 - t0:.3f} s, "
        f"check_ckpt_shapes {t2 - t1:.3f} s, from_train_params "
        f"{t3 - t2:.2f} s, serve_view {t4 - t3:.3f} s | peak allocated "
        f"above the baseline {peak / 2**30:.3f} GiB, serve view "
        f"{view_bytes / 2**30:.3f} GiB | {_host_memory()}")
    check(peak <= view_bytes + 2**30,
          f"the handoff's peak {peak / 2**30:.3f} GiB exceeds the serve "
          f"view's {view_bytes / 2**30:.3f} GiB + 1 GiB")
    kernels = [(n, m) for n, m in model.named_modules()
               if isinstance(m, QuantKernel)]
    check(len(kernels) == 7 * N_LAYERS + 2 and
          all(m.w.is_meta for _, m in kernels),
          "from_train_params materialised a master")
    static = params["static"]
    for name, mod in kernels:
        parts = name.split(".")
        i = None
        if parts[0] == "layers":
            i, parts = int(parts[1]), [parts[0]] + parts[2:]
        node = static
        for k in parts:
            node = node[k]
        want_a, want_d = node["__lutq_a"], node["__lutq_d"]
        if i is not None:
            want_a, want_d = want_a[i], want_d[i]
        a = mod.a if mod.a.dtype == torch.int8 else unpack4_kin(mod.a)
        check(torch.equal(a.cpu(), torch.from_numpy(np.array(want_a)))
              and torch.equal(mod.d.cpu(), torch.from_numpy(
                  np.array(want_d))),
              f"{name}: d or a differ from the checkpoint's")
    log(f"  d and unpacked a of all {len(kernels)} leaves equal the "
        f"checkpoint's bit for bit")
    del model, kernels, params, static
    expected = STEPS_GEN * CALLS_PER_FORWARD
    for mode in MODES:
        with _mode(mode):
            _reset_counts()
            out = generate(view, cfg, {"tokens": toks}, steps=STEPS_GEN,
                           device="cuda").cpu()
            counts = _read_counts()
        _add(handoff, counts)
        log(f"  generate from the checkpoint ({mode}): tokens equal the "
            f"in-memory model's {torch.equal(out, t_mem)} | {counts}")
        check(torch.equal(out, t_mem), f"served from the checkpoint "
              f"({mode}), the tokens differ from the in-memory model's")
        check(counts["lutq_gemv_packed"] == expected
              and counts["plain"] == 0 and counts["lutq_matmul"] == 0,
              f"generate ({mode}) launched {counts}, expected "
              f"{expected} lutq_gemv_packed")
    del view
    gc.collect()
    torch.cuda.empty_cache()
    for flags, kernel in (
            (["--pack4", "--engine", "--kv-pages", "160", "--page-size",
              "64", "--max-batch", "8", "--queue", "24", "--prompt-len",
              "512", "--gen", "64"], ("lutq_gemv_packed",
                                      "paged_attention")),
            (["--kernel-backend", "fused", "--batch", "4", "--prompt-len",
              "128", "--gen", "16"], ("lutq_matmul",))):
        t0 = time.perf_counter()
        rc, out, counts = _serve_cli("--ckpt-dir", d, *flags)
        _add(handoff, counts)
        log(f"  serve CLI {' '.join(flags[:2])}: rc {rc} in "
            f"{time.perf_counter() - t0:.1f} s | {counts}")
        check(rc == 0, f"serve CLI returned {rc}")
        check(f"restored train checkpoint step {step} from {d} (policy "
              "from manifest)" in out, "serve CLI: no restored line")
        check("4-bit/pow2 (K=16, min_size=4096)" in out
              and "min_size=1024" not in out,
              "serve CLI: not the manifest's policy")
        check(all(counts[k] > 0 for k in kernel) and counts["plain"] == 0,
              f"serve CLI {flags[:2]}: launches {counts}")
    shutil.rmtree(d)


def text_path_e2e(handoff):
    """Phase 3h: the reference's train_e2e recipe (~57M weights, 300
    steps of 4 x 256 bytes of this checkout) through
    repro_torch.launch.train_e2e into checkpoints, then its last
    checkpoint served greedy at act_bits=8 and, at act_bits=32,
    speculatively beside plain greedy. Adds the launches to
    ``handoff``."""
    import shutil
    import statistics

    import torch

    from repro_torch import interop
    from repro_torch.checkpoint import ckpt
    from repro_torch.core.policy import serve_view
    from repro_torch.data.text import byte_batch
    from repro_torch.launch import train_e2e
    from repro_torch.models import api
    from repro_torch.nn.tree import QuantKernel
    from repro_torch.runtime.serving import generate

    d = _ckpt_dir(3e9, "train_e2e")
    args = train_e2e.parser().parse_args(["--device", "cuda",
                                          "--ckpt-dir", d])
    _reset_counts()
    t0 = time.perf_counter()
    cfg, state, loop, step, corpus = train_e2e.train(args, log_fn=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    _add(handoff, counts)
    n_leaves = sum(isinstance(m, QuantKernel) for m in state.model.modules())
    per_step = (cfg.quant.kmeans_iters + 1) * n_leaves
    losses = [h["loss"] for h in loop.history]
    ms = [h["dt"] * 1e3 for h in loop.history]
    steady = statistics.median(ms[10:])
    seq = 256
    steps = sorted(int(p.name.split("_")[1]) for p in Path(d).glob(
        "step_????????"))
    sizes = [_dir_bytes(Path(d) / f"step_{s:08d}") / 1e9 for s in steps]
    log(f"train_e2e {cfg.n_layers}L d{cfg.d_model}: corpus {len(corpus)} "
        f"bytes | {step} steps in {wall:.1f} s | ms a step: first window "
        f"{ms[0]:.1f}, median after it {steady:.2f} "
        f"({4 * seq / steady * 1e3:.0f} tokens/s) | loss {losses[0]:.4f} -> {losses[-1]:.4f} (every 50: "
        f"{['%.3f' % x for x in losses[::50]]}) | kmeans_stats "
        f"{counts['kmeans_stats']} ({n_leaves} leaves, {per_step} a step), "
        f"plain {counts['plain']} | checkpoints {steps}, "
        f"{['%.3f' % x for x in sizes]} GB")
    check(step == 300 and len(losses) == 300, f"trained {step} steps")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses[0]} -> "
          f"{losses[-1]}")
    check(n_leaves == 7 * cfg.n_layers + 2, f"{n_leaves} quantized leaves")
    check(counts["kmeans_stats"] == 300 * per_step and counts["plain"] == 0,
          f"train_e2e launched {counts}, expected {300 * per_step} "
          "kmeans_stats and no plain version")
    check(steps == [100, 200, 300], f"checkpoints at {steps}")
    batch = loop.make_batch(step)

    def one_step():  # after the last checkpoint: what is served is on disk
        loop.train_step(state, batch)
        torch.cuda.synchronize()
    wall_ms, busy_ms, rows = profile_run(one_step, "one train_e2e step")
    km_ms = sum(r[0] for r in rows if "kmeans" in r[2])
    log(f"  kmeans_stats in the profiled step: {km_ms:.2f} ms")
    del state, loop, batch
    gc.collect()
    torch.cuda.empty_cache()

    policy = api.resolved_policy(cfg)
    params, _ = ckpt.restore_params(d)
    view = serve_view(interop.from_train_params(
        params, cfg, pack4=True, policy=policy, device="cuda"),
        pack4=True, policy=policy)
    prompts = torch.from_numpy(byte_batch(corpus, 0, 4, 128,
                                          seed=2)["tokens"])
    _reset_counts()
    out = generate(view, cfg, {"tokens": prompts}, steps=64,
                   device="cuda").cpu()
    counts = _read_counts()
    _add(handoff, counts)

    def text(t):
        return bytes(t.tolist()).decode("utf-8", "replace")
    log(f"  served from step 300 (packed4, act_bits 8): prompt "
        f"{text(prompts[0])!r} -> {text(out[0])!r} | {counts}")
    check(counts["lutq_gemv_packed"] > 0 and counts["plain"] == 0,
          f"served through {counts}")
    cfg32 = cfg.replace(act_bits=32)
    _reset_counts()
    plain = generate(view, cfg32, {"tokens": prompts}, steps=64,
                     device="cuda").cpu()
    spec, stats = generate(view, cfg32, {"tokens": prompts}, steps=64,
                           speculative=3, draft_bits=3, return_stats=True,
                           device="cuda")
    counts = _read_counts()
    _add(handoff, counts)
    same = torch.equal(spec.cpu(), plain)
    log(f"  act_bits 32, speculative k=3 draft_bits=3: tokens equal plain "
        f"greedy {same} | acceptance {stats['acceptance_rate']:.3f}, "
        f"{stats['spec_tokens_per_round']:.2f} tokens a round over "
        f"{stats['spec_rounds']} rounds (random weights, phase 3f: ~0.06) "
        f"| {text(plain[0])!r} | {counts}")
    check(same, "speculative tokens differ from plain greedy")
    check(counts["plain"] == 0, f"a plain version ran: {counts}")
    del view, params
    shutil.rmtree(d)


def reduced_ckpt_card_vs_cpu(handoff):
    """The reduced config trained 3 steps under serving_pow2 on the CPU by
    the training CLI, its checkpoint served on the card and on the CPU:
    through the serve CLI (its restored line, lutq_shift launches) and
    through restore_params / from_train_params / generate (all tokens
    equal)."""
    import shutil
    import tempfile

    import torch

    from repro_torch import interop
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.core.policy import serve_view
    from repro_torch.launch import train as train_cli
    from repro_torch.models import api
    from repro_torch.models.reduce import reduced
    from repro_torch.runtime.serving import generate

    d = tempfile.mkdtemp(prefix="lutq_ckpt_")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train_cli.main(["--arch", "h2o-danube-1.8b", "--reduced",
                             "--steps", "3", "--batch", "4", "--seq", "32",
                             "--quant-policy", "serving_pow2", "--device",
                             "cpu", "--ckpt-dir", d])
    check(rc == 0, f"reduced serving_pow2 training returned {rc}")
    samples = {}
    for dev in ("cpu", "cuda"):
        rc, out, counts = _serve_cli("--reduced", "--vocab", "256",
                                     "--ckpt-dir", d, "--device", dev)
        check(rc == 0 and "restored train checkpoint step 3" in out
              and "serving_pow2" in out, f"serve CLI on {dev}: rc {rc}")
        samples[dev] = [ln for ln in out.splitlines() if "sample:" in ln][0]
        if dev == "cuda":
            _add(handoff, counts)
            check(counts["lutq_shift"] > 0 and counts["plain"] == 0,
                  f"card serve launched {counts}")
    cfg = reduced(get_config("h2o-danube-1.8b")).replace(
        vocab=256, quant=ckpt.load_policy(d), act_bits=8)
    policy = api.resolved_policy(cfg)
    params, _ = ckpt.restore_params(d)
    toks = torch.randint(0, cfg.vocab, (4, 32),
                         generator=torch.Generator().manual_seed(5))
    out = {}
    for dev in ("cpu", "cuda"):
        view = serve_view(interop.from_train_params(
            params, cfg, policy=policy, device=dev), policy=policy)
        out[dev] = generate(view, cfg, {"tokens": toks}, steps=16,
                            device=dev).cpu()
    same = torch.equal(out["cpu"], out["cuda"])
    log(f"reduced serving_pow2 checkpoint, card vs cpu: CLI samples "
        f"{samples['cuda'].split('sample:')[1].strip()} vs "
        f"{samples['cpu'].split('sample:')[1].strip()} | generate B=4 "
        f"x 16 tokens equal {same}")
    check(samples["cpu"].split("sample:")[1]
          == samples["cuda"].split("sample:")[1], "CLI samples differ")
    check(same, "reduced serving_pow2 checkpoint: card and CPU differ")
    shutil.rmtree(d)


def reduced_train_card_vs_cpu(arch="h2o-danube-1.8b", label="reduced"):
    """The reduced config of ``arch`` trained 3 steps on the card and on
    the CPU from one initial state and the same batches (an encdec
    config's with their frames), kmeans_impl="stats" forced.
    Activations stay f32 here: the point is the kernel path, and an
    8-bit activation grid turns a one-ulp matmul difference into a
    ~1e-5 loss difference."""
    import torch

    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.launch import train as train_cli

    args = _train_args("--reduced", "--steps", "3", "--batch", "4",
                       "--seq", "32", "--act-bits", "32", "--device", "cpu",
                       arch=arch)
    runs = {}
    for dev in ("cpu", "cuda"):
        cfg, state, step_fn = train_cli.build(args, kmeans_impl="stats")
        state.model.to(dev)
        state.opt_state = {k: {n: t.to(dev) for n, t in v.items()}
                           for k, v in state.opt_state.items()}
        make_batch = train_cli.batch_fn(MarkovLM(cfg.vocab, seed=0), args,
                                        torch.device(dev), cfg)
        _reset_counts()
        losses = []
        for s in range(3):
            state, m = step_fn(state, make_batch(s))
            losses.append(float(m["loss"]))
        runs[dev] = (losses, {n: m.d.cpu() for n, m in _leaves(state.model)},
                     _read_counts())
    n_leaves = len(runs["cpu"][1])
    want = 3 * 2 * n_leaves
    (lc, dc, cc), (lg, dg, cg) = runs["cpu"], runs["cuda"]
    rel = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
    derr = max(float((dg[n] - dc[n]).abs().max() / dc[n].abs().max())
               for n in dc)
    log(f"{label} train card vs cpu ({arch}, {n_leaves} leaves): losses "
        f"{lg} vs {lc} (max rel {rel:.2e}), dictionaries max rel "
        f"{derr:.2e} | card {cg} | cpu {cc}")
    check(cg["kmeans_stats"] == want and cg["plain"] == 0,
          f"{arch} card run: {cg}, expected {want} kmeans_stats launches")
    check(cc["kmeans_stats"] == 0 and cc["plain"] == want,
          f"{arch} cpu run: {cc}, expected {want} plain passes")
    check(rel <= 1e-4, f"{arch} reduced training: card and CPU losses "
          "disagree")
    check(derr <= 1e-5, f"{arch} reduced training: dictionaries disagree")
    return cg["kmeans_stats"]


# ---------------------------------------------------------------------------
# phase 3t
# ---------------------------------------------------------------------------

#: phase 3t: each sequence family trained at full width, the vocab kept,
#: its depth cut (seamless 2 + 2 of 12 + 12, zamba one super-block of 6
#: of 54 layers, rwkv 4 of 24)
SEQ_TRAIN = {"seamless-m4t-medium": dict(n_layers=2, enc_layers=2),
             "zamba2-2.7b": dict(n_layers=6),
             "rwkv6-1.6b": dict(n_layers=4)}
SEQ_TRAIN_BATCH, SEQ_TRAIN_SEQ, SEQ_TRAIN_STEPS = 2, 128, 3


def sequence_train():
    """Phase 3t: the encdec, hybrid and ssm families trained on the card,
    (a) at full width (``_family_train``, one step more profiled), (b)
    reduced, card against CPU
    (``reduced_train_card_vs_cpu``). Returns {family: kmeans_stats
    launches of (a)}."""
    def has_frames(cfg, batch):
        if cfg.family == "encdec":
            check(batch["frames"].shape
                  == (SEQ_TRAIN_BATCH, SEQ_TRAIN_SEQ, cfg.d_model),
                  f"{cfg.name} trainer: the batch has no frames")

    out = {}
    for arch, cut in SEQ_TRAIN.items():
        out[arch] = _family_train(arch, cut, SEQ_TRAIN_STEPS,
                                  SEQ_TRAIN_BATCH, SEQ_TRAIN_SEQ,
                                  check_batch=has_frames, profile=True)
    for arch in SEQ_TRAIN:
        reduced_train_card_vs_cpu(arch, label="3t reduced")
    return out


# ---------------------------------------------------------------------------
# phase 3j
# ---------------------------------------------------------------------------

#: the cifar_table row the phase trains and serves
VISION_ROW = "LUT-Q 4-bit pow2 (fully ML)"
#: ResNet-20 proper (6 * 3 + 2 layers) at CIFAR's resolution
VISION_FULL = dict(widths=(16, 32, 64), blocks=3)
VISION_RES, VISION_BATCH, VISION_STEPS, VISION_EVAL = 32, 128, 200, 512
#: the card-vs-CPU check's reduced network, images and batch
VISION_REDUCED = dict(widths=(8, 16), blocks=1)
VISION_REDUCED_RES, VISION_REDUCED_BATCH = 8, 8
#: the fc's rows in the kernel checks: one image, the reduced batch, the
#: eval batch, the held-out set at once
VISION_FC_M = (1, 8, 128, 512)
#: card against CPU, of max|CPU|: f32 convolutions in another order (TF32
#: off) give ~1e-6 a layer; with 8-bit activations an activation within an
#: ulp of a rounding boundary of its grid may round the other way, one
#: grid step (1/255 of the layer's max) that the layers after it carry
VISION_LOGIT_TOL = {32: 1e-4, 8: 2e-2}
VISION_LOSS_TOL = 1e-2   # relative, one step at 8-bit activations
VISION_STATS_TOL = 1e-3  # running statistics after the step, of max|CPU|


def _ml_scales(model, stats):
    """Every BN's folded multiplier-less scale (a), concatenated."""
    import torch

    from repro_torch.core.mlbn import inference_scale_offset

    return torch.cat([inference_scale_offset(
        m.p.params, stats[name.replace(".", "_")], multiplier_less=True)[0]
        for name, m in model.named_modules() if hasattr(m, "p")])


def vision_reduced_card_vs_cpu():
    """Phase 3j (a): the reduced ResNet (widths 8/16, one block a stage,
    8x8 images, B=8) from one seeded init, quantized on the CPU under the
    fully multiplier-less row's spec and copied to the card: each forward
    form (training and multiplier_less on and off, act_bits 32 and 8)
    and one train_step on both devices, within the VISION_* tolerances;
    the folded ML-BN scales equal bit for bit (their roots are float64 on
    both); after the step dictionaries equal and assignments equal except
    for weights within 2 lr of a midpoint (a gradient whose sign differs
    moves Adam's first step by 2 lr), counted."""
    import copy

    import torch

    from repro_torch.core.policy import quantize_tree, split_trainable
    from repro_torch.data.synthetic import class_batches, shapes_dataset
    from repro_torch.launch import cifar_table as ct
    from repro_torch.models.resnet import init_resnet20, resnet20_apply
    from repro_torch.optim.optimizers import adamw, cosine_schedule

    _, spec, ml, act_bits = ct.config(VISION_ROW)
    spec = ct.table_spec(spec)
    model, stats = init_resnet20(torch.Generator().manual_seed(3),
                                 n_classes=8, device="cpu", **VISION_REDUCED)
    quantize_tree(model, spec)
    # non-trivial running statistics, so the inference forms fold work
    stats = {k: type(v)(v.mean + 0.1, v.var * 1.7) for k, v in stats.items()}
    xs, ys = shapes_dataset(64, seed=1, res=VISION_REDUCED_RES)
    batch = next(class_batches(xs, ys, VISION_REDUCED_BATCH, seed=3))
    runs = {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(model).to(dev)
        s = {k: type(v)(v.mean.to(dev), v.var.to(dev))
             for k, v in stats.items()}
        b = ct.to_device(batch, dev)
        out = {}
        with torch.no_grad():
            for training in (False, True):
                for ml_ in (False, True):
                    for ab in (32, 8):
                        logits, ns = resnet20_apply(
                            m, s, b["x"], training=training,
                            multiplier_less=ml_, act_bits=ab,
                            **VISION_REDUCED)
                        out[training, ml_, ab] = (logits.cpu(), {
                            k: v.var.cpu() for k, v in ns.items()})
        scales = _ml_scales(m, s).cpu()
        opt = adamw(cosine_schedule(2e-3, 20, ct.STEPS))
        opt_state = opt.init(split_trainable(m)[0])
        _reset_counts()
        s2, loss, _ = ct.train_step(m, s, opt, opt_state, 5, b, spec=spec,
                                    multiplier_less=ml, act_bits=act_bits,
                                    **VISION_REDUCED)
        counts = _read_counts()
        runs[dev] = dict(out=out, scales=scales, loss=float(loss),
                         counts=counts,
                         stats={k: v.var.cpu() for k, v in s2.items()},
                         leaves={n: (q.w.detach().cpu(), q.d.cpu(), q.a.cpu())
                                 for n, q in _leaves(m)},
                         params={n: p.detach().cpu() for n, p in
                                 m.named_parameters()})
    cpu, card = runs["cpu"], runs["cuda"]
    for key, (want, want_s) in cpu["out"].items():
        got, got_s = card["out"][key]
        rel = float((got - want).abs().max() / want.abs().max())
        srel = max(float((got_s[k] - want_s[k]).abs().max()
                         / want_s[k].abs().max()) for k in want_s)
        training, ml_, ab = key
        log(f"vision reduced forward training={training} "
            f"multiplier_less={ml_} act_bits={ab}: logits max rel "
            f"{rel:.2e} (tol {VISION_LOGIT_TOL[ab]:.0e}), running var max "
            f"rel {srel:.2e}")
        check(rel <= VISION_LOGIT_TOL[ab] and srel <= 1e-4,
              f"vision forward {key}: card and CPU disagree")
    flips = int((card["scales"] != cpu["scales"]).sum())
    log(f"vision ML-BN folded scales: {flips} of {cpu['scales'].numel()} "
        f"differ between card and CPU")
    check(flips == 0, "ML-BN scales differ between card and CPU")
    lrel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    srel = max(float((card["stats"][k] - v).abs().max() / v.abs().max())
               for k, v in cpu["stats"].items())
    lr = cosine_schedule(2e-3, 20, ct.STEPS)(5)
    near, beyond = 0, 0
    for name, p in cpu["params"].items():
        diff = (card["params"][name] - p).abs()
        check(float(diff.max()) <= 2 * lr + 1e-6 * float(p.abs().max()),
              f"vision step: {name} moved {float(diff.max()):.3e} apart")
        beyond += int((diff > 1e-5 * p.abs().max()).sum())
    for name, (w, d, a) in cpu["leaves"].items():
        _, dg, ag = card["leaves"][name]
        check(torch.equal(dg, d), f"vision step: {name} dictionaries differ")
        diff = ag != a
        mid = (d[:-1] + d[1:]) * 0.5
        dist = (w[diff].reshape(-1, 1) - mid).abs().min(1).values
        check(bool((dist <= 2 * lr).all()), f"vision step: {name} "
              f"assignments differ away from a midpoint")
        near += int(diff.sum())
    log(f"vision reduced train_step card vs cpu: loss {card['loss']:.6f} vs "
        f"{cpu['loss']:.6f} (rel {lrel:.2e}, tol {VISION_LOSS_TOL:.0e}), "
        f"running var max rel {srel:.2e}; {beyond} parameter elements "
        f"beyond 1e-5 of their leaf's max (all within 2 lr = {2 * lr:.1e}); "
        f"dictionaries equal; {near} assignments differ, all within 2 lr of "
        f"a midpoint | card {card['counts']} | cpu {cpu['counts']}")
    check(lrel <= VISION_LOSS_TOL, "vision step: losses disagree")
    check(srel <= VISION_STATS_TOL, "vision step: running stats disagree")
    check(card["counts"]["plain"] == 0 and card["counts"]["kmeans_stats"]
          == 0, f"vision step ran a kernel or plain version: "
          f"{card['counts']}")


def _vision_fc_checks(view, kname):
    """The fc's kernel against its plain version at the fc's shape
    ((M, 64) @ (64, 8), K = 16) for M in VISION_FC_M, on features from
    the view's own relu range; returns max |kernel - plain|."""
    import torch

    from repro_torch.kernels import lutq_gemv_packed, lutq_matmul, ops
    from repro_torch.kernels.ref import lutq_gemv_packed_ref, lutq_matmul_ref
    from repro_torch.nn.tree import leaf

    st = leaf(view.fc, "kernel")
    g = torch.Generator(device="cuda").manual_seed(27)
    worst = 0.0
    for M in VISION_FC_M:
        x = torch.rand(M, st.a.shape[0] * (2 if kname == "lutq_gemv_packed"
                                           else 1),
                       generator=g, device="cuda") * 3.0
        if kname == "lutq_shift":
            got, _ = ops._pow2_dot_acc(x, st.d, st.a, st.act)
            want, _ = ops._pow2_dot_acc(x, st.d, st.a, st.act,
                                        use_kernel=False)
            torch.cuda.synchronize()
            err = float((got.long() - want.long()).abs().max())
            ok = torch.equal(got, want)
            tol = "bit for bit"
        else:
            fn, plain = ((lutq_matmul.lutq_matmul, lutq_matmul_ref)
                         if kname == "lutq_matmul" else
                         (lutq_gemv_packed.lutq_gemv_packed,
                          lutq_gemv_packed_ref))
            got = fn(x, st.a, st.d)
            want = plain(x, st.a, st.d)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ok = err <= TOL["float32"] * float(want.abs().max())
            tol = f"rel tol {TOL['float32']:.0e}"
        log(f"check {kname} vision fc M={M} Kin=64 N={got.shape[1]} K="
            f"{st.d.numel()}: max_abs_err {err:.3e} ({tol})")
        check(ok and bool(torch.isfinite(got.float()).all()),
              f"{kname} disagrees with its plain version at the vision fc's "
              f"shape, M={M}")
        worst = max(worst, err)
    return worst


def vision_full_width(card: str):
    """Phase 3j (b, c): ResNet-20 (widths 16/32/64, 3 blocks a stage, 8
    classes) trained by cifar_table.train under the fully multiplier-less
    row (4-bit pow2 LUT-Q, ML-BN, 8-bit activations) for VISION_STEPS
    steps of B=128 on shapes_dataset(2048, res=32), then served three
    ways on 512 held-out images. Returns ({kernel: launches of the serve
    evaluations}, {kernel: worst |kernel - plain| at the fc's shape})."""
    import torch

    from repro_torch.core import rules
    from repro_torch.core.policy import serve_view, split_trainable
    from repro_torch.data.synthetic import class_batches, shapes_dataset
    from repro_torch.launch import cifar_table as ct
    from repro_torch.models import resnet as resnet_mod
    from repro_torch.optim.optimizers import adamw, cosine_schedule

    _, spec, ml, act_bits = ct.config(VISION_ROW)
    geo = dict(VISION_FULL)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    trained = ct.train(spec, multiplier_less=ml, act_bits=act_bits,
                       steps=VISION_STEPS, res=VISION_RES,
                       batch=VISION_BATCH, device="cuda", **geo)
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30 - base
    losses = trained.losses
    first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    n_kernels = sum(1 for n, _ in trained.model.named_parameters()
                    if n.endswith("kernel.w"))
    log(f"vision train {VISION_ROW}: ResNet-20 {geo}, {n_kernels} LUT-Q "
        f"leaves, B={VISION_BATCH} at {VISION_RES}x{VISION_RES}, "
        f"{VISION_STEPS} steps in {trained.seconds:.2f} s "
        f"({trained.seconds / VISION_STEPS * 1e3:.2f} ms a step, first step "
        f"included) | loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of "
        f"first / last 10: {first:.4f} / {last:.4f}) | peak "
        f"{peak:.3f} GiB above the {base:.3f} GiB held before the phase | "
        f"counts {counts} | {card}")
    check(all(math.isfinite(v) for v in losses), "vision loss not finite")
    check(last < first, f"vision loss did not fall: {first} -> {last}")
    check(counts["plain"] == 0 and counts["kmeans_stats"] == 0,
          f"vision training ran a kernel or plain version: {counts}")
    check(n_kernels == 22, f"{n_kernels} quantized leaves, expected 22")

    xt, yt = shapes_dataset(VISION_EVAL, seed=2, res=VISION_RES)
    ekw = dict(geo, multiplier_less=ml, act_bits=act_bits)
    model, stats = trained.model, trained.stats

    def evaluate(m, what):
        err = ct.error_rate(m, stats, xt, yt, **ekw)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        err2 = ct.error_rate(m, stats, xt, yt, **ekw)
        sec = time.perf_counter() - t0
        check(err == err2, f"{what}: two evaluations disagree")
        return err, VISION_EVAL / sec

    err_train, ips_train = evaluate(model, "train form")
    log(f"vision eval train form (decode fc): held-out error "
        f"{err_train:.2f} %, {ips_train:.0f} images/s")
    launches, worst = {}, {}
    x = torch.from_numpy(xt[:VISION_BATCH]).to("cuda")
    with torch.no_grad():
        ref_logits, _ = resnet_mod.resnet20_apply(
            model, stats, x, training=False, **ekw)
    views = {"int8": (serve_view(model), "lutq_matmul"),
             "pack4": (serve_view(model, pack4=True), "lutq_gemv_packed"),
             "serving_pow2": (serve_view(model, policy=rules.serving_pow2()),
                              "lutq_shift")}
    for name, (view, kname) in views.items():
        _reset_counts()
        err = ct.error_rate(view, stats, xt, yt, **ekw)
        counts = _read_counts()
        forwards = -(-VISION_EVAL // 128)
        others = {k: v for k, v in counts.items() if k != kname and v}
        log(f"vision serve {name}: held-out error {err:.2f} % | {kname} "
            f"{counts[kname]} launches for {forwards} forwards | other "
            f"counts {others}")
        check(counts[kname] == forwards and not others,
              f"vision serve {name}: counts {counts}, expected {forwards} "
              f"{kname} launches and nothing else")
        launches[kname] = counts[kname]
        _, ips = evaluate(view, name)
        with torch.no_grad():
            logits, _ = resnet_mod.resnet20_apply(
                view, stats, x, training=False, **ekw)
            # the shift-add fold against the multiply form it replaces,
            # deterministic convolutions in both
            with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                            deterministic=True,
                                            allow_tf32=False):
                fold, _ = resnet_mod.resnet20_apply(
                    view, stats, x, training=False, **ekw)
                orig = resnet_mod.apply_scale_offset_shift
                resnet_mod.apply_scale_offset_shift = \
                    lambda h, a, b, **_: a * h + b
                try:
                    mul, _ = resnet_mod.resnet20_apply(
                        view, stats, x, training=False, **ekw)
                finally:
                    resnet_mod.apply_scale_offset_shift = orig
        same = torch.equal(fold, mul)
        rel = float((logits - ref_logits).abs().max()
                    / ref_logits.abs().max())
        log(f"vision serve {name}: {ips:.0f} images/s (train form "
            f"{ips_train:.0f}) | shift-add fold vs multiply form on the "
            f"card: {'same' if same else 'DIFFERENT'} bits | logits vs the "
            f"train form max rel {rel:.2e} (B={VISION_BATCH})")
        check(same, f"vision serve {name}: the fold's bits differ from the "
              f"multiply form's")
        if kname != "lutq_shift":  # the pow2 path quantizes the fc input
            check(rel <= TOL["float32"], f"vision serve {name}: logits "
                  f"differ from the train form's")
        worst[kname] = _vision_fc_checks(view, kname)

    # steady step time and the card's idle share: more steps of the same
    # recipe on the trained model (after the serving above)
    opt = adamw(cosine_schedule(2e-3, 20, VISION_STEPS))
    opt_state = opt.init(split_trainable(model)[0])
    xs, ys = shapes_dataset(2048, seed=1, res=VISION_RES)
    it = class_batches(xs, ys, VISION_BATCH, seed=4)
    spec = ct.table_spec(spec)

    def step(n):
        nonlocal stats
        stats, loss, _ = ct.train_step(model, stats, opt, opt_state, n,
                                       ct.to_device(next(it), "cuda"),
                                       spec=spec, multiplier_less=ml,
                                       act_bits=act_bits, **geo)
        torch.cuda.synchronize()

    for n in range(3):
        step(n)
    t0 = time.perf_counter()
    for n in range(3, 13):
        step(n)
    ms = (time.perf_counter() - t0) / 10 * 1e3
    wall, busy, _ = profile_run(lambda: step(13), "vision train step")
    log(f"vision train step steady: {ms:.2f} ms a step (10 steps), one "
        f"profiled step busy {busy:.2f} of {wall:.2f} ms (idle "
        f"{(1 - busy / wall) * 100:.1f} %) | {card}")
    return launches, worst


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def time_ms(fn, arg_sets, iters: int, graph: bool = True):
    """(device ms, host-loop ms) per call over ``iters`` calls cycling
    through ``arg_sets`` (distinct operand copies, so weights come from
    device memory, not L2, as on the serve path), after a warm-up.

    Device time replays the calls captured in a CUDA graph, so the
    wrapper's host work is out of it; the host-loop time is the same
    calls made from Python, as the serve path makes them. With
    ``graph=False`` (a function that synchronizes, such as the k-means
    plain version's ``bincount``) both are the host-loop time."""
    import torch

    for i in range(3):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    loop = start.elapsed_time(end) / iters
    if not graph:
        return loop, loop
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    device = start.elapsed_time(end) / iters
    del graph
    return device, loop


def _copies(nbytes: int) -> int:
    return max(2, min(256, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def bound(M, Kin, N, packed):
    """(ms for bytes, ms for operations): each input read once, the f32
    output written once, at the HBM rate; bf16 products at the
    tensor-core peak. The bound is the larger of the two."""
    idx_bytes = Kin * N // (2 if packed else 1)
    nbytes = M * Kin * 2 + idx_bytes + 16 * 4 + M * N * 4
    flops = 2 * M * N * Kin
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            flops / PEAK_FLOPS["bfloat16"] * 1e3)


#: phase 4's M for the GEMMs: decode (M=4) and prefill (M=512); the A/B
#: adds the engine's 8-slot step and the 32- and 64-row prefill chunks
TIMING_M, AB_TIMING_M = (4, 512), (4, 8, 32, 64, 512)


def timings(card: str, ms=TIMING_M):
    import torch

    from repro_torch.core.lutq import decode
    from repro_torch.kernels.ref import unpack4_kin

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    shapes = dict(LAYER_SHAPES, head=(HEAD_SHAPE, 1))
    table = {}
    for kname, (fn, plain) in _gemm_fns().items():
        packed = KERNELS[kname]["packed"]
        per_m = {}
        for M in ms:
            agg = dict(ms=0.0, loop_ms=0.0, plain_ms=0.0, library_ms=0.0,
                       bytes_ms=0.0, ops_ms=0.0)
            for label, ((Kin, N), calls) in shapes.items():
                x, a, d = _operands(M, Kin, N, 16, torch.bfloat16, gen, dev,
                                    packed)
                n = _copies(a.numel())
                sets = [(x, a.clone(), d) for _ in range(n)]
                t, t_loop = time_ms(fn, sets, iters=max(40, 2 * n))
                tp, _ = time_ms(plain, sets[:2], iters=4)
                w = decode(d, unpack4_kin(a) if packed else a).to(
                    torch.bfloat16)
                nw = _copies(w.numel() * 2)
                wsets = [(x, w.clone()) for _ in range(nw)]
                tl, _ = time_ms(torch.matmul, wsets, iters=max(40, 2 * nw))
                del w, wsets, sets
                tb, to = bound(M, Kin, N, packed)
                b, by = max(tb, to), ("bytes" if tb >= to else "operations")
                log(f"time {kname} M={M} {label} Kin={Kin} N={N}: kernel "
                    f"{t * 1e3:.1f} us (host loop {t_loop * 1e3:.1f} us) | "
                    f"bound {b * 1e3:.1f} us ({by}) = "
                    f"{b / t * 100:.1f}% | plain {tp * 1e3:.1f} us | "
                    f"torch.matmul bf16 {tl * 1e3:.1f} us | {card}")
                per_fwd = calls * (1 if label == "head" else N_LAYERS)
                agg["ms"] += per_fwd * t
                agg["loop_ms"] += per_fwd * t_loop
                agg["plain_ms"] += per_fwd * tp
                agg["library_ms"] += per_fwd * tl
                agg["bytes_ms"] += per_fwd * tb
                agg["ops_ms"] += per_fwd * to
            agg["bound_ms"] = max(agg["bytes_ms"], agg["ops_ms"])
            agg["bound_by"] = ("bytes" if agg["bytes_ms"] >= agg["ops_ms"]
                               else "operations")
            per_m[M] = agg
            log(f"time {kname} M={M} one forward ({CALLS_PER_FORWARD} "
                f"calls): kernel {agg['ms']:.3f} ms (host loop "
                f"{agg['loop_ms']:.3f} ms) | bound "
                f"{agg['bound_ms']:.3f} ms ({agg['bound_by']}) = "
                f"{agg['bound_ms'] / agg['ms'] * 100:.1f}% | plain "
                f"{agg['plain_ms']:.3f} ms | torch.matmul "
                f"{agg['library_ms']:.3f} ms | {card}")
        table[kname] = per_m
    return table


#: phase 4's M for lutq_shift: generate's decode rows, the engine's
#: 8-slot decode step, generate's 512-row prefill
SHIFT_TIMING_M = (4, 8, 512)


def shift_timings(card: str):
    """lutq_shift at the 168 body shapes of one forward, at each M of
    SHIFT_TIMING_M (decode 4 and 8, prefill 512), with the assignments
    rotated through more than twice the L2, beside its bound, its plain
    version and torch._int_mm on the pre-decoded int8 weight (a yardstick
    the port never calls, its fastest layout; exact here because the
    timing dictionary's |wsh| <= 64, M padded to the 32 rows _int_mm
    takes at least). Bound: A at 1 byte a weight, xq, the int32 output
    and wsh at the HBM rate; operations at the int8 tensor-core rate."""
    import torch

    from repro_torch.kernels.lutq_shift import lutq_shift
    from repro_torch.kernels.ref import lutq_shift_ref, shift_planes

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    per_m = {}
    for M in SHIFT_TIMING_M:
        agg = dict(ms=0.0, loop_ms=0.0, plain_ms=0.0, library_ms=0.0,
                   bytes_ms=0.0, ops_ms=0.0)
        for label, ((Kin, N), calls) in LAYER_SHAPES.items():
            xq, a, wsh = _shift_operands(M, Kin, N, 16, gen, dev, span=6)
            n = _copies(a.numel())
            # the digit planes as the serving path hands them in: derived
            # once, not in the captured calls
            planes = shift_planes(wsh)
            sets = [(xq, a.clone(), wsh, planes) for _ in range(n)]
            t, t_loop = time_ms(lutq_shift, sets, iters=max(40, 2 * n))
            tp, _ = time_ms(lutq_shift_ref, [z[:3] for z in sets[:2]],
                            iters=4)
            tl = _int_mm_ms(xq, a, wsh, n)
            del sets
            tb = (Kin * N + M * Kin + M * N * 4 + 16 * 4) / HBM_BYTES_PER_S \
                * 1e3
            to = 2 * M * N * Kin / INT8_OPS * 1e3
            b, by = max(tb, to), ("bytes" if tb >= to else "operations")
            log(f"time lutq_shift M={M} {label} Kin={Kin} N={N}: kernel "
                f"{t * 1e3:.1f} us (host loop {t_loop * 1e3:.1f} us) | bound "
                f"{b * 1e3:.1f} us ({by}) = {b / t * 100:.1f}% | plain "
                f"{tp * 1e3:.1f} us | torch._int_mm "
                f"{'n/a' if tl is None else '%.1f us' % (tl * 1e3)} | {card}")
            per_fwd = calls * N_LAYERS
            agg["ms"] += per_fwd * t
            agg["loop_ms"] += per_fwd * t_loop
            agg["plain_ms"] += per_fwd * tp
            agg["library_ms"] = (None if tl is None or agg["library_ms"]
                                 is None else agg["library_ms"]
                                 + per_fwd * tl)
            agg["bytes_ms"] += per_fwd * tb
            agg["ops_ms"] += per_fwd * to
        agg["bound_ms"] = max(agg["bytes_ms"], agg["ops_ms"])
        agg["bound_by"] = ("bytes" if agg["bytes_ms"] >= agg["ops_ms"]
                           else "operations")
        per_m[M] = agg
        lib = agg["library_ms"]
        log(f"time lutq_shift M={M} one forward ({SHIFT_CALLS_PER_FORWARD} "
            f"calls): kernel {agg['ms']:.3f} ms (host loop "
            f"{agg['loop_ms']:.3f} ms) | bound {agg['bound_ms']:.3f} ms "
            f"({agg['bound_by']}) = {agg['bound_ms'] / agg['ms'] * 100:.1f}% "
            f"| plain {agg['plain_ms']:.3f} ms | torch._int_mm "
            f"{'n/a' if lib is None else '%.3f ms' % lib} | {card}")
    return per_m


def _int_mm_ms(xq, a, wsh, n):
    """Time of torch._int_mm on the pre-decoded int8 weight wsh[a] (exact
    where every |wsh| <= 64), x padded to the 32 rows it takes at least:
    each layout of the weight it accepts is checked against the plain
    version's sums, timed and logged, and the fastest is returned; None
    (logged) where this PyTorch refuses every layout."""
    import torch

    from repro_torch.core.lutq import index_of
    from repro_torch.kernels.ref import lutq_shift_ref

    check(bool((wsh.abs() <= 64).all()), "yardstick needs |wsh| <= 64")
    M, Kin = xq.shape
    xpad = torch.zeros((max(M, 32), Kin), dtype=torch.int8, device=xq.device)
    xpad[:M] = xq
    w8 = wsh[index_of(a)].to(torch.int8)
    want = lutq_shift_ref(xq, a, wsh)
    best = None
    for layout, w in (("row-major", w8), ("column-major",
                                          w8.t().contiguous().t())):
        try:
            got = torch._int_mm(xpad, w)[:M]
        except RuntimeError as exc:
            log(f"  torch._int_mm refuses {layout} {tuple(w.shape)}: "
                f"{str(exc).splitlines()[0][:120]}")
            continue
        check(torch.equal(got, want),
              "the _int_mm yardstick does not compute the same sums")
        sets = [(xpad, w.clone(memory_format=torch.preserve_format))
                for _ in range(n)]
        t, _ = time_ms(torch._int_mm, sets, iters=max(40, 2 * n))
        log(f"  torch._int_mm {layout} M={M} {tuple(w.shape)}: "
            f"{t * 1e3:.1f} us")
        best = t if best is None else min(best, t)
        del sets
    return best


def kmeans_timings(card: str):
    """kmeans_stats over every leaf shape of one training step (two
    passes each, both writing a), against its byte bound: each pass reads
    4 B of w and writes 1 B of a per weight, plus the (K,) dictionary in
    and sums and counts out. The work per weight (15 compares against the
    midpoints and two adds) is far below the f32 rate, so bytes bound it.
    Then the step as the trainer makes it: the iteration pass with
    write_a=False (4 B a weight), the final pass writing a."""
    import torch

    from repro_torch.kernels.kmeans_stats import kmeans_stats
    from repro_torch.kernels.ref import kmeans_stats_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    agg = dict(ms=0.0, loop_ms=0.0, plain_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
               trainer_ms=0.0, trainer_bound_ms=0.0)
    passes = 2  # kmeans_iters = 1, plus the final assignment
    for label, ((r, c), count) in TRAIN_LEAVES.items():
        N = r * c
        w = torch.randn(N, generator=gen, device=dev) * 0.02
        d = _pow2_dict(w, 16)
        n = _copies(N * 4)
        sets = [(w.clone(), d) for _ in range(n)]
        t, t_loop = time_ms(kmeans_stats, sets, iters=max(20, 2 * n))
        tp, _ = time_ms(kmeans_stats_ref, sets[:2], iters=4, graph=False)
        tn, _ = time_ms(lambda w_, d_: kmeans_stats(w_, d_, write_a=False),
                        sets, iters=max(20, 2 * n))
        tb = (N * 5 + 16 * 4 * 3) / HBM_BYTES_PER_S * 1e3
        tbn = (N * 4 + 16 * 4 * 3) / HBM_BYTES_PER_S * 1e3
        to = N * 6 / PEAK_FLOPS["float32"] * 1e3
        log(f"time kmeans_stats {label} N={N}: kernel {t * 1e3:.1f} us "
            f"(host loop {t_loop * 1e3:.1f} us) | bound {tb * 1e3:.1f} us "
            f"(bytes) = {tb / t * 100:.1f}% | plain {tp * 1e3:.1f} us | "
            f"{card}")
        log(f"time kmeans_stats {label} N={N} write_a=False: kernel "
            f"{tn * 1e3:.1f} us | bound {tbn * 1e3:.1f} us (bytes) = "
            f"{tbn / tn * 100:.1f}% | {card}")
        agg["trainer_ms"] += count * (tn + t)
        agg["trainer_bound_ms"] += count * (tbn + tb)
        k = passes * count
        agg["ms"] += k * t
        agg["loop_ms"] += k * t_loop
        agg["plain_ms"] += k * tp
        agg["bytes_ms"] += k * tb
        agg["ops_ms"] += k * to
        del sets, w
    agg["bound_ms"] = max(agg["bytes_ms"], agg["ops_ms"])
    agg["bound_by"] = "bytes" if agg["bytes_ms"] >= agg["ops_ms"] else \
        "operations"
    n_calls = passes * sum(c for _, c in TRAIN_LEAVES.values())
    log(f"time kmeans_stats one training step ({n_calls} calls): kernel "
        f"{agg['ms']:.3f} ms (host loop {agg['loop_ms']:.3f} ms) | bound "
        f"{agg['bound_ms']:.3f} ms ({agg['bound_by']}) = "
        f"{agg['bound_ms'] / agg['ms'] * 100:.1f}% | plain "
        f"{agg['plain_ms']:.3f} ms | library: none | {card}")
    log(f"time kmeans_stats one training step as the trainer makes it "
        f"(iteration pass write_a=False): kernel {agg['trainer_ms']:.3f} ms "
        f"| bound {agg['trainer_bound_ms']:.3f} ms (bytes) = "
        f"{agg['trainer_bound_ms'] / agg['trainer_ms'] * 100:.1f}% | {card}")
    return agg


def paged_timings(card: str, run_a_lens, G=4, dh=80, labels=("a", "c"),
                  sweep=True, Hkv=8, kv_dtype="int8"):
    """The paged-attention kernel at run (a)'s decode geometry (8 rows,
    lengths mid-generation) and at run (c)'s longest row, int8 pages
    (``kv_dtype="bfloat16"``: bf16 pages, no scales), both variants,
    with pools rotated through more than twice the L2; beside its byte
    bound (the live pages' K/V rows and scales, q and out once), its
    plain version and scaled_dot_product_attention on a pre-gathered,
    pre-dequantized row with the same mask (a yardstick the port never
    calls). Danube's group, head dim and 8 KV heads unless ``G``, ``dh``,
    ``Hkv`` say otherwise; ``labels`` picks the geometries, ``sweep``
    the blocks-per-SM sweep."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build, paged_attn
    from repro_torch.kernels.ref import paged_attention_ref
    from repro_torch.nn.attention import gather_pages

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(9)
    page, window = 64, 4096
    kvdt = getattr(torch, kv_dtype)
    quant = kvdt == torch.int8
    geometries = {"a": (run_a_lens, -(-(512 + 64) // page)),
                  "c": ([LONG_PROMPT + LONG_GEN - 1],
                        -(-(LONG_PROMPT + LONG_GEN) // page))}
    out = {}
    for label in labels:
        lens, NB = geometries[label]
        B = len(lens)
        q, kp, vp, ks, vs, block, _, cl = _paged_case(
            B, Hkv, G, dh, page, NB, lens, torch.bfloat16, kvdt,
            window, gen, dev)
        live = sum(paged_attn.live_pages(L, page, NB, window) for L in lens)
        valid = sum(min(L, NB * page) - max(0, L - window) for L in lens)
        # what a call must move: the valid positions' K and V rows (int8
        # with their bf16 scales, or bf16), q read and out written (bf16),
        # the block table and the lengths
        kv_bytes = valid * Hkv * (2 * dh * kvdt.itemsize
                                  + (2 * 2 if quant else 0))
        nbytes = kv_bytes + 2 * q.numel() * 2 + block.numel() * 4 + B * 4
        n = _copies(kv_bytes)

        def copy(t):
            return None if t is None else t.clone()
        sets = [(q, kp.clone(), vp.clone(), block, cl, copy(ks), copy(vs))
                for _ in range(n)]
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        to = 4 * Hkv * G * dh * valid / PEAK_FLOPS["float32"] * 1e3
        b, by = max(tb, to), ("bytes" if tb >= to else "operations")
        times = {}
        for variant, budget in (("paged_attention", paged_attn.MAX_SMEM),
                                ("paged_attention_multipass", 0)):
            def fn(q, kp, vp, blk, cl, ks, vs, budget=budget):
                return paged_attn.paged_attention(
                    q, kp, vp, blk, cl, window=window, k_scale=ks,
                    v_scale=vs, smem_budget_bytes=budget)
            times[variant] = time_ms(fn, sets, iters=max(40, 2 * n))
        # the split plan's target of blocks per SM, swept (the default,
        # paged_attn.BLOCKS_PER_SM, is what every other call used)
        default = paged_attn.BLOCKS_PER_SM
        swept = {}
        try:
            for per_sm in (1, 2, 4, 8) if sweep else ():
                paged_attn.BLOCKS_PER_SM = per_sm
                for variant, budget in (("paged_attention", None),
                                        ("paged_attention_multipass", 0)):
                    def fn(q, kp, vp, blk, cl, ks, vs, budget=budget):
                        return paged_attn.paged_attention(
                            q, kp, vp, blk, cl, window=window, k_scale=ks,
                            v_scale=vs, smem_budget_bytes=budget)
                    swept[per_sm, variant] = time_ms(
                        fn, sets, iters=max(40, 2 * n))[0]
        finally:
            paged_attn.BLOCKS_PER_SM = default
        split = paged_attn.split_plan(B, Hkv, NB, page, window,
                                      sms=build.sm_count(dev))
        for per_sm in (1, 2, 4, 8) if sweep else ():
            sp = paged_attn.split_plan(B, Hkv, NB, page, window,
                                       sms=build.sm_count(dev), per_sm=per_sm)
            log(f"  run ({label}) at {per_sm} blocks an SM ({sp['nsplit']} "
                f"splits of {sp['chunk']}, {sp['blocks']} blocks): "
                + ", ".join(f"{v} {swept[per_sm, v] * 1e3:.1f} us"
                            for v in times))

        def plain(q, kp, vp, blk, cl, ks, vs):
            return paged_attention_ref(q, kp, vp, blk, cl, window=window,
                                       k_scale=ks, v_scale=vs)
        tp, _ = time_ms(plain, sets[:2], iters=4, graph=False)
        pos = torch.arange(NB * page, device=dev)
        mask = ((pos[None] < cl[:, None]) & (pos[None] >= cl[:, None] - window)
                )[:, None, None, :]
        lsets = []
        for _, kpc, vpc, blk, _, ksc, vsc in sets[:_copies(
                4 * B * NB * page * Hkv * dh)]:
            kc, vc = (gather_pages(t, blk).to(torch.bfloat16)
                      for t in (kpc, vpc))
            if quant:
                kc = kc * gather_pages(ksc, blk)[..., None]
                vc = vc * gather_pages(vsc, blk)[..., None]
            kc, vc = kc.transpose(1, 2), vc.transpose(1, 2)
            lsets.append((q.transpose(1, 2), kc.contiguous(), vc.contiguous(),
                          mask))

        def library(qt, kc, vc, m):
            return F.scaled_dot_product_attention(qt, kc, vc, attn_mask=m,
                                                  enable_gqa=True)
        tl, _ = time_ms(library, lsets, iters=max(40, 2 * len(lsets)),
                        graph=False)
        for variant, (t, t_loop) in times.items():
            log(f"time {variant} run ({label}) geometry B={B} Hkv={Hkv} G={G} "
                f"dh={dh} page={page} NB={NB} {kv_dtype} pages, {live} live "
                f"pages, "
                f"{split['nsplit']} splits of {split['chunk']} positions "
                f"({split['blocks']} blocks): kernel {t * 1e3:.1f} us (host "
                f"loop {t_loop * 1e3:.1f} us) | bound {b * 1e3:.2f} us ({by})"
                f" = {b / t * 100:.1f}% | plain {tp * 1e3:.1f} us | sdpa on "
                f"the gathered row {tl * 1e3:.1f} us (the kernel takes "
                f"{t / tl:.2f}x its time) | x{N_LAYERS} per engine decode "
                f"step = {t * N_LAYERS:.3f} ms | {card}")
        out[label] = dict(times=times, plain_ms=tp, library_ms=tl,
                          bound_ms=b, bound_by=by)
        del sets, lsets
        torch.cuda.empty_cache()
    return out


def flash_timings(card: str):
    """Kernel 5 at danube's prefill geometry (GQA layout, bf16, causal)
    and at one 4096-token row, operands rotated through more than twice
    the L2: the kernel the plan names (flash_wgmma) beside the mma.sync
    kernel flash_bf16 forced on the same operands, its bound (the larger
    of q, k, v and out at the HBM rate and 4·BH·D·S(S+1)/2 causal bf16
    operations at the tensor-core peak), its plain version and
    scaled_dot_product_attention(..., is_causal=True) on the same tensors
    (a yardstick the port never calls)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn
    from repro_torch.kernels.ref import flash_attention_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(14)
    out = {}
    for label, geo in (("danube", FLASH_DANUBE), ("4096", FLASH_LONG)):
        _, (q, k, v) = _flash_gqa(g, torch.bfloat16, dev, **geo)
        BH, S, D = q.shape
        kernel = flash_attn.plan(S, S, D, 128, 128, q.dtype)
        nbytes = 4 * q.numel() * 2
        n = _copies(nbytes)
        sets = [(q.clone(), k.clone(), v.clone()) for _ in range(n)]
        iters = max(40, 2 * n)

        def forced(q, k, v):
            return flash_attn.launch("flash_bf16", q, k, v, causal=True,
                                     scale=D ** -0.5, bk=128)
        t, t_loop = time_ms(flash_attn.flash_attention, sets, iters=iters)
        t_bf16, _ = time_ms(forced, sets, iters=iters)
        tp, _ = time_ms(flash_attention_ref, sets[:2], iters=2, graph=False)

        # the same tensors as (B, H, S, D) views: PyTorch's fused
        # attention backends take 4-d operands (3-d ones run its math path)
        heads = (geo["B"], geo["H"], S, D)

        def library(q, k, v):
            return F.scaled_dot_product_attention(
                q.view(heads), k.view(heads), v.view(heads), is_causal=True)
        tl, _ = time_ms(library, sets, iters=iters)
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        to = 4 * BH * D * S * (S + 1) / 2 / PEAK_FLOPS["bfloat16"] * 1e3
        b, by = max(tb, to), ("bytes" if tb >= to else "operations")
        log(f"time flash_attention {label} BH={BH} S={S} D={D} bf16 causal: "
            f"kernel ({kernel}) {t * 1e3:.1f} us (host loop "
            f"{t_loop * 1e3:.1f} us) | flash_bf16 (mma.sync) forced "
            f"{t_bf16 * 1e3:.1f} us | bound {b * 1e3:.2f} us ({by}; bytes "
            f"{tb * 1e3:.2f} us, operations {to * 1e3:.2f} us) = "
            f"{b / t * 100:.1f}% | plain {tp * 1e3:.1f} us | sdpa "
            f"{tl * 1e3:.1f} us (the kernel takes {t / tl:.2f}x its time) "
            f"| {card}")
        out[label] = dict(ms=t, flash_bf16_ms=t_bf16, plain_ms=tp,
                          library_ms=tl, bound_ms=b, bound_by=by)
        del sets, q, k, v
        torch.cuda.empty_cache()
    return out


def ab_timings(parent: str) -> int:
    """Phase 4's GEMM (at AB_TIMING_M), lutq_shift, flash-attention and
    kmeans_stats timings (``timings``, ``shift_timings``,
    ``flash_timings``, ``kmeans_timings``) of another checkout's package
    (say the parent commit, unpacked with git archive) and of this one,
    in turns (other, this, this, other), each in a fresh process that
    builds that package's kernels and times them with this script, on
    this one card. Prints each run's per-forward lines and a summary; no
    ok line. kmeans_stats' per-shape and per-step numbers are read from
    its log lines."""
    other = Path(parent).resolve()
    check((other / "src" / "repro_torch").is_dir(),
          f"{other}: no src/repro_torch")
    code = ("import json, sys; from pathlib import Path; "
            f"sys.path.insert(0, {str(ROOT)!r}); "
            "import chip_smoke as c; c.SRC = Path({root!r}) / 'src'; "
            "_, _, card = c.setup(); "
            "t = c.timings(card, c.AB_TIMING_M); "
            "t['lutq_shift'] = c.shift_timings(card); "
            "t['flash_attention'] = c.flash_timings(card); "
            "c.kmeans_timings(card); "
            "print('AB ' + json.dumps({{k: {{str(m): v "
            "for m, v in per.items()}} for k, per in t.items()}}))")
    import re

    km_shape = re.compile(r"time kmeans_stats (\S+) N=(\d+): kernel "
                          r"([\d.]+) us .*bound ([\d.]+) us")
    km_step = re.compile(r"time kmeans_stats one training step \((\d+) "
                         r"calls\): kernel ([\d.]+) ms .*bound ([\d.]+) ms")
    runs, km_runs = [], []
    for label, root in (("parent", other), ("change", ROOT),
                        ("change", ROOT), ("parent", other)):
        log(f"A/B run {len(runs) + 1}: {label} ({root})")
        proc = subprocess.run([sys.executable, "-c",
                               code.format(root=str(root))], cwd=root,
                              capture_output=True, text=True, timeout=1500)
        result, km = None, {}
        for line in proc.stdout.splitlines():
            if line.startswith("AB "):
                result = json.loads(line[3:])
                continue
            print(line, flush=True)
            m = km_shape.search(line)
            if m:
                km[m[1]] = (float(m[3]), float(m[4]), "us")
            m = km_step.search(line)
            if m:
                km[f"one training step ({m[1]} calls)"] = (
                    float(m[2]), float(m[3]), "ms")
        check(proc.returncode == 0 and result is not None,
              f"A/B run of {root} failed:\n{proc.stderr[-4000:]}")
        runs.append((label, result))
        km_runs.append((label, km))
    for kname in runs[0][1]:
        lib = {"lutq_shift": "torch._int_mm",
               "flash_attention": "sdpa"}.get(kname, "torch.matmul")
        what = "one call" if kname == "flash_attention" else "one forward"
        for m in runs[0][1][kname]:
            if not all(m in r[kname] for _, r in runs):
                continue  # an M only one side times
            ms = {lab: [r[kname][m]["ms"] for l2, r in runs if l2 == lab]
                  for lab in ("parent", "change")}
            libs = [r[kname][m]["library_ms"] for _, r in runs]
            ref = runs[0][1][kname][m]
            f = ".4f" if kname == "flash_attention" else ".3f"
            forced = [r[kname][m]["flash_bf16_ms"] for _, r in runs
                      if "flash_bf16_ms" in r[kname][m]]
            at = m if kname == "flash_attention" else f"M={m}"
            log(f"A/B {kname} {at} {what}: parent "
                f"{ms['parent'][0]:{f}} / {ms['parent'][1]:{f}} ms, change "
                f"{ms['change'][0]:{f}} / {ms['change'][1]:{f}} ms | bound "
                f"{ref['bound_ms']:{f}} ms ({ref['bound_by']}) | {lib} "
                + " / ".join("n/a" if x is None else f"{x:{f}}"
                             for x in libs) + " ms"
                + (" | flash_bf16 forced in the change's runs "
                   + " / ".join(f"{x:{f}}" for x in forced) + " ms"
                   if forced else ""))
    for what, (_, bound_, unit) in km_runs[0][1].items():
        if not all(what in km for _, km in km_runs):
            continue
        ms = {lab: [km[what][0] for l2, km in km_runs if l2 == lab]
              for lab in ("parent", "change")}
        log(f"A/B kmeans_stats {what}: parent {ms['parent'][0]:.3f} / "
            f"{ms['parent'][1]:.3f} {unit}, change {ms['change'][0]:.3f} / "
            f"{ms['change'][1]:.3f} {unit} | bound {bound_:.3f} {unit} "
            f"(bytes) | library: none")
    print(json.dumps({"ab": [{"run": lab, "timings": r, "kmeans_stats": km}
                             for (lab, r), (_, km) in zip(runs, km_runs)]}),
          flush=True)
    return 0


#: main()'s seconds a phase (a phase's name as the module docstring's)
PHASE_S = {}


def _timed(phase, fn, *args):
    """``fn(*args)``, its seconds kept under ``phase`` in PHASE_S."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[phase] = time.perf_counter() - t0
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        die("torch is not importable")
    if not torch.cuda.is_available():
        die("no CUDA device: torch.cuda.is_available() is False")
    if sys.argv[1:2] == ["--ab-timings"]:
        check(len(sys.argv) == 3, "usage: chip_smoke.py --ab-timings DIR")
        return ab_timings(sys.argv[2])
    t_start = time.perf_counter()
    name, count, card = _timed("1", setup)
    t0 = time.perf_counter()
    worst = kernel_checks()
    window_row_checks()
    prefill_row_checks()
    worst["kmeans_stats"] = kmeans_checks()
    worst.update(paged_kernel_checks())
    worst["lutq_shift"] = shift_checks()
    worst["flash_attention"] = flash_checks()
    worst.update(moe_kernel_checks())
    for checks in (deepseek_kernel_checks, seamless_kernel_checks,
                   paligemma_kernel_checks, zamba_kernel_checks,
                   rwkv_kernel_checks):
        for kname, err in checks().items():
            worst[kname] = max(worst[kname], err)
    quant_divide_checks()
    adamw_checks()
    PHASE_S["2"] = time.perf_counter() - t0
    launches, _, views, cfg = _timed("3", serve_full_width)
    _timed("3 reduced", reduced_reference)
    engine = _timed("3c", engine_runs, views, cfg)
    packed_launches = _timed("3i", packed_runs, views, cfg)
    spec_launches = _timed("3f", serve_speculative, views, cfg)
    del views
    torch.cuda.empty_cache()
    for variant in ("paged_attention", "paged_attention_multipass"):
        launches[variant] = sum(r["launches"][variant]
                                for r in engine.values())
    _timed("3d", reduced_engine_card_vs_cpu)
    moe = _timed("3m", moe_full_width)
    deepseek = _timed("3o", deepseek_full_width)
    seamless = _timed("3p", seamless_full_width)
    paligemma = _timed("3q", paligemma_full_width)
    zamba = _timed("3r", zamba_full_width)
    rwkv = _timed("3s", rwkv_full_width)
    dense = _timed("3n", dense_families_full_width)
    pow2 = _timed("3e", serve_pow2_full_width)
    launches["lutq_shift"] = pow2["launches"]
    trained = _timed("3b", train_full_width)
    launches["kmeans_stats"] = trained["launches"]
    handoff = {}
    _timed("3g", handoff_full_width, trained, handoff)
    del trained
    _timed("3b reduced", reduced_train_card_vs_cpu)
    seq_train = _timed("3t", sequence_train)
    _timed("3h", text_path_e2e, handoff)
    _timed("3h reduced", reduced_ckpt_card_vs_cpu, handoff)
    log(f"phase 3g {PHASE_S['3g']:.1f} s, phase 3h and the reduced "
        f"checkpoint {PHASE_S['3h'] + PHASE_S['3h reduced']:.1f} s (3b' is "
        f"inside phase 3b) | launches {handoff}")
    t0 = time.perf_counter()
    vision_reduced_card_vs_cpu()
    vision, vision_worst = vision_full_width(card)
    for kname, err in vision_worst.items():
        worst[kname] = max(worst[kname], err)
    PHASE_S["3j"] = time.perf_counter() - t0
    log(f"phase 3j {PHASE_S['3j']:.1f} s | launches {vision}")
    t0 = time.perf_counter()
    # the GEMMs and lutq_shift at decode (M = 4, the record's top level)
    # and at prefill (M = 512, its "prefill" entry)
    table, prefill = {}, {}
    for kname, per_m in timings(card).items():
        table[kname], prefill[kname] = per_m[4], per_m[512]
    shift = shift_timings(card)
    table["lutq_shift"], prefill["lutq_shift"] = shift[4], shift[512]
    table["kmeans_stats"] = dict(kmeans_timings(card), library_ms=None)
    from repro_torch.runtime.engine import synthetic_requests

    run_a = synthetic_requests(cfg, 8, max_prompt=512, max_new=64, seed=0)
    paged = paged_timings(card, [len(r["tokens"]) + r["max_new"] // 2
                                 for r in run_a])
    for variant, geometry in (("paged_attention", "a"),
                              ("paged_attention_multipass", "c")):
        g = paged[geometry]
        table[variant] = dict(ms=g["times"][variant][0],
                              plain_ms=g["plain_ms"], bound_ms=g["bound_ms"],
                              bound_by=g["bound_by"],
                              library_ms=g["library_ms"])
    # kernels 6 and 7 at run (a)'s geometry with head dim 128 at
    # qwen1.5-110b's group (8) and mistral-large-123b's (12)
    wide = {}
    for G in (8, 12):
        g = paged_timings(card, [len(r["tokens"]) + r["max_new"] // 2
                                 for r in run_a], G=G, dh=128, labels=("a",),
                          sweep=False)["a"]
        for variant in ("paged_attention", "paged_attention_multipass"):
            wide.setdefault(variant, {})[f"G{G}_dh128"] = dict(
                ms=g["times"][variant][0], plain_ms=g["plain_ms"],
                bound_ms=g["bound_ms"], bound_by=g["bound_by"],
                library_ms=g["library_ms"])
    # phase 4p: kernels 6 and 7 at seamless's G = 1, dh 64 (16 KV heads,
    # bf16 pages: encdec never quantizes its pages) at run (a)'s lengths
    g = paged_timings(card, [len(r["tokens"]) + r["max_new"] // 2
                             for r in run_a], G=1, dh=64, Hkv=16,
                      kv_dtype="bfloat16", labels=("a",), sweep=False)["a"]
    for variant in ("paged_attention", "paged_attention_multipass"):
        wide.setdefault(variant, {})["G1_dh64_bf16"] = dict(
            ms=g["times"][variant][0], plain_ms=g["plain_ms"],
            bound_ms=g["bound_ms"], bound_by=g["bound_by"],
            library_ms=g["library_ms"])
    # kernel 5: danube's prefill geometry (the 4096 row is logged)
    table["flash_attention"] = flash_timings(card)["danube"]
    # the expert-stacked kernels: one MoE layer's three products at E =
    # 128, C = 1 (the record's top level) and C = 40 (its "prefill")
    for kname, per_c in moe_kernel_timings(card).items():
        table[kname], prefill[kname] = per_c[1], per_c[40]
    # phase 4o: the stacks at deepseek's E = 64, C = 1 and 60
    ds_stacks = moe_kernel_timings(card, E=DS_E, shapes=DS_SHAPES,
                                   cs=(1, 60))
    launches.update({k: moe[k] for k in MOE_KERNELS})
    records = []
    for kname, meta in {**KERNELS, **MOE_KERNELS}.items():
        t = table[kname]
        records.append({
            "name": kname, "route": meta["route"], "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[kname],
            "max_abs_err": worst[kname],
            # GEMMs: one decode forward at B=4, the 169 calls of the serve
            # path (lutq_shift: the 168 body calls of serving_pow2, with
            # launches over its generate and engine runs); kmeans_stats:
            # one training step, its 340 calls; paged
            # attention: one call at run (a)'s geometry (shared-memory
            # variant) and at run (c)'s longest row (workspace variant,
            # forced: on the engine's path danube's rows never need it);
            # flash attention: one call at danube's prefill geometry (no
            # path of the reference or the port reaches it: 0 launches);
            # the expert-stacked kernels: one MoE layer's three products
            # at qwen3-moe's shapes, E = 128, C = 1, with launches over
            # phase 3m's graph-mode generate of the view that runs them
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
        # phase 3o: deepseek-v2-lite's graph-mode generates
        if kname in deepseek:
            records[-1]["deepseek_launches"] = deepseek[kname]
        # phase 3p: seamless-m4t-medium's graph-mode generates and engines
        if kname in seamless:
            records[-1]["seamless_launches"] = seamless[kname]
        # phase 3q: paligemma-3b's graph-mode generates, engines, training
        if kname in paligemma:
            records[-1]["paligemma_launches"] = paligemma[kname]
        # phase 3r: zamba2-2.7b's graph-mode generates and engine
        if kname in zamba:
            records[-1]["zamba_launches"] = zamba[kname]
        # phase 3s: rwkv6-1.6b's graph-mode generates and engine
        if kname in rwkv:
            records[-1]["rwkv_launches"] = rwkv[kname]
        # phase 3t: the sequence families' full-width training steps
        if kname == "kmeans_stats":
            records[-1]["sequence_train_launches"] = seq_train
        if kname in MOE_KERNELS:  # phase 2m's timing at C = 40
            p = prefill[kname]
            records[-1]["prefill"] = {
                "C": 40, "ms": p["ms"], "plain_ms": p["plain_ms"],
                "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
                "library_ms": p["library_ms"]}
            # phase 4o: one deepseek MoE layer's three products, E = 64
            records[-1]["deepseek"] = {
                f"C{C}": {k: t[k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")}
                for C, t in ds_stacks[kname].items()}
            continue
        if kname in moe["dense"]:  # phase 3m's q, k, v, o and head
            records[-1]["moe_launches"] = moe["dense"][kname]
        # phase 3n: mistral-large-123b's and qwen1.5-110b's graph-mode
        # generates and paged engines, mistral-nemo-12b's engine
        records[-1]["dense_family_launches"] = dense.get(kname, 0)
        if kname in wide:  # phase 4 at dh 128, G = 8 and 12, and G = 1,
            records[-1]["shapes"] = wide[kname]  # dh 64 (4p), run (a)
        if kname in spec_launches:  # phase 3f's speculative runs
            records[-1]["speculative_launches"] = spec_launches[kname]
        if kname in packed_launches:  # phase 3i's packed graph passes
            records[-1]["packed_launches"] = packed_launches[kname]
        # phases 3g, 3h and the reduced checkpoint: the handoff path
        records[-1]["handoff_launches"] = handoff.get(kname, 0)
        # phase 3j: the vision serve views' held-out evaluations
        records[-1]["vision_launches"] = vision.get(kname, 0)
        # phase 3k: the multiply audit's runs and its refused negatives
        records[-1]["audit_launches"] = pow2["audit"]["launches"][kname]
        if kname in prefill:  # one prefill forward at B=4 x 128 (M=512)
            p = prefill[kname]
            records[-1]["prefill"] = {
                "M": 512, "ms": p["ms"], "plain_ms": p["plain_ms"],
                "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
                "library_ms": p["library_ms"]}
    PHASE_S["4"] = time.perf_counter() - t0
    log("seconds a phase: " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in PHASE_S.items()))
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
