"""End to end on real bytes: a ~57M-weight danube-family byte LM trained
under 4-bit pow2 LUT-Q with 8-bit activations on this checkout's own
source tree, with checkpoints and auto-resume (counterpart of the
reference's ``examples/train_e2e.py``).

    PYTHONPATH=src python -m repro_torch.launch.train_e2e --ckpt-dir DIR
    PYTHONPATH=src python -m repro_torch.launch.train_e2e --tiny --device cpu

The model is h2o-danube-1.8b's family (GQA, sliding window) cut to 12
layers of width 640 (8 query / 2 KV heads, window 256) over the 256-byte
vocab; 300 AdamW steps of 4 x 256 bytes (``--tiny``: 2 layers of width
128, 40 steps of 4 x 64). Batches are ``data.text.byte_batch`` windows
of ``default_corpus(<checkout root>)``; a checkpoint is written every
100 steps and at the end, in the reference's format, so
``launch/serve.py --ckpt-dir`` (with ``--vocab 256`` and the matching
``--arch``/width) or ``interop.from_train_params`` serves it.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.core.spec import QuantSpec
from repro_torch.data.text import byte_batch, default_corpus
from repro_torch.device import resolve_device
from repro_torch.kernels import kmeans_stats
from repro_torch.models import api
from repro_torch.optim.optimizers import adamw, cosine_schedule
from repro_torch.optim.train_state import init_train_state, make_train_step
from repro_torch.runtime.loop import TrainLoop

#: the checkout whose files are the corpus
ROOT = Path(__file__).resolve().parents[3]


def e2e_config(tiny: bool):
    """(cfg, steps, batch, seq) of the example's run."""
    base = get_config("h2o-danube-1.8b")
    if tiny:
        cfg = base.replace(
            n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
            d_ff=256, vocab=256, window=64, dtype=torch.float32,
            attn_q_block=64, attn_kv_block=64,
            quant=QuantSpec(bits=4, constraint="pow2", min_size=1024),
            act_bits=8)
        return cfg, 40, 4, 64
    # 12 layers x d640 (GQA 8/2, window 256) over the byte vocab
    cfg = base.replace(
        n_layers=12, d_model=640, n_heads=8, n_kv_heads=2, head_dim=80,
        d_ff=1920, vocab=256, window=256, dtype=torch.float32,
        attn_q_block=128, attn_kv_block=128,
        quant=QuantSpec(bits=4, constraint="pow2", min_size=4096),
        act_bits=8)
    return cfg, 300, 4, 256


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "lutq_e2e_ckpt"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to train; cuda raises when no card is found")
    return ap


def train(args, *, log_fn=print):
    """Run the recipe; returns (cfg, state, loop, step, corpus)."""
    dev = resolve_device(args.device)
    cfg, steps, batch, seq = e2e_config(args.tiny)
    steps = args.steps or steps
    model = api.quantize(api.init(cfg, seed=0, device=dev), cfg)
    n = (sum(p.numel() for p in model.parameters())
         + sum(b.numel() for b in model.buffers()))
    log_fn(f"[e2e] {n/1e6:.1f}M parameter slots (incl. LUT-Q state), "
           f"{steps} steps, batch {batch}x{seq}")

    opt = adamw(cosine_schedule(3e-3, 20, steps))
    state = init_train_state(model, opt)
    step_fn = make_train_step(cfg, api.loss_fn, opt)

    corpus = default_corpus(str(ROOT))
    log_fn(f"[e2e] corpus: {len(corpus)/1e6:.2f}M bytes of this checkout")

    def make_batch(s):
        b = byte_batch(corpus, s, batch, seq, seed=1)
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    loop = TrainLoop(step_fn, make_batch, ckpt_dir=args.ckpt_dir,
                     ckpt_every=100, log_every=10, log_fn=log_fn)
    state, step = loop.run(state, steps)
    return cfg, state, loop, step, corpus


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    _, _, loop, step, _ = train(args)
    losses = [h["loss"] for h in loop.history]
    if losses:
        print(f"[e2e] byte-level CE {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"({step} steps; resume-capable checkpoint in "
              f"{args.ckpt_dir})")
    print(f"[e2e] kmeans_stats launches {kmeans_stats.COUNTS['launches']}, "
          f"plain {kmeans_stats.COUNTS['plain']} | device {args.device}")
    if not (losses and losses[-1] < losses[0]):
        raise RuntimeError(f"[e2e] the loss did not fall: {losses}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
