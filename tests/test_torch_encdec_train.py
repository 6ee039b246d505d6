"""Port parity, seamless-m4t-medium (the encdec family), training: reduced
(2 encoder + 2 decoder layers, d_model 64, 4 / 4 heads of 16, d_ff 96,
vocab 211, a tied readout) under 4-bit pow2 LUT-Q, against the JAX
package on the same numpy-seeded frames, tokens and labels, weights
through ``interop.from_jax``.

Held: ``api.loss_fn`` (the encoder over the frames, the decoder over the
whole target with unmasked cross-attention, the tied readout through the
STE, the masked CE) and its gradient over the trainable split, against
``jax.value_and_grad`` of the reference's ``loss_fn``, the tied table's
gradient (lookup and readout) and the encoder's among them: in float32
the loss within 1e-5 relative and each gradient within 1e-4 of its
leaf's largest magnitude; in bfloat16 the loss within 2^-7 relative
(the bound of this family's bf16 prefill parity) and each gradient
within 2^-7 of its leaf's largest magnitude for each layer the
gradient crosses, forward and back (2 x 4 layers: 2^-4; measured 2.7e-2,
bf16 products and sums rounding in another order at each layer). The loss
and every gradient are the same bits with ``cfg.remat`` on and off.
Three ``make_train_step`` steps (AdamW + ``kmeans_tree``, ``kmeans_impl``
forced to ``"stats"`` and to ``"dense"``) against the reference's train
step: losses and grad-norms within 1e-5 relative, dictionaries within
1e-6, assignments equal but within 1e-6 of a midpoint, masters within
1e-5 of their largest magnitude. The CLI trains the reduced config on
the CPU; its batches carry ``frames`` drawn from the data seed and the
step; its checkpoint serves through the serve CLI's ``--ckpt-dir`` with
the in-memory model's greedy tokens; ``interop.trainable_shapes`` is the
reference's trainable tree.
"""
import re

import jax
import numpy as np
import pytest
import torch
from torch_port_helpers import (assert_grads_close, assert_histories_match,
                                assert_kmeans_tree_reaches_every_leaf,
                                assert_remat_same_bits,
                                assert_train_states_match, cfg_pair,
                                jax_loss_and_grads, jax_train_run,
                                one_thread, port_checkpoint_handoff,
                                port_grads, port_loss_backward,
                                port_train_run, to_np)

from repro.core import policy as jpolicy
from repro.models import api as japi
from repro_torch import interop
from repro_torch.data.synthetic import MarkovLM
from repro_torch.launch import train as t_train_cli
from repro_torch.models import api as tapi
from repro_torch.nn.tree import QuantKernel

ARCH = "seamless-m4t-medium"
B, T, S_SRC, STEPS = 2, 12, 9, 3
LR = dict(peak=1e-3, warmup=1, total=STEPS)
#: (loss relative, gradient of max|g|) per working dtype; bf16 gradients
#: 2^-7 for each of the 2 x 4 layer passes (2 encoder + 2 decoder layers,
#: forward and backward)
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2.0 ** -7, 2.0 ** -7 * 8)}


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _cfgs(dtype="float32", **kw):
    """Reduced seamless at 4-bit pow2 (the helpers' 512 floor: every
    leaf quantizes), act_bits 32, remat off unless given."""
    kw.setdefault("remat", False)
    return cfg_pair(dtype, arch=ARCH, constraint="pow2", act_bits=32, **kw)


@pytest.fixture(scope="module")
def jq():
    jcfg, _ = _cfgs()
    params, axes = japi.init(jax.random.PRNGKey(0), jcfg)
    return japi.quantize(params, jcfg, axes)


def _batch(seed, vocab=211):
    """frames (B, S_SRC, 64), tokens (B, T) and their next-token labels,
    the last column and the second row's tail ignored (-100)."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, (B, T + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[1, -4:] = -100
    return {"frames": rng.randn(B, S_SRC, 64).astype(np.float32),
            "tokens": toks[:, :-1], "labels": labels}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_gradients_equal_jax_grad(jq, dtype):
    jcfg, tcfg = _cfgs(dtype)
    batch = _batch(1)
    jl, jg = jax_loss_and_grads(jcfg, jq, batch)
    model = interop.from_jax(to_np(jq), tcfg)
    loss = port_loss_backward(model, tcfg, batch)
    ltol, gtol = TOL[dtype]
    assert abs(loss.item() - jl) <= ltol * abs(jl), (loss.item(), jl)
    grads = port_grads(model)
    n = assert_grads_close(grads, jg, gtol)
    assert n == len(list(model.parameters()))
    # the tied table (lookup and readout) and every encoder layer
    names = {"/".join(p) for p, _ in grads}
    assert {"embed/table", "encoder/attn/q/kernel", "encoder/mlp/wo/kernel",
            "decoder/xattn/k/kernel", "enc_norm/scale"} <= names


def test_remat_gives_the_same_bits(jq):
    """Each encoder and decoder layer recomputed in the backward
    (``cfg.remat``) changes no bit of the loss or of any gradient."""
    assert_remat_same_bits(lambda remat: _cfgs(remat=remat)[1], jq,
                           _batch(2))


def test_remat_recomputes_the_layers(jq):
    """With ``cfg.remat`` the autograd graph keeps no layer's
    intermediates: only the layers' inputs (the residual stream and the
    memory) outside the checkpoints, against every attention and MLP
    activation without it."""
    batch = {k: torch.from_numpy(v) for k, v in _batch(3).items()}
    saved = {}
    for remat in (False, True):
        _, tcfg = _cfgs(remat=remat)
        model = interop.from_jax(to_np(jq), tcfg)
        n = [0]

        def pack(t):
            n[0] += 1
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            tapi.loss_fn(model, tcfg, batch)
        saved[remat] = n[0]
    assert saved[True] * 4 < saved[False], saved


@pytest.mark.parametrize("impl", ["stats", "dense"])
def test_train_steps_match_reference(jq, impl):
    jcfg, tcfg = _cfgs()
    batches = [_batch(10 + s) for s in range(STEPS)]
    jtree, jhist = jax_train_run(jcfg, jq, batches, impl, LR)
    ttree, thist, counts = port_train_run(tcfg, jq, batches, impl, LR)
    assert_histories_match(thist, jhist)
    near = assert_train_states_match(jtree, ttree)
    model = interop.from_jax(to_np(jq), tcfg)
    leaves = sum(isinstance(m, QuantKernel) for m in model.modules())
    # kmeans_iters = 1: two plain kmeans_stats passes a leaf a step
    want = STEPS * 2 * leaves if impl == "stats" else 0
    assert counts == {"launches": 0, "plain": want}, counts
    print(f"assignments that differ, all within 1e-6 of a midpoint: {near}")


def test_kmeans_tree_reaches_every_leaf(jq, monkeypatch):
    """The quantized leaves are the reference's, one dictionary a layer
    of the encoder and decoder stacks (xattn among them) and one for the
    tied table; ``kmeans_tree`` runs step 4 on every one of them, once."""
    got, n = assert_kmeans_tree_reaches_every_leaf(_cfgs()[1], jq,
                                                   monkeypatch)
    assert {("decoder", "xattn", "o", "kernel"), ("embed", "table")} <= got
    assert n == 7 * 2 + 11 * 2 + 1


def test_trainable_shapes_are_the_reference_tree(jq):
    _, tcfg = _cfgs()
    trainable, _ = jpolicy.split_trainable(jq)
    want = {p: tuple(leaf.shape) for p, leaf in
            interop.walk(to_np(trainable)) if leaf is not None}
    assert interop.trainable_shapes(tcfg) == want


def _cli_args(*flags):
    args = t_train_cli.parser().parse_args(
        ["--arch", ARCH, "--reduced", "--batch", "2", "--seq", "8",
         "--device", "cpu", *flags])
    args.device = torch.device("cpu")
    return args


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_fn_draws_frames_from_the_step(dtype):
    """An encdec batch has ``frames`` (batch, seq, d_model) in the
    config's dtype, standard normal from ``frames_seed``: the same for
    the same step (a resumed run sees them again), another step's
    differ; other families' batches carry none."""
    args = _cli_args()
    cfg = t_train_cli._train_cfg(args).replace(dtype=dtype)
    lm = MarkovLM(cfg.vocab, seed=0)
    make = t_train_cli.batch_fn(lm, args, args.device, cfg)
    b0, again, b1 = make(0), make(0), make(1)
    assert b0["frames"].shape == (2, 8, cfg.d_model)
    assert b0["frames"].dtype == dtype
    assert torch.equal(b0["frames"], again["frames"])
    assert not torch.equal(b0["frames"], b1["frames"])
    gen = torch.Generator().manual_seed(t_train_cli.frames_seed(0, 1))
    assert torch.equal(b1["frames"], torch.randn((2, 8, cfg.d_model),
                                                 generator=gen).to(dtype))
    assert t_train_cli.frames_seed(0, 1) != t_train_cli.prefix_seed(0, 1)
    dense = t_train_cli._train_cfg(
        t_train_cli.parser().parse_args(["--arch", "h2o-danube-1.8b",
                                         "--reduced"]))
    assert set(t_train_cli.batch_fn(lm, args, args.device, dense)(0)) == {
        "tokens", "labels"}


def test_cli_trains_and_its_checkpoint_serves(tmp_path, capsys):
    out = port_checkpoint_handoff(ARCH, str(tmp_path / "ckpt"), capsys)
    m = re.search(r"loss (\d+\.\d+) -> (\d+\.\d+) .* in 2 steps", out)
    assert m and all(np.isfinite(float(x)) for x in m.groups()), out
    assert "kmeans_stats launches 0" in out
