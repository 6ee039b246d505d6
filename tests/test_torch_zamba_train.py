"""Port parity, zamba2-2.7b (the hybrid family), training: reduced (4
Mamba2 layers in 2 super-blocks of 2, d_model 64, d_inner 128 = 8 SSM
heads of 16, ssm_state 16, chunk 8; the shared attention block after
each super-block; vocab 211, a tied readout) under 4-bit pow2 LUT-Q at
min_size 1024 (so that the reduced ``conv_w``, 2560 stacked, quantizes
as the full-width one does), against the JAX package on the same
numpy-seeded tokens and labels, weights through ``interop.from_jax``.

Held: ``api.loss_fn`` (the Mamba layers over the whole sequence with the
chunked SSD scan, the shared block after each super-block, the tied
readout through the STE, the masked CE) and its gradient over the
trainable split, against ``jax.value_and_grad`` of the reference's
``loss_fn``; ``in_proj``, ``out_proj``, the STE'd ``conv_w`` of every
layer of the two-axis stack, the shared block's and the tied table's
gradients among them: in float32 the loss within 1e-5 relative and
each gradient within 1e-4 of its leaf's largest magnitude; in bfloat16
the loss within 2^-7 relative (this family's bf16 prefill bound) and
each gradient within 2^-7 of its leaf's largest magnitude for each
layer it crosses, forward and back (2 x 6 layer applications: 0.094;
measured 7.0e-2 on an ``A_log``, whose gradient sums the f32 scan's
terms under a bf16 upstream gradient). The loss and every gradient are
the same bits with ``cfg.remat`` on and off. The SSD scan checkpointed a
chunk at a time (13 tokens, chunks of 8 and 4) gives the scan without
checkpoints' forward bits and gradients within 1e-6 of each input's
largest, and keeps no chunk's (B, H, L, L) decay for the backward.
Three ``make_train_step`` steps (``kmeans_impl`` "stats" and "dense")
against the reference's train step (losses and grad-norms within 1e-5
relative, dictionaries within 1e-6, assignments equal, masters within
1e-4 of their leaf's largest: ``conv_b`` starts at zero, and AdamW,
which divides by a gradient's root mean square, carries a float32
difference of a near-zero gradient into its master, measured 2.1e-5).
The CLI trains the reduced config on the CPU and its checkpoint serves
through the serve CLI's ``--ckpt-dir`` with the in-memory model's
greedy tokens.
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

from repro.core.spec import QuantSpec as JSpec
from repro.models import api as japi
from repro_torch import interop
from repro_torch.core.spec import QuantSpec as TSpec
from repro_torch.nn import mamba2 as tm
from repro_torch.nn.tree import QuantKernel

ARCH = "zamba2-2.7b"
B, T, STEPS = 2, 13, 3
LR = dict(peak=1e-3, warmup=1, total=STEPS)
#: (loss relative, gradient of max|g|) per working dtype; bf16 gradients
#: 2^-7 for each of the 2 x 6 layer passes (4 Mamba layers, 2
#: applications of the shared block)
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2.0 ** -7, 2.0 ** -7 * 12)}


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _cfgs(dtype="float32", **kw):
    """Reduced zamba at 4-bit pow2, min_size 1024, act_bits 32, remat off
    unless given."""
    kw.setdefault("remat", False)
    jcfg, tcfg = cfg_pair(dtype, arch=ARCH, act_bits=32, **kw)
    spec = dict(bits=4, constraint="pow2", min_size=1024)
    return jcfg.replace(quant=JSpec(**spec)), tcfg.replace(quant=TSpec(**spec))


@pytest.fixture(scope="module")
def jq():
    jcfg, _ = _cfgs()
    params, axes = japi.init(jax.random.PRNGKey(0), jcfg)
    return japi.quantize(params, jcfg, axes)


def _batch(seed):
    """tokens (B, T) and their next-token labels, the first row's tail
    ignored (-100)."""
    toks = np.random.RandomState(seed).randint(0, 211, (B, T + 1)).astype(
        np.int32)
    labels = toks[:, 1:].copy()
    labels[0, -5:] = -100
    return {"tokens": toks[:, :-1], "labels": labels}


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
    assert assert_grads_close(grads, jg, gtol) == len(
        list(model.parameters()))
    idx = {i for p, i in grads if p[0] == "mamba_layers"}
    assert idx == {(s, i) for s in range(2) for i in range(2)}
    names = {"/".join(p) for p, _ in grads}
    assert {"embed/table", "mamba_layers/mamba/conv_w",
            "mamba_layers/mamba/in_proj/kernel", "mamba_layers/mamba/A_log",
            "shared/attn/q/kernel", "shared/mlp/wo/kernel"} <= names


def test_remat_gives_the_same_bits(jq):
    assert_remat_same_bits(lambda remat: _cfgs(remat=remat)[1], jq,
                           _batch(2))


def _ssd_inputs(seed, H=8, P=16, N=16):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).requires_grad_()

    dt = torch.nn.functional.softplus(torch.randn((B, T, H), generator=g)
                                      - 1.0)
    A = torch.linspace(1.0, 4.0, H)
    return (rnd(B, T, H, P), dt.requires_grad_(), A.requires_grad_(),
            rnd(B, T, N), rnd(B, T, N))


@pytest.mark.parametrize("chunk", [8, 4])
def test_ssd_checkpointed_backward_equals_plain(chunk, monkeypatch):
    """Under autograd each chunk of the scan is recomputed in the
    backward (13 tokens: the last chunk padded): the forward is the bits
    of the scan without checkpoints, the gradients of x, dt, A, B, C and
    h0 within 1e-6 of each one's largest, and autograd keeps no chunk's
    (B, H, L, L) decay, where the plain scan keeps one a chunk."""
    x, dt, A, Bm, Cm = _ssd_inputs(3)
    h0 = (torch.randn((B, 8, 16, 16),
                      generator=torch.Generator().manual_seed(7)) * 0.1
          ).requires_grad_()
    inputs = (x, dt, A, Bm, Cm, h0)
    g = torch.Generator().manual_seed(4)
    gy = torch.randn((B, T, 8, 16), generator=g)
    gh = torch.randn((B, 8, 16, 16), generator=g)
    runs = {}
    for plain in (True, False):
        if plain:
            monkeypatch.setattr(tm, "checkpoint",
                                lambda fn, *a, **kw: fn(*a))
        else:
            monkeypatch.undo()
        n = [0]

        def pack(t):
            n[0] += tuple(t.shape) == (B, 8, chunk, chunk)
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            y, hT = tm.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
        grads = torch.autograd.grad((y * gy).sum() + (hT * gh).sum(),
                                    inputs)
        runs[plain] = (y.detach(), hT.detach(), grads, n[0])
    y0, h0_, g0, saves0 = runs[True]
    y1, h1, g1, saves1 = runs[False]
    assert torch.equal(y0, y1) and torch.equal(h0_, h1)
    for a, b in zip(g0, g1):
        assert (a - b).abs().max() <= 1e-6 * a.abs().max()
    assert saves0 >= -(-T // chunk) and saves1 == 0, (saves0, saves1)


@pytest.mark.parametrize("impl", ["stats", "dense"])
def test_train_steps_match_reference(jq, impl):
    jcfg, tcfg = _cfgs()
    batches = [_batch(10 + s) for s in range(STEPS)]
    jtree, jhist = jax_train_run(jcfg, jq, batches, impl, LR)
    ttree, thist, counts = port_train_run(tcfg, jq, batches, impl, LR)
    assert_histories_match(thist, jhist)
    near = assert_train_states_match(jtree, ttree, master_tol=1e-4)
    model = interop.from_jax(to_np(jq), tcfg)
    leaves = sum(isinstance(m, QuantKernel) for m in model.modules())
    want = STEPS * 2 * leaves if impl == "stats" else 0
    assert counts == {"launches": 0, "plain": want}, counts
    print(f"assignments that differ, all within 1e-6 of a midpoint: {near}")


def test_kmeans_tree_reaches_every_leaf(jq, monkeypatch):
    """The quantized leaves are the reference's: each Mamba layer's
    in_proj, out_proj and conv_w (one dictionary a layer of the two-axis
    stack), the shared block's seven products (one dictionary each, for
    all its applications) and the tied table; ``kmeans_tree`` runs step
    4 on every one of them, once."""
    got, n = assert_kmeans_tree_reaches_every_leaf(_cfgs()[1], jq,
                                                   monkeypatch)
    assert {("mamba_layers", "mamba", "conv_w"),
            ("shared", "attn", "q", "kernel"), ("embed", "table")} <= got
    assert n == 3 * 4 + 7 + 1


def test_cli_trains_and_its_checkpoint_serves(tmp_path, capsys):
    out = port_checkpoint_handoff(ARCH, str(tmp_path / "ckpt"), capsys)
    m = re.search(r"loss (\d+\.\d+) -> (\d+\.\d+) .* in 2 steps", out)
    assert m and all(np.isfinite(float(x)) for x in m.groups()), out
    assert "kmeans_stats launches 0" in out
