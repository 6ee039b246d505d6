"""Port parity, rwkv6-1.6b (the ssm family), training: reduced (2 RWKV6
layers, d_model 64 = 4 WKV heads of 16, d_ff 128, the decay LoRA 64
wide; vocab 211, a tied readout) under the config's 4-bit pow2 LUT-Q,
against the JAX package on the same numpy-seeded tokens and labels,
weights through ``interop.from_jax``.

Held: ``api.loss_fn`` (the f32 residual stream from a zero state, the
exact WKV recurrence, the tied readout through the STE, the masked CE)
and its gradient over the trainable split, against ``jax.value_and_grad``
of the reference's ``loss_fn``, the tied table's and the bare decay-LoRA
leaves' (``w1``, ``w2``) gradients among them: in float32 the loss
within 1e-5 relative and each gradient within 1e-4 of its leaf's largest
magnitude; in bfloat16 the loss within 2^-7 relative (this family's bf16
prefill bound) and each gradient within 2^-7 of its leaf's largest
magnitude for each layer it crosses, forward and back (2 x 2 layers:
2^-5; measured 6.9e-5, the body runs in f32). The loss and every
gradient are the same bits with ``cfg.remat`` on and off. The WKV scan
checkpointed a chunk at a time (13 tokens, chunks of 8 and 5) gives the
unchunked scan's forward bits and its gradients within 1e-6 of each
input's largest gradient (the chunks sum u's and the state's gradients
in another order), and keeps a state a chunk, not one a token, for the
backward.
Three ``make_train_step`` steps (``kmeans_impl`` "stats" and "dense")
against the reference's train step, as tests/test_torch_train.py holds
danube's (losses within 1e-5 relative, dictionaries within 1e-6,
assignments equal), but for the grad-norms and masters: within 1e-4 (the
gradient bound above). From the state after two steps the same batch's
gradients differ by up to 8.8e-5 of their leaves' largest in float32
(5e-6 at the first step: the trained model is more sensitive, its grad
norm 27 against 9.5), and AdamW, which divides by the gradient's root
mean square, carries such a difference into a near-zero gradient's
master. The CLI trains the reduced config on the CPU and its
checkpoint serves through the serve CLI's ``--ckpt-dir`` with the
in-memory model's greedy tokens.
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
from repro_torch.nn import rwkv6 as tr
from repro_torch.nn.tree import QuantKernel

ARCH = "rwkv6-1.6b"
B, T, STEPS = 2, 13, 3
LR = dict(peak=1e-3, warmup=1, total=STEPS)
#: (loss relative, gradient of max|g|) per working dtype; bf16 gradients
#: 2^-7 for each of the 2 x 2 layer passes
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2.0 ** -7, 2.0 ** -7 * 4)}


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _cfgs(dtype="float32", **kw):
    """Reduced rwkv at the config's 4-bit pow2 spec (min_size 4096: every
    reduced leaf's stacked size is 8192 or more, w1 and w2 among them),
    act_bits 32, remat off unless given."""
    kw.setdefault("remat", False)
    jcfg, tcfg = cfg_pair(dtype, arch=ARCH, act_bits=32, **kw)
    spec = dict(bits=4, constraint="pow2", min_size=4096)
    return jcfg.replace(quant=JSpec(**spec)), tcfg.replace(quant=TSpec(**spec))


@pytest.fixture(scope="module")
def jq():
    jcfg, _ = _cfgs()
    params, axes = japi.init(jax.random.PRNGKey(0), jcfg)
    return japi.quantize(params, jcfg, axes)


def _batch(seed):
    """tokens (B, T) and their next-token labels, the second row's tail
    ignored (-100)."""
    toks = np.random.RandomState(seed).randint(0, 211, (B, T + 1)).astype(
        np.int32)
    labels = toks[:, 1:].copy()
    labels[1, -3:] = -100
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
    names = {"/".join(p) for p, _ in grads}
    assert {"embed/table", "layers/mix/w1", "layers/mix/w2", "layers/mix/u",
            "layers/mix/w0", "layers/mix/mix_w"} <= names


def test_remat_gives_the_same_bits(jq):
    assert_remat_same_bits(lambda remat: _cfgs(remat=remat)[1], jq,
                           _batch(2))


def _wkv_inputs(seed, dk=16):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).requires_grad_()

    w = torch.sigmoid(torch.randn((B, T, 4, dk), generator=g) + 2.0)
    return (rnd(B, T, 4, dk), rnd(B, T, 4, dk), rnd(B, T, 4, dk),
            w.requires_grad_(), rnd(4, dk, scale=0.1),
            rnd(B, 4, dk, dk, scale=0.5))


def _state_saves(fn):
    """Run ``fn`` and count the (B, H, dk, dv) tensors autograd keeps."""
    n = [0]

    def pack(t):
        n[0] += tuple(t.shape) == (B, 4, 16, 16)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, n[0]


@pytest.mark.parametrize("chunk", [8, 5])
def test_wkv_chunked_backward_equals_unchunked(chunk):
    """Under autograd the scan runs in checkpointed chunks (13 tokens is
    no multiple of the chunk): the forward is the unchunked loop's bits,
    the gradients of r, k, v, w, u and s0 within 1e-6 of each one's
    largest (u's and the state's sums run in another order), and the
    graph keeps a state at each chunk's start only, not one a token."""
    inputs = _wkv_inputs(3)
    g = torch.Generator().manual_seed(4)
    gy = torch.randn((B, T, 4, 16), generator=g)
    gs = torch.randn((B, 4, 16, 16), generator=g)
    runs = {}
    for c in (None, chunk):
        (y, sT), saves = _state_saves(lambda: tr.wkv_scan(*inputs, chunk=c))
        grads = torch.autograd.grad((y * gy).sum() + (sT * gs).sum(),
                                    inputs)
        runs[c] = (y.detach(), sT.detach(), grads, saves)
    y0, s0, g0, saves0 = runs[None]
    y1, s1, g1, saves1 = runs[chunk]
    assert torch.equal(y0, y1) and torch.equal(s0, s1)
    for a, b in zip(g0, g1):
        assert (a - b).abs().max() <= 1e-6 * a.abs().max()
    assert saves0 >= T and saves1 == -(-T // chunk), (saves0, saves1)


def test_serving_scan_runs_unchunked():
    """Without autograd the chunk changes nothing: one loop over all the
    tokens, the same bits as the unchunked scan."""
    inputs = [t.detach() for t in _wkv_inputs(5)]
    with torch.no_grad():
        want = tr.wkv_scan(*inputs)
        got = tr.wkv_scan(*inputs, chunk=4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("impl", ["stats", "dense"])
def test_train_steps_match_reference(jq, impl):
    jcfg, tcfg = _cfgs()
    batches = [_batch(10 + s) for s in range(STEPS)]
    jtree, jhist = jax_train_run(jcfg, jq, batches, impl, LR)
    ttree, thist, counts = port_train_run(tcfg, jq, batches, impl, LR)
    assert_histories_match(thist, jhist, norm_rtol=1e-4)
    near = assert_train_states_match(jtree, ttree, master_tol=1e-4)
    model = interop.from_jax(to_np(jq), tcfg)
    leaves = sum(isinstance(m, QuantKernel) for m in model.modules())
    want = STEPS * 2 * leaves if impl == "stats" else 0
    assert counts == {"launches": 0, "plain": want}, counts
    print(f"assignments that differ, all within 1e-6 of a midpoint: {near}")


def test_kmeans_tree_reaches_every_leaf(jq, monkeypatch):
    """The quantized leaves are the reference's: a layer's eight
    products, the decay LoRA's bare w1 and w2, and the tied table;
    ``kmeans_tree`` runs step 4 on every one of them, once."""
    got, n = assert_kmeans_tree_reaches_every_leaf(_cfgs()[1], jq,
                                                   monkeypatch)
    assert {("layers", "mix", "w1"), ("layers", "mix", "w2"),
            ("embed", "table")} <= got
    assert n == 10 * 2 + 1


def test_cli_trains_and_its_checkpoint_serves(tmp_path, capsys):
    out = port_checkpoint_handoff(ARCH, str(tmp_path / "ckpt"), capsys)
    m = re.search(r"loss (\d+\.\d+) -> (\d+\.\d+) .* in 2 steps", out)
    assert m and all(np.isfinite(float(x)) for x in m.groups()), out
    assert "kmeans_stats launches 0" in out
