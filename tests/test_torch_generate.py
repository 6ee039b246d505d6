"""Port parity, generation: greedy tokens of the port's ``generate`` on
reduced danube equal the JAX reference loop's (prefill ->
adapt_prefill_cache -> argmax -> decode_step), and the entry points
refuse to fall back to the CPU silently."""
import numpy as np
import pytest
import torch
from torch_port_helpers import (cfg_pair, jax_quantized, jax_reference,
                                one_thread, to_np, tokens)

from repro.core.policy import serve_view as j_serve_view
from repro.models import api as japi
from repro_torch import interop
from repro_torch.core.policy import serve_view as t_serve_view
from repro_torch.kernels import lutq_gemv_packed, lutq_matmul, ops
from repro_torch.launch import serve as t_serve_cli
from repro_torch.models import api as tapi
from repro_torch.runtime import serving as tserving

B, P, STEPS = 2, 30, 8


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jq():
    return jax_quantized(cfg_pair()[0])


def _launches():
    return (lutq_matmul.COUNTS["launches"],
            lutq_gemv_packed.COUNTS["launches"])


@pytest.mark.parametrize("pack4,kv_cache_bits,window", [
    (False, 16, 24), (True, 16, 24), (False, 8, 24), (True, 8, 24),
    (True, 8, None)])
def test_greedy_tokens_identical(jq, pack4, kv_cache_bits, window):
    """window=None: a linear cache grown to max_len instead of the ring."""
    jcfg, tcfg = cfg_pair(act_bits=32, kv_cache_bits=kv_cache_bits,
                          window=window)
    js = j_serve_view(jq, pack4=pack4, policy=japi.resolved_policy(jcfg))
    model = t_serve_view(interop.from_jax(to_np(jq), tcfg), pack4=pack4,
                         policy=tapi.resolved_policy(tcfg))
    toks = tokens(jcfg, B, P, seed=5)
    _, want = jax_reference(jcfg, js, toks, STEPS)
    before = _launches()
    plain = (lutq_matmul.COUNTS["plain"], lutq_gemv_packed.COUNTS["plain"])
    got, stats = tserving.generate(model, tcfg,
                                   {"tokens": torch.from_numpy(toks)},
                                   steps=STEPS, return_stats=True,
                                   device="cpu")
    assert got.dtype == torch.int32 and got.shape == (B, STEPS)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats["decode_tok_s"] > 0
    # a CPU run goes through the plain versions and launches nothing:
    # 7 matmuls x 2 layers + head, per forward
    assert _launches() == before
    ran = (lutq_gemv_packed.COUNTS["plain"] - plain[1] if pack4
           else lutq_matmul.COUNTS["plain"] - plain[0])
    assert ran == STEPS * (7 * tcfg.n_layers + 1)


def test_generate_without_device_cpu_raises_here(jq):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    _, tcfg = cfg_pair()
    model = interop.from_jax(to_np(jq), tcfg)
    toks = torch.from_numpy(tokens(tcfg, B, P))
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        tserving.generate(model, tcfg, {"tokens": toks}, steps=2)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        tapi.init(tcfg)


def test_cli_without_device_cpu_raises_here():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is valid here")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        t_serve_cli.main(["--arch", "h2o-danube-1.8b", "--reduced"])


@pytest.mark.parametrize("flags", [[], ["--pack4"],
                                   ["--kernel-backend", "decode"]])
def test_cli_runs_on_cpu_and_launches_nothing(capsys, flags):
    before = _launches()
    decode_before = ops.COUNTS["decode"]
    assert t_serve_cli.main(["--arch", "h2o-danube-1.8b", "--reduced",
                             "--batch", "2", "--prompt-len", "12",
                             "--gen", "3", "--device", "cpu"] + flags) == 0
    out = capsys.readouterr().out
    assert "kernel launches: lutq_matmul 0, lutq_gemv_packed 0" in out
    assert "device cpu" in out
    assert _launches() == before
    want = {(): "fused: 9 leaves", ("--pack4",): "packed4: 8 leaves",
            ("--kernel-backend", "decode"): "decode: 9 leaves"}[tuple(flags)]
    assert want in out
    if flags == ["--kernel-backend", "decode"]:
        assert ops.COUNTS["decode"] > decode_before


def test_generate_refuses_unported_options(jq):
    """Speculative decoding under 8-bit activations is refused, as the
    reference refuses it (tests/test_torch_speculative.py holds the
    ported path); temperature and eos_id are ported
    (tests/test_torch_engine.py holds them to the serving contract)."""
    _, tcfg = cfg_pair()
    assert tcfg.act_bits == 8
    model = interop.from_jax(to_np(jq), tcfg)
    toks = torch.from_numpy(tokens(tcfg, B, P))
    with pytest.raises(ValueError, match="activation quantization"):
        tserving.generate(model, tcfg, {"tokens": toks}, steps=2,
                          device="cpu", speculative=2)
    for kw in (dict(temperature=0.7), dict(eos_id=3)):
        out = tserving.generate(model, tcfg, {"tokens": toks}, steps=2,
                                device="cpu", **kw)
        assert out.shape == (B, 2) and out.dtype == torch.int32


def test_ragged_lengths_match_per_stream_runs(jq):
    """A right-padded stream decodes as it would alone at its length."""
    _, tcfg = cfg_pair(act_bits=32)
    model = t_serve_view(interop.from_jax(to_np(jq), tcfg),
                         policy=tapi.resolved_policy(tcfg))
    toks = torch.from_numpy(tokens(tcfg, B, P, seed=6))
    lengths = torch.tensor([P, 17])
    got = tserving.generate(model, tcfg, {"tokens": toks}, steps=4,
                            lengths=lengths, max_len=P + 4, device="cpu")
    alone = tserving.generate(model, tcfg, {"tokens": toks[1:, :17]},
                              steps=4, max_len=P + 4, device="cpu")
    np.testing.assert_array_equal(got[1].numpy(), alone[0].numpy())


def test_serve_state_is_init_quantize_serve_view():
    _, tcfg = cfg_pair()
    model, manifest = tapi.serve_state(tcfg, seed=4, pack4=True,
                                       with_manifest=True, device="cpu")
    again = t_serve_view(tapi.quantize(tapi.init(tcfg, seed=4, device="cpu"),
                                       tcfg),
                         pack4=True, policy=tapi.resolved_policy(tcfg))
    a, b = interop.to_numpy(model), interop.to_numpy(again)
    for key in ("q", "o"):
        np.testing.assert_array_equal(a["layers"]["attn"][key]["kernel"].a,
                                      b["layers"]["attn"][key]["kernel"].a)
    assert manifest["layers/attn/q/kernel"]["backend"] == "packed4"
    assert all(v.w is None for v in (a["lm_head"]["kernel"],
                                     a["embed"]["table"]))
