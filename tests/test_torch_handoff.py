"""Port parity, the train -> serve handoff: ``ckpt.restore_params``,
``interop.from_train_params``, ``launch/serve.py --ckpt-dir / --vocab``
(with ``check_ckpt_shapes``) and ``launch/train_e2e``.

A checkpoint written by the reference's training CLI and one written by
the port's (reduced h2o-danube-1.8b, vocab 48, 6 steps, the CLIs'
4-bit pow2 spec) are each served by both packages: the port through
``restore_params -> from_train_params -> serve_view -> generate`` (fused
and packed4) and one paged ``Engine`` run, the reference through
``restore_params -> merge_trainable -> serve_view`` and its plain
prefill/decode loop (``torch_port_helpers.jax_reference``; the
reference's own engine on serve-form weights is a red test, ROADMAP
queue 3). Served at act_bits=32 and float32, as the other serving parity
tests are: greedy tokens identical, each step's logits within 1e-5 of
that step's max|logits| (float32 sums in another order).
"""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch_port_helpers import (ARCH, cfg_pair, jax_quantized, jax_reference,
                                one_thread, port_teacher_forced, to_np,
                                tokens)

from repro.checkpoint import ckpt as jckpt
from repro.core.policy import merge_trainable as j_merge
from repro.core.policy import serve_view as j_serve_view
from repro.launch import train as j_train_cli
from repro.models import api as japi
from repro_torch import interop
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.core.lutq import LutqState
from repro_torch.core.policy import (backend_manifest, draft_view,
                                     serve_view)
from repro_torch.kernels.ref import unpack4_kin
from repro_torch.launch import serve as t_serve_cli
from repro_torch.launch import train as t_train_cli
from repro_torch.launch import train_e2e
from repro_torch.models import api as tapi
from repro_torch.nn.tree import QuantKernel, tree_paths
from repro_torch.runtime import serving as tserving
from repro_torch.runtime.engine import Engine

VOCAB, B, P, STEPS = 48, 2, 12, 6
TRAIN = ["--arch", ARCH, "--reduced", "--batch", "4", "--seq", "16",
         "--vocab", str(VOCAB)]


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """{"reference": dir, "port": dir}: 6 steps of each package's
    training CLI at its defaults."""
    root = tmp_path_factory.mktemp("ckpts")
    dirs = {"reference": str(root / "reference"), "port": str(root / "port")}
    assert j_train_cli.main(TRAIN + ["--steps", "6", "--ckpt-dir",
                                     dirs["reference"]]) == 0
    assert t_train_cli.main(TRAIN + ["--steps", "6", "--ckpt-dir",
                                     dirs["port"], "--device", "cpu"]) == 0
    return dirs


def test_restore_params_maps_only_the_params(ckpts):
    for who, d in ckpts.items():
        got, step = tckpt.restore_params(d)
        want, jstep = jckpt.restore_params(d)
        assert step == jstep == 6 and set(got) == {"trainable", "static"}
        g, w = dict(interop.walk(got)), dict(interop.walk(want))
        assert g.keys() == w.keys(), who
        for path, leaf in g.items():
            if w[path] is None:
                assert leaf is None, path
                continue
            assert isinstance(leaf, np.memmap) and not leaf.flags.writeable
            assert leaf.dtype == w[path].dtype, path
            np.testing.assert_array_equal(leaf, w[path], err_msg=str(path))


def test_restore_params_never_reads_opt_state(ckpts, tmp_path):
    import shutil

    d = tmp_path / "ck"
    shutil.copytree(ckpts["port"], d)
    step_dir = d / "step_00000006"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    opt = [e["file"] for e in manifest["leaves"]
           if e["key"].startswith("opt_state/") and e["file"]]
    assert opt
    for f in opt:
        (step_dir / f).unlink()
    params, step = tckpt.restore_params(str(d))
    assert step == 6
    want, _ = tckpt.restore_params(ckpts["port"])
    for (p, a), (q, b) in zip(interop.walk(params), interop.walk(want)):
        assert p == q
        if a is not None:
            np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(d))
    assert tckpt.load is not None and tckpt.load(ckpts["port"])[1] == 6


def _serve_cfgs(d, backend):
    """(JAX cfg, port cfg) serving checkpoint ``d``: reduced danube at
    its vocab, float32, act_bits=32, the manifest's policy."""
    jcfg, tcfg = cfg_pair(act_bits=32, vocab=VOCAB, kernel_backend=backend)
    return (jcfg.replace(quant=jckpt.load_policy(d)),
            tcfg.replace(quant=tckpt.load_policy(d)))


def _port_serve(d, tcfg, pack4):
    params, _ = tckpt.restore_params(d)
    pol = tapi.resolved_policy(tcfg)
    model = interop.from_train_params(params, tcfg, pack4=pack4, policy=pol,
                                      device="cpu")
    return serve_view(model, pack4=pack4, policy=pol)


def _jax_serve(d, jcfg, pack4):
    state, _ = jckpt.restore_params(d)
    qp = j_merge(state["trainable"], state["static"])
    return j_serve_view(qp, pack4=pack4, policy=japi.resolved_policy(jcfg))


@pytest.mark.parametrize("who", ["reference", "port"])
@pytest.mark.parametrize("backend", ["fused", "packed4"])
def test_checkpoint_serves_the_same_tokens_in_both(ckpts, who, backend):
    d = ckpts[who]
    pack4 = backend == "packed4"
    jcfg, tcfg = _serve_cfgs(d, backend)
    js, model = _jax_serve(d, jcfg, pack4), _port_serve(d, tcfg, pack4)
    man = backend_manifest(model, tapi.resolved_policy(tcfg),
                           override=backend)
    assert man and {m["backend"] for m in man.values()} == {backend}
    toks = tokens(jcfg, B, P, seed=11)
    want_logits, want = jax_reference(jcfg, js, toks, STEPS)
    got = tserving.generate(model, tcfg, {"tokens": torch.from_numpy(toks)},
                            steps=STEPS, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    with torch.inference_mode():
        logits = port_teacher_forced(tcfg, model, toks, want)
    for i, (g, w) in enumerate(zip(logits, want_logits)):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=f"step {i}")


@pytest.mark.parametrize("who", ["reference", "port"])
def test_checkpoint_serves_through_the_paged_engine(ckpts, who):
    """Each request of a ragged queue on 2 slots equals the reference's
    plain loop over that prompt alone."""
    d = ckpts[who]
    jcfg, tcfg = _serve_cfgs(d, "auto")
    js, model = _jax_serve(d, jcfg, True), _port_serve(d, tcfg, True)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, VOCAB, n).astype(np.int32) for n in (9, 14, 5)]
    gens = [5, 3, 6]
    eng = Engine(model, tcfg, capacity=2, max_len=24, kv_pages=12,
                 page_size=8, prefill_pack=False, device="cpu")
    for p, g in zip(prompts, gens):
        eng.submit(p, max_new=g)
    res = eng.run()
    assert [r["rid"] for r in res] == [0, 1, 2]
    for r, p, g in zip(res, prompts, gens):
        _, want = jax_reference(jcfg, js, p[None], g)
        np.testing.assert_array_equal(r["tokens"], want[0],
                                      err_msg=f"request {r['rid']}")


def test_from_train_params_materialises_no_master(ckpts):
    d = ckpts["reference"]
    _, tcfg = _serve_cfgs(d, "auto")
    params, _ = tckpt.restore_params(d)
    for pack4 in (False, True):
        model = interop.from_train_params(
            params, tcfg, pack4=pack4, policy=tapi.resolved_policy(tcfg),
            device="cpu")
        kernels = [m for m in model.modules() if isinstance(m, QuantKernel)]
        assert kernels and all(m.w.is_meta for m in kernels)
        assert all(not t.is_meta for n, t in model.named_parameters()
                   if not n.endswith(".w"))
        assert all(not t.is_meta for t in model.buffers())
        assert {m.a.dtype for m in kernels} == {
            torch.uint8 if pack4 else torch.int8}
        sv = serve_view(model, pack4=pack4,
                        policy=tapi.resolved_policy(tcfg))
        states = [x for _, x in tree_paths(sv) if isinstance(x, LutqState)]
        assert all(x.w is None for x in states)
        # the loaded leaves are the checkpoint's, bit for bit
        static = params["static"]["layers"]["mlp"]["wi"]["kernel"]
        for i in range(tcfg.n_layers):
            leaf = model.layers[i].mlp.wi.kernel
            a = unpack4_kin(leaf.a) if pack4 else leaf.a
            np.testing.assert_array_equal(a.numpy(), static["__lutq_a"][i])
            np.testing.assert_array_equal(leaf.d.numpy(),
                                          static["__lutq_d"][i])


def _serve(capsys, *flags):
    rc = t_serve_cli.main(["--arch", ARCH, "--reduced", "--batch", "2",
                           "--prompt-len", "8", "--gen", "3", "--device",
                           "cpu", *flags])
    assert rc == 0
    return capsys.readouterr().out


def test_serve_cli_restores_train_ckpt(ckpts, capsys):
    for who, d in ckpts.items():
        out = _serve(capsys, "--vocab", str(VOCAB), "--ckpt-dir", d)
        assert (f"restored train checkpoint step 6 from {d} (policy from "
                "manifest)") in out, who
        assert "4-bit/pow2 (K=16, min_size=4096)" in out, who
    out = _serve(capsys, "--vocab", str(VOCAB), "--ckpt-dir", ckpts["port"],
                 "--engine", "--kv-pages", "16", "--page-size", "8",
                 "--max-batch", "2", "--queue", "3")
    assert "restored train checkpoint step 6" in out
    assert "3/3 requests" in out


def _breakdown_bits(out):
    rows = [ln.split() for ln in out.splitlines() if ln.startswith("all ")]
    assert len(rows) == 1, out
    return rows[0][3]


def test_manifest_policy_supersedes_quant_flags(tmp_path, capsys):
    d = str(tmp_path / "u3")
    assert t_train_cli.main(TRAIN + ["--steps", "2", "--quant-policy",
                                     "uniform:3", "--ckpt-dir", d,
                                     "--device", "cpu"]) == 0
    capsys.readouterr()
    out = _serve(capsys, "--vocab", str(VOCAB), "--ckpt-dir", d,
                 "--quant-bits", "4")
    assert "3-bit/none" in out and _breakdown_bits(out) == "3"
    out = _serve(capsys, "--vocab", str(VOCAB), "--quant-bits", "4")
    assert _breakdown_bits(out) == "4"


def test_serving_pow2_checkpoint_serves_pow2_planes(tmp_path, capsys):
    d = str(tmp_path / "pow2")
    assert t_train_cli.main(TRAIN + ["--steps", "2", "--quant-policy",
                                     "serving_pow2", "--ckpt-dir", d,
                                     "--device", "cpu"]) == 0
    capsys.readouterr()
    out = _serve(capsys, "--vocab", str(VOCAB), "--ckpt-dir", d)
    assert "pow2-encoded leaves: 10 of 10" in out
    tcfg = cfg_pair(vocab=VOCAB)[1].replace(quant=tckpt.load_policy(d))
    pol = tapi.resolved_policy(tcfg)
    params, _ = tckpt.restore_params(d)
    sv, man = serve_view(interop.from_train_params(params, tcfg, policy=pol,
                                                   device="cpu"),
                         policy=pol, with_manifest=True)
    assert len(man) == 5 and all(m["encoding"] == "pow2" and
                                 m["backend"] == "pow2"
                                 for m in man.values())


def test_serve_cli_rejects_mismatched_ckpt(ckpts):
    for d in ckpts.values():
        with pytest.raises(SystemExit, match="does not fit the serve config"):
            t_serve_cli.main(["--arch", ARCH, "--reduced", "--vocab", "96",
                              "--batch", "2", "--prompt-len", "8", "--gen",
                              "2", "--device", "cpu", "--ckpt-dir", d])


def test_check_ckpt_shapes_names_the_mismatch(ckpts):
    _, tcfg = _serve_cfgs(ckpts["port"], "auto")
    params, _ = tckpt.restore_params(ckpts["port"])
    t_serve_cli.check_ckpt_shapes(tcfg, params["trainable"])
    for cfg, words in (
            (tcfg.replace(vocab=96), r"embed/table: model \(96"),
            (tcfg.replace(n_layers=3), r"9 mismatched.*model \(3, 64, 16\)")):
        with pytest.raises(SystemExit, match=words):
            t_serve_cli.check_ckpt_shapes(cfg, params["trainable"])
    trainable = dict(params["trainable"])
    del trainable["final_norm"]
    with pytest.raises(SystemExit, match="missing from checkpoint"):
        t_serve_cli.check_ckpt_shapes(tcfg, trainable)


def test_draft_view_roundtrip_ckpt_and_manifest(tmp_path):
    """The draft view of reduced danube's serve model survives a
    checkpoint save and restore (the port's and the reference's) bit
    for bit, and the manifest gives each coarse leaf a backend."""
    jcfg, tcfg = cfg_pair(act_bits=32)
    pol = tapi.resolved_policy(tcfg)
    model = serve_view(interop.from_jax(to_np(jax_quantized(jcfg)), tcfg),
                       policy=pol)
    draft, report = draft_view(model, draft_bits=3, with_report=True)
    assert report and not any(r["shared"] for r in report.values())
    tckpt.save(interop.to_numpy(draft), str(tmp_path), step=0)
    orig = dict(tree_paths(draft))
    for restore in (tckpt.restore, jckpt.restore):
        back, step = restore(str(tmp_path))
        assert step == 0
        back = interop.from_jax(jax.tree.map(np.asarray, back), tcfg)
        n = 0
        for path, leaf in tree_paths(back):
            if isinstance(leaf, LutqState):
                n += 1
                assert leaf.w is None and leaf.a.dtype == orig[path].a.dtype
                assert torch.equal(leaf.d, orig[path].d), path
                assert torch.equal(leaf.a, orig[path].a), path
        assert n == 7 * tcfg.n_layers + 2
        man = backend_manifest(back, pol)
        assert len(man) == 9 and all(m["backend"] for m in man.values())
        assert man == backend_manifest(draft, pol)
        assert sum(m["backend"] == "packed4" for m in man.values()) == 8


def test_train_e2e_tiny_on_cpu(tmp_path, capsys):
    d = tmp_path / "e2e"
    assert train_e2e.main(["--tiny", "--device", "cpu", "--steps", "10",
                           "--ckpt-dir", str(d)]) == 0
    out = capsys.readouterr().out
    ce = [ln for ln in out.splitlines() if "byte-level CE" in ln]
    first, last = (float(x) for x in ce[0].split()[3:6:2])
    assert last < first
    assert tckpt.latest_step(str(d)) == 10
    assert Path(d, "step_00000010", "manifest.json").exists()
