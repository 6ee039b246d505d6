"""Port parity, the training slice: reduced h2o-danube-1.8b trained
3 steps by the JAX package and by the port from the same converted
state on the same MarkovLM batches; checkpoints that each package
restores from the other; TrainLoop's auto-resume; the training CLI.

Tolerances (float32 on both sides): per-step loss and grad-norm 1e-5
relative; masters 1e-5 of each leaf's largest magnitude; dictionaries
1e-6; assignments equal except for weights within 1e-6 of a midpoint,
where summation order may tip the nearest entry (the test counts them).
The parity runs keep activations in float32: with 8-bit activations a
one-ulp difference in a matmul can move a value across a rounding
boundary of the activation grid, which moves the loss by ~1e-5.
"""
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import cfg_pair, jax_quantized, one_thread, to_np

from repro.checkpoint import ckpt as jckpt
from repro.data.synthetic import MarkovLM
from repro.models import api as japi
from repro.optim import optimizers as jopt
from repro.optim.train_state import init_train_state as j_init_state
from repro.optim.train_state import make_train_step as j_make_step
from repro.optim.train_state import state_flat
from repro_torch import interop
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.kernels import kmeans_stats as tks
from repro_torch.launch import train as t_train_cli
from repro_torch.models import api as tapi
from repro_torch.nn.tree import QuantKernel
from repro_torch.optim import optimizers as topt
from repro_torch.optim.train_state import init_train_state as t_init_state
from repro_torch.optim.train_state import make_train_step as t_make_step
from repro_torch.runtime.loop import TrainLoop

STEPS, B, S = 3, 4, 16
LR = dict(peak=1e-3, warmup=1, total=STEPS)


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jq():
    """(JAX config, port config, JAX quantized reduced danube): the
    CLI's 4-bit pow2 spec, float32 activations (see the module doc)."""
    jcfg, tcfg = cfg_pair(constraint="pow2", act_bits=32)
    return jcfg, tcfg, jax_quantized(jcfg)


def _batch(step):
    return MarkovLM(211, seed=0).batch(0, step, B, S)


@pytest.fixture(scope="module")
def jax_run(jq):
    """_jax_run with its results kept for the module (each variant
    compiles its own train step)."""
    runs = {}

    def get(impl, microbatches):
        if (impl, microbatches) not in runs:
            runs[impl, microbatches] = _jax_run(jq, impl, microbatches)
        return runs[impl, microbatches]
    return get


def _jax_run(jq, impl, microbatches):
    jcfg, _, params = jq
    opt = jopt.adamw(jopt.cosine_schedule(**LR))
    state = state_flat(j_init_state(params, opt))
    step = jax.jit(j_make_step(jcfg, japi.loss_fn, opt,
                               microbatches=microbatches, kmeans_impl=impl))
    hist = []
    for s in range(STEPS):
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in _batch(s).items()})
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    return to_np(state), hist


def _port_state(jq):
    _, tcfg, params = jq
    opt = topt.adamw(topt.cosine_schedule(**LR))
    return t_init_state(interop.from_jax(to_np(params), tcfg), opt), opt


def _port_run(jq, impl, microbatches):
    tcfg = jq[1]
    state, opt = _port_state(jq)
    step = t_make_step(tcfg, tapi.loss_fn, opt, microbatches=microbatches,
                       kmeans_impl=impl)
    hist = []
    for s in range(STEPS):
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in _batch(s).items()})
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    return state, hist


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _near_midpoint(w, d, tol=1e-6):
    mid = (d[:-1] + d[1:]) * np.float32(0.5)
    return np.abs(w.reshape(-1)[:, None] - mid[None, :]).min(1) <= tol


@pytest.mark.parametrize("impl,microbatches", [(None, 1), ("stats", 1),
                                               (None, 2)])
def test_three_train_steps_match_reference(jq, jax_run, impl, microbatches):
    jtree, jhist = jax_run(impl, microbatches)
    plain = tks.COUNTS["plain"]
    state, thist = _port_run(jq, impl, microbatches)
    n_leaves = sum(isinstance(m, QuantKernel) for m in state.model.modules())
    want_plain = (STEPS * 2 * n_leaves) if impl == "stats" else 0
    assert tks.COUNTS["plain"] - plain == want_plain  # kmeans_iters = 1
    np.testing.assert_allclose(np.array(thist), np.array(jhist), rtol=1e-5)
    ttree = interop.train_state_to_numpy(state)
    jl, tl = dict(_leaves(jtree)), dict(_leaves(ttree))
    assert sorted(jl) == sorted(tl)
    assert int(tl[("step",)]) == STEPS
    near = 0
    for k, x in jl.items():
        y = tl[k]
        if x is None:
            assert y is None, k
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, k
        if k[-1] == "__lutq_a":
            w = jl[("trainable",) + k[1:-1]]
            d = jl[k[:-1] + ("__lutq_d",)]
            for i in range(x.shape[0] if x.ndim == 3 else 1):
                xa, ya = (x[i], y[i]) if x.ndim == 3 else (x, y)
                wi, di = (w[i], d[i]) if x.ndim == 3 else (w, d)
                diff = (xa != ya).reshape(-1)
                assert _near_midpoint(wi[diff.reshape(wi.shape)], di).all(), k
                near += int(diff.sum())
        elif k[-1] == "__lutq_d":
            np.testing.assert_allclose(y, x, rtol=1e-6, atol=1e-6,
                                       err_msg=str(k))
        elif k[0] == "trainable":
            np.testing.assert_allclose(y, x, rtol=0,
                                       atol=1e-5 * np.abs(x).max(),
                                       err_msg=str(k))
        elif k[0] == "static":
            np.testing.assert_array_equal(y, x, err_msg=str(k))
    print(f"assignments that differ, all within 1e-6 of a midpoint: {near}")


@pytest.fixture(scope="module")
def jax_trained(jax_run):
    """A JAX train state after the 3 steps (nonzero moments)."""
    return jax_run(None, 1)[0]


def _assert_trees_bit_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert sorted(la) == sorted(lb)
    for k in la:
        if la[k] is None or lb[k] is None:
            assert la[k] is None and lb[k] is None, k
            continue
        x, y = np.asarray(la[k]), np.asarray(lb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x.reshape(-1).view(np.uint8),
                                      y.reshape(-1).view(np.uint8),
                                      err_msg=str(k))


def test_checkpoints_cross_between_packages(jq, jax_trained, tmp_path):
    jcfg, tcfg, _ = jq
    jpol, tpol = japi.resolved_policy(jcfg), tapi.resolved_policy(tcfg)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jckpt.save(jax_trained, str(jdir), STEPS, policy=jpol)

    # JAX checkpoint -> port
    state, _ = _port_state(jq)
    tree, step = tckpt.restore(str(jdir))
    assert step == STEPS and tckpt.latest_step(str(jdir)) == STEPS
    interop.load_train_state(state, tree)
    assert state.step == STEPS
    _assert_trees_bit_equal(interop.train_state_to_numpy(state), jax_trained)
    assert (tckpt.load_policy(str(jdir)).to_json_dict()
            == jpol.to_json_dict())

    # port checkpoint -> JAX
    tckpt.save(state, str(tdir), STEPS, policy=tpol)
    back, jstep = jckpt.restore(str(tdir))
    assert jstep == STEPS
    _assert_trees_bit_equal(to_np(back), jax_trained)
    assert (jckpt.load_policy(str(tdir)).to_json_dict()
            == jpol.to_json_dict())
    keys = [[e["key"] for e in json.loads(
        (d / f"step_{STEPS:08d}" / "manifest.json").read_text())["leaves"]]
        for d in (jdir, tdir)]
    assert keys[0] == keys[1]


def test_trainloop_resumes_at_the_same_step_and_batch(jq, tmp_path):
    tcfg = jq[1]

    def run(num_steps, ckpt_dir):
        state, opt = _port_state(jq)
        step = t_make_step(tcfg, tapi.loss_fn, opt)
        seen = []

        def make_batch(s):
            seen.append(s)
            return {k: torch.from_numpy(v) for k, v in _batch(s).items()}

        loop = TrainLoop(step, make_batch, ckpt_dir=ckpt_dir, ckpt_every=2,
                         log_every=100, log_fn=lambda m: None,
                         quant_policy=tapi.resolved_policy(tcfg))
        state, end = loop.run(state, num_steps, handle_signals=False)
        return state, end, seen, loop.history

    straight, _, _, hist = run(4, None)
    ck = str(tmp_path / "ck")
    _, end, seen, _ = run(2, ck)
    assert (end, seen) == (2, [0, 1])
    resumed, end, seen, hist2 = run(4, ck)
    assert (end, seen) == (4, [2, 3])
    assert [h["step"] for h in hist2] == [2, 3]
    assert [h["loss"] for h in hist2] == [h["loss"] for h in hist[2:]]
    _assert_trees_bit_equal(interop.train_state_to_numpy(resumed),
                            interop.train_state_to_numpy(straight))


def test_training_after_serving_in_one_process(jq):
    """Tables cached while serving (under inference mode) must not break
    a later training step in the same process."""
    from repro_torch.nn import rotary

    tcfg = jq[1]
    state, opt = _port_state(jq)
    rotary._rope_tables_on.cache_clear()
    toks = torch.from_numpy(_batch(0)["tokens"])
    with torch.inference_mode():
        tapi.prefill(state.model, tcfg, {"tokens": toks})
    step = t_make_step(tcfg, tapi.loss_fn, opt)
    _, m = step(state, {k: torch.from_numpy(v)
                        for k, v in _batch(0).items()})
    assert np.isfinite(float(m["loss"]))


def test_cli_trains_on_cpu(capsys):
    assert t_train_cli.main(["--arch", "h2o-danube-1.8b", "--reduced",
                             "--steps", "3", "--batch", "2", "--seq", "16",
                             "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    m = re.search(r"loss (\d+\.\d+) -> (\d+\.\d+) .* in 3 steps", out)
    assert m and all(np.isfinite(float(x)) for x in m.groups()), out
    assert "kmeans_stats launches 0" in out


def test_cli_without_device_cpu_raises_here():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is valid here")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        t_train_cli.main(["--arch", "h2o-danube-1.8b", "--reduced",
                          "--steps", "1"])


@pytest.mark.parametrize("flags", [["--mesh", "2x4"],
                                   ["--grad-compress", "ef"],
                                   ["--autotune", "cache"]])
def test_cli_refuses_unported_options(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        t_train_cli.main(["--arch", "h2o-danube-1.8b", "--reduced",
                          "--steps", "1", "--device", "cpu"] + flags)
