"""Port parity, the text data path: ``repro_torch.data.text`` gives the
reference's byte corpus and batches bit for bit (the repo's own tree, a
tree with unreadable and oversized files, several steps, seeds and host
splits), and ``repro_torch.data.loader.Prefetcher`` keeps the step order
at any depth and hands a failing ``make_batch``'s exception to the
consumer instead of hanging."""
import concurrent.futures
import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from repro.data import text as jtext
from repro_torch.data import text as ttext
from repro_torch.data.loader import Prefetcher

ROOT = Path(__file__).resolve().parent.parent


def _equal(a, b):
    assert a.dtype == b.dtype == np.int32 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_default_corpus_of_the_repo_equals_reference():
    _equal(ttext.default_corpus(str(ROOT)), jtext.default_corpus(str(ROOT)))


@pytest.fixture
def tree(tmp_path):
    """Files of every kind the walk meets: kept suffixes, other suffixes,
    a dot directory, an unreadable file (a dangling link) and files past
    a small max_bytes."""
    (tmp_path / "b").mkdir()
    (tmp_path / ".hidden").mkdir()
    (tmp_path / "a.py").write_bytes(b"print('a')\n" * 7)
    (tmp_path / "b" / "z.md").write_bytes(bytes(range(256)) * 3)
    (tmp_path / "b" / "y.toml").write_bytes(b"[x]\ny = 1\n")
    (tmp_path / "c.txt").write_bytes(b"\x00\xff" * 50)
    (tmp_path / "skip.json").write_bytes(b"{}")
    (tmp_path / ".hidden" / "h.py").write_bytes(b"hidden")
    os.symlink(tmp_path / "gone.py", tmp_path / "dangling.py")
    return tmp_path


def test_default_corpus_of_a_tree_equals_reference(tree):
    got = ttext.default_corpus(str(tree))
    _equal(got, jtext.default_corpus(str(tree)))
    assert b"hidden" not in got.astype(np.uint8).tobytes()


@pytest.mark.parametrize("max_bytes", [1, 50, 77, 900, 8 << 20])
def test_load_corpus_cut_equals_reference(tree, max_bytes):
    paths = [str(p) for p in tree.rglob("*") if p.suffix]
    _equal(ttext.load_corpus(paths, max_bytes=max_bytes),
           jtext.load_corpus(paths, max_bytes=max_bytes))


def test_empty_corpus_raises(tmp_path):
    (tmp_path / "empty.py").write_bytes(b"")
    for mod in (ttext, jtext):
        with pytest.raises(ValueError, match="empty corpus"):
            mod.load_corpus([str(tmp_path / "empty.py"),
                             str(tmp_path / "missing.py")])
        with pytest.raises(ValueError, match="empty corpus"):
            mod.default_corpus(str(tmp_path / "nothing"))


@pytest.mark.parametrize("step,seed,hosts", [
    (0, 0, 1), (1, 1, 1), (7, 1, 2), (300, 3, 4), (12345, 0, 1)])
def test_byte_batch_equals_reference(step, seed, hosts):
    corpus = jtext.default_corpus(str(ROOT))
    for host in range(hosts):
        kw = dict(host_id=host, num_hosts=hosts, seed=seed)
        got = ttext.byte_batch(corpus, step, 8, 33, **kw)
        want = jtext.byte_batch(corpus, step, 8, 33, **kw)
        assert set(got) == {"tokens", "labels"}
        for k in got:
            _equal(got[k], want[k])
        np.testing.assert_array_equal(got["tokens"][:, 1:],
                                      got["labels"][:, :-1])


def _batch(step):
    return {"tokens": np.full((2, 3), step, np.int32)}


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetcher_order_from_a_start_step(depth):
    pf = Prefetcher(_batch, start_step=5, depth=depth)
    try:
        for want in range(5, 17):
            step, batch = next(pf)
            assert step == want
            np.testing.assert_array_equal(batch["tokens"], _batch(want)[
                "tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_raises_what_make_batch_raised():
    def make(step):
        if step == 3:
            raise KeyError("no batch 3")
        time.sleep(0.01)
        return _batch(step)

    pf = Prefetcher(make, start_step=1, depth=2)

    def consume():
        seen = []
        with pytest.raises(KeyError, match="no batch 3"):
            while True:
                seen.append(next(pf)[0])
        return seen

    # a daemon thread feeds the future: if next() hung, result() times
    # out and the test fails without keeping the process alive
    fut = concurrent.futures.Future()

    def run():
        try:
            fut.set_result(consume())
        except BaseException as e:
            fut.set_exception(e)

    threading.Thread(target=run, daemon=True).start()
    assert fut.result(timeout=10) == [1, 2]
    pf.close()
    assert not pf._thread.is_alive()
