"""The port's CkIO host runtime against the reference's: the same token
file read on the thread backend with the same readers and consumers gives
the same bytes, splinter plan and copy counts."""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.data import make_token_file  # noqa: E402

HEADER = 4096


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckio") / "tokens.bin")
    make_token_file(path, 40_000, vocab_size=200064, seed=5)
    return path, np.fromfile(path, dtype=np.uint8)


def _drain(core, path, nbytes, num_readers, splinter_bytes, consumers):
    ck = core.CkIO(num_pes=2, pes_per_node=2)
    f = ck.open_sync(path, core.FileOptions(num_readers=num_readers,
                                            splinter_bytes=splinter_bytes))
    sess = ck.start_read_session_sync(f, nbytes, HEADER)
    clients = [ck.make_client(pe=i % 2) for i in range(consumers)]
    per = nbytes // consumers
    copied = []
    for i, c in enumerate(clients):
        off = HEADER + i * per
        take = nbytes - i * per if i == consumers - 1 else per
        copied.append(bytes(ck.read_sync(sess, take, off, client=c)))
    view = bytes(ck.read_view_sync(sess, nbytes, HEADER))
    plan = [(s.index, s.offset, s.nbytes) for s in sess.plan.splinters]
    m = sess.metrics.summary()
    ck.close_read_session_sync(sess)
    ck.close_sync(f)
    return b"".join(copied), view, plan, m


@pytest.mark.parametrize("num_readers,splinter_bytes,consumers", [
    (1, 8 * 1024 * 1024, 1), (3, 16 * 1024, 4), (4, 4096, 7)])
def test_same_bytes_plan_and_counts(corpus, num_readers, splinter_bytes,
                                    consumers):
    path, raw = corpus
    nbytes = 40_000 * 4
    got = {name: _drain(core, path, nbytes, num_readers, splinter_bytes,
                        consumers)
           for name, core in (("jax", jcore), ("port", tcore))}
    want = raw[HEADER:HEADER + nbytes].tobytes()
    for name, (copied, view, _, _) in got.items():
        assert copied == want, name
        assert view == want, name
    assert got["jax"][2] == got["port"][2]               # splinter plan
    for key in ("session_bytes", "num_readers", "bytes_read", "read_calls",
                "bytes_served", "bytes_copied", "pieces_served", "requests"):
        assert got["jax"][3][key] == got["port"][3][key], key
    assert got["port"][3]["bytes_copied"] == nbytes      # read() copies
