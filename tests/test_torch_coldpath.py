"""The port's cold-path read engine against the reference's: stripe plans
with hard bounds, the submitters (depth ceiling, drain, backend selection,
retries, short reads, direct tails), the O_DIRECT alignment errors and the
three online tuners. The same seeded inputs go to both packages; plans,
bytes, counters and tuner decisions are compared exactly (no tolerance:
these are integers and bytes)."""
import dataclasses
import hashlib
import os

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core.autotune as jtune  # noqa: E402
import repro.core.faults as jfaults  # noqa: E402
import repro.core.metrics as jmetrics  # noqa: E402
import repro.io.layout as jlayout  # noqa: E402
import repro.io.posix as jposix  # noqa: E402
import repro.io.submit as jsubmit  # noqa: E402
import repro_torch.core.autotune as ttune  # noqa: E402
import repro_torch.core.faults as tfaults  # noqa: E402
import repro_torch.core.metrics as tmetrics  # noqa: E402
import repro_torch.io.layout as tlayout  # noqa: E402
import repro_torch.io.posix as tposix  # noqa: E402
import repro_torch.io.submit as tsubmit  # noqa: E402
from repro_torch.core.api import CkIO  # noqa: E402
from repro_torch.core.session import FileOptions  # noqa: E402

SEED = 20260809
PKGS = {"ref": (jposix, jsubmit, jfaults), "port": (tposix, tsubmit, tfaults)}


@pytest.fixture
def blob(tmp_path):
    rng = np.random.default_rng(SEED)
    # Not a block multiple: the last read's tail is shorter than a block.
    data = rng.integers(0, 256, 2 * 1024 * 1024 + 777,
                        dtype=np.uint8).tobytes()
    path = str(tmp_path / "blob.bin")
    with open(path, "wb") as f:
        f.write(data)
    return path, data


def _plain(plan):
    """A StripePlan as plain tuples (the two packages' classes differ)."""
    d = dataclasses.asdict(plan)
    d["splinters"] = tuple(tuple(sorted(s.items())) for s in d["splinters"])
    return d


# -- stripe plans with hard bounds ---------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_plan_session_hard_bounds_match_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        align = int(rng.choice([512, 4096]))
        nseg = int(rng.integers(1, 5))
        seg = [int(rng.integers(1, 40)) * align for _ in range(nseg)]
        seg[-1] += int(rng.integers(0, align))          # odd-sized last shard
        starts = np.cumsum([0] + seg)
        offset = int(rng.integers(0, 3)) * align
        nbytes = int(starts[-1]) - offset
        bounds = [int(g) for g in starts[1:-1]]
        readers = int(rng.integers(nseg, nseg + 6))
        sb = int(rng.choice([align, 3 * align, 8 * align + 7]))
        per = ([int(rng.integers(1, 9)) * align for _ in range(readers)]
               if rng.random() < 0.5 else None)
        kw = dict(splinter_bytes=sb, align=align, hard_bounds=bounds,
                  reader_splinter_bytes=per)
        tp = tlayout.plan_session(offset, nbytes, readers, **kw)
        jp = jlayout.plan_session(offset, nbytes, readers, **kw)
        assert _plain(tp) == _plain(jp)
        inside = [g for g in bounds if offset < g < offset + nbytes]
        assert tp.hard_bounds == (tuple(inside) or None)
        for s, e in tp.stripe_bounds:
            assert not any(s < g < e for g in inside)
        for sp in tp.splinters:
            assert not any(sp.offset < g < sp.end for g in inside)
        assert sum(sp.nbytes for sp in tp.splinters) == nbytes


def test_too_few_readers_for_segments_raise_as_reference():
    errs = []
    for mod in (jlayout, tlayout):
        with pytest.raises(ValueError) as e:
            mod.plan_session(0, 3 * 4096, 2, splinter_bytes=4096,
                             hard_bounds=[4096, 8192])
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "hard segments" in errs[1]


def test_sharded_file_bounds_and_shard_of_match_reference(tmp_path):
    paths = []
    for i, n in enumerate((8192, 4096, 5000)):
        paths.append(str(tmp_path / f"s{i}.bin"))
        with open(paths[-1], "wb") as f:
            f.write(bytes([i]) * n)
    segs = [(paths[0], 0, 0, 8192, 0), (paths[1], 8192, 0, 4096, 2),
            (paths[2], 12288, 0, 5000, 3)]
    jf, tf = jposix.ShardedFile(segs), tposix.ShardedFile(segs)
    try:
        for off, n in ((0, 17288), (100, 8092), (8192, 4096), (9000, 5000),
                       (0, 8192), (12287, 2)):
            assert tf.bounds_in(off, n) == jf.bounds_in(off, n)
        for off in (0, 8191, 8192, 12287, 12288, 17287, 17288, 99999):
            assert tf.shard_of(off) == jf.shard_of(off)
    finally:
        jf.close()
        tf.close()


# -- submitters ------------------------------------------------------------------
def _items(data_len, chunk, arena):
    out, pos, i = [], 0, 0
    while pos < data_len:
        n = min(chunk, data_len - pos)
        out.append((i, pos, memoryview(arena)[pos: pos + n]))
        pos += n
        i += 1
    return out


class _Sink:
    """Stats sink counting what both packages' submitters report."""

    def __init__(self):
        self.retries = self.tails = self.tail_bytes = self.suppressed = 0

    def record_io_retry(self, err=None):
        self.retries += 1

    def record_direct_tail(self, n=0):
        self.tails += 1
        self.tail_bytes += n

    def record_suppressed(self, err=None):
        self.suppressed += 1


def _drain(pkg, path, data, *, depth, mode, chunk, fault=None,
           direct=False, stop=None):
    posix, submit, _ = PKGS[pkg]
    f = posix.PosixFile.open(path, direct_io=direct)
    try:
        bs = f.block_size
        raw = np.empty(len(data) + bs, dtype=np.uint8)
        skew = (-raw.ctypes.data) % bs
        arena = raw[skew: skew + len(data)]
        sink = _Sink()
        eng = submit.AsyncReadEngine(f, depth, mode=mode, stats=sink,
                                     fault=fault)
        items = iter(_items(len(data), chunk, arena))
        got = {}
        live = []

        def on_complete(token, n, dt):
            got[token] = n
            live.append(eng.sub.inflight())

        done = eng.run(lambda: next(items, None), on_complete, stop=stop)
        return dict(bytes=arena.tobytes(), done=done, got=got,
                    hwm=eng.max_inflight, live_max=max(live, default=0),
                    left=eng.sub.inflight(), kind=eng.kind,
                    retries=sink.retries, tails=sink.tails,
                    tail_bytes=sink.tail_bytes)
    finally:
        f.close()


@pytest.mark.parametrize("mode", ["threads", "auto"])
def test_depth_is_a_hard_ceiling_as_reference(blob, mode):
    path, data = blob
    out = {pkg: _drain(pkg, path, data, depth=4, mode=mode, chunk=128 << 10)
           for pkg in PKGS}
    for r in out.values():
        assert r["bytes"] == data
        assert r["done"] == len(r["got"]) == -(-len(data) // (128 << 10))
        assert 1 <= r["hwm"] <= 4 and r["live_max"] <= 4 and r["left"] == 0
    assert out["port"]["got"] == out["ref"]["got"]
    assert out["port"]["kind"] == out["ref"]["kind"]
    # The engine fills to depth before it first waits.
    assert out["port"]["hwm"] == out["ref"]["hwm"] == 4


def test_depth_violation_and_drain_on_close_as_reference(blob):
    path, _ = blob
    msgs = []
    for pkg in PKGS:
        posix, submit, _ = PKGS[pkg]
        f = posix.PosixFile.open(path)
        arena = np.empty(3 * 4096, dtype=np.uint8)
        sub = submit.ThreadPoolSubmitter(f, 2)
        try:
            sub.submit(0, 0, memoryview(arena)[0:4096])
            sub.submit(1, 4096, memoryview(arena)[4096:8192])
            assert not sub.can_submit()
            with pytest.raises(RuntimeError) as e:
                sub.submit(2, 8192, memoryview(arena)[8192:12288])
            msgs.append(str(e.value))
        finally:
            sub.close(drain=True)
            f.close()
        assert sub.inflight() == 0 and sub.max_inflight == 2
    assert msgs[0] == msgs[1] and "depth" in msgs[1]


def test_stop_drains_inflight_as_reference(blob):
    path, data = blob
    for pkg in PKGS:
        r = _drain(pkg, path, data, depth=4, mode="threads", chunk=64 << 10,
                   stop=lambda: True)
        assert r["done"] == 0 and r["left"] == 0


def test_backend_selection_matches_reference(blob, tmp_path, monkeypatch):
    path, data = blob
    half = len(data) // 2
    p2 = str(tmp_path / "s2.bin")
    with open(p2, "wb") as fh:
        fh.write(data[half:])
    segs = [(path, 0, 0, half, 0), (p2, half, 0, len(data) - half, 1)]
    assert tsubmit.io_uring_supported() == jsubmit.io_uring_supported()
    for pkg in PKGS:
        posix, submit, _ = PKGS[pkg]
        f = posix.PosixFile.open(path)
        sf = posix.ShardedFile(segs)
        try:
            kinds = []
            for fl, kw in ((f, {}), (f, dict(delay=lambda t, n: None)),
                           (sf, {})):
                sub = submit.make_submitter(fl, 2, mode="auto", **kw)
                kinds.append(sub.kind)
                sub.close()
            ring = "io_uring" if submit.io_uring_supported() else "threads"
            assert kinds == [ring, "threads", "threads"]
            with pytest.raises(ValueError, match="delay"):
                submit.make_submitter(f, 2, mode="io_uring",
                                      delay=lambda t, n: None)
            with pytest.raises(ValueError, match="[Ss]harded"):
                submit.make_submitter(sf, 2, mode="io_uring")
            with pytest.raises(ValueError, match="submit mode"):
                submit.make_submitter(f, 2, mode="sidecar")
            monkeypatch.setenv("CKIO_NO_IOURING", "1")
            assert not submit.io_uring_supported()
            sub = submit.make_submitter(f, 2, mode="auto")
            assert sub.kind == "threads"
            sub.close()
            with pytest.raises(ValueError, match="io_uring"):
                submit.make_submitter(f, 2, mode="io_uring")
            monkeypatch.delenv("CKIO_NO_IOURING")
        finally:
            f.close()
            sf.close()


# One worker thread (threads at depth 1) or the single-threaded ring keeps
# the count-based fault hooks' call order, and so the counters, fixed.
FAULT_MODES = [("threads", 1), ("auto", 4)]


def _same_counters(out, key):
    if out["port"]["kind"] == "io_uring" or out["port"]["hwm"] == 1:
        assert out["port"][key] == out["ref"][key] > 0
    else:                        # a pool of 4: the hooks' call order varies
        assert out["port"][key] > 0 and out["ref"][key] > 0


@pytest.mark.parametrize("mode,depth", FAULT_MODES)
def test_flaky_eio_retried_as_reference(blob, mode, depth):
    path, data = blob
    out = {pkg: _drain(pkg, path, data, depth=depth, mode=mode,
                       chunk=128 << 10,
                       fault=PKGS[pkg][2].FlakyEIO(every=5))
           for pkg in PKGS}
    assert out["port"]["bytes"] == out["ref"]["bytes"] == data
    _same_counters(out, "retries")
    assert out["port"]["kind"] == out["ref"]["kind"]
    assert out["port"]["hwm"] == out["ref"]["hwm"] == depth


@pytest.mark.parametrize("mode,depth", FAULT_MODES)
def test_short_reads_resumed_as_reference(blob, mode, depth):
    path, data = blob

    def fault(pkg):
        f = PKGS[pkg][2]
        return f.ComposedIOFault((f.ShortRead(every=2, max_bytes=16 << 10),
                                  f.FlakyEIO(every=9)))
    out = {pkg: _drain(pkg, path, data, depth=depth, mode=mode,
                       chunk=128 << 10, fault=fault(pkg))
           for pkg in PKGS}
    assert out["port"]["bytes"] == out["ref"]["bytes"] == data
    _same_counters(out, "retries")
    assert out["port"]["got"] == out["ref"]["got"]
    assert out["port"]["hwm"] == out["ref"]["hwm"] == depth


@pytest.mark.parametrize("mode", ["threads", "auto"])
def test_direct_tail_shorter_than_a_block_as_reference(blob, mode):
    path, data = blob
    out = {}
    for pkg in PKGS:
        posix = PKGS[pkg][0]
        if not posix.supports_direct_io(path):
            pytest.skip("the filesystem under the test's tmp dir refuses "
                        "O_DIRECT")
        out[pkg] = _drain(pkg, path, data, depth=1 if mode == "threads"
                          else 4, mode=mode, chunk=256 << 10, direct=True)
    bs = tposix.fs_block_size(path)
    assert len(data) % bs
    assert out["port"]["bytes"] == out["ref"]["bytes"] == data
    assert out["port"]["tails"] == out["ref"]["tails"] >= 1
    assert out["port"]["tail_bytes"] == out["ref"]["tail_bytes"] == \
        len(data) % bs


# -- O_DIRECT alignment errors ---------------------------------------------------
def test_direct_misalignment_errors_match_reference(blob, tmp_path):
    path, data = blob
    if not tposix.supports_direct_io(path):
        pytest.skip("the filesystem under the test's tmp dir refuses O_DIRECT")
    bs = tposix.fs_block_size(path)
    raw = np.empty(bs * 2, dtype=np.uint8)
    skew = (-raw.ctypes.data) % bs
    aligned = raw[skew: skew + bs]
    odd_buf = raw[skew + 1: skew + 1 + bs]
    p2 = str(tmp_path / "shard2.bin")
    with open(p2, "wb") as fh:
        fh.write(data)
    cases = {
        "offset": lambda P: P.PosixFile.open(path, direct_io=True)
        .pread_into(1, memoryview(aligned)),
        "buffer": lambda P: P.PosixFile.open(path, direct_io=True)
        .pread_into(0, memoryview(odd_buf)),
        "file_base": lambda P: P.ShardedFile(
            [(path, 0, 100, len(data) - 100, 0)], direct_io=True),
        "global_start": lambda P: P.ShardedFile(
            [(path, 0, 0, bs + 1, 0), (p2, bs + 1, 0, bs, 1)],
            direct_io=True),
    }
    for what, make in cases.items():
        msgs = []
        for P in (jposix, tposix):
            with pytest.raises(P.DirectIOError) as e:
                make(P)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1] and what in msgs[1], what
    assert issubclass(tposix.DirectIOError, OSError)


def test_direct_session_off_the_grid_fails_at_start(blob):
    path, data = blob
    if not tposix.supports_direct_io(path):
        pytest.skip("the filesystem under the test's tmp dir refuses O_DIRECT")
    ck = CkIO(num_pes=2)
    fh = ck.open_sync(path, FileOptions(num_readers=1, splinter_bytes=32768,
                                        direct_io=True, queue_depth=4))
    with pytest.raises(tposix.DirectIOError, match="session offset 100"):
        ck.start_read_session_sync(fh, 65536, 100)
    ck.close_sync(fh)


def test_forced_io_uring_on_a_sharded_file_fails_at_start(blob, tmp_path):
    """The port checks the submit mode at session start, so a forced
    ``io_uring`` over a ``ShardedFile`` raises the reference's
    ``make_submitter`` error there (in the reference it raises inside a
    reader thread)."""
    path, data = blob
    from repro_torch.data.fileset import FileSet, write_token_shards

    arr = np.arange(3000, dtype=np.uint32)
    paths = write_token_shards(str(tmp_path / "fs"), arr, [1024, 1024, 952])
    ck = CkIO(num_pes=2)
    fh = ck.open_fileset_sync(FileSet.build(paths), FileOptions(
        num_readers=3, queue_depth=4, submit_mode="io_uring"))
    with pytest.raises(ValueError, match="sharded handles use 'threads'"):
        ck.start_read_session_sync(fh, 8192, 0)
    ck.close_sync(fh)


# -- whole sessions through the port's CkIO ---------------------------------------
@pytest.mark.parametrize("opts", [
    dict(),
    dict(queue_depth=4, submit_mode="threads", readahead_bytes=1 << 20),
    dict(queue_depth=4),
    dict(queue_depth=4, direct_io=True),
    dict(direct_io=True),
], ids=["blocking", "async_threads", "async_auto", "direct_async",
        "direct_blocking"])
def test_session_modes_read_the_file_exactly(blob, opts):
    path, data = blob
    if opts.get("direct_io") and not tposix.supports_direct_io(path):
        pytest.skip("the filesystem under the test's tmp dir refuses O_DIRECT")
    ck = CkIO(num_pes=2)
    fh = ck.open_sync(path, FileOptions(num_readers=2,
                                        splinter_bytes=256 << 10, **opts))
    sess = ck.start_read_session_sync(fh, len(data), 0)
    assert sess.readers.join(120)
    out = bytes(ck.read_view_sync(sess, len(data), 0))
    m = sess.metrics
    assert hashlib.sha256(out).digest() == hashlib.sha256(data).digest()
    assert m.bytes_copied == 0 and m.bytes_read == len(data)
    if opts.get("queue_depth", 0) >= 2:
        assert m.submit_backend == (
            "threads" if opts.get("submit_mode") == "threads" or
            not tsubmit.io_uring_supported() else "io_uring")
        assert 1 <= m.inflight_hwm <= 4 and m.queue_depth == 4
    else:
        assert m.submit_backend == "" and m.inflight_hwm == 0
    assert m.direct_io == bool(opts.get("direct_io"))
    if opts.get("direct_io"):
        assert m.recovery.direct_tail_bytes == len(data) % tposix.fs_block_size(
            path)
    ck.close_read_session_sync(sess)
    ck.close_sync(fh)


def test_drop_page_cache_as_reference(tmp_path):
    path = str(tmp_path / "f.bin")
    with open(path, "wb") as f:
        f.write(os.urandom(1 << 16))
    sinks = (_Sink(), _Sink())
    assert (tposix.drop_page_cache(path, stats=sinks[0])
            == jposix.drop_page_cache(path, stats=sinks[1]))
    assert not tposix.drop_page_cache(str(tmp_path / "missing"),
                                      stats=sinks[0])
    assert sinks[0].suppressed == sinks[1].suppressed + 1


def test_options_validation_as_reference():
    with pytest.raises(ValueError, match="submit mode"):
        FileOptions(submit_mode="sidecar").reader_options()
    with pytest.raises(ValueError, match="queue_depth"):
        FileOptions(queue_depth=-1).reader_options()
    with pytest.raises(ValueError, match="readahead"):
        FileOptions(readahead_bytes=-4096).reader_options()
    r = FileOptions(direct_io=True, queue_depth=8, readahead_bytes=1 << 20,
                    submit_mode="threads").reader_options()
    assert (r.direct_io, r.queue_depth, r.readahead_bytes, r.submit_mode) == (
        True, 8, 1 << 20, "threads")


# -- the online tuners -------------------------------------------------------------
def _session(mod, rng, *, depth=None, ra=None, readers=None):
    """A finished session's SessionMetrics in package ``mod``, from ``rng``
    draws (the same draws give the same fields in either package)."""
    m = mod.SessionMetrics()
    m.num_readers = readers if readers is not None else int(rng.integers(1, 9))
    m.bytes_read = int(rng.integers(1, 1 << 30))
    m.t_start = 10.0
    m.t_last_read = 10.0 + float(rng.uniform(0.01, 2.0))
    m.read_calls = int(rng.integers(1, 200))
    m.read_time_s = float(rng.uniform(0.01, 4.0))
    m.steals = int(rng.integers(0, m.read_calls + 1))
    for r in range(m.num_readers):
        m.bytes_per_reader[r] = int(rng.integers(0, 1 << 28))
        m.read_time_per_reader[r] = float(rng.uniform(0.0, 1.0))
        m.reads_per_reader[r] = int(rng.integers(0, 40))
        m.steals_from_reader[r] = int(rng.integers(0, 5))
    m.queue_depth = depth if depth is not None else int(rng.choice([0, 2, 8, 16]))
    m.readahead_bytes = ra if ra is not None else int(rng.integers(0, 9)) << 20
    return m


@pytest.mark.parametrize("seed", range(3))
def test_tuners_give_the_reference_decisions(seed):
    pairs = ((jtune, jmetrics), (ttune, tmetrics))
    out = []
    for tune, metrics in pairs:
        rng = np.random.default_rng(seed)
        auto = tune.AutoTuner(num_pes=4)
        queue = tune.QueueTuner()
        sizer = tune.SplinterSizer(align=4096)
        got = []
        for _ in range(12):
            m = _session(metrics, rng)
            for t in (auto, queue, sizer):
                t.record_session(m)
            nbytes = int(rng.integers(1, 1 << 34))
            got.append((auto.suggest(nbytes), queue.suggest(8, 1 << 20),
                        sizer.suggest(8 << 20),
                        sizer.suggest_per_reader(4, 8 << 20),
                        tune.suggest_num_readers(nbytes, 4, 2)))
        out.append(got)
    assert out[0] == out[1]


def test_queue_tuner_walk_matches_reference():
    """A closed loop: each tuner's own suggestion is 'run' and observed at a
    throughput from the same seeded response surface."""
    paths = []
    for tune, metrics in ((jtune, jmetrics), (ttune, tmetrics)):
        q = tune.QueueTuner()
        path = []
        for i in range(16):
            d, ra = q.suggest(8, 8 << 20)
            path.append((d, ra))
            m = metrics.SessionMetrics(queue_depth=d, readahead_bytes=ra,
                                       bytes_read=1 << 28, t_start=1.0)
            # Peak at depth 16, 4 MiB readahead.
            m.t_last_read = 1.0 + (abs(np.log2(d / 16)) + abs(
                (ra >> 20) - 4) / 4 + 1) * 0.1
            q.record_session(m)
        paths.append((path, q.best()))
    assert paths[0] == paths[1]
    assert paths[1][1] is not None
