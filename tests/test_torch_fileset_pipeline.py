"""A 3-shard ``FileSet`` through the port's ``CkIOPipeline`` and train
driver against the reference's pipeline over the same ``FileSet``: the host
path, the whole window and streaming, in the blocking, async and direct
read modes. Batches are compared exactly, and so are the per-shard bytes of
``ShardMetrics`` (no tolerance: these are tokens and bytes). The driver
runs each new flag on a ``--data a b c`` corpus, and its batches must
equal those of a single file holding the same tokens, read with the
blocking buffered loop."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import FileOptions as JFileOptions  # noqa: E402
from repro.data import CkIOPipeline as JPipeline  # noqa: E402
from repro.data.fileset import FileSet as JFileSet  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.core import FileOptions  # noqa: E402
from repro_torch.data import CkIOPipeline, FileSet  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402
from repro_torch.data.fileset import write_token_shards  # noqa: E402
from repro_torch.data.tokenfile import write_token_file  # noqa: E402
from repro_torch.io.posix import DirectIOError, supports_direct_io  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402

# Interior shards of whole 4 KiB blocks (1,024 uint32 tokens), as O_DIRECT
# needs; the last shard odd-sized. B=4, S=1023 windows (4,096 tokens) start
# on the block grid: the first and third straddle a shard start, the second
# lies inside shard 1, and the reads reach shard 2.
COUNTS = (3072, 6144, 4000)
MODES = {"blocking": {}, "async": dict(queue_depth=4),
         "direct": dict(queue_depth=4, direct_io=True)}
STREAM_COUNTS = ("splinters_staged", "bytes_staged", "stage_chunks",
                 "stale_events", "steps")


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("fileset")
    arr = np.random.default_rng(17).integers(
        0, 200064, sum(COUNTS)).astype(np.uint32)
    return write_token_shards(str(d), arr, COUNTS), arr.view(np.int32)


def _needs_direct(paths, mode):
    if mode == "direct" and not supports_direct_io(paths[0]):
        pytest.skip("the filesystem under the test's tmp dir refuses O_DIRECT")


@pytest.mark.parametrize("path_kind", ["host", "window", "streamed"])
@pytest.mark.parametrize("mode", list(MODES))
def test_fileset_batches_and_shard_bytes_match_reference(shards, mode,
                                                         path_kind):
    paths, raw = shards
    _needs_direct(paths, mode)
    opts = dict(num_readers=3, splinter_bytes=4096, **MODES[mode])
    common = dict(global_batch=4, seq_len=1023, num_pes=2, num_consumers=8,
                  streaming=path_kind == "streamed")
    jp = JPipeline(JFileSet.build(paths), file_opts=JFileOptions(**opts),
                   **common)
    tp = CkIOPipeline(FileSet.build(paths), file_opts=FileOptions(**opts),
                      device="cpu", **common)
    assert tp.num_steps == jp.num_steps == 3
    for step in range(3):
        w = raw[step * 4096:(step + 1) * 4096].reshape(4, 1024)
        if path_kind == "host":
            (xj, yj), (xt, yt) = jp.get_batch(step), tp.get_batch(step)
        else:
            xj, yj = jp.get_batch_device(step)
            xt, yt = (t.numpy() for t in tp.get_batch_device(step))
        np.testing.assert_array_equal(xt, np.asarray(xj))
        np.testing.assert_array_equal(yt, np.asarray(yj))
        np.testing.assert_array_equal(xt, w[:, :-1])
        np.testing.assert_array_equal(yt, w[:, 1:])
    assert tp.ingest.summary() == jp.ingest.summary()
    if path_kind == "streamed":
        js, ts = jp.stream.summary(), tp.stream.summary()
        assert {k: ts[k] for k in STREAM_COUNTS} == \
            {k: js[k] for k in STREAM_COUNTS}
    jp.close()
    tp.close()
    jsh, tsh = jp.ck.director.shards, tp.ck.director.shards
    assert tsh.shard_bytes == jsh.shard_bytes and len(tsh.shard_bytes) == 3
    assert tsh.summary() == {k: jsh.summary()[k] for k in tsh.summary()}
    if mode == "direct":
        assert tp.ck.director.recovery.direct_tail_reads == \
            jp.ck.director.recovery.direct_tail_reads


@pytest.mark.parametrize("streaming", [False, True])
def test_direct_windows_off_the_block_grid(shards, streaming):
    """B=2, S=100 windows (808 B) start off the block grid, where the
    reference raises DirectIOError: the port reads from the block below
    and hands out the window alone, bit-equal to the blocking loop."""
    paths, raw = shards
    _needs_direct(paths, "direct")
    kw = dict(num_pes=2, num_consumers=8, streaming=streaming, device="cpu")
    plain = CkIOPipeline(FileSet.build(paths), 2, 100, **kw,
                         file_opts=FileOptions(num_readers=3,
                                               splinter_bytes=4096))
    direct = CkIOPipeline(FileSet.build(paths), 2, 100, **kw,
                          file_opts=FileOptions(num_readers=3,
                                                splinter_bytes=4096,
                                                direct_io=True,
                                                queue_depth=4))
    for step in range(plain.num_steps):
        a, b = plain.get_batch_device(step), direct.get_batch_device(step)
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert direct.num_steps == sum(COUNTS) // 202 and direct.num_steps > 60
    if streaming:
        assert direct.stream.summary()["bytes_staged"] == \
            plain.stream.summary()["bytes_staged"]
    plain.close()
    direct.close()
    assert direct.ck.director.recovery.direct_tail_reads > 0


# -- the driver --------------------------------------------------------------------
# --global-batch 8 --seq 255: 2,048-token windows; shard starts at tokens
# 3,072 and 5,120, so windows 2 and 3 straddle one each.
DRIVER_COUNTS = (3072, 2048, 2000)
DRIVER = ["--smoke", "--steps", "3", "--global-batch", "8", "--seq", "255",
          "--microbatches", "1", "--num-readers", "2", "--device", "cpu",
          "--device-ingest"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The same tokens as three shards and as one file, and the single
    file's run with the blocking buffered loop: its batches and losses."""
    d = tmp_path_factory.mktemp("driver")
    vocab = smoke_config(get_config("phi4-mini-3.8b")).vocab_size
    arr = np.random.default_rng(3).integers(
        0, vocab, sum(DRIVER_COUNTS)).astype(np.uint32)
    paths = write_token_shards(str(d / "shards"), arr, DRIVER_COUNTS)
    single = str(d / "single.bin")
    write_token_file(single, arr)
    batches, summary = _run_driver(["--data", single, "--ckpt-dir",
                                    str(d / "ck_single")])
    return d, paths, batches, summary


def _run_driver(argv):
    batches = []
    orig = tpipeline.CkIOPipeline.get_batch_device

    def recorded(self, step, *a, **kw):
        x, y = orig(self, step, *a, **kw)
        batches.append((x.numpy().copy(), y.numpy().copy()))
        return x, y

    tpipeline.CkIOPipeline.get_batch_device = recorded
    try:
        summary = port_train.main([*DRIVER, *argv])
    finally:
        tpipeline.CkIOPipeline.get_batch_device = orig
    return batches, summary


@pytest.mark.parametrize("flags", [
    ["--direct-io"],
    ["--direct-io", "--queue-depth", "4", "--streaming"],
    ["--queue-depth", "4"],
    ["--queue-depth", "4", "--readahead-mb", "1"],
    ["--queue-depth", "4", "--submit-mode", "threads"],
    ["--adaptive-queue"],
    ["--adaptive-splinters"],
], ids=lambda f: "_".join(a.strip("-") for a in f))
def test_driver_fileset_flags_equal_single_file(corpus, flags):
    d, paths, want, single = corpus
    if "--direct-io" in flags:
        _needs_direct(paths, "direct")
    got, summary = _run_driver(["--data", *paths, *flags, "--ckpt-dir",
                                str(d / ("ck_" + "_".join(flags)))])
    assert len(got) == len(want) == 3
    for (xg, yg), (xw, yw) in zip(got, want):
        np.testing.assert_array_equal(xg, xw)
        np.testing.assert_array_equal(yg, yw)
    # Losses are not compared here: the CPU GEMMs' rounding may depend on
    # the params' alignment, so two runs can differ in the last bits.
    assert np.isfinite(summary["first_loss"]) and np.isfinite(
        single["first_loss"])
    read, shards = summary["read"], summary["shards"]
    assert single["shards"] is None and shards["shards_read"] == 3
    assert shards["shard_read_bytes"] == read["bytes_read"] > 0
    assert sum(shards["shard_bytes"].values()) == read["bytes_read"]
    assert read["direct_io"] == ["--direct-io" in flags]
    if "--queue-depth" in flags or "--adaptive-queue" in flags:
        lo, hi = read["queue_depth"]
        assert read["inflight_hwm"][1] <= hi and lo >= 2
        assert read["submit_backend"] == ["threads"]   # sharded handles
    else:
        assert read["submit_backend"] == ["blocking"]
    if "--readahead-mb" in flags:
        assert read["readahead_bytes"] == [1 << 20, 1 << 20]


def test_driver_forced_io_uring_on_a_fileset_raises(corpus):
    d, paths, _, _ = corpus
    with pytest.raises(ValueError, match="sharded handles use 'threads'"):
        port_train.main([*DRIVER, "--data", *paths, "--queue-depth", "4",
                         "--submit-mode", "io_uring",
                         "--ckpt-dir", str(d / "ck_uring")])


def test_driver_direct_io_names_an_odd_interior_shard(tmp_path):
    paths = write_token_shards(str(tmp_path), np.arange(3000, dtype=np.uint32),
                               [1000, 1000, 1000])
    if not supports_direct_io(paths[0]):
        pytest.skip("the filesystem under the test's tmp dir refuses O_DIRECT")
    with pytest.raises(DirectIOError, match="shard_00001.bin"):
        port_train.main([*DRIVER, "--data", *paths, "--direct-io",
                         "--ckpt-dir", str(tmp_path / "ck")])
