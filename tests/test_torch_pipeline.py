"""The port's ``CkIOPipeline`` against the reference's: the same token file
and steps give equal batches (whole-window, streamed, remainder window) and
equal ``IngestMetrics``/``StreamMetrics`` counters. Batches are compared
exactly; the counters that are times are not compared."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import FileOptions as JFileOptions  # noqa: E402
from repro.data import CkIOPipeline as JPipeline  # noqa: E402
from repro.data import make_token_file  # noqa: E402
from repro_torch.core import FileOptions  # noqa: E402
from repro_torch.data import CkIOPipeline  # noqa: E402

STREAM_COUNTS = ("splinters_staged", "bytes_staged", "stage_chunks",
                 "stale_events", "steps")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pipe") / "corpus.bin")
    make_token_file(path, 20_000, vocab_size=200064, seed=11)
    raw = np.fromfile(path, dtype=np.uint32, offset=4096).view(np.int32)
    return path, raw


def _pair(path, **kw):
    common = dict(num_pes=2, num_consumers=8)
    common.update(kw)
    opts = dict(num_readers=3, splinter_bytes=4096)
    return (JPipeline(path, file_opts=JFileOptions(**opts), **common),
            CkIOPipeline(path, file_opts=FileOptions(**opts), device="cpu",
                         **common))


@pytest.mark.parametrize("streaming", [False, True])
def test_get_batch_device_matches_reference(corpus, streaming):
    path, raw = corpus
    jp, tp = _pair(path, global_batch=4, seq_len=1023, streaming=streaming)
    need = 4 * 1024
    for step in range(4):
        xj, yj = jp.get_batch_device(step)
        xt, yt = tp.get_batch_device(step)
        assert xt.dtype == torch.int32 and xt.shape == (4, 1023)
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        w = raw[step * need:(step + 1) * need].reshape(4, 1024)
        np.testing.assert_array_equal(xt.numpy(), w[:, :-1])
        np.testing.assert_array_equal(yt.numpy(), w[:, 1:])
    assert tp.ingest.summary() == jp.ingest.summary()
    assert tp.ingest.host_permute_bytes == 0
    if streaming:
        js, ts = jp.stream.summary(), tp.stream.summary()
        assert {k: ts[k] for k in STREAM_COUNTS} == {k: js[k] for k in STREAM_COUNTS}
        assert tp.ingest.h2d_transfers == ts["stage_chunks"] > 4
    else:
        assert tp.ingest.h2d_transfers == 4
    jp.close()
    tp.close()


@pytest.mark.parametrize("streaming", [False, True])
def test_remainder_window_matches_reference(tmp_path, streaming):
    path = str(tmp_path / "rem.bin")
    make_token_file(path, 1000, vocab_size=50, seed=3)
    jp, tp = _pair(path, global_batch=2, seq_len=32, drop_remainder=False,
                   streaming=streaming)
    assert tp.num_steps == jp.num_steps == 16
    last = tp.num_steps - 1
    xj, yj = jp.get_batch_device(last)
    xt, yt = tp.get_batch_device(last)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    assert (xt.numpy()[-1, -10:] == 0).all()          # padded tail
    assert tp.ingest.summary() == jp.ingest.summary()
    jp.close()
    tp.close()


def test_host_path_and_copy_mode_match_reference(corpus):
    path, _ = corpus
    jp, tp = _pair(path, global_batch=2, seq_len=31, zero_copy=False)
    for step in range(2):
        xj, yj = jp.get_batch(step)
        xt, yt = tp.get_batch(step)
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(yt, yj)
    xj, _ = jp.get_batch_device(2)
    xt, _ = tp.get_batch_device(2)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    assert tp.ingest.summary() == jp.ingest.summary()
    assert tp.ingest.host_permute_bytes > 0           # copy mode says so
    x, y = tp.to_device(*tp.get_batch(3))
    assert x.device.type == "cpu" and x.shape == (2, 31)
    jp.close()
    tp.close()


def test_staged_view_retires_on_next_fetch(corpus):
    path, raw = corpus
    _, tp = _pair(path, global_batch=4, seq_len=63)
    x0, _ = tp.get_batch_device(0)
    st = tp._staged[-1]
    mv = st.host_view
    assert mv is not None and st.staged is not None
    tp.get_batch_device(1)
    with pytest.raises(ValueError):                   # use-after-retire
        bytes(mv)
    assert st.host_tokens is None and st.staged is None
    np.testing.assert_array_equal(x0.numpy(), raw[:256].reshape(4, 64)[:, :-1])
    tp.close()


def test_resize_mid_stream_keeps_batches(corpus):
    path, raw = corpus
    _, tp = _pair(path, global_batch=4, seq_len=63, streaming=True)
    tp.get_batch_device(0)
    tp.resize(12)
    tp.get_batch_device(1)
    tp.resize(3)
    x2, _ = tp.get_batch_device(2)
    np.testing.assert_array_equal(x2.numpy(),
                                  raw[512:768].reshape(4, 64)[:, :-1])
    assert tp.ck.locations.count() == 3
    tp.close()


def test_unported_options_and_missing_card_raise(corpus, tmp_path):
    path, raw = corpus
    # A FileSet corpus is carried now (tests/test_torch_fileset_pipeline.py).
    from repro_torch.data import FileSet, write_token_shards

    shards = write_token_shards(str(tmp_path), np.arange(600, dtype=np.uint32),
                                [300, 300])
    pipe = CkIOPipeline(FileSet.build(shards), 2, 31, device="cpu")
    np.testing.assert_array_equal(pipe.get_batch(1)[0][0], np.arange(64, 95))
    pipe.close()
    # A sharding is carried now (tests/test_torch_sharded_pipeline.py); an
    # object that is not one is refused before anything is opened.
    with pytest.raises(TypeError, match="devices_indices_map"):
        CkIOPipeline(path, 2, 31, sharding=object(), device="cpu")
    # A reader service is carried now: a pipeline on its pool gives the
    # same batch (tests/test_torch_service.py holds every mode).
    from repro_torch.ipc.service import ReaderService, ServiceOptions

    svc = ReaderService(ServiceOptions(pool_workers=2, backend="thread"))
    try:
        pipe = CkIOPipeline(path, 2, 31, device="cpu", service=svc,
                            file_opts=FileOptions(backend="process",
                                                  max_workers=2))
        x, y = pipe.get_batch_device(1)
        np.testing.assert_array_equal(x.numpy(),
                                      raw[64:128].reshape(2, 32)[:, :-1])
        assert pipe.ck.director.service is svc
        pipe.close()
    finally:
        svc.shutdown()
    assert svc.metrics.completed >= 1 and svc.metrics.sessions_failed == 0
    # The process backend is carried now: its batch is the thread
    # backend's (tests/test_torch_process_backend.py holds every mode).
    pipe = CkIOPipeline(path, 2, 31, device="cpu",
                        file_opts=FileOptions(backend="process",
                                              max_workers=2))
    x, y = pipe.get_batch_device(1)
    np.testing.assert_array_equal(x.numpy(),
                                  raw[64:128].reshape(2, 32)[:, :-1])
    pipe.close()
    with pytest.raises(ValueError, match="unknown reader backend"):
        CkIOPipeline(path, 2, 31, device="cpu",
                     file_opts=FileOptions(backend="mpi"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            CkIOPipeline(path, 2, 31)                 # device="cuda" default
