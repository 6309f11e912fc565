"""The constructor-sharded ``CkIOPipeline`` of the port against the
reference's.

* ``device_token_spans`` on the reference's fake index maps (replicated
  spans, a sequence split, strides, rank, remote-span routing), equal to
  the reference's function;
* ``NamedSharding.devices_indices_map`` on one device against JAX's, and
  on 4 ranks and a 2 × 2 mesh against the blocks DTensor holds;
* a one-device sharding (a fake process group of one rank) over
  {thread, process} × {whole-window, streamed} on a 3-shard ``FileSet``:
  batches bit-equal to the reference's sharded pipeline on its one CPU
  device, no ``RuntimeWarning``, ``ShardMetrics.summary()`` equal;
* the remainder window with ``pad_id=3``, the per-call mismatch
  ``ValueError``, the per-call fallback's one ``RuntimeWarning``,
  ``to_device(sharding=...)``;
* a fake process group of 4 ranks at each rank: each rank stages its
  block alone, the four blocks tile the unsharded batch, and the
  cross-host ledger balances.

Tokens and bytes are compared exactly."""
import contextlib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402
from jax.sharding import NamedSharding as JNamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402

from repro.core import CkIO as JCkIO  # noqa: E402
from repro.core import FileOptions as JFileOptions  # noqa: E402
from repro.data import CkIOPipeline as JPipeline  # noqa: E402
from repro.data.fileset import FileSet as JFileSet  # noqa: E402
from repro.data.pipeline import device_token_spans as jspans  # noqa: E402
from repro_torch.core import CkIO, FileOptions  # noqa: E402
from repro_torch.data import CkIOPipeline, FileSet, device_token_spans, make_token_file  # noqa: E402
from repro_torch.data.fileset import write_token_shards  # noqa: E402
from repro_torch.launch.dryrun import fake_process_group  # noqa: E402
from repro_torch.launch.sharding import DeviceKey, NamedSharding, P  # noqa: E402

B, S = 16, 127
W = S + 1
SEED = 20260809


@contextlib.contextmanager
def mesh_of(world: int = 1, rank: int = 0, shape=None, names=("data",)):
    """A ``DeviceMesh`` on the CPU over a fake group of ``world`` ranks,
    this process ``rank``; the group is gone after the block."""
    with fake_process_group(world, rank=rank):
        ranks = torch.arange(world)
        yield DeviceMesh("cpu", ranks.reshape(shape) if shape else ranks,
                         mesh_dim_names=names)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """4 full (16, 128) windows and 64 tokens over; the same tokens as a
    3-shard FileSet (shard starts inside windows 1 and 2)."""
    d = tmp_path_factory.mktemp("sharded_corpus")
    path = str(d / "tokens.bin")
    make_token_file(path, B * W * 4 + 64, vocab_size=32000, seed=SEED)
    raw = np.fromfile(path, dtype=np.uint32, offset=4096).view(np.int32)
    paths = write_token_shards(str(d / "shards"), raw.view(np.uint32),
                               [3000, 4096, len(raw) - 7096])
    return path, paths, raw


def _window(raw, step, pad_id=0):
    w = raw[step * B * W:(step + 1) * B * W]
    return np.concatenate([w, np.full(B * W - len(w), pad_id, np.int32)]
                          ).reshape(B, W)


def _opts(backend="thread"):
    return dict(num_readers=2, splinter_bytes=32 * 1024, backend=backend,
                max_workers=2)


def _jpipe(paths, streaming, **kw):
    mesh = JMesh(np.array(jax.devices()[:1]), ("dp",))
    sh = JNamedSharding(mesh, JP("dp", None))
    return JPipeline(JFileSet.build(paths), B, S, ckio=JCkIO(num_pes=4),
                     file_opts=JFileOptions(**_opts()), streaming=streaming,
                     sharding=sh, **kw)


def _tpipe(source, streaming, sharding, backend="thread", **kw):
    return CkIOPipeline(source, B, S, ckio=CkIO(num_pes=4),
                        file_opts=FileOptions(**_opts(backend)),
                        streaming=streaming, sharding=sharding, device="cpu",
                        **kw)


# -- device_token_spans: the pure placement function ---------------------------
@pytest.mark.parametrize("spans_fn", [device_token_spans, jspans],
                         ids=["port", "reference"])
def test_device_token_spans_fake_maps(spans_fn):
    fake = {f"dev{i}": (slice(2 * i, 2 * i + 2), slice(None)) for i in range(4)}
    spans = spans_fn(fake, 8, W)
    assert spans == {f"dev{i}": (2 * i * W, (2 * i + 2) * W) for i in range(4)}
    ordered = sorted(spans.values())
    assert ordered[0][0] == 0 and ordered[-1][1] == 8 * W
    for (_, a1), (b0, _) in zip(ordered, ordered[1:]):
        assert a1 == b0
    rep = {"d0": (slice(0, 8), slice(None)), "d1": (slice(0, 8), slice(None))}
    assert spans_fn(rep, 8, W) == {"d0": (0, 8 * W), "d1": (0, 8 * W)}
    assert device_token_spans(fake, 8, W) == jspans(fake, 8, W)


@pytest.mark.parametrize("bad, match", [
    ({"d0": (slice(None), slice(0, 64)), "d1": (slice(None), slice(64, 128))},
     "splits the sequence dimension"),
    ({"d0": (slice(0, 8, 2), slice(None))}, "unit-stride"),
    ({"d0": (slice(None),)}, "2-d"),
])
def test_device_token_spans_rejects_like_the_reference(bad, match):
    for fn in (device_token_spans, jspans):
        with pytest.raises(ValueError, match=match):
            fn(bad, 8, 128)


def test_chunk_routing_with_remote_spans():
    """A chunk straddling a local and a remote span splits between them at
    the span edge, as the reference routes it."""
    idx = {"local": (slice(0, 4), slice(None)),
           "remote": (slice(4, 8), slice(None))}
    spans = device_token_spans(idx, 8, W)
    assert spans == jspans(idx, 8, W)
    tok0, ntok = 3 * W, 2 * W
    pieces = {dev: (max(tok0, s0), min(tok0 + ntok, s1))
              for dev, (s0, s1) in spans.items()
              if max(tok0, s0) < min(tok0 + ntok, s1)}
    assert pieces == {"local": (3 * W, 4 * W), "remote": (4 * W, 5 * W)}


# -- NamedSharding ------------------------------------------------------------------
def test_one_device_indices_match_jax():
    jsh = JNamedSharding(JMesh(np.array(jax.devices()[:1]), ("data",)),
                         JP("data", None))
    with mesh_of() as mesh:
        sh = NamedSharding(mesh, P("data", None))
        got = sh.devices_indices_map((B, W))
    assert list(got.values()) == list(jsh.devices_indices_map((B, W)).values())
    assert list(got) == [DeviceKey(0, torch.device("cpu"))]
    assert str(list(got)[0]) == "rank0:cpu"


@pytest.mark.parametrize("rank", range(4))
def test_indices_are_the_blocks_dtensor_holds(rank):
    """4 ranks, 1-D and 2 × 2: each rank's index is the block of a
    DTensor made from the full tensor by ``put``; ``addressable_devices``
    is this rank's key alone."""
    full = torch.arange(8 * 6).reshape(8, 6)
    with mesh_of(4, rank) as mesh:
        sh = NamedSharding(mesh, P("data", None))
        idx = sh.devices_indices_map(full.shape)
        assert [idx[k] for k in sorted(idx, key=lambda k: k.rank)] == [
            (slice(2 * r, 2 * r + 2), slice(None)) for r in range(4)]
        assert sh.addressable_devices == {sh.local_key}
        assert sh.local_key.rank == rank
        d = sh.put(full)
        assert d.shape == full.shape
        assert torch.equal(d.to_local(), full[2 * rank:2 * rank + 2])
    with mesh_of(4, rank, shape=(2, 2), names=("data", "model")) as mesh:
        sh = NamedSharding(mesh, P("data", "model"))
        d = sh.put(full)
        r, c = divmod(rank, 2)
        assert torch.equal(d.to_local(), full[4 * r:4 * r + 4, 3 * c:3 * c + 3])
        both = NamedSharding(mesh, P(("data", "model"), None))
        assert torch.equal(both.put(full).to_local(),
                           full[2 * rank:2 * rank + 2])
        with pytest.raises(ValueError, match="mesh's order"):
            NamedSharding(mesh, P(("model", "data"), None))


# -- one device: the reference's sharded pipeline ---------------------------------
@pytest.fixture(scope="module")
def reference_runs(corpus):
    """The reference's sharded pipeline on its one CPU device, whole-window
    and streamed: batches and ``ShardMetrics.summary()``."""
    _, paths, _ = corpus
    out = {}
    for streaming in (False, True):
        pipe = _jpipe(paths, streaming)
        batches = [tuple(np.asarray(a) for a in pipe.get_batch_device(s))
                   for s in range(pipe.num_steps)]
        pipe.close()
        out[streaming] = batches, pipe.ck.director.shards.summary()
    return out


@pytest.mark.parametrize("backend", ["thread", "process"])
@pytest.mark.parametrize("streaming", [False, True])
def test_one_device_sharding_matches_reference(corpus, reference_runs,
                                               backend, streaming):
    _, paths, raw = corpus
    want, want_shards = reference_runs[streaming]
    with mesh_of() as mesh:
        sh = NamedSharding(mesh, P("data", None))
        pipe = _tpipe(FileSet.build(paths), streaming, sh, backend)
        out = []
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            for s in range(pipe.num_steps):
                x, y = pipe.get_batch_device(s)
                assert x.shape == (B, S) and x.placements == tuple(
                    sh.placements)
                out.append((x.to_local().numpy(), y.to_local().numpy()))
            pipe.close()
    assert len(out) == len(want) == 4
    for s, ((x, y), (jx, jy)) in enumerate(zip(out, want)):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        np.testing.assert_array_equal(x, _window(raw, s)[:, :-1])
    assert pipe.ingest.summary()["host_permute_bytes"] == 0
    assert pipe.ck.director.shards.summary() == want_shards
    m = want_shards
    assert m["window_bytes"] == m["addressable_bytes"] == 4 * B * W * 4
    assert m["cross_host_placements"] == 0
    assert (m["device_put_calls"] > 4) if streaming else (
        m["device_put_calls"] == 4)


def test_sharded_remainder_window(corpus):
    """``drop_remainder=False``: the last window (64 tokens) pads with
    ``pad_id`` in the window kernel's plain version, as the reference's
    host path and its sharded pipeline give it."""
    path, paths, raw = corpus
    jp = _jpipe(paths, True, drop_remainder=False, pad_id=3)
    with mesh_of() as mesh:
        sh = NamedSharding(mesh, P("data", None))
        tp = _tpipe(path, True, sh, drop_remainder=False, pad_id=3)
        assert tp.num_steps == jp.num_steps == 5
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            for s in range(5):
                jx, jy = jp.get_batch_device(s)
                x, y = tp.get_batch_device(s)
                np.testing.assert_array_equal(x.to_local().numpy(),
                                              np.asarray(jx))
                np.testing.assert_array_equal(y.to_local().numpy(),
                                              np.asarray(jy))
        np.testing.assert_array_equal(y.to_local().numpy(),
                                      _window(raw, 4, 3)[:, 1:])
        tp.close()
    jp.close()


def test_per_call_sharding_mismatch_raises(corpus):
    path, _, raw = corpus
    with mesh_of() as mesh:
        sh = NamedSharding(mesh, P("data", None))
        pipe = _tpipe(path, True, sh)
        try:
            with pytest.raises(ValueError, match="constructor sharding"):
                pipe.get_batch_device(0, sharding=NamedSharding(mesh, P()))
            # the matching sharding (an equal object) and None both work
            x, _ = pipe.get_batch_device(0, sharding=NamedSharding(
                mesh, P("data", None)))
            x2, _ = pipe.get_batch_device(1)
            np.testing.assert_array_equal(x.to_local().numpy(),
                                          _window(raw, 0)[:, :-1])
            np.testing.assert_array_equal(x2.to_local().numpy(),
                                          _window(raw, 1)[:, :-1])
        finally:
            pipe.close()


@pytest.mark.parametrize("streaming", [False, True])
def test_per_call_sharding_without_constructor_sharding(corpus, streaming):
    """A per-call sharding runs the whole-window sharded path; on a
    streaming pipeline it warns once (the overlap is lost), not per call."""
    path, _, raw = corpus
    with mesh_of() as mesh:
        sh = NamedSharding(mesh, P("data", None))
        pipe = _tpipe(path, streaming, None)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for s in range(3):
                x, y = pipe.get_batch_device(s, sharding=sh)
                np.testing.assert_array_equal(x.to_local().numpy(),
                                              _window(raw, s)[:, :-1])
                np.testing.assert_array_equal(y.to_local().numpy(),
                                              _window(raw, s)[:, 1:])
        runtime = [w for w in caught if w.category is RuntimeWarning]
        assert len(runtime) == (1 if streaming else 0)
        x, _ = pipe.get_batch_device(3)          # unsharded again
        assert type(x) is torch.Tensor
        with pytest.raises(TypeError, match="NamedSharding"):
            pipe.get_batch_device(0, sharding=object())
        pipe.close()
        assert pipe.ck.director.shards.summary()["window_bytes"] == \
            3 * B * W * 4


def test_to_device_places_the_host_batch(corpus):
    path, _, raw = corpus
    with mesh_of(4, 2) as mesh:
        sh = NamedSharding(mesh, P("data", None))
        pipe = _tpipe(path, False, None)
        x, y = pipe.to_device(*pipe.get_batch(1), sharding=sh)
        assert x.shape == y.shape == (B, S)
        np.testing.assert_array_equal(x.to_local().numpy(),
                                      _window(raw, 1)[8:12, :-1])
        np.testing.assert_array_equal(y.to_local().numpy(),
                                      _window(raw, 1)[8:12, 1:])
        pipe.close()


def test_constructor_rejects_what_it_cannot_route(corpus):
    path, _, _ = corpus
    with pytest.raises(TypeError, match="devices_indices_map"):
        CkIOPipeline(path, B, S, sharding=object(), device="cpu")
    with mesh_of(4, 0) as mesh:
        with pytest.raises(ValueError, match="splits the sequence"):
            CkIOPipeline(path, B, S, device="cpu",
                         sharding=NamedSharding(mesh, P(None, "data")))


# -- four ranks: each stages its block alone ----------------------------------------
@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("rank", range(4))
def test_four_ranks_stage_their_blocks(corpus, rank, streaming):
    """Every window of the file read at rank ``rank`` of 4 (no step past
    them is prefetched, so the ledger is exact): the local blocks are rows
    4r..4r+3, and each window's bytes are this rank's staged quarter plus
    three quarters counted cross-host."""
    path, _, raw = corpus
    with mesh_of(4, rank) as mesh:
        sh = NamedSharding(mesh, P("data", None))
        pipe = _tpipe(path, streaming, sh)
        for s in range(pipe.num_steps):
            x, y = pipe.get_batch_device(s)
            w = _window(raw, s)[4 * rank:4 * rank + 4]
            np.testing.assert_array_equal(x.to_local().numpy(), w[:, :-1])
            np.testing.assert_array_equal(y.to_local().numpy(), w[:, 1:])
        pipe.close()
    m = pipe.ck.director.shards.summary()
    window = 4 * B * W * 4
    assert m["window_bytes"] == window
    assert m["addressable_bytes"] == window // 4 == m["max_device_bytes"]
    assert m["cross_host_bytes"] == 3 * window // 4
    assert m["addressable_bytes"] + m["cross_host_bytes"] == m["window_bytes"]
    assert m["devices_staged"] == 1
