"""The port's serving path against the reference's, on the same inputs.

* ``ModelEngine`` under the continuous and static batchers, and the
  pad-to-bucket ``BatchServer``, give greedy tokens EQUAL to the
  reference's for the same converted float32 params of
  ``smoke_config(phi4-mini-3.8b)``. Tokens are compared in float32 only:
  in bfloat16 the reference rounds the attention probabilities to bf16
  before PV and the port's attention does not, so an argmax may differ.
* ``ModeledEngine`` streams, the ingest backpressure counters, ``FileSet``
  addressing and the prompt bytes a session delivers are bit-equal.
* ``launch.serve`` runs both modes with ``--device cpu --smoke``.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.data.fileset as jfileset  # noqa: E402
import repro.serve as jserve  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.data.fileset as tfileset  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.data.tokenfile import read_meta, write_token_file  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import from_reference  # noqa: E402

SEED = 20260809
VOCAB = 97
PKGS = {"ref": (jcore, jserve), "port": (tcore, tserve)}


def _token_file(tmp_path, n_rows, vocab=512):
    rng = np.random.default_rng(SEED)
    arr = rng.integers(0, vocab, size=(n_rows,), dtype=np.int32)
    path = str(tmp_path / "prompts.bin")
    write_token_file(path, arr)
    return path, arr


def _requests(serve, n, rows_per, max_new, eos_id=None):
    return [serve.ServeRequest(rid=i, row_start=i * rows_per,
                               num_rows=rows_per, max_new_tokens=max_new[i],
                               eos_id=eos_id) for i in range(n)]


def _run(pkg, path, engine_fn, max_new, L, *, batcher="continuous",
         max_inflight_bytes=256 << 20):
    core, serve = PKGS[pkg]
    ck = core.CkIO(num_pes=2)
    fh = ck.open_sync(path, core.FileOptions(num_readers=1))
    metrics = core.ServeMetrics()
    ck.director.add_observer(metrics.record_session)
    ing = serve.RequestIngester(ck, fh, read_meta(path), metrics,
                                max_pending=len(max_new),
                                max_inflight_bytes=max_inflight_bytes)
    engine = engine_fn(pkg)
    if batcher == "continuous":
        bat = serve.ContinuousBatcher(engine, ing)
    else:
        bat = serve.StaticBatcher(engine, ing, batch_size=engine.slots)
    for r in _requests(serve, len(max_new), L, max_new):
        ing.submit(r)
    states = dict(metrics.transitions), metrics.over_budget_events
    done = bat.run()
    ck.close_sync(fh)
    return {r.rid: r.result for r in done}, metrics, states


@pytest.fixture(scope="module")
def models():
    jcfg = jsmoke(jget_config("phi4-mini-3.8b")).replace(dtype="float32")
    tcfg = smoke_config(get_config("phi4-mini-3.8b")).replace(dtype="float32")
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return {"ref": (jm, jp), "port": (tm, from_reference(jp, tcfg, device="cpu"))}


def _model_engine(models, slots, budget):
    def make(pkg):
        m, p = models[pkg]
        return PKGS[pkg][1].ModelEngine(m, p, slots=slots, seq_budget=budget)
    return make


@pytest.mark.parametrize("batcher", ["continuous", "static"])
def test_model_engine_tokens_equal_reference(tmp_path, models, batcher):
    n, L, max_new = 4, 8, [5, 3, 4, 5]
    path, arr = _token_file(tmp_path, n * L, vocab=256)
    make = _model_engine(models, 2, L + 6)
    want, _, _ = _run("ref", path, make, max_new, L, batcher=batcher)
    got, metrics, _ = _run("port", path, make, max_new, L, batcher=batcher)
    assert got == want
    assert metrics.ingest_bytes_copied == 0 and metrics.ingest_sessions == n
    # ... and the port's batcher equals its own sequential oracle.
    oracle = tserve.sequential_oracle(
        make("port"), [arr[i * L:(i + 1) * L] for i in range(n)], max_new)
    assert [got[i] for i in range(n)] == oracle


def test_batch_server_tokens_equal_reference(models):
    rng = np.random.default_rng(SEED)
    lens = [5, 9, 7]                              # left-padded to bucket 16
    prompts = [rng.integers(0, 256, size=s).astype(np.int32) for s in lens]
    out = {}
    for pkg in PKGS:
        m, p = models[pkg]
        reqs = [PKGS[pkg][1].Request(rid=i, prompt=prompts[i],
                                     max_new_tokens=3 + i) for i in range(3)]
        done = PKGS[pkg][1].BatchServer(m, p, batch_size=2, bucket=16).serve(reqs)
        out[pkg] = [np.asarray(r.result).tolist() for r in done]
        assert all(r.latency_s >= r.service_s > 0.0 for r in done)
    assert out["port"] == out["ref"]
    assert [len(x) for x in out["port"]] == [3, 4, 5]


def test_modeled_engine_streams_equal_reference():
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, 512, size=int(s)) for s in rng.integers(1, 40, 12)]
    max_new = rng.integers(1, 12, size=12).tolist()
    eng = lambda serve: serve.ModeledEngine(slots=1, vocab=VOCAB)  # noqa: E731
    base = jserve.sequential_oracle(eng(jserve), prompts, max_new)
    eos = base[0][min(2, len(base[0]) - 1)]
    for eos_id in (None, eos):
        assert (tserve.sequential_oracle(eng(tserve), prompts, max_new, eos_id)
                == jserve.sequential_oracle(eng(jserve), prompts, max_new,
                                            eos_id))


def test_continuous_backpressure_matches_reference(tmp_path):
    # One session's bytes of budget: submits queue on the thread backend;
    # both packages walk the same states and give the same streams.
    n, L = 6, 64
    path, _ = _token_file(tmp_path, n * L)
    make = lambda pkg: PKGS[pkg][1].ModeledEngine(slots=2, vocab=VOCAB)  # noqa: E731
    runs = {pkg: _run(pkg, path, make, [3 + i for i in range(n)], L,
                      max_inflight_bytes=L * 4) for pkg in PKGS}
    (gt, gm, gs), (wt, wm, ws) = runs["port"], runs["ref"]
    assert gt == wt and sorted(gt) == list(range(n))
    assert gs == ws and gs[1] >= 1 and gs[0] == {"open->queueing": 1}
    for k in ("completed", "admissions", "evictions", "generated_tokens",
              "queue_depth_hwm", "inflight_bytes_hwm", "ingest_sessions"):
        assert getattr(gm, k) == getattr(wm, k), k
    assert set(gm.summary()) == set(wm.summary())


def test_percentile_equals_reference():
    rng = np.random.default_rng(SEED)
    for n in (0, 1, 2, 7, 100):
        vals = rng.exponential(1.0, size=n).tolist()
        for q in (0.0, 10.0, 50.0, 99.0, 99.9, 100.0):
            assert tcore.percentile(vals, q) == jcore.percentile(vals, q)


def _shards(tmp_path):
    rng = np.random.default_rng(SEED)
    arr = rng.integers(0, 1 << 30, size=(1000,), dtype=np.int32)
    counts = [300, 0, 250, 450]                   # an empty shard included
    paths = jfileset.write_token_shards(str(tmp_path), arr, counts)
    return arr, paths


def test_fileset_addressing_equals_reference(tmp_path):
    _, paths = _shards(tmp_path)
    jfs, tfs = jfileset.FileSet.build(paths), tfileset.FileSet.build(paths)
    assert tfs.segments() == jfs.segments()
    assert (tfs.num_rows, tfs.data_bytes, tfs.row_bytes, tfs.dtype) == \
        (jfs.num_rows, jfs.data_bytes, jfs.row_bytes, jfs.dtype)
    for start, rows in ((0, 1), (299, 2), (290, 300), (0, 1000), (999, 1)):
        assert tfs.byte_range_for_rows(start, rows) == \
            jfs.byte_range_for_rows(start, rows)
        assert tfs.shard_ranges_for_rows(start, rows) == \
            jfs.shard_ranges_for_rows(start, rows)
        assert tfs.shard_of_row(start) == jfs.shard_of_row(start)
    with pytest.raises(ValueError):
        tfs.byte_range_for_rows(990, 20)


def test_fileset_prompt_bytes_equal_reference(tmp_path):
    # Zero-copy views of shard-straddling row windows, through each
    # package's own CkIO over its own FileSet, against the NumPy corpus.
    arr, paths = _shards(tmp_path)
    for start, rows in ((0, 1000), (290, 300), (540, 10), (999, 1)):
        got = {}
        for pkg, fmod in (("ref", jfileset), ("port", tfileset)):
            core = PKGS[pkg][0]
            fs = fmod.FileSet.build(paths)
            ck = core.CkIO(num_pes=2)
            fh = ck.open_fileset_sync(fs, core.FileOptions(
                num_readers=2, splinter_bytes=4096))
            off, nb = fs.byte_range_for_rows(start, rows)
            sess = ck.start_read_session_sync(fh, nb, off)
            got[pkg] = bytes(ck.read_view_sync(sess, nb, off))
            ck.close_read_session_sync(sess)
            ck.close_sync(fh)
        assert got["port"] == got["ref"] == arr[start:start + rows].tobytes()


@pytest.mark.parametrize("mode", [[], ["--continuous", "--arrival-rate", "200"]])
def test_launch_serve_runs_on_cpu(tmp_path, mode):
    run = tlaunch.main(["--smoke", "--device", "cpu", "--requests", "5",
                        "--batch", "2", "--prompt-len", "6", "--max-new", "3",
                        "--data", str(tmp_path / "p.bin"), *mode])
    s = run.summary
    assert s["all_completed"] and s["requests"] == 5 and s["new_tokens"] == 15
    assert all(len(r.result) == 3 for r in run.requests)
    assert all(0 <= t < 256 for r in run.requests for t in r.result)
    if mode:
        assert run.metrics.ingest_sessions == 5
        assert os.path.isdir(str(tmp_path / "p.bin") + ".shards")
        oracle = tserve.sequential_oracle(
            run.engine, [run.corpus[r.row_start:r.row_start + r.num_rows]
                         for r in sorted(run.requests, key=lambda r: r.rid)],
            [3] * 5)
        assert [r.result for r in sorted(run.requests, key=lambda r: r.rid)] \
            == oracle


def test_unported_serving_options_raise(tmp_path):
    # The reader service is carried now: --service runs the continuous
    # ingest on its pool (tests/test_torch_service.py holds the tokens
    # against the oracle), and RequestIngester(service=) paces on it.
    run = tlaunch.main(["--smoke", "--device", "cpu", "--continuous",
                        "--service", "--requests", "3", "--max-new", "2",
                        "--data", str(tmp_path / "p.bin")])
    assert run.summary["all_completed"]
    assert run.summary["pooled_sessions"] == 3

    class Pool:
        listeners = []

        def add_capacity_listener(self, cb):
            self.listeners.append(cb)

    pool = Pool()
    ing = tserve.RequestIngester(None, None, None, service=pool)
    assert pool.listeners == [ing.capacity_event.set]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tlaunch.main(["--smoke"])
