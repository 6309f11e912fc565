"""The reference's last functions that the port lacked, each against the
reference's own: ``data.packing.pack_documents``,
``data.synthetic.make_opaque_file``, ``configs.registry.smoke_shape``,
``ipc.service.ReaderService.would_admit``, ``serve.serve_step.
make_prefill_step`` and ``models.attention.prefill_cache`` (whose ring,
continued by ``attention_decode``, must give the decode replay's output).
Exact where the function moves integers or bytes; fp32 model outputs at
1e-5."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.data as jdata  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.configs.registry import smoke_shape as jsmoke_shape  # noqa: E402
from repro.ipc.service import ReaderService as JReaderService  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.serve import make_prefill_step as jmake_prefill_step  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config, smoke_shape  # noqa: E402
from repro_torch.core import CkIO, FileOptions  # noqa: E402
from repro_torch.io.posix import write_file  # noqa: E402
from repro_torch.ipc.service import ReaderService, ServiceOptions  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import from_reference  # noqa: E402
from repro_torch.models.layers import rope_angles  # noqa: E402
from repro_torch.serve import make_prefill_step  # noqa: E402
from repro_torch.train import leaves  # noqa: E402


@pytest.mark.parametrize("seed", range(5))
def test_pack_documents_matches_reference(seed):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, 500, size=int(rng.integers(0, 40))).tolist()
            for _ in range(int(rng.integers(1, 12)))]
    seq_len = int(rng.integers(4, 33))
    got = tdata.pack_documents(docs, seq_len, eos_id=2, pad_id=seed)
    want = jdata.pack_documents(docs, seq_len, eos_id=2, pad_id=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("nbytes", [0, 1000, (16 << 20) + 5])
def test_make_opaque_file_matches_reference(tmp_path, nbytes):
    a, b = str(tmp_path / "t" / "a.bin"), str(tmp_path / "j" / "b.bin")
    tdata.make_opaque_file(a, nbytes, seed=7)
    jdata.make_opaque_file(b, nbytes, seed=7)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        got = fa.read()
        assert len(got) == nbytes and got == fb.read()


def test_smoke_shape_matches_reference():
    assert [s.name for s in SHAPES] == [s.name for s in JSHAPES]
    for s, js in zip(SHAPES, JSHAPES):
        got, want = smoke_shape(s), jsmoke_shape(js)
        assert (got.name, got.seq_len, got.global_batch, got.kind) == (
            want.name, want.seq_len, want.global_batch, want.kind)


def test_would_admit_on_a_pool(tmp_path):
    """``would_admit`` of a one-session, no-queue pool on the thread
    substrate: fresh, with a session running, after it closes, after
    shutdown."""
    path = str(tmp_path / "blob.bin")
    data = np.random.default_rng(3).integers(0, 256, 1 << 18,
                                             dtype=np.uint8).tobytes()
    write_file(path, data)
    ck = CkIO(num_pes=2)
    svc = ReaderService(ServiceOptions(pool_workers=1, backend="thread",
                                       max_sessions=1, max_queue=0))
    ck.director.attach_service(svc)
    trace = [svc.would_admit()]
    try:
        fh = ck.open_sync(path, FileOptions(num_readers=1, backend="process",
                                            max_workers=1, use_service=True))
        sess = ck.start_read_session_sync(fh, len(data), 0, timeout=60)
        trace.append(svc.would_admit())
        ck.read_view_sync(sess, len(data), 0, timeout=60)
        ck.close_read_session_sync(sess)
        ck.close_sync(fh)
        trace.append(svc.would_admit())
    finally:
        svc.shutdown()
    trace.append(svc.would_admit())
    assert trace == [True, False, True, False]


@pytest.mark.parametrize("running", [0, 1, 2])
@pytest.mark.parametrize("queued", [0, 1, 3])
@pytest.mark.parametrize("shutdown", [False, True])
def test_would_admit_matches_reference(running, queued, shutdown):
    """The admission predicate against the reference's on the same state
    (a stand-in with the fields both read: the reference's service is not
    started here, since its segments share a prefix that the reference's
    own tests scrub)."""
    class State:
        _lock = threading.Lock()
        _shutdown = shutdown
        _running = [object()] * running
        _waitq = [object()] * queued
        opts = ServiceOptions(max_sessions=2, max_queue=2)

    assert ReaderService.would_admit(State()) == \
        JReaderService.would_admit(State())


def test_make_prefill_step_matches_reference():
    """A smoke phi4-mini's prefill logits in fp32, from the reference's
    weights, through both packages' prefill steps; the port's runs without
    autograd."""
    jcfg = jsmoke(jget_config("phi4-mini-3.8b")).replace(dtype="float32")
    tcfg = smoke_config(get_config("phi4-mini-3.8b")).replace(dtype="float32")
    jm = jbuild(jcfg)
    ref = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    params = from_reference(ref, tcfg, device="cpu")
    for t in leaves(params):
        t.requires_grad_(True)
    toks = np.random.default_rng(1).integers(0, 256, (2, 24)).astype(np.int32)
    got = make_prefill_step(build_model(tcfg))(
        params, {"tokens": torch.from_numpy(toks)})
    want = jmake_prefill_step(jm)(ref, {"tokens": jnp.asarray(toks)})
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _layer(seed, d=32, H=4, K=2, hd=8):
    gen = torch.Generator().manual_seed(seed)
    params = tattn.attn_init(gen, d, H, K, hd, torch.float32, "cpu")
    return params, K, hd


@pytest.mark.parametrize("S, capacity", [(7, 12), (12, 12), (19, 8), (16, 5)])
def test_prefill_cache_matches_reference_and_the_decode_replay(S, capacity):
    """The ring from a prefill pass equals the reference's (its k and v;
    ``slot_pos`` is implied by the position) and the ring the decode replay
    of the same S tokens leaves; one more decode step from either gives the
    same output (1e-5, fp32)."""
    B, d, eps = 2, 32, 1e-6
    params, K, hd = _layer(S + capacity, d)
    x = torch.from_numpy(np.random.default_rng(S).standard_normal(
        (B, S + 1, d)).astype(np.float32))
    pos = torch.arange(S + 1)[None].expand(B, -1)
    cos, sin = rope_angles(pos, hd, 10000.0)
    got = tattn.prefill_cache(params, x[:, :S], cos[:, :S], sin[:, :S],
                              capacity, dtype=torch.float32, eps=eps)
    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    want = jattn.prefill_cache(jp, jnp.asarray(x[:, :S].numpy()),
                               jnp.asarray(cos[:, :S].numpy()),
                               jnp.asarray(sin[:, :S].numpy()), capacity,
                               dtype=jnp.float32, eps=eps)
    for g, w in ((got.k, want.k), (got.v, want.v)):
        assert g.shape == (B, capacity, K, hd)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    # the decode replay of the same tokens
    cache = tattn.init_cache(B, capacity, K, hd, torch.float32, "cpu")
    for t in range(S):
        _, cache = tattn.attention_decode(
            params, x[:, t:t + 1], cache, t, cos[:, t:t + 1], sin[:, t:t + 1],
            dtype=torch.float32, eps=eps)
    for g, r in ((got.k, cache.k), (got.v, cache.v)):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)
    step = [tattn.attention_decode(
        params, x[:, S:S + 1], c, S, cos[:, S:S + 1], sin[:, S:S + 1],
        dtype=torch.float32, eps=eps)[0] for c in (got, cache)]
    torch.testing.assert_close(step[0], step[1], rtol=1e-5, atol=1e-5)
