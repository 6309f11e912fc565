"""The port's NUMA layer against the reference's: ``io/numa.py``, the
``Topology`` model, the ``domain_spread`` / ``near_consumers`` placements,
``LocalityMetrics`` of a thread-backend session with a topology, and the
setup gate that keeps work stealing off a stripe until its owner has
first-touched it, in both reader loops."""
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import CkIO as JCkIO  # noqa: E402
from repro.core import FileOptions as JFileOptions  # noqa: E402
from repro.core import Topology as JTopology  # noqa: E402
from repro.core.placement import place_readers as jplace  # noqa: E402
from repro.core.scheduler import TaskScheduler as JSched  # noqa: E402
from repro.io import numa as jnuma  # noqa: E402
from repro_torch.core import CkIO, FileOptions, LocalityMetrics, Topology  # noqa: E402
from repro_torch.core.buffers import BufferReaderSet  # noqa: E402
from repro_torch.core.placement import place_readers  # noqa: E402
from repro_torch.core.scheduler import TaskScheduler  # noqa: E402
from repro_torch.io import numa  # noqa: E402
from repro_torch.io.layout import plan_session  # noqa: E402
from repro_torch.io.posix import PosixFile, write_file  # noqa: E402
from repro_torch.ipc.worker import StallReader  # noqa: E402


@pytest.fixture(scope="module")
def data_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tnuma") / "data.bin")
    data = np.random.default_rng(7).integers(0, 256, 1_000_000,
                                             dtype=np.uint8).tobytes()
    write_file(path, data)
    return path, data


# -- io/numa.py ------------------------------------------------------------------
@pytest.mark.parametrize("text", ["0-3,8,10-11", "5", "", " 0 , 2-2 ",
                                  "0-127", "x-y", "7-3", "1,,3"])
def test_parse_cpulist_matches_reference(text):
    try:
        want = jnuma.parse_cpulist(text)
    except ValueError:
        with pytest.raises(ValueError):
            numa.parse_cpulist(text)
        return
    assert numa.parse_cpulist(text) == want


def test_detect_domains_cpus_and_first_touch_match_reference():
    assert numa.detect_numa_domains() == jnuma.detect_numa_domains()
    assert numa.current_cpus() == jnuma.current_cpus()
    assert numa.PAGE_BYTES == jnuma.PAGE_BYTES
    for n in (0, 1, 4096, 10 * 4096 + 1):
        a, b = np.ones(n, np.uint8), np.ones(n, np.uint8)
        assert numa.first_touch(a, 4096) == jnuma.first_touch(b, 4096)
        np.testing.assert_array_equal(a, b)
    assert numa.first_touch(memoryview(bytearray(8192))) == \
        jnuma.first_touch(memoryview(bytearray(8192)))


def test_pin_thread_round_trip():
    before = sorted(numa.current_cpus())
    out = {}

    def pin():
        out["ok"] = numa.pin_thread_to_cpus(before[:1])
        out["cpus"] = numa.current_cpus()

    th = threading.Thread(target=pin)
    th.start()
    th.join(10)
    assert not th.is_alive()
    if out["ok"]:
        assert out["cpus"] == set(before[:1])
    assert numa.current_cpus() == set(before)   # only that thread moved
    assert not numa.pin_thread_to_cpus([])


# -- Topology --------------------------------------------------------------------
def _topo_fields(t):
    return (t.num_pes, t.pes_per_node, t.domains_per_node, t.domain_cpus,
            t.num_nodes, t.num_domains, t.pes_per_domain,
            [t.domain_of(p) for p in range(t.num_pes)])


@pytest.mark.parametrize("spec,num_pes,ppn", [
    ("auto", 4, 4), ("auto", 8, 2), ("auto", 3, 1), ("1", 4, 4),
    ("2", 8, 4), ("16", 4, 2), ("3", 6, 4),
])
def test_topology_from_spec_and_detect_match_reference(spec, num_pes, ppn):
    t = Topology.from_spec(spec, num_pes=num_pes, pes_per_node=ppn)
    j = JTopology.from_spec(spec, num_pes=num_pes, pes_per_node=ppn)
    assert _topo_fields(t) == _topo_fields(j)
    for d in range(t.num_domains):
        assert t.pes_in_domain(d) == j.pes_in_domain(d)
        assert t.cpus_of_domain(d) == j.cpus_of_domain(d)
    assert _topo_fields(Topology.detect(num_pes, ppn)) == _topo_fields(
        JTopology.detect(num_pes, ppn))
    assert _topo_fields(Topology.with_host_cpus(num_pes, ppn, 1)) == \
        _topo_fields(JTopology.with_host_cpus(num_pes, ppn, 1))


def test_topology_rejects_what_the_reference_rejects():
    for kw in (dict(num_pes=0), dict(num_pes=4, pes_per_node=2,
                                     domains_per_node=3),
               dict(num_pes=8, pes_per_node=4, domains_per_node=2,
                    domain_cpus=((0,), (1,), (0,)))):
        with pytest.raises(ValueError):
            JTopology(**kw)
        with pytest.raises(ValueError):
            Topology(**kw)
    with pytest.raises(ValueError):
        Topology.from_spec("fast", num_pes=4)


# -- placements ------------------------------------------------------------------
GRIDS = [(4, 4, 1), (4, 4, 2), (8, 4, 2), (8, 2, 2), (6, 4, 2), (7, 3, 3),
         (5, 5, 1)]


@pytest.mark.parametrize("policy", ["domain_spread", "near_consumers",
                                    "node_spread", "round_robin"])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "x".join(map(str, g)))
def test_placements_match_reference(policy, grid):
    num_pes, ppn, dpn = grid
    sched, jsched = (TaskScheduler(num_pes=num_pes, pes_per_node=ppn),
                     JSched(num_pes=num_pes, pes_per_node=ppn))
    topo = Topology(num_pes=num_pes, pes_per_node=ppn, domains_per_node=dpn)
    jtopo = JTopology(num_pes=num_pes, pes_per_node=ppn,
                      domains_per_node=dpn)
    for num_readers in (1, 2, num_pes - 1 or 1, num_pes, num_pes + 3,
                        3 * num_pes):
        for consumers in (None, [0], [num_pes - 1, 0],
                          list(range(num_pes))[::2]):
            for t, jt in ((None, None), (topo, jtopo)):
                assert place_readers(
                    policy, num_readers, sched, consumers, topology=t
                ) == jplace(policy, num_readers, jsched, consumers,
                            topology=jt)


def test_placements_reject_what_the_reference_rejects():
    sched = TaskScheduler(num_pes=4, pes_per_node=2)
    with pytest.raises(ValueError, match="topology covers"):
        place_readers("domain_spread", 2, sched,
                      topology=Topology(num_pes=8, pes_per_node=4))
    with pytest.raises(ValueError, match="out of range"):
        place_readers("near_consumers", 2, sched, consumer_pes=[1, 7])
    with pytest.raises(ValueError):
        place_readers("nearest", 2, sched)


# -- LocalityMetrics -------------------------------------------------------------
def _locality(ck_cls, opts_cls, topo_cls, path, nbytes, placement, pin,
              consumer_pe):
    ck = ck_cls(num_pes=8, pes_per_node=4)
    topo = topo_cls.with_host_cpus(8, pes_per_node=4, domains_per_node=2)
    fh = ck.open_sync(path, opts_cls(
        num_readers=4, splinter_bytes=32 * 1024, placement=placement,
        topology=topo, numa_pin=pin, prefault_arena=True))
    sess = ck.start_read_session_sync(fh, nbytes, 0)
    got = bytes(ck.read_view_sync(sess, nbytes, 0,
                                  client=ck.make_client(pe=consumer_pe)))
    summary = sess.locality.summary()
    copied = sess.metrics.bytes_copied
    ck.close_read_session_sync(sess)
    agg = ck.director.locality.summary()
    ck.close_sync(fh)
    return got, summary, agg, copied


@pytest.mark.parametrize("placement,pin,consumer_pe", [
    ("domain_spread", False, 0), ("domain_spread", True, 5),
    ("near_consumers", True, 0), ("node_spread", False, 6),
])
def test_locality_metrics_match_reference(data_file, placement, pin,
                                          consumer_pe):
    """A thread-backend session with a topology: the port's LocalityMetrics
    (same/cross-domain bytes and pieces, first-touched pages, pin outcomes,
    readers observed) equal the reference's for the same file and
    consumer, per session and merged into the Director's aggregate."""
    path, data = data_file
    n = 256 * 1024
    got, loc, agg, copied = _locality(CkIO, FileOptions, Topology, path, n,
                                      placement, pin, consumer_pe)
    jgot, jloc, jagg, jcopied = _locality(JCkIO, JFileOptions, JTopology,
                                          path, n, placement, pin,
                                          consumer_pe)
    assert got == jgot == data[:n]
    assert copied == jcopied == 0
    assert loc == jloc and agg == jagg == loc
    assert loc["same_domain_bytes"] + loc["cross_domain_bytes"] == n
    assert loc["prefault_pages"] >= n // numa.PAGE_BYTES


def test_locality_metrics_merge_and_summary():
    a, b = LocalityMetrics(), LocalityMetrics()
    a.record_delivery(100, True)
    a.record_splinter(0, 4096)
    a.record_prefault(3)
    a.record_pin(True)
    b.record_delivery(50, False)
    b.record_splinter(0, 8192)
    b.record_pin(False)
    a.merge(b)
    assert a.reader_splinter_sizes() == {0: [4096, 8192]}
    s = a.summary()
    assert (s["same_domain_bytes"], s["cross_domain_bytes"],
            s["prefault_pages"], s["pinned_threads"], s["pin_failures"]) == (
        100, 50, 3, 1, 1)
    assert s["cross_domain_fraction"] == pytest.approx(50 / 150)


# -- the setup gate ----------------------------------------------------------------
class _GatedReaders(BufferReaderSet):
    """Records when each reader thread finished its NUMA setup and when
    each steal was taken; thread 1's setup (first touch) is slow."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.setup_done = {}
        self.steal_times = []

    def _thread_setup(self, tid, nthreads):
        if tid == 1:
            time.sleep(0.3)
        super()._thread_setup(tid, nthreads)
        self.setup_done[tid] = time.perf_counter()

    def _next_splinter(self, tid, nthreads):
        sp = super()._next_splinter(tid, nthreads)
        if sp is not None and sp.reader % nthreads != tid:
            self.steal_times.append(time.perf_counter())
        return sp


@pytest.mark.parametrize("queue_depth", [0, 4], ids=["blocking", "async"])
def test_setup_gate_holds_steals_until_every_stripe_is_touched(
        data_file, queue_depth):
    """Thread 0 drains its stripe while thread 1 is still first-touching
    its own: the gate must keep thread 0 from stealing until every setup
    is done (a splinter read before its page-stride touch would be zeroed
    by it). Held in the blocking loop and in the async one."""
    path, data = data_file
    n = 512 * 1024
    sched = TaskScheduler(num_pes=2, pes_per_node=2)
    f = PosixFile.open(path)
    try:
        plan = plan_session(0, n, 2, splinter_bytes=32 * 1024)
        from repro_torch.core.buffers import ReaderOptions

        opts = ReaderOptions(
            splinter_bytes=32 * 1024, queue_depth=queue_depth,
            topology=Topology(num_pes=2, pes_per_node=2, domains_per_node=2),
            prefault_arena=True, delay_model=StallReader(1, 0.02))
        rs = _GatedReaders(f, plan, sched, [0, 1], opts)
        rs.start()
        assert rs.join(60)
        assert rs.stop(10)
        assert bytes(rs.view(0, n)) == data[:n]
        assert rs.steal_times, "thread 0 never stole: the case is vacuous"
        assert min(rs.steal_times) >= max(rs.setup_done.values())
        assert rs.locality.summary()["prefault_pages"] >= n // numa.PAGE_BYTES
    finally:
        f.close()
