"""The port's restart supervisor and seeded fault injection against the
reference's.

The supervisor on a smoke phi4-mini with two injected faults at step 5
counts what the reference's counts, and its params are bit-equal to an
unbroken run of the port (CPU; the replay reads the checkpoint file, in
the reference's layout). A kernel or CUDA error is not retried. The fault
plan derives the reference's injection points from a seed, and the thread
backend absorbs its I/O faults."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.core import CkIO as JCkIO  # noqa: E402
from repro.core import FileOptions as JFileOptions  # noqa: E402
from repro.core.faults import FaultPlan as JFaultPlan  # noqa: E402
from repro.ipc.worker import WorkerCrashed as JWorkerCrashed  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.train import AsyncCheckpointer as JAsyncCheckpointer  # noqa: E402
from repro.train import FaultInjected as JFaultInjected  # noqa: E402
from repro.train import OptConfig as JOptConfig  # noqa: E402
from repro.train import StepSupervisor as JStepSupervisor  # noqa: E402
from repro.train import init_opt_state as jinit_opt  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.core import CkIO, FileOptions  # noqa: E402
from repro_torch.core.faults import FaultPlan  # noqa: E402
from repro_torch.ipc.worker import WorkerCrashed  # noqa: E402
from repro_torch.kernels.reassemble import KernelError, check_rc  # noqa: E402
from repro_torch.launch.train import make_supervisor  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import from_reference  # noqa: E402
from repro_torch.train import (  # noqa: E402
    AsyncCheckpointer,
    FaultInjected,
    OptConfig,
    StepSupervisor,
    init_opt_state,
    leaves,
    make_train_step,
)

OPT = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=50)
STEPS, FAULT_STEP, CKPT_EVERY = 8, 5, 3


def _batch(step: int, vocab: int):
    t = np.random.default_rng(100 + step).integers(
        0, vocab, size=(2, 17)).astype(np.int32)
    return t[:, :-1], t[:, 1:]


def _two_faults_at(step: int, exc):
    left = {"n": 2}

    def hook(s):
        if s == step and left["n"] > 0:
            left["n"] -= 1
            raise exc("node died")

    return hook


def test_supervisor_matches_reference_and_an_unbroken_run(tmp_path):
    jcfg = jsmoke(jget_config("phi4-mini-3.8b"))
    tcfg = smoke_config(get_config("phi4-mini-3.8b"))
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jstep = jax.jit(jmake_train_step(jm, JOptConfig(**OPT)))

    def jstep_fn(state, batch):
        p, o, m = jstep(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, m

    jsup = JStepSupervisor(jstep_fn, JAsyncCheckpointer(str(tmp_path / "j"),
                                                        keep=2),
                           ckpt_every=CKPT_EVERY, max_retries=3)
    jsup.run({"params": jp, "opt": jinit_opt(jp)},
             lambda s: dict(zip(("tokens", "labels"), _batch(s, jcfg.vocab_size))),
             STEPS, fault_hook=_two_faults_at(FAULT_STEP, JFaultInjected))
    jsup.ckpt.shutdown()

    tstep = make_train_step(build_model(tcfg), OptConfig(**OPT))
    tbatch = lambda s: {k: torch.from_numpy(v) for k, v in zip(  # noqa: E731
        ("tokens", "labels"), _batch(s, tcfg.vocab_size))}
    p0 = jax.tree.map(np.asarray, jp)

    def fresh():
        params = from_reference(p0, tcfg, device="cpu")
        return {"params": params, "opt": init_opt_state(params)}

    def tstep_fn(state, batch):
        p, o, m = tstep(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, m

    losses = {}
    sup = make_supervisor(tstep_fn, tcfg, str(tmp_path / "t"),
                          ckpt_every=CKPT_EVERY, keep=2)
    ck = sup.ckpt
    state = sup.run(fresh(), tbatch, STEPS,
                    fault_hook=_two_faults_at(FAULT_STEP, FaultInjected),
                    on_metrics=lambda s, m: losses.setdefault(s, []).append(
                        float(m["loss"])))
    ck.shutdown()
    got = (sup.stats.failures, sup.stats.restores, sup.stats.steps_run)
    assert got == (jsup.stats.failures, jsup.stats.restores,
                   jsup.stats.steps_run) == (2, 2, 12)
    assert len(sup.stats.restore_times) == 2
    assert state["opt"]["step"] == STEPS
    assert ck.list_steps() == [6, 8]

    unbroken = fresh()
    for s in range(STEPS):
        unbroken, m = tstep_fn(unbroken, tbatch(s))
        # steps 4 and 5 ran three times, from the step-3 checkpoint
        assert losses[s + 1] == [float(m["loss"])] * (3 if s in (3, 4) else 1)
    for key in ("params", "opt"):
        for a, b in zip(jax.tree.leaves(state[key]),
                        jax.tree.leaves(unbroken[key])):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_restore_overwrites_a_half_written_step_in_place(tmp_path):
    """A fault inside a step, after AdamW has written the params and
    moments in place: the restore writes the file's values into the same
    tensors (no second copy of the state), and the run ends bit-equal to an
    unbroken one."""
    tcfg = smoke_config(get_config("phi4-mini-3.8b"))
    tstep = make_train_step(build_model(tcfg), OptConfig(**OPT))
    tbatch = lambda s: {k: torch.from_numpy(v) for k, v in zip(  # noqa: E731
        ("tokens", "labels"), _batch(s, tcfg.vocab_size))}

    def fresh():
        params = build_model(tcfg).init(0, device="cpu")
        return {"params": params, "opt": init_opt_state(params)}

    left = [1]

    def faulty(state, batch):
        p, o, m = tstep(state["params"], state["opt"], batch)
        if left[0] and o["step"] == 4:
            left[0] = 0
            raise FaultInjected("node died after the optimizer wrote step 4")
        return {"params": p, "opt": o}, m

    def tensors(st):
        return [t for k in ("params", "mu", "nu")
                for t in leaves(st[k] if k == "params" else st["opt"][k])]

    state = fresh()
    live = [t.data_ptr() for t in tensors(state)]
    sup = make_supervisor(faulty, tcfg, str(tmp_path / "c"), ckpt_every=2)
    out = sup.run(state, tbatch, 6)
    sup.ckpt.shutdown()
    assert (sup.stats.failures, sup.stats.restores, sup.stats.steps_run) == (
        1, 1, 7)
    assert [t.data_ptr() for t in tensors(out)] == live
    unbroken = fresh()
    for s in range(6):
        p, o, _ = tstep(unbroken["params"], unbroken["opt"], tbatch(s))
        unbroken = {"params": p, "opt": o}
    assert out["opt"]["step"] == unbroken["opt"]["step"] == 6
    for a, b in zip(tensors(out), tensors(unbroken)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("every", [2, 3])
def test_final_save_is_not_written_twice(tmp_path, every):
    """The forced last save is skipped when ``ckpt_every`` has just saved
    that step; the files on disk are those the reference leaves."""
    _, ck, state, step = _trivial(tmp_path, "port")
    ck.keep = 5
    sup = StepSupervisor(step, ck, ckpt_every=every)
    sup.run(state, lambda s: None, 6)
    ck.shutdown()
    assert [r["step"] for r in ck.records] == [0, *range(every, 7, every)]
    jsup_cls, jck, jstate, jstep = _trivial(tmp_path, "reference")
    jck.keep = 5
    jsup_cls(jstep, jck, ckpt_every=every).run(jstate, lambda s: None, 6)
    jck.shutdown()
    assert ck.list_steps() == jck.list_steps()


def _trivial(tmp_path, pkg):
    """A supervisor of either package over a one-leaf state."""
    if pkg == "port":
        state = {"x": torch.zeros(())}
        step = lambda st, b: ({"x": st["x"] + 1}, {})  # noqa: E731
        return StepSupervisor, AsyncCheckpointer(str(tmp_path / pkg), keep=1), state, step
    state = {"x": jnp.zeros(())}
    step = lambda st, b: ({"x": st["x"] + 1}, {})  # noqa: E731
    return JStepSupervisor, JAsyncCheckpointer(str(tmp_path / pkg), keep=1), state, step


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_supervisor_gives_up_after_max_retries(tmp_path, pkg):
    sup_cls, ck, state, step = _trivial(tmp_path, pkg)
    exc = FaultInjected if pkg == "port" else JFaultInjected

    def always_fail(s):
        raise exc("persistent failure")

    sup = sup_cls(step, ck, ckpt_every=1, max_retries=2)
    with pytest.raises(RuntimeError, match="2 consecutive retries exhausted"):
        sup.run(state, lambda s: None, 3, fault_hook=always_fail)
    assert (sup.stats.failures, sup.stats.restores) == (3, 2)
    ck.shutdown()


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_worker_crash_counts_reader_failure_and_recovers_input(tmp_path, pkg):
    sup_cls, ck, state, step = _trivial(tmp_path, pkg)
    crashed = WorkerCrashed if pkg == "port" else JWorkerCrashed
    recovered, left = [], {"n": 1}

    def batches(s):
        if s == 2 and left["n"]:
            left["n"] -= 1
            raise crashed("reader worker 1 died")
        return None

    sup = sup_cls(step, ck, ckpt_every=2, input_recover=recovered.append)
    out = sup.run(state, batches, 4)
    assert recovered == [2]
    assert (sup.stats.failures, sup.stats.reader_failures,
            sup.stats.restores, sup.stats.steps_run) == (1, 1, 1, 4)
    assert float(out["x"]) == 4.0
    ck.shutdown()


def _raiser(exc):
    def raise_it():
        raise exc
    return raise_it


@pytest.mark.parametrize("raise_it", [
    lambda: check_rc(700, "reassemble_window"),
    _raiser(torch.AcceleratorError(
        "CUDA error: an illegal memory access was encountered")),
    _raiser(RuntimeError("CUDA error: misaligned address")),
    _raiser(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")),
], ids=["kernel", "accelerator", "cuda_runtime", "out_of_memory"])
def test_device_errors_propagate_with_no_restore(tmp_path, raise_it):
    sup_cls, ck, state, step = _trivial(tmp_path, "port")

    def step_fn(st, batch):
        if float(st["x"]) == 1.0:
            raise_it()
        return step(st, batch)

    sup = StepSupervisor(step_fn, ck, ckpt_every=1, max_retries=3)
    with pytest.raises(RuntimeError) as info:
        sup.run(state, lambda s: None, 3)
    assert not isinstance(info.value, FaultInjected)
    assert (sup.stats.failures, sup.stats.restores, sup.stats.steps_run) == (0, 0, 1)
    ck.shutdown()


def test_kernel_error_is_a_runtime_error_with_the_message_of_before():
    with pytest.raises(KernelError, match=r"^window: CUDA error 1 at launch$"):
        check_rc(1, "window")
    assert issubclass(KernelError, RuntimeError)
    check_rc(0, "window")


def test_a_plain_runtime_error_is_still_restored(tmp_path):
    sup_cls, ck, state, step = _trivial(tmp_path, "port")
    left = {"n": 1}

    def step_fn(st, batch):
        if float(st["x"]) == 1.0 and left["n"]:
            left["n"] -= 1
            raise RuntimeError("collective timed out")
        return step(st, batch)

    sup = StepSupervisor(step_fn, ck, ckpt_every=1)
    out = sup.run(state, lambda s: None, 3)
    assert (sup.stats.failures, sup.stats.restores) == (1, 1)
    assert float(out["x"]) == 3.0
    ck.shutdown()


@pytest.mark.parametrize("seed", [0, 1, 7, 20260809, 2**31 - 1])
@pytest.mark.parametrize("layout", [(2, 16), (4, 64), (1, 1)])
def test_fault_plan_describe_matches_reference(seed, layout):
    readers, splinters = layout
    kw = dict(crash=True, stall=True, short_reads=True, flaky_io=True,
              torn_slots=True, num_readers=readers, num_splinters=splinters)
    got = FaultPlan(seed, **kw)
    want = JFaultPlan(seed, **kw)
    assert got.describe() == want.describe()
    assert repr(got.io_fault()) == repr(want.io_fault())
    assert repr(got.worker_fault()) == repr(want.worker_fault())
    assert repr(got.delay_model()) == repr(want.delay_model())
    assert repr(got.ring_fault()) == repr(want.ring_fault())


@pytest.mark.parametrize("seed", [3, 20260809])
def test_thread_backend_absorbs_the_plans_io_faults(tmp_path, seed):
    data = np.random.default_rng(seed).integers(
        0, 256, 1 << 20, dtype=np.uint8).tobytes()
    path = str(tmp_path / "blob.bin")
    with open(path, "wb") as f:
        f.write(data)
    plan = dict(flaky_io=True, short_reads=True)
    got = {}
    for name, ck_cls, opts_cls, plan_cls in (
            ("port", CkIO, FileOptions, FaultPlan),
            ("reference", JCkIO, JFileOptions, JFaultPlan)):
        ck = ck_cls(num_pes=2)
        fh = ck.open_sync(path, opts_cls(num_readers=2,
                                         splinter_bytes=128 * 1024,
                                         fault_plan=plan_cls(seed, **plan)))
        sess = ck.start_read_session_sync(fh, len(data), 0, timeout=120)
        got[name] = bytes(ck.read_sync(sess, len(data), 0, timeout=120))
        assert sess.metrics.recovery.io_retries > 0, name
        ck.close_read_session_sync(sess)
        ck.close_sync(fh)
    assert got["port"] == got["reference"] == data


def test_an_explicit_hook_wins_over_the_plan():
    from repro_torch.core.faults import FlakyEIO, StallReader

    explicit = FlakyEIO(every=9)
    opts = FileOptions(io_fault=explicit, fault_plan=FaultPlan(
        5, flaky_io=True, short_reads=True, stall=True)).reader_options()
    assert opts.io_fault is explicit
    assert isinstance(opts.delay_model, StallReader)
    # worker and ring hooks act in reader worker processes: set explicitly
    # they win over the plan's, as the I/O hook does
    crash, torn = FaultPlan(7).worker_fault(), FaultPlan(
        7, torn_slots=True).ring_fault()
    opts = FileOptions(worker_fault=crash, ring_fault=torn,
                       fault_plan=FaultPlan(5, torn_slots=True)
                       ).reader_options()
    assert opts.worker_fault is crash and opts.ring_fault is torn
    planned = FileOptions(fault_plan=FaultPlan(5, torn_slots=True)
                          ).reader_options()
    assert planned.worker_fault is not None
    assert planned.ring_fault is not None
    for bad in (dict(recovery="retry"), dict(fallback_backend="process")):
        with pytest.raises(ValueError):
            FileOptions(**bad).reader_options()
