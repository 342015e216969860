"""The port's host runtime (parsec_tpu_torch): device selection at init,
the PTG runtime path, termination detection, scheduling, staging, and
the package's independence from JAX."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import parsec_tpu_torch as parsec
from parsec_tpu_torch.core.task import DeviceType, HookReturn
from parsec_tpu_torch.core.reshape import ReshapeSpec
from parsec_tpu_torch.data import LocalCollection
from parsec_tpu_torch.device.base import Device
from parsec_tpu_torch.dsl import ptg
from parsec_tpu_torch.ops import precision
from parsec_tpu_torch.termdet import LocalTermdet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cpu_ctx():
    c = parsec.init(nb_cores=3, device="cpu")
    c.start()
    yield c
    parsec.fini(c)


def _chain(n, A, fail_at=None):
    """T(0) reads A(0); T(k) folds its predecessor's value +1; T(n-1)
    writes A(1)."""
    tp = ptg.Taskpool("chain", N=n, A=A)
    T = tp.task_class(
        "T", params=("k",), space=lambda g: range(g.N),
        flows=[ptg.FlowSpec(
            "X", ptg.RW,
            ins=[ptg.In(data=lambda g, k: (g.A, (0,)),
                        guard=lambda g, k: k == 0),
                 ptg.In(src=("T", lambda g, k: (k - 1,), "X"),
                        guard=lambda g, k: k > 0)],
            outs=[ptg.Out(dst=("T", lambda g, k: (k + 1,), "X"),
                          guard=lambda g, k: k < g.N - 1),
                  ptg.Out(data=lambda g, k: (g.A, (1,)),
                          guard=lambda g, k: k == g.N - 1)])])

    @T.body
    def body(task, X):
        if task.locals[0] == fail_at:
            raise ValueError("injected body failure")
        assert isinstance(X, torch.Tensor)
        return X + 1

    return tp


def test_init_default_device_is_cuda():
    """init() runs on the card: without one it raises rather than
    continuing on the CPU."""
    if torch.cuda.is_available():
        c = parsec.init(nb_cores=1)
        try:
            assert c.torch_device.type == "cuda"
            assert c.devices.by_type(DeviceType.CUDA)
        finally:
            parsec.fini(c)
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            parsec.init(nb_cores=1)


def test_init_cpu_registers_no_cuda_device(cpu_ctx):
    assert cpu_ctx.torch_device == torch.device("cpu")
    assert cpu_ctx.devices.by_type(DeviceType.CUDA) == []
    [cpu] = cpu_ctx.devices.devices
    assert cpu.device_type == DeviceType.CPU and cpu.weight == 1.0
    with pytest.raises(ValueError, match="unsupported device"):
        parsec.init(nb_cores=1, device="meta")


@pytest.mark.parametrize("n", [1, 5, 40])
def test_ptg_chain_runs_and_terminates(cpu_ctx, n):
    A = LocalCollection("A", {(0,): np.zeros(4, np.float32), (1,): None})
    tp = _chain(n, A)
    ptg.check_taskpool(tp)
    cpu_ctx.add_taskpool(tp)
    assert cpu_ctx.wait(timeout=60)
    assert tp.completed and tp.nb_tasks == 0
    out = A.data_of((1,))
    assert isinstance(out, torch.Tensor)
    np.testing.assert_array_equal(out.numpy(), np.full(4, n, np.float32))
    # the numpy read was staged once and written back as a tensor
    assert isinstance(A.data_of((0,)), torch.Tensor)
    assert sum(es.stats["executed"] for es in cpu_ctx.streams) >= n


def test_failing_body_aborts_wait_instead_of_hanging(cpu_ctx):
    A = LocalCollection("A", {(0,): np.zeros(2, np.float32), (1,): None})
    cpu_ctx.add_taskpool(_chain(6, A, fail_at=2))
    with pytest.raises(RuntimeError, match="injected body failure"):
        cpu_ctx.wait(timeout=60)
    # the context stays usable for the next taskpool
    B = LocalCollection("B", {(0,): np.zeros(2, np.float32), (1,): None})
    cpu_ctx.add_taskpool(_chain(3, B))
    assert cpu_ctx.wait(timeout=60)
    np.testing.assert_array_equal(B.data_of((1,)).numpy(), [3, 3])


def test_many_independent_tasks_overflow_and_steal(cpu_ctx):
    """More startup tasks than lfq's local bound: the overflow goes to
    the system queue and every task still runs exactly once."""
    n = 300
    seen = []
    lock = threading.Lock()
    tp = ptg.Taskpool("flat", N=n)
    W = tp.task_class("W", params=("k",), space=lambda g: range(g.N),
                      flows=[])

    @W.body
    def body(task):
        with lock:
            seen.append(task.locals[0])

    cpu_ctx.add_taskpool(tp)
    assert cpu_ctx.wait(timeout=60)
    assert sorted(seen) == list(range(n))


def test_stage_read_makes_tensors_on_context_device(cpu_ctx):
    dc = LocalCollection("D", {(0,): np.arange(3.0)})
    v = cpu_ctx.stage_read(dc, (0,), dc.data_of((0,)))
    assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
    assert dc.data_of((0,)) is v
    assert cpu_ctx.stage_read(dc, (0,), v) is v
    assert cpu_ctx.stage_read(dc, (0,), None) is None


def test_device_for_prefers_weighted_accelerator(cpu_ctx):
    """The registry's least (load+1)/weight choice: a heavier device of a
    matching type wins over the CPU, and never for a CPU-only chore."""

    class FakeAccel(Device):
        device_type = DeviceType.CUDA
        name = "fake"

        def execute(self, es, task, chore):
            return HookReturn.DONE

    reg = cpu_ctx.devices
    fake = reg.add(FakeAccel())
    fake.weight = 100.0
    try:
        assert reg.device_for(DeviceType.ALL, None) is fake
        assert reg.device_for(DeviceType.CPU, None) is reg.devices[0]
        assert fake.load == 1.0
        fake.release_load()
        assert fake.load == 0.0
    finally:
        reg.devices.remove(fake)


def test_termdet_startup_deficit_carries():
    """A completion that races set_nb_tasks carries as a deficit (the
    `_counted` startup window); after counting, negatives raise."""
    fired = []
    m = LocalTermdet()
    m.monitor(lambda: fired.append(True))
    m.addto_nb_tasks(-1)
    m.set_nb_tasks(3)
    assert m.nb_tasks == 2 and not fired
    m.addto_nb_tasks(-2)
    assert fired == [True]
    with pytest.raises(RuntimeError, match="negative"):
        m.addto_nb_tasks(-1)


def test_matmul_precision_sets_both_tf32_flags():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        parsec.mca_param.set("ops.matmul_precision", "default")
        assert precision.apply_matmul_precision() == "default"
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        parsec.mca_param.set("ops.matmul_precision", "highest")
        assert precision.apply_matmul_precision() == "highest"
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        parsec.mca_param.unset("ops.matmul_precision")
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_reshape_spec_on_tensors():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    out = ReshapeSpec(dtype=torch.float64, transpose=True).apply(t)
    assert out.dtype == torch.float64 and out.shape == (3, 2)


def test_port_imports_neither_jax_nor_the_reference():
    code = ("import sys, parsec_tpu_torch\n"
            "import parsec_tpu_torch.algorithms.transformer\n"
            "import parsec_tpu_torch.algorithms.potrf\n"
            "import parsec_tpu_torch.compiled.panels\n"
            "import parsec_tpu_torch.compiled.wavefront\n"
            "import parsec_tpu_torch.data.matrix\n"
            "import parsec_tpu_torch.ops.tile_kernels\n"
            "import parsec_tpu_torch.ops.flash_attention\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'parsec_tpu' or "
            "m.startswith('parsec_tpu.')]\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _repo_trace(mod):
    """Drive the usage-limit + retain protocol of a DataRepo module and
    record what is alive after each step."""
    repo = mod.DataRepo(nb_flows=2)
    out = []
    ent = repo.lookup_or_create(("T", 1))
    ent.set(1, "v")
    out.append((len(repo), ent.get(1)))
    repo.lookup_or_create(("T", 1))              # second retain
    repo.entry_addto_usage_limit(("T", 1), 2)
    out.append(len(repo))
    repo.entry_used_once(("T", 1))
    repo.entry_used_once(("T", 1))
    out.append(len(repo))
    repo.entry_addto_usage_limit(("T", 1), 0)    # last retain dropped
    out.append(len(repo))
    return out


def test_datarepo_protocol_matches_reference():
    from parsec_tpu.core import datarepo as ref_repo
    from parsec_tpu_torch.core import datarepo as port_repo
    assert _repo_trace(port_repo) == _repo_trace(ref_repo)
    assert _repo_trace(port_repo)[-1] == 0


def test_data_versions_and_coherency_match_reference():
    from parsec_tpu.data import data as ref_data
    from parsec_tpu_torch.data import data as port_data

    def trace(mod):
        d = mod.Data(("A", 0))
        d.attach_copy(0, "host")
        d.write(1, "dev")
        d.write(1, "dev2")
        cp0, cp1 = d.get_copy(0), d.get_copy(1)
        return (d.version, int(cp0.coherency), int(cp1.coherency),
                cp1.version, d.newest_copy().value)

    assert trace(port_data) == trace(ref_data) == (2, 0, 2, 2, "dev2")
