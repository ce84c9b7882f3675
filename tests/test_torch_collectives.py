"""The port's topology, collectives and DistributedOptimizer over gloo:
world size 1 in this process, and one two-rank job in spawned processes
that checks the collectives' arithmetic and that two ranks with half a
batch each train exactly like one rank with the whole batch."""

import socket
import threading

import pytest
import torch
import torch.multiprocessing as mp

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.parallel.train import build_train_step


@pytest.fixture(autouse=True)
def _port_initialized():
    hvd.init(device="cpu")
    yield


def test_world_one_topology():
    assert hvd.is_initialized()
    assert (hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size(),
            hvd.process_count()) == (0, 1, 0, 1, 1)
    assert hvd.get_topology().backend == "gloo"
    assert hvd.device() == torch.device("cpu")


@pytest.mark.parametrize("average", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64])
def test_world_one_allreduce(average, dtype):
    x = torch.arange(12).reshape(3, 4).to(dtype)
    out = hvd.allreduce(x, average=average)
    assert out.dtype == dtype and torch.equal(out, x)
    assert out.data_ptr() != x.data_ptr()


def test_world_one_async_handles():
    h = hvd.allreduce_async(torch.ones(4), name="h.one")
    g = hvd.allgather_async(torch.arange(3), name="h.two")
    b = hvd.broadcast_async(torch.full((2,), 5.0), 0, name="h.three")
    assert torch.equal(hvd.synchronize(h), torch.ones(4))
    assert torch.equal(g.wait(), torch.arange(3))
    assert torch.equal(b.wait(), torch.full((2,), 5.0))
    assert hvd.poll(h) and hvd.poll(g) and hvd.poll(b)


def test_duplicate_in_flight_name_raises(monkeypatch):
    # The engine frees a name when it executes the op, within a cycle of
    # 1 ms; a gate holds the first "dup" in flight, as
    # tests/test_ops.py::test_duplicate_name_error does.
    eng = hvd.ops.collective.engine()
    gate = threading.Event()
    execute = eng._execute

    def gated(group):
        gate.wait(30)
        return execute(group)

    monkeypatch.setattr(eng, "_execute", gated)
    h = hvd.allreduce_async(torch.ones(2), name="dup")
    try:
        with pytest.raises(ValueError, match="same name"):
            hvd.allreduce_async(torch.ones(2), name="dup")
    finally:
        gate.set()
    h.wait()
    hvd.allreduce_async(torch.ones(2), name="dup").wait()   # free again


@pytest.mark.parametrize("root", [-1, 1, 7])
def test_out_of_range_root_raises(root):
    with pytest.raises(ValueError, match="root rank"):
        hvd.broadcast(torch.ones(2), root)


def test_grouped_allreduce_and_compression():
    ts = [torch.randn(5), torch.randn(2, 3), torch.arange(4)]
    outs = hvd.grouped_allreduce(ts)
    for a, b in zip(outs, ts):
        assert a.dtype == b.dtype and torch.equal(a, b)
    x = torch.randn(16)
    out = hvd.allreduce(x, compression=hvd.Compression.bf16)
    assert out.dtype == torch.float32
    assert torch.equal(out, x.to(torch.bfloat16).float())


def test_fusion_buffers_cut_at_threshold(monkeypatch):
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "16")
    ts = [torch.ones(4), torch.full((4,), 2.0), torch.arange(2),
          torch.ones(1)]
    h = hvd.ops.collective.fused_allreduce_async(ts, name="cut")
    for a, b in zip(h.wait(), ts):
        assert torch.equal(a, b)
    # Each fp32 tensor would overflow the open 16-byte fp32 group, so
    # each opens its own; the int64 tensor has a group of its dtype.
    assert h.groups == [("cut.0",), ("cut.1",), ("cut.2",), ("cut.3",)]


def test_world_one_inplace_ops_land_in_their_input():
    x = torch.arange(6.0)
    assert hvd.allreduce_(x, average=False) is x
    assert torch.equal(x, torch.arange(6.0))
    ys = [torch.full((3,), 2.0), torch.ones(2, dtype=torch.bfloat16)]
    hs = [hvd.allreduce_async_(y, name=f"ip.{i}") for i, y in enumerate(ys)]
    outs = hvd.synchronize_many(hs)
    assert all(o is y for o, y in zip(outs, ys))
    w = torch.nn.Parameter(torch.ones(4))       # requires grad
    assert hvd.broadcast_(w, 0) is w
    h = hvd.broadcast_async_(torch.zeros(2), 0)
    assert torch.equal(h.wait(), torch.zeros(2))


@pytest.mark.parametrize("name", ["int8_blockwise", "fp8_blockwise"])
def test_world_one_blockwise_allreduce_is_the_closed_form(name):
    """At one rank the wire quantizes twice: dequant(quant(0 + dequant(
    quant(x)))) with the wire's quantizer, in the input's dtype."""
    from horovod_tpu_torch import quantization as tq
    comp = getattr(hvd.Compression, name)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(700, generator=gen) * torch.exp(3 * torch.randn(
        700, generator=gen))
    spec = tq.parse(comp.wire_spec)
    for dtype in (torch.float32, torch.bfloat16):
        want = torch.cat([x.to(dtype).float(), torch.zeros(68)])
        # Phase 1 accumulates from zero (so -0 becomes +0), phase 2 not.
        for zero in (0.0, None):
            want = tq.dequantize_blocks(*tq.quantize_blocks(
                want, spec, folded=True), spec)
            want = want if zero is None else want + zero
        got = hvd.allreduce(x.to(dtype), compression=comp, name=name)
        assert got.dtype == dtype
        assert torch.equal(got, want[:700].to(dtype))


def test_allreduce_gradients_structure():
    grads = {"a": torch.ones(3), "b": torch.full((2, 2), 2.0)}
    out = hvd.allreduce_gradients(grads)
    assert set(out) == {"a", "b"} and torch.equal(out["b"], grads["b"])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_rank_worker(rank, port):
    hvd.shutdown()
    hvd.init(device="cpu", init_method=f"tcp://localhost:{port}", rank=rank,
             world_size=2)
    assert (hvd.rank(), hvd.size()) == (rank, 2)

    x = torch.tensor([1.0, 2.0]) * (rank + 1)
    assert torch.equal(hvd.allreduce(x, average=False),
                       torch.tensor([3.0, 6.0]))
    assert torch.equal(hvd.allreduce(x), torch.tensor([1.5, 3.0]))
    assert torch.equal(hvd.allreduce(torch.tensor([3, 4]) * (rank + 1)),
                       torch.tensor([4, 6]))
    assert torch.equal(hvd.broadcast(x, 1), torch.tensor([2.0, 4.0]))
    y = x.clone()
    assert hvd.allreduce_(y, average=False) is y
    assert torch.equal(y, torch.tensor([3.0, 6.0]))
    assert torch.equal(hvd.broadcast_(y, 0), torch.tensor([3.0, 6.0]))
    assert torch.equal(hvd.broadcast_async_(x.clone(), 1).wait(),
                       torch.tensor([2.0, 4.0]))
    ragged = hvd.allgather(torch.full((rank + 1, 2), float(rank)))
    assert torch.equal(ragged, torch.tensor([[0.0, 0.0], [1.0, 1.0],
                                             [1.0, 1.0]]))
    assert hvd.broadcast_object({"from": rank}, 1) == {"from": 1}

    cfg = tfm.TransformerConfig(vocab=32, d_model=16, n_heads=2, n_layers=1,
                                d_ff=32, max_seq=8, dtype=torch.float32,
                                remat=False)
    step = build_train_step(cfg, lambda p: torch.optim.Adam(p, lr=1e-2),
                            device="cpu")
    # Different draws per rank; broadcast_parameters makes them rank 0's.
    model = step.make_model(generator=torch.Generator().manual_seed(rank))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    ref = tfm.Transformer(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    for a, b in zip(model.parameters(), ref.parameters()):
        assert torch.equal(a, b)
    opt = step.make_optimizer(model)
    ref_opt = torch.optim.Adam(ref.parameters(), lr=1e-2)

    tok = torch.randint(0, 32, (4, 9), generator=torch.Generator()
                        .manual_seed(3))
    tokens, targets = tok[:, :-1], tok[:, 1:]
    mine = slice(2 * rank, 2 * rank + 2)
    for _ in range(2):
        loss = step(model, opt, tokens[mine], targets[mine])
        ref_opt.zero_grad()
        ref_loss = ref.loss_fn(tokens, targets)
        ref_loss.backward()
        ref_opt.step()
        torch.testing.assert_close(loss, ref_loss.detach(), rtol=1e-5,
                                   atol=1e-6)
    for a, b in zip(model.parameters(), ref.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)

    # Optimizer state: rank 1 drops its state and takes rank 0's.
    if rank == 1:
        opt.state.clear()
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    for p, rp in zip(model.parameters(), ref.parameters()):
        torch.testing.assert_close(opt.state[p]["exp_avg"],
                                   ref_opt.state[rp]["exp_avg"], rtol=1e-5,
                                   atol=1e-7)
    hvd.shutdown()


def test_two_ranks_gloo():
    mp.spawn(_two_rank_worker, args=(_free_port(),), nprocs=2, join=True)
