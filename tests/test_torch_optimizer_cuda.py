"""The blockwise wire and the bucketed DistributedOptimizer on the card.

These need an NVIDIA GPU; without one they skip. On a machine with one
(the repo's conftest imports JAX, so leave it out):

    python -m pytest --noconftest -m cuda tests/test_torch_optimizer_cuda.py

Tolerance 0 everywhere: the wire's functions on the card against the
same functions on CPU copies; a blockwise allreduce through the engine
(NCCL, world size 1) against its closed form; a model's gradients
bucketed, on gradient views and per tensor, whose hooks fire on
autograd's device thread, against each other.
"""

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import quantization as tq

pytestmark = pytest.mark.cuda

SIZES = [256, 1000, 65536 + 7, 4_000_000]
SPECS = ["int8x256", "fp8x256", "int8x64"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture
def nccl_world(card):
    hvd.init()
    yield
    hvd.shutdown()


def _wide(n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(n, generator=g, device="cuda")
            * torch.exp(3 * torch.randn(n, generator=g, device="cuda")))


def _bits(t):
    t = t.cpu().contiguous()
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _same(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("n", SIZES)
def test_quantizer_on_card_equals_cpu(card, n, spec, folded):
    s = tq.parse(spec)
    x = _wide(tq.padded_size(n, s.block_size), n)
    q, sc = tq.quantize_blocks(x, s, folded)
    qc, scc = tq.quantize_blocks(x.cpu(), s, folded)
    assert _same(q, qc) and _same(sc, scc)
    assert _same(tq.dequantize_blocks(q, sc, s),
                 tq.dequantize_blocks(qc, scc, s))
    assert _same(tq.local_roundtrip(x[:n - 3], s),
                 tq.local_roundtrip(x[:n - 3].cpu(), s))


@pytest.mark.parametrize("n", SIZES)
def test_e4m3_casts_and_fma_on_card_equal_cpu(card, n):
    y = _wide(n, 7) * 100          # some magnitudes past ±448
    q = tq.to_e4m3fn(y)
    assert _same(q, tq.to_e4m3fn(y.cpu()))
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        assert _same(tq.from_e4m3fn(q, dt), tq.from_e4m3fn(q.cpu(), dt))
    a, b, c = _wide(n, 1), _wide(n, 2), _wide(n, 3)
    assert _same(tq._fma(a, b, c), tq._fma(a.cpu(), b.cpu(), c.cpu()))


@pytest.mark.parametrize("name", ["int8_blockwise", "fp8_blockwise"])
@pytest.mark.parametrize("n", [1000, 4_000_000 + 1])
def test_blockwise_allreduce_at_one_rank_is_the_closed_form(nccl_world, n,
                                                            name):
    comp = getattr(hvd.Compression, name)
    s = tq.parse(comp.wire_spec)
    x = _wide(n, 11)
    want = torch.cat([x.cpu(), torch.zeros(tq.padded_size(n, 256) - n)])
    want = tq.dequantize_blocks(*tq.quantize_blocks(want, s, True), s) + 0.0
    want = tq.dequantize_blocks(*tq.quantize_blocks(want, s, True), s)
    got = hvd.allreduce(x, compression=comp, name=f"closed.{name}.{n}")
    assert _same(got, want[:n])


def _model():
    torch.manual_seed(0)
    return torch.nn.Sequential(
        torch.nn.Linear(512, 1024), torch.nn.GELU(),
        torch.nn.Linear(1024, 1024), torch.nn.GELU(),
        torch.nn.Linear(1024, 10)).cuda()


def _grads(compression, steps=2, **kw):
    model = _model()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01),
        named_parameters=model.named_parameters(),
        compression=compression, **kw)
    g = torch.Generator(device="cuda").manual_seed(5)
    for _ in range(steps):
        opt.zero_grad()
        x = torch.randn(64, 512, generator=g, device="cuda")
        model(x).square().mean().backward()
        opt.step()
    torch.cuda.synchronize()
    return [p.grad.clone() for p in model.parameters()], opt


@pytest.mark.parametrize("name", ["none", "fp16", "int8_blockwise"])
def test_buckets_views_and_per_tensor_agree_on_card(nccl_world, name):
    comp = getattr(hvd.Compression, name)
    bucketed, opt = _grads(comp, bucket_cap_mb=2)
    assert len(opt._buckets) > 1
    assert opt.bucket_fires == {"hook": 2 * len(opt._buckets), "flush": 0}
    views, vopt = _grads(comp, bucket_cap_mb=2, gradient_as_bucket_view=True)
    assert all(a.equal(b) for a, b in zip(bucketed, views))
    if name != "int8_blockwise":    # blocks span tensors in a bucket
        per_tensor, _ = _grads(comp, bucket_cap_mb=0)
        assert all(a.equal(b) for a, b in zip(bucketed, per_tensor))
    if name != "fp16":
        assert len(vopt._grad_views) == 6
