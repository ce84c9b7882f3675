"""The CUDA probe kernels against their plain PyTorch versions on the card.

These need an NVIDIA Hopper GPU and ``nvcc``; without a card they skip.
On a machine with one (the repo's conftest imports JAX, so leave it out):

    python -m pytest --noconftest -m cuda tests/test_torch_probes_cuda.py

Tolerances: copy and addone exact; stats-like within 1e-4 of sum |terms|
per channel, and two calls bit-identical; the flash ablation's stream
within 1 bf16 ulp, matmul and nosoft within 1e-2 of max |plain| (fp32
sums in another order, then one bf16 rounding), and the non-causal
matmul within 1e-2 of the library chain bmm(bmm(q, k^T), v).
"""

import pytest
import torch

from horovod_tpu_torch.experiments import bf16_ulp
from horovod_tpu_torch.ops import probes

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from horovod_tpu_torch.ops import _build
    _build.library()
    torch.backends.cuda.matmul.allow_tf32 = False


def _randn(seed, *shape):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(*shape, generator=g, device="cuda",
                       dtype=torch.bfloat16)


@pytest.mark.parametrize("m,c,bm", [(4096, 256, 512), (1024, 2048, 8),
                                    (2048, 64, 2048), (96, 8, 32)])
def test_copy_and_addone_are_exact(cuda_kernels, m, c, bm):
    x = _randn(m + c, m, c) * 8
    assert torch.equal(probes.copy_cuda(x, bm), x)
    assert torch.equal(probes.addone_cuda(x, bm), probes.addone_reference(x))


@pytest.mark.parametrize("m,c,bm", [(8192, 256, 1024), (4096, 256, 16),
                                    (1024, 264, 64)])
def test_stats_like_matches_plain_and_repeats_bit_for_bit(cuda_kernels, m, c,
                                                          bm):
    x = _randn(m * c, m, c) + 0.5
    got = probes.stats_like_cuda(x, bm)
    again = probes.stats_like_cuda(x, bm)
    want = probes.stats_like_reference(x, bm)
    xf = x.float()
    mag = (xf.abs() + xf * xf).sum(0, keepdim=True)
    assert got.shape == (1, c)
    assert float(((got - want).abs() / mag).max()) <= 1e-4
    assert torch.equal(got, again)


@pytest.mark.parametrize("tile", probes.CUDA_TILES)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mode", probes.MODES)
def test_ablate_matches_plain(cuda_kernels, mode, causal, d, tile):
    bh, s = 3, 512
    q, k, v = (_randn(seed + d, bh, s, d) for seed in (1, 2, 3))
    got = probes.ablate_cuda(q, k, v, mode, causal, tile, tile)
    want = probes.ablate_reference(q, k, v, mode, causal, tile, tile).float()
    diff = (got.float() - want).abs()
    if mode == "stream":
        assert bool((diff <= bf16_ulp(want)).all())
    else:
        assert float(diff.max()) <= 1e-2 * float(want.abs().max())


def test_matmul_matches_the_bmm_chain(cuda_kernels):
    q, k, v = (_randn(seed, 4, 1024, 128) for seed in (7, 8, 9))
    got = probes.ablate_cuda(q, k, v, "matmul", False, 64, 64).float()
    want = torch.bmm(torch.bmm(q, k.transpose(1, 2)), v).float()
    assert float((got - want).abs().max()) <= 1e-2 * float(want.abs().max())


def test_wrappers_count_launches_and_refuse_what_they_do_not_take(
        cuda_kernels):
    probes.reset_launch_counts()
    q = _randn(0, 2, 128, 64)
    probes.flash_ablate(q, q, q, "nosoft", True, 64, 64)
    probes.stats_like(q.view(-1, 64), 32)
    assert probes.launch_counts()["flash_ablate_nosoft"] == 1
    assert probes.launch_counts()["probe_stats_like"] == 1
    with pytest.raises(ValueError, match="square tiles"):
        probes.ablate_cuda(q, q, q, "matmul", True, 32, 32)
    with pytest.raises(ValueError, match="ragged"):
        probes.ablate_cuda(q[:, :100].contiguous(), q[:, :100].contiguous(),
                           q[:, :100].contiguous(), "matmul", True, 64, 64)
    with pytest.raises(TypeError):
        probes.copy_cuda(q.view(-1, 64).float(), 16)
    with pytest.raises(ValueError, match="multiple of 8"):
        probes.copy_cuda(_randn(1, 64, 12), 16)
    assert sum(probes.launch_counts().values()) == 2
