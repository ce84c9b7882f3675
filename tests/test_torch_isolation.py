"""The port stands alone: no module of ``horovod_tpu_torch`` and not
``chip_smoke.py`` imports ``jax`` or anything of ``horovod_tpu``, nor
``ml_dtypes`` (the card's machine has none: the checkpoint format's bf16
goes through integer views), and its entry points refuse to fall back
to the CPU when CUDA is absent."""

import ast
from pathlib import Path

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import resnet as tres
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.parallel.train import (build_image_train_step,
                                              build_train_step)

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "horovod_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "ml_dtypes",
                   "horovod_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def test_scan_sees_the_package():
    names = {p.name for p in FILES}
    assert {"flash_attention.py", "transformer.py", "train.py",
            "fused_bn.py", "resnet.py", "probes.py", "shape_probe.py",
            "mem_probe.py", "flash_ablate_probe.py", "chip_smoke.py",
            "vgg.py", "inception.py", "mnist.py", "word2vec.py",
            "layers.py", "sync_bn.py", "loader.py", "prefetch.py",
            "sources.py", "sharding.py", "engine.py", "manifest.py",
            "reader.py", "writer.py", "fingerprint.py", "state.py",
            "failure.py", "checkpoint.py"} <= names


def test_scan_catches_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom horovod_tpu.ops import x\n"
                 "from horovod_tpu_torch import y\nimport ml_dtypes\n")
    assert [m for m in _imports(f) if _forbidden(m)] == [
        "jax.numpy", "horovod_tpu.ops", "ml_dtypes"]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hvd.shutdown()
    yield
    hvd.shutdown()


def test_init_without_cuda_raises(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hvd.init()
    assert not hvd.is_initialized()


def test_model_and_step_without_cuda_raise(no_cuda):
    cfg = tfm.TransformerConfig(vocab=16, d_model=16, n_layers=1, d_ff=16,
                                max_seq=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfm.Transformer(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_train_step(cfg, lambda p: torch.optim.SGD(p, lr=0.1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tres.ResNet([1], num_classes=4, num_filters=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tres.ResNet50(num_classes=1000, bn_impl="pallas")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_image_train_step(tres.ResNet50,
                               lambda p: torch.optim.SGD(p, lr=0.1))


def test_zoo_data_and_sync_bn_without_cuda_raise(no_cuda):
    """The conv zoo, word2vec's parameters, ``SyncBatchNorm`` and the
    prefetcher stay on the card unless the caller passes the CPU."""
    from horovod_tpu_torch import data
    from horovod_tpu_torch.data.sync_bn import SyncBatchNorm
    from horovod_tpu_torch.models import (InceptionV3, MnistConvNet, VGG,
                                          VGG16)
    from horovod_tpu_torch.models import word2vec
    small_vgg = dict(cfg=((1, 4),), num_classes=4, image_size=8)
    makers = [
        lambda **kw: VGG(**small_vgg, **kw),
        lambda **kw: VGG(**small_vgg, use_bn=True, bn_axis_name="dp", **kw),
        lambda **kw: InceptionV3(num_classes=4, **kw),
        lambda **kw: MnistConvNet(**kw),
        lambda **kw: tres.ResNet([1], num_classes=4, num_filters=8,
                                 bn_axis_name="dp", **kw),
        lambda **kw: SyncBatchNorm(4, **kw),
        lambda **kw: word2vec.init_params(16, 4, **kw),
        lambda **kw: data.prefetch_to_device(
            data.build_loader(data.synthetic("image", n=8, image_size=4),
                              batch_size=4, rank=0, world_size=1), **kw),
    ]
    for make in makers:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
        made = make(device="cpu")
        if hasattr(made, "close"):
            assert next(made).data[0].device.type == "cpu"
            made.close()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_image_train_step(VGG16, lambda p: torch.optim.SGD(p, lr=0.1))


def test_rank_before_init_raises(no_cuda):
    with pytest.raises(hvd.NotInitializedError):
        hvd.rank()
