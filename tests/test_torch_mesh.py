"""The port's mesh helper and topology against the JAX package.

``MeshSpec.resolve`` against the JAX ``MeshSpec.resolve`` for the same
specs (values and errors); ``mesh()``/``hierarchical_mesh()`` at world
size 1 in this process; and one 4-rank gloo job with
``LOCAL_WORLD_SIZE=2`` (two nodes of two ranks) that checks the rank,
size and local invariants of ``tests/test_topology.py``, the flat
``('dp',)`` and the ``('dcn', 'ici')`` meshes, which axes cross nodes
(with the ``HOROVOD_TPU_DCN_AXES`` override), and sums over the
hierarchical mesh's groups. The job has a time limit of its own.
"""

import os
import socket
import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel import mesh as tmesh

JOB_TIMEOUT_S = 180

SPECS = [({"dp": -1}, 8), ({"dp": 2, "tp": 4}, 8), ({"dp": -1, "tp": 2}, 8),
         ({"dcn": 2, "ici": -1}, 4), ({"dp": 3, "tp": -1}, 9),
         ({"dp": 1}, 1), ({"dp": 3}, 8), ({"dp": -1, "tp": 3}, 8),
         ({"dp": -1, "tp": -1}, 4), ({"dp": 2, "tp": 2}, 8)]


def _resolve(cls, axes, n):
    try:
        return cls.of(**axes).resolve(n)
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("axes,n", SPECS, ids=lambda v: str(v))
def test_meshspec_resolve_matches_jax(axes, n):
    from horovod_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    assert _resolve(tmesh.MeshSpec, axes, n) == _resolve(JaxMeshSpec, axes, n)


def test_world_one_meshes():
    hvd.init(device="cpu")
    m, h = hvd.mesh(), hvd.hierarchical_mesh()
    assert m.mesh_dim_names == ("dp",) and m.mesh.tolist() == [0]
    assert h.mesh_dim_names == ("dcn", "ici") and h.mesh.tolist() == [[0]]
    assert hvd.mesh() is m
    assert tmesh.axis_kinds(h) == {"dcn": "ici", "ici": "ici"}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, port, outdir):
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    os.environ.pop("LOCAL_RANK", None)
    hvd.init(device="cpu", init_method=f"tcp://localhost:{port}", rank=rank,
             world_size=4)
    out = {"rank": hvd.rank(), "size": hvd.size(),
           "local_rank": hvd.local_rank(), "local_size": hvd.local_size(),
           "process_rank": hvd.process_rank(),
           "process_count": hvd.process_count()}
    m, h = hvd.mesh(), hvd.hierarchical_mesh()
    out["flat"] = (m.mesh_dim_names, m.mesh.tolist())
    out["hier"] = (h.mesh_dim_names, h.mesh.tolist())
    out["kinds_flat"] = tmesh.axis_kinds(m)
    out["kinds_hier"] = tmesh.axis_kinds(h)
    out["dcn_axes"], out["ici_axes"] = tmesh.dcn_axes(h), tmesh.ici_axes(h)
    hybrid = tmesh.create_mesh(dp=2, tp=-1)
    out["kinds_hybrid"] = tmesh.axis_kinds(hybrid)
    os.environ["HOROVOD_TPU_DCN_AXES"] = "ici"
    out["kinds_forced"] = tmesh.axis_kinds(h)
    del os.environ["HOROVOD_TPU_DCN_AXES"]
    for axis in ("dcn", "ici"):
        x = torch.tensor([float(rank)])
        dist.all_reduce(x, group=h.get_group(axis))
        out[f"sum_{axis}"] = float(x)
    # The engine still agrees on an op after the meshes' groups exist.
    out["allreduce"] = float(hvd.allreduce(torch.tensor([float(rank)]),
                                           average=False, name="mesh.sum"))
    hvd.shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh4")
    ctx = mp.spawn(_worker, args=(_free_port(), str(d)), nprocs=4,
                   join=False)
    deadline = time.monotonic() + JOB_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the 4-rank job did not finish within "
                        f"{JOB_TIMEOUT_S} s")
    return [torch.load(d / f"rank{r}.pt") for r in range(4)]


def test_four_ranks_topology_invariants(four_ranks):
    for r, out in enumerate(four_ranks):
        assert (out["rank"], out["size"]) == (r, 4)
        assert (out["local_rank"], out["local_size"]) == (r % 2, 2)
        assert (out["process_rank"], out["process_count"]) == (r, 4)
        assert out["rank"] // out["local_size"] == r // 2   # its node


def test_four_ranks_meshes(four_ranks):
    for out in four_ranks:
        assert out["flat"] == (("dp",), [0, 1, 2, 3])
        assert out["hier"] == (("dcn", "ici"), [[0, 1], [2, 3]])


def test_four_ranks_axis_kinds(four_ranks):
    for out in four_ranks:
        assert out["kinds_flat"] == {"dp": "dcn"}
        assert out["kinds_hier"] == {"dcn": "dcn", "ici": "ici"}
        assert (out["dcn_axes"], out["ici_axes"]) == (("dcn",), ("ici",))
        assert out["kinds_hybrid"] == {"dp": "dcn", "tp": "ici"}
        assert out["kinds_forced"] == {"dcn": "dcn", "ici": "dcn"}


def test_four_ranks_mesh_groups(four_ranks):
    for r, out in enumerate(four_ranks):
        node, local = divmod(r, 2)
        assert out["sum_ici"] == 2 * node + (2 * node + 1)
        assert out["sum_dcn"] == local + (2 + local)
        assert out["allreduce"] == 6.0
