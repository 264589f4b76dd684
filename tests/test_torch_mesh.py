"""The port's mesh and multi-host layer against the JAX package, on the CPU:
``mesh_shape_for``, ``make_mesh`` (shape, axis names, devices, the raise
with no card), ``Mesh``'s JAX attributes, and ``multihost``
(``initialize``'s backend by device, its torchrun environment and its
single-process no-op, ``is_multiprocess``, ``global_mesh``'s layout).
The two-process run of ``multihost`` is in
``test_torch_distributed_streamed.py``.
"""
import datetime

import jax
import numpy as np
import pytest
import torch

from vpower_tpu.parallel import make_mesh as jmake_mesh
from vpower_tpu.parallel import mesh_shape_for as jmesh_shape_for
from vpower_tpu_torch.parallel import make_mesh, mesh_shape_for, multihost
from vpower_tpu_torch.parallel.mesh import Mesh

CPU = torch.device("cpu")


def test_mesh_shape():
    assert mesh_shape_for(8) == (4, 2)
    assert mesh_shape_for(16) == (4, 4)
    assert mesh_shape_for(4) == (2, 2)
    for n in range(1, 65):
        assert mesh_shape_for(n) == jmesh_shape_for(n), n


@pytest.mark.parametrize("n, shape", [(8, None), (8, (2, 4)), (6, None),
                                      (3, (3, 1)), (1, None)])
def test_make_mesh_matches_jax_layout(n, shape):
    """Shape, axis names, size and entry order as ``jax.sharding.Mesh``
    lays them out over the same number of devices."""
    cpus = [CPU] * 8
    got = make_mesh(n, shape=shape, devices=cpus)
    ref = jmake_mesh(n, shape=shape, devices=jax.devices()[:8])
    assert isinstance(got, Mesh)
    assert got.devices.shape == ref.devices.shape
    assert got.axis_names == ref.axis_names == ("x", "y")
    assert dict(got.shape) == dict(ref.shape)
    assert list(got.shape) == ["x", "y"]
    assert got.size == ref.size == n
    assert all(d == CPU for d in got.devices.reshape(-1))
    assert got.group is None and got.process_index == 0
    assert (got.process_ids == 0).all()


def test_make_mesh_devices_and_order():
    """Entries keep the order of ``devices`` (row-major over (x, y)); a
    device may repeat; strings are devices."""
    devs = [torch.device("cuda", i) for i in range(4)]
    mesh = make_mesh(devices=devs)
    assert mesh.devices.shape == (2, 2)
    assert list(mesh.devices.reshape(-1)) == devs
    mesh = make_mesh(devices=["cpu", "cpu"])
    assert mesh.devices.shape == (2, 1)
    assert list(mesh.devices.reshape(-1)) == [CPU, CPU]
    mesh = make_mesh(2, devices=devs)      # the first n_devices only
    assert list(mesh.devices.reshape(-1)) == devs[:2]


def test_make_mesh_rejects_bad_shapes():
    with pytest.raises(ValueError, match="cover n_devices exactly"):
        make_mesh(8, shape=(3, 3), devices=[CPU] * 8)
    with pytest.raises(ValueError, match="cover n_devices exactly"):
        make_mesh(8, devices=[CPU] * 4)


def test_make_mesh_defaults_to_cards_and_raises_without_one(monkeypatch):
    """With no ``devices`` the mesh spans the visible cards; with no card
    it raises instead of laying a mesh over the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_mesh(1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = make_mesh()
    assert mesh.devices.shape == (2, 1)
    assert list(mesh.devices.reshape(-1)) == [torch.device("cuda", 0),
                                              torch.device("cuda", 1)]


class _Recorder:
    """Stands in for ``torch.distributed.init_process_group``."""

    def __init__(self):
        self.calls = []

    def __call__(self, backend, **kw):
        self.calls.append((backend, kw))


@pytest.fixture
def fake_group(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(torch.distributed, "init_process_group", rec)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    return rec


@pytest.mark.parametrize("device, backend", [("cuda", "nccl"),
                                             ("cpu", "gloo"),
                                             (torch.device("cuda", 0),
                                              "nccl")])
def test_initialize_backend_follows_device(fake_group, device, backend):
    """``nccl`` on the card, ``gloo`` only for ``device="cpu"``; the
    coordinator, size and rank as given, with a timeout."""
    multihost.initialize("10.0.0.1:9999", num_processes=4, process_id=3,
                         device=device)
    (got, kw), = fake_group.calls
    assert got == backend
    assert kw["init_method"] == "tcp://10.0.0.1:9999"
    assert (kw["world_size"], kw["rank"]) == (4, 3)
    assert isinstance(kw["timeout"], datetime.timedelta)
    assert kw["timeout"].total_seconds() > 0


def test_initialize_default_device_is_the_card(fake_group):
    multihost.initialize("10.0.0.1:9999", num_processes=2, process_id=0)
    assert fake_group.calls[0][0] == "nccl"


def test_initialize_single_process_and_torchrun(fake_group, monkeypatch):
    """No coordinator and one process: nothing starts; torchrun's
    ``WORLD_SIZE`` above 1 starts the group from the environment; an
    incomplete multi-process call raises; an unknown device raises."""
    multihost.initialize(device="cpu")
    multihost.initialize(num_processes=1)
    monkeypatch.setenv("WORLD_SIZE", "1")
    multihost.initialize()
    assert fake_group.calls == []
    monkeypatch.setenv("WORLD_SIZE", "2")
    multihost.initialize(device="cpu")
    (backend, kw), = fake_group.calls
    assert backend == "gloo" and kw["init_method"] == "env://"
    assert "timeout" in kw
    with pytest.raises(ValueError, match="coordinator_address"):
        multihost.initialize("10.0.0.1:9999", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        multihost.initialize("10.0.0.1:9999", 2, 0, device="meta")


def test_initialize_is_a_noop_while_a_group_is_up(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(torch.distributed, "init_process_group", rec)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    multihost.initialize("10.0.0.1:9999", num_processes=2, process_id=0)
    assert rec.calls == []


def test_multihost_single_process_noop_and_mesh(monkeypatch):
    """Single-process ``initialize`` is a no-op; ``global_mesh`` lays the
    inner axis within the local entries, over the CPU or over the cards
    (a process's share of them under torchrun)."""
    for var in ("WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    multihost.initialize(device="cpu")
    assert not multihost.is_multiprocess()
    gm = multihost.global_mesh(device="cpu")
    assert gm.devices.shape == (1, 1) and gm.devices[0, 0] == CPU
    assert gm.group is None and gm.axis_names == ("x", "y")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    gm = multihost.global_mesh(inner=2, axis_names=("a", "b"))
    assert gm.devices.shape == (2, 2) and gm.axis_names == ("a", "b")
    assert list(gm.devices.reshape(-1)) == [torch.device("cuda", i)
                                            for i in range(4)]
    assert multihost.global_mesh().devices.shape == (1, 4)
    with pytest.raises(ValueError, match="inner axis"):
        multihost.global_mesh(inner=3)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    gm = multihost.global_mesh()
    assert list(gm.devices.reshape(-1)) == [torch.device("cuda", 2),
                                            torch.device("cuda", 3)]


def test_global_mesh_spans_every_process(monkeypatch):
    """Under a group of 3 processes, rank 1's mesh lays out every
    process's entries, process r holding entries r * n_local onward;
    only rank 1's are its own."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size",
                        lambda group=None: 3)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(torch.distributed, "group",
                        type("G", (), {"WORLD": "world"}))
    for var in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    gm = multihost.global_mesh()
    assert gm.devices.shape == (3, 2) and gm.group == "world"
    np.testing.assert_array_equal(gm.process_ids, [[0, 0], [1, 1], [2, 2]])
    assert gm.process_index == 1
    assert multihost.is_multiprocess()
    gm = multihost.global_mesh(inner=3)
    np.testing.assert_array_equal(gm.process_ids, [[0, 0, 1], [1, 2, 2]])
