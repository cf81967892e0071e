"""The port's (data, spatial, disp) mesh in one process on the CPU: the layout
rule against the JAX package's constrain_volume on the 8 virtual CPU
devices, make_mesh's rank layout against JAX's device layout, a mesh of one
process against the plain server, what a sharded volume refuses, and the
CLI's mesh flags (a lone process is told how many to start, the world
counts every axis). The multi-process forward is in tests/test_torch_port_mesh_ranks.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msnets_tpu.parallel import mesh as jax_mesh
from msnets_tpu_torch import cli
from msnets_tpu_torch.config import Config, MeshConfig, ModelConfig
from msnets_tpu_torch.models import MSGCNet, gcnet
from msnets_tpu_torch.models.layers import conv_head
from msnets_tpu_torch.parallel import mesh as pm
from msnets_tpu_torch.serve import StereoServer

MESHES = [(1, 2, 1), (1, 1, 2), (1, 2, 2), (1, 2, 4), (1, 4, 2), (2, 2, 2),
          (2, 1, 1), (4, 1, 2), (1, 8, 1), (1, 1, 8), (8, 1, 1)]
# JAX volumes [N, D, H, W, C]: divisible and not, blocks of 1, 2 and more
SHAPES = [(1, 16, 32, 64, 8), (1, 8, 16, 32, 16), (1, 4, 8, 16, 16),
          (1, 2, 4, 8, 32), (1, 1, 2, 4, 32), (2, 6, 12, 8, 4),
          (4, 3, 5, 7, 2), (2, 12, 6, 3, 1), (8, 32, 16, 8, 1),
          (1, 96, 192, 624, 8)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_spec(shape, mesh_shape):
    n = int(np.prod(mesh_shape))
    mesh = jax_mesh.make_mesh(mesh_shape, devices=jax.devices()[:n])
    x = jnp.zeros(shape, jnp.float32)
    with jax_mesh.active_mesh(mesh):
        # a new function each time: jit's cache would keep the first mesh
        spec = tuple(jax.jit(lambda v: jax_mesh.constrain_volume(v))(x)
                     .sharding.spec)
    return spec + (None,) * (5 - len(spec))


@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
def test_volume_layout_is_constrain_volumes(mesh_shape):
    """For each volume, the axis splitting N, D and H (port [N, C, D, H,
    W]) is the one JAX's constrain_volume puts on N, D and H ([N, D, H, W,
    C]); W and C are never split. (tests/conftest.py gives JAX 8 CPU
    devices.)"""
    for n, d, h, w, c in SHAPES:
        n_, _, d_, h_, w_ = pm.volume_layout((n, c, d, h, w), mesh_shape)
        assert (n_, d_, h_, w_, None) == _jax_spec((n, d, h, w, c), mesh_shape), \
            ((n, d, h, w, c), mesh_shape)
        assert pm.volume_layout((n, c, d, h, w), mesh_shape)[1] is None


@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
def test_rank_layout_is_jaxs_device_layout(mesh_shape):
    """Rank r sits where JAX's make_mesh puts device r."""
    n = int(np.prod(mesh_shape))
    mesh = jax_mesh.make_mesh(mesh_shape, devices=jax.devices()[:n])
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    np.testing.assert_array_equal(pm.rank_grid(mesh_shape), ids)
    for r in range(n):
        m = pm.Mesh(mesh_shape, r, {a: None for a in pm.AXES})
        assert pm.rank_grid(mesh_shape)[m.coords] == r
        assert m.num_devices == n


def _server_sd():
    m = MSGCNet(32, 8, 4, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        for bn in m.modules():
            if isinstance(bn, torch.nn.BatchNorm3d):
                bn.running_var.uniform_(0.5, 2.0)
    return m.state_dict()


def test_a_mesh_of_one_process_is_the_plain_server(monkeypatch):
    """make_mesh((1, 1, 1)) without a process group: nothing is split, no
    collective runs, and the server equals the plain one bit for bit once
    both run the head a mesh runs (a plain server's fused head is held to
    it in tests/test_torch_port_head.py); with its own head, within float32
    reassociation."""
    mesh = pm.make_mesh((1, 1, 1))
    assert mesh.group is None and mesh.coords == (0, 0, 0)
    cfg = Config(model=ModelConfig(max_disp=32, base_filters=4,
                                   compute_dtype="float32"))
    sd = _server_sd()
    rng = np.random.default_rng(1)
    iml, imr = (rng.integers(0, 256, (60, 120), dtype=np.uint8)
                for _ in range(2))
    fused = StereoServer(cfg, sd, device="cpu").predict(iml, imr)
    before = pm.collectives
    got = StereoServer(cfg, sd, device="cpu", mesh=mesh).predict(iml, imr)
    assert pm.collectives == before
    monkeypatch.setattr(gcnet, "subpixel_soft_argmin", conv_head)
    want = StereoServer(cfg, sd, device="cpu").predict(iml, imr)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(fused, want, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="does not lay out"):
        pm.make_mesh((1, 2, 1))


def test_sharded_volume_refuses_what_it_cannot_split():
    """Only the convs, ReLU and + of two like-split volumes are defined on a
    sharded volume; a block must have its layout's shape."""
    mesh = pm.Mesh((1, 1, 2), 0, {a: None for a in pm.AXES})
    x = pm.Sharded(torch.zeros(1, 2, 4, 3, 5), (1, 2, 8, 3, 5), mesh)
    assert x.spec == (None, None, "disp", None, None)
    assert (x + x).local.shape == (1, 2, 4, 3, 5)
    assert torch.nn.functional.relu(x).shape == x.shape
    with pytest.raises(TypeError, match="softmax"):
        torch.softmax(x, dim=1)
    with pytest.raises(TypeError, match="split differently"):
        torch.zeros(1, 2, 4, 3, 5) + x
    with pytest.raises(ValueError, match="want"):
        pm.Sharded(torch.zeros(1, 2, 8, 3, 5), (1, 2, 8, 3, 5), mesh)
    with pytest.raises(NotImplementedError, match="k3"):
        torch.nn.functional.conv3d(x, torch.zeros(2, 2, 1, 1, 1))


@pytest.mark.parametrize("mode", ["train", "loop-train"])
@pytest.mark.parametrize("mesh", ["1,2,1", "1,1,2", "2,2,2"])
def test_training_over_spatial_or_disp_raises(mode, mesh):
    """Training takes a mesh with spatial or disp above 1; one process
    started with it and no coordinator is told, before any process group
    forms, to start one per rank of the mesh. (The step over the mesh:
    tests/test_torch_port_mesh_train.py.)"""
    n = int(np.prod([int(x) for x in mesh.split(",")]))
    with pytest.raises(ValueError, match=f"wants {n} processes, but this one "
                       f"was started among 1. Start {n}: torchrun "
                       f"--nproc_per_node {n} -m msnets_tpu_torch.cli --mesh "
                       f"{mesh}"):
        cli.main([f"--mode={mode}", f"--mesh={mesh}"], device="cpu")


@pytest.mark.parametrize("mesh,world", [("1,2,2", 4), ("1,2,4", 8),
                                        ("2,1,1", 2), ("", 1)])
def test_launch_world_counts_every_axis(mesh, world):
    a = cli.build_parser().parse_args(["--mode=test", f"--mesh={mesh}",
                                       "--coordinator=localhost:1"])
    assert cli.launch_world(a, cli.parse_mesh(a.mesh)) == world
    if mesh:
        assert cli.parse_mesh(mesh) == MeshConfig(*map(int, mesh.split(",")))


def test_eval_mesh_without_its_processes_raises():
    """One process started with --mesh 1,2,2 and no coordinator: the
    message says how to start four."""
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4"):
        cli.main(["--mode=test", "--mesh=1,2,2", "--resume=x.tar"],
                 device="cpu")
