"""`repro_torch.launch.mesh`: importing it touches no process group;
``make_debug_mesh`` over a gloo world of 8 ranks, and
``make_production_mesh``'s shapes and dim names (the JAX package's:
(16, 16) ``("data", "model")`` and (2, 16, 16) ``("pod", "data",
"model")``) over ``"fake"`` process groups of 256 and 512 ranks, each in
a subprocess of its own (a process has one default group)."""
import os
import subprocess
import sys
import textwrap

import torch.distributed as dist

from torch_world import run_world

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _run(code: str) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_import_touches_no_process_group():
    import repro_torch.launch.mesh as mesh
    assert callable(mesh.make_production_mesh)
    assert callable(mesh.make_debug_mesh)
    assert not dist.is_initialized()


def debug_world(rank, world, inputs):
    from repro_torch.launch.mesh import make_debug_mesh
    m = make_debug_mesh(2, 4, device_type="cpu")
    return {"shape": tuple(m.shape), "names": m.mesh_dim_names,
            "coord": list(m.get_coordinate()), "size": m.size()}


def test_debug_mesh_over_a_gloo_world(tmp_path):
    got = run_world(8, "test_torch_mesh:debug_world", str(tmp_path),
                    timeout=120)
    assert got == {"shape": (2, 4), "names": ("data", "model"),
                   "coord": [0, 0], "size": 8}


def test_production_meshes_under_fake_groups():
    out = _run("""
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.launch.mesh import make_production_mesh
        for multi, world in ((False, 256), (True, 512)):
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=world)
            m = make_production_mesh(multi_pod=multi, device_type="cpu")
            print(tuple(m.shape), m.mesh_dim_names, m.size())
            dist.destroy_process_group()
    """)
    assert out.splitlines() == [
        "(16, 16) ('data', 'model') 256",
        "(2, 16, 16) ('pod', 'data', 'model') 512"]
