"""The meshes' NCCL groups on the card.

Marked ``cuda``: the test needs an NVIDIA card and skips without one
(decided inside the test, never at import).  Run it on the machine with
the card:
    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_mesh.py
"""
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import init_process_group, make_mesh_for_devices

pytestmark = pytest.mark.cuda


def test_every_mesh_axis_runs_on_a_high_priority_stream(tmp_path):
    """A hop or a gather posted under a product must get SMs before the
    product's waiting blocks: each axis' NCCL group of a card mesh runs
    its kernels on a high-priority stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    init_process_group("cuda", init_method=f"file://{tmp_path}/store",
                       rank=0, world_size=1)
    try:
        mesh = make_mesh_for_devices(1, 1, device="cuda")
        for axis in ("data", "model"):
            nccl = mesh.get_group(axis)._get_backend(torch.device("cuda"))
            assert nccl.options.is_high_priority_stream, axis
    finally:
        dist.destroy_process_group()
