"""The paper's workload over a mesh of ranks with the PyTorch/CUDA port:
distributed GEMM with the BLASX ring schedule (the L2-cache/overlap
insight on the interconnect).

Starts one process a rank (NCCL on the cards unless ``--device cpu``,
then gloo; the rendezvous is a ``file://`` store in a temp dir), builds
a (2, ranks / 2) (data, model) mesh, and compares the ring schedule with
the plain gspmd one: the same numerics against a host oracle from the
persistent-context API, neighbour hops in place of all-gathers.

Run:  PYTHONPATH=src python examples/torch_pod_gemm.py [--device cpu]
"""
import argparse
import os
import subprocess
import sys
import tempfile


def rank_main(rank, world, store, device):
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.api import BlasxContext
    from repro_torch.core import distributed as D
    from repro_torch.core.runtime import RuntimeConfig
    from repro_torch.launch.mesh import init_process_group, \
        make_mesh_for_devices

    init_process_group(device, init_method=store, rank=rank,
                       world_size=world)
    try:
        mp = world // 2 if world % 2 == 0 else world
        mesh = make_mesh_for_devices(world, mp, device=device)
        rng = np.random.default_rng(0)
        A = rng.standard_normal((512, 1024)).astype(np.float32)
        B = rng.standard_normal((1024, 768)).astype(np.float32)
        want = None
        if rank == 0:
            # host-side oracle through the persistent-context API (the
            # tiled engine whose L2/overlap insight the ring ports)
            with BlasxContext(RuntimeConfig(device=device), tile=256) as ctx:
                want = np.array(ctx.gemm(A.astype(np.float64),
                                         B.astype(np.float64)).array(),
                                dtype=np.float32)
        a, b = (torch.from_numpy(x).to(device) for x in (A, B))
        for mode in ("gspmd", "ring"):
            D.reset_collectives()
            out = D.distributed_gemm(a, b, mesh, mode=mode)
            counts = dict(D.COLLECTIVES)
            if rank == 0:
                err = np.abs(out.cpu().numpy() - want).max()
                print(f"{mode:6s} max|err|={err:.2e} on a "
                      f"{tuple(mesh.shape)} mesh: "
                      f"all-gathers={counts['all_gather']} "
                      f"all-reduces={counts['all_reduce']} "
                      f"p2p hops={counts['p2p']}", flush=True)
            dist.barrier()
        if rank == 0:
            print("\nring mode: panels circulate the ring (neighbour P2P, "
                  "the paper's L2 tile cache) with the next hop posted "
                  "before each matmul (the paper's stream overlap).")
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="NCCL on the cards (default) or gloo on the CPU")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks to start (default: the cards present, "
                         "8 on the CPU)")
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args.rank, args.ranks, args.store, args.device)
        return 0
    ranks = args.ranks
    if ranks is None:
        import torch
        ranks = 8 if args.device == "cpu" else torch.cuda.device_count()
    if ranks < 1:
        print("torch_pod_gemm: no card found (--device cpu runs it on the "
              "CPU)", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--device", args.device, "--ranks",
             str(ranks), "--rank", str(r), "--store", f"file://{tmp}/store"],
            env=dict(os.environ, LOCAL_RANK=str(r), OMP_NUM_THREADS="1"))
            for r in range(ranks)]
        rcs = [p.wait() for p in procs]
    return 0 if not any(rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
