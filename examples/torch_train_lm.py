"""End-to-end training with the PyTorch/CUDA port: a qwen3-family model
for a few hundred steps with checkpointing, resume and metrics, through
the same launch stack a mesh uses.

With ``--mesh DxM`` the example starts D x M ranks (NCCL on the cards,
gloo with ``--device cpu``; the rendezvous is a ``file://`` store in a
temp dir) on a (data, model) mesh: each rank trains on its rows of every
global batch and holds its blocks of the parameters, gradients and AdamW
moments (FSDP on "data", tensor-parallel on "model").  The model runs on
the card unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 200]
          [--device cpu] [--mesh 2x2]
"""
import argparse
import os
import subprocess
import sys
import tempfile


def train(args, use_mesh=False, model_parallel=1):
    from repro_torch.launch.train import TrainConfig, run
    return run(TrainConfig(
        arch="qwen3_0_6b",
        smoke=True,               # reduced config; raise dims for ~100M
        steps=args.steps,
        seq_len=128,
        global_batch=8,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=50,
        log_every=20,
        lr=1e-3,
        use_mesh=use_mesh,
        model_parallel=model_parallel,
        device=args.device,
    ))


def report(out):
    print(f"\nloss: {out['first_loss']:.4f} -> {out['last_loss']:.4f} "
          f"({out['final_step']} steps, last ckpt @ {out['last_ckpt']})")
    assert out["last_loss"] < out["first_loss"], "training must learn"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temp dir)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model trains (default: the card)")
    ap.add_argument("--mesh", default=None,
                    help="DxM: train on a (data, model) mesh of D x M ranks")
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        args.ckpt_dir = args.ckpt_dir or os.path.join(tmp, "ckpt")
        if args.mesh is None:
            report(train(args))
            return 0
        data, model = (int(v) for v in args.mesh.lower().split("x"))
        world = data * model
        if args.rank is not None:
            from repro_torch.launch.mesh import init_process_group
            init_process_group(args.device, init_method=args.store,
                               rank=args.rank, world_size=world)
            out = train(args, use_mesh=True, model_parallel=model)
            if args.rank == 0:
                report(out)
            return 0
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--steps", str(args.steps),
             "--ckpt-dir", args.ckpt_dir, "--device", args.device, "--mesh",
             args.mesh, "--rank", str(r), "--store",
             f"file://{tmp}/store"],
            env=dict(os.environ, LOCAL_RANK=str(r), OMP_NUM_THREADS="1"))
            for r in range(world)]
        rcs = [p.wait() for p in procs]
    return 0 if not any(rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
