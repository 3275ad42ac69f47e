"""Batched serving with the PyTorch/CUDA port: continuous-batching
inference with demand-driven slot admission (the BLASX scheduling
insight applied to request scheduling: free slots pull work, no
head-of-line blocking).  The model runs on the card unless
``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import argparse

from repro_torch.launch.serve import ServeConfig, run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model runs (default: the card)")
    args = ap.parse_args(argv)
    out = run(ServeConfig(
        arch="olmo_1b", smoke=True,
        batch_slots=4, prompt_len=12, max_len=48,
        requests=10, max_new=12, device=args.device,
    ))
    print(f"served {out['requests']} requests / {out['tokens']} tokens "
          f"in {out['wall_s']:.2f}s -> {out['tok_per_s']:.1f} tok/s "
          f"({out['steps']} batched decode steps)")
    for rid, toks in sorted(out["outputs"].items())[:3]:
        print(f"  req {rid}: {toks}")


if __name__ == "__main__":
    main()
