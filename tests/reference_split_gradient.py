"""The reference's own f32 split-gradient spread, on the CPU: a measurement
script (not collected by pytest) for the question whether a batch's
gradient taken as the mean of its row blocks' moves in f32 because of the
model or because of the port.

The reference's Mamba2 at full width (the published config) and
``--layers`` depth, one batch of 8 x 1024 tokens from the port's data
pipeline (seed 0), its weights from its own init (key 0), in f32:

* ``ref_split``: its gradient as the mean of its 4 row blocks' against
  its whole-batch gradient (both jitted ``jax.grad`` of its chunked-CE
  loss), normwise a leaf;
* ``ref_f64`` / ``ref_split_f64``: each of the two against the exact
  gradient of the same weights, the port's float64 model (every sum in
  float64; the reference casts to float32 inside its norms and its SSD
  scan, so it has no float64 of its own), on the same batch;
* ``ref_x64``: the reference's whole-batch gradient with
  ``jax_enable_x64`` and its weights widened to float64 (its matmuls in
  float64, its float32 casts kept) against the f32 one;
* ``port_f64`` / ``port_split_f64``: the port's own f32 gradient, whole
  and as the 4 blocks' mean, from the same tree on the same batch,
  against the exact one: the port beside the reference on one CPU.

``--chunk`` cuts the f32 runs' SSD chunk (default 8): at the published
256 (the exact run's, EXACT_CHUNK), and at 32, the reference's f32 scan
overflows ``exp`` above the diagonal before it masks, and its gradient
is NaN (ROADMAP's recorded differences); the chunk changes the order of
the scan's sums, not the function.  Each
framework runs in a process of its own, one after the other (the
reference's gradients pass through an ``.npz`` in a temp dir), so the
peak is one model's:

  PYTHONPATH=src python tests/reference_split_gradient.py --layers 2
  PYTHONPATH=src python tests/reference_split_gradient.py --layers 4

prints one JSON line ``{"reference_split": {...}}`` a depth, each
distance's largest leaf and every leaf's.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

ARCH, SEQ, BATCH, BLOCKS = "mamba2_780m", 1024, 8, 4
# the exact gradient's SSD chunk: the published one (the port masks the
# decay before ``exp``, so no chunk overflows; the chunk changes only the
# order of float64 sums)
EXACT_CHUNK = 256


def batch():
    from repro_torch.data import DataConfig, batch_at_step
    from repro_torch.configs import get_config
    dc = DataConfig(get_config(ARCH).vocab_size, SEQ, BATCH, seed=0)
    return {k: v for k, v in batch_at_step(dc, 0).items()
            if k in ("tokens", "labels")}


def reference(layers: int, chunk: int, out: str) -> None:
    """The reference's gradients (whole, block mean, x64 whole) and its
    tree, as float32/float64 numpy arrays in ``out``."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_config
    from repro.launch.steps import _chunked_ce
    from repro.models import Model
    from repro.models.sharding import NO_MESH

    jax.config.update("jax_enable_x64", True)
    cfg = dataclasses.replace(get_config(ARCH), n_layers=layers,
                              dtype="float32", ssm_chunk=chunk, remat=True)
    model = Model(cfg, NO_MESH)
    params = model.init(jax.random.PRNGKey(0))

    def loss(p, tokens, labels):
        hidden, _ = model.train_logits(p, tokens=tokens, return_hidden=True)
        return _chunked_ce(hidden, model.head_matrix(p), labels, NO_MESH)

    grad = jax.jit(jax.grad(loss))
    b = batch()
    tok, lab = (jnp.asarray(b[k], jnp.int32) for k in ("tokens", "labels"))
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    arrays = {"tree" + k: v for k, v in flat(params).items()}
    arrays.update({"whole" + k: v for k, v in
                   flat(grad(params, tok, lab)).items()})
    rows = BATCH // BLOCKS
    parts = [flat(grad(params, tok[i * rows:(i + 1) * rows],
                       lab[i * rows:(i + 1) * rows])) for i in range(BLOCKS)]
    arrays.update({"split" + k: sum(p[k].astype(np.float64) for p in parts)
                   / BLOCKS for k in parts[0]})
    wide = jax.tree.map(lambda a: a.astype(jnp.float64), params)
    arrays.update({"x64" + k: v for k, v in
                   flat(grad(wide, tok, lab)).items()})
    np.savez(out, **arrays)


def port_f64(layers: int, chunk: int, out: str) -> dict:
    """The port's float64 gradient of the reference's tree on the same
    batch, and every distance."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import NO_MESH
    from repro_torch.tree import keystr, tree_flatten, tree_unflatten

    arrays = np.load(out)
    cfg = dataclasses.replace(get_config(ARCH), n_layers=layers,
                              dtype="float64", ssm_chunk=EXACT_CHUNK,
                              remat=True)
    grad_step, model = steps.make_grad_step(cfg, NO_MESH)
    paths, _ = tree_flatten(model.placements())
    params = tree_unflatten(paths, [torch.from_numpy(
        arrays["tree" + keystr(p)]).double() for p in paths])
    b = {k: torch.from_numpy(v) for k, v in batch().items()}
    exact = dict(zip(map(keystr, paths),
                     tree_flatten(grad_step(params, b)[0])[1]))
    # the port in f32 from the same tree: whole, and the 4 blocks' mean
    grad32, _ = steps.make_grad_step(dataclasses.replace(
        cfg, dtype="float32", ssm_chunk=chunk), NO_MESH)
    narrow = tree_unflatten(paths, [torch.from_numpy(
        arrays["tree" + keystr(p)]) for p in paths])
    port = {"port_whole": dict(zip(map(keystr, paths), tree_flatten(
        grad32(narrow, b)[0])[1]))}
    rows = BATCH // BLOCKS
    split = [torch.zeros_like(g, dtype=torch.float64)
             for g in port["port_whole"].values()]
    for i in range(BLOCKS):
        part = {n: v[i * rows:(i + 1) * rows] for n, v in b.items()}
        for acc, g in zip(split, tree_flatten(grad32(narrow, part)[0])[1]):
            acc.add_(g.double(), alpha=1 / BLOCKS)
    port["port_split"] = dict(zip(map(keystr, paths), split))

    def rel(got, want):
        got, want = torch.as_tensor(got).double(), torch.as_tensor(want)
        return float((got - want).norm() / want.norm())

    def got(name, k):
        return (port[name][k] if name in port
                else torch.from_numpy(arrays[name + k]))

    row = {"layers": layers, "ssm_chunk": chunk, "batch": [BATCH, SEQ]}
    for name, (a, b_) in {
            "ref_split": ("split", "whole"), "ref_f64": ("whole", None),
            "ref_split_f64": ("split", None), "ref_x64": ("x64", "whole"),
            "port_f64": ("port_whole", None),
            "port_split_f64": ("port_split", None)}.items():
        row[name + "_by_leaf"] = {
            k: rel(got(a, k), exact[k] if b_ is None else got(b_, k))
            for k in exact}
        row[name + "_max"] = max(row[name + "_by_leaf"].values())
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--part", choices=("reference", "port"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--npz", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.part == "reference":
        reference(args.layers, args.chunk, args.npz)
        return 0
    if args.part == "port":
        print(json.dumps({"reference_split": port_f64(
            args.layers, args.chunk, args.npz)}), flush=True)
        return 0
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "ref.npz")
        for part in ("reference", "port"):
            subprocess.run([sys.executable, __file__, "--layers",
                            str(args.layers), "--chunk", str(args.chunk),
                            "--part", part, "--npz", npz], env=env,
                           check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
