"""Twins of ``test_distributed.py`` for the port's ``core/distributed.py``,
plus the meshes' rules and the model's sharded branches.

The reference runs its rings as ``shard_map`` over 8 forced host
devices; the port runs one process a rank, so these checks run in gloo
ranks on the CPU (``torch_ranks.run_ranks``), grouped into a few spawns
that write their results for the tests to read.  The rings are held
against the f64 numpy oracle and the port's gspmd mode at the
reference's tolerances; not against the reference's ring mode, which
fails on this tree (``kernels/pallas_compat.py``'s ``shard_map``).
The reference's own gspmd ``tp_matmul`` and ``MeshRules`` run in a jax
subprocess with 8 forced host devices, and the port is held against
them.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from torch_ranks import REPO, run_ranks

# the reference's tolerances (test_distributed.py)
GEMM_TOL = 1e-3           # f32 distributed GEMM vs the oracle, max abs
TP_TOL = 5e-3             # f32 column-then-row tp_matmul, max abs
TOL = {"float64": 1e-5, "float32": 1e-3, "bfloat16": 1.0}

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "1x8": ((1, 8), ("data", "model")),
          "8x1": ((8, 1), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# (shape, logical axes): odd vocab, few kv heads, ragged batch, experts
RULE_CASES = [((8, 64), ("batch", "seq")), ((3, 64), ("batch", "seq")),
              ((151936, 64), ("model", "embed")), ((64, 6), ("embed", "kv")),
              ((16, 32, 8), ("expert", "embed", None)),
              ((7, 5, 6), ("batch", "seq", "model")),
              ((64, 128), ("embed", "model")), ((4,), ("batch",))]
LOGICAL = ("batch", "seq", "embed", "model", "expert", "kv", None)

RULES_BODY = """
def rules_record(rules, mesh_names):
    rec = {"physical": {str(lg): rules.physical(lg) for lg in LOGICAL},
           "axis_size": {a: rules.axis_size(a) for a in mesh_names},
           "batch_axes_size": rules.axis_size(rules.batch_axes),
           "divides": {b: rules.batch_size_divides(b)
                       for b in (1, 2, 3, 4, 8, 16)},
           "spec": [list(rules.spec(*lg)) for _, lg in RULE_CASES],
           "fitted": [list(rules.fitted_sharding(s, *lg).spec)
                      for s, lg in RULE_CASES]}
    return json.loads(json.dumps(rec))
"""


# ------------------------------------------------------------ the port
PORT_8 = f"""
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.core import distributed as D
from repro_torch.launch import mesh as M
from repro_torch.models.sharding import rules_for_mesh
from repro_torch.optim import adamw
MESHES = {MESHES!r}
RULE_CASES = {RULE_CASES!r}
LOGICAL = {LOGICAL!r}
{RULES_BODY}
mesh = M.make_mesh_for_devices(model_parallel=4, device="cpu")
ring = init_device_mesh("cpu", (8,), mesh_dim_names=("r",))
R = {{}}
f64 = lambda t: t.double().numpy()

def gemm_case(A, B, mode):
    D.reset_collectives()
    C = D.distributed_gemm(A, B, mesh, mode=mode)
    return f64(C), dict(D.COLLECTIVES)

# test_distributed_gemm_ring_matches_oracle
rng = np.random.default_rng(0)
A = torch.tensor(rng.standard_normal((64, 128)), dtype=torch.float32)
B = torch.tensor(rng.standard_normal((128, 96)), dtype=torch.float32)
for mode in ("ring", "gspmd"):
    R["gemm", mode], R["gemm_coll", mode] = gemm_case(A, B, mode)
R["gemm_want"] = f64(A) @ f64(B)

# test_tp_matmul_column_row_roundtrip
rng = np.random.default_rng(0)
x = torch.tensor(rng.standard_normal((2, 32, 128)), dtype=torch.float32)
w1 = torch.tensor(rng.standard_normal((128, 256)), dtype=torch.float32)
w2 = torch.tensor(rng.standard_normal((256, 128)), dtype=torch.float32)
for mode in ("ring", "gspmd"):
    D.reset_collectives()
    y = D.tp_matmul(x, w1, mesh, kind="column", mode=mode)
    R["tp_y", mode] = tuple(y.shape)
    R["tp", mode] = f64(D.tp_matmul(y, w2, mesh, kind="row", mode=mode))
    R["tp_coll", mode] = dict(D.COLLECTIVES)
R["tp_want"] = (f64(x) @ f64(w1)) @ f64(w2)

# tp_matmul where the model ring (4) does not divide W's columns or rows
for kind, w in (("column", w1[:, :7]), ("row", torch.zeros((7, 128)))):
    xin = x[..., :7] if kind == "row" else x
    for mode in ("ring", "gspmd"):
        try:
            R["tp_indivisible", kind, mode] = tuple(
                D.tp_matmul(xin, w, mesh, kind=kind, mode=mode).shape)
        except ValueError as e:
            R["tp_indivisible", kind, mode] = str(e)

# the operand bytes a rank sends, by the reference's collective kinds
D.reset_collectives()
y = D.all_gather(torch.zeros((3, 5)), mesh.get_group("model"))
y = D.all_reduce(torch.zeros(7, dtype=torch.float64), mesh.get_group("data"))
y = D.tp_matmul(x, w1, mesh, kind="column", mode="ring")
R["coll_bytes"], R["coll_counts"] = (dict(D.COLLECTIVE_BYTES),
                                     dict(D.COLLECTIVES))

# test_ragged_shapes_pad_and_slice
rng = np.random.default_rng(0)
A = torch.tensor(rng.standard_normal((61, 99)), dtype=torch.float32)
B = torch.tensor(rng.standard_normal((99, 96)), dtype=torch.float32)
for mode in ("ring", "gspmd"):
    R["ragged", mode], _ = gemm_case(A, B, mode)
R["ragged_want"] = f64(A) @ f64(B)
x = torch.tensor(rng.standard_normal((1, 3, 128)), dtype=torch.float32)
w1 = torch.tensor(rng.standard_normal((128, 256)), dtype=torch.float32)
w2 = torch.tensor(rng.standard_normal((256, 128)), dtype=torch.float32)
for mode in ("ring", "gspmd"):
    y = D.tp_matmul(x, w1, mesh, kind="column", mode=mode, batch_axis=None)
    R["ragged_tp_y", mode] = tuple(y.shape)
    R["ragged_tp", mode] = f64(D.tp_matmul(y, w2, mesh, kind="row",
                                           mode=mode, batch_axis=None))
R["ragged_tp_want"] = (f64(x) @ f64(w1)) @ f64(w2)

# test_ring_vs_gspmd_dtype_matrix, on the flat ring of 8 and the mesh
rng = np.random.default_rng(7)
r, rg = ring.get_local_rank("r"), ring.get_group("r")
for name in ("float64", "float32", "bfloat16"):
    dt = getattr(torch, name)
    A = torch.tensor(rng.standard_normal((64, 128)), dtype=dt)
    B = torch.tensor(rng.standard_normal((128, 96)), dtype=dt)
    R["mx_want", name] = (f64(A) @ f64(B)).astype(np.float32)
    for mode, (ag, rs) in D.MODES.items():
        D.reset_collectives()
        # allgather: A row-sharded, W column-sharded; out column-sharded
        y = ag(A[8 * r:8 * (r + 1)], B[:, 12 * r:12 * (r + 1)], rg)
        R["mx_ag_coll", name, mode] = dict(D.COLLECTIVES)
        R["mx_ag", name, mode] = f64(D.all_gather(y, rg, dim=1)
                                     ).astype(np.float32)
        D.reset_collectives()
        # reduce-scatter: A column-sharded, B row-sharded; out rows
        y = rs(A[:, 16 * r:16 * (r + 1)], B[16 * r:16 * (r + 1)], rg)
        R["mx_rs_coll", name, mode] = dict(D.COLLECTIVES)
        R["mx_rs", name, mode] = f64(D.all_gather(y, rg)).astype(np.float32)
    x = torch.tensor(rng.standard_normal((2, 30, 128)), dtype=dt)
    w1 = torch.tensor(rng.standard_normal((128, 256)), dtype=dt)
    w2 = torch.tensor(rng.standard_normal((256, 128)), dtype=dt)
    R["mx_tp_want", name] = ((f64(x) @ f64(w1)) @ f64(w2)).astype(np.float32)
    for mode in ("ring", "gspmd"):
        y = D.tp_matmul(x, w1, mesh, kind="column", mode=mode)
        R["mx_tp", name, mode] = f64(D.tp_matmul(y, w2, mesh, kind="row",
                                                 mode=mode)).astype(np.float32)

# test_bf16_ring_numerics
rng = np.random.default_rng(0)
A = torch.tensor(rng.standard_normal((64, 128)), dtype=torch.bfloat16)
B = torch.tensor(rng.standard_normal((128, 96)), dtype=torch.bfloat16)
C = D.distributed_gemm(A, B, mesh, mode="ring")
R["bf16_dtype"] = str(C.dtype)
R["bf16"] = f64(C)
R["bf16_want"] = (A.float() @ B.float()).double().numpy()

# compressed_psum: the mean of the ranks' dequantized int8 payloads
g = {{"a": torch.tensor(np.random.default_rng(RANK).standard_normal(300),
                        dtype=torch.float32),
      "b": {{"c": torch.tensor(np.random.default_rng(10 + RANK)
                              .standard_normal((4, 5)), dtype=torch.float32)}}}}
err = {{"a": torch.zeros(300), "b": {{"c": torch.zeros((4, 5))}}}}
mean, new_err = adamw.compressed_psum(g, err, rg)
R["cpsum_a"], R["cpsum_c"] = mean["a"].numpy(), mean["b"]["c"].numpy()
R["cpsum_err_a"] = new_err["a"].numpy()

# the mesh builders
try:
    M.make_mesh_for_devices(model_parallel=3, device="cpu")
except ValueError as e:
    R["mp_error"] = str(e)
try:
    M.make_production_mesh(device="cpu")
except ValueError as e:
    R["production_error"] = str(e)
R["axes"], R["chips"] = M.mesh_axes(mesh), M.n_chips(mesh)

# MeshRules over each mesh shape
rules = {{}}
for key, (shape, names) in MESHES.items():
    m = init_device_mesh("cpu", shape, mesh_dim_names=names)
    rules[key] = rules_record(rules_for_mesh(m), names)

if RANK == 0:
    import pickle
    with open(os.path.join(OUT, "port8.pkl"), "wb") as f:
        pickle.dump(R, f)
    with open(os.path.join(OUT, "port_rules.json"), "w") as f:
        json.dump(rules, f)
# every rank gets the full result
for k in ("gemm", "tp"):
    for mode in ("ring", "gspmd"):
        other = R[k, mode]
        assert other.shape == R[k + "_want"].shape, (k, mode)
"""

# ------------------------------------------------- the reference (jax)
REF_8 = f"""
import json, os, sys
import jax, numpy as np, jax.numpy as jnp
from repro.core import distributed as dist
from repro.models.sharding import rules_for_mesh
MESHES = {MESHES!r}
RULE_CASES = {RULE_CASES!r}
LOGICAL = {LOGICAL!r}
{RULES_BODY}
OUT = sys.argv[1]
mesh = jax.make_mesh((2, 4), ("data", "model"))
rng = np.random.default_rng(0)
x = jnp.asarray(rng.standard_normal((2, 32, 128)), jnp.float32)
w1 = jnp.asarray(rng.standard_normal((128, 256)), jnp.float32)
w2 = jnp.asarray(rng.standard_normal((256, 128)), jnp.float32)
y = dist.tp_matmul(x, w1, mesh, kind="column", mode="gspmd")
z = dist.tp_matmul(y, w2, mesh, kind="row", mode="gspmd")
np.save(os.path.join(OUT, "ref_tp.npy"), np.asarray(z))
rules = {{key: rules_record(rules_for_mesh(jax.make_mesh(shape, names)),
                           names)
          for key, (shape, names) in MESHES.items()}}
with open(os.path.join(OUT, "ref_rules.json"), "w") as f:
    json.dump(rules, f)
print("OK")
"""

# row_parallel_matmul's psum branch and the expert-parallel MoE on a
# (1, 4) and a (2, 2) mesh, against NO_MESH on this rank's tokens
PORT_4 = """
import dataclasses, pickle
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.models import layers, moe
from repro_torch.models.sharding import NO_MESH, rules_for_mesh
from repro_torch.models.transformer import build_params
from repro_torch.tree import tree_flatten
R = {}

def grads(fn, *inputs):
    live = [t.detach().requires_grad_(True) for t in inputs]
    out = fn(*live)
    y = out[0] if isinstance(out, tuple) else out
    g = torch.autograd.grad((y * y).sum(), live, allow_unused=True)
    return y.detach(), out, g

cfg = get_config("olmoe_1b_7b").reduced()          # f32, 8 experts, top 2
p = build_params(cfg, "init", NO_MESH, torch.Generator().manual_seed(0),
                 device="cpu")["moe_blocks"]
mp = {k: (v[0] if not isinstance(v, dict) else v)
      for k, v in p["moe"].items()}
for shape in ((1, 4), (2, 2)):
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    rules = rules_for_mesh(mesh)
    di = mesh.get_local_rank("data")
    rng = np.random.default_rng(3)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.tensor(rng.standard_normal((4, 5, 64)), dtype=dtype)
        w = torch.tensor(rng.standard_normal((64, 24)) / 8, dtype=dtype)
        xl = x[2 * di:2 * di + 2] if shape[0] == 2 else x
        # the mesh's rank holds its blocks of x's features and w's rows;
        # one matmul's gradients are cut to the same blocks
        f = 64 // shape[1]
        lo = mesh.get_local_rank("model") * f
        y, _, g = grads(lambda a, b: layers.row_parallel_matmul(
            a, b, rules, 64), xl[..., lo:lo + f], w[lo:lo + f])
        R["row", shape, str(dtype), "mesh"] = (
            y.double().numpy(), [t.double().numpy() for t in g])
        y, _, (gx, gw) = grads(lambda a, b: layers.row_parallel_matmul(
            a, b, NO_MESH, 64), xl, w)
        R["row", shape, str(dtype), "none"] = (
            y.double().numpy(), [gx[..., lo:lo + f].double().numpy(),
                                 gw[lo:lo + f].double().numpy()])
    tokens = torch.tensor(np.random.default_rng(4).standard_normal(
        (4, 6, cfg.d_model)), dtype=torch.float32)
    tl = tokens[2 * di:2 * di + 2] if shape[0] == 2 else tokens
    names = ("router", "w_gate", "w_up", "w_down")
    # the mesh's rank holds its block of the experts; the dense
    # dispatch's expert gradients are cut to the same block
    e_l = cfg.n_experts // shape[1]
    elo = mesh.get_local_rank("model") * e_l
    for name, r in (("mesh", rules), ("none", NO_MESH)):
        def f(x, *ws):
            return moe.moe_block(cfg, dict(mp, **dict(zip(names, ws))), x, r)
        ws = [mp[k] if k == "router" or name == "none"
              else mp[k][elo:elo + e_l] for k in names]
        y, out, g = grads(f, tl, *ws)
        g = [t if i < 2 or name == "mesh" else t[elo:elo + e_l]
             for i, t in enumerate(g)]
        aux = {k: float(v) for k, v in out[1].items()}
        R["moe", shape, name] = (y.numpy(), [t.numpy() for t in g], aux)
    # the reference's drop estimate on the sharded path: pos < C * model_n
    xt = tl.reshape(-1, cfg.d_model)
    _, _, gi = moe._router(cfg, mp, xt)
    n_tok = xt.shape[0]
    C = max(1, int(np.ceil(n_tok * cfg.top_k * cfg.capacity_factor
                           / cfg.n_experts)))
    pos = moe._positions_in_expert(gi.reshape(-1), cfg.n_experts)
    R["moe_drop_want", shape] = float(
        1.0 - (pos < C * shape[1]).float().mean())
with open(os.path.join(OUT, f"port4.{RANK}.pkl"), "wb") as f:
    pickle.dump(R, f)
"""


@pytest.fixture(scope="module")
def port8(tmp_path_factory):
    import pickle
    d = tmp_path_factory.mktemp("port8")
    run_ranks(d, 8, PORT_8)
    with open(d / "port8.pkl", "rb") as f:
        R = pickle.load(f)
    R["rules"] = json.loads((d / "port_rules.json").read_text())
    return R


@pytest.fixture(scope="module")
def ref8(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref8")
    env = dict(os.environ)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        + env.get("XLA_FLAGS", "")).strip()
    env["PYTHONPATH"] = str(REPO / "src")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_8),
                           str(d)], capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return {"tp": np.load(d / "ref_tp.npy"),
            "rules": json.loads((d / "ref_rules.json").read_text())}


@pytest.fixture(scope="module")
def port4(tmp_path_factory):
    import pickle
    d = tmp_path_factory.mktemp("port4")
    run_ranks(d, 4, PORT_4)
    out = []
    for r in range(4):
        with open(d / f"port4.{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b).max())


# ------------------------------------------------------------- the twins
def test_distributed_gemm_ring_matches_oracle(port8):
    for mode in ("ring", "gspmd"):
        assert _err(port8["gemm", mode], port8["gemm_want"]) < GEMM_TOL, mode
    assert _err(port8["gemm", "ring"], port8["gemm", "gspmd"]) < GEMM_TOL


def test_tp_matmul_column_row_roundtrip(port8):
    for mode in ("ring", "gspmd"):
        assert port8["tp_y", mode] == (2, 32, 256)
        assert _err(port8["tp", mode], port8["tp_want"]) < TP_TOL, mode


def test_tp_matmul_raises_where_the_ring_does_not_divide(port8):
    """The reference's shard_map refuses a W whose columns (column) or
    rows (row) the ring does not divide; so does the port, in both
    modes, where it once dropped them (N = 7 gave (2, 32, 4))."""
    for kind in ("column", "row"):
        for mode in ("ring", "gspmd"):
            got = port8["tp_indivisible", kind, mode]
            assert isinstance(got, str) and "not evenly divisible" in got, (
                kind, mode, got)


def test_collective_bytes_are_operand_bytes(port8):
    """``COLLECTIVE_BYTES`` adds each call's operand bytes under the
    reference's kind names: an all-gather of 3 x 5 f32, an all-reduce of
    7 f64, then a column tp_matmul on the (2, 4) mesh: 3 ring hops of a
    (8 x 128) f32 panel, one all-gather of its (1, 32, 64) columns over
    the model ring and one of the (1, 32, 256) rows over data."""
    assert port8["coll_counts"] == {"p2p": 3, "all_gather": 3,
                                    "reduce_scatter": 0, "all_reduce": 1}
    assert port8["coll_bytes"] == {
        "all-gather": 3 * 5 * 4 + 32 * 64 * 4 + 32 * 256 * 4,
        "all-reduce": 7 * 8, "reduce-scatter": 0, "all-to-all": 0,
        "collective-permute": 3 * 8 * 128 * 4}


def test_ring_uses_p2p_hops_not_allgather(port8):
    """The twin of ``test_ring_uses_collective_permute_not_allgather``:
    the ring's K reduction lowers to neighbour hops (3 on the 4-wide
    model axis), with no reduce-scatter or all-reduce; its all-gathers
    only re-gather the result.  The gspmd twin makes no hop."""
    ring, gspmd = port8["gemm_coll", "ring"], port8["gemm_coll", "gspmd"]
    assert ring["p2p"] >= 2 and ring["p2p"] == 3, ring
    assert ring["reduce_scatter"] == 0 and ring["all_reduce"] == 0, ring
    assert gspmd["p2p"] == 0 and gspmd["all_reduce"] == 1, gspmd
    # on the flat ring of 8 each ring kernel makes 7 hops and nothing else
    for kind in ("mx_ag_coll", "mx_rs_coll"):
        c = port8[kind, "float32", "ring"]
        assert c == {"p2p": 7, "all_gather": 0, "reduce_scatter": 0,
                     "all_reduce": 0}, (kind, c)
    assert port8["mx_ag_coll", "float32", "gspmd"]["all_gather"] == 1
    assert port8["mx_rs_coll", "float32", "gspmd"]["reduce_scatter"] == 1
    # tp_matmul's ring: 3 hops on the model axis for each kind
    assert port8["tp_coll", "ring"]["p2p"] == 6
    assert port8["tp_coll", "gspmd"]["p2p"] == 0


def test_ragged_shapes_pad_and_slice(port8):
    for mode in ("ring", "gspmd"):
        assert port8["ragged", mode].shape == (61, 96), mode
        assert _err(port8["ragged", mode], port8["ragged_want"]) < GEMM_TOL
        assert port8["ragged_tp_y", mode] == (1, 3, 256)
        assert port8["ragged_tp", mode].shape == (1, 3, 128)
        assert _err(port8["ragged_tp", mode],
                    port8["ragged_tp_want"]) < TP_TOL, mode


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_ring_vs_gspmd_dtype_matrix(port8, dtype):
    tol = TOL[dtype]
    want = port8["mx_want", dtype]
    for kind in ("mx_ag", "mx_rs"):
        ring, gspmd = port8[kind, dtype, "ring"], port8[kind, dtype, "gspmd"]
        assert _err(ring, want) < tol, (kind, dtype)
        assert _err(ring, gspmd) < tol, (kind, dtype)
    z = {mode: port8["mx_tp", dtype, mode] for mode in ("ring", "gspmd")}
    for mode in z:
        assert z[mode].shape == (2, 30, 128)
        assert _err(z[mode], port8["mx_tp_want", dtype]) < 8 * tol, mode
    assert _err(z["ring"], z["gspmd"]) < 8 * tol


def test_bf16_ring_numerics(port8):
    assert port8["bf16_dtype"] == "torch.bfloat16"
    assert _err(port8["bf16"], port8["bf16_want"]) < 1.0   # bf16 tolerance


# ------------------------------------------------------ beyond the twins
def test_tp_matmul_equals_the_references_gspmd(port8, ref8):
    """The reference's gspmd ``tp_matmul`` (its ring fails on this tree)
    against the port's, both modes, on the same inputs."""
    for mode in ("ring", "gspmd"):
        assert _err(port8["tp", mode], ref8["tp"]) < TP_TOL, mode


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_rules_match_the_reference(port8, ref8, mesh):
    """``physical``, ``axis_size``, ``batch_size_divides``, ``spec`` and
    the fitted per-dim axes over odd dims equal the reference's for the
    same mesh shape."""
    assert port8["rules"][mesh] == ref8["rules"][mesh]


def test_compressed_psum_is_the_mean_of_dequantized_payloads(port8):
    from repro_torch.optim import adamw
    deq = {"a": [], "c": []}
    for r in range(8):
        g = torch.tensor(np.random.default_rng(r).standard_normal(300),
                         dtype=torch.float32)
        q, s, e = adamw.compress_int8(g, torch.zeros(300))
        deq["a"].append(adamw.decompress_int8(q, s).numpy())
        if r == 0:
            np.testing.assert_array_equal(port8["cpsum_err_a"], e.numpy())
        g = torch.tensor(np.random.default_rng(10 + r).standard_normal(
            (4, 5)), dtype=torch.float32)
        q, s, _ = adamw.compress_int8(g, torch.zeros((4, 5)))
        deq["c"].append(adamw.decompress_int8(q, s).numpy())
    np.testing.assert_allclose(port8["cpsum_a"], np.mean(deq["a"], 0),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port8["cpsum_c"], np.mean(deq["c"], 0),
                               rtol=1e-6, atol=1e-6)


def test_mesh_builders(port8):
    assert port8["mp_error"] == "8 devices not divisible by mp=3"
    assert port8["production_error"] == (
        "a (16, 16) mesh needs a process group of exactly 256 ranks "
        "(a 'fake' one for the dry-run); this process has 8")
    assert port8["axes"] == ("data", "model") and port8["chips"] == 8
    from repro_torch.launch import mesh as M
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            M.make_mesh_for_devices(1, 1)            # the default: "cuda"
        with pytest.raises(RuntimeError, match="CUDA device"):
            M.init_process_group(init_method="file:///nonexistent",
                                 rank=0, world_size=1)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_row_parallel_psum_branch_equals_no_mesh(port4, shape, dtype):
    """Each rank's block of the features and rows (held, not sliced from
    whole operands), an f32 product, a psum in x's dtype: the same y as
    one matmul on the rank's tokens, and that matmul's gradients of x
    and w cut to the rank's blocks."""
    tol = 1e-5 if dtype == "torch.float32" else 2e-2
    for R in port4:
        (y, g), (y0, g0) = (R["row", shape, dtype, n]
                            for n in ("mesh", "none"))
        scale = np.abs(y0).max()
        assert np.abs(y - y0).max() <= tol * scale, (shape, dtype)
        for a, b in zip(g, g0):
            assert np.abs(a - b).max() <= tol * np.abs(b).max()


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_moe_sharded_dispatch_equals_no_mesh(port4, shape):
    """Expert-parallel dispatch over the model axis, each rank holding
    its block of the experts: y, the aux loss and the gradients (tokens,
    router, its experts) equal the dense dispatch on the rank's tokens
    (its expert gradients cut to the rank's block); the drop fraction
    is the reference's sharded estimate."""
    for R in port4:
        (y, g, aux), (y0, g0, aux0) = (R["moe", shape, n]
                                       for n in ("mesh", "none"))
        np.testing.assert_allclose(y, y0, rtol=1e-5, atol=1e-6)
        for a, b in zip(g, g0):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
        assert aux["moe_aux_loss"] == pytest.approx(aux0["moe_aux_loss"],
                                                    rel=1e-6)
        assert aux["moe_drop_frac"] == pytest.approx(
            R["moe_drop_want", shape], abs=1e-7)
