"""The slab pipeline of ``distributed_gemm``'s ring (``core/distributed.py``).

Where a row group's rows split evenly into products of at least 2048
rows, the ring runs P > 1 row slabs as one pipeline and all-gathers each
slab's piece straight into the output.  Each case runs in gloo ranks on
a (1, 4) or a (2, 4) mesh (``torch_ranks.run_ranks``) with a narrow K
and N, so the slabs are engaged at little cost, and holds: C against
the float64 oracle at the f32 tolerance of the ring's twins
(``test_torch_distributed.py``), ``RING_SLABS``, the hops and gathers
counted, the hop bytes against the un-slabbed ring's on the same
blocks, the spans under a CPU profiler, and the order in which the call
opens them, which is its schedule.  Shapes that give P = 1
(products under 2048 rows, a ragged row group) keep the un-slabbed
schedule; ``tp_matmul`` and the gspmd mode run no slab.
"""
import json

import pytest

from torch_ranks import run_ranks

GEMM_TOL = {"float32": 1e-3, "bfloat16": 1.0}   # max abs, as the twins'
K, N = 64, 32

# name: (ranks, M, dtype, P); the mesh is (ranks / 4, 4)
CASES = {
    "p4-1x4": (4, 32768, "float32", 4),
    "p2-1x4": (4, 16384, "float32", 2),
    "bf16-p4-1x4": (4, 32768, "bfloat16", 4),
    "short-1x4": (4, 8192, "float32", 1),       # 2 x 4 x 1024 rows: P = 1
    "ragged-1x4": (4, 32767, "float32", 1),
    "p4-2x4": (8, 65536, "float32", 4),
    "p2-2x4": (8, 32768, "float32", 2),
    # M pads to 65536 over the data axis: each row group is whole slabs
    "ragged-m-p4-2x4": (8, 65535, "float32", 4),
    "ragged-2x4": (8, 65534, "float32", 1),
}

BODY = """
from repro_torch.core import distributed as D
from repro_torch.launch.mesh import make_mesh_for_devices
from torch.profiler import ProfilerActivity, profile

CASES, K, N = {cases!r}, {k}, {n}
mesh = make_mesh_for_devices(WORLD, 4, device="cpu")
cols = mesh.get_group("model")
dr, c = WORLD // 4, mesh.get_local_rank("model")
R = {{}}
for name, (world, m, dtype, _) in CASES.items():
    if world != WORLD:
        continue
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(len(name) + m)
    A = torch.randn((m, K), generator=gen).to(dt)
    B = torch.randn((K, N), generator=gen).to(dt)
    D.reset_collectives()
    C = D.distributed_gemm(A, B, mesh, mode="ring")
    got = {{"shape": list(C.shape), "dtype": str(C.dtype),
           "err": float((C.double() - A.double() @ B.double()).abs().max()),
           "slabs": D.RING_SLABS, "coll": dict(D.COLLECTIVES),
           "bytes": dict(D.COLLECTIVE_BYTES)}}
    # the un-slabbed ring on this rank's blocks of the same operands
    mr = -(-m // dr)
    r = mesh.get_local_rank("data")
    blk = torch.nn.functional.pad(A, (0, 0, 0, mr * dr - m))[
        r * mr:(r + 1) * mr, c * (K // 4):(c + 1) * (K // 4)]
    D.reset_collectives()
    D.ring_reduce_scatter_matmul(blk, B[c * (K // 4):(c + 1) * (K // 4)],
                                 cols)
    got["unslabbed_hop_bytes"] = D.COLLECTIVE_BYTES["collective-permute"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = D.distributed_gemm(A, B, mesh, mode="ring")
    got["same_traced"] = bool(torch.equal(traced, C))
    spans = {{}}
    for e in prof.events():
        if e.name.startswith("blasx."):
            spans[e.name] = spans.get(e.name, 0) + 1
    got["spans"] = spans
    # the order in which the call opens its spans: its schedule
    order, real = [], D.span
    D.span = lambda name: order.append(name) or real(name)
    try:
        D.distributed_gemm(A, B, mesh, mode="ring")
    finally:
        D.span = real
    got["order"] = order
    # the callers that run no slab
    D.reset_collectives()
    D.distributed_gemm(A, B, mesh, mode="gspmd")
    x = A[:m - m % (4 * dr)].reshape(dr, -1, K)
    D.tp_matmul(x, B, mesh, kind="row", mode="ring")
    got["others_slabs"] = D.RING_SLABS
    R[name] = got
with open(os.path.join(OUT, f"slabs.{{RANK}}.json"), "w") as f:
    json.dump(R, f)
"""


def schedule(p: int, d: int, dr: int) -> list:
    """The spans a ring call opens, in order, for P slabs on a ring of d:
    slab j's last hop is waited on, and its gather posted, only after
    slab j + 1's first product has been launched."""
    ring = "blasx.ring."
    # wait for the last hop, add, cast; with slabs, post the gather
    last = [ring + "wait", ring + "accumulate", ring + "accumulate"] + (
        ["blasx.gemm.gather"] if p > 1 else [])
    seq = ["blasx.gemm.prep"] * 2
    for j in range(p):
        seq.append(ring + "block")
        if j:
            seq += last
        for s in range(1, d):
            if s > 1:
                seq += [ring + "wait", ring + "accumulate"]
            seq += [ring + "hop", ring + "block"]
    seq += last
    if p == 1:
        return seq + ["blasx.gemm.gather"]
    return seq + ["blasx.gemm.gather_wait"] + (
        ["blasx.gemm.gather"] if dr > 1 else [])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: [each rank's results]}, spawned once a world."""
    runs = {}

    def get(world):
        if world not in runs:
            d = tmp_path_factory.mktemp(f"slabs{world}")
            run_ranks(d, world, BODY.format(cases=CASES, k=K, n=N),
                      name="slabs")
            runs[world] = [json.loads((d / f"slabs.{r}.json").read_text())
                           for r in range(world)]
        return runs[world]
    return get


@pytest.mark.parametrize("case", sorted(CASES))
def test_ring_slabs(ranks, case):
    world, m, dtype, p = CASES[case]
    dr, d = world // 4, 4
    mr = -(-m // dr)
    for rank, R in enumerate(ranks(world)):
        got = R[case]
        assert got["shape"] == [m, N], rank
        assert got["dtype"] == f"torch.{dtype}", rank
        assert got["err"] < GEMM_TOL[dtype], (rank, got["err"])
        assert got["slabs"] == p, rank
        # the same hops, cut into P slabs: 3 a slab, the same bytes
        coll, nbytes = got["coll"], got["bytes"]
        assert coll["p2p"] == (d - 1) * p, rank
        assert nbytes["collective-permute"] == got["unslabbed_hop_bytes"]
        assert coll["reduce_scatter"] == coll["all_reduce"] == 0, rank
        size = 2 if dtype == "bfloat16" else 4
        piece = -(-mr // d) * N * size       # this rank's rows of C
        if p > 1:
            # a gather a slab into the output, and over data only where
            # the data axis has more than one rank
            assert coll["all_gather"] == p + (dr > 1), rank
            assert nbytes["all-gather"] == piece + (
                mr * N * size if dr > 1 else 0), rank
        else:
            assert coll["all_gather"] == 2, rank
            assert nbytes["all-gather"] == piece + mr * N * size, rank
        spans = {"blasx.gemm.prep": 2, "blasx.ring.block": d * p,
                 "blasx.ring.hop": (d - 1) * p,
                 "blasx.ring.wait": (d - 1) * p,
                 "blasx.ring.accumulate": d * p,
                 "blasx.gemm.gather": p + (dr > 1) if p > 1 else 1}
        if p > 1:
            spans["blasx.gemm.gather_wait"] = 1
        assert got["spans"] == spans, rank
        assert got["order"] == schedule(p, d, dr), rank
        assert got["same_traced"], rank
        assert got["others_slabs"] == 0, rank
