"""The dry-run slice of the port: ``launch/roofline.py`` (twins of
``test_roofline.py`` with the H100's constants), the abstract mode
(``Maker("abstract")``, ``Model.abstract``/``abstract_cache``,
``steps.input_specs``/``abstract_*``, ``adamw.abstract_state``) held
leaf by leaf against the reference's ``ShapeDtypeStruct`` trees on a
``jax.sharding.AbstractMesh``, and ``launch/dryrun.py`` on a fake
256-rank process group: its costs linear in depth (the reference's
``_depth_handle`` premise), its FLOPs those of a real step, and no
process group left behind.  Nothing here needs a card: the fake tensors
live on the CPU (``dryrun.default_device()`` on a CPU-only torch).
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import all_configs as ref_all_configs
from repro.launch import roofline as ref_rf
from repro.launch import steps as ref_steps
from repro.models.sharding import rules_for_mesh as ref_rules_for_mesh
from repro_torch.configs import SHAPES, ShapeConfig, get_config
from repro_torch.launch import dryrun, steps
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import Model
from repro_torch.models.layers import Maker
from repro_torch.models.sharding import (NO_MESH, global_shape,
                                         rules_for_mesh)
from repro_torch.optim import adamw
from repro_torch.tree import keystr, tree_flatten

from torch_ranks import REPO

ARCHS = list(ref_all_configs())
DEVICE = "cpu"

HLO_SAMPLE = """
HloModule test

ENTRY %main (p0: f32[16,128]) -> f32[16,128] {
  %p0 = f32[16,128]{1,0} parameter(0)
  %ag = f32[64,128]{1,0} all-gather(%p0), replica_groups={{0,1,2,3}}, dimensions={0}
  %c = f32[16,128]{1,0} constant(0)
  %ar.1 = f32[16,128]{1,0} all-reduce(%p0), to_apply=%add
  %rs = f32[4,128]{1,0} reduce-scatter(f32[16,128]{1,0} %ar.1), dimensions={0}
  %cp = f32[16,128]{1,0} collective-permute(%ar.1), source_target_pairs={{0,1}}
  ROOT %out = f32[16,128]{1,0} add(%ar.1, %cp)
}
"""


# ------------------------------------------------ twins of test_roofline
def test_shape_bytes():
    assert rf.shape_bytes("f32[16,128]{1,0}") == 16 * 128 * 4
    assert rf.shape_bytes("bf16[2,3]") == 12
    assert rf.shape_bytes("(f32[4], bf16[8])") == 16 + 16
    assert rf.shape_bytes("pred[]") == 0 or rf.shape_bytes("pred[]") >= 0


def test_collective_parser_counts_operands():
    out = rf.collective_bytes(HLO_SAMPLE)
    base = 16 * 128 * 4
    assert out["all-gather"] == base          # operand p0
    assert out["all-reduce"] == base
    assert out["reduce-scatter"] == base      # inline-typed operand
    assert out["collective-permute"] == base
    assert out["all-to-all"] == 0
    assert out == ref_rf.collective_bytes(HLO_SAMPLE)


def test_wire_weighting():
    bd = {"all-reduce": 100, "all-gather": 50, "reduce-scatter": 50,
          "all-to-all": 0, "collective-permute": 10}
    assert rf.wire_bytes(bd) == 2 * 100 + 50 + 50 + 10


def test_roofline_terms_and_dominance():
    """The reference's case against the H100's constants: one second of
    compute at 989 TFLOP/s, two of HBM at 3.35 TB/s, half a second of
    NVLink at 450 GB/s a direction."""
    assert (rf.PEAK_FLOPS, rf.HBM_BW, rf.LINK_BW) == (989e12, 3.35e12,
                                                      450e9)
    r = rf.Roofline(arch="x", shape="train_4k", mesh="single", chips=256,
                    hlo_flops=256 * rf.PEAK_FLOPS,        # 1 s compute
                    hlo_bytes=256 * rf.HBM_BW * 2,        # 2 s memory
                    coll_bytes=256 * rf.LINK_BW * 0.5,    # 0.5 s collective
                    coll_breakdown={"all-gather": 1},     # weight 1.0
                    model_flops=256 * rf.PEAK_FLOPS * 0.5)
    assert abs(r.compute_s - 1.0) < 1e-9
    assert abs(r.memory_s - 2.0) < 1e-9
    assert abs(r.collective_s - 0.5) < 1e-9
    assert r.dominant == "memory"
    assert abs(r.useful_flops_frac - 0.5) < 1e-9
    assert abs(r.roofline_frac - 0.25) < 1e-9   # 0.5s ideal vs 2s bound
    assert r.bound_s == pytest.approx(2.0)


def test_model_flops_train_vs_decode():
    cfg = get_config("olmo_1b")
    tr = rf.model_flops_for(cfg, SHAPES["train_4k"])
    pf = rf.model_flops_for(cfg, SHAPES["prefill_32k"])
    dc = rf.model_flops_for(cfg, SHAPES["decode_32k"])
    tokens_tr = 256 * 4096
    assert tr == pytest.approx(6 * cfg.param_count() * tokens_tr)
    assert pf == pytest.approx(2 * cfg.param_count() * 32 * 32768)
    assert dc == pytest.approx(2 * cfg.param_count() * 128)


def test_moe_uses_active_params():
    cfg = get_config("deepseek_v3_671b")
    tr = rf.model_flops_for(cfg, SHAPES["train_4k"])
    assert tr < 6 * cfg.param_count() * 256 * 4096 * 0.2  # far below total
    assert tr == pytest.approx(6 * cfg.active_param_count() * 256 * 4096)


def test_least_time_takes_the_larger_term():
    ms, by = rf.least_time(2 * 4096 ** 3, 3 * 4096 ** 2 * 2, "bfloat16")
    assert by == "operations" and ms == pytest.approx(
        2 * 4096 ** 3 / 989e12 * 1e3)
    ms, by = rf.least_time(1e6, 3.35e9, "float32")
    assert by == "bytes" and ms == pytest.approx(1.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_for_equals_the_references(arch):
    ref_cfg = ref_all_configs()[arch]
    for name in SHAPES:
        assert rf.model_flops_for(get_config(arch), SHAPES[name]) == \
            ref_rf.model_flops_for(ref_cfg, REF_SHAPES[name]), name


# ------------------------------------------------------- abstract mode
@pytest.fixture
def production_mesh():
    """The (16, 16) mesh over a fake 256-rank group, destroyed after."""
    with dryrun.fake_group(256):
        yield make_production_mesh(device=DEVICE)
    assert not dist.is_initialized()


def _ref_rules():
    return ref_rules_for_mesh(AbstractMesh((16, 16), ("data", "model")))


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): (
        tuple(x.shape), str(x.dtype), tuple(x.shape) if x.sharding is None
        else tuple(x.sharding.shard_shape(x.shape))) for p, x in flat}


def _port_leaves(tree):
    """Each leaf's global shape, dtype and held shape: an abstract leaf
    is a fake tensor of its block, and carries the placement that gives
    the global shape back."""
    paths, leaves = tree_flatten(tree)
    return {keystr(p): (global_shape(t), str(t.dtype).replace("torch.", ""),
                        tuple(t.shape))
            for p, t in zip(paths, leaves)}


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_state_match_the_references(arch,
                                                       production_mesh):
    """The same paths, global shapes and dtypes as the reference's
    ``ShapeDtypeStruct`` trees at full width, and the same per-device
    shard shapes: the port's placements against the reference's
    ``NamedSharding`` on an ``AbstractMesh`` of the same axes."""
    rules = rules_for_mesh(production_mesh)
    with FakeTensorMode():
        params, state = steps.abstract_train_state(get_config(arch), rules,
                                                   DEVICE)
        assert all(isinstance(t, torch._subclasses.FakeTensor)
                   for t in tree_flatten({"p": params, "s": state})[1])
    ref_params, ref_state = ref_steps.abstract_train_state(
        ref_all_configs()[arch], _ref_rules())
    assert _port_leaves(params) == _ref_leaves(ref_params)
    assert _port_leaves(state) == _ref_leaves(ref_state)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_cache_match_the_references(arch, production_mesh):
    rules = rules_for_mesh(production_mesh)
    cfg, ref_cfg = get_config(arch), ref_all_configs()[arch]
    for name, shape in SHAPES.items():
        with FakeTensorMode():
            specs = steps.input_specs(cfg, shape, rules, DEVICE)
            mine = _port_leaves(specs)
            if shape.kind == "decode":
                _, cache = steps.abstract_serve_state(cfg, rules, shape,
                                                      DEVICE)
                mine_cache = _port_leaves(cache)
        ref = ref_steps.input_specs(ref_cfg, REF_SHAPES[name], _ref_rules())
        assert mine == _ref_leaves(ref), name
        if shape.kind == "decode":
            _, ref_cache = ref_steps.abstract_serve_state(
                ref_cfg, _ref_rules(), REF_SHAPES[name])
            assert mine_cache == _ref_leaves(ref_cache), name


def test_abstract_mode_raises_outside_a_fake_mode():
    """``Maker("abstract")`` never allocates: outside an active
    ``FakeTensorMode`` it raises, and so do the trees built on it."""
    with pytest.raises(RuntimeError, match="FakeTensorMode"):
        Maker("abstract", NO_MESH, torch.bfloat16, device=DEVICE)
    cfg = get_config("deepseek_v3_671b")
    with pytest.raises(RuntimeError, match="FakeTensorMode"):
        Model(cfg).abstract(DEVICE)
    with pytest.raises(RuntimeError, match="FakeTensorMode"):
        steps.input_specs(cfg, SHAPES["train_4k"], NO_MESH, DEVICE)
    with FakeTensorMode():
        params = Model(get_config("qwen3_0_6b")).abstract(DEVICE)
    with pytest.raises(RuntimeError, match="FakeTensorMode"):
        adamw.abstract_state(params)


def test_production_mesh_on_fake_groups():
    """(16, 16) over 256 fake ranks and (2, 16, 16) over 512, each group
    gone after; anything else raises saying what it needs."""
    for multi, world, shape in ((False, 256, (16, 16)),
                                (True, 512, (2, 16, 16))):
        with dryrun.fake_group(world):
            mesh = make_production_mesh(multi_pod=multi, device=DEVICE)
            assert tuple(mesh.shape) == shape
            with pytest.raises(ValueError, match="exactly"):
                make_production_mesh(multi_pod=not multi, device=DEVICE)
        assert not dist.is_initialized()
    with pytest.raises(ValueError, match="exactly 256 ranks"):
        make_production_mesh(device=DEVICE)


# -------------------------------------------------------------- dry-run
def test_dryrun_cell_records_and_leaves_no_group(capsys):
    """One cell through the CLI's path: the reference's record, roofline
    terms from the H100's constants, a skipped cell as the reference
    records it, and no process group left behind."""
    r = dryrun.dryrun_cell("qwen3_0_6b", "prefill_32k",
                           cfg=dryrun._depth_handle(
                               get_config("qwen3_0_6b"))[1](1))
    assert not dist.is_initialized()
    assert (r["status"], r["chips"], r["mesh"]) == ("ok", 256, "single")
    mem = r["memory"]
    # every argument is held at its placement, as the reference's are
    assert mem["argument_size_in_bytes"] == \
        mem["argument_size_placed_in_bytes"] > 0
    assert mem["alias_size_in_bytes"] is None
    roof = r["roofline"]
    assert roof["compute_s"] == pytest.approx(
        roof["hlo_flops"] / (256 * 989e12))
    assert roof["memory_s"] == pytest.approx(
        roof["hlo_bytes"] / (256 * 3.35e12))
    assert "roofline: compute=" in capsys.readouterr().out
    skipped = dryrun.dryrun_cell("qwen3_0_6b", "long_500k")
    assert skipped["status"] == "skipped" and "sub-quadratic" in \
        skipped["reason"]


def test_dryrun_refuses_a_group_that_is_not_fake(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="'fake' process group"):
            dryrun.dryrun_cell("qwen3_0_6b", "prefill_32k")
    finally:
        dist.destroy_process_group()


def test_fake_flops_equal_a_real_cpu_step():
    """Reduced Qwen3: the trace on fake tensors counts what
    ``FlopCounterMode`` counts over the same step on real tensors."""
    cfg = get_config("qwen3_0_6b").reduced()
    shape = ShapeConfig("train_small", 32, 4, "train")
    predicted = dryrun.trace_step(cfg, shape, NO_MESH, device=DEVICE)
    step, model = steps.make_train_step(cfg, NO_MESH)
    params = model.init(0, device=DEVICE)
    rng = np.random.default_rng(0)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size, (4, 32)),
                             dtype=torch.int32)
             for k in ("tokens", "labels")}
    with FlopCounterMode(display=False) as fc:
        step(params, adamw.init_state(params), batch)
    assert predicted["flops"] == fc.get_total_flops() > 0
    held = sum(t.numel() * t.element_size()
               for t in tree_flatten({"p": params, "b": batch,
                                      "s": adamw.init_state(params)})[1])
    assert predicted["memory"]["argument_size_in_bytes"] == held


# one cell a family at depths 1, 2 and 3, full width, on a fake 256-rank
# group, in a process of its own (its peak RSS proves nothing was
# allocated); prefill runs one forward pass, train adds the backward
DEPTH_BODY = """
import json, resource, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
arch, shape = sys.argv[1], sys.argv[2]
cfg = get_config(arch)
_, make = dryrun._depth_handle(cfg)
out = []
for u in (1, 2, 3):
    r = dryrun.dryrun_cell(arch, shape, cfg=make(u), verbose=False)
    out.append([r["roofline"][k] for k in ("hlo_flops", "hlo_bytes",
                                           "coll_bytes")])
print(json.dumps({"costs": out, "rss_gib":
                  resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20}))
"""
DEPTH_CELLS = [("qwen3_0_6b", "prefill_32k"), ("deepseek_v3_671b",
               "prefill_32k"), ("mamba2_780m", "prefill_32k"),
               ("zamba2_2_7b", "prefill_32k"),
               ("seamless_m4t_medium", "prefill_32k"),
               ("qwen3_0_6b", "train_4k")]


# per-rank FLOPs that the parent commit (1b2e91c, whose model ranks
# computed whole column projections, attention over every head and
# whole logits) traces for reduced Qwen3 on a fake (2, 4) group, 8 x 32
# tokens, by the same trace_step
PARENT_TP_FLOPS = {"train": 55312384, "prefill": 12976128}


@pytest.mark.parametrize("kind", sorted(PARENT_TP_FLOPS))
def test_dryrun_rank_computes_its_model_block(kind):
    """On a fake (2, 4) group a rank's traced FLOPs fall below half of the
    parent's for the same cell (the q heads, ff width and vocab split 4
    ways; the 2 kv heads do not divide 4, so k/v stay whole), while the
    bytes it holds stay the reference's placed bytes, and its only
    model-axis all-gathers are those of the whole ``wk``/``wv``."""
    from repro_torch.launch.mesh import make_mesh_for_devices
    cfg = get_config("qwen3_0_6b").reduced()
    shape = ShapeConfig("tp", 32, 8, kind)
    with dryrun.fake_group(8):
        rules = rules_for_mesh(make_mesh_for_devices(8, 4, device=DEVICE))
        tr = dryrun.trace_step(cfg, shape, rules, device=DEVICE)
    assert not dist.is_initialized()
    assert tr["flops"] < PARENT_TP_FLOPS[kind] / 2, tr["flops"]
    mem = tr["memory"]
    assert mem["argument_size_in_bytes"] == \
        mem["argument_size_placed_in_bytes"]
    # wk and wv a layer, each a (d, Hkv*hd/4) f32 block after its "data"
    # gather (the reduced config does not remat, so once)
    d, kv = cfg.d_model, cfg.n_kv_heads * cfg.resolved_head_dim
    assert not cfg.remat
    want = cfg.n_layers * 2 * d * (kv // 4) * 4
    assert tr["coll_by_axis"]["model"]["all-gather"] == want


@pytest.fixture(scope="module")
def depth_costs():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c",
                               textwrap.dedent(DEPTH_BODY), arch, shape],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env)
             for arch, shape in DEPTH_CELLS]
    out = {}
    for cell, p in zip(DEPTH_CELLS, procs):
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stderr[-4000:]
        out[cell] = json.loads(stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("cell", DEPTH_CELLS, ids=lambda c: "-".join(c))
def test_dryrun_costs_are_linear_in_depth(depth_costs, cell):
    """cost(u) = const + u * per_unit, exactly, for each family (dense,
    moe, ssm, hybrid, encdec): FLOPs, bytes accessed and collective
    bytes, in the train step too: each stacked parameter is unbound once
    into its layers, so its gradient is written once a stack (indexing
    a layer at a time wrote a whole-stack gradient a layer, bytes
    growing as L squared), and each layer's gathers and reduce-scatters
    move its own blocks.  The process peaked below 2 GiB of RSS."""
    costs = np.array(depth_costs[cell]["costs"])
    inc = np.diff(costs, axis=0)
    for k in (0, 1, 2):
        assert inc[0, k] == inc[1, k], (cell, k, costs[:, k])
    assert inc[0, 0] > 0
    assert depth_costs[cell]["rss_gib"] < 2.0


# a fresh interpreter, as each cell of the card's sweep runs: the dry-run
# module imported, its FlopCounterMode made before the first layer, then
# K5's operator reached on fake tensors (a CUDA build reaches it from
# gqa_attention; here it is called as that path calls it)
_FRESH_K5 = """
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.models import Model, NO_MESH

with FakeTensorMode():
    fc = FlopCounterMode(display=False)
    cfg = get_config("qwen3_0_6b").reduced()
    params = Model(cfg, NO_MESH).abstract("cpu")
    grads = [t.requires_grad for t in torch.utils._pytree.tree_leaves(
        params)]
    q = torch.empty(2, 64, 4, 128)
    kv = torch.empty(2, 64, 2, 128)
    o = torch.empty_like(q)
    with fc:
        from repro_torch.kernels import flash_attention
        torch.ops.repro_torch.flash_attention_fwd(q, kv, kv, o, True, 0.1)
print(any(grads), fc.get_total_flops())
"""


def test_a_fresh_dryrun_counts_the_flash_operator_by_its_formula():
    """A sweep cell runs in a process of its own, whose FlopCounterMode
    copies the FLOP formulas registered when it is made, before any
    layer runs: K5's operator is counted by its formula (4 B H Sq Sk D)
    there only because the model imports the kernel's module, not at
    its first prefill.  And the abstract serving parameters do not
    require grad, so a prefill's trace takes K5 (``gqa_attention`` sends
    what requires grad to the plain chunked path)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.dirname(__file__)), "src"))
    proc = subprocess.run([sys.executable, "-c", _FRESH_K5], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    needs_grad, flops = proc.stdout.split()
    assert needs_grad == "False"
    assert int(flops) == 4 * 2 * 4 * 64 * 64 * 128
