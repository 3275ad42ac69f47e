"""The one-card controls of ``tools/fsdp_train.py``'s bf16 Mamba2 mesh
runs, at the tool's smoke size (``--device cpu``: the reduced config,
SMOKE_SEQ x SMOKE_BATCH tokens), here in bf16: the "rounded" control
(out_proj as a 2-way model axis's two partials, each rounded to bf16
before their sum) is the one-card run but for that rounding, and its
product is bitwise the one a (1, 2) gloo mesh's row-parallel all-reduce
gives; and the limits a bf16 mesh run is held to are drawn from its
control."""
import functools
import sys

import numpy as np
import pytest
import torch

from torch_ranks import REPO, run_ranks

sys.path.insert(0, str(REPO / "tools"))
import fsdp_train  # noqa: E402

torch.set_num_threads(1)

STEPS = 3


def _run(kind, base=None):
    return fsdp_train.one_run("mamba2_780m", kind, STEPS, "bfloat16", 0, 1,
                              "cpu", True, compare=True, base=base)


def test_rounded_control_without_rounding_is_the_one_card_run(
        monkeypatch):
    """With the rounding of the partials turned off, the (2, 2) control
    trains from the same weights on the same batches as the one-card
    run and gives its losses and first gradient bitwise."""
    row, first = _run(None)
    monkeypatch.setattr(fsdp_train, "rounded_partials", functools.partial(
        fsdp_train.rounded_partials, rounded=False))
    control, _ = _run("rounded", base=first)
    assert control["control"] == "rounded"
    assert control["losses"] == row["losses"]
    errs = control["first_grad_rel_err_by_leaf"]
    assert set(errs) == set(first) and not any(errs.values())


def test_rounded_control_rounds_only_the_out_proj_partials():
    """With the rounding on, the control's first gradient and losses
    move from the one-card run's (bf16 partials summed in bf16), stay
    finite, and the plain product is back after the run."""
    from repro_torch.models import ssm
    plain = ssm._out_proj
    row, first = _run(None)
    control, _ = _run("rounded", base=first)
    assert ssm._out_proj is plain
    errs = control["first_grad_rel_err_by_leaf"]
    assert any(errs.values()) and all(np.isfinite(list(errs.values())))
    assert all(np.isfinite(control["losses"]))
    assert control["losses"][0] != row["losses"][0]


PARTIALS_BODY = """
import sys
sys.path.insert(0, {tools!r})
import fsdp_train
from repro_torch.launch.mesh import make_mesh_for_devices
from repro_torch.models import NO_MESH, ssm
from repro_torch.models.layers import row_parallel_matmul
from repro_torch.models.sharding import rules_for_mesh

gen = torch.Generator().manual_seed(7)
di, d = 96, 40
y = torch.randn((2, 5, di), generator=gen).to(torch.bfloat16)
w = (torch.randn((di, d), generator=gen) / di ** 0.5).to(torch.bfloat16)
rules = rules_for_mesh(make_mesh_for_devices(2, 2, device="cpu"))
own = slice(RANK * di // 2, (RANK + 1) * di // 2)
mesh = row_parallel_matmul(y[..., own], w[own], rules, di)
with fsdp_train.rounded_partials():
    control = ssm._out_proj(y, w, NO_MESH, 1, di)
plain = ssm._out_proj(y, w, NO_MESH, 1, di)
assert torch.equal(mesh, control), (mesh - control).abs().max()
assert not torch.equal(plain, control)
with open(os.path.join(OUT, f"partials.{{RANK}}.ok"), "w") as f:
    f.write("ok")
"""


def test_rounded_partials_are_a_2_way_model_axis(tmp_path):
    """The control's out_proj product on one rank equals, bitwise, the
    all-reduced bf16 partials of a (1, 2) gloo mesh, each rank holding
    half of the rows (``layers.row_parallel_matmul``), and differs from
    the plain bf16 product."""
    run_ranks(tmp_path, 2, PARTIALS_BODY.format(tools=str(REPO / "tools")))
    assert all((tmp_path / f"partials.{r}.ok").exists() for r in range(2))


@pytest.mark.parametrize("dtype, control, want", [
    ("bfloat16", {"control": "split",
                  "loss_rel_diff_vs_one_card": [0.0, 4e-4, 7e-4]},
     (1.4e-3, {}, "2 x the split control's")),
    ("bfloat16", None, (1e-3, {}, "LOSS_RTOL")),
    ("float32", None, (1e-4, {}, "LOSS_RTOL")),
])
def test_a_bf16_mesh_limit_is_drawn_from_its_control(dtype, control, want):
    """``limits``: a bf16 mesh run's loss limit is twice its one-card
    control's largest distance from one card's losses where the control
    ran, else LOSS_RTOL; f32 keeps its limits."""
    got = fsdp_train.limits(dtype, {"losses": [1.0]}, control)
    assert got[0] == pytest.approx(want[0]) and got[1:] == want[1:]
    f64 = {"first_grad_f64_rel_err_by_leaf": {"a": 1e-5},
           "loss_rel_diff_vs_f64": [2e-6, 3e-6]}
    assert fsdp_train.limits("float32", f64, control) == (
        6e-6, {"a": 2e-5}, "2 x one card's f32 vs f64")
    assert fsdp_train.CONTROL_OF == {"cards": "split", "half": "rounded"}
