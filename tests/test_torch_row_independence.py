"""No operator of the port mixes a batch's rows at the card's sequence
length: in float64, the mean of the gradients of a batch's 4 row blocks
equals the whole batch's gradient to rounding, leaf by leaf.

The card's Mamba2-780M gradient of 8 x 1024 tokens moves up to 7.8e-4
normwise in float32 when taken as the mean of 4 row blocks' (``PERF.md``;
``tools/fsdp_train.py``'s data-split control).  Here the reduced widths
run at the card's sequence (1024 tokens, 4 SSD chunks of the published
256) and batch (8), 2 layers, in float64, where rounding alone stays
near 1e-16: a row-mixing operator (a reduction over the batch, a state
carried across rows, a chunking that crosses a row) would read far
above ROW_RTOL.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.launch import steps
from repro_torch.models import NO_MESH
from repro_torch.tree import tree_flatten

SEQ, BATCH, BLOCKS, LAYERS, CHUNK = 1024, 8, 4, 2, 256
# float64 sums of the same terms in another order
ROW_RTOL = 1e-10


@pytest.mark.parametrize("arch", ("mamba2_780m", "zamba2_2_7b"))
def test_row_blocks_mean_gradient_equals_the_whole_batchs(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float64",
                              n_layers=LAYERS, ssm_chunk=CHUNK)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, attn_every=1)
    grad_step, model = steps.make_grad_step(cfg, NO_MESH)
    params = model.init(0, device="cpu")
    dc = DataConfig(cfg.vocab_size, SEQ, BATCH, seed=0)
    batch = {k: torch.from_numpy(v) for k, v in batch_at_step(dc, 0).items()
             if k in ("tokens", "labels")}
    paths, whole = tree_flatten(grad_step(params, batch)[0])
    mean = [torch.zeros_like(g) for g in whole]
    for blk in range(BLOCKS):
        part = {k: v.chunk(BLOCKS)[blk] for k, v in batch.items()}
        for m, g in zip(mean, tree_flatten(grad_step(params, part)[0])[1]):
            m.add_(g, alpha=1 / BLOCKS)
    assert all(g.dtype == torch.float64 for g in whole)
    for path, m, g in zip(paths, mean, whole):
        assert float((m - g).norm() / g.norm()) <= ROW_RTOL, path
