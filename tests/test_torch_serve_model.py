"""The port's serving driver against the reference's, on the CPU.

Both ``Server``s get the same weights (the reference's ``jax.random``
tree, carried over with ``params_from_reference``) and the same
requests, through two slots with a 32-long cache: prefill, slot reuse
and batched decode, for the dense family and for a moe, ssm and hybrid
config.  Greedy tokens must be equal, not close.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch.serve import Request as RefRequest
from repro.launch.serve import Server as RefServer
from repro.models import Model as RefModel
from repro_torch.configs import get_config
from repro_torch.launch.serve import Request, ServeConfig, Server, run
from repro_torch.models import Model
from repro_torch.models.convert import params_from_reference

torch.set_num_threads(1)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def _drive(server, queue):
    """The reference's ``run`` loop: free slots pull from the queue, then
    one batched decode step."""
    finished = []
    steps = 0
    while queue or any(r is not None for r in server.active):
        for s in range(server.slots):
            if server.active[s] is None and queue:
                server.admit(queue.pop(0), s)
        finished.extend(server.step())
        steps += 1
        assert steps < 100
    return {r.rid: r.out for r in finished}


def test_server_emits_the_reference_tokens():
    cfg = get_config("qwen3_0_6b").reduced()
    ref_cfg = ref_get_config("qwen3_0_6b").reduced()
    ref_model = RefModel(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(1))
    params = params_from_reference(_np_tree(ref_params), torch.float32,
                                   "cpu")
    rng = np.random.default_rng(7)
    # prompts of two lengths, so slots hold different positions
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (8, 5, 8, 11, 6)]
    want = _drive(RefServer(ref_cfg, ref_model, ref_params, 2, 32),
                  [RefRequest(i, p, 6) for i, p in enumerate(prompts)])
    got = _drive(Server(cfg, Model(cfg), params, 2, 32),
                 [Request(i, p, 6) for i, p in enumerate(prompts)])
    assert sorted(got) == list(range(5))
    assert all(len(v) == 6 for v in got.values())
    assert got == want


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "deepseek_v3_671b",
                                  "mamba2_780m", "zamba2_2_7b"])
def test_server_emits_the_reference_tokens_for_each_family(arch):
    """Twin of the dense test for a reduced moe (OLMoE; DeepSeek with
    MLA's compressed cache), ssm and hybrid config: admit tiles and
    writes every leaf of the family's cache tree (the SSM state stays
    float32), and the greedy tokens equal the reference server's."""
    cfg = get_config(arch).reduced()
    ref_cfg = ref_get_config(arch).reduced()
    ref_model = RefModel(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(1))
    params = params_from_reference(_np_tree(ref_params), torch.float32,
                                   "cpu")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (8, 5, 11, 6)]
    want = _drive(RefServer(ref_cfg, ref_model, ref_params, 2, 32),
                  [RefRequest(i, p, 5) for i, p in enumerate(prompts)])
    server = Server(cfg, Model(cfg), params, 2, 32)
    got = _drive(server, [Request(i, p, 5) for i, p in enumerate(prompts)])
    assert sorted(got) == list(range(4))
    assert got == want
    if cfg.family in ("ssm", "hybrid"):
        ssm = server.cache["blocks" if cfg.family == "ssm" else "mamba"]
        assert ssm["ssm"].dtype == torch.float32
        assert ssm["ssm"].shape[:2] == (cfg.n_layers, 2)


def test_run_smoke_on_the_cpu_finishes_every_request():
    out = run(ServeConfig(smoke=True, device="cpu", requests=5,
                          batch_slots=2, max_new=4))
    assert out["requests"] == 5 and out["tokens"] == 20
    assert out["device"] == "cpu"
    assert all(len(v) == 4 for v in out["outputs"].values())
    assert out["prefill_s"] + out["decode_s"] <= out["wall_s"]
