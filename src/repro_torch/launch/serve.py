"""Batched serving driver: continuous-batching-lite inference loop.

The counterpart of the reference's ``launch/serve.py``.  It keeps a
fixed-size decode batch; each slot holds one request.  Finished
requests (max_tokens) free their slot, and queued requests are
prefilled into it — slots pull work as they free up, so fast and slow
requests never block each other.  Weights and caches live on the
config's device: the card unless the caller asks for the CPU.  It
serves the dense, moe, ssm and hybrid families; an encdec model takes
encoder states that ``run`` does not make (nor does the reference's),
so it is driven through ``Model.prefill`` / ``decode`` directly.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_0_6b \\
      --smoke --requests 8 --max-new 16             # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke \\
      --prompt-len 1024 --max-len 1088              # full width
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from ..configs import get_config
from ..models import Model
from ..models.moe import count_drops
from ..models.sharding import NO_MESH
from ..models.transformer import tree_map


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class ServeConfig:
    arch: str = "qwen3_0_6b"
    smoke: bool = True
    batch_slots: int = 4
    prompt_len: int = 16
    max_len: int = 64
    requests: int = 8
    max_new: int = 16
    greedy: bool = True
    seed: int = 0
    device: str = "cuda"


class Server:
    """One-model batch server with per-slot caches on the parameters'
    device."""

    def __init__(self, cfg, model: Model, params, batch_slots: int,
                 max_len: int):
        self.cfg = cfg
        self.model = model
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.device = params["embed"].device
        self.cache = None        # batched cache, built from first prefill
        self.nonfinite_logits = 0  # prefills and steps with a NaN/inf logit
        # the float32 logits of the last prefill (its last position, (V,))
        # or decode step ((slots, V)), for a caller to compare
        self.last_logits: Optional[torch.Tensor] = None
        # each decode step's dropped expert slots (a MoE model's; the
        # free slots' tokens are routed too)
        self.decode_drops: List[int] = []
        self.pos = np.zeros((batch_slots,), np.int32)
        self.active: List[Optional[Request]] = [None] * batch_slots
        self.last_token = np.zeros((batch_slots,), np.int32)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.int64)).to(self.device)

    # ------------------------------------------------------------- admit
    def admit(self, req: Request, slot: int) -> None:
        logits, cache = self.model.prefill(
            self.params, tokens=self._tensor(req.prompt[None, :]))
        cache = self.model.pad_cache(cache, self.max_len)
        # greedy: torch.argmax takes the first index on ties, as
        # jnp.argmax does
        self.last_logits = logits[0, -1]
        tok = int(torch.argmax(logits[0, -1]))
        self.nonfinite_logits += int(not torch.isfinite(logits).all())
        req.out.append(tok)
        if self.cache is None:
            # build the batched cache by tiling the first request's
            self.cache = tree_map(
                lambda a: torch.repeat_interleave(a, self.slots, dim=1),
                cache)
        # write this request's cache into its slot (in place); every leaf
        # of every family's tree holds the batch on axis 1
        tree_map(lambda big, one: big[:, slot].copy_(one[:, 0]),
                 self.cache, cache)
        self.pos[slot] = len(req.prompt)
        self.last_token[slot] = tok
        self.active[slot] = req

    # ------------------------------------------------------------- step
    def step(self) -> List[Request]:
        """One batched decode step; returns requests that finished."""
        tok = self._tensor(self.last_token)
        pos = self._tensor(self.pos)
        with count_drops() as drops:
            logits, self.cache = self.model.decode(self.params, self.cache,
                                                   tok, pos)
        self.last_logits = logits
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        self.nonfinite_logits += int(not torch.isfinite(logits).all())
        if drops:
            self.decode_drops.append(int(sum(drops)))
        done: List[Request] = []
        for s, req in enumerate(self.active):
            if req is None or req.done:
                continue
            req.out.append(int(nxt[s]))
            self.pos[s] += 1
            self.last_token[s] = nxt[s]
            if len(req.out) >= req.max_new or self.pos[s] >= self.max_len - 1:
                req.done = True
                done.append(req)
                self.active[s] = None  # slot freed -> next request pulls in
        return done


def run(sc: ServeConfig) -> dict:
    """Serve ``sc.requests`` random prompts to completion.  Each prefill
    and decode step ends in a device-to-host read of its tokens, so the
    host clock around them measures finished device work: ``prefill_s``
    and ``decode_s`` split ``wall_s`` between the two."""
    cfg = get_config(sc.arch)
    if sc.smoke:
        cfg = cfg.reduced()
    model = Model(cfg, NO_MESH)
    params = model.init(sc.seed, device=sc.device)
    rng = np.random.default_rng(sc.seed)
    queue = [Request(i, rng.integers(0, cfg.vocab_size,
                                     (sc.prompt_len,)).astype(np.int32),
                     sc.max_new) for i in range(sc.requests)]
    server = Server(cfg, model, params, sc.batch_slots, sc.max_len)
    finished: List[Request] = []
    t0 = time.perf_counter()
    steps = 0
    prefill_s = decode_s = 0.0
    while queue or any(r is not None for r in server.active):
        # demand-driven admission: every free slot pulls from the queue
        for s in range(server.slots):
            if server.active[s] is None and queue:
                t = time.perf_counter()
                server.admit(queue.pop(0), s)
                prefill_s += time.perf_counter() - t
        t = time.perf_counter()
        finished.extend(server.step())
        decode_s += time.perf_counter() - t
        steps += 1
        if steps > 10000:
            raise RuntimeError("serve loop did not converge")
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in finished)
    if len(finished) != sc.requests:
        raise RuntimeError(f"{len(finished)} of {sc.requests} requests "
                           f"finished")
    return {"steps": steps, "wall_s": dt, "prefill_s": prefill_s,
            "decode_s": decode_s, "requests": len(finished),
            "tokens": toks, "tok_per_s": toks / dt if dt else 0.0,
            "nonfinite_logits": server.nonfinite_logits,
            "decode_drops": server.decode_drops,
            "device": str(params["embed"].device),
            "outputs": {r.rid: r.out for r in finished}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    for f in dataclasses.fields(ServeConfig):
        name = "--" + f.name.replace("_", "-")
        if isinstance(f.default, bool):
            ap.add_argument(name, action=argparse.BooleanOptionalAction,
                            default=f.default)
        else:
            ap.add_argument(name, type=type(f.default), default=f.default)
    args = ap.parse_args(argv)
    sc = ServeConfig(**{f.name: getattr(args, f.name)
                        for f in dataclasses.fields(ServeConfig)})
    out = run(sc)
    print(f"[serve] {out['requests']} requests, {out['tokens']} tokens in "
          f"{out['wall_s']:.2f}s ({out['tok_per_s']:.1f} tok/s, "
          f"{out['steps']} decode steps, prefill {out['prefill_s']:.2f}s, "
          f"decode {out['decode_s']:.2f}s, on {out['device']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
