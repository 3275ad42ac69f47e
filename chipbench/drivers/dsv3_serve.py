"""Driver: DeepSeek-V3 served by the port's ``Server`` on one card.

Set-up: the model of the configuration's file
(``DeepSeekV3Config.from_hf``: the published widths, and the experts,
vocabulary and depth one card of the stated deployment holds) under
``Model(cfg, NO_MESH)``; its weights drawn here from the seed in the
reference's layout, with the deviations the file's ``init`` states
(:func:`draw_weights`), and handed to the port through its own names
(:func:`load_params`), the one tree both the port and the reference
compute with; a queue of ``requests`` requests from the seed,
prompt lengths log-uniform over [``prompt_min``, ``prompt_max``]
(stratified a batch of ``slots``: :func:`_requests`) and ids uniform
over the vocabulary held, each decoding greedily until its slot
reaches ``max_len``; every slot admitted (prefilled), then
``warmup_steps`` decode steps.

A call is one pass of the serving loop: every free slot admits the next
queued request, then one batched decode step through ``Server.step``,
which ends in reading the step's tokens to the host.  ``flops_per_call``
is a plain implementation's work over the window at each call's real
shapes (:class:`Counts`): every product a token touches, the absorbed
attention at each slot's live context, the held experts' products of
the slots routed to them (``moe.count_held_slots``), and any prefill,
with K and V expanded, causal.

After the window, ``compare_slots`` slots drawn from the seed are each
compared with the plain reference (``reference/deepseek_v3.py``,
float32, on the card) over their prompt and the tokens their request
generated: the logits at the prompt's last position and at the last
``compare_steps`` decode steps (the requests decode on, untimed, where
a short traced window left them fewer).  One compared row:
``normwise``, the largest over the slots of ||L - R||_F / ||R||_F, and
``route_mismatch``, the (position, MoE layer) pairs of all of them
whose held experts chosen differ, each with a limit; ``maxrel`` =
max|L - R| / max|R| in the notes, with none (a held expert chosen
otherwise at one position moves that position's logits as far as the
control moves every position's).  The control puts
the reference with every product's inputs rounded to float8_e4m3fn in
the program's place.
"""
from __future__ import annotations

import collections
import math
import random
import sys
import time
import zlib
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parents[1]
if str(BENCH_DIR) not in sys.path:
    sys.path.insert(0, str(BENCH_DIR))

from reference import deepseek_v3 as reference  # noqa: E402
from yardstick import env, peaks  # noqa: E402
# the program's spans reduced beside the trace; named as the other
# drivers name their tracer, which ``traced_spans.py`` swaps by name
from yardstick.spans import SpanTracer as Tracer  # noqa: E402
from yardstick.window import closed_loop  # noqa: E402


class Counts:
    """Operations and bytes of a plain implementation of the
    configuration ``hf`` (a DeepSeek-V3 ``config.json``'s keys): a
    product of (m, k) by (k, n) is 2mkn operations; each tensor is read
    or written once in the configuration's dtype."""

    def __init__(self, hf: dict, itemsize: int):
        d, H = hf["hidden_size"], hf["num_attention_heads"]
        self.d, self.H, self.item = d, H, itemsize
        self.nope, self.rope = hf["qk_nope_head_dim"], hf["qk_rope_head_dim"]
        self.vd, self.r = hf["v_head_dim"], hf["kv_lora_rank"]
        self.ff = hf["moe_intermediate_size"]
        self.layers = hf["num_hidden_layers"]
        dense = hf["first_k_dense_replace"]
        qr = hf["q_lora_rank"]
        mla = 2 * (d * qr + qr * H * (self.nope + self.rope)
                   + d * (self.r + self.rope) + H * self.vd * d)
        self.head = 2 * d * hf["vocab_size"]
        # every product of one token but the attention's and the routed
        # experts': MLA's projections, layer 0's MLP, the shared expert,
        # the router, the head
        self.token = (self.layers * mla + dense * 6 * d
                      * hf["intermediate_size"]
                      + (self.layers - dense)
                      * (6 * d * self.ff * hf["n_shared_experts"]
                         + 2 * d * hf["experts_routed_over"])
                      + self.head)
        # a prefill's K and V expanded from the latent, a token a layer
        self.expand = 2 * self.r * H * (self.nope + self.vd)
        self.slot = 6 * d * self.ff   # a (token, slot) on a held expert

    def attention(self, ctx: np.ndarray) -> float:
        """One layer's absorbed decode at each slot's live context:
        W_uk into q, the scores over latent and rope key, the latent
        sum, W_uv."""
        return float(2 * self.H * (self.nope * self.r * len(ctx)
                                   + ctx.sum() * (2 * self.r + self.rope)
                                   + self.r * self.vd * len(ctx)))

    def decode(self, ctx: np.ndarray, held: int) -> float:
        return (len(ctx) * self.token + self.layers * self.attention(ctx)
                + held * self.slot)

    def prefill(self, s: int, held: int) -> float:
        """A prompt of ``s`` tokens: its logits at the last position."""
        qk, v = self.nope + self.rope, self.vd
        causal = 2 * self.H * (qk + v) * s * (s + 1) // 2
        return float(s * (self.token - self.head + self.layers * self.expand)
                     + self.head + self.layers * causal + held * self.slot)

    def decode_bytes(self, ctx: np.ndarray) -> float:
        """One layer's absorbed decode: the live latent cache, W_uk and
        W_uv, q in and the output out."""
        b = len(ctx)
        return float(self.item * (ctx.sum() * (self.r + self.rope)
                                  + self.r * self.H * (self.nope + self.vd)
                                  + b * self.H * (self.nope + self.rope)
                                  + b * self.H * self.vd))

    def mla_decode_least_s(self, ctx: np.ndarray, dtype: str) -> float:
        t, _ = peaks.least_time(self.attention(ctx), self.decode_bytes(ctx),
                                dtype)
        return self.layers * t

    def experts_least_s(self, counts, dtype: str) -> float:
        """One layer call's held experts: the counted slots' operations;
        the weights of each expert with a slot read once, the rows in
        and out."""
        n = sum(counts)
        used = sum(1 for c in counts if c)
        nbytes = self.item * (used * 3 * self.d * self.ff + 2 * n * self.d)
        t, _ = peaks.least_time(n * self.slot, nbytes, dtype)
        return t


def _leaf_seed(seed: int, *key) -> int:
    """The seed that draws the weight ``key`` (names and numbers) of the
    weights of ``seed``."""
    entropy = [seed % 2**64, zlib.crc32(repr(key).encode())]
    return int(np.random.SeedSequence(entropy).generate_state(
        1, np.uint64)[0] >> 1)


def draw_weights(hf: dict, seed: int, device, dtype) -> dict:
    """The weights of the configuration ``hf``, drawn from ``seed`` in
    the reference's layout (``reference/deepseek_v3.py``): each matrix
    N(0, 1/fan_in), fan_in its rows; the embedding N(0,
    ``embed_std``^2), the selection bias N(0, ``bias_std``^2) and the
    norms ``norm``, of ``hf["init"]``; router and bias in float32, the
    rest in ``dtype``.  Each weight of each layer draws from a seed of
    its own, a routed expert's from one of its number among all
    ``experts_routed_over``: the experts held (``n_routed_experts`` from
    ``first_held_expert``) hold those experts' weights, whatever the
    share."""
    import torch

    init, f32 = hf["init"], torch.float32
    d, H = hf["hidden_size"], hf["num_attention_heads"]
    nope, rd, vd = (hf["qk_nope_head_dim"], hf["qk_rope_head_dim"],
                    hf["v_head_dim"])
    r, qr, ff = hf["kv_lora_rank"], hf["q_lora_rank"], \
        hf["moe_intermediate_size"]
    lo, n = hf["first_held_expert"], hf["n_routed_experts"]
    g = torch.Generator(device=device)

    def normal(shape, std, *key, dt=dtype):
        g.manual_seed(_leaf_seed(seed, *key))
        return torch.randn(shape, generator=g, dtype=f32,
                           device=device).mul_(std).to(dt)

    def matrix(rows, cols, *key, dt=dtype):
        return normal((rows, cols), rows ** -0.5, *key, dt=dt)

    def norm(width):
        return torch.full((width,), float(init["norm"]), dtype=dtype,
                          device=device)

    def swiglu(width, *key):
        return {"wg": matrix(d, width, *key, "wg"),
                "wi": matrix(d, width, *key, "wi"),
                "wo": matrix(width, d, *key, "wo")}

    def layer(i):
        w = {"ln1": norm(d), "ln2": norm(d), "attn": {
            "wq_a": matrix(d, qr, i, "wq_a"), "q_a_norm": norm(qr),
            "wq_b": matrix(qr, H * (nope + rd), i, "wq_b"),
            "wkv_a": matrix(d, r + rd, i, "wkv_a"), "kv_a_norm": norm(r),
            "wkv_b": matrix(r, H * (nope + vd), i, "wkv_b"),
            "wo": matrix(H * vd, d, i, "wo")}}
        if i < hf["first_k_dense_replace"]:
            w["mlp"] = swiglu(hf["intermediate_size"], i, "mlp")
            return w
        E = hf["experts_routed_over"]
        held = range(lo, lo + n)
        w["moe"] = {
            "router": matrix(d, E, i, "router", dt=f32),
            "bias": normal((E,), init["bias_std"], i, "bias", dt=f32),
            "w_gate": torch.stack([matrix(d, ff, i, "expert", e, "wg")
                                   for e in held]),
            "w_up": torch.stack([matrix(d, ff, i, "expert", e, "wi")
                                 for e in held]),
            "w_down": torch.stack([matrix(ff, d, i, "expert", e, "wo")
                                   for e in held]),
            "shared": swiglu(ff * hf["n_shared_experts"], i, "shared")}
        return w

    def stacked(layers):
        """The layers' weights on a leading dim, filled a layer at a
        time."""
        first = layer(layers[0])

        def empty(t):
            return ({k: empty(v) for k, v in t.items()} if isinstance(t, dict)
                    else t.new_empty((len(layers),) + tuple(t.shape)))

        def fill(out, t, j):
            if isinstance(t, dict):
                for k in t:
                    fill(out[k], t[k], j)
            else:
                out[j].copy_(t)
        out = empty(first)
        for j, i in enumerate(layers):
            fill(out, first if j == 0 else layer(i), j)
        return out

    dense = hf["first_k_dense_replace"]
    V = hf["vocab_size"]
    w = {"embed": normal((V, d), init["embed_std"], "embed"),
         "final_norm": norm(d), "lm_head": matrix(d, V, "lm_head")}
    if dense:
        w["dense_blocks"] = stacked(range(dense))
    w["moe_blocks"] = stacked(range(dense, hf["num_hidden_layers"]))
    return w


def load_params(model, weights: dict) -> dict:
    """``model``'s parameter tree made of ``weights``, by the port's own
    names (``Model.abstract``): each leaf the weights' tensor itself, of
    the shape and dtype the port builds.  A name that either lacks, or
    another shape or dtype, raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    device = weights["embed"].device
    with FakeTensorMode():
        want = model.abstract(device)

    def take(mine, theirs, path):
        if isinstance(mine, dict) != isinstance(theirs, dict):
            raise ValueError(f"{path}: a tree on one side, a leaf on the "
                             f"other")
        if isinstance(mine, dict):
            if set(mine) != set(theirs):
                raise KeyError(f"{path}: the port names {sorted(mine)}, "
                               f"the weights {sorted(theirs)}")
            return {k: take(mine[k], theirs[k], f"{path}/{k}") for k in mine}
        if (tuple(mine.shape), mine.dtype) != (tuple(theirs.shape),
                                               theirs.dtype):
            raise ValueError(f"{path}: the port builds {tuple(mine.shape)} "
                             f"{mine.dtype}, the weights hold "
                             f"{tuple(theirs.shape)} {theirs.dtype}")
        return theirs
    return take(want, weights, "")


def _requests(Request, tr: dict, vocab: int, seed: int):
    """The queue of ``requests`` requests: each prompt's length
    log-uniform over [``prompt_min``, ``prompt_max``], drawn stratified:
    each run of ``slots`` requests takes one length from each of
    ``slots`` equal strata of the log scale, in a seeded order, so every
    batch that fills the slots holds the same spread of lengths and the
    window's work hardly moves with the seed; ids uniform over
    ``vocab``."""
    rng = np.random.default_rng(seed)
    n, k = int(tr["requests"]), int(tr["slots"])
    lo, hi = int(tr["prompt_min"]), int(tr["prompt_max"])
    u = np.concatenate([(rng.permutation(k) + rng.uniform(size=k)) / k
                        for _ in range(-(-n // k))])[:n]
    lens = np.minimum(np.exp(math.log(lo) + u * math.log((hi + 1) / lo))
                      .astype(np.int64), hi)
    ids = rng.integers(0, vocab, int(lens.sum())).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return collections.deque(
        Request(i, ids[s:s + m], int(tr["max_len"]))
        for i, (s, m) in enumerate(zip(starts, lens)))


class Loop:
    """The serving loop around one ``Server``, with the counts of the
    calls since :meth:`open` and what the watched slots' comparisons
    need: each one's request, its prefill logits and routes, and its
    last ``keep`` decode steps' (request, position, logits, routes)."""

    def __init__(self, server, queue, counts: Counts, moe, watched, keep: int,
                 dtype: str):
        self.server, self.queue, self.c, self.moe = server, queue, counts, moe
        self.watched, self.keep, self.dtype = list(watched), keep, dtype
        self.steps = {s: collections.deque(maxlen=keep) for s in self.watched}
        self.req, self.prefilled = {}, {}
        self.open()

    def open(self) -> None:
        self.flops = 0.0
        self.mla_least_s = self.experts_least_s = 0.0
        self.counters = {"decode_steps": 0, "prefills": 0,
                         "prefill_tokens": 0, "held_slots": 0,
                         "decoded_tokens": 0}

    def _held(self, calls) -> int:
        for counts in calls:
            self.experts_least_s += self.c.experts_least_s(counts, self.dtype)
        n = sum(sum(c) for c in calls)
        self.counters["held_slots"] += n
        return n

    def admit(self, slot: int) -> None:
        req = self.queue.popleft()
        with self.moe.count_held_slots() as held, \
                self.moe.record_routes() as routes:
            self.server.admit(req, slot)
        self.flops += self.c.prefill(len(req.prompt), self._held(held))
        self.counters["prefills"] += 1
        self.counters["prefill_tokens"] += len(req.prompt)
        if slot in self.steps:
            self.req[slot] = req
            self.prefilled[slot] = {
                "logits": self.server.last_logits.clone(),
                "routes": [r[-1] for r in routes]}

    def __call__(self, i: int) -> None:
        server = self.server
        for s in range(server.slots):
            if server.active[s] is None and self.queue:
                self.admit(s)
        live = [s for s, r in enumerate(server.active) if r is not None]
        ctx = server.pos[live].astype(np.int64) + 1
        at = {s: (server.active[s].rid, int(server.pos[s]))
              for s in self.watched if server.active[s] is not None}
        with self.moe.count_held_slots() as held, \
                self.moe.record_routes() as routes:
            server.step()
        self.flops += self.c.decode(ctx, self._held(held))
        self.mla_least_s += self.c.mla_decode_least_s(ctx, self.dtype)
        self.counters["decode_steps"] += 1
        self.counters["decoded_tokens"] += len(live)
        for s, (rid, pos) in at.items():
            self.steps[s].append((rid, pos, server.last_logits[s].clone(),
                                  [r[s] for r in routes]))

    def short(self) -> bool:
        """Whether a watched slot's request is still decoding with fewer
        than ``keep`` of its decode steps held."""
        for s in self.watched:
            req = self.server.active[s]
            if req is not None and sum(
                    st[0] == req.rid for st in self.steps[s]) < self.keep:
                return True
        return False


def _held_sets(rows, hf) -> list:
    lo, n = hf["first_held_expert"], hf["n_routed_experts"]
    return [frozenset(e for e in row.tolist() if lo <= e < lo + n)
            for row in rows]


def compare_slot(loop: Loop, slot: int, params, hf: dict, program: str,
                 device: str) -> dict:
    """One watched slot's logits and held experts chosen against the
    reference's full forward over its request's tokens."""
    import torch

    req, first = loop.req[slot], loop.prefilled[slot]
    steps = [st for st in loop.steps[slot] if st[0] == req.rid]
    fed = len(req.prompt) + len(req.out) - 1   # tokens whose logits exist
    tokens = torch.as_tensor(np.concatenate([req.prompt, req.out])[:fed],
                             dtype=torch.long, device=device)
    at = [len(req.prompt) - 1] + [pos for _, pos, _, _ in steps]
    if program == "port":
        got = torch.stack([first["logits"]] + [lg for _, _, lg, _ in steps])
        got_routes = [torch.stack([r0] + [r[j] for _, _, _, r in steps])
                      for j, r0 in enumerate(first["routes"])]
    else:
        got, full = reference.forward(params, tokens, hf, at=at,
                                      mm=reference.fp8_matmul)
        got_routes = [r[at] for r in full]
    want, full = reference.forward(params, tokens, hf, at=at)
    want_routes = [r[at] for r in full]
    got = got.float()
    differ = [[a != b for a, b in zip(_held_sets(g, hf), _held_sets(w, hf))]
              for g, w in zip(got_routes, want_routes)]
    return {"normwise": float(torch.linalg.norm(got - want)
                              / torch.linalg.norm(want)),
            "maxrel": float((got - want).abs().max() / want.abs().max()),
            "route_mismatch": sum(map(sum, differ)),
            "route_positions": sum(map(any, zip(*differ))),
            "slot": slot, "request": req.rid, "positions": len(at),
            "tokens": fed}


def compare(loop: Loop, params, hf: dict, program: str, device: str
            ) -> dict:
    """The watched slots' comparisons as one row: ``normwise`` and
    ``maxrel`` the largest of any slot, ``route_mismatch`` and
    ``positions`` summed, each slot's own under ``slots``."""
    rows = [compare_slot(loop, s, params, hf, program, device)
            for s in loop.watched]
    return {"normwise": max(r["normwise"] for r in rows),
            "maxrel": max(r["maxrel"] for r in rows),
            "route_mismatch": sum(r["route_mismatch"] for r in rows),
            "positions": sum(r["positions"] for r in rows),
            "pairs": sum(r["positions"] for r in rows) * (
                hf["num_hidden_layers"] - hf["first_k_dense_replace"]),
            "slots": rows}


def run(job) -> dict:
    import torch

    # the port's pieces first: a checkout without them fails here, at once
    from repro_torch.configs.deepseek_v3_ep import DeepSeekV3Config
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import Model, moe
    from repro_torch.models.sharding import NO_MESH

    hf, tr = job.config, job.traffic
    device = hf.get("device", "cuda")
    cuda = device.split(":")[0] == "cuda"
    dtype = hf["dtype"]
    notes = []
    t = time.perf_counter()
    cfg = DeepSeekV3Config.from_hf(hf, dtype=dtype, name=hf["name"])
    model = Model(cfg, NO_MESH)
    weights = draw_weights(hf, job.seed, device, getattr(torch, dtype))
    if cuda:
        torch.cuda.synchronize()
    notes.append(f"set-up: weights drawn in {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    params = load_params(model, weights)
    notes.append(f"set-up: weights loaded in {time.perf_counter() - t:.3f} s")
    slots, max_len = int(tr["slots"]), int(tr["max_len"])
    queue = _requests(Request, tr, cfg.vocab_size, job.seed)
    server = Server(cfg, model, params, slots, max_len)
    counts = Counts(hf, getattr(torch, dtype).itemsize)
    watched = random.Random(job.seed).sample(
        range(slots), min(int(tr["compare_slots"]), slots))
    loop = Loop(server, queue, counts, moe, watched,
                int(tr["compare_steps"]), dtype)
    t = time.perf_counter()
    for s in range(slots):
        loop.admit(s)
    notes.append(f"set-up: {loop.counters['prefills']} prompts, "
                 f"{loop.counters['prefill_tokens']} tokens, prefilled in "
                 f"{time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    for i in range(int(tr["warmup_steps"])):
        loop(i)
    notes.append(f"set-up: {tr['warmup_steps']} decode steps in "
                 f"{time.perf_counter() - t:.3f} s")

    tracer = Tracer(device) if job.trace else None
    if tracer is not None:
        tracer.warm()
    loop.open()
    if tracer is None:
        opened = time.perf_counter()
        win = closed_loop(loop, job.seconds)
        summaries = None
    else:
        with tracer:
            opened = time.perf_counter()

            def traced(i):
                with tracer.span():
                    return loop(i)
            win = closed_loop(traced, float("inf"),
                              max_calls=int(tr["trace_calls"]))
        summaries = [tracer.summary()]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    modules = env.forbidden_modules()
    flops, counters = loop.flops, dict(loop.counters)
    mla_least_s, experts_least_s = loop.mla_least_s, loop.experts_least_s

    # a short (traced) window leaves a watched request fewer decode
    # steps than the comparison takes: they decode on, untimed
    extra = 0
    while loop.short():
        loop(win.calls + extra)
        extra += 1
    server.cache = None
    loop.server = server = None
    if cuda:
        torch.cuda.empty_cache()
    row = compare(loop, params, hf, job.program, device)
    notes.append(f"compared {len(row['slots'])} slots ({extra} steps after "
                 f"the window) at {row['positions']} positions, "
                 f"{row['pairs']} (position, MoE layer) pairs; maxrel (no "
                 f"limit) {row['maxrel']:.6e}")
    for r in row["slots"]:
        notes.append(f"slot {r['slot']} (request {r['request']}, "
                     f"{r['tokens']} tokens): normwise {r['normwise']:.6e}, "
                     f"maxrel {r['maxrel']:.6e}, route_mismatch "
                     f"{r['route_mismatch']}, {r['route_positions']} "
                     f"positions with a held expert differing")
    return {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name() if cuda else "cpu",
        "chips": 1,
        "dtype": dtype,
        "flops_per_call": flops / win.calls,
        "mla_decode_least_s": mla_least_s,
        "expert_least_s": experts_least_s,
        "calls": win.calls,
        "window_s": win.window_s,
        "latencies_s": win.latencies_s,
        "setup_s": opened - job.t0,
        "peak_bytes": peak,
        "counters": counters,
        "trace": summaries,
        "compared": [row],
        "modules": modules,
        "notes": notes,
    }
