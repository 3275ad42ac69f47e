#!/usr/bin/env python3
"""How far the flash-attention checks' limits sit from a planted fault.

Run from the root of the repository, on a machine with an NVIDIA card:

    python3 tools/flash_fault_margin.py

``chip_smoke.py`` holds the flash kernel against its plain version
(bf16: max abs and normwise) at the serving prefill's shape, and the
serving path's prefill logits against the plain "sdpa" attention
backend (normwise).  A limit is worth what it separates, so this script
prints, for each check, the sound reading (the kernel against its
plain version) beside the readings of faults planted in a plain copy of
the kernel's function, of the kind a loop-bound or tile-load slip would
make:

  drop64 — the last q-block's rows lose keys 0..63 (one whole k-window)
  drop16 — the same rows lose keys 0..15 (a quarter of a window)
  trunc  — the bf16 output rounded toward zero instead of to nearest
  p_bf16 — the PV product taken with the probabilities rounded once to
           the input type (the FA-2/3 shortcut the kernel's mma path
           avoids by carrying P as two 16-bit terms)

The faults live in this script only.  ``--device cpu --smoke`` runs it
at the reduced config on the CPU (the "kernel" is then its plain
version, so the sound readings are 0): a check of the script, not a
measurement.  The last line is a JSON object of every reading.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402

FAULTS = ("drop64", "drop16", "trunc", "p_bf16")
Q_BLOCK = 64  # rows of the "last q-block" the drop faults hit


def normwise(got, want) -> float:
    g, w = got.double(), want.double()
    return float(torch.linalg.norm(g - w) / torch.linalg.norm(w))


def max_abs(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


def faulty_attention(fault: str):
    """The plain version of the kernel's function with ``fault`` planted:
    (q, k, v, causal, scale) -> o, like ``kfa.flash_attention``."""

    def run(q, k, v, *, causal=True, scale=None):
        b, sq, h, d = q.shape
        sk, hkv = k.shape[1], k.shape[2]
        scale = scale if scale is not None else d ** -0.5
        qf = q.reshape(b, sq, hkv, h // hkv, d).float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        keep = (kpos <= qpos) if causal else torch.ones_like(kpos <= qpos)
        if fault in ("drop64", "drop16"):
            last_block = (qpos >= (sq - 1) // Q_BLOCK * Q_BLOCK)
            keep = keep & ~(last_block & (kpos < int(fault[4:])))
        s = torch.where(keep[None, None, None], s,
                        torch.tensor(-1e30, dtype=s.dtype, device=s.device))
        if fault == "p_bf16":
            # unnormalised p in [0, 1] rounded to q's type for PV; the
            # denominator sums the f32 p
            p = torch.exp(s - s.amax(dim=-1, keepdim=True))
            o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(q.dtype).float(),
                             v.float()) / p.sum(-1).permute(0, 3, 1, 2)[
                                 ..., None]
            return o.reshape(b, sq, h, d).to(q.dtype)
        o = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, dim=-1),
                         v.float()).reshape(b, sq, h, d)
        if fault == "trunc" and q.dtype == torch.bfloat16:
            return (o.contiguous().view(torch.int32) & -65536).view(
                torch.float32).to(torch.bfloat16)
        return o.to(q.dtype)

    return run


def kernel_readings(device, seq: int, seed: int) -> dict:
    """The prefill's attention shape (B=1, S=seq, H=16, Hkv=8, D=128,
    causal, bf16): the kernel and each fault against the plain version."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape_q, shape_kv = (1, seq, 16, 128), (1, seq, 8, 128)
    q, k, v = (torch.randn(s, generator=gen, device=device).to(torch.bfloat16)
               for s in (shape_q, shape_kv, shape_kv))
    want = flash_attention_ref(q, k, v, causal=True)
    out = {"mean_abs_o": float(want.float().abs().mean())}
    runs = {"sound": kfa.flash_attention}
    runs.update({f: faulty_attention(f) for f in FAULTS})
    for label, fn in runs.items():
        got = fn(q, k, v, causal=True)
        out[label] = {"max_abs": max_abs(got, want),
                      "normwise": normwise(got, want)}
    return out


def serve_readings(device, arch: str, smoke: bool, seq: int,
                   seed: int) -> dict:
    """One prompt's prefill logits through each attention function, on
    the same weights, against the plain "sdpa" backend: normwise."""
    cfg = get_config(arch)
    cfg = cfg.reduced() if smoke else cfg
    model = Model(cfg)
    params = model.init(seed, device=device)
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size, (seq,))
    tokens = torch.from_numpy(prompt[None]).to(device)
    saved_backend, saved_fn = attn.ATTENTION_BACKEND, kfa.flash_attention
    logits = {}
    try:
        attn.ATTENTION_BACKEND = "sdpa"
        logits["sdpa"], _ = model.prefill(params, tokens=tokens)
        attn.ATTENTION_BACKEND = "flash"
        logits["sound"], _ = model.prefill(params, tokens=tokens)
        for f in FAULTS:
            # attention.py looks the kernel's wrapper up at each call
            kfa.flash_attention = faulty_attention(f)
            logits[f], _ = model.prefill(params, tokens=tokens)
    finally:
        attn.ATTENTION_BACKEND, kfa.flash_attention = saved_backend, saved_fn
    return {label: {"normwise": normwise(lg, logits["sdpa"])}
            for label, lg in logits.items() if label != "sdpa"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="qwen3_0_6b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config (a CPU check)")
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    device = torch.device(args.device)
    card = "cpu"
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("flash_fault_margin: no CUDA device", file=sys.stderr)
            return 1
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
        torch.backends.cuda.matmul.allow_tf32 = False
    result = {"card": card, "seq": args.seq,
              "kernel": kernel_readings(device, args.seq, args.seed),
              "serve": serve_readings(device, args.arch, args.smoke,
                                      args.seq, args.seed)}
    for check in ("kernel", "serve"):
        for label, r in result[check].items():
            if isinstance(r, dict):
                print(f"[{check}] {label:6s} " + ", ".join(
                    f"{k} {x:.3e}" for k, x in r.items()) + f" | {card}")
    print(f"[kernel] mean |o| {result['kernel']['mean_abs_o']:.3e} | {card}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
