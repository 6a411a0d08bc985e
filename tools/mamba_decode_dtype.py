#!/usr/bin/env python3
"""Where falcon-mamba's bf16 prefill and decode part, on one GPU.

    python3 tools/mamba_decode_dtype.py [--rows 16] [--prompt 16] [--seed 0]

falcon-mamba-7b at its published widths and full depth, bf16, the serving
path's random weights (``--seed``), ``--rows`` prompts of ``--prompt``
tokens.  Serving keeps an fp32 cache, so the port's ``mamba_decode``
computes the mixer in fp32 (the weights cast each step), while the prefill
(``forward(last_only=True)``) computes it in bf16.  This runs the decode
twice, as the port does it (``port``) and with the mixer in the stream's
dtype (``stream_dtype``: the conv window cast to bf16, no weight cast), and
holds each, and the bf16 prefill, against the same weights run in fp32 (TF32
off), whose decode ``chip_smoke.dtype_witness`` also holds against its
forward at every position within 1e-3.  Prints the card's name and power
limit, one JSON line a decode variant (against the bf16 prefill; the device
ms of one graph-replayed decode step at the serving path's 4 slots and 64
positions) and the witness's line.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from chip_smoke import (SERVE_VS_FORWARD, decode_vs_forward, dtype_witness,  # noqa: E402
                        graph_device_ms, nvidia_smi)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import add_lane_axis  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.models import mamba as mam  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

PORT = mam.mamba_decode


def mamba_decode_stream_dtype(p, x, cache, cfg):
    """``mamba_decode`` with the conv window in the stream's dtype: every
    product in the weights' dtype, as the prefill computes them; ``h`` fp32."""
    uz = torch.einsum("kbsd,kdci->kbsci", x, p["in_proj"])
    u, z = uz[:, :, 0, 0], uz[:, :, 0, 1]
    window = torch.cat([cache["conv"].to(u.dtype), u[:, :, None]], dim=2)
    u_conv = F.silu(torch.einsum("kbci,kci->kbi", window, p["conv_w"]) + p["conv_b"][:, None])
    dt_raw, Bc, Cc = mam._split_xproj(torch.einsum("kbi,kij->kbj", u_conv, p["x_proj"]), cfg)
    dt = F.softplus(torch.einsum("kbr,kri->kbi", dt_raw, p["dt_proj"]) + p["dt_bias"][:, None])
    A = -torch.exp(p["A_log"].float())
    y, h = ops.ssm_decode_step(u_conv, dt, A, Bc, Cc, p["D"].float(), cache["h"])
    y = y * F.silu(z)
    out = torch.einsum("kbi,kid->kbd", y, p["out_proj"])[:, :, None]
    cache["conv"].copy_(window[:, :, 1:])
    cache["h"].copy_(h)
    return out, cache


VARIANTS = {"port": PORT, "stream_dtype": mamba_decode_stream_dtype}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=16)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mamba_decode_dtype: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(nvidia_smi(), flush=True)
    build.build()
    cfg = get_config("falcon-mamba-7b")
    params = add_lane_axis(T.init_params(torch.Generator(device=dev).manual_seed(args.seed),
                                         cfg, dev))
    tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(
        1, cfg.vocab_size, size=(1, args.rows, args.prompt))).to(dev)
    last = {}
    for name, fn in VARIANTS.items():
        mam.mamba_decode = fn
        try:
            res, fwd_last, dec_last = decode_vs_forward(torch, dev, cfg, params, tokens)
            cache = T.init_cache(cfg, 1, 4, 64, dtype=torch.float32, device=dev)
            tok = (torch.arange(4, device=dev) + 1).view(1, 4, 1)
            step_ms = graph_device_ms(torch, lambda: T.decode_step(params, cache, tok, 32, cfg),
                                      [()], min_launches=2, replays=3)
            del cache
        finally:
            mam.mamba_decode = PORT
        last["bf16_forward"], last["bf16_decode_" + name] = fwd_last, dec_last
        print(json.dumps({"variant": name, "decode_step_device_ms": step_ms,
                          **{k: res[k] for k in ("rows", "prompt", "max_abs_err",
                                                 "top1_agreeing_rows", "logit_abs_max")}}),
              flush=True)
    torch.cuda.empty_cache()
    out = dtype_witness(torch, dev, cfg, params, tokens, last, SERVE_VS_FORWARD["tol"])
    print(json.dumps({"witness": "fp32 weights, full depth", **out}), flush=True)
    return 0 if out["ok"] and not out["launch_problems"] else 1


if __name__ == "__main__":
    sys.exit(main())
