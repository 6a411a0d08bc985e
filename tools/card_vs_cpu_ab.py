#!/usr/bin/env python3
"""Hold the card against the CPU with each RMSNorm backward, on one GPU.

    python3 tools/card_vs_cpu_ab.py [ARCH ...]

Runs ``chip_smoke.py``'s card_vs_cpu phase (an fp32 smoke config, two lanes,
three population steps on the card and on the CPU from the same state and
batches) once for each choice of the RMSNorm backward on the CPU and on the
card:

    port              closed form on the CPU, the kernel on the card (as the
                      port runs)
    card_closed_form  closed form on both
    cpu_autograd      autograd through the recomputed plain forward on the
                      CPU, the kernel on the card
    autograd          autograd through the recomputed plain forward on both
                      (the backward before the kernel)

so that a change in the errors can be put down to one side.  Prints the
card's name and power limit, then one JSON line per (arch, variant): loss and
parameter max abs errors, the parameter leaf with the largest, and the
RMSNorm backward kernel's launches.  ARCH defaults to chip_smoke's
CARD_VS_CPU.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from chip_smoke import (CARD_VS_CPU, card_vs_cpu_run, nvidia_smi,  # noqa: E402
                        rmsnorm_bwd_autograd)
from repro_torch.kernels import rmsnorm as rn  # noqa: E402

KERNEL = rn.rmsnorm_bwd


def closed_form(x, gamma, dy, eps):
    return rn.rmsnorm_bwd_plain(x, gamma, dy.contiguous(), eps)


VARIANTS = {"port": (KERNEL, KERNEL), "card_closed_form": (KERNEL, closed_form),
            "cpu_autograd": (rmsnorm_bwd_autograd, KERNEL),
            "autograd": (rmsnorm_bwd_autograd, rmsnorm_bwd_autograd)}


def by_device(on_cpu, on_card):
    def bwd(x, gamma, dy, eps):
        return (on_cpu if x.device.type == "cpu" else on_card)(x, gamma, dy, eps)
    return bwd


def main() -> int:
    if not torch.cuda.is_available():
        print("card_vs_cpu_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(nvidia_smi(), flush=True)
    for arch in sys.argv[1:] or CARD_VS_CPU:
        for variant, (on_cpu, on_card) in VARIANTS.items():
            rn.rmsnorm_bwd = by_device(on_cpu, on_card)
            try:
                rec, ok, _ = card_vs_cpu_run(torch, dev, arch)
            finally:
                rn.rmsnorm_bwd = KERNEL
            print(json.dumps({"arch": arch, "variant": variant, "within_1e-4": ok,
                              **{k: rec[k] for k in ("loss_max_abs_err", "param_max_abs_err",
                                                      "param_worst_leaf")},
                              "rmsnorm_bwd_launches": rec["card_launches"]["rmsnorm_bwd"]}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
