"""Three-term roofline of one rank's step, for the NVIDIA H100 80GB HBM3.

The twin of the JAX package's ``launch/roofline.py``, with the same formula
and the same ``Roofline`` fields:

    compute    = flops_per_rank          / PEAK_FLOPS   [s]
    memory     = HBM_bytes_per_rank      / HBM_BW       [s]
    collective = wire_bytes_per_rank     / link_bw      [s]

Inputs come from ``op_cost`` (one rank's walk of its step: the chip count
is already divided out).  The card's constants (SXM part, 700 W; NVIDIA's
data sheet, as ``chip_smoke.py`` states its bounds): 989e12 dense bf16
FLOP/s, 3.35e12 B/s of HBM3, and 80 GB, the memory
``torch.cuda.get_device_properties(0).total_memory`` reports (the smoke
script checks the constant on the card).  The links: NVLink 4 at 450e9
B/s a direction between the 8 GPUs of a node, and 50e9 B/s (400 Gb/s NDR
InfiniBand, one adapter a GPU) for a group that spans more than one node.
The collective term takes the slowest link that a group carrying traffic
crosses (``link_bw``); both production meshes span nodes on every axis, so
there it is 50e9.  None of these link rates was measured: one card has no
link to another.

JAX's ``memory`` term subtracts the bytes inside ``kernel_*`` scopes,
which a Pallas kernel keeps in VMEM on the TPU.  The formula is kept, but
the port's kernels report their own HBM traffic (``kernels/walk.py``), so
the dry run passes no kernel bytes to subtract: ``memory_s ==
memory_unadjusted_s`` there.

MODEL_FLOPS uses the standard estimates (6·N·D for a train step over D
tokens, 2·N_active·D for prefill/decode), divided by the rank count;
``roofline_fraction`` = (MODEL_FLOPS / peak) / max(term).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable

PEAK_FLOPS = 989e12          # dense bf16 FLOP/s (tensor cores)
PEAK_OPS = {"bfloat16": PEAK_FLOPS,
            "float32": 67e12}    # fp32 outside the tensor cores
HBM_BW = 3.35e12             # bytes/s of HBM3
HBM_BYTES_PER_S = HBM_BW
CARD_MEMORY_BYTES = 85_017_493_504   # ``total_memory`` of the H100 80GB HBM3, as torch reports it
NVLINK_BW = 450e9            # bytes/s a direction, within a node
IB_BW = 50e9                 # bytes/s, 400 Gb/s NDR InfiniBand a GPU
GPUS_PER_NODE = 8
ICI_BW = IB_BW               # the production meshes' collective rate

KIND_TO_FLOP_FACTOR = {"train": 6.0, "prefill": 2.0, "decode": 2.0}


def link_bw(groups: Iterable[Iterable[int]]) -> float:
    """The slowest link a collective over any of ``groups`` (each the global
    ranks of one group that carried traffic) crosses: NVLink within a node
    of ``GPUS_PER_NODE`` consecutive ranks, InfiniBand across nodes."""
    bw = NVLINK_BW
    for g in groups:
        if len({r // GPUS_PER_NODE for r in g}) > 1:
            bw = IB_BW
    return bw


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float              # bytes less the kernel bytes passed / HBM_BW
    collective_s: float          # wire bytes / link rate
    memory_unadjusted_s: float   # all the bytes / HBM_BW
    flops_dev: float
    bytes_dev: float             # less the kernel bytes passed
    bytes_dev_raw: float
    kernel_bytes_dev: float
    wire_bytes_dev: float
    model_flops_dev: float
    useful_ratio: float
    bottleneck: str
    roofline_fraction: float

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


def analyse(
    *,
    flops_dev: float,
    bytes_bf16eq_dev: float,
    kernel_bytes_bf16eq_dev: float,
    bytes_raw_dev: float,
    wire_bytes_dev: float,
    n_params_active: float,
    tokens_global: float,
    kind: str,
    n_chips: int,
    peak_flops: float = PEAK_FLOPS,
    hbm_bw: float = HBM_BW,
    ici_bw: float = ICI_BW,
) -> Roofline:
    bytes_adj = max(bytes_bf16eq_dev - kernel_bytes_bf16eq_dev, 0.0)
    compute_s = flops_dev / peak_flops
    memory_s = bytes_adj / hbm_bw
    collective_s = wire_bytes_dev / ici_bw
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)

    model_flops = KIND_TO_FLOP_FACTOR[kind] * n_params_active * tokens_global / n_chips
    useful = model_flops / flops_dev if flops_dev else 0.0
    dominant = max(terms.values())
    frac = (model_flops / peak_flops) / dominant if dominant > 0 else 0.0
    return Roofline(
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        memory_unadjusted_s=bytes_bf16eq_dev / hbm_bw,
        flops_dev=flops_dev,
        bytes_dev=bytes_adj,
        bytes_dev_raw=bytes_raw_dev,
        kernel_bytes_dev=kernel_bytes_bf16eq_dev,
        wire_bytes_dev=wire_bytes_dev,
        model_flops_dev=model_flops,
        useful_ratio=useful,
        bottleneck=bottleneck,
        roofline_fraction=min(frac, 1.0),
    )
