"""Three-term roofline model from dry-run records (the JAX module's formulas).

    compute    = flops_total            / (chips * PEAK_FLOPS)   [s]
    memory     = bytes_total            / (chips * HBM_BW)       [s]
    collective = collective_bytes_total / (chips * LINK_BW)      [s]

The port of ``repro/analysis/roofline.py``, with one H100's rates in place
of the TPU's.  A dry-run record's numbers are PER RANK (``analysis.cost``
counts what one rank runs), so ``total = per_rank * chips`` and the chips
cancel: each term is per_rank / per_card_rate.  MODEL_FLOPS = 6*N*D (dense)
/ 6*N_active*D (MoE) for train, 2*N*D for inference; for decode shapes
D = tokens per step = global_batch.
"""

from __future__ import annotations

from dataclasses import dataclass

# One NVIDIA H100 SXM (the hopper-kernels guide's table, as PERF.md §6 uses it).
PEAK_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12  # HBM3 bytes/s per card
LINK_BW = 450e9  # NVLink bytes/s per card, each way


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops_total: float
    useful_ratio: float
    dominant: str
    note: str = ""

    @property
    def bound_time(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the ideal MODEL-FLOPS compute roof achieved assuming
        perfect overlap: ideal_time / bound_time."""
        chips = 512 if self.mesh == "2x16x16" else 256
        ideal = self.model_flops / (chips * PEAK_FLOPS)
        return ideal / self.bound_time if self.bound_time > 0 else 0.0


def tokens_per_step(shape_name: str, seq: int, batch: int, kind: str) -> float:
    if kind == "train" or kind == "prefill":
        return float(seq * batch)
    return float(batch)  # decode: one token per sequence


def model_flops(arch_cfg, shape, n_active_params: float) -> float:
    """6*N*D for train; 2*N*D for inference (fwd only)."""
    toks = tokens_per_step(shape.name, shape.seq_len, shape.global_batch, shape.kind)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active_params * toks


def from_record(rec: dict, shape) -> Roofline | None:
    """The roofline of an ``ok`` dry-run record (``hlo_*`` keys: the JAX
    record's names, per rank)."""
    if not rec.get("ok"):
        return None
    flops_dev = rec["hlo_flops_per_device"]
    bytes_dev = rec["hlo_bytes_per_device"]
    coll_dev = sum(rec["collective_bytes_per_device"].values())
    chips = rec["chips"]
    mf = model_flops(None, shape, rec["active_params"])
    compute = flops_dev / PEAK_FLOPS
    memory = bytes_dev / HBM_BW
    collective = coll_dev / LINK_BW
    dom = max(
        [("compute", compute), ("memory", memory), ("collective", collective)],
        key=lambda kv: kv[1],
    )[0]
    total_flops = flops_dev * chips
    return Roofline(
        arch=rec["arch"],
        shape=rec["shape"],
        mesh=rec["mesh"],
        compute_s=compute,
        memory_s=memory,
        collective_s=collective,
        model_flops=mf,
        hlo_flops_total=total_flops,
        useful_ratio=mf / total_flops if total_flops else 0.0,
        dominant=dom,
    )


def fix_suggestion(r: Roofline) -> str:
    """One sentence on what would move the dominant term down."""
    if r.dominant == "compute":
        if r.useful_ratio < 0.5:
            return ("compute-bound with low useful ratio: cut remat recompute "
                    "(policy: save attention outputs) and skip fully-masked "
                    "causal KV blocks")
        return "compute-bound near useful peak: only larger per-chip batch helps"
    if r.dominant == "memory":
        return ("memory-bound: fuse elementwise chains (gossip_mix kernel), "
                "larger matmul tiles, bf16 loss accumulators, widen per-chip batch")
    return ("collective-bound: shrink TP degree for this model size, switch "
            "gossip to matched ppermute, overlap pulls with grad compute, "
            "or compress pulls (top-k/int8)")
