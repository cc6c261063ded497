"""Architecture + shape configuration system.

Every assigned architecture is an ``ArchConfig`` registered under its id;
``--arch <id>`` in the launchers resolves through ``get_arch``.  Input
shapes are global (seq_len x global_batch) and map to one of three lowered
programs: train_step / serve_prefill / serve_step (DESIGN.md §5).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

# ---------------------------------------------------------------------------
# Shapes (assigned): seq_len x global_batch, and which program they lower.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Architectures
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # Layers with MoE MLPs; "all" or "every_2" (jamba-style alternation).
    layout: str = "all"


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int | None = None  # default d_model // 16


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64  # rank of the data-dependent decay LoRA (Finch)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    activation: str = "swiglu"  # swiglu | gelu
    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    rwkv: RWKVConfig | None = None
    # hybrid (jamba): one attention layer per `attn_period` layers, rest mamba.
    attn_period: int = 0
    # encoder-decoder (whisper): encoder layers; n_layers = decoder layers.
    n_enc_layers: int = 0
    enc_seq_len: int = 1500  # frozen encoder frames (audio stub)
    # vlm: number of vision-stub tokens prepended to the text sequence.
    n_vis_tokens: int = 0
    # --- distribution hints -------------------------------------------------
    # Mesh axes that enumerate NetMax workers ("data" => M=16/32; "pod" =>
    # M=#pods with FSDP+TP inside — for models too big to replicate per-row).
    worker_axes: tuple = ("pod", "data")
    fsdp: bool = False
    # --- TP head padding (§Perf hillclimb) ------------------------------------
    # Extra zero-initialized q / kv heads so head counts divide the TP degree
    # (inert at init: padded q rows are zero AND their wo rows are zero, so
    # they contribute exactly nothing; they add ~pad/H flops but unlock
    # 16-way TP instead of replicated attention).
    pad_heads: int = 0
    pad_kv_heads: int = 0
    # --- numerics ------------------------------------------------------------
    dtype: str = "bfloat16"
    remat: bool = True
    # Gradient-accumulation microbatches per round (bounds saved-activation
    # memory: peak ~ (b/microbatches) * S * d_model * n_layers * 2B).
    microbatches: int = 1
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_heads_eff(self) -> int:
        return self.n_heads + self.pad_heads

    @property
    def n_kv_heads_eff(self) -> int:
        return self.n_kv_heads + self.pad_kv_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve 500k-token contexts?  SSM/hybrid only."""
        return self.family in ("ssm", "hybrid")

    def supports(self, shape: ShapeSpec) -> bool:
        if shape.name == "long_500k":
            return self.sub_quadratic
        return True

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            dtype="float32",
            remat=False,
        )
        if self.moe is not None:
            # capacity_factor 2.0: no token drops at smoke-test sizes, so
            # decode matches teacher-forced forward exactly.
            kw["moe"] = replace(
                self.moe, n_experts=4, top_k=min(self.moe.top_k, 2), capacity_factor=2.0
            )
        if self.mamba is not None:
            kw["mamba"] = MambaConfig(d_state=4, d_conv=4, expand=2, dt_rank=8)
        if self.rwkv is not None:
            kw["rwkv"] = RWKVConfig(head_dim=16, decay_lora=8)
        if self.attn_period:
            kw["attn_period"] = 2
            kw["n_layers"] = 4
        if self.n_enc_layers:
            kw["n_enc_layers"] = 2
            kw["enc_seq_len"] = 32
        if self.n_vis_tokens:
            kw["n_vis_tokens"] = 8
        return replace(self, **kw)


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        # Import the per-arch modules lazily so `configs.base` has no deps.
        from repro_torch import configs as _c  # noqa: F401

        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_archs() -> dict[str, ArchConfig]:
    _load_all()
    return dict(_REGISTRY)


_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    import importlib

    for mod in (
        "internvl2_1b",
        "phi35_moe",
        "llama4_maverick",
        "rwkv6_7b",
        "jamba_v01",
        "starcoder2_3b",
        "qwen15_05b",
        "tinyllama_11b",
        "stablelm_12b",
        "whisper_small",
        "netmax_paper",
    ):
        importlib.import_module(f"repro_torch.configs.{mod}")
    _LOADED = True
