"""Configuration dataclasses (the port's copy of repro.core.config).

  * ArchConfig           -- an LM architecture (the attention-only dense
                            archs the engine IR lowers, and the mamba and
                            RG-LRU hybrid archs served on the eager path).
  * CNNConfig / ConvSpec -- a CNN from the paper's own evaluation zoo.
  * EngineConfig         -- the DPUV4E engine feature set.
  * ShapeConfig          -- a (seq_len, global_batch, kind) input shape.
  * TrainConfig          -- optimizer / schedule / fault-tolerance knobs
                            (the reference's, less the fields of paths
                            not ported yet: the mesh fields zero1 and
                            seq_shard_activations, loss_chunk_vocab,
                            scan_layers, triangle_skip and param_dtype
                            join with their slices).

EngineConfig keeps the knobs the served and trained paths read: the quant
mode (with the int4 group size of w4a8), the kernel backend and the
KV-cache dtype.
The reference's other fields (XVDPU baseline, MoE dispatch, Pallas
interpret mode) join with the slices that run them; ArchConfig keeps the
fields the transformer lowering and the mamba / RG-LRU mixers read, and
the MoE / encoder fields only as far as `lowering_blockers` needs them to
refuse an arch.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Tuple

QUANT_MODES = ("none", "w8a8", "w4a8")
BACKENDS = ("ref", "cuda")
KV_DTYPES = ("bf16",)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- attention variants -------------------------------------------------
    qkv_bias: bool = False
    # per-layer block pattern, cycled: "global" | "local" | "recurrent" |
    # "mamba"
    block_pattern: Tuple[str, ...] = ("global",)
    local_window: int = 4096
    attn_softcap: float = 0.0        # gemma2 attention-logit softcap (0 = off)
    final_softcap: float = 0.0       # gemma2 final-logit softcap (0 = off)
    rope_theta: float = 10000.0
    mrope: bool = False              # qwen2-vl multimodal RoPE

    # --- MLP ----------------------------------------------------------------
    mlp_act: str = "silu"            # silu -> SwiGLU, gelu -> GeGLU
    mlp_gated: bool = True           # False: plain up/act/down
    tie_embeddings: bool = True

    # --- SSM / hybrid -------------------------------------------------------
    ssm_state: int = 0               # mamba1 d_state
    ssm_expand: int = 2              # mamba d_inner = expand * d_model
    conv_kernel: int = 4             # mamba / RG-LRU temporal conv width
    lru_width: int = 0               # RG-LRU recurrent width (0 -> d_model)

    # --- what the engine IR does not lower (lowering_blockers) --------------
    n_experts: int = 0
    encoder_layers: int = 0
    frontend: str = ""               # "" | "audio_stub" | "vision_stub"

    # --- norms / misc ---------------------------------------------------------
    norm_eps: float = 1e-6
    post_norms: bool = False         # gemma2-style pre+post block norms
    emb_scale: bool = False          # gemma2 scales embeddings by sqrt(d)
    max_seq_len: int = 524288        # RoPE table cap

    # --- paper-technique applicability metadata ------------------------------
    subquadratic: bool = False       # may run long_500k

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family in ("hybrid",) and self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def layer_kind(self, i: int) -> str:
        return self.block_pattern[i % len(self.block_pattern)]


@dataclass(frozen=True)
class ConvSpec:
    kind: str                        # conv | dwc | pool | add_branch
    out_ch: int = 0
    kernel: int = 3
    stride: int = 1
    repeat: int = 1
    expand: int = 0                  # inverted-residual expansion factor


@dataclass(frozen=True)
class CNNConfig:
    name: str
    input_hw: int
    input_ch: int
    stem_kernel: int
    stem_stride: int
    stem_ch: int
    stages: Tuple[ConvSpec, ...]
    num_classes: int = 1000
    gops: float = 0.0                # paper-reported GOPs per inference


@dataclass(frozen=True)
class EngineConfig:
    # none -> float math (training, and calibration on backend="ref");
    # w8a8 -> int8 x int8 -> int32 (the paper's mode); w4a8 -> w8a8
    # everywhere, except that the LM projection weights pack to per-group
    # int4 (Q4Tensor), unpacked in registers by the int4 Conv PE kernel.
    quant: str = "none"
    # K rows per (scale, zero) group of the w4a8 packing; part of the
    # ProgramCache key through EngineConfig, so group sizes never collide.
    w4_group_size: int = 64
    # "ref" = plain PyTorch (kernels/ref.py), "cuda" = the hand-written
    # Hopper kernels (the reference's "pallas" slot): the int8 / int4
    # engines under w8a8 / w4a8, and under quant="none" the float GEMM
    # (conv_pe.matmul_f_fused) on every float projection.
    backend: str = "ref"
    # serving KV-cache element type
    kv_cache_dtype: str = "bf16"

    def __post_init__(self):
        if self.quant not in QUANT_MODES:
            raise ValueError(f"quant {self.quant!r} not in {QUANT_MODES}")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in {BACKENDS}")
        if self.kv_cache_dtype == "int8":
            raise NotImplementedError(
                "the int8 KV cache is not ported yet (a later LM slice, "
                "after paged bf16 serving); use kv_cache_dtype='bf16'")
        if self.kv_cache_dtype not in KV_DTYPES:
            raise ValueError(f"kv_cache_dtype {self.kv_cache_dtype!r} not "
                             f"in {KV_DTYPES}")


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    z_loss: float = 1e-4
    # Memory / schedule
    remat: str = "block"             # none | block | full
    microbatches: int = 1            # gradient accumulation
    # Fault tolerance
    ckpt_every: int = 100
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    async_ckpt: bool = True
    keep_ckpts: int = 3
    step_timeout_s: float = 0.0      # straggler watchdog (0 = off)
    seed: int = 0
