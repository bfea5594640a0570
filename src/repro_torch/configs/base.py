"""Model configuration dataclass shared by every architecture: a copy of the
JAX package's ``repro/configs/base.py``, which is framework-free, kept here
so that the port imports nothing of that package.  Fields and defaults are
the reference's, so a config means the same in both."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int          # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0       # 0 => d_model // num_heads

    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    window: Optional[int] = None          # sliding-window size (None = full)
    rope_theta: float = 10_000.0
    q_chunk_size: int = 1024              # query-chunked attention for long S

    # MLP
    mlp_type: str = "swiglu"              # swiglu | gelu

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_dense_ff: int = 0                 # arctic-style parallel dense MLP
    capacity_factor: float = 1.25

    # hybrid (RG-LRU / Griffin): repeating block pattern, e.g.
    # ("rec", "rec", "attn"); empty tuple = pure attention stack
    block_pattern: Tuple[str, ...] = ()
    lru_width: int = 0                    # 0 => d_model
    conv_width: int = 4

    # RWKV6
    is_rwkv: bool = False
    rwkv_head_dim: int = 64

    # io
    input_mode: str = "tokens"            # tokens | embeddings (audio/vlm stub)
    tie_embeddings: bool = False

    # numerics / training
    param_dtype: str = "float32"
    activation_dtype: str = "bfloat16"
    remat: bool = True
    # the reference's layer-stack loop form (XLA while loop or unrolled);
    # the port runs the stack as a Python loop either way
    scan_layers: bool = True
    optimizer: str = "adamw"              # adamw | adafactor
    logits_chunk: int = 512               # chunked xent over sequence

    # attention implementation: xla_chunked (plain torch, query-chunked) |
    # flash (the hand-written CUDA kernel; its plain version on CPU tensors)
    attention_impl: str = "xla_chunked"

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if not self.lru_width:
            object.__setattr__(self, "lru_width", self.d_model)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_hybrid(self) -> bool:
        return bool(self.block_pattern)

    @property
    def attends(self) -> bool:
        return not self.is_rwkv

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve a 500k-token context?"""
        return self.is_rwkv or self.is_hybrid or self.window is not None

    # ---- parameter counting (for MODEL_FLOPS = 6 N D) -----------------
    def attn_params(self) -> int:
        hd = self.head_dim
        q = self.d_model * self.num_heads * hd
        kv = 2 * self.d_model * self.num_kv_heads * hd
        o = self.num_heads * hd * self.d_model
        bias = (self.num_heads + 2 * self.num_kv_heads) * hd if self.qkv_bias else 0
        return q + kv + o + bias

    def mlp_params(self, d_ff: Optional[int] = None) -> int:
        f = d_ff or self.d_ff
        n_mat = 3 if self.mlp_type == "swiglu" else 2
        return n_mat * self.d_model * f

    def rglru_params(self) -> int:
        w = self.lru_width
        # in-proj (x & gate), conv, RG-LRU gates (W_a, W_x, Lambda), out-proj
        return (2 * self.d_model * w + self.conv_width * w
                + 2 * w * w + w + w * self.d_model)

    def rwkv_params(self) -> int:
        d = self.d_model
        # time-mix: r,k,v,g,w,o (6 d^2) + lora mixers (small) ; channel-mix
        tm = 6 * d * d + 7 * d * 64
        cm = 2 * d * self.d_ff + d * d
        return tm + cm

    def layer_params(self, kind: str = "attn") -> int:
        if self.is_rwkv:
            return self.rwkv_params() + 2 * self.d_model
        mixer = self.attn_params() if kind == "attn" else self.rglru_params()
        if self.is_moe:
            ff = self.num_experts * self.mlp_params()
            if self.moe_dense_ff:
                ff += self.mlp_params(self.moe_dense_ff)
            ff += self.d_model * self.num_experts  # router
        else:
            ff = self.mlp_params()
        return mixer + ff + 2 * self.d_model

    def layer_kinds(self) -> Tuple[str, ...]:
        if self.is_rwkv:
            return tuple("rwkv" for _ in range(self.num_layers))
        if not self.block_pattern:
            return tuple("attn" for _ in range(self.num_layers))
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    def param_count(self) -> int:
        emb = self.vocab_size * self.d_model
        head = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        body = sum(
            self.layer_params("attn" if k == "attn" else "rec" if k == "rec"
                              else "rwkv")
            for k in self.layer_kinds()
        )
        return emb + head + body + self.d_model  # final norm

    def active_param_count(self) -> int:
        """Per-token active params (MoE: only routed experts count)."""
        if not self.is_moe:
            return self.param_count()
        total = self.param_count()
        inactive = (
            self.num_layers
            * (self.num_experts - self.experts_per_token)
            * self.mlp_params()
        )
        return total - inactive
