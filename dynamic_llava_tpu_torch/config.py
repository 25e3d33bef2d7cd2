"""Typed configuration of the port.

The port's own copy of the JAX package's frozen dataclasses
(``dynamic_llava_tpu/config.py``): the same fields and defaults, so a
config built from the same values means the same model in both packages,
without either importing the other. Frozen dataclasses are hashable and
compare by value. The MPT family and the HF-dict constructors are not
ported.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional


def _round_keep(n_tokens: int, keep_rate: float) -> int:
    """Fixed keep budget: ``int(n_tokens * keep_rate)`` like the original
    top-k, but resolved statically."""
    return max(1, int(n_tokens * keep_rate))


@dataclass(frozen=True)
class SparseConfig:
    """Sparsification flags and rates.

    Field names and defaults are those of the original Dynamic-LLaVA
    ``SparseArguments``, so checkpoints' ``config.sparse_config`` dicts
    round-trip unchanged.
    """

    use_vision_predictor: bool = True
    vision_keep_rate: float = 0.2

    use_text_predictor: bool = True

    use_output_text_predictor: bool = True
    output_text_keep_rate: float = 0.5
    output_text_len_for_training: int = 50

    use_instruct_predictor: bool = False
    instruct_keep_rate: float = 0.7
    instruct_len_for_training: int = 25

    sparse_layer: int = 2
    # predictor architecture (VisionPredictor transformer blocks)
    d_model: int = 512
    nhead: int = 8
    dim_feedforward: int = 2048
    num_layers: int = 2
    mask_loss_weight: float = 100.0

    def vision_keep_budget(self, num_image_tokens: int) -> int:
        return _round_keep(num_image_tokens, self.vision_keep_rate)

    @property
    def any_predictor(self) -> bool:
        return (
            self.use_vision_predictor
            or self.use_output_text_predictor
            or self.use_instruct_predictor
        )

    @classmethod
    def from_dict(cls, d: dict) -> "SparseConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


DENSE_SPARSE_CONFIG = SparseConfig(
    use_vision_predictor=False,
    use_text_predictor=False,
    use_output_text_predictor=False,
    use_instruct_predictor=False,
)


@dataclass(frozen=True)
class RopeScalingConfig:
    """RoPE scaling (linear / dynamic-NTK), as HF's
    LlamaLinearScalingRotaryEmbedding / LlamaDynamicNTKScalingRotaryEmbedding."""

    rope_type: str = "linear"  # "linear" | "dynamic"
    factor: float = 1.0


@dataclass(frozen=True)
class LlamaConfig:
    """Decoder config (LLaMA/Vicuna family)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling: Optional[RopeScalingConfig] = None
    attention_bias: bool = False
    tie_word_embeddings: bool = False
    # Mistral-family sliding-window attention: token q attends to keys with
    # q_pos - k_pos in [0, window). None = full causal (LLaMA). The dense
    # LLaVA-Mistral baseline (reference llava_mistral.py) rides the same
    # decoder stack with this set; the sparse/dynamic path is LLaMA-only,
    # exactly as in the reference (dynamic_modeling_llama.py has no
    # Mistral twin) — enforced in models.dynamic.
    sliding_window: Optional[int] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    @classmethod
    def llama_7b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def llama_13b(cls) -> "LlamaConfig":
        return cls(
            hidden_size=5120,
            intermediate_size=13824,
            num_hidden_layers=40,
            num_attention_heads=40,
            num_key_value_heads=40,
        )

    @classmethod
    def mistral_7b(cls) -> "LlamaConfig":
        """Mistral-7B-v0.1 (the reference's llava_mistral.py base): LLaMA
        architecture + GQA (8 kv heads) + 4096-token sliding window."""
        return cls(
            intermediate_size=14336,
            num_key_value_heads=8,
            max_position_embeddings=32768,
            sliding_window=4096,
        )

    @classmethod
    def tiny(cls, **overrides) -> "LlamaConfig":
        base = dict(
            vocab_size=512,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=4,
            num_attention_heads=4,
            num_key_value_heads=4,
            max_position_embeddings=512,
        )
        base.update(overrides)
        return cls(**base)

@dataclass(frozen=True)
class ClipVisionConfig:
    """CLIP ViT vision tower config (CLIP-ViT-L/14-336 defaults)."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    projection_dim: int = 768
    # which hidden_states layer to tap (negative indexing like the reference
    # mm_vision_select_layer, default -2; clip_encoder.py:43-50)
    select_layer: int = -2
    select_feature: str = "patch"  # "patch" drops CLS, "cls_patch" keeps it

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_per_side**2

    @property
    def num_positions(self) -> int:
        return self.num_patches + 1

    @classmethod
    def tiny(cls, **overrides) -> "ClipVisionConfig":
        base = dict(
            hidden_size=32,
            intermediate_size=64,
            num_hidden_layers=3,
            num_attention_heads=2,
            image_size=56,
            patch_size=14,
        )
        base.update(overrides)
        return cls(**base)

@dataclass(frozen=True)
class LlavaConfig:
    """Full multimodal model config (tower + projector + decoder + sparse)."""

    text: LlamaConfig = field(default_factory=LlamaConfig)
    vision: ClipVisionConfig = field(default_factory=ClipVisionConfig)
    sparse: SparseConfig = field(default_factory=SparseConfig)
    mm_projector_type: str = "mlp2x_gelu"
    mm_vision_select_layer: int = -2
    mm_vision_select_feature: str = "patch"
    image_aspect_ratio: str = "pad"  # "pad" | "square" | "anyres"
    mm_use_im_start_end: bool = False
    mm_use_im_patch_token: bool = False
    model_max_length: int = 2048

    def __post_init__(self):
        if self.text.sliding_window is not None and (
            self.sparse.use_vision_predictor
            or self.sparse.use_text_predictor
            or self.sparse.use_output_text_predictor
            or self.sparse.use_instruct_predictor
        ):
            # Sparse compaction breaks the slot==position invariant the
            # decode-time window mask relies on; the reference likewise has
            # no dynamic Mistral (llava_mistral.py is a dense baseline,
            # dynamic_modeling_llama.py is LLaMA-only).
            raise ValueError(
                "sliding_window (Mistral) supports the dense stack only: "
                "disable the sparse predictors or unset text.sliding_window"
            )

    @property
    def num_image_tokens(self) -> int:
        return self.vision.num_patches

    @property
    def vision_keep_budget(self) -> int:
        if not self.sparse.use_vision_predictor:
            return self.num_image_tokens
        return self.sparse.vision_keep_budget(self.num_image_tokens)

    @classmethod
    def tiny(cls, sparse: Optional[SparseConfig] = None, **overrides) -> "LlavaConfig":
        return cls(
            text=LlamaConfig.tiny(),
            vision=ClipVisionConfig.tiny(),
            sparse=sparse
            or SparseConfig(d_model=32, nhead=2, dim_feedforward=64, num_layers=1),
            **overrides,
        )

    def to_json(self) -> str:
        def enc(o: Any):
            if dataclasses.is_dataclass(o):
                return dataclasses.asdict(o)
            raise TypeError(o)

        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "LlavaConfig":
        d = json.loads(s)
        rs = d["text"].pop("rope_scaling", None)
        text = LlamaConfig(
            **{**d["text"], "rope_scaling": RopeScalingConfig(**rs) if rs else None}
        )
        vision = ClipVisionConfig(**d["vision"])
        sparse = SparseConfig(**d["sparse"])
        rest = {
            k: v for k, v in d.items() if k not in ("text", "vision", "sparse")
        }
        return cls(text=text, vision=vision, sparse=sparse, **rest)


from .constants import IMAGE_TOKEN_INDEX  # noqa: E402,F401  (re-exported)
