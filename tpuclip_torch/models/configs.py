"""Model configurations for the SigLIP family.

A copy of ``tpuclip/models/configs.py``: importing it from there would load
``tpuclip.models.siglip`` and so jax (``tpuclip/models/__init__.py``).
``tests/test_torch_imports.py`` pins this copy to the original.

The reference serves exactly one checkpoint, google/siglip2-so400m-patch14-224
(image_database.py:193), at 1152-d embeddings (image_database.py:235). We keep
a preset registry so the same towers serve the whole family; fixed-resolution
SigLIP2 checkpoints share the SigLIP architecture (conv patch-embed + pre-LN
ViT + MAP attention-pooling head; text tower with last-token pooling and a
linear head).

Configs are frozen dataclasses: hashable, and safe to share between modules.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict


@dataclass(frozen=True)
class VisionConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    layer_norm_eps: float = 1e-6
    # NaFlex (SigLIP2 variable aspect/resolution): images are patchified
    # host-side at native aspect into <= max_num_patches patches; position
    # embeddings live on a sqrt(max_num_patches)-square grid and are
    # antialias-resized per image on device (models/naflex.py).
    naflex: bool = False
    max_num_patches: int = 256

    @property
    def num_patches(self) -> int:
        if self.naflex:
            return self.max_num_patches
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 256000
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 64  # SigLIP contract: pad to exactly 64 tokens
    projection_size: int = 768
    layer_norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class SiglipConfig:
    name: str
    vision: VisionConfig
    text: TextConfig

    @property
    def embedding_dim(self) -> int:
        return self.text.projection_size


def _so400m_vision(image_size: int = 224) -> VisionConfig:
    return VisionConfig(
        hidden_size=1152,
        intermediate_size=4304,
        num_layers=27,
        num_heads=16,
        image_size=image_size,
        patch_size=14,
    )


def _so400m_text(vocab_size: int) -> TextConfig:
    return TextConfig(
        vocab_size=vocab_size,
        hidden_size=1152,
        intermediate_size=4304,
        num_layers=27,
        num_heads=16,
        projection_size=1152,
    )


PRESETS: Dict[str, SiglipConfig] = {
    # --- SigLIP 2 (Gemma tokenizer, 256k vocab) ---
    "google/siglip2-so400m-patch14-224": SiglipConfig(
        name="google/siglip2-so400m-patch14-224",
        vision=_so400m_vision(224),
        text=_so400m_text(256000),
    ),
    "google/siglip2-so400m-patch14-384": SiglipConfig(
        name="google/siglip2-so400m-patch14-384",
        vision=_so400m_vision(384),
        text=_so400m_text(256000),
    ),
    "google/siglip2-base-patch16-224": SiglipConfig(
        name="google/siglip2-base-patch16-224",
        vision=VisionConfig(),
        text=TextConfig(vocab_size=256000),
    ),
    "google/siglip2-base-patch16-256": SiglipConfig(
        name="google/siglip2-base-patch16-256",
        vision=VisionConfig(image_size=256),
        text=TextConfig(vocab_size=256000),
    ),
    "google/siglip2-large-patch16-256": SiglipConfig(
        name="google/siglip2-large-patch16-256",
        vision=VisionConfig(
            hidden_size=1024, intermediate_size=4096, num_layers=24, num_heads=16,
            image_size=256, patch_size=16,
        ),
        text=TextConfig(
            vocab_size=256000, hidden_size=1024, intermediate_size=4096,
            num_layers=24, num_heads=16, projection_size=1024,
        ),
    ),
    # g-opt shape per the published ViT shape-optimization recipe the
    # SigLIP2 report uses (width 1536, depth 40, MLP 6144, 16 heads),
    # paired with a So400m-sized text tower projecting to the vision width.
    # Paper-sourced offline (zero-egress env): a real checkpoint's own
    # config.json ALWAYS overrides this preset via config_from_hf_dict
    # (loader.py:64-67), so a dim mismatch cannot corrupt a real load —
    # the preset only shapes offline/random-init runs.
    "google/siglip2-giant-opt-patch16-384": SiglipConfig(
        name="google/siglip2-giant-opt-patch16-384",
        vision=VisionConfig(
            hidden_size=1536, intermediate_size=6144, num_layers=40, num_heads=16,
            image_size=384, patch_size=16,
        ),
        text=TextConfig(
            vocab_size=256000, hidden_size=1152, intermediate_size=4304,
            num_layers=27, num_heads=16, projection_size=1536,
        ),
    ),
    # --- SigLIP 2 NaFlex (variable aspect/resolution) ---
    "google/siglip2-giant-opt-patch16-naflex": SiglipConfig(
        name="google/siglip2-giant-opt-patch16-naflex",
        vision=VisionConfig(
            hidden_size=1536, intermediate_size=6144, num_layers=40, num_heads=16,
            patch_size=16, naflex=True, max_num_patches=256,
        ),
        text=TextConfig(
            vocab_size=256000, hidden_size=1152, intermediate_size=4304,
            num_layers=27, num_heads=16, projection_size=1536,
        ),
    ),
    "google/siglip2-so400m-patch16-naflex": SiglipConfig(
        name="google/siglip2-so400m-patch16-naflex",
        vision=VisionConfig(
            hidden_size=1152, intermediate_size=4304, num_layers=27, num_heads=16,
            patch_size=16, naflex=True, max_num_patches=256,
        ),
        text=_so400m_text(256000),
    ),
    "google/siglip2-base-patch16-naflex": SiglipConfig(
        name="google/siglip2-base-patch16-naflex",
        vision=VisionConfig(patch_size=16, naflex=True, max_num_patches=256),
        text=TextConfig(vocab_size=256000),
    ),
    # --- SigLIP 1 (32k sentencepiece vocab) ---
    "google/siglip-base-patch16-224": SiglipConfig(
        name="google/siglip-base-patch16-224",
        vision=VisionConfig(),
        text=TextConfig(vocab_size=32000),
    ),
    "google/siglip-so400m-patch14-384": SiglipConfig(
        name="google/siglip-so400m-patch14-384",
        vision=_so400m_vision(384),
        text=_so400m_text(32000),
    ),
    # --- tiny configs for tests ---
    "tpuclip/test-tiny-naflex": SiglipConfig(
        name="tpuclip/test-tiny-naflex",
        vision=VisionConfig(
            hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
            patch_size=8, naflex=True, max_num_patches=64,
        ),
        text=TextConfig(
            vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, projection_size=64,
        ),
    ),
    "tpuclip/test-tiny": SiglipConfig(
        name="tpuclip/test-tiny",
        vision=VisionConfig(
            hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
            image_size=56, patch_size=14,
        ),
        text=TextConfig(
            vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, projection_size=64,
        ),
    ),
}

DEFAULT_MODEL = "google/siglip2-so400m-patch14-224"


def get_config(name: str) -> SiglipConfig:
    if name in PRESETS:
        return PRESETS[name]
    raise KeyError(
        f"Unknown model preset: {name!r}. Available: {sorted(PRESETS)}. "
        "Custom checkpoints can be loaded via tpuclip.models.loader with an "
        "HF-style config.json."
    )


def config_from_hf_dict(name: str, cfg: dict) -> SiglipConfig:
    """Build a SiglipConfig from an HF-style config.json dict."""
    v = cfg.get("vision_config", {})
    t = cfg.get("text_config", {})
    # HF model_type "siglip2" (Siglip2VisionConfig) is NaFlex: it carries
    # num_patches and patchifies host-side; plain "siglip" is fixed-res.
    is_naflex = cfg.get("model_type") == "siglip2" or "num_patches" in v
    vision = VisionConfig(
        hidden_size=v.get("hidden_size", 768),
        intermediate_size=v.get("intermediate_size", 3072),
        num_layers=v.get("num_hidden_layers", 12),
        num_heads=v.get("num_attention_heads", 12),
        image_size=v.get("image_size", 224),
        patch_size=v.get("patch_size", 16),
        num_channels=v.get("num_channels", 3),
        layer_norm_eps=v.get("layer_norm_eps", 1e-6),
        naflex=is_naflex,
        max_num_patches=v.get("num_patches", 256),
    )
    text = TextConfig(
        vocab_size=t.get("vocab_size", 32000),
        hidden_size=t.get("hidden_size", 768),
        intermediate_size=t.get("intermediate_size", 3072),
        num_layers=t.get("num_hidden_layers", 12),
        num_heads=t.get("num_attention_heads", 12),
        max_length=t.get("max_position_embeddings", 64),
        projection_size=t.get("projection_size") or t.get("hidden_size", 768),
        layer_norm_eps=t.get("layer_norm_eps", 1e-6),
    )
    return SiglipConfig(name=name, vision=vision, text=text)


def with_image_size(config: SiglipConfig, image_size: int) -> SiglipConfig:
    return replace(config, vision=replace(config.vision, image_size=image_size))
