"""Modality frontend STUBS (port of ``repro.models.multimodal``; per spec:
'[audio]/[vlm] entries specify the transformer BACKBONE only; the modality
frontend is a STUB — input_specs() provides precomputed frame/patch
embeddings').

These helpers produce the stand-in embeddings used by the data pipeline,
smoke tests and the dry-run input specs; a production deployment would
replace them with a ViT tower (llava anyres tiling) or the w2v2 conv
feature extractor.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig


def vision_patch_embeds_stub(rng: np.random.Generator, batch: int,
                             cfg: ModelConfig) -> np.ndarray:
    """(B, n_patches, d_model) float32 — one anyres tile of patch embeddings,
    unit-scaled like a trained projector's output."""
    assert cfg.frontend == "vision"
    return rng.standard_normal(
        (batch, cfg.n_patches, cfg.d_model)).astype(np.float32)


def audio_frame_embeds_stub(rng: np.random.Generator, batch: int,
                            n_frames: int, cfg: ModelConfig) -> np.ndarray:
    """(B, S, d_model) float32 — post-conv-extractor frame embeddings."""
    assert cfg.frontend == "audio"
    return rng.standard_normal(
        (batch, n_frames, cfg.d_model)).astype(np.float32)


def frontend_notes(cfg: ModelConfig) -> str:
    if cfg.frontend == "vision":
        return ("llava-next anyres tiling stub: a real frontend runs the ViT "
                "over N image tiles + the base image and projects to "
                f"d_model={cfg.d_model}; here input_specs provides "
                f"{cfg.n_patches} precomputed patch embeddings per sample.")
    if cfg.frontend == "audio":
        return ("hubert conv-extractor stub: a real frontend downsamples "
                "16 kHz audio 320x into frames; here input_specs provides "
                "frame embeddings directly at d_model.")
    return "no frontend"
