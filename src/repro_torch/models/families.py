"""Model registry of the port (the counterpart of
``repro.models.families``).

Only the dense GQA decoder family is ported so far.  ``RWKVLM``,
``Mamba2Hybrid`` and ``EncDecLM`` raise ``NotImplementedError`` naming the
ROADMAP item they wait for.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import DecoderLM


class RWKVLM:
    def __init__(self, cfg: ArchConfig, device="cuda"):
        raise NotImplementedError(
            f"{cfg.name}: RWKV6 models are not ported yet (ROADMAP queue "
            f"1: rwkv.py + rwkv6_scan kernel)")


class Mamba2Hybrid:
    def __init__(self, cfg: ArchConfig, device="cuda"):
        raise NotImplementedError(
            f"{cfg.name}: Mamba2 hybrid models are not ported yet (ROADMAP "
            f"queue 1: ssm.py + mamba2_scan kernel)")


class EncDecLM:
    def __init__(self, cfg: ArchConfig, device="cuda"):
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet "
            f"(ROADMAP queue 1: EncDecLM)")


def build_model(cfg: ArchConfig, device="cuda"):
    """The model class for ``cfg`` on ``device`` (default: the GPU; raises
    when there is none)."""
    if cfg.family == "ssm" and cfg.rwkv is not None:
        return RWKVLM(cfg, device)
    if cfg.family == "hybrid":
        return Mamba2Hybrid(cfg, device)
    if cfg.family == "audio":
        return EncDecLM(cfg, device)
    return DecoderLM(cfg, device)
