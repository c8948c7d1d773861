"""Arch config module (selectable via --arch)."""
from repro_torch.configs.archs import GEMMA3_4B as CONFIG
from repro_torch.configs.archs import SMOKE
SMOKE_CONFIG = SMOKE[CONFIG.name]
