"""Arch config module (selectable via --arch)."""
from repro_torch.configs.archs import DEEPSEEK_V2_236B as CONFIG
from repro_torch.configs.archs import SMOKE
SMOKE_CONFIG = SMOKE[CONFIG.name]
