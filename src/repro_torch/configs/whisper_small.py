"""Arch config module (selectable via --arch)."""
from repro_torch.configs.archs import WHISPER_SMALL as CONFIG
from repro_torch.configs.archs import SMOKE
SMOKE_CONFIG = SMOKE[CONFIG.name]
