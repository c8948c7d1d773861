"""Arch config module (selectable via --arch)."""
from repro_torch.configs.archs import LLAVA_NEXT_MISTRAL_7B as CONFIG
from repro_torch.configs.archs import SMOKE
SMOKE_CONFIG = SMOKE[CONFIG.name]
