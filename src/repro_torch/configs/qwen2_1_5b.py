"""--arch qwen2-1.5b (see configs/archs.py for the full definition)."""
from repro_torch.configs.archs import QWEN2_1_5B as CONFIG, smoke_config

SMOKE = smoke_config(CONFIG)
