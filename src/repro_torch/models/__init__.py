"""Model stack: configs, layers, attention and the decoder-only transformer."""
from .config import ModelConfig  # noqa: F401
