from .configs import MODEL_CONFIGS, LlamaConfig

__all__ = ["MODEL_CONFIGS", "LlamaConfig"]
