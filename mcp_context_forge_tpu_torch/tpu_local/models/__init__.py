from .configs import ENCODER_CONFIGS, MODEL_CONFIGS, EncoderConfig, LlamaConfig

__all__ = ["ENCODER_CONFIGS", "MODEL_CONFIGS", "EncoderConfig", "LlamaConfig"]
