from repro_torch.checkpoint.manager import CheckpointConfig, CheckpointManager

__all__ = ["CheckpointConfig", "CheckpointManager"]
