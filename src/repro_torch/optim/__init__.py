from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.optim.gradients import clip_by_global_norm, GradAccumulator

__all__ = ["AdamW", "cosine_schedule", "clip_by_global_norm", "GradAccumulator"]
