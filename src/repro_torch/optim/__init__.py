from repro_torch.optim.adamw import AdamWConfig, init, update  # noqa: F401
from repro_torch.optim.schedules import cosine_with_warmup  # noqa: F401
