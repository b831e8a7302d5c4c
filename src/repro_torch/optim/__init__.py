from repro_torch.optim.optimizers import Optimizer, adamw, clip_by_global_norm, lion, sgd  # noqa: F401
from repro_torch.optim.schedules import cosine_schedule, linear_warmup  # noqa: F401
