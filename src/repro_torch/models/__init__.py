"""Model substrate of the port: attention-only decoder configs so far."""

from repro_torch.models.model import (  # noqa: F401
    Model,
    decode_step,
    embed_inputs,
    forward,
    init_cache,
    init_params,
    lm_logits,
)
