"""Model substrate of the port: decoders of attention and Mamba-2 blocks."""

from repro_torch.models.model import (  # noqa: F401
    Model,
    decode_step,
    embed_inputs,
    forward,
    init_cache,
    init_params,
    lm_logits,
    loss_fn,
)
