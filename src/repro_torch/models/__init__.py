"""Model substrate of the port: decoders of attention (GQA or MLA, with a
dense or Mixture-of-Experts FFN) and Mamba-2 blocks."""

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
