from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig,
    SyntheticLM,
    TokenFileDataset,
    make_pipeline,
)
