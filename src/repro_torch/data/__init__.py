from repro_torch.data.pipeline import SyntheticLM, make_pipeline  # noqa: F401
