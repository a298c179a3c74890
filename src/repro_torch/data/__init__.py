"""Data pipelines of the port (``repro/data``): the synthetic LM stream."""

from repro_torch.data.synthetic import SyntheticLMDataset  # noqa: F401
