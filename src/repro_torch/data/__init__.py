"""Data pipelines of the port (``repro/data``): deterministic, sharded,
checkpointable. The synthetic LM stream, the binary token file and the
paper's cloze QA task, each a numpy-only copy that gives the JAX
package's batches bit for bit."""

from repro_torch.data.synthetic import SyntheticLMDataset  # noqa: F401
from repro_torch.data.memmap import (  # noqa: F401
    TokenFileDataset, write_token_file,
)
from repro_torch.data.cloze import ClozeBatch, ClozeTask  # noqa: F401
