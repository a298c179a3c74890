"""The paper's own experiment (§5) in the port (``repro/qa``): cloze QA
with GRU encoders and the attention variants (none | linear |
gated_linear | softmax | second_order), and its training driver."""

from repro_torch.qa.model import ATTENTION_VARIANTS, QAModel  # noqa: F401
from repro_torch.qa.train import (  # noqa: F401
    TrainResult, run_figure1, train_qa,
)
