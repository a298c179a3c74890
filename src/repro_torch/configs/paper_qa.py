"""The paper's own experimental setup (§5): GRU encoders, k=100 (copy of
``repro/configs/paper_qa.py``).

Not one of the assigned architectures: this config reproduces the paper's
CNN cloze-QA experiment (Figure 1): a single-layer GRU document encoder
and a separate single-layer GRU query encoder, hidden size k=100, word
embeddings 100, four attention variants (none | linear | gated_linear |
softmax). The port's lookup serving path (``serving/lookup_engine.py``)
builds its paper-width encoder from it.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class QAConfig:
    vocab_size: int = 400          # synthetic cloze vocabulary
    n_entities: int = 50           # anonymised entity markers (answers)
    embed_dim: int = 100           # paper: word embeddings of size 100
    hidden: int = 100              # paper: GRU hidden size k = 100
    doc_len: int = 120             # synthetic documents (paper: n≈750)
    query_len: int = 16
    attention: str = "linear"      # none|linear|gated_linear|softmax
    lr: float = 1e-3               # ADAM (paper §5)
    batch_size: int = 64


PAPER_N = 750   # CNN-dataset average document length (paper §5)
PAPER_K = 100   # paper's hidden size
PAPER_M = 4     # queries per document (paper §5)
