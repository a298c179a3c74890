"""Core of the port: the paper's linear attention family, its softmax
baseline, the document state and the §6 second-order unit (the exports
of ``repro.core``)."""

from repro_torch.core.linear_attention import (  # noqa: F401
    causal_linear_attention,
    causal_linear_attention_chunked,
    causal_linear_attention_scan,
    decode_step,
    encode_document,
    encode_document_streaming,
    lookup,
)
from repro_torch.core.gated import (  # noqa: F401
    chunked_gla,
    gated_decode_step,
    gated_linear_attention,
    gla_scan,
    invert_update,
    paper_gate,
    reconstruct_states_backward,
)
from repro_torch.core.softmax_attention import (  # noqa: F401
    causal_softmax_attention,
    softmax_decode_step,
    softmax_lookup,
)
from repro_torch.core.state import DocumentState, DocumentStore  # noqa: F401
from repro_torch.core.second_order import (  # noqa: F401
    second_order_params, second_order_scan,
)
