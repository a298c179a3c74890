"""The paper's QA architecture (§5) (port of ``repro/qa/model.py``):

* a single-layer GRU encodes the document (hidden size k = 100),
* a separate single-layer GRU encodes the query (footnote 3: the
  document representation is query-agnostic),
* word embeddings of size 100, ADAM training,
* the attention variants over the document states H (B, n, k):

    none          answer from [h_last; q] only
    linear        R(D,Q) = HᵀH q = C q          (paper §3)
    gated_linear  C = Σ f fᵀ, f = σ(Wh+b) ⊙ h   (paper §4, α=β=1)
    softmax       R(D,Q) = Hᵀ softmax(Hq)       (paper §2 baseline)
    second_order  C from the §6 unit (``core/second_order.py``)

The linear variants keep only the k×k matrix C per document and answer
a query in O(k²) through ``lookup``. The answer head scores R(D,Q) and
q against entity embeddings (cloze over anonymised entities). JAX runs
no Pallas kernel here (``encode_document``, ``lookup`` and
``softmax_lookup`` are jnp), so neither does the port.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.paper_qa import QAConfig
from repro_torch.core.gated import paper_gate
from repro_torch.core.linear_attention import encode_document, lookup
from repro_torch.core.softmax_attention import softmax_lookup
from repro_torch.data.cloze import ClozeBatch
from repro_torch.qa.gru import gru_params, gru_scan

Tensor = torch.Tensor
Params = Dict[str, object]

ATTENTION_VARIANTS = ("none", "linear", "gated_linear", "softmax",
                      "second_order")


class QAModel:
    def __init__(self, cfg: QAConfig):
        assert cfg.attention in ATTENTION_VARIANTS
        self.cfg = cfg

    # -- params ---------------------------------------------------------------

    def init(self, generator: torch.Generator) -> Params:
        """Weights drawn from ``generator`` on its device, at JAX's scales
        (the numbers differ: ``convert.qa_params_from_jax`` carries JAX's
        over)."""
        cfg, dev = self.cfg, generator.device

        def randn(*shape):
            return torch.randn(shape, generator=generator, device=dev)

        p: Params = {
            "embed": randn(cfg.vocab_size, cfg.embed_dim) * 0.1,
            "doc_gru": gru_params(generator, cfg.embed_dim, cfg.hidden),
            "query_gru": gru_params(generator, cfg.embed_dim, cfg.hidden),
            "w_out": randn(2 * cfg.hidden, cfg.hidden) * 0.05,
            "b_out": torch.zeros(cfg.hidden, device=dev),
            "ans_embed": randn(cfg.n_entities, cfg.hidden) * 0.1,
        }
        if cfg.attention == "gated_linear":
            # the paper's gate f = σ(W h + b) ⊙ h
            p["w_gate"] = randn(cfg.hidden, cfg.hidden) * 0.05
            p["b_gate"] = torch.zeros(cfg.hidden, device=dev)
        if cfg.attention == "second_order":
            # the paper's §6 proposal: C and h updates interleaved
            from repro_torch.core.second_order import second_order_params
            p["so"] = second_order_params(generator, cfg.embed_dim,
                                          cfg.hidden)
            del p["doc_gru"]
        return p

    # -- document encoding (the paper's "encode once") ------------------------

    def encode_doc(self, p: Params, doc: Tensor) -> Tuple[Tensor, Tensor]:
        """doc: (B, n) -> (H (B, n, k) or C (B, k, k), h_last (B, k)).

        The linear variants collapse the n×k states into the k×k
        fixed-size representation; softmax keeps all of H."""
        emb = p["embed"][doc.long()]
        att = self.cfg.attention
        if att == "second_order":
            from repro_torch.core.second_order import second_order_scan
            _, h_last, c = second_order_scan(p["so"], emb)
            return c, h_last
        hs, h_last = gru_scan(p["doc_gru"], emb)
        if att == "none":
            return h_last, h_last          # nothing else retained
        if att == "linear":
            return encode_document(hs), h_last
        if att == "gated_linear":
            return encode_document(paper_gate(hs, p["w_gate"],
                                              p["b_gate"])), h_last
        return hs, h_last                  # softmax keeps H

    def encode_query(self, p: Params, query: Tensor) -> Tensor:
        _, q = gru_scan(p["query_gru"], p["embed"][query.long()])
        return q

    # -- lookup + answer ------------------------------------------------------

    def answer_logits(self, p: Params, doc_repr: Tensor, h_last: Tensor,
                      q: Tensor) -> Tensor:
        att = self.cfg.attention
        if att == "none":
            r = h_last
        elif att in ("linear", "gated_linear", "second_order"):
            r = lookup(doc_repr, q)        # O(k²), the paper's claim
            r = r / (torch.linalg.vector_norm(r, dim=-1, keepdim=True)
                     + 1e-6) * self.cfg.hidden ** 0.5
        else:
            r = softmax_lookup(doc_repr, q)
        hidden = torch.tanh(torch.cat([r, q], dim=-1) @ p["w_out"]
                            + p["b_out"])
        return hidden @ p["ans_embed"].T

    def loss_and_acc(self, p: Params, batch: ClozeBatch
                     ) -> Tuple[Tensor, Tensor]:
        """Mean cross-entropy of the answers and the accuracy of the
        argmax; ``batch`` holds tensors on the parameters' device."""
        doc_repr, h_last = self.encode_doc(p, batch.doc)
        q = self.encode_query(p, batch.query)
        logits = self.answer_logits(p, doc_repr, h_last, q)
        answer = batch.answer.long()
        nll = -torch.log_softmax(logits, dim=-1).gather(
            -1, answer[:, None]).mean()
        acc = (logits.argmax(-1) == answer).float().mean()
        return nll, acc
